"""The matvec's far-field phases replayed from CUDA graphs
(``executor/graphs.py``).

Every test here runs on the card and skips without one: a CUDA graph
has no CPU counterpart (on the CPU the phases run eagerly, which
``tests/test_torch_tracing.py`` holds).  The eager reference is the same
program with ``phases_for`` patched by the test to the eager runner: the
same phase methods, called eagerly.  This file does not import JAX, so
it runs where JAX is not installed, in a process of its own (the
profiler can miss the first operations of a later session in one
process): ``python3 -m pytest -o addopts="" --noconftest
tests/test_torch_matvec_graph.py -m card``."""

import contextlib
import gc
import json
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.executor import graphs as G
from fmm_bem_tpu_torch.executor import plan as plan_mod
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.solver.gmres import DeviceGmresContext
from fmm_bem_tpu_torch.utils.metrics import log

FAR = ("p2m", "m2m", "m2l", "l2l", "l2p")
#: the most a graphed result may differ from the eager one, relative to
#: its norm (cuBLAS may pick another algorithm under capture)
GRAPH_LIMIT = 1e-6


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


def sphere_plan(card, kernel, recursions, max_p):
    return T.FmmPlan(kernel, make_panels(unit_sphere(recursions), K=3),
                     T.FMMConfig(ncrit=64, leaf_pad=64, dtype="float32",
                                 max_p=max_p), device=card)


@pytest.fixture(scope="module")
def plans(card):
    """The 8,192-panel Laplace and Yukawa BEM spheres (the cells'
    kernels and settings) and 100,000 points in a cube at p=5."""
    xyz = np.random.default_rng(3).uniform(0, 1, (100_000, 3))
    return {
        "laplace": sphere_plan(card, LaplaceBEMKernel(K=3, fine_K=17), 6,
                               10),
        "yukawa": sphere_plan(card, YukawaBEMKernel(K=3, fine_K=17,
                                                    kappa=0.125), 6, 8),
        "points": T.FmmPlan(LaplaceKernel(), {"xyz": xyz},
                            T.FMMConfig(ncrit=64, dtype="float32",
                                        max_p=5), device=card),
    }


@contextlib.contextmanager
def eager_phases():
    """The program's matvec with every far-field phase run eagerly."""
    old = plan_mod.phases_for
    plan_mod.phases_for = lambda aux, d, pool: G.EAGER
    try:
        yield
    finally:
        plan_mod.phases_for = old


def counted(fn):
    """``fn()`` under a (CPU) profiler session: (result, counters by
    name)."""
    log.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counts = {}
    for (name, _), n in log.counts().items():
        counts[name] = counts.get(name, 0) + n
    log.clear_spans()
    return out, counts


def operator(plan, flipped=False):
    """(matvec, operand_for_p, to_slots) of the plan's slot operator."""
    mv, op4p, to_s = plan._slot_ops(
        *(plan._flipped_pair() if flipped else ()))[:3]
    return mv, op4p, to_s


def fresh(plan, to_s, seed):
    n = plan.src.tree.num_bodies
    return to_s(np.random.default_rng(seed).standard_normal(n))


def fresh_operand(op4p, p):
    """The operand of order ``p``, its graphs dropped: its next matvec
    is its first."""
    operand = op4p(p)
    operand[1].pop("graphs", None)
    return operand


def rel(a, b):
    return float((a - b).norm() / b.norm())


def held(got, want, what):
    """``got`` within ``GRAPH_LIMIT`` of ``want``; prints whether the two
    are bit-equal."""
    r = rel(got, want)
    print(json.dumps({"graph_vs_eager": what, "bit_equal":
                      bool(torch.equal(got, want)), "rel": r}), flush=True)
    assert r <= GRAPH_LIMIT, (what, r)


CASES = ([("laplace", p, f) for p in (3, 5, 10) for f in (False, True)]
         + [("yukawa", p, False) for p in (3, 5, 8)] + [("points", 5, False)])


@pytest.mark.card
@pytest.mark.parametrize("name,p,flipped", CASES)
def test_graphed_matvec_matches_eager(plans, name, p, flipped):
    """An operand's first matvec runs its far phases eagerly, its second
    captures each and replays it, its third replays: both against the
    eager phases on the same vectors, and a result unchanged by the
    next matvec (no result aliases a graph's output)."""
    plan = plans[name]
    mv, op4p, to_s = operator(plan, flipped)
    operand = fresh_operand(op4p, p)
    xs = [fresh(plan, to_s, s) for s in range(3)]
    with eager_phases():
        want = [mv(operand, x, p) for x in xs]
    got, counts = [], []
    for x in xs:
        r, c = counted(lambda: mv(operand, x, p))
        got.append(r)
        counts.append(c)
    kept = got[1].clone()
    torch.cuda.synchronize()
    assert counts[0].get("matvec.eager") == len(FAR)
    assert "matvec.graph" not in counts[0]
    assert counts[1].get("matvec.graph_captures") == len(FAR)
    assert counts[1].get("matvec.graph") == len(FAR)
    assert counts[2].get("matvec.graph") == len(FAR)
    for c in counts[1:]:
        assert "matvec.eager" not in c
    assert "matvec.graph_captures" not in counts[2]
    assert torch.equal(got[0], want[0])
    for i in (1, 2):
        held(got[i], want[i], f"{name} p={p} flipped={flipped} call {i}")
    assert torch.equal(got[1], kept)


@pytest.mark.card
def test_orders_switch_on_fresh_vectors(plans):
    """The Yukawa operator at p 8 -> 5 -> 3 -> 8, each order's graphs
    captured before: every call replays its order's graphs and matches
    the eager phases."""
    plan = plans["yukawa"]
    mv, op4p, to_s = operator(plan)
    for p in (3, 5, 8):
        operand = fresh_operand(op4p, p)
        for s in (10, 11):
            mv(operand, fresh(plan, to_s, s), p)
    for k, p in enumerate((8, 5, 3, 8)):
        x = fresh(plan, to_s, 20 + k)
        got, c = counted(lambda: mv(op4p(p), x, p))
        with eager_phases():
            want = mv(op4p(p), x, p)
        assert c.get("matvec.graph") == len(FAR) and "matvec.eager" not in c
        held(got, want, f"switch {k} p={p}")


@pytest.mark.card
def test_an_evicted_operand_drops_its_graphs(card):
    """Nine operands on one plan: the entry the cache evicts takes its
    graphs with it, and the operand built anew captures again."""
    plan = sphere_plan(card, LaplaceBEMKernel(K=3), 4, 10)
    mv, op4p, to_s = operator(plan)
    x = fresh(plan, to_s, 1)
    first = op4p(2)
    mv(first, x, 2)
    mv(first, x, 2)
    gone = weakref.ref(first[1]["graphs"])
    assert gone().graphs.keys() == set(FAR)
    del first
    for p in range(3, 11):
        operand = op4p(p)
        mv(operand, x, p)
        mv(operand, x, p)
    del operand
    gc.collect()
    assert len(plan._aux_slots_cache) == 8
    assert gone() is None
    got, c = counted(lambda: [mv(op4p(2), x, 2) for _ in range(2)][-1])
    assert c.get("matvec.graph_captures") == len(FAR)
    with eager_phases():
        want = mv(op4p(2), x, 2)
    held(got, want, "rebuilt p=2")


@pytest.mark.card
def test_relaxed_solve_repeats_the_eager_schedule(plans):
    """A relaxed first-kind GMRES solve (tiers 3, 5, 10) with the graphs
    takes the iterations and orders the eager phases take."""
    plan = plans["laplace"]
    xyz = make_panels(unit_sphere(6), K=3)["xyz"]
    phi = 1.0 / np.linalg.norm(xyz - [2.0, 0.0, 0.0], axis=1)
    b = plan.apply_flipped_bc(phi, p=10)[:, 0].cpu().numpy()
    cfg = T.SolverConfig(residual=1e-5, max_iters=100, restart=100,
                         max_p=10, p_min=1, p_tiers=(3, 5, 10))

    def solve():
        return solve_plan(plan, b, cfg, context=DeviceGmresContext())

    solve()  # captures every operand it reaches
    (x, info, _), c = counted(solve)
    with eager_phases():
        x0, info0, _ = solve()
    assert c.get("matvec.graph", 0) > 0 and "matvec.eager" not in c
    assert info.converged and info0.converged
    assert info.iterations == info0.iterations
    assert [int(h[2]) for h in info.history] == \
        [int(h[2]) for h in info0.history]
    assert np.linalg.norm(x - x0) <= 1e-5 * np.linalg.norm(x0)


@pytest.mark.card
def test_traced_graph_matvec_keeps_its_phase_spans(plans):
    """Graphs captured before the profiler starts: a traced matvec
    records the spans p2m ... l2p, each enclosing device work between
    its markers on the card, counts ``matvec.graph`` once a phase, and
    the profiler sees as many kernels as in the eager matvec."""
    from bench_h100 import spans as bench_spans
    from bench_h100.yardstick import Trace

    plan = plans["yukawa"]
    mv, op4p, to_s = operator(plan)
    operand = op4p(8)
    x = fresh(plan, to_s, 30)
    for _ in range(2):
        mv(operand, x, 8)
    torch.cuda.synchronize()

    def traced():
        log.clear_spans()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("bench.solve"):
                mv(operand, x, 8)
                torch.cuda.synchronize()
        trace = Trace.from_profile(prof)
        lo = min(s for _, s, _ in trace.spans)
        hi = max(e for _, _, e in trace.spans)
        a = bench_spans.Attribution(trace.ops, log.spans(), lo, hi,
                                    log.counts())
        counts = {}
        for (name, _), n in log.counts().items():
            counts[name] = counts.get(name, 0) + n
        log.clear_spans()
        return a, counts, trace.kernel_launches()

    a, counts, launches = traced()
    with eager_phases():
        _, _, eager_launches = traced()
    print(json.dumps({"traced_launches": launches,
                      "eager_launches": eager_launches}), flush=True)
    assert a.on_card
    for name in FAR + ("near",):
        assert a.busy_ns(name) > 0, name
    assert counts.get("matvec.graph") == len(FAR)
    assert "matvec.eager" not in counts
    assert abs(launches - eager_launches) <= 0.03 * eager_launches


@pytest.mark.card
def test_a_failed_capture_runs_eagerly(card):
    """A phase that cannot be captured (a host sync in L2L) leaves its
    operand eager from then on, on the outputs the replays before it
    left: results match the eager phases, and the plan's other operands
    still capture."""
    plan = sphere_plan(card, LaplaceBEMKernel(K=3), 4, 10)
    mv, op4p, to_s = operator(plan)
    l2l = plan._phase_l2l

    def syncing_l2l(d, L):
        float(L[0, 0])  # a host sync: not allowed while capturing
        return l2l(d, L)

    plan._phase_l2l = syncing_l2l
    operand = fresh_operand(op4p, 5)
    xs = [fresh(plan, to_s, s) for s in range(3)]
    with eager_phases():
        want = [mv(operand, x, 5) for x in xs]
    runs = [counted(lambda x=x: mv(operand, x, 5)) for x in xs]
    assert operand[1]["graphs"].error.startswith("l2l: ")
    assert runs[1][1].get("matvec.graph_captures") == 3
    assert runs[1][1].get("matvec.graph") == 3
    assert runs[1][1].get("matvec.eager") == 2
    assert runs[2][1].get("matvec.eager") == len(FAR)
    assert not torch.cuda.is_current_stream_capturing()
    for (got, _), w in zip(runs, want):
        held(got, w, "failed capture")
    del plan._phase_l2l
    other = fresh_operand(op4p, 3)
    mv(other, xs[0], 3)
    got, c = counted(lambda: mv(other, xs[1], 3))
    assert c.get("matvec.graph_captures") == len(FAR), \
        other[1]["graphs"].error
    with eager_phases():
        held(got, mv(other, xs[1], 3), "after a failed capture")
    _, c = counted(lambda: mv(operand, xs[0], 5))
    assert c.get("matvec.eager") == len(FAR)
