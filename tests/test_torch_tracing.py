"""The spans and counters of ``fmm_bem_tpu_torch/utils/metrics.py``
(``log.span``, ``log.count``) on the CPU: they record only while a
``torch.profiler`` session is recording, on the profiler's clock; the
leaf spans under each matvec are the phases the plan runs, in order;
a solve's spans and counters follow its iterations, true residuals and
host waits.  One test, marked ``card``, holds a span against a kernel
and the span's markers on the card's timeline, and skips without one.  This file does not
import JAX, so that the ``card`` test runs where JAX is not installed
(``README.md``, "Tracing")."""

import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.bem.panels import make_panels, switch_bc
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.solver.gmres import DeviceGmresContext
from fmm_bem_tpu_torch.utils.metrics import MARKER, Logger, log

F64 = dict(dtype="float64", max_p=6)
PHASE_NAMES = {"p2m", "m2m", "m2l", "l2l", "l2p", "m2p", "near", "p2p"}


@pytest.fixture(autouse=True)
def clean_log():
    log.clear_spans()
    yield
    log.clear_spans()


def traced(fn):
    """``fn()`` under a CPU ``torch.profiler`` session: (result, prof)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def children(spans, idx):
    return [s for s in spans if s[3] == idx]


def two_spheres():
    """A unit sphere beside a sphere fifty times smaller: the adaptive
    tree gets level-skewed pairs (M2P) and family M2L."""
    small = unit_sphere(4) * 0.02 + np.array([1.3, 0.0, 0.0])
    return np.concatenate([unit_sphere(3), small])


@functools.lru_cache(maxsize=None)
def phase_case(case):
    """(port plan, flipped) of one parametrised case (built once a
    process; the tests here only apply it)."""
    if case == "skewed":
        return T.FmmPlan(LaplaceBEMKernel(K=3),
                         make_panels(two_spheres(), K=3),
                         T.FMMConfig(ncrit=8, **F64), device="cpu"), False
    if case == "yukawa":
        # per-level translations and the eager M2P; a low order keeps
        # the build short
        return T.FmmPlan(YukawaBEMKernel(K=3, kappa=0.125),
                         make_panels(two_spheres(), K=3),
                         T.FMMConfig(ncrit=8, dtype="float64", max_p=5),
                         device="cpu"), False
    if case == "points":
        xyz = np.random.default_rng(4).uniform(0, 1, (1500, 3))
        return T.FmmPlan(LaplaceKernel(), {"xyz": xyz},
                         T.FMMConfig(ncrit=32, **F64), device="cpu"), False
    if case == "stokes":
        return T.FmmPlan(StokesBEMKernel(K=4, mu=1e-3),
                         make_panels(unit_sphere(2), K=4),
                         T.FMMConfig(ncrit=16, **F64), device="cpu"), False
    extra = {"otf": dict(near_mode="otf"),
             "local_evaluation": dict(local_evaluation=True),
             "coo": dict(near_panel=False)}.get(case, {})
    plan = T.FmmPlan(LaplaceBEMKernel(K=3), make_panels(unit_sphere(3), K=3),
                     T.FMMConfig(ncrit=16, **F64, **extra), device="cpu")
    return plan, case == "bem_flipped"


#: the phases each case runs, in order
PHASES = {
    "skewed": ["p2m", "m2m", "m2l", "l2l", "l2p", "m2p", "near"],
    "yukawa": ["p2m", "m2m", "m2l", "l2l", "l2p", "m2p", "near"],
    "otf": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "stokes": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "points": ["p2m", "m2m", "m2l", "l2l", "l2p", "p2p"],
    "local_evaluation": ["near"],
    "bem": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "bem_flipped": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "coo": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
}


@pytest.mark.parametrize("case", list(PHASES))
def test_phase_spans_are_the_matvec(case):
    """Under the profiler, an apply opens one ``apply`` span with one
    ``matvec`` under it, whose leaf spans are the phases the plan's
    matvec runs, in order: M2P and family M2L, the OTF tiles, the Stokes
    two-stage store, the point P2P, the near-only operator, both BC
    variants, the COO replay.  The traced result is bit-identical to the
    untraced one."""
    plan, flipped = phase_case(case)
    n = plan.src.tree.num_bodies
    cdim = getattr(plan.kernel, "charge_dim", 1)
    q = np.random.default_rng(8).standard_normal(n * cdim)
    q = q if cdim == 1 else q.reshape(n, cdim)
    apply = plan.apply_flipped_bc if flipped else plan.apply
    want = apply(q, p=5)
    assert log.spans() == []
    got, _ = traced(lambda: apply(q, p=5))
    assert torch.equal(got, want)
    spans = log.spans()
    roots = [i for i, s in enumerate(spans) if s[3] is None]
    assert [spans[i][0] for i in roots] == ["apply"]
    mvs = [i for i, s in enumerate(spans) if s[0] == "matvec"]
    assert len(mvs) == 1 and spans[mvs[0]][3] == roots[0]
    leaves = [s for s in children(spans, mvs[0])]
    assert [s[0] for s in leaves] == PHASES[case]
    assert all(not children(spans, spans.index(s)) for s in leaves)
    assert {s[0] for s in spans} - PHASE_NAMES <= {
        "apply", "apply.entry", "apply.exit", "matvec"}
    if case in ("skewed", "yukawa"):
        assert len(plan.m2p_src) > 0 and plan.m2l_fam is not None


FAR_PHASES = ("p2m", "m2m", "m2l", "l2l", "l2p")


@pytest.mark.parametrize("case", list(PHASES))
def test_far_phases_run_eagerly_on_the_cpu(case):
    """On the CPU a matvec runs each of its far-field phases eagerly:
    ``matvec.eager`` counts once for each, and nothing is captured into
    or replayed from a CUDA graph (``executor/graphs.py``), twice in a
    row on the same operand."""
    plan, flipped = phase_case(case)
    n = plan.src.tree.num_bodies
    cdim = getattr(plan.kernel, "charge_dim", 1)
    q = np.random.default_rng(9).standard_normal(n * cdim)
    q = q if cdim == 1 else q.reshape(n, cdim)
    apply = plan.apply_flipped_bc if flipped else plan.apply
    far = [ph for ph in PHASES[case] if ph in FAR_PHASES]
    for _ in range(2):
        traced(lambda: apply(q, p=5))
        counts = {}
        for (name, _), k in log.counts().items():
            counts[name] = counts.get(name, 0) + k
        assert counts.get("matvec.eager", 0) == len(far)
        assert "matvec.graph" not in counts
        assert "matvec.graph_captures" not in counts
        log.clear_spans()


@pytest.fixture(scope="module")
def bem_plan():
    return T.FmmPlan(LaplaceBEMKernel(K=3), make_panels(unit_sphere(3), K=3),
                     T.FMMConfig(ncrit=16, dtype="float64", max_p=10),
                     device="cpu")


@pytest.fixture(scope="module")
def second_kind_plan():
    fields = switch_bc(make_panels(unit_sphere(3), K=3))
    return T.FmmPlan(LaplaceBEMKernel(K=3), fields,
                     T.FMMConfig(ncrit=16, dtype="float64", max_p=10),
                     device="cpu")


#: the relaxed first kind and the second kind at fixed p, as the
#: benchmark's two solve mixes run them
RELAXED = dict(residual=1e-5, max_iters=100, restart=100, max_p=10,
               p_min=1, p_tiers=(3, 5, 10))
FIXED = dict(residual=1e-5, max_iters=60, restart=60, max_p=5)


def solve_case(case, bem_plan, second_kind_plan):
    """(plan, right-hand side, SolverConfig, p_fixed) of a solve case."""
    if case == "relaxed":
        plan, cfg, p_fixed = bem_plan, T.SolverConfig(**RELAXED), None
    else:
        plan, cfg, p_fixed = second_kind_plan, T.SolverConfig(**FIXED), 5
    n = plan.src.tree.num_bodies
    b = plan.apply_flipped_bc(np.ones(n), p=10)[:, 0].numpy()
    return plan, b, cfg, p_fixed


@pytest.mark.parametrize("what", ["apply", "solve"])
def test_tracing_off_records_nothing(what, bem_plan):
    """Without a profiler session a span is one shared object that does
    nothing, and neither spans nor counters are recorded."""
    assert log.span("solve") is log.span("m2l")
    n = bem_plan.src.tree.num_bodies
    if what == "apply":
        bem_plan.apply(np.ones(n), p=5)
    else:
        solve_plan(bem_plan, np.ones(n), T.SolverConfig(**FIXED),
                   p_fixed=5)
    log.count("host_syncs")
    assert log.spans() == [] and log.counts() == {}
    assert log.spans_dropped == 0


@pytest.mark.parametrize("case", ["relaxed", "fixed_p"])
def test_solve_spans_and_counters(case, bem_plan, second_kind_plan):
    """A device solve under the profiler: one ``solve`` root whose
    operation id every span shares; one ``solve.arnoldi`` per
    iteration; one ``matvec`` per iteration and per true residual;
    ``host_syncs`` counts the waits the code makes (one ``.cpu()`` an
    iteration, the norm's ``float`` of each true residual and of the
    right-hand side, the exit's ``.cpu()``)."""
    plan, b, cfg, p_fixed = solve_case(case, bem_plan, second_kind_plan)
    want, _, _ = solve_plan(plan, b, cfg, p_fixed=p_fixed)
    (x, info, mode), _ = traced(
        lambda: solve_plan(plan, b, cfg, p_fixed=p_fixed))
    assert mode == "device-slots" and info.converged
    assert np.array_equal(x, want)
    spans = log.spans()
    assert spans[0][0] == "solve" and spans[0][3] is None
    assert all(s[4] == 0 for s in spans)
    assert all(s[1] <= s[2] for s in spans)
    names = [s[0] for s in spans]
    its, n_true = info.iterations, names.count("solve.true_resid")
    assert names.count("solve.arnoldi") == its
    assert names.count("matvec") == its + n_true
    assert n_true >= 2  # at the start and to confirm convergence
    for one in ("solve", "solve.entry", "solve.finish", "solve.exit"):
        assert names.count(one) == 1
    counts = log.counts()
    assert counts[("host_syncs", 0)] == its + n_true + 2
    assert counts[("gmres.iterations", 0)] == its
    assert {k[1] for k in counts} == {0}


def test_operand_builds_on_a_shared_context(bem_plan):
    """Two relaxed solves sharing one ``DeviceGmresContext`` build the
    operand of every order they use, each time: ``solve_plan`` hands
    the context a new ``operand_for_p`` closure per call, so the
    context's key never hits across solves.  This pins that behaviour;
    a fix that keyed the context on the plan and the BC variant would
    make the second read 0."""
    plan, b, cfg, _ = solve_case("relaxed", bem_plan, None)
    ctx = DeviceGmresContext()
    reads = []
    for _ in range(2):
        log.clear_spans()
        (_, info, _), _ = traced(
            lambda: solve_plan(plan, b, cfg, context=ctx))
        orders = {int(h[2]) for h in info.history} | {cfg.max_p}
        reads.append(log.counts()[("solve.operand_builds", 0)])
        assert reads[-1] == len(orders)
    assert reads[0] == reads[1]
    assert len(ctx.operands) == 2 * reads[0]


def test_span_stamps_bracket_the_profiler_clock():
    """A span's host stamps (``time.time_ns``) bracket the kineto
    stamps of a ``record_function`` opened inside it and of the range
    the span opens itself: they are on the profiler's clock."""
    def body():
        with log.span("outer"):
            with record_function("inner"):
                sum(range(1000))

    _, prof = traced(body)
    (name, start, end, _, _), = log.spans()
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()}
    for nm in ("outer", "inner"):
        ev = events[nm]
        assert start <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() \
            <= end, nm
    assert end - start < 1e9


def test_span_buffer_is_bounded():
    """Past ``max_spans`` spans are dropped and counted; counters still
    land on the open operation; ``clear_spans`` forgets it all."""
    lg = Logger()
    lg.max_spans = 3

    def body():
        with lg.span("a"):
            for _ in range(4):
                with lg.span("b"):
                    lg.count("c")

    traced(body)
    assert [s[0] for s in lg.spans()] == ["a", "b", "b"]
    assert lg.spans_dropped == 2
    assert lg.counts() == {("c", 0): 4}
    lg.clear_spans()
    assert lg.spans() == [] and lg.counts() == {} and lg.spans_dropped == 0


def test_apply_without_slot_route_opens_one_apply_span():
    """``apply`` on the COO replay opens one ``apply`` span with one
    ``apply.entry`` and one ``apply.exit``, as on every other plan."""
    plan, _ = phase_case("coo")
    assert not plan._use_panels and len(plan.near_rows) > 0
    n = plan.src.tree.num_bodies
    traced(lambda: plan.apply(np.ones(n), p=5))
    names = [s[0] for s in log.spans()]
    assert [names.count(k) for k in ("apply", "apply.entry", "apply.exit")
            ] == [1, 1, 1]


def test_chrome_trace_holds_the_program_spans(tmp_path, bem_plan):
    """The ranges the spans open reach an exported Chrome trace."""
    n = bem_plan.src.tree.num_bodies
    _, prof = traced(lambda: bem_plan.apply(np.ones(n), p=5))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {ev.get("name") for ev in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"apply", "apply.entry", "matvec", "p2m", "m2l", "near",
            "apply.exit"} <= names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_span_encloses_its_kernel_on_the_card(card):
    """A kernel launched inside a span is launched (by the profiler's
    host stamp of the launch) between the span's stamps, and runs on the
    card between the span's two markers."""
    torch.cuda._sleep(1000)  # loaded before the trace
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with log.span("probe"):
            torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize(card)
    (_, start, end, _, _), = log.spans()
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    on_card = [ev for ev in events if ev.device_type() == DeviceType.CUDA]
    marks = sorted(ev.start_ns() for ev in on_card if ev.name() == MARKER)
    kernel, = [ev for ev in on_card if "spin" in ev.name().lower()]
    assert len(marks) == 2
    assert marks[0] < kernel.start_ns()
    assert kernel.start_ns() + kernel.duration_ns() <= marks[1]
    assert kernel.duration_ns() > 1_000_000  # 2e7 cycles: milliseconds
    launch, = [ev for ev in events if ev.device_type() == DeviceType.CPU
               and ev.correlation_id() == kernel.correlation_id()
               and "launch" in ev.name().lower()]
    assert start <= launch.start_ns() <= end
