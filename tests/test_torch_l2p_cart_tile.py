"""The L2P of the Yukawa BEM plans as one kernel (``ops/l2p_cart_tile.py``,
``csrc/l2p_cart_tile.cu``).

On the CPU, in f64: the plain version ``l2p_cart_tiles_reference``,
which the plan's ``_l2p_slots`` takes for a ``YukawaBEMKernel`` (its
``l2p_tile`` marker names ``l2p_cart_tile``), against the eager
``YukawaBEMKernel.l2p`` per slot on hand-made tables (orders 1 to 10,
both BC flags in one tile, padded slots), whole matvecs and a relaxed
solve against the eager route every other kernel keeps (the marker
switched off on the instance), the marker's route, the wrapper's checks,
and a model of the kernel's walk (running products in i, j, k, each
term at its degree-ordered position) against the eager monomials.  The
tests marked ``card`` hold the CUDA kernel to the plain version on the
card and skip without one.  This file does not import JAX, so they run
where JAX is not installed: ``python3 -m pytest -o addopts=""
--noconftest tests/test_torch_l2p_cart_tile.py -m card``."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.config import Evaluator
from fmm_bem_tpu_torch.executor import graphs as G
from fmm_bem_tpu_torch.executor import plan as plan_mod
from fmm_bem_tpu_torch.kernels import cartesian as ct
from fmm_bem_tpu_torch.kernels.cartesian import (
    LaplaceCartesianKernel,
    YukawaKernel,
)
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.stokes import StokesKernel
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.ops import l2p_cart_tile as lc
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.utils.metrics import log

MAX_P = 8


def tables(p, nl=5, K=8, nbox=9, dtype=torch.float64, device="cpu",
           seed=1):
    """Hand-made inputs: ``nl`` target leaves of ``K`` slots among
    ``nbox`` boxes, seeded expansion rows, offsets of a leaf's size,
    both BC flags in every tile and the last slots of each leaf padded
    (leaf b has K - b real slots; leaf 0 is full)."""
    rng = np.random.default_rng(seed)
    n = nl * K
    mask = np.arange(K)[None, :] < (K - np.arange(nl))[:, None]
    bc = rng.integers(0, 2, n)
    bc[:2] = (0, 1)
    return dict(
        L=torch.as_tensor(rng.standard_normal((nbox, 2 * ct.num_terms(p))),
                          dtype=dtype, device=device),
        leaves=torch.as_tensor(rng.permutation(nbox)[:nl], device=device),
        dn=torch.as_tensor(rng.uniform(-0.9, 0.9, (n, 3)), dtype=dtype,
                           device=device),
        bc=torch.as_tensor(bc, dtype=dtype, device=device),
        mask=torch.as_tensor(mask.reshape(-1), device=device),
        p=p,
    )


def per_slot(tb, kappa):
    """The eager ``YukawaBEMKernel.l2p`` at ``kappa``, one slot at a
    time, on the slot's own leaf row; padded slots 0."""
    kern = YukawaBEMKernel(kappa=kappa)
    p, n = tb["p"], tb["dn"].shape[0]
    K = n // tb["leaves"].shape[0]
    out = torch.zeros((n, 1), dtype=tb["L"].dtype)
    for s in range(n):
        if not tb["mask"][s]:
            continue
        row = tb["L"][tb["leaves"][s // K]].reshape(1, 2, -1)
        out[s] = kern.l2p({"bc": tb["bc"][s:s + 1]}, row,
                          tb["dn"][s:s + 1], None, p)[0]
    return out


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("kappa", [0.125, 2.0])
@pytest.mark.parametrize("p", [1, 3, 5, 8, 10])
def test_reference_is_the_eager_l2p(p, kappa):
    """The plain version gives the eager ``YukawaBEMKernel.l2p`` of each
    slot to 1e-12, both BC flags in one tile, padded slots exactly 0."""
    tb = tables(p)
    got = lc.l2p_cart_tiles_reference(**tb)
    assert got.shape == (tb["dn"].shape[0], 1)
    assert rel(got, per_slot(tb, kappa)) <= 1e-12
    assert bool((got[~tb["mask"]] == 0).all())
    real = tb["mask"]
    assert set(tb["bc"][real].tolist()) == {0.0, 1.0}
    assert bool((got[real] != 0).all())


def tile_walk(L, leaf, d, second, p):
    """A model of the kernel's walk for one slot, on the host: x^i / i!,
    y^j / j! and z^k / k! as running products with the factors of
    ``term_table``, term (i, j, k) read at n(n+1)(n+2)/6 + u(u+1)/2 + k
    of the component the flag selects, negated for the second."""
    tab = lc.term_table(p, torch.float64, "cpu").numpy()
    nt = ct.num_terms(p)
    c = L[leaf, nt:] if second else L[leaf, :nt]
    x, y, z = d
    acc, xi = 0.0, 1.0
    for i in range(p + 1):
        yj = 1.0
        for j in range(p - i + 1):
            zk = 1.0
            for k in range(p - i - j + 1):
                n, u = i + j + k, j + k
                acc += c[n * (n + 1) * (n + 2) // 6 + u * (u + 1) // 2
                         + k] * (xi * yj * zk)
                zk *= z * tab[k + 1]
            yj *= y * tab[j + 1]
        xi *= x * tab[i + 1]
    return -acc if second else acc


@pytest.mark.parametrize("p", [0, 1, 3, 8, 10])
def test_tile_walk_is_the_eager_l2p(p):
    """The kernel's arithmetic (``tile_walk``) gives the plain version
    to 1e-13 at every real slot."""
    tb = tables(p, seed=p)
    want = lc.l2p_cart_tiles_reference(**tb)[:, 0].numpy()
    L = tb["L"].numpy()
    K = tb["dn"].shape[0] // tb["leaves"].shape[0]
    for s in np.flatnonzero(tb["mask"].numpy()):
        got = tile_walk(L, int(tb["leaves"][s // K]), tb["dn"][s].numpy(),
                        bool(tb["bc"][s]), p)
        assert abs(got - want[s]) <= 1e-13 * np.abs(want).max(), s


def test_term_table():
    """The kernel's table: 1/m at m = 1 .. p + 1, 0 at 0; cached per
    (p, dtype, device)."""
    p = 5
    tab = lc.term_table(p, torch.float64, "cpu").numpy()
    assert tab.shape == (p + 2,) and tab[0] == 0.0
    assert list(tab[1:]) == [1.0 / m for m in range(1, p + 2)]
    assert lc.term_table(p, torch.float64, "cpu") is \
        lc.term_table(p, torch.float64, "cpu")


@pytest.mark.parametrize("case", ["past_nbox", "negative"])
def test_reference_reads_a_bad_leaf_as_empty(case):
    """A box id outside [0, nbox) reads as an empty expansion, as the
    kernel reads it: the leaf's slots are 0, the others unchanged."""
    tb = tables(3)
    want = lc.l2p_cart_tiles_reference(**tb)
    leaves = tb["leaves"].clone()
    leaves[1] = {"past_nbox": 9, "negative": -1}[case]
    got = lc.l2p_cart_tiles_reference(**{**tb, "leaves": leaves})
    K = 8
    assert bool((got[K:2 * K] == 0).all())
    assert torch.equal(torch.cat([got[:K], got[2 * K:]]),
                       torch.cat([want[:K], want[2 * K:]]))


@pytest.mark.parametrize("case", [
    "L_int", "L_width", "dn_f32", "bc_f32", "leaves_int32", "mask_float",
    "dn_shape", "bc_shape", "leaves_2d", "no_leaves", "mask_device",
    "not_contiguous", "p_negative", "p_past_max",
])
def test_kernel_args_are_checked(case):
    """What the CUDA entry point refuses, checked on CPU tensors: a wrong
    dtype, device, shape or contiguity, no leaves, and an order outside
    [0, ``MAX_ORDER``] (that order itself is taken)."""
    tb = tables(3)
    bad = {
        "L_int": dict(L=tb["L"].long()),
        # the order's spherical width: the Laplace BEM rows
        "L_width": dict(L=tb["L"][:, :2 * 16].contiguous()),
        "dn_f32": dict(dn=tb["dn"].float()),
        "bc_f32": dict(bc=tb["bc"].float()),
        "leaves_int32": dict(leaves=tb["leaves"].int()),
        "mask_float": dict(mask=tb["mask"].double()),
        "dn_shape": dict(dn=tb["dn"][:-1].contiguous()),
        "bc_shape": dict(bc=tb["bc"][:-1].contiguous()),
        "leaves_2d": dict(leaves=tb["leaves"][:, None].contiguous()),
        "no_leaves": dict(leaves=tb["leaves"][:0].contiguous()),
        "mask_device": dict(mask=torch.empty(tb["mask"].shape,
                                             dtype=torch.bool,
                                             device="meta")),
        "not_contiguous": dict(dn=tb["dn"].T.contiguous().T),
        "p_negative": dict(p=-1),
        "p_past_max": dict(tables(lc.MAX_ORDER + 1)),
    }[case]
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        lc.check_kernel_args(**{**tb, **bad})
    assert lc.check_kernel_args(**tb) == (5, 8)
    assert lc.check_kernel_args(**tables(lc.MAX_ORDER)) == (5, 8)


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors ``l2p_cart_tiles`` is the plain version and
    launches nothing."""
    tb = tables(3)
    before = lc.l2p_cart_tiles.launches
    assert torch.equal(lc.l2p_cart_tiles(**tb),
                       lc.l2p_cart_tiles_reference(**tb))
    assert lc.l2p_cart_tiles.launches == before


# ------------------------------------------------------------ the plan


def yukawa_plan(device="cpu", dtype="float64", max_p=MAX_P, kappa=0.125):
    """A Yukawa BEM plan on a 512-panel sphere: 56 target leaves of 13
    slots, 216 of them padded."""
    return T.FmmPlan(YukawaBEMKernel(K=3, kappa=kappa),
                     make_panels(unit_sphere(4), K=3),
                     T.FMMConfig(ncrit=16, dtype=dtype, max_p=max_p),
                     device=device)


@pytest.fixture(scope="module")
def plan():
    pl = yukawa_plan()
    assert pl.kernel.l2p_tile == "l2p_cart_tile"
    assert bool((~pl.device_data(MAX_P)["t_slot_mask"]).any())
    return pl


@contextlib.contextmanager
def eager(plan):
    """The plan's kernel without its ``l2p_tile`` marker: the eager
    ``l2p``."""
    plan.kernel.l2p_tile = None
    try:
        yield
    finally:
        del plan.kernel.l2p_tile


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("p", [3, MAX_P])
def test_matvec_slots_unchanged(plan, p, flipped):
    """A whole slot matvec through the kernel route equals the eager one
    to 1e-12, on the plain and the flipped BC variant."""
    mv, op4p, to_s, _, _ = plan.solver_ops_slots(flipped=flipped)
    q = np.random.default_rng(4).standard_normal(plan.src.tree.num_bodies)
    x = to_s(q)
    got = mv(op4p(p), x, p)
    with eager(plan):
        want = mv(op4p(p), x, p)
    assert rel(got, want) <= 1e-12


def test_relaxed_solve_unchanged(plan):
    """The relaxed first-kind solve (tiers 3, 5, 8, as the benchmark's
    Yukawa cell) through the kernel route takes the eager route's
    iterations, orders and residuals, and its solution to 1e-10."""
    pts = plan.src.fields["xyz"]
    phi = 1.0 / np.linalg.norm(pts - np.array([0.2, 1.8, 0.3]), axis=1)
    cfg = T.SolverConfig(residual=1e-5, restart=100, max_p=MAX_P, p_min=1,
                         p_tiers=(3, 5, MAX_P))
    b = plan.apply_flipped_bc(phi[np.argsort(plan.src.tree.perm)],
                              p=MAX_P).numpy()
    x, info, mode = solve_plan(plan, b, cfg)
    with eager(plan):
        xe, infoe, _ = solve_plan(plan, b, cfg)
    assert mode == "device-slots" and info.converged
    assert info.iterations == infoe.iterations
    assert [h[2] for h in info.history] == [h[2] for h in infoe.history]
    np.testing.assert_allclose([h[1] for h in info.history],
                               [h[1] for h in infoe.history], rtol=1e-8)
    assert np.abs(x - xe).max() / np.abs(xe).max() <= 1e-10


def profiled_counts(fn):
    log.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    counts = {}
    for (name, _), n in log.counts().items():
        counts[name] = counts.get(name, 0) + n
    log.clear_spans()
    return counts


@pytest.mark.parametrize("kernel", [
    "yukawa_bem", "laplace_bem", "laplace_points", "yukawa_points",
    "laplace_cartesian", "stokes_bem", "stokes_points",
])
def test_the_marker_picks_the_route(kernel):
    """Only ``YukawaBEMKernel`` names the L2P tile kernel; the Laplace BEM
    (its table), point Laplace (``eval_regular``), point Yukawa and
    Cartesian Laplace (the eager ``powers`` and gradient) and Stokes
    kernels have no marker, and ``cuda_kernels`` starts its build only
    for a plan whose matvec runs L2P."""
    kern = {
        "yukawa_bem": YukawaBEMKernel, "laplace_bem": LaplaceBEMKernel,
        "laplace_points": LaplaceKernel, "yukawa_points": YukawaKernel,
        "laplace_cartesian": LaplaceCartesianKernel,
        "stokes_bem": StokesBEMKernel, "stokes_points": StokesKernel,
    }[kernel]()
    marker = getattr(kern, "l2p_tile", None)
    names = plan_mod.cuda_kernels(kern, T.FMMConfig(), False)
    if kernel == "yukawa_bem":
        assert marker == "l2p_cart_tile" and marker in names
        for far_off in ({"local_evaluation": True},
                        {"evaluator": Evaluator.TREECODE}):
            assert marker not in plan_mod.cuda_kernels(
                kern, T.FMMConfig(**far_off), False)
    else:
        assert marker is None
        assert "l2p_cart_tile" not in names


@pytest.mark.parametrize("marked", [True, False])
def test_which_route_runs(plan, marked, monkeypatch):
    """Each ``apply`` (the plain operator and a target-field override)
    counts ``l2p.kernel`` once and calls ``l2p_cart_tiles`` once where
    the marker is set, and neither without it."""
    if not marked:
        monkeypatch.setattr(plan.kernel, "l2p_tile", None)
    called = []
    wrapper = plan_mod.l2p_cart_tiles

    def counted(*a, **k):
        called.append(1)
        return wrapper(*a, **k)

    monkeypatch.setattr(plan_mod, "l2p_cart_tiles", counted)
    q = np.random.default_rng(2).standard_normal(plan.src.tree.num_bodies)
    counts = profiled_counts(lambda: (
        plan.apply(q, p=3),
        plan.apply(q, p=3, target_fields=plan._flipped_fields())))
    assert counts.get("l2p.kernel", 0) == len(called) == (2 if marked else 0)


def test_a_marker_naming_no_kernel_raises(plan, monkeypatch):
    """A marker that names no L2P kernel raises at the matvec, before
    anything is counted, and does not fall through to another route."""
    monkeypatch.setattr(plan.kernel, "l2p_tile", "l2p_tile")
    q = np.random.default_rng(2).standard_normal(plan.src.tree.num_bodies)
    counts = {}
    with pytest.raises(ValueError, match="l2p_tile"):
        counts = profiled_counts(lambda: plan.apply(q, p=3))
    assert "l2p.kernel" not in counts


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_the_card(card, dtype, tol):
    """The kernel against the plain version on the card, orders 0 to 10
    and ``MAX_ORDER``, at the bench plan's tile (64 slots) and at small
    and large ones: relative to the largest value, padded slots exactly
    0, two launches bit-equal, and a box id outside [0, nbox) read as
    empty."""
    for p in (*range(11), lc.MAX_ORDER):
        for nl, K in ((600, 64), (7, 5), (3, 300)):
            tb = tables(p, nl=nl, K=K, nbox=nl + 40, dtype=dtype,
                        device=card, seed=p)
            got = lc.l2p_cart_tiles(**tb)
            again = lc.l2p_cart_tiles(**tb)
            want = lc.l2p_cart_tiles_reference(**tb)
            torch.cuda.synchronize()
            assert rel(got, want) <= tol, (p, nl, K)
            assert bool((got[~tb["mask"]] == 0).all())
            assert torch.equal(got, again)
    tb = tables(3, dtype=dtype, device=card)
    tb["leaves"][1] = -1
    got = lc.l2p_cart_tiles(**tb)
    want = lc.l2p_cart_tiles_reference(**tb)
    torch.cuda.synchronize()
    assert torch.equal(got, want) or rel(got, want) <= tol
    assert bool((got[8:16] == 0).all())


@pytest.mark.card
def test_l2p_phase_is_graphed_on_the_card(card):
    """A Yukawa BEM plan on the card: an operand's first matvec runs the
    L2P phase eagerly (one launch), its second captures it (one launch),
    its third replays the graph (no launch from the host) with every far
    phase graphed; each graphed result equals the eager phases' on the
    same vector, and the card's matvec the CPU plan's to 1e-12 (f64)."""
    plan = yukawa_plan(device=card)
    mv, op4p, to_s, _, _ = plan.solver_ops_slots()
    op = op4p(MAX_P)
    q = np.random.default_rng(6).standard_normal(plan.src.tree.num_bodies)
    x = to_s(q)
    old = plan_mod.phases_for
    plan_mod.phases_for = lambda aux, d, pool: G.EAGER
    try:
        want = mv(op, x, MAX_P).clone()
    finally:
        plan_mod.phases_for = old
    launches = []
    for _ in range(3):
        before = lc.l2p_cart_tiles.launches
        counts = profiled_counts(lambda: launches.append(
            mv(op, x, MAX_P).clone()))
        launches[-1] = (launches[-1], lc.l2p_cart_tiles.launches - before,
                        counts)
    torch.cuda.synchronize()
    for i, (got, n, counts) in enumerate(launches):
        assert rel(got, want) <= 1e-12, i
        assert counts.get("l2p.kernel") == 1, i
        assert n == (1 if i < 2 else 0), (i, n)
    counts = launches[2][2]
    assert counts.get("matvec.graph") == 5 and "matvec.eager" not in counts
    cpu = yukawa_plan()
    mvc, op4pc, to_sc, _, _ = cpu.solver_ops_slots()
    assert rel(launches[2][0].cpu(), mvc(op4pc(MAX_P), to_sc(q), MAX_P)) \
        <= 1e-12
