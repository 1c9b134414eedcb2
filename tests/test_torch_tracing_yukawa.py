"""The tracing of what the Yukawa sphere cell runs, on the CPU:

- ``gmres.stall_raises`` counts each raise of the floor tier by the
  stall guard (tiered schedule) and each block the guard ends as stalled
  (one order a block), and reads 0 at a fixed order;
- in a relaxed solve on a small Yukawa BEM plan with level-skewed pairs
  every phase span records once a matvec, and M2P takes the kernel route
  (``ops/m2p_cart_tile.py``) once a matvec, or the eager route once a
  matvec where the kernel's marker is switched off (an ``apply``'s
  phases: ``test_torch_tracing.py``), and L2P takes its kernel route
  (``ops/l2p_cart_tile.py``, counted ``l2p.kernel``) once a matvec,
  which a Laplace BEM solve (the L2P table) never counts.

Spans and counters record only under a ``torch.profiler`` session
(``fmm_bem_tpu_torch/utils/metrics.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.solver.gmres import gmres_device
from fmm_bem_tpu_torch.utils.metrics import log

STALL = "gmres.stall_raises"


@pytest.fixture(autouse=True)
def clean_log():
    log.clear_spans()
    yield
    log.clear_spans()


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def totals():
    """The counters summed over operations, by name."""
    out = {}
    for (name, _), n in log.counts().items():
        out[name] = out.get(name, 0) + n
    return out


#: case -> (p_tiers, p_fixed, orders of the 20 iterations, stall raises)
STALL_CASES = {
    # the floor tier rises after each window of 4 iterations without a
    # halving: 3 -> 5 -> 8, then stays at the top (no more raises)
    "tiered": ((3, 5, 8), None, [3] * 5 + [5] * 5 + [8] * 10, 2),
    # one order a block: each block ends as stalled after 5 iterations
    "one_order_a_block": (None, None, None, 4),
    "p_fixed": ((3, 5, 8), 5, [5] * 20, 0),
}


@pytest.mark.parametrize("case", list(STALL_CASES))
def test_stall_raises_count_the_stall_guard(case):
    """GMRES on a cyclic shift from ``e_1`` makes no progress for n - 1
    iterations (the residual stays 1), so the stall guard fires after
    every window; the tolerance 0.5 schedules order 1, the lowest tier."""
    tiers, p_fixed, orders, raises = STALL_CASES[case]
    n = 30
    b = torch.zeros(n, dtype=torch.float64)
    b[0] = 1.0
    cfg = T.SolverConfig(residual=0.5, max_iters=20, restart=20, max_p=8,
                         p_min=1, p_tiers=tiers)
    x, info = traced(lambda: gmres_device(
        lambda op, v, p: torch.roll(v, 1), b, config=cfg, p_fixed=p_fixed))
    assert not info.converged and info.iterations == 20
    if orders is not None:
        assert [h[2] for h in info.history] == orders
    assert totals()[STALL] == raises


@pytest.fixture(scope="module")
def yukawa_skewed():
    """A Yukawa BEM plan on a unit sphere beside a sphere fifty times
    smaller: level-skewed pairs (M2P) and per-level translation classes;
    a low order keeps the build short."""
    small = unit_sphere(4) * 0.02 + np.array([1.3, 0.0, 0.0])
    tris = np.concatenate([unit_sphere(3), small])
    plan = T.FmmPlan(YukawaBEMKernel(K=3, kappa=0.125),
                     make_panels(tris, K=3),
                     T.FMMConfig(ncrit=8, dtype="float64", max_p=4),
                     device="cpu")
    assert len(plan.m2p_src) > 0
    assert plan.kernel.m2p_tile == "m2p_cart_tile"
    return plan


def test_yukawa_solve_counts_kernel_m2p_per_matvec(yukawa_skewed):
    """A relaxed Yukawa solve: one ``m2p.kernel`` a ``matvec`` span
    (Arnoldi steps and true residuals), never ``m2p.eager``; the stall
    counter is registered for the solve."""
    solve_counts(yukawa_skewed, "m2p.kernel", "m2p.eager")


def test_yukawa_solve_counts_eager_m2p_per_matvec(yukawa_skewed,
                                                  monkeypatch):
    """The same solve with the kernel's marker switched off (a kernel
    without an M2P tile kernel): one ``m2p.eager`` a ``matvec`` span,
    never ``m2p.kernel``."""
    monkeypatch.setattr(yukawa_skewed.kernel, "m2p_tile", None)
    solve_counts(yukawa_skewed, "m2p.eager", "m2p.kernel")


def solve_counts(plan, route, other):
    """A relaxed solve on ``plan``: its M2P route counted once a
    ``matvec`` span, the other never, every phase span once a matvec,
    the stall counter registered."""
    n = plan.src.tree.num_bodies
    b = plan.apply_flipped_bc(np.ones(n), p=4)[:, 0].numpy()
    cfg = T.SolverConfig(residual=1e-5, max_iters=8, restart=8, max_p=4,
                         p_min=1, p_tiers=(3, 4))
    _, info, mode = traced(lambda: solve_plan(plan, b, cfg))
    assert mode == "device-slots" and info.iterations == 8
    names = [s[0] for s in log.spans()]
    matvecs = names.count("matvec")
    assert matvecs == info.iterations + names.count("solve.true_resid")
    counts = totals()
    assert counts[route] == matvecs and other not in counts
    assert STALL in counts
    for phase in ("p2m", "m2m", "m2l", "l2l", "l2p", "m2p", "near"):
        assert names.count(phase) == matvecs, phase


@pytest.fixture(scope="module")
def laplace_bem_plan():
    """A Laplace BEM plan on a small sphere: its L2P is the table."""
    return T.FmmPlan(LaplaceBEMKernel(K=3), make_panels(unit_sphere(3), K=3),
                     T.FMMConfig(ncrit=8, dtype="float64", max_p=4),
                     device="cpu")


@pytest.mark.parametrize("kernel", ["yukawa_bem", "laplace_bem"])
def test_solve_counts_l2p_kernel_per_matvec(kernel, yukawa_skewed,
                                            laplace_bem_plan):
    """A relaxed solve: one ``l2p.kernel`` a ``matvec`` span on the
    Yukawa BEM plan (its ``l2p_tile`` marker), none on the Laplace BEM
    plan."""
    plan = yukawa_skewed if kernel == "yukawa_bem" else laplace_bem_plan
    n = plan.src.tree.num_bodies
    b = plan.apply_flipped_bc(np.ones(n), p=4)[:, 0].numpy()
    cfg = T.SolverConfig(residual=1e-5, max_iters=8, restart=8, max_p=4,
                         p_min=1, p_tiers=(3, 4))
    _, info, _ = traced(lambda: solve_plan(plan, b, cfg))
    matvecs = [s[0] for s in log.spans()].count("matvec")
    assert matvecs >= info.iterations > 0
    want = matvecs if kernel == "yukawa_bem" else 0
    assert totals().get("l2p.kernel", 0) == want
