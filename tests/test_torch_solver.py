"""GMRES of the PyTorch port against the JAX package's ``gmres_device``,
on the CPU at f64: the same sphere problems go through both solvers in
the slot layout, and the port must take the same number of iterations
with the same multipole order at every one of them (fixed, tiered,
continuous with its stall boost, flexible), and give the same solution
to 1e-9 (same algorithm; sums in another order move the iterates by
rounding only)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu.solver import gmres as jgm
from fmm_bem_tpu_torch.config import RelaxType
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel
from fmm_bem_tpu_torch.solver import gmres as tgm
from fmm_bem_tpu_torch.solver.api import solve_plan


@pytest.fixture(scope="module")
def plans():
    fields = make_panels(unit_sphere(4), K=3)
    jp = J.FmmPlan(
        JKernel(K=3), fields,
        J.FMMConfig(ncrit=32, dtype="float64", max_p=10),
    )
    tp = T.FmmPlan(
        TKernel(K=3), fields,
        T.FMMConfig(ncrit=32, dtype="float64", max_p=10), device="cpu",
    )
    n = len(fields["xyz"])
    ones = np.ones(n)
    rhs = {
        # second kind: dGdn system (flipped BC), RHS = G . 1, solution 1
        True: np.asarray(jp.apply(ones, p=5)[:, 0]),
        # first kind: G system, RHS = dGdn . 1, solution 1
        False: np.asarray(jp.apply_flipped_bc(ones, p=10)[:, 0]),
    }
    return jp, tp, rhs


def jax_solve(jp, b, cfg, flipped, p_fixed=None, flexible=False):
    mv, op4p, to_s, from_s, _ = jp.solver_ops_slots(flipped=flipped)
    x, info = jgm.gmres_device(
        mv, to_s(jnp.asarray(b)), operand_for_p=op4p,
        config=J.SolverConfig(**dataclasses.asdict(cfg)),
        p_fixed=p_fixed, flexible=flexible,
    )
    return np.asarray(from_s(x)), info


FIRST_KIND = dict(residual=1e-5, max_iters=100, restart=100, max_p=10, p_min=1)

CASES = {
    "second_kind_fixed_p": (
        True, dict(residual=1e-5, max_p=5, max_iters=60, restart=60), 5, False),
    "first_kind_tiers": (
        False, dict(FIRST_KIND, p_tiers=(3, 5, 10)), None, False),
    "first_kind_continuous": (False, dict(FIRST_KIND), None, False),
    "first_kind_continuous_tight": (
        False, dict(FIRST_KIND, residual=1e-8), None, False),
    "first_kind_tiers_flexible": (
        False, dict(FIRST_KIND, p_tiers=(3, 5, 10)), None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_iterations_and_schedule_as_jax(plans, case):
    jp, tp, rhs = plans
    flipped, cfg_kw, p_fixed, flexible = CASES[case]
    cfg = T.SolverConfig(**cfg_kw)
    jcfg = dataclasses.replace(
        cfg, relax_type=J.config.RelaxType(cfg.relax_type.value)
    )
    xj, ij = jax_solve(jp, rhs[flipped], jcfg, flipped, p_fixed, flexible)
    xt, it, mode = solve_plan(
        tp, rhs[flipped], cfg, flipped=flipped, p_fixed=p_fixed,
        flexible=flexible, device="cpu",
    )
    assert mode == "device-slots"
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations
    assert [h[2] for h in it.history] == [h[2] for h in ij.history]
    np.testing.assert_allclose(
        [h[1] for h in it.history], [h[1] for h in ij.history], rtol=1e-6
    )
    print(case, it.iterations, [h[2] for h in it.history],
          float(np.abs(xt - xj).max()))
    assert np.abs(xt - xj).max() <= 1e-9
    # the sphere's analytic solution is 1 (flat-panel error at 512 panels)
    assert np.linalg.norm(xt - 1.0) / np.sqrt(len(xt)) < 5e-2
    if p_fixed is None:
        assert len({h[2] for h in it.history}) > 1  # the order did relax


def test_solve_plan_refuses_another_device(plans):
    _, tp, rhs = plans
    with pytest.raises(ValueError, match="built for"):
        solve_plan(tp, rhs[True], device="cuda")


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"p_tiers": (3, 5, 10)},
        {"p_min": 5, "max_p": 16},
        {"relax_type": RelaxType.SIMONCINI},
        {"eps_c": 0.7, "eps_gamma": 0.45, "eps_p_lo": 2},
        {"eps_c": 0.7, "eps_gamma": 0.45, "p_tiers": (4, 8)},
    ],
    ids=["bouras", "tiers", "p_min", "simoncini", "calibrated",
         "calibrated_tiers"],
)
def test_device_predict_p_is_the_host_schedule(kw):
    cfg = T.SolverConfig(**{**dict(residual=1e-5, max_p=10, p_min=1), **kw})
    grid = np.concatenate([
        [1e-320, 1.0, 3.0], np.logspace(-12, 0.5, 241),
        2.0 ** -np.arange(0, 30),  # the boundaries of ceil(-log2)
    ])
    for boost in (0, 2, 7):
        for r in grid:
            want = cfg.schedule_p(float(r), boost=boost)
            assert tgm._device_predict_p(np.float64(r), cfg, boost) == want
            # the same residual as the JAX package's in-loop schedule
            if r in grid[::16]:
                jcfg = J.SolverConfig(**{
                    **dataclasses.asdict(cfg),
                    "relax_type": J.config.RelaxType(cfg.relax_type.value),
                })
                assert int(jgm._device_predict_p(
                    jnp.asarray(r), jcfg, boost)) == want


def test_device_predict_p_rounds_in_the_working_dtype():
    cfg = T.SolverConfig(residual=1e-5, max_p=30, p_min=1)
    for r in np.logspace(-6, 0, 97).astype(np.float32):
        jcfg = J.SolverConfig(residual=1e-5, max_p=30, p_min=1)
        assert tgm._device_predict_p(r, cfg) == int(
            jgm._device_predict_p(jnp.asarray(r), jcfg)
        )


class _Killed(RuntimeError):
    """Simulated process death mid-solve."""


def _ill_system(seed, n=90):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.logspace(0, 2, n)) @ Q.T
    return torch.as_tensor(A), torch.as_tensor(rng.standard_normal(n))


@pytest.mark.parametrize(
    "restart,die_after,flexible",
    [(300, 9, False), (300, 40, False), (12, 17, False), (300, 9, True)],
    ids=["first_block", "after_basis_growth", "second_restart_cycle",
         "flexible"],
)
def test_checkpoint_resume_is_bit_identical(tmp_path, restart, die_after,
                                            flexible):
    A, b = _ill_system(seed=32)
    path = str(tmp_path / "krylov.npz")
    cfg = T.SolverConfig(residual=1e-10, max_iters=300, restart=restart)
    kw = dict(config=cfg, p_fixed=1, checkpoint_path=path,
              checkpoint_every=4, flexible=flexible)

    x_ref, info_ref = tgm.gmres_device(lambda op, v, p: A @ v, b, **kw)
    assert info_ref.converged and info_ref.iterations > die_after
    assert not (tmp_path / "krylov.npz").exists()  # removed on convergence

    calls = [0]

    def mv_dying(op, v, p):
        calls[0] += 1
        if calls[0] > die_after:
            raise _Killed()
        return A @ v

    with pytest.raises(_Killed):
        tgm.gmres_device(mv_dying, b, **kw)
    assert (tmp_path / "krylov.npz").exists()

    x_res, info_res = tgm.gmres_device(lambda op, v, p: A @ v, b, **kw)
    assert info_res.converged
    assert info_res.iterations == info_ref.iterations
    assert torch.equal(x_res, x_ref)


def test_gmres_device_matches_jax_on_a_dense_system():
    """Plain restarted GMRES (no relaxation), restart shorter than the
    solve and longer than the first basis: growth and restarts."""
    A, b = _ill_system(seed=5)
    cfg = dict(residual=1e-9, max_iters=300, restart=40)
    xt, it = tgm.gmres_device(
        lambda op, v, p: A @ v, b, config=T.SolverConfig(**cfg), p_fixed=1)
    Aj = jnp.asarray(A.numpy())
    xj, ij = jgm.gmres_device(
        lambda op, v, p: Aj @ v, jnp.asarray(b.numpy()),
        config=J.SolverConfig(**cfg), p_fixed=1)
    assert it.converged and it.iterations == ij.iterations > 40
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-9
    # a right preconditioner passes through both forms
    d = torch.diagonal(A)
    xp, ip = tgm.fgmres_device(
        lambda op, v, p: A @ v, b, config=T.SolverConfig(**cfg), p_fixed=1,
        M=lambda r: r / d)
    assert ip.converged
    assert torch.linalg.vector_norm(A @ xp - b) / torch.linalg.vector_norm(b) < 1e-8


@pytest.mark.parametrize("tiers", [None, (2, 4, 8, 12)], ids=["continuous", "tiers"])
def test_stall_guard_raises_the_order_like_jax(tiers):
    """An operator whose error at order p is far above the 2^-p the
    schedule assumes: the relaxed solve stalls at low order, the guard
    raises the order (a boost, or the floor tier), and the solve takes
    the same orders at the same iterations in both packages."""
    n = 120
    rng = np.random.default_rng(9)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1.0, 4.0, n)) @ Q.T
    E = rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    cfg = dict(residual=1e-8, max_iters=200, restart=200, max_p=12, p_min=1,
               p_tiers=tiers)

    def noisy(lib):
        A_, E_ = lib(A), lib(E)
        return lambda op, v, p: A_ @ v + (0.5 ** p) * 40.0 * (E_ @ v)

    xt, it = tgm.gmres_device(
        noisy(torch.as_tensor), torch.as_tensor(b), config=T.SolverConfig(**cfg))
    xj, ij = jgm.gmres_device(
        noisy(jnp.asarray), jnp.asarray(b), config=J.SolverConfig(**cfg))
    sched = [h[2] for h in it.history]
    assert it.converged == ij.converged
    assert it.iterations == ij.iterations
    assert sched == [h[2] for h in ij.history]
    # the order fell with the residual and was raised again by the guard
    assert any(b_ > a_ for a_, b_ in zip(sched, sched[1:]))
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-9
