"""FMGMRES of the PyTorch port against the JAX package, on the CPU at
f64: ``fmgmres`` (inner relaxed GMRES as the flexible preconditioner of
the outer host loop), ``make_inner_pc_device`` and ``fmgmres_device`` on
the dense systems of tests/test_gmres.py, and ``fmgmres`` on the
128-panel Stokes sphere as the reference program's -fmgmres runs it:
the same outer iterations and orders, solutions to 1e-10 and the drag
to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.stokes_bem import StokesBEMKernel as JStokes
from fmm_bem_tpu.solver import fmgmres as jfm
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel as TStokes
from fmm_bem_tpu_torch.solver import fmgmres as tfm
from fmm_bem_tpu_torch.solver import gmres as tgm


def jcfg(**kw):
    return J.SolverConfig(**kw)


def tcfg(**kw):
    return T.SolverConfig(**kw)


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def same_solve(ij, it, xj, xt, tol):
    """Same iterations, orders and convergence; residual histories to
    1e-12 of ||b||; solutions to ``tol`` of their largest entry."""
    assert it.iterations == ij.iterations
    assert it.converged == ij.converged
    assert [h[2] for h in it.history] == [h[2] for h in ij.history]
    rj = np.array([h[1] for h in ij.history])
    rt = np.array([h[1] for h in it.history])
    assert np.abs(rt - rj).max(initial=0.0) <= 1e-12
    assert rel(xt.numpy(), xj) <= tol


def fm_system(seed, n, top):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.logspace(0, top, n)) @ Q.T
    return A, rng.standard_normal(n)


def test_fmgmres_matches_jax_dense():
    A, b = fm_system(20, 120, 3)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    cfg = dict(residual=1e-8, max_iters=200, restart=200)
    xj, ij = jfm.fmgmres(lambda v, p: Aj @ v, b, config=jcfg(**cfg),
                         inner_iters=20, inner_tol=1e-2, p_inner=1)
    xt, it = tfm.fmgmres(lambda v, p: At @ v, torch.as_tensor(b),
                         config=tcfg(**cfg), inner_iters=20, inner_tol=1e-2,
                         p_inner=1)
    same_solve(ij, it, xj, xt, tol=1e-10)
    _, i0 = tgm.gmres(lambda v, p: At @ v, torch.as_tensor(b),
                      config=tcfg(**cfg), p_fixed=1)
    assert it.converged and it.iterations < i0.iterations / 2


def test_fmgmres_device_matches_jax_dense():
    A, b = fm_system(21, 100, 2.5)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    cfg = dict(residual=1e-8, max_iters=120, restart=120)
    xj, ij = jfm.fmgmres_device(
        lambda op, v, p: Aj @ v, b, operand_for_p=lambda p: None,
        config=jcfg(**cfg), inner_k=10, p_inner=1)
    xt, it = tfm.fmgmres_device(
        lambda op, v, p: At @ v, torch.as_tensor(b),
        operand_for_p=lambda p: None, config=tcfg(**cfg), inner_k=10,
        p_inner=1)
    assert it.converged and it.iterations == ij.iterations
    assert [h[2] for h in it.history] == [h[2] for h in ij.history]
    assert rel(xt.numpy(), xj) <= 1e-10
    _, i0 = tgm.gmres_device(lambda op, v, p: At @ v, torch.as_tensor(b),
                             config=tcfg(**cfg), p_fixed=1)
    assert it.iterations < i0.iterations / 2


@pytest.mark.parametrize("k", [3, 6])
def test_make_inner_pc_device_matches_jax(k):
    A, b = fm_system(22, 60, 2)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    Mj = jfm.make_inner_pc_device(lambda op, v, p: Aj @ v, None, 1, k=k)
    Mt = tfm.make_inner_pc_device(lambda op, v, p: At @ v, None, 1, k=k)
    want = np.asarray(Mj(jnp.asarray(b)))
    assert rel(Mt(torch.as_tensor(b)).numpy(), want) <= 1e-12
    zero = Mt(torch.zeros(60, dtype=torch.float64))
    assert torch.equal(zero, torch.zeros_like(zero))


def test_fmgmres_on_the_stokes_sphere_matches_jax():
    """FMGMRES on the 128-panel Stokes sphere as the reference program's
    -fmgmres runs it (p = 8, inner p = p_min = 5, tiers (3, 5, 8)): the
    JAX outer iterations, the drag to 1e-10 of the JAX drag (the
    reference's traction sign put in), fewer outer iterations than the
    plain relaxed solve."""
    fields = make_panels(unit_sphere(3), K=4)
    n = len(fields["xyz"])
    cfgp = dict(ncrit=32, dtype="float64", max_p=8)
    jp = J.FmmPlan(JStokes(K=4, fine_K=19, mu=1e-3), fields,
                   J.FMMConfig(**cfgp))
    tk = TStokes(K=4, fine_K=19, mu=1e-3)
    tk.traction_far_scale = 0.5  # the reference's sign (ROADMAP.md C)
    tp = T.FmmPlan(tk, fields, T.FMMConfig(**cfgp), device="cpu")
    b = np.tile([4 * np.pi, 0.0, 0.0], (n, 1)).reshape(-1)
    cfg = dict(residual=1e-5, max_p=8, p_min=5, p_tiers=(3, 5, 8))
    jmv = lambda x, p: jp.apply(x.reshape(n, 3), p=p).reshape(-1)
    tmv = lambda x, p: tp.apply(x.reshape(n, 3), p=p).reshape(-1)
    xj, ij = jfm.fmgmres(jmv, b, config=jcfg(**cfg), inner_iters=10,
                         inner_tol=1e-1, p_inner=5)
    xt, it = tfm.fmgmres(tmv, torch.as_tensor(b), config=tcfg(**cfg),
                         inner_iters=10, inner_tol=1e-1, p_inner=5)
    assert it.converged and it.iterations == ij.iterations
    area = np.asarray(fields["area"])
    fj = float((np.asarray(xj).reshape(n, 3)[:, 0] * area).sum())
    ft = float((xt.numpy().reshape(n, 3)[:, 0] * area).sum())
    assert abs(ft - fj) <= 1e-10 * abs(fj)
    _, i0 = tgm.gmres(tmv, torch.as_tensor(b), config=tcfg(**cfg))
    assert it.iterations < i0.iterations
