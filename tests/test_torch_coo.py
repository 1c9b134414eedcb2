"""The COO near-field replay of the PyTorch port (``near_panel=False``:
every near entry kept as (row, col, value) and replayed by the kernel's
``near_matvec`` inside the slot-layout matvec) and its drop tolerance,
against the JAX package, on the CPU at f64.  Inputs are made with numpy
from a seed and handed to both packages.

- The COO plan against the panel plan of the same panels (the cases of
  the JAX package's tests/test_ops.py): Laplace BEM to 1e-11 absolute,
  Stokes BEM to 1e-9 of the result's scale, Yukawa BEM to 1e-11; each
  COO plan also against the JAX COO plan (entries array for array, the
  matvec to 1e-12 relative).
- ``droptol`` at the 25th percentile of the entry magnitudes (the case
  of tests/test_plan.py): the kept fraction in (0.5, 0.9), the matvec
  changed by a relative (0, 0.5), the kept entries the JAX plan's.
- ``solve_plan`` on a COO plan runs the device solver on the slot
  operator (mode ``"device-slots"``; the JAX package's mode
  ``"device"``) with the JAX package's iteration count and order
  schedule, the solution to 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JLB
from fmm_bem_tpu.kernels.stokes_bem import StokesBEMKernel as JSB
from fmm_bem_tpu.kernels.yukawa_bem import YukawaBEMKernel as JYB
from fmm_bem_tpu.solver.api import solve_plan as j_solve_plan
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TLB
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel as TSB
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel as TYB
from fmm_bem_tpu_torch.solver.api import solve_plan

TOL = 1e-12

#: kernel name -> (JAX kernel, port kernel, charge dim)
KERNELS = {
    "laplace": (lambda: JLB(K=3), lambda: TLB(K=3), 1),
    "yukawa": (lambda: JYB(K=3, kappa=0.125), lambda: TYB(K=3, kappa=0.125),
               1),
    "stokes": (lambda: JSB(K=4, fine_K=17, mu=1e-3),
               lambda: TSB(K=4, fine_K=17, mu=1e-3), 3),
}


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def npy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=sorted(KERNELS))
def coo_plans(request):
    jk, tk, cdim = KERNELS[request.param]
    # a 128-panel sphere at ncrit 8: M2L pairs beside the near field
    fields = make_panels(unit_sphere(3), K=4 if cdim == 3 else 3)
    cfg = dict(ncrit=8, dtype="float64", max_p=6 if cdim == 1 else 4)
    tpanel = T.FmmPlan(tk(), fields, T.FMMConfig(**cfg), device="cpu")
    tcoo = T.FmmPlan(tk(), fields, T.FMMConfig(near_panel=False, **cfg),
                     device="cpu")
    jcoo = J.FmmPlan(jk(), fields, J.FMMConfig(near_panel=False, **cfg))
    n = len(fields["xyz"])
    rng = np.random.default_rng(1)
    q = rng.standard_normal(n) if cdim == 1 else rng.standard_normal((n, cdim))
    return request.param, q, tpanel, tcoo, jcoo


def test_coo_matches_panel_plan(coo_plans):
    name, q, tpanel, tcoo, _ = coo_plans
    assert not tcoo._use_panels
    assert len(tcoo.lists.m2l_pairs) > 0
    assert tcoo.solver_ops_slots() is not None
    for p in (3, 5):
        a = npy(tpanel.apply(q, p=p))
        b = npy(tcoo.apply(q, p=p))
        atol = 1e-9 * np.abs(b).max() if name == "stokes" else 1e-11
        assert np.allclose(a, b, atol=atol), (name, p)
    if name != "stokes":
        fa = npy(tpanel.apply_flipped_bc(q, p=5))
        fb = npy(tcoo.apply_flipped_bc(q, p=5))
        assert np.allclose(fa, fb, atol=1e-11)


def test_coo_matches_jax_coo(coo_plans):
    name, q, _, tcoo, jcoo = coo_plans
    np.testing.assert_array_equal(tcoo.near_rows, jcoo.near_rows)
    np.testing.assert_array_equal(tcoo.near_cols, jcoo.near_cols)
    np.testing.assert_allclose(
        tcoo.near_vals, np.asarray(jcoo.near_vals), rtol=1e-13, atol=1e-15)
    for p in (3, tcoo.config.max_p):
        assert rel(tcoo.apply(q, p=p), jcoo.apply(q, p=p)) <= TOL, (name, p)
    if name != "stokes":
        assert rel(tcoo.apply_flipped_bc(q, p=5),
                   jcoo.apply_flipped_bc(q, p=5)) <= TOL


def test_near_droptol_inexact_matvec():
    fields = make_panels(unit_sphere(3), K=3)
    n = len(fields["xyz"])
    q = np.random.default_rng(1).standard_normal(n)
    cfg = dict(ncrit=32, dtype="float64", max_p=8, near_panel=False)
    base = T.FmmPlan(TLB(K=3), fields, T.FMMConfig(**cfg), device="cpu")
    mags = np.abs(np.asarray(base.near_vals)).max(axis=1)
    tol = float(np.quantile(mags, 0.25))
    drop = T.FmmPlan(TLB(K=3), fields, T.FMMConfig(droptol=tol, **cfg),
                     device="cpu")
    kept = len(drop.near_rows) / len(base.near_rows)
    assert 0.5 < kept < 0.9, kept
    r0 = npy(base.apply(q, p=8))[:, 0]
    r1 = npy(drop.apply(q, p=8))[:, 0]
    d = np.linalg.norm(r1 - r0) / np.linalg.norm(r0)
    assert 0 < d < 0.5, d
    # the entries the JAX plan keeps at the same threshold
    jdrop = J.FmmPlan(JLB(K=3), fields, J.FMMConfig(droptol=tol, **cfg))
    np.testing.assert_array_equal(drop.near_rows, jdrop.near_rows)
    np.testing.assert_array_equal(drop.near_cols, jdrop.near_cols)
    assert rel(drop.apply(q, p=8), jdrop.apply(q, p=8)) <= TOL


@pytest.mark.parametrize("tiers", [None, (3, 5, 8)], ids=["continuous",
                                                          "tiers"])
def test_solve_plan_on_coo_is_device_mode(tiers):
    """The first-kind relaxed solve on a COO plan (ref LaplaceBEM.cpp
    first kind: G system, RHS = dG/dn . 1, solution 1)."""
    fields = make_panels(unit_sphere(4), K=3)  # 512 panels, M2L pairs
    n = len(fields["xyz"])
    cfg = dict(ncrit=16, dtype="float64", max_p=8, near_panel=False)
    jp = J.FmmPlan(JLB(K=3), fields, J.FMMConfig(**cfg))
    tp = T.FmmPlan(TLB(K=3), fields, T.FMMConfig(**cfg), device="cpu")
    b = np.asarray(jp.apply_flipped_bc(np.ones(n), p=8)[:, 0])
    scfg = T.SolverConfig(residual=1e-6, max_iters=60, restart=60, max_p=8,
                          p_min=1, p_tiers=tiers)
    jcfg = dataclasses.replace(
        scfg, relax_type=J.config.RelaxType(scfg.relax_type.value))
    xj, ij, mj = j_solve_plan(jp, b, J.SolverConfig(
        **dataclasses.asdict(jcfg)), prefer_device=True)
    xt, it, mt = solve_plan(tp, b, scfg)
    assert mj == "device" and mt == "device-slots"
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations
    assert [h[2] for h in it.history] == [h[2] for h in ij.history]
    assert len({h[2] for h in it.history}) > 1  # the order did relax
    assert np.abs(xt - np.asarray(xj)).max() <= 1e-9
    assert np.linalg.norm(xt - 1.0) / np.sqrt(n) < 5e-2
