"""The body-order matvec of the PyTorch port (``FmmPlan._matvec``,
through ``apply_body_order`` and ``solver_ops``): charges in and results
out per body, gathered into leaf tiles for the near pass and back — the
layout of the plans without a slot operator.  On the CPU at f64.

- On every plan that also has the slot-layout matvec, the two layouts
  give the same operator to 1e-12 relative: Laplace BEM with the cached
  and the on-the-fly near field (both BC variants), Stokes BEM, Yukawa
  BEM, point Laplace (the leaf-tile P2P), point Yukawa, the stokeslet,
  the treecode, a near-field-only plan.
- ``solver_ops`` (the operator the device solver takes on a plan
  without a slot operator) against the JAX package's ``solver_ops`` on
  the same plan, the same vector and order: 1e-12 relative.
"""

import jax.numpy as jnp
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
from fmm_bem_tpu_torch.config import Evaluator
from fmm_bem_tpu_torch.kernels import stokes as tst
from fmm_bem_tpu_torch.kernels.cartesian import YukawaKernel as TYukawa
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TLB
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel as TSB
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel as TYB

TOL = 1e-12


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(
        want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bem(kern, K=3, **cfg):
    """A 128-panel sphere at ncrit 8: a tree with M2L pairs."""
    fields = make_panels(unit_sphere(3), K=K)
    plan = T.FmmPlan(kern, fields, T.FMMConfig(
        **{**dict(ncrit=8, dtype="float64", max_p=6), **cfg}), device="cpu")
    return plan, len(fields["xyz"])


def _points(kern, n=1500, **cfg):
    pts = np.random.default_rng(7).uniform(0, 1, (n, 3))
    plan = T.FmmPlan(kern, {"xyz": pts}, T.FMMConfig(
        **{**dict(ncrit=32, dtype="float64", max_p=8), **cfg}), device="cpu")
    return plan, n


#: plan name -> function returning (plan, n)
PLANS = {
    "laplace_bem_cached": lambda: _bem(TLB(K=3)),
    "laplace_bem_otf": lambda: _bem(TLB(K=3), near_mode="otf"),
    "stokes_bem": lambda: _bem(TSB(K=4, fine_K=17, mu=1e-3), K=4,
                               max_p=4),
    "yukawa_bem": lambda: _bem(TYB(K=3, kappa=0.125)),
    "laplace_points": lambda: _points(TLaplace()),
    "yukawa_points": lambda: _points(TYukawa(kappa=0.125), n=800, max_p=5),
    "stokeslet": lambda: _points(tst.StokesKernel(), n=800),
    "laplace_treecode": lambda: _points(
        TLaplace(), evaluator=Evaluator.TREECODE),
    "near_only": lambda: _bem(TLB(K=3), local_evaluation=True),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_body_order_is_the_slot_matvec(name):
    plan, n = PLANS[name]()
    assert plan.has_slot_route
    # the far field runs (but for the near-field-only operator)
    assert plan.near_only or len(plan.lists.m2l_pairs) + len(
        plan.m2p_src) > 0
    cdim = getattr(plan.kernel, "charge_dim", 1)
    rng = np.random.default_rng(3)
    q = rng.standard_normal(n) if cdim == 1 else rng.standard_normal((n, cdim))
    p = plan.config.max_p - 1
    assert rel(plan.apply_body_order(q, p=p), plan.apply(q, p=p)) <= TOL
    if "bc" in plan.src.fields:
        sf, tf = plan._flipped_pair()
        assert rel(
            plan.apply_body_order(q, p=p, fields=sf, target_fields=tf),
            plan.apply_flipped_bc(q, p=p),
        ) <= TOL


@pytest.mark.parametrize("case", ["laplace_bem", "stokes_bem"])
@pytest.mark.parametrize("flipped", [False, True])
def test_solver_ops_match_jax(case, flipped, monkeypatch):
    if case == "laplace_bem":
        fields = make_panels(unit_sphere(3), K=3)
        jk, tk, cdim = JLB(K=3), TLB(K=3), 1
        cfg = dict(ncrit=8, dtype="float64", max_p=6)
    else:
        # a tree with M2L pairs, so the far field at traction targets
        # (flipped) runs too: with the reference's sign put into the
        # port (ROADMAP.md C)
        monkeypatch.setattr(TSB, "traction_far_scale", 0.5)
        fields = make_panels(unit_sphere(3), K=4)
        jk = JSB(K=4, fine_K=17, mu=1e-3)
        tk = TSB(K=4, fine_K=17, mu=1e-3)
        cdim = 3
        cfg = dict(ncrit=8, dtype="float64", max_p=4)
    jp = J.FmmPlan(jk, fields, J.FMMConfig(**cfg))
    tp = T.FmmPlan(tk, fields, T.FMMConfig(**cfg), device="cpu")
    assert len(tp.lists.m2l_pairs) > 0
    x = np.random.default_rng(5).standard_normal(len(fields["xyz"]) * cdim)
    jmv, jop = jp.solver_ops(flipped=flipped)
    tmv, top = tp.solver_ops(flipped=flipped)
    for p in (cfg["max_p"] - 2, cfg["max_p"]):
        want = np.asarray(jmv(jop(p), jnp.asarray(x), p))
        got = tmv(top(p), torch.tensor(x), p)
        assert got.shape == want.shape
        assert rel(got, want) <= TOL, p
