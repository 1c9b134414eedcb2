"""The near-field-only operators of the PyTorch port against the JAX
package, on the CPU at f64: ``FMMConfig.local_evaluation`` (every near
leaf pair) and ``FMMConfig.block_diagonal`` (the leaf self pairs only;
ref EvalLocalSparse / EvalDiagonalSparse) for a point kernel, the
Laplace BEM kernel with its cached and on-the-fly near fields, Stokes
and Yukawa BEM: ``apply`` to 1e-12, the pair lists, no far-field work,
and the block-diagonal BEM operator against the dense leaf blocks."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace import LaplaceKernel as JLaplace
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu.kernels.stokes_bem import StokesBEMKernel as JStokes
from fmm_bem_tpu.kernels.yukawa_bem import YukawaBEMKernel as JYukawa
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel as TStokes
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel as TYukawa


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _bem_case(name):
    if name == "stokes":
        return (make_panels(unit_sphere(2), K=4),
                lambda: JStokes(K=4, mu=1e-3), lambda: TStokes(K=4, mu=1e-3),
                3, {"ncrit": 8})
    if name == "yukawa":
        return (make_panels(unit_sphere(3), K=3),
                lambda: JYukawa(K=3, kappa=0.5),
                lambda: TYukawa(K=3, kappa=0.5), 1, {})
    mode = {"laplace_cached": "cached", "laplace_otf": "otf"}[name]
    return (make_panels(unit_sphere(3), K=3), lambda: JKernel(K=3),
            lambda: TKernel(K=3), 1, {"near_mode": mode})


@pytest.mark.parametrize("mode", ["local_evaluation", "block_diagonal"])
@pytest.mark.parametrize(
    "name", ["points", "laplace_cached", "laplace_otf", "stokes", "yukawa"])
def test_near_only_plan_matches_jax(name, mode, monkeypatch):
    """``apply`` (and, for the BEM kernels, ``apply_flipped_bc``) of a
    near-field-only plan against the JAX plan's; the block-diagonal plan
    keeps exactly the leaf self pairs, and no near-only matvec runs a
    P2M (nor anything else of the far field)."""
    rng = np.random.default_rng(3)
    if name == "points":  # the 800-point case of tests/test_utils.py
        fields = {"xyz": rng.uniform(0, 1, (800, 3))}
        jk, tk, cdim, extra = JLaplace, TLaplace, 1, {}
    else:
        fields, jk, tk, cdim, extra = _bem_case(name)
    n = len(fields["xyz"])
    cfg = dict(dict(ncrit=32, dtype="float64", max_p=6), **extra,
               **{mode: True})
    jp = J.FmmPlan(jk(), fields, J.FMMConfig(**cfg))
    tp = T.FmmPlan(tk(), fields, T.FMMConfig(**cfg), device="cpu")
    assert tp.near_only
    if name == "laplace_otf":
        assert tp._otf_near
    pairs = tp.lists.p2p_pairs
    if mode == "block_diagonal":
        self_pairs = int((pairs[:, 0] == pairs[:, 1]).sum())
        assert len(tp.p2p_src_slot) == self_pairs == len(tp.leaf_ids)
        np.testing.assert_array_equal(tp.p2p_src_slot, tp.p2p_tgt_slot)
    else:
        assert len(tp.p2p_src_slot) == len(pairs) > len(tp.leaf_ids)
    np.testing.assert_array_equal(tp.p2p_src_slot, jp.p2p_src_slot)
    np.testing.assert_array_equal(tp.p2p_tgt_slot, jp.p2p_tgt_slot)

    def no_far(*a, **k):
        raise AssertionError("a near-only matvec ran far-field work")

    for far in ("_p2m_slots", "_phase_m2m", "_phase_m2l", "_l2p_slots",
                "_m2p_pass"):
        monkeypatch.setattr(tp, far, no_far)
    monkeypatch.setattr(tp.kernel, "p2m", no_far)
    q = rng.standard_normal((n, cdim) if cdim > 1 else n)
    variants = [("apply", {})]
    if name != "points":
        variants.append(("apply_flipped_bc", {}))
    for fn, kw in variants:
        want = np.asarray(getattr(jp, fn)(q, p=6))
        got = getattr(tp, fn)(q, p=6).numpy()
        assert got.shape == want.shape
        assert rel(got, want) <= 1e-12, (fn, rel(got, want))
    assert "p2m_tab_t" not in tp.variant_aux_slots(6)


def test_block_diagonal_bem_plan_is_the_dense_leaf_blocks():
    """The oracle of the block-diagonal BEM operator: the dense matrix of
    the kernel restricted to pairs within one leaf (512 panels, ncrit
    32)."""
    fields = make_panels(unit_sphere(4), K=3)
    n = len(fields["xyz"])
    kern = TKernel(K=3)
    tp = T.FmmPlan(kern, fields,
                   T.FMMConfig(ncrit=32, dtype="float64", max_p=6,
                               block_diagonal=True), device="cpu")
    t = tp.tree
    leaf_of = np.empty(n, np.int64)
    for leaf in t.leaves:
        s0, c = t.box_body_start[leaf], t.box_body_count[leaf]
        leaf_of[t.perm[s0 : s0 + c]] = leaf
    Ad = kern.dense_matrix(fields) * (leaf_of[:, None] == leaf_of[None, :])
    q = np.random.default_rng(4).standard_normal(n)
    for fn, A in (("apply", Ad), ("apply_flipped_bc", None)):
        if A is None:
            fl = dict(fields, bc=1.0 - np.asarray(fields["bc"]))
            A = kern.dense_matrix(fl) * (leaf_of[:, None] == leaf_of[None, :])
        got = getattr(tp, fn)(q, p=6)[:, 0].numpy()
        assert rel(got, A @ q) <= 1e-12, (fn, rel(got, A @ q))
