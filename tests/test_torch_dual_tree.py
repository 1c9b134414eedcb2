"""Dual-tree plans of the PyTorch port (``target_fields``: a distinct
target set with its own tree in the sources' root box, ref
ExecutorDualTree.hpp) against the JAX package, on the CPU at f64.
Inputs are made with numpy from a seed and handed to both packages.

- The three cases of the JAX package's own dual-tree tests with their
  bars: the unit kernel (FMM and treecode) exact to 1e-13 against
  direct summation (the dual_correctness.cpp oracle), Laplace potential
  to 5e-5, the BEM exterior potential (panels as sources, off-surface
  points as pseudo-panel targets) to 1e-4 against ``eval_exterior``;
  each also against the JAX plan to 1e-12 relative.
- The dual plans' interaction lists and both sides' leaf tables, array
  for array.
- ``apply`` and ``apply_flipped_bc`` of the dual BEM plan against the
  JAX plan; no square operator (``solver_ops_slots() is None``).
- The dual plan with the on-the-fly near field and unequal leaf pads
  (``K_t != K_s``: both sides packed at the wider one) against the JAX
  package's XLA path of the same plan and against the cached dual plan.
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
from fmm_bem_tpu.kernels.laplace import LaplaceKernel as JLaplace
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JBEM
from fmm_bem_tpu.kernels.unit import UnitKernel as JUnit
from fmm_bem_tpu_torch.config import Evaluator
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TBEM
from fmm_bem_tpu_torch.kernels.unit import UnitKernel as TUnit

TOL = 1e-12


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def pseudo_panels(pts, fields):
    """Off-surface evaluation points as zero-area pseudo-panels (only
    their centers matter for POTENTIAL targets)."""
    npts = len(pts)
    return {
        "xyz": pts,
        "normal": np.zeros((npts, 3)),
        "area": np.zeros(npts),
        "vertices": np.zeros((npts, 3, 3)),
        "qp_off": np.zeros((npts,) + fields["qp_off"].shape[1:]),
        "qw": np.zeros((npts, fields["qw"].shape[1])),
        "bc": np.zeros(npts),  # POTENTIAL -> single-layer G values
    }


def shell(rng, npts, r0, r1):
    dirs = rng.standard_normal((npts, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return dirs * rng.uniform(r0, r1, (npts, 1))


@pytest.mark.parametrize("evaluator", ["fmm", "treecode"])
def test_dual_unit_kernel_exact(evaluator):
    rng = np.random.default_rng(0)
    src = rng.uniform(-1, 1, (1800, 3))
    tgt = rng.uniform(-0.8, 1.2, (1300, 3))
    q = rng.standard_normal(1800)
    jp = J.FmmPlan(
        JUnit(), {"xyz": src},
        J.FMMConfig(ncrit=24, dtype="float64",
                    evaluator=J.config.Evaluator(evaluator)),
        target_fields={"xyz": tgt},
    )
    tp = T.FmmPlan(
        TUnit(), {"xyz": src},
        T.FMMConfig(ncrit=24, dtype="float64",
                    evaluator=Evaluator(evaluator)),
        target_fields={"xyz": tgt}, device="cpu",
    )
    got = tp.apply(q, p=3)
    assert got.shape[0] == len(tgt)
    exact = TUnit().direct(torch.tensor(tgt), torch.tensor(src),
                           torch.tensor(q))
    assert rel(got, exact) < 1e-13
    assert rel(got, jp.apply(q, p=3)) <= TOL
    assert tp.solver_ops_slots() is None


def test_dual_laplace_accuracy():
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 1, (1500, 3))
    tgt = rng.uniform(0.2, 1.4, (900, 3))
    q = rng.standard_normal(1500)
    cfg = dict(ncrit=32, dtype="float64", max_p=10)
    jp = J.FmmPlan(JLaplace(), {"xyz": src}, J.FMMConfig(**cfg),
                   target_fields={"xyz": tgt})
    tp = T.FmmPlan(TLaplace(), {"xyz": src}, T.FMMConfig(**cfg),
                   target_fields={"xyz": tgt}, device="cpu")
    assert tp._p2p_rows is None  # no single count table for two trees
    got = tp.apply(q, p=10)
    exact = TLaplace().direct(torch.tensor(tgt), torch.tensor(src),
                              torch.tensor(q))
    assert rel(got[:, 0], exact[:, 0]) < 5e-5
    assert rel(got, jp.apply(q, p=10)) <= TOL


@pytest.fixture(scope="module")
def bem_exterior():
    """The JAX test's exterior problem: a rec-3 sphere as sources, 200
    points at radius 2..4 as targets (ncrit 32, max_p 10)."""
    fields = make_panels(unit_sphere(3), K=3)
    rng = np.random.default_rng(2)
    pts = shell(rng, 200, 2.0, 4.0)
    tfields = pseudo_panels(pts, fields)
    cfg = dict(ncrit=32, dtype="float64", max_p=10)
    jp = J.FmmPlan(JBEM(K=3), fields, J.FMMConfig(**cfg),
                   target_fields=tfields)
    tp = T.FmmPlan(TBEM(K=3), fields, T.FMMConfig(**cfg),
                   target_fields=tfields, device="cpu")
    q = rng.standard_normal(len(fields["xyz"]))
    return fields, pts, q, jp, tp


def test_dual_bem_exterior_evaluation(bem_exterior):
    fields, pts, q, jp, tp = bem_exterior
    got = tp.apply(q, p=10)
    exact = TBEM(K=3).eval_exterior(fields, q, pts, layer="G")
    assert rel(got[:, 0], exact) < 1e-4
    assert rel(got, jp.apply(q, p=10)) <= TOL
    # the near field and the far field are both exercised
    assert len(tp.p2p_src_slot) > 0 and len(tp.lists.m2l_pairs) > 0


def test_dual_lists_and_leaf_tables(bem_exterior):
    _, _, _, jp, tp = bem_exterior
    assert tp.dual and jp.dual
    for name in ("m2l_pairs", "p2p_pairs", "m2p_pairs"):
        np.testing.assert_array_equal(
            getattr(tp.lists, name), getattr(jp.lists, name), err_msg=name)
    for side in ("src", "tgt"):
        ts, js = getattr(tp, side), getattr(jp, side)
        np.testing.assert_array_equal(ts.tree.perm, js.tree.perm)
        np.testing.assert_allclose(ts.tree.box_center, js.tree.box_center,
                                   rtol=0, atol=1e-15)
        for name in ("leaf_ids", "box_to_slot", "leaf_body_idx",
                     "leaf_body_mask", "body_flat_slot", "body_leaf_box"):
            np.testing.assert_array_equal(
                getattr(ts, name), getattr(js, name), err_msg=side + name)
        assert ts.leaf_pad == js.leaf_pad
    np.testing.assert_array_equal(tp.p2p_src_slot, jp.p2p_src_slot)
    np.testing.assert_array_equal(tp.p2p_tgt_slot, jp.p2p_tgt_slot)
    np.testing.assert_array_equal(tp.m2p_src, jp.m2p_src)
    np.testing.assert_array_equal(tp.m2p_tgt_slot, jp.m2p_tgt_slot)
    # one root box around sources and targets together
    np.testing.assert_array_equal(tp.src.tree.pmin, tp.tgt.tree.pmin)
    assert tp.src.tree.root_side == tp.tgt.tree.root_side


@pytest.mark.parametrize("p", [6, 10])
def test_dual_apply_and_flipped_match_jax(bem_exterior, p):
    _, _, q, jp, tp = bem_exterior
    assert rel(tp.apply(q, p=p), jp.apply(q, p=p)) <= TOL
    assert rel(tp.apply_flipped_bc(q, p=p),
               jp.apply_flipped_bc(q, p=p)) <= TOL
    assert tp.solver_ops_slots() is None


@pytest.fixture(scope="module")
def otf_dual():
    """A dual plan with the on-the-fly near field and the leaf pads the
    trees give (``leaf_pad=None``): targets in a shell at 1.05..3.0."""
    fields = make_panels(unit_sphere(3), K=3)
    rng = np.random.default_rng(4)
    pts = shell(rng, 700, 1.05, 3.0)
    tfields = pseudo_panels(pts, fields)
    cfg = dict(ncrit=24, dtype="float64", max_p=6)
    jp = J.FmmPlan(JBEM(K=3), fields, J.FMMConfig(near_mode="otf", **cfg),
                   target_fields=tfields)
    tp = T.FmmPlan(TBEM(K=3), fields, T.FMMConfig(near_mode="otf", **cfg),
                   target_fields=tfields, device="cpu")
    cached = T.FmmPlan(TBEM(K=3), fields, T.FMMConfig(**cfg),
                       target_fields=tfields, device="cpu")
    q = rng.standard_normal(len(fields["xyz"]))
    return q, jp, tp, cached


def test_dual_otf_unequal_leaf_pads(otf_dual):
    q, jp, tp, cached = otf_dual
    assert tp._otf_near and tp.tgt.leaf_pad != tp.src.leaf_pad
    assert len(tp.lists.m2l_pairs) > 0
    K = max(tp.src.leaf_pad, tp.tgt.leaf_pad)
    ot = tp.near_panels()[0]["otf_tiles"]
    assert ot["sb_src"].shape[2] == ot["sb_tgt"].shape[2] == K
    got = tp.apply(q, p=6)
    # the JAX package's XLA path (off the TPU) on the same plan
    assert rel(got, jp.apply(q, p=6)) <= TOL
    # the cached store of the same dual plan: the same operator
    assert rel(got, cached.apply(q, p=6)) <= 1e-12
    assert rel(tp.apply_flipped_bc(q, p=6),
               jp.apply_flipped_bc(q, p=6)) <= TOL
