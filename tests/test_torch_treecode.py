"""The treecode evaluator (``Evaluator.TREECODE``) of the PyTorch port, on
the CPU at f64: the far field goes from each far box's multipole straight
to the target leaves (M2P), with no M2L, L2L or L2P.

- The unit kernel counts every pair once: exact against direct
  summation to 1e-13 (the JAX package's tests/test_plan.py bar).
- ``LaplaceKernel`` at p = 10 on 1,500 points: ``apply`` (potential and
  force) against the JAX package's treecode plan to 1e-12, and against
  direct summation within 1e-4 (tests/test_plan.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.config import Evaluator as JEvaluator
from fmm_bem_tpu.kernels.laplace import LaplaceKernel as JLaplace
from fmm_bem_tpu_torch.config import Evaluator
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.unit import UnitKernel as TUnit


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("ncrit", [16, 64])
def test_unit_kernel_exact(ncrit):
    rng = np.random.default_rng(42)
    n = 2500
    pts = rng.uniform(-1, 1, (n, 3))
    q = rng.standard_normal(n)
    plan = T.FmmPlan(
        TUnit(), {"xyz": pts},
        T.FMMConfig(ncrit=ncrit, dtype="float64",
                    evaluator=Evaluator.TREECODE),
        device="cpu",
    )
    assert len(plan.m2p_src) > 0 and len(plan.lists.m2l_pairs) == 0
    res = plan.apply(q, p=3)
    exact = TUnit().direct(torch.tensor(pts), torch.tensor(pts),
                           torch.tensor(q))
    assert rel(res, exact) < 1e-13


@pytest.fixture(scope="module")
def laplace_pair():
    rng = np.random.default_rng(4)
    n = 1500
    pts = rng.uniform(0, 1, (n, 3))
    q = rng.standard_normal(n)
    cfg = dict(ncrit=32, dtype="float64", max_p=10)
    jp = J.FmmPlan(JLaplace(), {"xyz": pts},
                   J.FMMConfig(evaluator=JEvaluator.TREECODE, **cfg))
    tp = T.FmmPlan(TLaplace(), {"xyz": pts},
                   T.FMMConfig(evaluator=Evaluator.TREECODE, **cfg),
                   device="cpu")
    return pts, q, jp, tp


def test_laplace_treecode_plan_is_the_jax_plans(laplace_pair):
    _, _, jp, tp = laplace_pair
    for name in ("m2p_src", "m2p_tgt_slot", "p2p_src_slot", "p2p_tgt_slot"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    np.testing.assert_array_equal(tp.lists.m2p_pairs, jp.lists.m2p_pairs)
    assert len(tp.lists.m2l_pairs) == 0 and len(tp.m2l_tile_src) == 0


def test_laplace_treecode_apply_matches_jax(laplace_pair):
    _, q, jp, tp = laplace_pair
    got = tp.apply(q, p=10)
    assert rel(got, jp.apply(q, p=10)) <= 1e-12


def test_laplace_treecode_against_direct(laplace_pair):
    """A single multipole expansion converges slower than the FMM's M2L
    at the same opening angle: 1e-4 at p = 10."""
    pts, q, _, tp = laplace_pair
    exact = TLaplace().direct(torch.tensor(pts), torch.tensor(pts),
                              torch.tensor(q))
    assert rel(tp.apply(q, p=10)[:, 0], exact[:, 0]) < 1e-4
