"""The Yukawa point kernels of the PyTorch port through whole plans,
against the JAX plans on the CPU at f64 (1e-12 relative): ``apply`` at
p = 8 (potential and gradient) of ``YukawaKernel`` on 1,500 points
(kappa 0 and 0.5) and of ``YukawaSphericalKernel`` on 800 points, on the
port's own tables and on the JAX plan's carried across as numpy.  These
plans run the per-level translation classes (M2M / L2L octant matrices,
M2L class and family operators), the table-less L2P and the batched
``p2p_block`` near field.  Also: the converter refuses kernels that
differ."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.kernels.cartesian import YukawaKernel as JYukawa
from fmm_bem_tpu.kernels.spherical_yukawa import (
    YukawaSphericalKernel as JSpherical,
)
from fmm_bem_tpu_torch.kernels.cartesian import YukawaKernel as TYukawa
from fmm_bem_tpu_torch.kernels.spherical_yukawa import (
    YukawaSphericalKernel as TSpherical,
)
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel as TBem
from fmm_bem_tpu_torch.utils.convert import (
    check_kernels_agree,
    operand_from_numpy,
)

TOL = 1e-12


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


POINT_KERNELS = {
    "yukawa_k0": (lambda: JYukawa(0.0), lambda: TYukawa(0.0)),
    "yukawa_k0.5": (lambda: JYukawa(0.5), lambda: TYukawa(0.5)),
    "spherical_k0.5": (lambda: JSpherical(0.5), lambda: TSpherical(0.5)),
}


class PointPair:
    def __init__(self, kernels, n, seed, **cfg):
        rng = np.random.default_rng(seed)
        self.pts = rng.uniform(0, 1, (n, 3))
        self.q = rng.standard_normal(n)
        cfg = {"ncrit": 32, "max_p": 8, "dtype": "float64", **cfg}
        jk, tk = (make() for make in kernels)
        self.jp = J.FmmPlan(jk, {"xyz": self.pts}, J.FMMConfig(**cfg))
        self.tp = T.FmmPlan(tk, {"xyz": self.pts}, T.FMMConfig(**cfg),
                            device="cpu")

    def carried(self, p):
        """The port's slot matvec on the JAX plan's tables."""
        jp, tp = self.jp, self.tp
        operand = operand_from_numpy(
            to_numpy(jp.device_data(p)), to_numpy(jp.variant_aux_slots(p)),
            None, None, device="cpu", dtype=torch.float64,
            fields={k: np.asarray(v) for k, v in jp.src.fields.items()},
            kernels=(jp.kernel, tp.kernel),
        )
        mv, _, to_s, from_s, _ = tp._slot_ops(None)
        return from_s(mv(operand, to_s(self.q), p))


POINT_PLANS = {
    "yukawa_k0": (POINT_KERNELS["yukawa_k0"], 1500, 2),
    "yukawa_k0.5": (POINT_KERNELS["yukawa_k0.5"], 1500, 2),
    "spherical_k0.5": (POINT_KERNELS["spherical_k0.5"], 800, 3),
}


@pytest.fixture(scope="module", params=sorted(POINT_PLANS))
def point_pair(request):
    kernels, n, seed = POINT_PLANS[request.param]
    return PointPair(kernels, n, seed)


@pytest.mark.parametrize("tables", ["carried", "own"])
def test_point_plan_matches_jax(point_pair, tables):
    """``apply`` at p = 8: potential and gradient; the tree has M2L
    families and residual tiles, whose class operators are per level."""
    tp = point_pair.tp
    assert not tp.kernel.scale_invariant and tp.m2l_fam is not None
    assert len(tp.src.m2m_mats) > 8  # octant classes per level
    want = np.asarray(point_pair.jp.apply(point_pair.q, p=8))
    got = (point_pair.carried(8) if tables == "carried"
           else tp.apply(point_pair.q, p=8))
    assert got.shape == (len(point_pair.q), 4)
    assert rel(got, want) <= TOL


def test_kernel_agreement_is_checked(point_pair):
    jp, tp = point_pair.jp, point_pair.tp
    check_kernels_agree(jp.kernel, tp.kernel)
    with pytest.raises(ValueError, match="kappa"):
        check_kernels_agree(jp.kernel, type(tp.kernel)(kappa=0.25))
    with pytest.raises(ValueError, match="differ"):
        check_kernels_agree(jp.kernel, TBem(K=3))
