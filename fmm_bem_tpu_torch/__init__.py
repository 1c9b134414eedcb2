"""fmm_bem_tpu_torch — the PyTorch/CUDA port of the fmm_bem_tpu FMM-BEM solver.

A second package beside ``fmm_bem_tpu`` (the JAX reference), mirroring its
directories so the counterpart of a module sits at the same relative
path.  It imports ``torch`` and numpy only — never ``jax`` and nothing of
the reference package.

- host side (numpy + the native C++ helper): Morton octree, dual-tree
  traversal, M2L classes/families, BEM near-field assembly;
- kernels: Laplace (spherical harmonics and Cartesian Taylor), Yukawa
  (Cartesian Taylor and spherical Bessel), the Laplace, Yukawa and
  Stokes BEM panel kernels, the unit kernel;
- device side (torch tensors): the slot-space FMM matvec (or the
  treecode's M2P far field), whose near
  field runs as a hand-written CUDA kernel on CUDA tensors and as its
  plain PyTorch version on CPU tensors: the cached BEM panel product
  (``csrc/near_panel.cu``), the on-the-fly BEM quadrature
  (``csrc/otf_tile.cu``) or the point-Laplace P2P (``csrc/p2p_tile.cu``);
- GMRES / FGMRES with per-iteration relaxation of the multipole order.

Every entry point takes an explicit ``device`` (default ``"cuda"``; the
CPU tests pass ``"cpu"``).
"""

import torch as _torch

# An FMM's M2M/M2L/L2L chain and the Krylov orthogonalisation are
# matmuls whose rounding feeds straight into the solve: reduced-precision
# products (TF32, bf16) cost digits the relaxation schedule relies on.
# Pin full-f32 products once, at import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from fmm_bem_tpu_torch.config import FMMConfig, SolverConfig
from fmm_bem_tpu_torch.tree.octree import Tree, build_tree
from fmm_bem_tpu_torch.traversal.lists import (
    InteractionLists,
    build_interaction_lists,
)
from fmm_bem_tpu_torch.executor.plan import FmmPlan
from fmm_bem_tpu_torch.kernels.cartesian import (
    LaplaceCartesianKernel,
    YukawaKernel,
)
from fmm_bem_tpu_torch.kernels.spherical_yukawa import YukawaSphericalKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel

__version__ = "0.1.0"

__all__ = [
    "FMMConfig",
    "SolverConfig",
    "Tree",
    "build_tree",
    "InteractionLists",
    "build_interaction_lists",
    "FmmPlan",
    "LaplaceCartesianKernel",
    "YukawaKernel",
    "YukawaSphericalKernel",
    "YukawaBEMKernel",
    "resolve_device",
    "torch_dtype",
]


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point's ``device`` argument.

    Asking for CUDA where there is none raises: nothing falls back to
    the CPU unless the caller asks for the CPU."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    return dev


def torch_dtype(name):
    """``torch.dtype`` for a config's dtype string."""
    if isinstance(name, _torch.dtype):
        return name
    return {"float32": _torch.float32, "float64": _torch.float64}[str(name)]
