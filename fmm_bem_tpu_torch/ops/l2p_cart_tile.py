"""Yukawa BEM L2P over target leaf tiles.

For every target leaf b (box ``leaves[b]``) and every slot t of its tile
of K slots, with the slot's normalised offset d from the box centre

    out[b K + t] = sign_t sum_{|a|<=p} L[leaves[b], c, a] d^a / a!

with c = 0 and sign + where ``bc[b K + t] == 0``, c = 1 and sign -
otherwise, and exact zeros in padded slots (``mask`` False): the math of
``kernels/yukawa_bem.py::YukawaBEMKernel.l2p`` in the slot layout of
``FmmPlan._l2p_slots``.  ``L`` is the plan's local expansion table
[nbox, 2T], T = (p+1)(p+2)(p+3)/6 Cartesian terms a component,
component-major and degree-ordered; it is read at the leaf ids directly.

On CUDA tensors the sum runs as the hand-written kernel of
``csrc/l2p_cart_tile.cu`` (one launch for every slot); on CPU tensors it
runs as the plain PyTorch version ``l2p_cart_tiles_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fmm_bem_tpu_torch.kernels import cartesian as ct
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel

#: the highest order a launch takes: its shared memory, 2 T(20) + 22
#: values (28 KB in f64), fits the 48 KB a block has by default.  Every
#: configuration stops at 10
MAX_ORDER = 20


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel whose ``l2p`` the plain version runs (its math does
    not depend on the kernel's parameters)."""
    return YukawaBEMKernel()


def l2p_cart_tiles_reference(L, leaves, dn, bc, mask, p):
    """Plain PyTorch version: the eager ``YukawaBEMKernel.l2p`` on each
    leaf's expansion broadcast over its tile, padded slots then cut to
    0.  A box id outside [0, nbox) reads as the kernel reads it: an
    empty expansion.  Returns [nl K, 1]."""
    nl, nbox = leaves.shape[0], L.shape[0]
    K = dn.shape[0] // nl if nl else 0
    ok = (leaves >= 0) & (leaves < nbox)
    Ll = L[leaves.clamp(0, max(nbox - 1, 0))] * ok[:, None].to(L.dtype)
    Lb = Ll[:, None, :].expand(nl, K, L.shape[1]).reshape(
        nl * K, 2, ct.num_terms(p))
    out = _kernel().l2p({"bc": bc}, Lb, dn, None, p)
    return torch.where(mask[:, None], out, 0.0)


_C_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library():
    from fmm_bem_tpu_torch.ops import _build

    return _build.load("l2p_cart_tile")


def _kernel_fn(dtype):
    lib = _library()
    fn = (lib.l2p_cart_tile_f32 if dtype == torch.float32
          else lib.l2p_cart_tile_f64)
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def term_table(p, dtype, device):
    """[p + 2]: 1/m at m = 1 .. p + 1, 0 at m = 0, the factors of the
    running products x^i / i!.  Made once per (p, dtype, device): a
    launch copies nothing to the card."""
    m = np.arange(p + 2, dtype=np.float64)
    tab = np.divide(1.0, m, out=np.zeros_like(m), where=m > 0)
    return torch.as_tensor(tab, dtype=dtype, device=device)


def check_kernel_args(L, leaves, dn, bc, mask, p):
    """What the kernel takes, checked before it is loaded: float32 or
    float64 ``L`` [nbox, 2 T(p)], ``dn`` [nl K, 3] and ``bc`` [nl K] of
    that type; int64 ``leaves`` [nl]; bool ``mask`` [nl K]; all
    contiguous and on one device; an order from 0 to ``MAX_ORDER``.
    Raises TypeError / ValueError / RuntimeError; returns (nl, K)."""
    name = "l2p_cart_tiles"
    if L.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: L must be float32 or float64, got "
                        f"{L.dtype}")
    for k, v in (("dn", dn), ("bc", bc)):
        if v.dtype != L.dtype:
            raise TypeError(f"{name}: {k} must be {L.dtype}, got {v.dtype}")
    if leaves.dtype != torch.int64:
        raise TypeError(f"{name}: leaves must be int64, got {leaves.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool, got {mask.dtype}")
    args = {"L": L, "leaves": leaves, "dn": dn, "bc": bc, "mask": mask}
    for k, v in args.items():
        if v.device != L.device:
            raise RuntimeError(f"{name}: {k} is on {v.device}, L on "
                               f"{L.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    if not 0 <= p <= MAX_ORDER:
        raise ValueError(f"{name}: p must be in [0, {MAX_ORDER}], got {p}")
    nl = leaves.shape[0]
    if L.ndim != 2 or L.shape[1] != 2 * ct.num_terms(p):
        raise ValueError(f"{name}: L must be [nbox, {2 * ct.num_terms(p)}] "
                         f"at p={p}, got {list(L.shape)}")
    if leaves.ndim != 1 or nl == 0 or dn.ndim != 2 or dn.shape[1] != 3 \
            or dn.shape[0] % nl:
        raise ValueError(f"{name}: leaves must be [nl] and dn [nl*K, 3], "
                         f"got {list(leaves.shape)} and {list(dn.shape)}")
    for k, v in (("bc", bc), ("mask", mask)):
        if v.shape != (dn.shape[0],):
            raise ValueError(f"{name}: {k} must be [{dn.shape[0]}], got "
                             f"{list(v.shape)}")
    return nl, dn.shape[0] // nl


def l2p_cart_tiles(L, leaves, dn, bc, mask, p):
    """The L2P of the leaf expansions at their tiles' slots, [nl K, 1].

    L : [nbox, 2 T(p)] local expansion rows (component-major,
        degree-ordered).
    leaves : [nl] the target leaves' box ids.
    dn : [nl K, 3] the slots' offsets from their box centre, normalised.
    bc : [nl K] the slots' BC flags (0: component 0, else component 1,
        negated).
    mask : [nl K] the real slots; padded slots come out exactly 0.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    hand-written kernel (and only there is ``l2p_cart_tiles.launches``
    incremented) or raise.
    """
    if L.device.type == "cpu":
        return l2p_cart_tiles_reference(L, leaves, dn, bc, mask, p)
    if L.device.type != "cuda":
        raise RuntimeError(f"l2p_cart_tiles: unsupported device {L.device}")
    nl, K = check_kernel_args(L, leaves, dn, bc, mask, p)
    out = torch.empty((nl * K, 1), dtype=L.dtype, device=L.device)
    tab = term_table(p, L.dtype, L.device)
    with torch.cuda.device(L.device):
        err = _kernel_fn(L.dtype)(
            L.data_ptr(), leaves.data_ptr(), dn.data_ptr(), bc.data_ptr(),
            mask.data_ptr(), tab.data_ptr(), out.data_ptr(), nl, K,
            L.shape[0], int(p), torch.cuda.current_stream().cuda_stream,
        )
    l2p_cart_tiles.launches += 1
    if err != 0:
        raise RuntimeError(
            f"l2p_cart_tile kernel launch failed: CUDA error {err}")
    return out


#: number of kernel launches made by ``l2p_cart_tiles`` in this process
l2p_cart_tiles.launches = 0
