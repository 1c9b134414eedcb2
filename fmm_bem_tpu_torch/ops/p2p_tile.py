"""Point-kernel P2P over near leaf pairs (Laplace: potential + force).

The near field of a point kernel is a direct sum over (target leaf,
source leaf) pairs.  Leaves are packed tiles ``xyzq [nl+1, 4, K]`` (rows
x, y, z, q; padded slots carry q = 0, and one dummy tile at a far
sentinel position with zero charge closes the table); charges ride the
plan-constant xyz tiles and are rebuilt per matvec.  The pair list is
sorted by target leaf, so a row pointer gives each leaf a contiguous
range of source leaves.

Laplace-specific math (pot + difference-form force, matching
kernels/laplace.LaplaceKernel.p2p — LaplaceSpherical.hpp:153-162); other
point kernels keep the batched ``p2p_block`` path of the plan.

The real points of a leaf lead its tile, so a count table [nl+1]
(``ops/near_panel.py::leaf_counts``; the closing dummy tile counts 0, and
one table serves targets and sources of the single tree) says which
slots are real: the kernel walks only those.

On CUDA tensors the product runs as the hand-written kernel of
``csrc/p2p_tile.cu`` (one block per target leaf, the real source points
staged compacted in shared memory, two targets a thread, partial sums in
registers); on CPU tensors it runs as the plain PyTorch version
``p2p_leaf_tiles_reference``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fmm_bem_tpu_torch.ops.near_panel import chunk_row_ptr

#: dummy source tiles sit here: far enough that 1/r is a harmless tiny
#: value even against real targets, with q = 0 anyway
SENTINEL = 1e15


def sorted_pair_rows(sslot, tslot, nl_t):
    """Near leaf pairs sorted by (target slot, source slot).

    Returns ``(src_sorted [npairs] int32, row_ptr [nl_t + 1] int32)``:
    target leaf l owns the source leaves
    ``src_sorted[row_ptr[l] : row_ptr[l + 1]]``."""
    sslot = np.asarray(sslot)
    tslot = np.asarray(tslot)
    order = np.lexsort((sslot, tslot))
    return (
        np.ascontiguousarray(sslot[order], np.int32),
        chunk_row_ptr(tslot[order], nl_t),
    )


def pack_xyzq(xyz_tiles, q_tiles):
    """[nl, 3, K] xyz + [nl, 1, K] charges -> [nl+1, 4, K] with the
    sentinel dummy tile appended."""
    _, _, K = xyz_tiles.shape
    body = torch.cat([xyz_tiles, q_tiles], dim=1)
    dummy = torch.cat(
        [
            torch.full((1, 3, K), SENTINEL, dtype=body.dtype,
                       device=body.device),
            torch.zeros((1, 1, K), dtype=body.dtype, device=body.device),
        ],
        dim=1,
    )
    return torch.cat([body, dummy], dim=0)


def p2p_leaf_tiles_reference(xyzq, row_ptr, src_idx, eps2, cnt=None,
                             chunk=512):
    """Plain PyTorch version of the leaf-tile P2P: per chunk of pairs,
    the [K, K] difference planes, the eps2-excluded 1/r and the
    difference-form force, summed into the target leaves.  Chunked so
    the [chunk, K, K] planes stay small at any pair count.  With the
    count table ``cnt`` [nl+1] (``leaf_counts``) source slots past a
    leaf's count are skipped and target slots past it come out exactly
    0, as in the kernel; without it every slot is summed (padded
    sources carry q = 0, padded targets hold values the caller
    masks).  Bad tables read as the kernel reads them: a count outside
    [0, K] is clamped to it, and a source leaf index outside [0, nl) is
    an empty leaf."""
    nl_t = row_ptr.shape[0] - 1
    K = xyzq.shape[2]
    out = torch.zeros((nl_t, 4, K), dtype=xyzq.dtype, device=xyzq.device)
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    npairs = int(counts.sum())
    if npairs == 0:
        return out
    start = int(row_ptr[0])
    tslot = torch.repeat_interleave(
        torch.arange(nl_t, device=xyzq.device), counts
    )
    sslot = src_idx[start : start + npairs].long()
    # the dummy leaf, and any index past it, is an empty tile
    real = (sslot >= 0) & (sslot < xyzq.shape[0] - 1)
    pos = torch.arange(K, device=xyzq.device)
    for c0 in range(0, npairs, chunk):
        keep = real[c0 : c0 + chunk]
        ts = tslot[c0 : c0 + chunk][keep]
        ss = sslot[c0 : c0 + chunk][keep]
        t = xyzq[ts]                          # [c, 4, K]
        s = xyzq[ss]
        dd = [s[:, d, None, :] - t[:, d, :, None] for d in range(3)]
        r2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]  # [c, KT, KS]
        skip = r2 < eps2
        if cnt is not None:
            skip = skip | ~(
                (pos < cnt[ts].long()[:, None])[:, :, None]
                & (pos < cnt[ss].long()[:, None])[:, None, :]
            )
        inv_r2 = torch.where(skip, 0.0, 1.0 / torch.clamp_min(r2, eps2))
        inv_r = torch.sqrt(inv_r2)
        q = s[:, 3, None, :]
        w = q * inv_r * inv_r2
        vals = torch.stack(
            [torch.sum(q * inv_r, dim=2)]
            + [torch.sum(w * dd[d], dim=2) for d in range(3)],
            dim=1,
        )                                     # [c, 4, KT]
        out.index_add_(0, ts, vals)
    return out


_C_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_double,
                                                  ctypes.c_void_p]
)


def _library():
    from fmm_bem_tpu_torch.ops import _build

    return _build.load("p2p_tile")


def _kernel_fn(dtype):
    lib = _library()
    fn = lib.p2p_tile_f32 if dtype == torch.float32 else lib.p2p_tile_f64
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def stage_capacity(dtype, K):
    """Source points one shared-memory stage of the kernel holds at leaf
    width ``K`` (builds the kernel: on the card only)."""
    fn = _library().p2p_tile_stage_cap
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(int(K), int(dtype == torch.float64))


def check_kernel_args(xyzq, row_ptr, src_idx, cnt):
    """What the kernel takes, checked before it is loaded: float32 or
    float64 tiles ``[nl+1, 4, K]``; int32 ``row_ptr`` [nl_t + 1] with
    nl_t <= nl, ``src_idx`` [npairs] and the count table ``cnt``
    [nl+1] (required: the kernel walks nothing else); all contiguous
    and on one device.  Raises TypeError / ValueError / RuntimeError;
    returns (nl_t, K)."""
    if cnt is None:
        raise ValueError("p2p_leaf_tiles: the kernel needs the count "
                         "table cnt (leaf_counts)")
    if xyzq.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"p2p_leaf_tiles: xyzq {xyzq.dtype} must be float32 "
                        "or float64")
    if any(t.dtype != torch.int32 for t in (row_ptr, src_idx, cnt)):
        raise TypeError("p2p_leaf_tiles: row_ptr, src_idx and cnt must be "
                        "int32")
    for name, t in (("xyzq", xyzq), ("row_ptr", row_ptr),
                    ("src_idx", src_idx), ("cnt", cnt)):
        if t.device != xyzq.device:
            raise RuntimeError(
                f"p2p_leaf_tiles: {name} on {t.device}, xyzq on {xyzq.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"p2p_leaf_tiles: {name} must be contiguous")
    nl_t = row_ptr.shape[0] - 1
    if (
        xyzq.ndim != 3 or xyzq.shape[1] != 4 or row_ptr.ndim != 1
        or src_idx.ndim != 1 or nl_t < 0 or nl_t > xyzq.shape[0] - 1
        or cnt.shape != (xyzq.shape[0],)
    ):
        raise ValueError(
            f"p2p_leaf_tiles: shapes xyzq {tuple(xyzq.shape)} row_ptr "
            f"{tuple(row_ptr.shape)} src_idx {tuple(src_idx.shape)} cnt "
            f"{tuple(cnt.shape)} do not fit"
        )
    return nl_t, xyzq.shape[2]


def p2p_leaf_tiles(xyzq, row_ptr, src_idx, eps2, cnt):
    """Laplace point P2P over the near leaf pairs.

    Parameters
    ----------
    xyzq : [nl+1, 4, K] packed leaf tiles (``pack_xyzq``), sources and
        targets alike (single tree).
    row_ptr : [nl_t + 1] int32, ``src_idx`` : [npairs] int32 — the
        target-sorted pair list (``sorted_pair_rows``).
    eps2 : exclusion threshold on r^2: pairs below it contribute 0.
    cnt : [nl + 1] int32 real points per leaf (``leaf_counts``); only
        those are walked.
    Returns [nl_t, 4, K] tiles (pot, fx, fy, fz); padded target slots
    are exactly 0.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    hand-written kernel (and only there is ``p2p_leaf_tiles.launches``
    incremented) or raise.
    """
    if xyzq.device.type == "cpu":
        return p2p_leaf_tiles_reference(xyzq, row_ptr, src_idx, eps2, cnt)
    if xyzq.device.type != "cuda":
        raise RuntimeError(f"p2p_leaf_tiles: unsupported device {xyzq.device}")
    nl_t, K = check_kernel_args(xyzq, row_ptr, src_idx, cnt)
    out = torch.empty((nl_t, 4, K), dtype=xyzq.dtype, device=xyzq.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xyzq.device):
        err = _kernel_fn(xyzq.dtype)(
            xyzq.data_ptr(), row_ptr.data_ptr(), src_idx.data_ptr(),
            cnt.data_ptr(), out.data_ptr(), nl_t, K, xyzq.shape[0] - 1,
            float(eps2), torch.cuda.current_stream().cuda_stream,
        )
    p2p_leaf_tiles.launches += 1
    if err != 0:
        raise RuntimeError(f"p2p_tile kernel launch failed: CUDA error {err}")
    return out


#: number of kernel launches made by ``p2p_leaf_tiles`` in this process
p2p_leaf_tiles.launches = 0
