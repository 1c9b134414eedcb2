"""On-the-fly BEM near field over near leaf pairs.

The cached near field stores every regular-quadrature interaction block;
the on-the-fly mode recomputes them inside each matvec instead: per
(target leaf, source leaf) pair, the KQ-point quadrature planes against
the target tile, BC-selected and contracted with the charges on the
spot, nothing but the [nl, K] result written out.

Laplace/Yukawa BEM math, matching kernels/laplace_bem.near_block_device
(the correction deltas are computed against that function, so this
product must reproduce it up to rounding).

Packed source-tile layout [nl+1, CS, K] with CS = 4*KQ + 3
(component-major, the K panels of a leaf contiguous):
  rows 0..3KQ-1   quadrature points, dim-major (qp_d[k] at row d*KQ+k)
  rows 3KQ..4KQ-1 quadrature weights * area (zero for padded panels)
  rows 4KQ..4KQ+2 panel normal
Target tiles [nl+1, 4, K]: xyz rows + BC flag row.  Charges are a
separate [nl, K] table, rebuilt per matvec.  Padded panels (and the
closing dummy tile) sit at a far sentinel position.  The real panels of
a leaf lead its tile, so a count table [nl+1]
(``ops/near_panel.py::leaf_counts``; the closing dummy tile counts 0)
says which slots are real: the kernel walks only those.

On CUDA tensors the product runs as the hand-written kernel of
``csrc/otf_tile.cu``; on CPU tensors it runs as the plain PyTorch
version ``otf_leaf_tiles_reference``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fmm_bem_tpu_torch.ops.p2p_tile import SENTINEL


def pack_otf_src(fields_tiled, mask, KQ, dtype=np.float32):
    """Static source components [nl+1, CS, K] from leaf-tiled panel
    fields ({'xyz','qp_off','qw','area','normal'} each [nl, K, ...])."""
    xyz = np.asarray(fields_tiled["xyz"])          # [nl, K, 3]
    qp = np.asarray(fields_tiled["qp_off"]) + xyz[:, :, None, :]
    w = np.asarray(fields_tiled["qw"]) * np.asarray(
        fields_tiled["area"]
    )[..., None]                                    # [nl, K, KQ]
    nrm = np.asarray(fields_tiled["normal"])        # [nl, K, 3]
    mask = np.asarray(mask)                         # [nl, K]
    nl, K = mask.shape
    CS = 4 * KQ + 3
    out = np.zeros((nl + 1, CS, K), dtype)
    # padded panels: quadrature points at the sentinel (far away) with
    # zero weight — contributions vanish through w
    for d in range(3):
        for k in range(KQ):
            out[:nl, d * KQ + k, :] = np.where(mask, qp[:, :, k, d], SENTINEL)
    for k in range(KQ):
        out[:nl, 3 * KQ + k, :] = np.where(mask, w[:, :, k], 0.0)
    for d in range(3):
        out[:nl, 4 * KQ + d, :] = nrm[:, :, d]
    out[nl, : 3 * KQ, :] = SENTINEL
    return out


def pack_otf_tgt(xyz_tiled, bc_tiled, mask, dtype=np.float32):
    """Target components [nl+1, 4, K]: xyz rows + BC flag row."""
    xyz = np.asarray(xyz_tiled)
    bc = np.asarray(bc_tiled)
    mask = np.asarray(mask)
    nl, K = mask.shape
    out = np.zeros((nl + 1, 4, K), dtype)
    for d in range(3):
        out[:nl, d, :] = np.where(mask, xyz[:, :, d], SENTINEL)
    out[:nl, 3, :] = bc
    out[nl, :3, :] = SENTINEL
    return out


def otf_leaf_tiles_reference(src_tab, ql, tgt_tab, row_ptr, src_idx, KQ,
                             kappa=0.0, chunk=256, src_cnt=None,
                             tgt_cnt=None):
    """Plain PyTorch version of the on-the-fly near product, with the
    arithmetic of ``near_block_device`` (sqrt, r^2 floored at 1e-30) on
    the packed tiles.  Chunked over pairs so the [chunk, KT, KS, KQ]
    planes stay small at any pair count.  Padded panels are masked out
    exactly: those past the count tables ``src_cnt`` / ``tgt_cnt``
    (``leaf_counts``) where they are given, else those at the sentinel;
    both give the same result.  Bad tables read as the kernel reads
    them: a count outside [0, K] is clamped to it, and a source leaf
    index outside [0, nl_s) is an empty leaf."""
    if (src_cnt is None) != (tgt_cnt is None):
        raise ValueError("otf_leaf_tiles_reference: give both count "
                         "tables or neither")
    nl_t = row_ptr.shape[0] - 1
    K = tgt_tab.shape[2]
    dev, dt = ql.device, ql.dtype
    out = torch.zeros((nl_t, K), dtype=dt, device=dev)
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    npairs = int(counts.sum())
    if npairs == 0:
        return out
    start = int(row_ptr[0])
    tslot = torch.repeat_interleave(torch.arange(nl_t, device=dev), counts)
    sslot = src_idx[start : start + npairs].long()
    src_ok = (sslot >= 0) & (sslot < ql.shape[0])
    sslot = torch.where(src_ok, sslot, 0)
    half = 0.5 * SENTINEL
    for c0 in range(0, npairs, chunk):
        ts = tslot[c0 : c0 + chunk]
        ss = sslot[c0 : c0 + chunk]
        ok = src_ok[c0 : c0 + chunk, None, None]
        t = tgt_tab[ts]                                  # [c, 4, KT]
        s = src_tab[ss]                                  # [c, CS, KS]
        c = t.shape[0]
        qp = s[:, : 3 * KQ].reshape(c, 3, KQ, K)
        w = s[:, 3 * KQ : 4 * KQ]                        # [c, KQ, KS]
        nrm = s[:, 4 * KQ : 4 * KQ + 3]                  # [c, 3, KS]
        if src_cnt is None:
            keep = (t[:, 0, :, None] < half) & (qp[:, 0, 0, None, :] < half)
        else:
            pos = torch.arange(K, device=dev)
            keep = (pos < tgt_cnt[ts].long()[:, None])[:, :, None] & (
                pos < src_cnt[ss].long()[:, None])[:, None, :]
        keep = keep & ok
        # d = target - quadrature point, [c, KT, KQ, KS] per dimension;
        # masked pairs get a harmless unit offset
        d = [
            torch.where(
                keep[:, :, None, :],
                t[:, dim, :, None, None] - qp[:, dim, None, :, :],
                1.0,
            )
            for dim in range(3)
        ]
        r2 = torch.clamp_min(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-30)
        r = torch.sqrt(r2)
        dn = -(
            d[0] * nrm[:, 0, None, None, :] + d[1] * nrm[:, 1, None, None, :]
            + d[2] * nrm[:, 2, None, None, :]
        )
        wb = w[:, None, :, :]
        if kappa:
            scr = torch.exp(-kappa * r)
            G = torch.sum(wb * scr / r, dim=2)
            dG = torch.sum(
                wb * dn * (kappa * r + 1.0) * scr / (r2 * r), dim=2
            )
        else:
            G = torch.sum(wb / r, dim=2)
            dG = torch.sum(wb * dn / (r2 * r), dim=2)
        blk = torch.where(t[:, 3, :, None] == 0.0, G, dG)  # [c, KT, KS]
        blk = torch.where(keep, blk, 0.0)
        out.index_add_(0, ts, torch.einsum("cts,cs->ct", blk, ql[ss]))
    return out


_C_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_double, ctypes.c_void_p]
)


def _kernel_fn(dtype):
    from fmm_bem_tpu_torch.ops import _build

    lib = _build.load("otf_tile")
    fn = lib.otf_tile_f32 if dtype == torch.float32 else lib.otf_tile_f64
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_kernel_args(src_tab, ql, tgt_tab, row_ptr, src_idx, KQ, src_cnt,
                      tgt_cnt):
    """What the kernel takes, checked before it is loaded: float32 or
    float64 tables ``src_tab`` [nl_s+1, 4*KQ+3, K], ``ql`` [nl_s, K] and
    ``tgt_tab`` [nl+1, 4, K] of one type; int32 ``row_ptr`` [nl_t + 1]
    with nl_t <= nl, ``src_idx`` [npairs] and the count tables
    ``src_cnt`` [nl_s+1] and ``tgt_cnt`` [nl+1] (required: the kernel
    walks nothing else); all contiguous and on one device.  Raises
    TypeError / ValueError / RuntimeError; returns (nl_t, K, KQ)."""
    if ql.dtype not in (torch.float32, torch.float64) or (
        src_tab.dtype != ql.dtype or tgt_tab.dtype != ql.dtype
    ):
        raise TypeError(
            f"otf_leaf_tiles: src_tab {src_tab.dtype} / ql {ql.dtype} / "
            f"tgt_tab {tgt_tab.dtype} must all be float32 or all float64"
        )
    if src_cnt is None or tgt_cnt is None:
        raise ValueError("otf_leaf_tiles: the kernel needs the count "
                         "tables src_cnt and tgt_cnt (leaf_counts)")
    if any(t.dtype != torch.int32
           for t in (row_ptr, src_idx, src_cnt, tgt_cnt)):
        raise TypeError("otf_leaf_tiles: row_ptr, src_idx, src_cnt and "
                        "tgt_cnt must be int32")
    for name, t in (("src_tab", src_tab), ("ql", ql), ("tgt_tab", tgt_tab),
                    ("row_ptr", row_ptr), ("src_idx", src_idx),
                    ("src_cnt", src_cnt), ("tgt_cnt", tgt_cnt)):
        if t.device != ql.device:
            raise RuntimeError(
                f"otf_leaf_tiles: {name} on {t.device}, ql on {ql.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"otf_leaf_tiles: {name} must be contiguous")
    nl_t = row_ptr.shape[0] - 1
    KQ = int(KQ)
    if (
        ql.ndim != 2 or src_tab.ndim != 3 or tgt_tab.ndim != 3 or KQ < 1
        or src_tab.shape != (ql.shape[0] + 1, 4 * KQ + 3, ql.shape[1])
        or tgt_tab.shape[1:] != (4, ql.shape[1])
        or row_ptr.ndim != 1 or src_idx.ndim != 1
        or nl_t < 0 or nl_t > tgt_tab.shape[0] - 1
        or src_cnt.shape != (src_tab.shape[0],)
        or tgt_cnt.shape != (tgt_tab.shape[0],)
    ):
        raise ValueError(
            f"otf_leaf_tiles: shapes src_tab {tuple(src_tab.shape)} ql "
            f"{tuple(ql.shape)} tgt_tab {tuple(tgt_tab.shape)} row_ptr "
            f"{tuple(row_ptr.shape)} src_cnt {tuple(src_cnt.shape)} "
            f"tgt_cnt {tuple(tgt_cnt.shape)} do not fit KQ={KQ}"
        )
    return nl_t, ql.shape[1], KQ


def otf_leaf_tiles(src_tab, ql, tgt_tab, row_ptr, src_idx, KQ, kappa=0.0,
                   src_cnt=None, tgt_cnt=None):
    """On-the-fly near product from leaf-tiled charges.

    Parameters
    ----------
    src_tab : [nl_s+1, 4*KQ+3, K] static source components
        (``pack_otf_src``).
    ql : [nl_s, K] per-matvec charges, padded slots zero.
    tgt_tab : [nl_t+1, 4, K] target components (``pack_otf_tgt``; the
        BC row differs per operator variant).
    row_ptr : [nl_t + 1] int32, ``src_idx`` : [npairs] int32 — the
        target-sorted pair list (source leaves in [0, nl_s); another
        index reads as an empty leaf).
    kappa : screening parameter (0 = Laplace).
    src_cnt : [nl_s + 1] int32, tgt_cnt : [nl_t + 1] int32 — real slots
        per leaf of each table (``leaf_counts``), clamped to [0, K]; the
        kernel walks only those and needs both, the plain version takes
        the sentinel without them.
    Returns [nl_t, K] leaf potential tiles, padded target slots zero.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    hand-written kernel (and only there is ``otf_leaf_tiles.launches``
    incremented) or raise.
    """
    if ql.device.type == "cpu":
        return otf_leaf_tiles_reference(
            src_tab, ql, tgt_tab, row_ptr, src_idx, KQ, kappa,
            src_cnt=src_cnt, tgt_cnt=tgt_cnt,
        )
    if ql.device.type != "cuda":
        raise RuntimeError(f"otf_leaf_tiles: unsupported device {ql.device}")
    nl_t, K, KQ = check_kernel_args(
        src_tab, ql, tgt_tab, row_ptr, src_idx, KQ, src_cnt, tgt_cnt)
    out = torch.empty((nl_t, K), dtype=ql.dtype, device=ql.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(ql.device):
        err = _kernel_fn(ql.dtype)(
            src_tab.data_ptr(), ql.data_ptr(), tgt_tab.data_ptr(),
            row_ptr.data_ptr(), src_idx.data_ptr(), src_cnt.data_ptr(),
            tgt_cnt.data_ptr(), out.data_ptr(), nl_t, ql.shape[0], K, KQ,
            float(kappa), torch.cuda.current_stream().cuda_stream,
        )
    otf_leaf_tiles.launches += 1
    if err != 0:
        raise RuntimeError(f"otf_tile kernel launch failed: CUDA error {err}")
    return out


#: number of kernel launches made by ``otf_leaf_tiles`` in this process
otf_leaf_tiles.launches = 0
