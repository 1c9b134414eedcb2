"""Laplace BEM M2P over target leaf tiles (the level-skewed pairs).

For every target leaf that has M2P pairs and every real slot t of its
tile, the sum over the leaf's pairs s (source box s, its multipole row
``M[s]`` of two components, its centre c_s and 1/sigma_s)

    res[t] += sign_t * inv_sig_s * sum_{n<p, 0<=m<=n}
              w_m (Re M_s[c] Re S_n^m(dn) - Im M_s[c] Im S_n^m(dn))
    dn = (x_t - c_s) * inv_sig_s

with c = 0 and sign + where ``bc[t] == 0``, c = 1 and sign - otherwise
(ref LaplaceSphericalBEM.hpp M2P :394-422, the math of
``kernels/laplace_bem.py::LaplaceBEMKernel.m2p``); ``S_n^m`` is the
two-term Cartesian recurrence of ``kernels/laplace.py::eval_singular``
and ``w_m`` is 1 for m = 0, 2 for m > 0 (``harmonics.term_weights``).
The plain version runs that ``m2p`` itself on the gathered pairs.

The pairs are grouped by target leaf (``pair_tables``): ``leaves`` [nb]
the target leaves that have pairs, a row pointer [nb + 1] over the
sorted source boxes and their 1/sigma, and per such leaf its real slot
count, its slot coordinates [nb, K, 3] and (per BC variant) its BC tile
[nb, K].  Real slots lead a tile; padded slots are neither read nor
written.  The result is ADDED into ``out`` [nl, K] in place.

On CUDA tensors the sum runs as the hand-written kernel of
``csrc/m2p_tile.cu`` (one launch for every pair); on CPU tensors it runs
as the plain PyTorch version ``m2p_tiles_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fmm_bem_tpu_torch.kernels import harmonics as hm
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.ops.near_panel import leaf_counts


def pair_tables(src, tgt_leaf, inv_sigma, leaf_body_idx, leaf_body_mask,
                xyz):
    """Host tables of the M2P pairs, grouped by target leaf (numpy).

    src, tgt_leaf, inv_sigma : [npairs] source box, target leaf slot and
        the source's 1/sigma of each pair.
    leaf_body_idx, leaf_body_mask : [nl, K] the target side's leaf tiles.
    xyz : [n, 3] target bodies (Morton order).

    Returns a dict: ``leaves`` [nb] int32 (ascending), ``row_ptr``
    [nb + 1] int32, ``src`` [npairs] int32 and ``isig`` [npairs] (a
    leaf's pairs in their original order), ``cnt`` [nb] int32 real
    slots and ``xyz`` [nb, K, 3] slot coordinates."""
    tgt_leaf = np.asarray(tgt_leaf)
    order = np.argsort(tgt_leaf, kind="stable")
    leaves, counts = np.unique(tgt_leaf, return_counts=True)
    body = np.asarray(leaf_body_idx)[leaves]
    return {
        "leaves": leaves.astype(np.int32),
        "row_ptr": np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        "src": np.asarray(src)[order].astype(np.int32),
        "isig": np.asarray(inv_sigma)[order],
        "cnt": leaf_counts(np.asarray(leaf_body_mask)[leaves])[:-1],
        "xyz": np.asarray(xyz)[body],
    }


def m2p_tiles_reference(M, centers, leaves, row_ptr, src, isig, cnt, xyz,
                        bc, out, p, chunk=1024):
    """Plain PyTorch version: per chunk of pairs, the eager
    ``LaplaceBEMKernel.m2p`` at every slot of the target tile, summed
    into the target leaves; padded slots are then cut and the sums added
    into ``out`` [nl, K] in place.  Bad tables read as the kernel reads
    them: a count is clamped to [0, K], a source box outside [0, nbox)
    is an empty pair.  Returns ``out``."""
    return grouped_reference(_KERNEL, hm.real_width(p), M, centers, leaves,
                             row_ptr, src, isig, cnt, xyz, bc, out, p, chunk)


def grouped_reference(kern, W, M, centers, leaves, row_ptr, src, isig, cnt,
                      xyz, bc, out, p, chunk=1024):
    """The plain versions' common walk: ``kern.m2p`` (a BEM kernel of two
    components of width ``W``, result one value) over chunks of the
    grouped pairs, as ``m2p_tiles_reference`` says."""
    nb, K = bc.shape
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    npairs = int(counts.sum())
    if nb == 0 or npairs == 0:
        return out
    b_of = torch.repeat_interleave(torch.arange(nb, device=M.device), counts)
    start = int(row_ptr[0])
    ss_all = src[start : start + npairs].long()
    ok = (ss_all >= 0) & (ss_all < M.shape[0])
    seg = torch.zeros((nb, K), dtype=M.dtype, device=M.device)
    for c0 in range(0, npairs, chunk):
        keep = ok[c0 : c0 + chunk]
        bb = b_of[c0 : c0 + chunk][keep]
        ss = ss_all[c0 : c0 + chunk][keep]
        sig = isig[start + c0 : start + c0 + chunk][keep]
        P = ss.shape[0]
        dn = (xyz[bb] - centers[ss][:, None, :]) * sig[:, None, None]
        vals = kern.m2p(
            {"bc": bc[bb].reshape(P * K)},
            M[ss].reshape(P, 1, 2, W).expand(P, K, 2, W).reshape(P * K, 2, W),
            dn.reshape(P * K, 3),
            sig[:, None].expand(P, K).reshape(P * K),
            p,
        )
        seg.index_add_(0, bb, vals.reshape(P, K))
    real = torch.arange(K, device=M.device) < cnt.long().clamp(0, K)[:, None]
    return out.index_add_(0, leaves.long(), torch.where(real, seg, 0.0))


#: the kernel whose ``m2p`` the plain version runs (its math depends on
#: no parameter of the instance)
_KERNEL = LaplaceBEMKernel()


_C_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _kernel_fn(dtype):
    from fmm_bem_tpu_torch.ops import _build

    lib = _build.load("m2p_tile")
    fn = lib.m2p_tile_f32 if dtype == torch.float32 else lib.m2p_tile_f64
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def recurrence_coefficients(p, dtype, device):
    """[3, T(p)] per flat (n, m) term: ``w_m * prefac(n, m)`` (the weight
    of the term in the sum), and for n > m the recurrence's factors
    (2n - 1) / (n - m) and (n + m - 1) / (n - m) (0 where n == m).
    Made once per (p, dtype, device): a launch copies nothing to the
    card."""
    n = hm.term_degrees(p)
    m = hm.term_orders(p)
    gap = np.maximum(n - m, 1)
    tab = np.stack([
        hm.term_weights(p) * hm.prefac(n, m),
        np.where(n > m, (2 * n - 1) / gap, 0.0),
        np.where(n > m, (n + m - 1) / gap, 0.0),
    ])
    return torch.as_tensor(tab, dtype=dtype, device=device)


def check_kernel_args(M, centers, leaves, row_ptr, src, isig, cnt, xyz, bc,
                      out, p):
    """What the kernel takes, checked before it is loaded: float32 or
    float64 ``M`` [nbox, 2 * width(p)], ``centers`` [nbox, 3], ``isig``
    [npairs], ``xyz`` [nb, K, 3], ``bc`` [nb, K] and ``out`` [nl, K] of
    that type; int32 ``leaves`` [nb], ``row_ptr`` [nb + 1], ``src``
    [npairs] and ``cnt`` [nb]; all contiguous and on one device.  Raises
    TypeError / ValueError / RuntimeError; returns (nb, K)."""
    return check_tile_args("m2p_tiles", hm.real_width(p), M, centers, leaves,
                           row_ptr, src, isig, cnt, xyz, bc, out, p)


def check_tile_args(name, W, M, centers, leaves, row_ptr, src, isig, cnt,
                    xyz, bc, out, p):
    """``check_kernel_args`` for an M2P tile kernel ``name`` whose rows
    hold two components of width ``W``."""
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: M {M.dtype} must be float32 or float64")
    named = (("M", M), ("centers", centers), ("leaves", leaves),
             ("row_ptr", row_ptr), ("src", src), ("isig", isig),
             ("cnt", cnt), ("xyz", xyz), ("bc", bc), ("out", out))
    for arg, t in named:
        want = torch.int32 if arg in ("leaves", "row_ptr", "src",
                                      "cnt") else M.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} is {t.dtype}, not {want}")
        if t.device != M.device:
            raise RuntimeError(
                f"{name}: {arg} on {t.device}, M on {M.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    nb = leaves.shape[0]
    K = out.shape[-1]
    if (
        p < 1 or M.ndim != 2 or M.shape[1] != 2 * W
        or centers.shape != (M.shape[0], 3) or leaves.ndim != 1
        or row_ptr.shape != (nb + 1,) or src.ndim != 1
        or isig.shape != src.shape or cnt.shape != (nb,)
        or xyz.shape != (nb, K, 3) or bc.shape != (nb, K) or out.ndim != 2
    ):
        raise ValueError(
            f"{name}: shapes M {tuple(M.shape)} (p={p}) centers "
            f"{tuple(centers.shape)} leaves {tuple(leaves.shape)} row_ptr "
            f"{tuple(row_ptr.shape)} src {tuple(src.shape)} isig "
            f"{tuple(isig.shape)} cnt {tuple(cnt.shape)} xyz "
            f"{tuple(xyz.shape)} bc {tuple(bc.shape)} out "
            f"{tuple(out.shape)} do not fit")
    return nb, K


def m2p_tiles(M, centers, leaves, row_ptr, src, isig, cnt, xyz, bc, out, p):
    """Add the M2P sums of the grouped pairs (``pair_tables``) into
    ``out`` [nl, K] in place and return it.

    M : [nbox, 2 * width(p)] multipole rows (component-major, each
        component interleaved (re, im) and degree-ordered).
    centers : [nbox, 3] source box centres.
    leaves, row_ptr, src, isig, cnt, xyz : the pair tables.
    bc : [nb, K] the BC flags of the leaves' slots.
    Padded slots (past ``cnt``) and leaves without pairs are left as
    they are.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    hand-written kernel (and only there is ``m2p_tiles.launches``
    incremented) or raise.
    """
    if M.device.type == "cpu":
        return m2p_tiles_reference(M, centers, leaves, row_ptr, src, isig,
                                   cnt, xyz, bc, out, p)
    if M.device.type != "cuda":
        raise RuntimeError(f"m2p_tiles: unsupported device {M.device}")
    nb, K = check_kernel_args(M, centers, leaves, row_ptr, src, isig, cnt,
                              xyz, bc, out, p)
    if nb == 0 or K == 0 or src.shape[0] == 0:
        return out
    coef = recurrence_coefficients(p, M.dtype, M.device)
    with torch.cuda.device(M.device):
        err = _kernel_fn(M.dtype)(
            M.data_ptr(), centers.data_ptr(), coef.data_ptr(),
            leaves.data_ptr(), row_ptr.data_ptr(), src.data_ptr(),
            isig.data_ptr(), cnt.data_ptr(), xyz.data_ptr(), bc.data_ptr(),
            out.data_ptr(), nb, K, out.shape[0], M.shape[0], src.shape[0],
            int(p), torch.cuda.current_stream().cuda_stream,
        )
    m2p_tiles.launches += 1
    if err != 0:
        raise RuntimeError(f"m2p_tile kernel launch failed: CUDA error {err}")
    return out


#: number of kernel launches made by ``m2p_tiles`` in this process
m2p_tiles.launches = 0
