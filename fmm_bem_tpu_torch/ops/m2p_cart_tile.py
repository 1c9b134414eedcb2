"""Yukawa BEM M2P over target leaf tiles (the level-skewed pairs).

For every target leaf that has M2P pairs and every real slot t of its
tile, the sum over the leaf's pairs s (source box s, its multipole row
``M[s]`` of two components, its centre c_s and 1/sigma_s)

    res[t] += sign_t * sum_{|a|<=p} a! a_a(x_t - c_s; kappa)
              sigma_s^|a| M_s[c, a]

with c = 0 and sign + where ``bc[t] == 0``, c = 1 and sign - otherwise
(ref YukawaCartesianBEM.hpp M2P, the math of
``kernels/yukawa_bem.py::YukawaBEMKernel.m2p``); ``a_a`` are the
screened Taylor coefficients of ``kernels/cartesian.py::eval_coeffs`` at
the kernel instance's kappa.  The plain version runs that ``m2p`` itself
on the gathered pairs.

The pair tables and the BC tile are those of ``ops/m2p_tile.py``
(``pair_tables``), and so are the conventions: real slots lead a tile,
padded slots are neither read nor written, and the result is ADDED into
``out`` [nl, K] in place.  Only the rows differ: ``M`` is [nbox, 2T],
T = (p+1)(p+2)(p+3)/6 Cartesian terms a component, degree-ordered.

On CUDA tensors the sum runs as the hand-written kernel of
``csrc/m2p_cart_tile.cu`` (one launch for every pair); on CPU tensors it
runs as the plain PyTorch version ``m2p_cart_tiles_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fmm_bem_tpu_torch.kernels import cartesian as ct
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.ops.m2p_tile import check_tile_args, grouped_reference

#: the kernel's launch shape (``csrc/m2p_cart_tile.cu``): pairs staged a
#: round, target slots a block, evaluation groups a block
PAIR_LANES = 16
SLOTS = 2
GROUPS = PAIR_LANES * SLOTS
#: the dynamic shared memory a block may take on this card
SMEM_MAX = 227 * 1024


def m2p_cart_tiles_reference(M, centers, leaves, row_ptr, src, isig, cnt,
                             xyz, bc, out, p, kappa, chunk=1024):
    """Plain PyTorch version: per chunk of pairs, the eager
    ``YukawaBEMKernel.m2p`` at ``kappa`` at every slot of the target
    tile, summed into the target leaves; padded slots are then cut and
    the sums added into ``out`` [nl, K] in place.  Bad tables read as the
    kernel reads them: a count is clamped to [0, K], a source box outside
    [0, nbox) is an empty pair.  Returns ``out``."""
    return grouped_reference(_kernel(kappa), ct.num_terms(p), M, centers,
                             leaves, row_ptr, src, isig, cnt, xyz, bc, out,
                             p, chunk)


@functools.lru_cache(maxsize=None)
def _kernel(kappa):
    """The kernel whose ``m2p`` the plain version runs: its math depends
    on kappa alone."""
    return YukawaBEMKernel(kappa=kappa)


_C_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
               + [ctypes.c_double, ctypes.c_void_p])


def _library():
    from fmm_bem_tpu_torch.ops import _build

    return _build.load("m2p_cart_tile")


def _kernel_fn(dtype):
    lib = _library()
    fn = (lib.m2p_cart_tile_f32 if dtype == torch.float32
          else lib.m2p_cart_tile_f64)
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def library_smem_bytes(p, itemsize):
    """The library's own ``smem_bytes`` (loads it: the card's machine
    only), to hold ``smem_bytes`` to."""
    fn = _library().m2p_cart_tile_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(p, itemsize))


def smem_bytes(p, itemsize):
    """Dynamic shared memory of a launch at order ``p`` with values of
    ``itemsize`` bytes: the term table, a round's staged rows and their
    geometry, each group's ring of three degree shells of a and b, the
    slot sums, then the pairs' flags and the shell positions (ints).  The
    same sum as ``smem_bytes`` in the source."""
    T, S = ct.num_terms(p), (p + 1) * (p + 2) // 2
    return ((T + 3 * (p + 1) + PAIR_LANES * 2 * T + 4 * PAIR_LANES
             + GROUPS * 6 * S + PAIR_LANES * SLOTS) * itemsize
            + (PAIR_LANES + S) * 4)


@functools.lru_cache(maxsize=None)
def term_table(p, dtype, device):
    """[T(p) + 3(p + 1)]: a! = i! j! k! per flat term, then per degree n
    the recurrence's factors (2n - 1) / n, (n - 1) / n and 1 / n (0 at
    n = 0).  Made once per (p, dtype, device): a launch copies nothing to
    the card."""
    n = np.arange(p + 1)
    m = np.maximum(n, 1)
    deg = np.stack([np.where(n > 0, (2 * n - 1) / m, 0.0),
                    np.where(n > 0, (n - 1) / m, 0.0),
                    np.where(n > 0, 1.0 / m, 0.0)], axis=1)
    tab = np.concatenate([ct._factorial_prod(p), deg.reshape(-1)])
    return torch.as_tensor(tab, dtype=dtype, device=device)


def check_kernel_args(M, centers, leaves, row_ptr, src, isig, cnt, xyz, bc,
                      out, p):
    """What the kernel takes, checked before it is loaded: float32 or
    float64 ``M`` [nbox, 2 T(p)], ``centers`` [nbox, 3], ``isig``
    [npairs], ``xyz`` [nb, K, 3], ``bc`` [nb, K] and ``out`` [nl, K] of
    that type; int32 ``leaves`` [nb], ``row_ptr`` [nb + 1], ``src``
    [npairs] and ``cnt`` [nb]; all contiguous and on one device; an order
    whose shared memory fits a block.  Raises TypeError / ValueError /
    RuntimeError; returns (nb, K)."""
    nb_k = check_tile_args("m2p_cart_tiles", ct.num_terms(p), M, centers,
                           leaves, row_ptr, src, isig, cnt, xyz, bc, out, p)
    need = smem_bytes(p, M.element_size())
    if need > SMEM_MAX:
        raise ValueError(
            f"m2p_cart_tiles: p={p} in {M.dtype} needs {need} bytes of "
            f"shared memory a block, more than {SMEM_MAX}")
    return nb_k


def m2p_cart_tiles(M, centers, leaves, row_ptr, src, isig, cnt, xyz, bc, out,
                   p, kappa):
    """Add the M2P sums of the grouped pairs (``ops/m2p_tile.py::
    pair_tables``) at screening ``kappa`` into ``out`` [nl, K] in place
    and return it.

    M : [nbox, 2 T(p)] multipole rows (component-major, degree-ordered).
    centers : [nbox, 3] source box centres.
    leaves, row_ptr, src, isig, cnt, xyz : the pair tables.
    bc : [nb, K] the BC flags of the leaves' slots.
    Padded slots (past ``cnt``) and leaves without pairs are left as
    they are.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    hand-written kernel (and only there is ``m2p_cart_tiles.launches``
    incremented) or raise.
    """
    if M.device.type == "cpu":
        return m2p_cart_tiles_reference(M, centers, leaves, row_ptr, src,
                                        isig, cnt, xyz, bc, out, p, kappa)
    if M.device.type != "cuda":
        raise RuntimeError(f"m2p_cart_tiles: unsupported device {M.device}")
    nb, K = check_kernel_args(M, centers, leaves, row_ptr, src, isig, cnt,
                              xyz, bc, out, p)
    if nb == 0 or K == 0 or src.shape[0] == 0:
        return out
    tab = term_table(p, M.dtype, M.device)
    with torch.cuda.device(M.device):
        err = _kernel_fn(M.dtype)(
            M.data_ptr(), centers.data_ptr(), tab.data_ptr(),
            leaves.data_ptr(), row_ptr.data_ptr(), src.data_ptr(),
            isig.data_ptr(), cnt.data_ptr(), xyz.data_ptr(), bc.data_ptr(),
            out.data_ptr(), nb, K, out.shape[0], M.shape[0], src.shape[0],
            int(p), float(kappa), torch.cuda.current_stream().cuda_stream,
        )
    m2p_cart_tiles.launches += 1
    if err != 0:
        raise RuntimeError(
            f"m2p_cart_tile kernel launch failed: CUDA error {err}")
    return out


#: number of kernel launches made by ``m2p_cart_tiles`` in this process
m2p_cart_tiles.launches = 0
