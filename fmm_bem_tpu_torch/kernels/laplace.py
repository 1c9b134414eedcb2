"""Laplace solid harmonics on torch tensors.

Counterpart of kernel/LaplaceSpherical.hpp's evalMultipole/evalLocal.
Device-side operators are batched functions over bodies; translation
matrices come from :mod:`fmm_bem_tpu_torch.kernels.harmonics`.  The
harmonics are carried as explicit (re, im) planes so every expansion is
a real vector and truncation to a lower order is a prefix slice.
"""

from __future__ import annotations

import torch

from fmm_bem_tpu_torch.kernels import harmonics as hm


def eval_regular(d, p):
    """Regular solid harmonics R_n^m(d), m >= 0, flat (n,m) index.

    Batched over leading dims of ``d`` [..., 3]; returns a REAL pair
    (re [..., T], im [..., T]) from the Cartesian two-term recurrence
    (no trig, no sin(theta) division — cf. the reference's polar
    recurrence, LaplaceSpherical.hpp:455-488).
    """
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z
    T = hm.num_terms(p)
    re = [None] * T
    im = [None] * T
    br = torch.ones_like(x)
    bi = torch.zeros_like(x)
    for m in range(p):
        if m > 0:
            c = -(2 * m - 1)
            br, bi = c * (br * x - bi * yc), c * (br * yc + bi * x)
        pr2 = pi2 = None
        pr1, pi1 = br, bi
        for n in range(m, p):
            if n > m:
                if pr2 is None:
                    nr = (2 * n - 1) * z * pr1 / (n - m)
                    ni = (2 * n - 1) * z * pi1 / (n - m)
                else:
                    nr = ((2 * n - 1) * z * pr1 - (n + m - 1) * rho2 * pr2) / (n - m)
                    ni = ((2 * n - 1) * z * pi1 - (n + m - 1) * rho2 * pi2) / (n - m)
                pr2, pi2 = pr1, pi1
                pr1, pi1 = nr, ni
            f = float(hm.prefac(n, m))
            idx = n * (n + 1) // 2 + m
            re[idx] = f * pr1
            im[idx] = f * pi1
    return torch.stack(re, dim=-1), torch.stack(im, dim=-1)


def eval_singular(d, p, eps=0.0):
    """Singular solid harmonics S_n^m(d), m >= 0, flat (n,m) index —
    real-pair form (see eval_regular)."""
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z + eps
    inv_rho2 = 1.0 / rho2
    T = hm.num_terms(p)
    re = [None] * T
    im = [None] * T
    br = torch.sqrt(inv_rho2)
    bi = torch.zeros_like(br)
    for m in range(p):
        if m > 0:
            c = -(2 * m - 1)
            br, bi = (
                c * inv_rho2 * (br * x - bi * yc),
                c * inv_rho2 * (br * yc + bi * x),
            )
        pr2 = pi2 = None
        pr1, pi1 = br, bi
        for n in range(m, p):
            if n > m:
                if pr2 is None:
                    nr = (2 * n - 1) * z * pr1 * inv_rho2 / (n - m)
                    ni = (2 * n - 1) * z * pi1 * inv_rho2 / (n - m)
                else:
                    nr = ((2 * n - 1) * z * pr1 - (n + m - 1) * pr2) * inv_rho2 / (n - m)
                    ni = ((2 * n - 1) * z * pi1 - (n + m - 1) * pi2) * inv_rho2 / (n - m)
                pr2, pi2 = pr1, pi1
                pr1, pi1 = nr, ni
            f = float(hm.prefac(n, m))
            idx = n * (n + 1) // 2 + m
            re[idx] = f * pr1
            im[idx] = f * pi1
    return torch.stack(re, dim=-1), torch.stack(im, dim=-1)


def to_interleaved_ri(re, im):
    """(re, im) [..., T] pairs -> real [..., 2T] interleaved.

    Coefficients are degree-ordered, so truncating to a lower p is a
    prefix slice — the property the per-p device tables rely on.
    """
    return torch.stack([re, im], dim=-1).reshape(
        re.shape[:-1] + (2 * re.shape[-1],)
    )


def re_part(E):
    """Interleaved real view [..., 2T] -> re [..., T]."""
    return E[..., 0::2]


def im_part(E):
    return E[..., 1::2]
