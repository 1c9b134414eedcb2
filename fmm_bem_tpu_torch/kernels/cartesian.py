"""Cartesian Taylor expansions for the Yukawa (screened-Laplace) and
Laplace kernels, on torch tensors.

Counterpart of kernel/YukawaCartesian.hpp / LaplaceCartesian.hpp:
multipoles are scaled moments M_a = sum_s q (c - x_s)^a / a!, locals
are Taylor derivative coefficients, and every translation is a dense
matrix over the multi-index set {|a| <= p} built on the host:

  M2M  binomial shift            (ref YukawaCartesian.hpp:190-210)
  M2L  T[k,n] = (n+k)! a_{n+k}   (ref :250-291, with the |n|+|k| <= p
                                  truncation)
  L2L  Taylor shift of locals    (ref :301-330)

where a_a = D^a G / a! are the Taylor coefficients of the Green's
function, generated by the screened-derivative recurrence the reference
hand-unrolls case-by-case in getCoeff (:356-670).  Here the recurrence
is stated once in its general multi-index form:

  n b_a = -kappa [ sum_d dx_d a_{a-e_d} + sum_d a_{a-2e_d} ]
  n R^2 a_a = -kappa [ sum_d dx_d b_{a-e_d} + sum_d b_{a-2e_d} ]
             - (2n-1) sum_d dx_d a_{a-e_d} - (n-1) sum_d a_{a-2e_d}

with b_a the coefficients of e^{-kappa R} and a_0 = e^{-kappa R}/R.
kappa = 0 degenerates to the classic 1/r derivative recurrence (the
LaplaceCartesian<P> family, ref LaplaceCartesian.hpp getCoef).

Terms are ordered by total degree (prefix slicing = lower p), so these
kernels carry a per-call p like every other kernel of the package.

Unlike the spherical Laplace family, the screened operators are NOT
scale-invariant (kappa sets a length scale), so translation-class
matrices are built per level (``scale_invariant = False``).

The host side (index tables, the numpy recurrences, the translation
matrices) is numpy; the device operators are batched torch functions
whose forces come from reverse-mode differentiation of the potential.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fmm_bem_tpu_torch.kernels.laplace import _grad_rows


def num_terms(p: int) -> int:
    """(p+1)(p+2)(p+3)/6 multi-indices with |a| <= p."""
    return (p + 1) * (p + 2) * (p + 3) // 6


@functools.lru_cache(maxsize=None)
def index_set(p: int):
    """Degree-ordered multi-index table.

    Returns (alphas [T,3] int, degree [T], lookup [p+1]^3 -> flat idx,
    parent1 [T,3] (a - e_d or -1), parent2 [T,3] (a - 2 e_d or -1)).
    """
    alphas = []
    for n in range(p + 1):
        for i in range(n, -1, -1):
            for j in range(n - i, -1, -1):
                alphas.append((i, j, n - i - j))
    alphas = np.asarray(alphas, dtype=np.int64)
    T = len(alphas)
    lookup = -np.ones((p + 1, p + 1, p + 1), dtype=np.int64)
    for t, (i, j, k) in enumerate(alphas):
        lookup[i, j, k] = t
    e = np.eye(3, dtype=np.int64)
    p1 = np.full((T, 3), -1, dtype=np.int64)
    p2 = np.full((T, 3), -1, dtype=np.int64)
    for t, a in enumerate(alphas):
        for d in range(3):
            b = a - e[d]
            if b.min() >= 0:
                p1[t, d] = lookup[tuple(b)]
            c = a - 2 * e[d]
            if c.min() >= 0:
                p2[t, d] = lookup[tuple(c)]
    return alphas, alphas.sum(1), lookup, p1, p2


@functools.lru_cache(maxsize=None)
def _factorial_prod(p):
    """a! = i! j! k! per flat term."""
    alphas, _, _, _, _ = index_set(p)
    f = np.ones(2 * p + 1)
    for i in range(1, len(f)):
        f[i] = f[i - 1] * i
    return f[alphas[:, 0]] * f[alphas[:, 1]] * f[alphas[:, 2]]


# ---------------------------------------------------------------------------
# Green's-function Taylor coefficients a_a = D^a G / a!


def eval_coeffs_np(dX, kappa, p):
    """Numpy version (host, batched over leading dims of dX [..., 3])."""
    alphas, deg, _, p1, p2 = index_set(p)
    T = len(alphas)
    dX = np.asarray(dX, dtype=np.float64)
    x = [dX[..., 0], dX[..., 1], dX[..., 2]]
    R2 = sum(v * v for v in x)
    R = np.sqrt(R2)
    inv_R2 = 1.0 / R2
    a = [None] * T
    b = [None] * T
    b[0] = np.exp(-kappa * R)
    a[0] = b[0] / R
    for t in range(1, T):
        n = int(deg[t])
        sa1 = 0.0
        sb1 = 0.0
        sa2 = 0.0
        sb2 = 0.0
        for d in range(3):
            if p1[t, d] >= 0:
                sa1 = sa1 + x[d] * a[p1[t, d]]
                sb1 = sb1 + x[d] * b[p1[t, d]]
            if p2[t, d] >= 0:
                sa2 = sa2 + a[p2[t, d]]
                sb2 = sb2 + b[p2[t, d]]
        b[t] = -(kappa / n) * (sa1 + sa2)
        a[t] = (inv_R2 / n) * (
            -kappa * (sb1 + sb2) - (2 * n - 1) * sa1 - (n - 1) * sa2
        )
    return np.stack(a, axis=-1)


def eval_coeffs(dX, kappa, p):
    """Torch version (device, batched over leading dims of dX [..., 3]).
    With kappa = 0 the b terms (the coefficients of e^{-kappa R}) are
    not formed at all."""
    alphas, deg, _, p1, p2 = index_set(p)
    T = len(alphas)
    x = [dX[..., 0], dX[..., 1], dX[..., 2]]
    R2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2]
    R = torch.sqrt(R2)
    inv_R2 = 1.0 / R2
    a = [None] * T
    b = [None] * T
    b[0] = torch.exp(-kappa * R)
    a[0] = b[0] / R
    for t in range(1, T):
        n = int(deg[t])
        sa1 = 0.0
        sb1 = 0.0
        sa2 = 0.0
        sb2 = 0.0
        for d in range(3):
            if p1[t, d] >= 0:
                sa1 = sa1 + x[d] * a[p1[t, d]]
                if kappa:
                    sb1 = sb1 + x[d] * b[p1[t, d]]
            if p2[t, d] >= 0:
                sa2 = sa2 + a[p2[t, d]]
                if kappa:
                    sb2 = sb2 + b[p2[t, d]]
        if kappa:
            b[t] = -(kappa / n) * (sa1 + sa2)
            a[t] = (inv_R2 / n) * (
                -kappa * (sb1 + sb2) - (2 * n - 1) * sa1 - (n - 1) * sa2
            )
        else:
            a[t] = (inv_R2 / n) * (-(2 * n - 1) * sa1 - (n - 1) * sa2)
    return torch.stack(a, dim=-1)


def powers(v, p):
    """v^a / a! for all |a| <= p, batched over leading dims (torch)."""
    alphas, deg, _, p1, _ = index_set(p)
    T = len(alphas)
    out = [None] * T
    out[0] = torch.ones_like(v[..., 0])
    x = [v[..., 0], v[..., 1], v[..., 2]]
    for t in range(1, T):
        # build from any valid parent: v^a/a! = (v^(a-e_d)/(a-e_d)!) * v_d / a_d
        for d in range(3):
            if p1[t, d] >= 0:
                out[t] = out[p1[t, d]] * x[d] / float(alphas[t, d])
                break
    return torch.stack(out, dim=-1)


def powers_np(v, p):
    alphas, deg, _, p1, _ = index_set(p)
    T = len(alphas)
    v = np.asarray(v, dtype=np.float64)
    out = [None] * T
    out[0] = np.ones_like(v[..., 0])
    x = [v[..., 0], v[..., 1], v[..., 2]]
    for t in range(1, T):
        for d in range(3):
            if p1[t, d] >= 0:
                out[t] = out[p1[t, d]] * x[d] / float(alphas[t, d])
                break
    return np.stack(out, axis=-1)


def _like(a, ref):
    """Host array as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(np.asarray(a), dtype=ref.dtype, device=ref.device)


def taylor_weights(d_norm, inv_sigma, kappa, p, like):
    """a! a_a(dX) sigma^|a| per target and term, with dX = d_norm /
    inv_sigma the physical offset: phi = sum_a weights_a M_hat_a is the
    multipole evaluation (ref M2P :221-240).  [B, 3] -> [B, T]."""
    _, deg, _, _, _ = index_set(p)
    fac = _like(_factorial_prod(p), like)
    degs = _like(deg, like)
    a = eval_coeffs(d_norm / inv_sigma[:, None], kappa, p)
    sig = (1.0 / inv_sigma)[:, None] ** degs
    return fac * a * sig


class YukawaKernel:
    """Point Yukawa kernel K(t,s) = e^{-kappa r}/r with gradient output
    (ref YukawaCartesian.hpp; result = [phi, grad phi], Vec<4> :95-97).

    Setting kappa = 0 gives the Cartesian-Taylor Laplace kernel (the
    reference's LaplaceCartesian<P> family).
    """

    name = "yukawa"
    ncomp = 1
    charge_dim = 1
    result_dim = 4
    near_sparse = False
    #: kappa sets a physical length scale -> per-level translation classes
    scale_invariant = False
    eps2 = 1e-8

    def __init__(self, kappa=0.125):
        self.kappa = kappa

    def width(self, p):
        return num_terms(p)

    # ----- host matrices -----
    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        """T[a,b] = (dr/sig_s)^(a-b)/(a-b)! * (sig_s/sig_t)^|a| (binomial
        moment shift, scale-normalised)."""
        alphas, deg, lookup, _, _ = index_set(p)
        T = len(alphas)
        diff = alphas[:, None, :] - alphas[None, :, :]
        valid = (diff >= 0).all(axis=-1)
        diff_c = np.clip(diff, 0, None)
        drn = np.asarray(dr, dtype=np.float64) / sigma_src
        pw = powers_np(
            np.broadcast_to(drn, (T, T, 3)).reshape(-1, 3), p
        ).reshape(T, T, -1)
        # pick the entry corresponding to each diff multi-index
        flat = lookup[diff_c[..., 0], diff_c[..., 1], diff_c[..., 2]]
        mat = np.take_along_axis(pw, flat[..., None], axis=-1)[..., 0]
        mat = np.where(valid, mat, 0.0)
        ratio = (sigma_src / sigma_tgt) ** deg.astype(np.float64)
        return mat * ratio[:, None]

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        """T[k,n] = (n+k)! a_{n+k}(dr) sig_s^|n| sig_t^|k|, truncated to
        |n|+|k| <= p (ref M2L :276-279)."""
        alphas, deg, lookup, _, _ = index_set(p)
        T = len(alphas)
        ssum = alphas[:, None, :] + alphas[None, :, :]
        dsum = deg[:, None] + deg[None, :]
        valid = dsum <= p
        a = eval_coeffs_np(np.asarray(dr, dtype=np.float64), self.kappa, p)
        fac = _factorial_prod(p)
        ss = np.clip(ssum, 0, p)
        flat = lookup[ss[..., 0], ss[..., 1], ss[..., 2]]
        mat = np.where(valid, fac[flat] * a[flat], 0.0)
        sn = sigma_src ** deg.astype(np.float64)
        sk = sigma_tgt ** deg.astype(np.float64)
        return mat * sn[None, :] * sk[:, None]

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        """T[n,k] = (dr/?)^(k-n)/(k-n)! with scale factors (Taylor shift
        of derivative coefficients, ref L2L :301-330)."""
        alphas, deg, lookup, _, _ = index_set(p)
        T = len(alphas)
        diff = alphas[None, :, :] - alphas[:, None, :]  # k - n at [n, k]
        valid = (diff >= 0).all(axis=-1)
        diff_c = np.clip(diff, 0, None)
        dr = np.asarray(dr, dtype=np.float64)
        pw = powers_np(
            np.broadcast_to(dr, (T, T, 3)).reshape(-1, 3), p
        ).reshape(T, T, -1)
        flat = lookup[diff_c[..., 0], diff_c[..., 1], diff_c[..., 2]]
        mat = np.take_along_axis(pw, flat[..., None], axis=-1)[..., 0]
        mat = np.where(valid, mat, 0.0)
        sk = sigma_src ** (-deg.astype(np.float64))
        sn = sigma_tgt ** deg.astype(np.float64)
        return mat * sk[None, :] * sn[:, None]

    def m2l_pair_scale(self, sigma_src):
        return np.ones_like(sigma_src)

    # ----- device ops -----
    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        """M_hat_a = q (-d_norm)^a / a!  (moments of (c-x)/sigma; ref
        P2M :169-181 with dX = center - source)."""
        del inv_sigma
        pw = powers(-d_norm, p)
        return (charges[..., None] * pw)[:, None, :]

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        """phi = sum_k L_hat_k d_norm^k / k!; gradient by reverse-mode
        differentiation (replacing the reference's phi*k/dx trick, L2P
        :332-352)."""
        del fields
        Lr = L[:, 0]

        def phi_fn(d):
            return torch.sum(Lr * powers(d, p), dim=-1)

        phi, grad = _grad_rows(phi_fn, d_norm)
        return torch.cat([phi[:, None], grad * inv_sigma[:, None]], dim=-1)

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        """phi(t) = sum_a a! a_a(dX) sigma^|a| M_hat_a (ref M2P
        :221-240); dX is physical.  Gradient by reverse mode."""
        del fields
        Mr = M[:, 0]

        def phi_fn(d):
            w = taylor_weights(d, inv_sigma, self.kappa, p, M)
            return torch.sum(w * Mr, dim=-1)

        phi, grad = _grad_rows(phi_fn, d_norm)
        return torch.cat([phi[:, None], grad * inv_sigma[:, None]], dim=-1)

    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        del src_mask
        return self.p2p(tgt_fields["xyz"], src_fields["xyz"], charges)

    def p2p(self, tgt_xyz, src_xyz, charges):
        """phi = e^{-kappa r}/r; grad_t phi = (s-t)(1+kappa r)e^{-kappa r}/r^3."""
        dist = src_xyz[None, :, :] - tgt_xyz[:, None, :]
        r2 = torch.sum(dist * dist, dim=-1)
        inv_r2 = torch.where(
            r2 < self.eps2, 0.0, 1.0 / torch.clamp_min(r2, self.eps2)
        )
        r = torch.sqrt(torch.clamp_min(r2, self.eps2))
        inv_r = torch.sqrt(inv_r2)
        ekr = torch.exp(-self.kappa * r)
        pot = torch.sum(charges[None, :] * ekr * inv_r, dim=1)
        fmag = charges[None, :] * ekr * (1.0 + self.kappa * r) * inv_r2 * inv_r
        f = torch.sum(fmag[:, :, None] * dist, dim=1)
        return torch.cat([pot[:, None], f], dim=-1)

    def direct(self, tgt_xyz, src_xyz, charges, chunk=2048):
        """O(N^2) direct summation, chunked over targets."""
        outs = []
        for i in range(0, tgt_xyz.shape[0], chunk):
            outs.append(self.p2p(tgt_xyz[i : i + chunk], src_xyz, charges))
        return torch.cat(outs, dim=0)


class LaplaceCartesianKernel(YukawaKernel):
    """Cartesian-Taylor Laplace kernel (ref kernel/LaplaceCartesian.hpp,
    which hard-codes P via template metaprogramming; here P is the same
    runtime argument as everywhere else)."""

    name = "laplace_cartesian"

    def __init__(self):
        super().__init__(kappa=0.0)
