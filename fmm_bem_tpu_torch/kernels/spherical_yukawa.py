"""Spherical-harmonic Yukawa kernel: modified spherical Bessel
expansions with projection-built translation operators.

Counterpart of kernel/YukawaSpherical.hpp, on torch tensors.  The reference
expands e^{-kappa r}/r in products of modified spherical Bessel
functions and spherical harmonics (its P2M :149-176 evaluates
i_n(kappa rho) Y_nm via recurrences :220-333) and translates with
rotation + axial-shift matrices memoized per level (:774-864) — and its
M2L is disabled (#if 0, :500-583), so the shipped evaluator is treecode
only.  This module keeps the same expansion basis

    e^{-kappa r}/r = kappa * sum_n (2n+1) i_n(kappa rho_<)
                     k_n(kappa rho_>) P_n(cos gamma)

(with i_0(x) = sinh(x)/x, k_0(x) = e^{-x}/x) but re-designs everything
array-first:

* Radial functions enter device ops only through the smooth ratios
  g_n(t) = s_n(kappa sigma t) / s_n(kappa sigma), where
  i_n(x) = x^n s_n(x)/(2n+1)!! and s_n is an even power series — so
  P2M/L2P are the **Laplace regular solid harmonics** (shared
  real-pair Cartesian recurrence, kernels/laplace.py) times per-degree
  polynomial corrections in t^2.  No Bessel recurrences, no
  overflow/underflow: coefficients stay O(1) in float32 exactly like
  the Laplace scale-normalised design.

* M2M / M2L / L2L are dense real translation matrices **assembled by
  spectral projection**: the source-basis fields are evaluated on a
  quadrature sphere around the target box and least-squares-fitted in
  the target basis (column-equilibrated, float64, built once per
  (level, class) like every other kernel here).  This replaces the
  reference's rotation + z-shift machinery with a scheme that is exact
  to the same truncation order, is kernel-convention-proof (it uses
  the very same basis evaluators as the device ops), and — unlike the
  reference — yields a *working* Yukawa M2L.

* kappa sets a physical length scale, so ``scale_invariant = False``
  and the executor builds per-level translation classes (same path as
  the Cartesian Yukawa, kernels/cartesian.py).

Expansion layout, interleaved real pairs, matches kernels/harmonics.py:
slot (n, m>=0) holds Re/Im of  M_nm = sum_q q kappa (2n+1)
i_n(kappa rho) conj(Yhat_nm) / A_n(sigma),  A_n = kappa (2n+1)
i_n(kappa sigma);  evaluation folds with weights (1, 2, 2, ...).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fmm_bem_tpu_torch.kernels import harmonics as hm
from fmm_bem_tpu_torch.kernels.laplace import (
    _grad_rows,
    eval_regular,
    eval_singular,
    im_part,
    re_part,
    to_interleaved_ri,
)

# ---------------------------------------------------------------------------
# modified spherical Bessel machinery (host float64 + device-safe series)


def _dfact(n):
    """(2n+1)!! as float64."""
    out = 1.0
    for k in range(1, n + 1):
        out *= 2 * k + 1
    return out


@functools.lru_cache(maxsize=None)
def _series_coeffs(p, nterms=30):
    """c[n, k] with s_n(x) = sum_k c[n,k] x^{2k}:  the entire part of
    i_n(x) = x^n s_n(x) / (2n+1)!!.

    From i_n(x) = x^n sum_k x^{2k} / (2^k k! (2n+2k+1)!!/(2n-1)!!...),
    i.e. c[n,k] = 1 / (2^k k! prod_{j=n+1}^{n+k} (2j+1)); c[n,0] = 1,
    so s_n(0) = 1 and g_n(0) ratios are well-conditioned.  30 terms are
    converged to <1e-13 for x = kappa*sigma <= 15 (an octree whose root
    box spans 15 screening lengths has no far field to speak of).
    """
    c = np.zeros((p, nterms))
    for n in range(p):
        for k in range(nterms):
            dk = 1.0
            for j in range(n + 1, n + k + 1):
                dk *= 2 * j + 1
            c[n, k] = 1.0 / (2.0**k * _factorial(k) * dk)
    return c


def _factorial(k):
    out = 1.0
    for j in range(2, k + 1):
        out *= j
    return out


def bessel_i(x, p):
    """i_n(x) for n < p (numpy, x >= 0 scalar or array): series form,
    i_n = x^n s_n(x) / (2n+1)!!  — absolutely convergent, monotone
    terms, float64-safe for the x = kappa*sigma range of an octree."""
    x = np.asarray(x, np.float64)
    c = _series_coeffs(p)
    x2 = x * x
    out = []
    for n in range(p):
        s = np.zeros_like(x)
        for k in range(c.shape[1] - 1, -1, -1):
            s = s * x2 + c[n, k]
        out.append(x**n * s / _dfact(n))
    return np.stack(out, axis=-1)


@functools.lru_cache(maxsize=None)
def _kn_poly(p):
    """a[n, j]: k_n(x) = e^{-x}/x * sum_j a[n,j] x^{-j} (j <= n), from
    k_0 = e^{-x}/x and the upward recurrence
    k_{n+1} = k_{n-1} + (2n+1)/x k_n (stable: k grows with n)."""
    a = np.zeros((max(p, 2), max(p, 2)))
    a[0, 0] = 1.0
    if p > 1:
        a[1, 0] = 1.0
        a[1, 1] = 1.0
    for n in range(1, p - 1):
        a[n + 1] = a[n - 1]
        a[n + 1, 1:] += (2 * n + 1) * a[n, :-1]
    return a[:p, :p]


def bessel_k(x, p):
    """k_n(x) for n < p (numpy, x > 0), k_0 = e^{-x}/x convention."""
    x = np.asarray(x, np.float64)
    a = _kn_poly(p)
    invx = 1.0 / x
    pows = invx[..., None] ** np.arange(p)
    base = np.exp(-x) * invx
    return base[..., None] * (pows[..., None, :] * a).sum(-1)


# ---------------------------------------------------------------------------
# host basis evaluation (float64) — shared by all projection builders


def _fold_real(vals_complex, p):
    """Complex slot values [Q, T] -> real basis matrix [Q, 2T] such
    that phi = B @ interleaved_coeffs reproduces the evaluation folding
    phi = sum w (ReC * ReV - ImC * ImV)."""
    w = hm.term_weights(p)
    B = np.empty(vals_complex.shape[:-1] + (2 * vals_complex.shape[-1],))
    B[..., 0::2] = w * vals_complex.real
    B[..., 1::2] = -w * vals_complex.imag
    return B


def _angular_flat(dirs, p):
    """Yhat_nm at unit vectors for m >= 0, flat (n,m) index [Q, T]."""
    full = hm.eval_regular_full(dirs, p)  # rho = 1 -> pure angular
    n = hm.term_degrees(p).astype(np.int64)
    m = hm.term_orders(p).astype(np.int64)
    return full[..., n * n + n + m]


def _sphere_points(p):
    """Gauss-Legendre x uniform-phi sphere grid resolving harmonics
    well past degree p (2x oversampling in theta, alias-free in phi):
    returns (unit_points [Q,3], weights [Q]) with weights summing to
    4 pi."""
    nth = 2 * p + 4
    nph = 2 * p + 6
    xg, wg = np.polynomial.legendre.leggauss(nth)
    phi = (np.arange(nph) + 0.5) * (2 * np.pi / nph)
    ct = xg[:, None]
    st = np.sqrt(1.0 - ct * ct)
    pts = np.stack(
        [
            np.broadcast_to(st * np.cos(phi)[None, :], (nth, nph)),
            np.broadcast_to(st * np.sin(phi)[None, :], (nth, nph)),
            np.broadcast_to(ct, (nth, nph)),
        ],
        axis=-1,
    ).reshape(-1, 3)
    w = np.broadcast_to(wg[:, None] * (2 * np.pi / nph), (nth, nph)).reshape(-1)
    return pts, w


def _as(a, ref):
    """Host numbers as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(np.asarray(a), dtype=ref.dtype, device=ref.device)


def _radial_ratio(d_norm, x2, p):
    """g_n(t) = s_n(kappa sigma t) / s_n(kappa sigma) per body and slot
    [B, T], with t = |d_norm| and x2 = (kappa sigma)^2 per body [B]: both
    s_n series by Horner in the squared arguments."""
    gc = _series_coeffs(p)
    t2 = torch.sum(d_norm * d_norm, dim=-1)  # [B]
    num = torch.zeros(t2.shape + (p,), dtype=d_norm.dtype,
                      device=d_norm.device)
    den = torch.zeros_like(num)
    xt2 = (x2 * t2)[..., None]
    x2e = x2[..., None]
    for k in range(gc.shape[1] - 1, -1, -1):
        ck = _as(gc[:, k], d_norm)
        num = num * xt2 + ck
        den = den * x2e + ck
    n_of = torch.as_tensor(hm.term_degrees(p), device=d_norm.device)
    return (num / den)[..., n_of]


class YukawaSphericalKernel:
    """Point Yukawa kernel via spherical modified-Bessel expansions
    (ref kernel/YukawaSpherical.hpp; result = [phi, grad phi])."""

    name = "yukawa_spherical"
    ncomp = 1
    charge_dim = 1
    result_dim = 4
    near_sparse = False
    #: kappa is a physical scale -> per-level translation classes
    scale_invariant = False
    eps2 = 1e-8

    def __init__(self, kappa=0.125):
        self.kappa = float(kappa)
        #: cached QR factors of the target-side fit basis — identical
        #: for every translation class at a given (kind, p, sigma, a),
        #: so per-class assembly is one basis evaluation + triangular
        #: solve (the array-era analogue of the reference's per-level
        #: shift-matrix memoization, YukawaSpherical.hpp:774-864)
        self._fit_cache = {}

    def width(self, p):
        return hm.real_width(p)

    # ----- basis fields (host, float64) -----
    def _out_basis(self, pts, sigma, p):
        """Outgoing (singular) real basis at physical points rel box
        center: slot (n,m) value A_n(sigma) k_n(kappa rho) Yhat_nm."""
        rho = np.linalg.norm(pts, axis=-1)
        dirs = pts / rho[:, None]
        ang = _angular_flat(dirs, p)  # [Q, T]
        iN = bessel_i(self.kappa * sigma, p)  # [p]
        kN = bessel_k(self.kappa * rho, p)  # [Q, p]
        n = hm.term_degrees(p)
        A = self.kappa * (2 * n + 1) * iN[n]
        vals = ang * (A[None, :] * kN[:, n])
        return _fold_real(vals, p)

    def _in_basis(self, pts, sigma, p):
        """Incoming (regular) real basis: slot value
        [i_n(kappa rho)/i_n(kappa sigma)] Yhat_nm."""
        rho = np.linalg.norm(pts, axis=-1)
        dirs = pts / np.maximum(rho, 1e-300)[:, None]
        ang = _angular_flat(dirs, p)
        iN = bessel_i(self.kappa * sigma, p)
        iR = bessel_i(self.kappa * rho, p)  # [Q, p]
        n = hm.term_degrees(p)
        vals = ang * (iR[:, n] / iN[n])
        return _fold_real(vals, p)

    # ----- projection builder -----
    def _fit_factors(self, kind, sigma_tgt, a, p):
        """QR of the (column-equilibrated) target basis on the fit
        sphere — shared across every class with the same target level."""
        key = (kind, round(float(sigma_tgt), 12), round(float(a), 12), p)
        hit = self._fit_cache.get(key)
        if hit is not None:
            return hit
        dirs, _ = _sphere_points(p)
        xt = a * dirs
        basis = self._out_basis if kind == "out" else self._in_basis
        B = basis(xt, sigma_tgt, p)
        cn = np.linalg.norm(B, axis=0)
        # the Im slots of m = 0 are identically zero columns (real
        # harmonics); solve on the nonzero-column subspace and leave
        # their coefficient rows zero
        live = cn > 1e-300
        Q, R = np.linalg.qr(B[:, live] / cn[live])
        out = (xt, cn, live, Q, R)
        self._fit_cache[key] = out
        return out

    def _project(self, kind, sigma_tgt, a, F_at, p):
        xt, cn, live, Q, R = self._fit_factors(kind, sigma_tgt, a, p)
        F = F_at(xt)
        T = np.zeros((len(cn), F.shape[1]))
        T[live] = np.linalg.solve(R, Q.T @ F) / cn[live][:, None]
        return T

    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        """hat-M_tgt = mat @ hat-M_src, dr = c_tgt - c_src (physical).
        Projection sphere a = 3 sigma_tgt encloses the source box with
        a convergence margin >= 2.4x (tail decays ~(0.87/2.1)^p)."""
        dr = np.asarray(dr, np.float64)
        return self._project(
            "out", sigma_tgt, 3.0 * sigma_tgt,
            lambda xt: self._out_basis(xt + dr, sigma_src, p), p,
        )

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        """hat-L_tgt = mat @ hat-M_src; fit sphere a = sigma_tgt sits
        inside the local-expansion convergence region (MAC guarantees
        |dr| >= 2 sigma under theta = 0.5)."""
        dr = np.asarray(dr, np.float64)
        return self._project(
            "in", sigma_tgt, 1.0 * sigma_tgt,
            lambda xt: self._out_basis(xt + dr, sigma_src, p), p,
        )

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        dr = np.asarray(dr, np.float64)
        return self._project(
            "in", sigma_tgt, 1.0 * sigma_tgt,
            lambda xt: self._in_basis(xt + dr, sigma_src, p), p,
        )

    def m2l_pair_scale(self, sigma_src):
        return np.ones_like(np.asarray(sigma_src, np.float64))

    # ----- device ops (torch, batched over bodies) -----
    def p2m(self, src, charges, d_norm, inv_sigma, p):
        """hat-M slots = q g_n(t) conj(R_n^m(d_norm)): the i_n radial
        ratio folded into the Laplace solid harmonics (ref P2M
        :149-176, scale-normalised)."""
        del src
        x = self.kappa / inv_sigma  # kappa sigma, [B]
        x2 = x * x
        g = _radial_ratio(d_norm, x2, p)  # [B, T]
        yr, yi = eval_regular(d_norm, p)
        return to_interleaved_ri(
            charges[..., None] * g * yr, -charges[..., None] * g * yi
        )[..., None, :]

    def l2p(self, tgt, L, d_norm, inv_sigma, p):
        """phi from hat-L: the same g_n radial correction on the regular
        harmonics; gradient by reverse mode."""
        del tgt
        x = self.kappa / inv_sigma
        x2 = x * x
        w = _as(hm.term_weights(p), L)
        Lr, Li = re_part(L[:, 0]), im_part(L[:, 0])

        def phi_fn(d):
            g = _radial_ratio(d, x2, p)
            yr, yi = eval_regular(d, p)
            return torch.sum(w * g * (Lr * yr - Li * yi), dim=-1)

        phi, grad = _grad_rows(phi_fn, d_norm)
        return torch.cat([phi[:, None], grad * inv_sigma[:, None]], dim=-1)

    def _m2p_potential(self, M, d_norm, x, p):
        """phi = sum w Re(hat-M A_n(sigma) k_n(kappa rho) Yhat): fused
        as h_n(t) * solid singular harmonics, h_n smooth for t >= MAC
        separation.  x = kappa sigma per body [B]."""
        t2 = torch.sum(d_norm * d_norm, dim=-1)
        t = torch.sqrt(t2)
        # s_n(x) (Horner), a_nj polynomial of k_n
        gc = _series_coeffs(p)
        sn = torch.zeros(x.shape + (p,), dtype=d_norm.dtype,
                         device=d_norm.device)
        x2 = (x * x)[:, None]
        for k in range(gc.shape[1] - 1, -1, -1):
            sn = sn * x2 + _as(gc[:, k], d_norm)
        # sigma * A_n(sigma) k_n(xt) t^{n+1}
        #   = (2n+1) s_n(x)/(2n+1)!! e^{-xt} (xt)^n sum_j a_nj (xt)^{-j}
        # (kappa x^{n-1} t^n = (xt)^n / sigma); smooth for MAC-separated
        # t, and -> 1 as kappa -> 0 (the Laplace limit).
        xt = (x * t)[:, None]
        ar = _as(np.arange(p), d_norm)
        pows = (1.0 / xt) ** ar  # (xt)^{-j}
        poly = pows @ _as(_kn_poly(p), d_norm).T  # [B, p]: sum_j a_nj (xt)^-j
        dfac = _as([_dfact(n) for n in range(p)], d_norm)
        twon1 = _as(2 * np.arange(p) + 1, d_norm)
        h = twon1 * sn / dfac * torch.exp(-xt) * poly * xt ** ar
        n_of = torch.as_tensor(hm.term_degrees(p), device=d_norm.device)
        sr, si = eval_singular(d_norm, p)
        w = _as(hm.term_weights(p), M)
        return torch.sum(
            w * h[:, n_of] * (re_part(M) * sr - im_part(M) * si), dim=-1
        )

    def m2p(self, tgt, M, d_norm, inv_sigma, p):
        del tgt
        x = self.kappa / inv_sigma
        Mr = M[:, 0]

        def phi_fn(d):
            return self._m2p_potential(Mr, d, x, p) * inv_sigma

        phi, grad = _grad_rows(phi_fn, d_norm)
        return torch.cat([phi[:, None], grad * inv_sigma[:, None]], dim=-1)

    # ----- near field -----
    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        del src_mask
        return self.p2p(tgt_fields["xyz"], src_fields["xyz"], charges)

    def p2p(self, tgt_xyz, src_xyz, charges):
        """phi = e^{-kappa r}/r, grad_t = (s-t)(1+kappa r)e^{-kappa r}/r^3."""
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
