"""Solid spherical harmonics and FMM translation operators for the
Laplace family.

The math follows the classic spherical-harmonic FMM operator set the
reference implements scalar-at-a-time (kernel/LaplaceSpherical.hpp:
evalMultipole/evalLocal recurrences :455-524, P2M :186-235, M2M
:245-285, M2L :296-329, L2L :378-411), re-designed for arrays:

* Harmonic evaluation uses a **Cartesian two-term recurrence** (no trig,
  no division by sin(theta)), vectorised over bodies — the natural form
  for array code and for autodiff (gradients are obtained with
  ``torch.func`` instead of the reference's hand-coded YnmTheta arrays).

* M2M / M2L / L2L are **dense real translation matrices** acting on the
  real/imaginary-stacked coefficient vector.  The complex operators are
  only real-linear (they mix ``M`` and ``conj(M)``), so a complex matrix
  cannot represent them; the ``[2T, 2T]`` real form can, and it turns
  every translation into dense matmuls.

* Expansions are **scale-normalised per box** (multipoles divided by
  sigma^n, locals multiplied by sigma^j, sigma = box half-side).  This
  keeps all coefficients O(1) in float32 and makes translation matrices
  depend only on the *normalised* offset — so the octree's grid-aligned
  centers collapse all M2M/L2L translations into 8 classes total and all
  M2L translations into a few hundred classes shared across levels.
  (The reference keeps raw coefficients and needs float64 + an EPS
  rescaling hack, LaplaceSpherical.hpp:30,93-95.)

Conventions (matching the reference so accuracy tests are comparable):
  R_n^m(d) = sqrt((n-m)!/(n+m)!) * rho^n  * P_n^m(cos th) * e^{i m phi}
  S_n^m(d) = sqrt((n-m)!/(n+m)!) * rho^-(n+1) * P_n^m(cos th) * e^{i m phi}
  multipole coefficients M_n^m for 0 <= m <= n at flat index
  n(n+1)/2 + m;  P2M accumulates q * conj(R_n^m).
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# index helpers


def num_terms(p: int) -> int:
    """Number of complex coefficients kept at order p: p(p+1)/2
    (ref LaplaceSpherical.hpp:134)."""
    return p * (p + 1) // 2


def term_degrees(p: int) -> np.ndarray:
    """Degree n of each flat (n,m>=0) coefficient index."""
    return np.concatenate([np.full(n + 1, n, dtype=np.int32) for n in range(p)])


def term_orders(p: int) -> np.ndarray:
    """Order m of each flat coefficient index."""
    return np.concatenate([np.arange(n + 1, dtype=np.int32) for n in range(p)])


def term_weights(p: int) -> np.ndarray:
    """Real-part weights: 1 for m=0, 2 for m>0 (conjugate-pair folding,
    ref LaplaceSpherical.hpp:352-361)."""
    return np.where(term_orders(p) == 0, 1.0, 2.0)


# ---------------------------------------------------------------------------
# factorial-based tables (float64; max argument 4*pmax safely < 170)


@functools.lru_cache(maxsize=None)
def _factorials(nmax: int) -> np.ndarray:
    f = np.ones(nmax + 1, dtype=np.float64)
    for i in range(1, nmax + 1):
        f[i] = f[i - 1] * i
    return f


def prefac(n, m):
    """sqrt((n-|m|)! / (n+|m|)!) (ref LaplaceSpherical.hpp:101).

    Out-of-range (|m| > n) entries are clamped — callers mask them out.
    """
    n = np.maximum(np.asarray(n), 0)
    m = np.abs(np.asarray(m))
    f = _factorials(int(2 * np.max(n) + 1) if n.size else 1)
    return np.sqrt(f[np.maximum(n - m, 0)] / f[np.minimum(n + m, len(f) - 1)])


def anm(n, m):
    """A_n^m = (-1)^n / sqrt((n-m)! (n+m)!) (ref LaplaceSpherical.hpp:102),
    symmetric in the sign of m.  Out-of-range entries clamped (masked by
    callers)."""
    n = np.maximum(np.asarray(n), 0)
    m = np.abs(np.asarray(m))
    f = _factorials(int(2 * np.max(n) + 1) if n.size else 1)
    return np.where(n % 2 == 0, 1.0, -1.0) / np.sqrt(
        f[np.maximum(n - m, 0)] * f[np.minimum(n + m, len(f) - 1)]
    )


# ---------------------------------------------------------------------------
# harmonic evaluation (numpy, full signed-m arrays) — host-side use only


def eval_regular_full(d, p):
    """R_n^m(d) for n < p, -n <= m <= n, at full index n^2+n+m.

    Vectorised over leading dims of ``d`` (shape [..., 3]).  Negative-m
    entries satisfy R_n^{-m} = conj(R_n^m).
    """
    d = np.asarray(d, dtype=np.float64)
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z
    u = x + 1j * yc
    out = np.zeros(d.shape[:-1] + (p * p,), dtype=np.complex128)
    # B_n^m = rho^n P_n^m(cos th) e^{i m phi} via Cartesian recurrence
    bmm = np.ones_like(u)  # B_m^m without prefactor
    for m in range(p):
        if m > 0:
            bmm = bmm * (-(2 * m - 1)) * u
        b_prev2 = np.zeros_like(u)
        b_prev = bmm
        for n in range(m, p):
            if n > m:
                b = ((2 * n - 1) * z * b_prev - (n + m - 1) * rho2 * b_prev2) / (
                    n - m
                )
                b_prev2, b_prev = b_prev, b
            val = prefac(n, m) * b_prev
            out[..., n * n + n + m] = val
            if m > 0:
                out[..., n * n + n - m] = np.conj(val)
    return out


def eval_singular_full(d, p, eps=1e-300):
    """S_n^m(d) = rho^{-n-1}-type singular harmonics, full signed-m array."""
    d = np.asarray(d, dtype=np.float64)
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z + eps
    inv_rho2 = 1.0 / rho2
    u = x + 1j * yc
    out = np.zeros(d.shape[:-1] + (p * p,), dtype=np.complex128)
    cmm = np.sqrt(inv_rho2) + 0j  # C_0^0 = 1/rho
    for m in range(p):
        if m > 0:
            cmm = cmm * (-(2 * m - 1)) * u * inv_rho2
        c_prev2 = np.zeros_like(u)
        c_prev = cmm
        for n in range(m, p):
            if n > m:
                c = (
                    ((2 * n - 1) * z * c_prev - (n + m - 1) * c_prev2)
                    * inv_rho2
                    / (n - m)
                )
                c_prev2, c_prev = c_prev, c
            val = prefac(n, m) * c_prev
            out[..., n * n + n + m] = val
            if m > 0:
                out[..., n * n + n - m] = np.conj(val)
    return out


# ---------------------------------------------------------------------------
# translation-operator coefficient grids (cached per p; translation-
# independent integer/real data so per-class assembly is pure gathers)


@functools.lru_cache(maxsize=None)
def _pair_grids(p):
    """Meshgrids over (target term a=(j,k), source term b=(n,mu>=0))."""
    j = term_degrees(p).astype(np.int64)
    k = term_orders(p).astype(np.int64)
    n = j.copy()
    mu = k.copy()
    J = j[:, None]
    K = k[:, None]
    N = n[None, :]
    MU = mu[None, :]
    return J, K, N, MU


def _ipow(e):
    """i**e for integer array e, as complex128."""
    e = np.mod(e, 4)
    table = np.array([1, 1j, -1, -1j], dtype=np.complex128)
    return table[e]


@functools.lru_cache(maxsize=None)
def _m2l_coeffs(p):
    """Translation-independent parts of the M2L operator.

    Returns (Cp, idxp, Cc, idxc, maskc): L_a += sum_b Cp[a,b] *
    S_full[idxp[a,b]] * M_b  +  (mu>=1) Cc[a,b] * S_full[idxc[a,b]] *
    conj(M_b), with S_full of order 2p.  Mirrors the Cnm construction at
    LaplaceSpherical.hpp:106-116 and the M2L loops :305-328, without the
    EPS scaling.
    """
    J, K, N, MU = _pair_grids(p)

    def cnm(m):
        return (
            _ipow(np.abs(K - m) - np.abs(K) - np.abs(m))
            * np.where(J % 2 == 0, 1.0, -1.0)
            * anm(N, m)
            * anm(J, K)
            / anm(J + N, m - K)
        )

    # m = +mu path (acts on M)
    Cp = cnm(MU)
    idxp = (J + N) * (J + N) + (J + N) + (MU - K)
    # m = -mu path (acts on conj(M)), only mu >= 1
    Cc = cnm(-MU)
    idxc = (J + N) * (J + N) + (J + N) + (-MU - K)
    maskc = MU >= 1
    return Cp, idxp, Cc * maskc, np.where(maskc, idxc, 0), maskc


@functools.lru_cache(maxsize=None)
def _m2m_coeffs(p):
    """Translation-independent parts of M2M (ref LaplaceSpherical.hpp:255-281).

    target a=(j,k) <- source b=(nu,mu) through harmonic degree n = j-nu:
    branch M:      m = k-mu   (mu>=1, -n<=m<=min(k-1,n))
    branch conjM:  m = mu+k   (k<=m<=n)
    coefficient uses conj(R_n^m) of the normalised translation.
    """
    J, K, NU, MU = _pair_grids(p)
    n = J - NU
    valid = n >= 0

    # branch acting on M
    m1 = K - MU
    mask1 = valid & (MU >= 1) & (np.abs(m1) <= n)
    c1 = np.where(
        mask1,
        _ipow(m1 - np.abs(m1))
        * np.where(n % 2 == 0, 1.0, -1.0)
        * anm(np.maximum(n, 0), m1 * mask1)
        * anm(NU, MU)
        / anm(J, K),
        0.0,
    )
    idx1 = np.where(mask1, n * n + n + m1, 0)

    # branch acting on conj(M)
    m2 = MU + K
    mask2 = valid & (m2 <= n)
    c2 = np.where(
        mask2,
        np.where((K + n + m2) % 2 == 0, 1.0, -1.0)
        * anm(np.maximum(n, 0), m2)
        * anm(NU, MU)
        / anm(J, K),
        0.0,
    )
    idx2 = np.where(mask2, n * n + n + m2, 0)
    return c1, idx1, c2, idx2


@functools.lru_cache(maxsize=None)
def _l2l_coeffs(p):
    """Translation-independent parts of L2L (ref LaplaceSpherical.hpp:385-410).

    target a=(j,k) <- source b=(n,mu) through harmonic degree n-j:
    branch L:      m = mu      (n>=j, n-j >= |mu-k|)
    branch conjL:  m = -mu     (mu>=1, mu+k <= n-j)
    coefficient uses R_{n-j}^{m-k} of the normalised translation.
    """
    J, K, N, MU = _pair_grids(p)
    dj = N - J
    valid = dj >= 0

    m1 = MU
    mask1 = valid & (dj >= np.abs(m1 - K))
    c1 = np.where(
        mask1,
        _ipow((m1 - K) - np.abs(m1 - K))
        * anm(np.maximum(dj, 0), (m1 - K) * mask1)
        * anm(J, K)
        / anm(N, MU),
        0.0,
    )
    idx1 = np.where(mask1, dj * dj + dj + (m1 - K), 0)

    m2 = -MU
    mask2 = valid & (MU >= 1) & (MU + K <= dj)
    c2 = np.where(
        mask2,
        np.where(K % 2 == 0, 1.0, -1.0)
        * anm(np.maximum(dj, 0), (m2 - K) * mask2)
        * anm(J, K)
        / anm(N, MU),
        0.0,
    )
    idx2 = np.where(mask2, dj * dj + dj + (m2 - K), 0)
    return c1, idx1, c2, idx2


# ---------------------------------------------------------------------------
# real matrix assembly — INTERLEAVED layout [re_0, im_0, re_1, im_1, ...]
# with coefficients ordered by degree, so truncating to a lower p is a
# prefix slice of both expansions and matrices


def real_width(p: int) -> int:
    """Real slots per expansion component: 2 * num_terms."""
    return 2 * num_terms(p)


def _real_form(T, Tc):
    """Real matrix of the real-linear map L = T @ M + Tc @ conj(M), in
    interleaved (re, im) layout."""
    n = T.shape[0]
    m = T.shape[1]
    R = np.zeros((2 * n, 2 * m))
    R[0::2, 0::2] = T.real + Tc.real
    R[0::2, 1::2] = -T.imag + Tc.imag
    R[1::2, 0::2] = T.imag + Tc.imag
    R[1::2, 1::2] = T.real - Tc.real
    return R


def _interleave_scale(s):
    """Duplicate a per-term scale vector to the interleaved layout."""
    return np.repeat(s, 2)


def m2m_matrix(dr, sigma_src, sigma_tgt, p):
    """Scale-normalised M2M: hat-M_target = mat @ hat-M_source, with
    hat-M_n = M_n / sigma^n.  ``dr`` = target_center - source_center
    (physical)."""
    c1, idx1, c2, idx2 = _m2m_coeffs(p)
    drn = np.asarray(dr, dtype=np.float64) / sigma_src
    R = np.conj(eval_regular_full(drn, p))
    T = c1 * R[idx1]
    Tc = c2 * R[idx2]
    j = term_degrees(p).astype(np.float64)
    scale = (sigma_src / sigma_tgt) ** j  # per target row
    return _real_form(T, Tc) * _interleave_scale(scale)[:, None]


def m2l_matrix(dr, sigma_src, sigma_tgt, p):
    """Scale-normalised M2L *without* the overall 1/sigma_source factor
    (applied per pair at execution): sigma_s * hat-L contribution."""
    Cp, idxp, Cc, idxc, _ = _m2l_coeffs(p)
    drn = np.asarray(dr, dtype=np.float64) / sigma_src
    S = eval_singular_full(drn, 2 * p)
    T = Cp * S[idxp]
    Tc = Cc * S[idxc]
    j = term_degrees(p).astype(np.float64)
    scale = (sigma_tgt / sigma_src) ** j  # per target row
    return _real_form(T, Tc) * _interleave_scale(scale)[:, None]


def l2l_matrix(dr, sigma_src, sigma_tgt, p):
    """Scale-normalised L2L: hat-L_target = mat @ hat-L_source, with
    hat-L_n = L_n * sigma^n."""
    c1, idx1, c2, idx2 = _l2l_coeffs(p)
    drn = np.asarray(dr, dtype=np.float64) / sigma_tgt
    R = eval_regular_full(drn, p)
    T = c1 * R[idx1]
    Tc = c2 * R[idx2]
    n = term_degrees(p).astype(np.float64)
    scale = (sigma_tgt / sigma_src) ** n  # per source column
    return _real_form(T, Tc) * _interleave_scale(scale)[None, :]
