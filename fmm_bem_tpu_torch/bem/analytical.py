"""Closed-form singular panel integrals (the reference's Fata role).

The reference evaluates the singular Stokes single-layer self-integral
with S. Fata's closed-form expressions (FataAnalytical.hpp:236-420,
consumed at kernel/StokesSphericalBEM.hpp:279-293; optional for Laplace
via USE_ANALYTICAL, kernel/LaplaceSphericalBEM.hpp:8-12).  This module
provides the same capability from an independent derivation specialised
to the case the reference actually uses it for — the *self* term, where
the target lies in the panel plane (the panel centroid):

For a flat triangle T with in-plane target x, switch to polar
coordinates about x (dS = r dr dtheta).  The Stokeslet block
``G = I/r + rhat rhat^T / r`` then integrates radially to elementary
per-edge antiderivatives.  Decompose T into three sub-triangles
(x, v_a, v_b); for each edge let t_hat be the unit edge direction,
f_hat the unit foot-of-perpendicular direction from x, d the
perpendicular distance, and s the signed coordinate along the edge
(s_a < s_b, s_b - s_a = edge length).  With psi the angle from f_hat
(tan psi = s/d) the radial extent is R(psi) = d sec(psi) and

  int 1/r dS              = d * [asinh(s/d)]
  int cos^2 psi sec psi   -> [sin psi],   sin psi = s / sqrt(s^2+d^2)
  int sin psi cos psi sec -> [-cos psi],  cos psi = d / sqrt(s^2+d^2)
  int sin^2 psi sec psi   -> [asinh(s/d) - sin psi]

so the in-plane direction u(psi) = cos(psi) f_hat + sin(psi) t_hat
gives the uu^T moment per edge in closed form.  Every edge contributes
positively (s_b > s_a by construction), which sums the three sector
integrals exactly — valid whenever x is inside T, which holds for the
self-term (x = centroid).

All functions are batched numpy (host near-field assembly path).
"""

from __future__ import annotations

import numpy as np


def _edge_terms(verts, x):
    """Per-edge closed-form primitives.

    Returns (I0, M) where I0 [B] = int_T 1/r dS and M [B,3,3] =
    int_T rhat rhat^T / r dS, for targets x [B,3] inside the flat
    triangles verts [B,3,3] (and in their planes).
    """
    verts = np.asarray(verts, np.float64)
    x = np.asarray(x, np.float64)
    B = x.shape[0]
    I0 = np.zeros(B)
    M = np.zeros((B, 3, 3))
    for a, b in ((0, 1), (1, 2), (2, 0)):
        va = verts[:, a] - x
        vb = verts[:, b] - x
        E = vb - va
        elen = np.linalg.norm(E, axis=1)
        elen = np.maximum(elen, 1e-300)
        t_hat = E / elen[:, None]
        s_a = (va * t_hat).sum(1)
        s_b = (vb * t_hat).sum(1)
        F = va - s_a[:, None] * t_hat  # foot of perpendicular
        d = np.linalg.norm(F, axis=1)
        # target on the edge line -> zero-area sector, no contribution
        ok = d > 1e-14 * elen
        dd = np.where(ok, d, 1.0)
        f_hat = F / dd[:, None]

        asinh_b = np.arcsinh(s_b / dd)
        asinh_a = np.arcsinh(s_a / dd)
        dS = asinh_b - asinh_a
        ra = np.sqrt(s_a * s_a + d * d)
        rb = np.sqrt(s_b * s_b + d * d)
        dsin = s_b / rb - s_a / ra
        dcos = dd / rb - dd / ra

        ff = f_hat[:, :, None] * f_hat[:, None, :]
        tt = t_hat[:, :, None] * t_hat[:, None, :]
        ft = f_hat[:, :, None] * t_hat[:, None, :]
        ft = ft + np.swapaxes(ft, 1, 2)

        w = np.where(ok, d, 0.0)
        I0 += w * dS
        M += w[:, None, None] * (
            dsin[:, None, None] * ff
            - dcos[:, None, None] * ft
            + (dS - dsin)[:, None, None] * tt
        )
    return I0, M


def laplace_single_layer_self(verts, x):
    """Closed-form int_T 1/|y-x| dS(y) for in-plane interior targets.

    The Laplace-G Fata case (USE_ANALYTICAL,
    kernel/LaplaceSphericalBEM.hpp:8-12).  The companion dGdn self
    integral vanishes identically for a flat panel ((y-x).n = 0)."""
    I0, _ = _edge_terms(verts, x)
    return I0


def stokes_single_layer_self(verts, x):
    """Closed-form int_T (I/r + rhat rhat^T/r) dS — the Stokeslet
    single-layer self block (Fata role, StokesSphericalBEM.hpp:279).

    Returns [B,3,3]; multiply by 1/(2 mu) for the velocity BC entry."""
    I0, M = _edge_terms(verts, x)
    return I0[:, None, None] * np.eye(3) + M


# ----------------------------------------------------------------------
# General (off-plane) closed forms — the reference's full Fata surface
# (FataAnalytical.hpp:236-420).  Independent derivation: every panel
# moment follows from in-plane divergence/gradient identities,
#
#   div(rho/r)    =  1/r   + h^2/r^3        grad(1/r)   = -rho/r^3
#   d_j(rho_i/r)  =  P_ij/r - rho_i rho_j/r^3
#   div(rho/r^3)  = -1/r^3 + 3 h^2/r^5      grad(1/r^3) = -3 rho/r^5
#   d_j(rho_i/r^3)=  P_ij/r^3 - 3 rho_i rho_j/r^5
#
# (rho = in-plane offset from the target's foot point x0, h = signed
# height of x above the plane, P = in-plane projector), which reduce
# every surface moment {1, rho, rho rho^T} x {r^-1, r^-3, r^-5} to
# per-edge line integrals with elementary antiderivatives plus the
# triangle's solid angle Omega at x (int 1/r^3 dS = Omega/|h|,
# Van Oosterom-Strackee).  Structurally unlike the reference's
# edge-parametrised Fata expressions, but the same capability: exact
# near-singular panel integrals for arbitrary targets.
# ----------------------------------------------------------------------


def solid_angle(verts, x):
    """Unsigned solid angle of triangles [B,3,3] at targets x [B,3]
    (Van Oosterom & Strackee 1983, atan2 form)."""
    v1 = verts[:, 0] - x
    v2 = verts[:, 1] - x
    v3 = verts[:, 2] - x
    l1 = np.linalg.norm(v1, axis=1)
    l2 = np.linalg.norm(v2, axis=1)
    l3 = np.linalg.norm(v3, axis=1)
    num = np.einsum("bi,bi->b", v1, np.cross(v2, v3))
    den = (
        l1 * l2 * l3
        + np.einsum("bi,bi->b", v1, v2) * l3
        + np.einsum("bi,bi->b", v2, v3) * l1
        + np.einsum("bi,bi->b", v3, v1) * l2
    )
    return np.abs(2.0 * np.arctan2(num, den))


def _panel_moments(verts, x, want_r5=False):
    """Closed-form panel moments for arbitrary targets.

    Returns a dict with (all [B] / [B,3] / [B,3,3]):
      n      : unit panel normal (winding orientation)
      h      : signed height of x above the plane ((x-y0).n)
      omega  : unsigned solid angle at x
      I1     : int 1/r dS
      Vr3    : int rho/r^3 dS             (in-plane vector, 3-D coords)
      Trr3   : int rho rho^T/r^3 dS
      hI3    : h * int 1/r^3 dS   = sign(h) * omega
      h2I3   : h^2 * int 1/r^3 dS = |h| * omega
    and when want_r5:
      h2Vr5  : h^2 * int rho/r^5 dS
      hTrr5  : h * int rho rho^T/r^5 dS
      h3I5   : h^3 * int 1/r^5 dS
    Every returned combination is finite for h -> 0.
    """
    verts = np.asarray(verts, np.float64)
    x = np.asarray(x, np.float64)
    B = x.shape[0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    nv = np.cross(e1, e2)
    n = nv / np.maximum(np.linalg.norm(nv, axis=1), 1e-300)[:, None]
    h = np.einsum("bi,bi->b", x - verts[:, 0], n)
    x0 = x - h[:, None] * n  # foot point in the panel plane

    omega = solid_angle(verts, x)
    P = np.eye(3)[None] - n[:, :, None] * n[:, None, :]

    I1 = np.zeros(B)
    Vr3 = np.zeros((B, 3))
    Trr3_edge = np.zeros((B, 3, 3))
    sum_dL3 = np.zeros(B)
    Vr5_edge = np.zeros((B, 3))
    Trr5_edge = np.zeros((B, 3, 3))

    for a, b in ((0, 1), (1, 2), (2, 0)):
        va = verts[:, a] - x0
        vb = verts[:, b] - x0
        E = vb - va
        elen = np.maximum(np.linalg.norm(E, axis=1), 1e-300)
        t_hat = E / elen[:, None]
        # outward in-plane edge normal for this winding: t x n
        nu = np.cross(t_hat, n)
        d_e = np.einsum("bi,bi->b", va, nu)  # signed: + outside edge
        s_a = np.einsum("bi,bi->b", va, t_hat)
        s_b = np.einsum("bi,bi->b", vb, t_hat)
        c2 = d_e * d_e + h * h
        c = np.sqrt(np.maximum(c2, 1e-300))
        r_a = np.sqrt(s_a * s_a + c2)
        r_b = np.sqrt(s_b * s_b + c2)
        # guard the true edge singularity (x ON the edge segment):
        # the integrals genuinely diverge there; clamp like quadrature
        L1 = np.arcsinh(s_b / c) - np.arcsinh(s_a / c)
        Ls = r_b - r_a
        L3 = (s_b / np.maximum(c2 * r_b, 1e-300)
              - s_a / np.maximum(c2 * r_a, 1e-300))
        Ls3 = 1.0 / np.maximum(r_a, 1e-300) - 1.0 / np.maximum(
            r_b, 1e-300
        )

        I1 += d_e * L1
        Vr3 -= nu * L1[:, None]
        # int_e rho/r dl = d_e nu L1 + t Ls
        edge_vec1 = d_e[:, None] * nu * L1[:, None] + t_hat * Ls[:, None]
        Trr3_edge += edge_vec1[:, :, None] * nu[:, None, :]
        sum_dL3 += d_e * L3
        if want_r5:
            Vr5_edge += nu * L3[:, None]
            edge_vec3 = (
                d_e[:, None] * nu * L3[:, None] + t_hat * Ls3[:, None]
            )
            Trr5_edge += edge_vec3[:, :, None] * nu[:, None, :]

    habs = np.abs(h)
    sgn = np.sign(h)
    I1 = I1 - habs * omega
    hI3 = sgn * omega
    h2I3 = habs * omega
    Trr3 = P * I1[:, None, None] - Trr3_edge

    out = {
        "n": n, "h": h, "omega": omega, "I1": I1,
        "Vr3": Vr3, "Trr3": Trr3, "hI3": hI3, "h2I3": h2I3,
    }
    if want_r5:
        # 3 h^2 I5 = I3 + sum d_e L3  (times h for the finite combo)
        out["h3I5"] = (sgn * omega + h * sum_dL3) / 3.0
        out["h2Vr5"] = -(h * h)[:, None] * Vr5_edge / 3.0
        out["hTrr5"] = (
            P * hI3[:, None, None] - h[:, None, None] * Trr5_edge
        ) / 3.0
    return out


def laplace_layers(verts, x):
    """Closed-form (int 1/r dS, int dG/dn dS) for arbitrary targets —
    the general Fata Laplace case (FataAnalytical.hpp LAPLACE path).

    dG/dn follows the framework/reference convention (integrals.py
    _quad_dGdn; ref eval_dGdn): integrand (y-x).n/r^3 = -h/r^3, so the
    closed form is -sign(h)*omega."""
    m = _panel_moments(verts, x)
    return m["I1"], -m["hI3"]


def stokes_single_layer(verts, x):
    """Closed-form int_T (I/r + r r^T/r^3) dS for ARBITRARY targets
    (r = y - x).  Off-plane generalisation of the Fata single-layer
    integral (FataAnalytical.hpp STOKES path, :236-420); reduces to
    ``stokes_single_layer_self`` in-plane.  Returns [B,3,3]; multiply
    by 1/(2 mu) for the velocity BC entry."""
    m = _panel_moments(verts, x)
    n, h = m["n"], m["h"]
    # r r^T = rho rho^T - h (rho n^T + n rho^T) + h^2 n n^T
    cross = m["Vr3"][:, :, None] * n[:, None, :]
    cross = cross + np.swapaxes(cross, 1, 2)
    rr3 = (
        m["Trr3"]
        - h[:, None, None] * cross
        + m["h2I3"][:, None, None] * (n[:, :, None] * n[:, None, :])
    )
    return m["I1"][:, None, None] * np.eye(3) + rr3


def stokes_stresslet_layer(verts, x):
    """Closed-form int_T (dx.n) dx dx^T / r^5 dS in the framework's
    dx = x - y convention (kernels/stokes_bem.py _stresslet_block;
    multiply by -3 for the traction BC entry, ref
    StokesSphericalBEM.hpp eval_traction_integral).

    (dx.n) = h is constant over the flat panel and dx dx^T = r r^T, so
    the integral is h int r r^T/r^5 dS, assembled from the finite
    combinations h*Trr5, h^2*Vr5, h^3*I5.  At h = 0 exactly this
    returns the principal value 0; the one-sided limits for a target
    over the panel interior are -+(2 pi/3) I (the double-layer jump),
    i.e. +-2 pi I after the traction entry's -3 scale — consistent
    with the reference's 2 pi I self convention added separately."""
    m = _panel_moments(verts, x, want_r5=True)
    n = m["n"]
    cross = m["h2Vr5"][:, :, None] * n[:, None, :]
    cross = cross + np.swapaxes(cross, 1, 2)
    return (
        m["hTrr5"]
        - cross
        + m["h3I5"][:, None, None] * (n[:, :, None] * n[:, None, :])
    )
