"""Singular / near-singular panel integrals (host-side, vectorised).

Counterpart of examples/BEM/SemiAnalytical.hpp: the surface integral of
G (and dG/dn) over a flat triangle is reduced to three edge line
integrals in panel-local polar coordinates, each evaluated with 5-point
Gauss in the angle.  Supports LAPLACE (kappa=0) and YUKAWA (kappa>0),
matching the reference's equation switch (SemiAnalytical.hpp:41-68).

These integrals are branchy and run once at plan build on the host —
their results live in the precomputed near-field sparse matrix (the
array equivalent of EvalInteractionLazySparse's CSR assembly,
EvalInteractionLazySparse.hpp:68-115) — so the device never sees them.

Everything is vectorised over an arbitrary batch of (panel, target)
pairs; the reference's per-edge sign flips and zero-crossing splits
collapse into a uniform two-sub-integral form using the antisymmetry
lineInt(a, b) = -lineInt(b, a).
"""

from __future__ import annotations

import numpy as np

from fmm_bem_tpu_torch.bem.quadrature import GAUSS_1D_5


def _line_int(z, x, va, vb, kappa):
    """Edge line integral in polar angle from atan2(va,x) to atan2(vb,x).

    Returns (G, dGdn) contributions, vectorised over the batch.
    Ref SemiAnalytical.hpp:13-71 (lineInt).
    """
    theta1 = np.arctan2(va, x)
    theta2 = np.arctan2(vb, x)
    dtheta = theta2 - theta1
    thetam = 0.5 * (theta2 + theta1)

    abs_z = np.abs(z)
    sign_z = np.where(abs_z < 1e-10, 0.0, np.sign(z))

    xk, wk = GAUSS_1D_5
    G = np.zeros_like(x)
    dG = np.zeros_like(x)
    exp_kz = np.exp(-kappa * abs_z) if kappa else 1.0
    for i in range(len(xk)):
        thetak = 0.5 * dtheta * xk[i] + thetam
        r_theta = x / np.cos(thetak)
        R = np.sqrt(r_theta * r_theta + z * z)
        if kappa:
            exp_kr = np.exp(-kappa * R)
            G += -wk[i] * (exp_kr - exp_kz) / kappa * 0.5 * dtheta
            dG += wk[i] * (z / np.maximum(R, 1e-300) * exp_kr - exp_kz * sign_z) * 0.5 * dtheta
        else:
            G += wk[i] * (R - abs_z) * 0.5 * dtheta
            dG += wk[i] * (z / np.maximum(R, 1e-300) - sign_z) * 0.5 * dtheta
    return G, dG


def _int_side(v1, v2, p, kappa):
    """One panel edge (2-D endpoints v1, v2 in target-centred plane
    coordinates, target height p above the plane) -> (G, dGdn).

    Re-derivation of ref intSide (SemiAnalytical.hpp:80-150): rotate so
    the edge is a vertical line at perpendicular distance x >= 0, then
    always evaluate the two sub-integrals (0 -> y1) + (y2 -> 0); by
    antisymmetry of lineInt this equals both of the reference's
    branches.
    """
    e = v2[:, :2] - v1[:, :2]
    elen = np.linalg.norm(e, axis=1)
    safe = np.maximum(elen, 1e-300)
    eu = e / safe[:, None]
    # signed perpendicular coordinate of the edge line wrt the origin
    # (target projection); orientation matches the reference's
    # orthog = cross(z, v21u) frame so the sector signs come out right
    x = eu[:, 0] * v1[:, 1] - eu[:, 1] * v1[:, 0]
    y1 = v1[:, 0] * eu[:, 0] + v1[:, 1] * eu[:, 1]
    y2 = v2[:, 0] * eu[:, 0] + v2[:, 1] * eu[:, 1]
    # flip so the perpendicular distance is positive
    neg = x < 0
    x = np.abs(x)
    y1 = np.where(neg, -y1, y1)
    y2 = np.where(neg, -y2, y2)

    Ga, dGa = _line_int(p, x, np.zeros_like(y1), y1, kappa)
    Gb, dGb = _line_int(p, x, y2, np.zeros_like(y2), kappa)
    degenerate = (x < 1e-14) | (elen < 1e-300)
    G = np.where(degenerate, 0.0, Ga + Gb)
    dG = np.where(degenerate, 0.0, dGa + dGb)
    return G, dG


def semi_analytical(verts, x, same, kappa=0.0):
    """Semi-analytical integral of G and dG/dn over triangles.

    Parameters
    ----------
    verts : [B, 3, 3] triangle vertices
    x : [B, 3] target points
    same : [B] bool — self-interaction (dGdn forced to +-2pi, ref
        SemiAnalytical.hpp:196-201)
    kappa : Yukawa screening parameter (0 -> Laplace)

    Returns (G, dGdn), each [B].
    """
    verts = np.asarray(verts, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    y0, y1, y2 = verts[:, 0], verts[:, 1], verts[:, 2]

    # panel-local frame (ref SemiAnalytical.hpp:159-176)
    X = y1 - y0
    Z = np.cross(y1 - y0, y2 - y0)
    X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-300)
    Z = Z / np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1e-300)
    Y = np.cross(Z, X)

    def to_plane(v):
        rel = v - y0
        return np.stack(
            [(rel * X).sum(1), (rel * Y).sum(1), (rel * Z).sum(1)], axis=1
        )

    xp = to_plane(x)
    p0 = to_plane(y0)
    p1 = to_plane(y1)
    p2 = to_plane(y2)
    # shift in-plane origin to the target's projection; keep panel z(=0)
    shift = np.concatenate([xp[:, :2], np.zeros((len(x), 1))], axis=1)
    p0 = p0 - shift
    p1 = p1 - shift
    p2 = p2 - shift
    height = xp[:, 2]

    G = np.zeros(len(x))
    dG = np.zeros(len(x))
    for a, b in ((p0, p1), (p1, p2), (p2, p0)):
        Ge, dGe = _int_side(a, b, height, kappa)
        G += Ge
        dG += dGe

    same = np.asarray(same, dtype=bool)
    if kappa:
        dG = np.where(same, -2.0 * np.pi, dG)
    else:
        dG = np.where(same, 2.0 * np.pi, dG)
    return G, dG


# ---------------------------------------------------------------------------
# near-field entry assembly for the Laplace/Yukawa BEM kernels


def _quad_G(t, verts, area, qpts, qw, kappa=0.0):
    """K-point quadrature of int G over panels: sum_k w_k A / |t - qp_k|
    (ref LaplaceSphericalBEM::eval_G far branch, :195-203)."""
    d = t[:, None, :] - qpts
    r = np.maximum(np.sqrt((d * d).sum(-1)), 1e-100)
    g = np.exp(-kappa * r) / r if kappa else 1.0 / r
    return (qw * g).sum(1) * area


def _quad_dGdn(t, verts, area, normal, qpts, qw, kappa=0.0):
    """K-point quadrature of int dG/dn: sum_k w_k A (qp_k - t).n / r^3
    (ref eval_dGdn, :241-263); Yukawa adds the screening factor
    (kappa r + 1) e^{-kappa r} (ref YukawaCartesianBEM::eval_dGdn)."""
    d = qpts - t[:, None, :]
    r2 = (d * d).sum(-1)
    # guard the q==t case (hit for self rows whose value is later
    # overwritten by the analytic +-2pi)
    r2 = np.maximum(r2, 1e-100)
    r = np.sqrt(r2)
    dn = (d * normal[:, None, :]).sum(-1)
    if kappa:
        val = dn * (kappa * r + 1.0) * np.exp(-kappa * r) / (r2 * r)
    else:
        val = dn / (r2 * r)
    return (qw * val).sum(1) * area


def near_entries_laplace(tgt_fields, src_fields, t_idx, s_idx, fine_K=17, kappa=0.0):
    """(G, dGdn) matrix entries for target centres (tgt_fields["xyz"])
    vs source panels — the semantics of the reference's BC-switched
    operator() (LaplaceSphericalBEM.hpp:273-297):

    - G:    semi-analytical when sqrt(2 A_s)/dist >= 0.5, else K-point
            panel quadrature (ref eval_G :159-205)
    - dGdn: 2*pi (self), fine-K quadrature when near, else K-point
            quadrature (ref eval_dGdn :208-264; its SA branch is
            compiled out in the reference too)
    """
    from fmm_bem_tpu_torch.bem.quadrature import get_rule

    centers = np.asarray(src_fields["xyz"])
    verts = np.asarray(src_fields["vertices"])
    area = np.asarray(src_fields["area"])
    normal = np.asarray(src_fields["normal"])
    qp = np.asarray(src_fields["qp_off"]) + centers[:, None, :]
    qw = np.asarray(src_fields["qw"])

    # native C++ assembly when available (identical semantics,
    # multithreaded; see native/fmm_native.cpp fmm_near_laplace)
    from fmm_bem_tpu_torch import native

    nat = native.near_laplace(
        tgt_fields, src_fields, t_idx, s_idx, fine_K, kappa
    )
    if nat is not None:
        return nat

    t = np.asarray(tgt_fields["xyz"])[t_idx]
    sv = verts[s_idx]
    sa = area[s_idx]
    sn = normal[s_idx]
    sqp = qp[s_idx]
    sqw = qw[s_idx]

    dist = np.linalg.norm(t - centers[s_idx], axis=1)
    near = np.sqrt(2.0 * sa) / np.maximum(dist, 1e-300) >= 0.5
    self_ = dist < 1e-8

    # --- G
    G = _quad_G(t, sv, sa, sqp, sqw, kappa)
    if near.any():
        Gn, _ = semi_analytical(sv[near], t[near], self_[near], kappa)
        G[near] = Gn

    # --- dGdn
    dG = _quad_dGdn(t, sv, sa, sn, sqp, sqw, kappa)
    if near.any():
        pts_f, w_f = get_rule(fine_K)
        fqp = np.einsum("kj,njd->nkd", pts_f, sv[near])
        fw = np.broadcast_to(w_f, (near.sum(), len(w_f)))
        dG[near] = _quad_dGdn(t[near], sv[near], sa[near], sn[near], fqp, fw, kappa)
    if kappa:
        dG[self_] = -2.0 * np.pi
    else:
        dG[self_] = 2.0 * np.pi
    return G, dG
