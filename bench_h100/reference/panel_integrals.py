"""Panel quadrature and the semi-analytical panel integrals, frozen.

A copy of ``fmm_bem_tpu_torch/bem/quadrature.py`` (the 3-point and
16-point Dunavant rules; the reference's "17" is the 16-point table)
and ``fmm_bem_tpu_torch/bem/integrals.py`` (``semi_analytical``: the
integral of G and dG/dn over a flat triangle as three edge line
integrals in panel-local polar coordinates, 5-point Gauss in the angle;
after the reference's SemiAnalytical.hpp), Laplace only.  Kept here so
that the yardstick does not move with the program.
"""

from __future__ import annotations

import numpy as np

_RULES = {
    # midpoint rule (degree 2), the reference's 3-point table
    3: [(1 / 3, (0.0, 0.5))],
    # degree-8 16-point rule; the reference labels it "17"
    16: [
        (0.144315607677787, (1 / 3,)),
        (0.095091634267285, (0.081414823414554, 0.459292588292723)),
        (0.103217370534718, (0.658861384496480, 0.170569307751760)),
        (0.032458497623198, (0.898905543365938, 0.050547228317031)),
        (0.027230314174435,
         (0.008394777409958, 0.263112829634638, 0.728492392955404)),
    ],
}

GAUSS_1D_5 = np.polynomial.legendre.leggauss(5)


def rule(K):
    """(barycentric points [K', 3], weights [K'] summing to 1)."""
    if K == 17:
        K = 16
    pts, wts = [], []
    for w, gen in _RULES[K]:
        if len(gen) == 1:
            perms = [(gen[0],) * 3]
        elif len(gen) == 2:
            a, b = gen
            perms = [(a, b, b), (b, a, b), (b, b, a)]
        else:
            a, b, c = gen
            perms = [(a, b, c), (a, c, b), (b, a, c),
                     (b, c, a), (c, a, b), (c, b, a)]
        for p in perms:
            pts.append(p)
            wts.append(w)
    return np.asarray(pts, np.float64), np.asarray(wts, np.float64)


def _line_int(z, x, va, vb):
    theta1 = np.arctan2(va, x)
    theta2 = np.arctan2(vb, x)
    dtheta = theta2 - theta1
    thetam = 0.5 * (theta2 + theta1)
    abs_z = np.abs(z)
    sign_z = np.where(abs_z < 1e-10, 0.0, np.sign(z))
    xk, wk = GAUSS_1D_5
    G = np.zeros_like(x)
    dG = np.zeros_like(x)
    for i in range(len(xk)):
        thetak = 0.5 * dtheta * xk[i] + thetam
        r_theta = x / np.cos(thetak)
        R = np.sqrt(r_theta * r_theta + z * z)
        G += wk[i] * (R - abs_z) * 0.5 * dtheta
        dG += wk[i] * (z / np.maximum(R, 1e-300) - sign_z) * 0.5 * dtheta
    return G, dG


def _int_side(v1, v2, p):
    e = v2[:, :2] - v1[:, :2]
    elen = np.linalg.norm(e, axis=1)
    eu = e / np.maximum(elen, 1e-300)[:, None]
    x = eu[:, 0] * v1[:, 1] - eu[:, 1] * v1[:, 0]
    y1 = v1[:, 0] * eu[:, 0] + v1[:, 1] * eu[:, 1]
    y2 = v2[:, 0] * eu[:, 0] + v2[:, 1] * eu[:, 1]
    neg = x < 0
    x = np.abs(x)
    y1 = np.where(neg, -y1, y1)
    y2 = np.where(neg, -y2, y2)
    Ga, dGa = _line_int(p, x, np.zeros_like(y1), y1)
    Gb, dGb = _line_int(p, x, y2, np.zeros_like(y2))
    degenerate = (x < 1e-14) | (elen < 1e-300)
    return (np.where(degenerate, 0.0, Ga + Gb),
            np.where(degenerate, 0.0, dGa + dGb))


def semi_analytical_G(verts, x):
    """The integral of 1/|x - y| over each triangle ``verts[b]`` at the
    point ``x[b]``: ``[B]``."""
    y0, y1, y2 = verts[:, 0], verts[:, 1], verts[:, 2]
    X = y1 - y0
    Z = np.cross(y1 - y0, y2 - y0)
    X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-300)
    Z = Z / np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1e-300)
    Y = np.cross(Z, X)

    def to_plane(v):
        rel = v - y0
        return np.stack([(rel * X).sum(1), (rel * Y).sum(1),
                         (rel * Z).sum(1)], axis=1)

    xp = to_plane(x)
    shift = np.concatenate([xp[:, :2], np.zeros((len(x), 1))], axis=1)
    p0, p1, p2 = (to_plane(v) - shift for v in (y0, y1, y2))
    G = np.zeros(len(x))
    for a, b in ((p0, p1), (p1, p2), (p2, p0)):
        G += _int_side(a, b, xp[:, 2])[0]
    return G
