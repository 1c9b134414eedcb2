"""Triangle Gauss quadrature rules.

Counterpart of examples/BEM/GaussQuadrature.hpp: symmetric (Dunavant)
rules keyed by point count, in barycentric coordinates with weights
summing to 1 (multiply by the panel area to integrate).

Differences from the reference:
- K=7 maps to the *true* degree-5 seven-point rule (the reference
  aliases K=7 to its 4-point data, GaussQuadrature.hpp:58-59 — a latent
  bug flagged in SURVEY.md).
- Arbitrary K >= 30 beyond the tabulated set are served by a
  collapsed-square (Duffy) Gauss-Legendre product rule.
- a 1-D 5-point Gauss-Legendre rule is exposed for the semi-analytical
  edge integrals (ref GaussQuadrature.hpp:14-16 / SemiAnalytical 5-pt).
"""

from __future__ import annotations

import functools

import numpy as np


def _sym(groups):
    """Expand (weight, generator) groups into point/weight arrays.

    Generators: 1 value  -> centroid; 2 values (a, b) with a + 2b = 1 ->
    3 permutations; 3 distinct values -> 6 permutations.
    """
    pts, wts = [], []
    for w, gen in groups:
        if len(gen) == 1:
            pts.append((gen[0],) * 3)
            wts.append(w)
        elif len(gen) == 2:
            a, b = gen
            for perm in ((a, b, b), (b, a, b), (b, b, a)):
                pts.append(perm)
                wts.append(w)
        else:
            a, b, c = gen
            for perm in (
                (a, b, c),
                (a, c, b),
                (b, a, c),
                (b, c, a),
                (c, a, b),
                (c, b, a),
            ):
                pts.append(perm)
                wts.append(w)
    return np.asarray(pts, dtype=np.float64), np.asarray(wts, dtype=np.float64)


# Dunavant symmetric rules (publicly tabulated constants), by point count.
_RULES = {
    1: [(1.0, (1 / 3,))],
    # midpoint rule (degree 2) — matches the reference's 3-point table
    3: [(1 / 3, (0.0, 0.5))],
    4: [(-27 / 48, (1 / 3,)), (25 / 48, (0.6, 0.2))],
    7: [
        (0.225, (1 / 3,)),
        (0.125939180544827, (0.797426985353087, 0.101286507323456)),
        (0.132394152788506, (0.059715871789770, 0.470142064105115)),
    ],
    13: [
        (-0.149570044467670, (1 / 3,)),
        (0.175615257433204, (0.479308067841923, 0.260345966079038)),
        (0.053347235608839, (0.869739794195568, 0.065130102902216)),
        (0.077113760890257, (0.638444188569809, 0.312865496004875, 0.048690315425316)),
    ],
    # degree-8 16-point rule; the reference labels it "17"
    16: [
        (0.144315607677787, (1 / 3,)),
        (0.095091634267285, (0.081414823414554, 0.459292588292723)),
        (0.103217370534718, (0.658861384496480, 0.170569307751760)),
        (0.032458497623198, (0.898905543365938, 0.050547228317031)),
        (0.027230314174435, (0.008394777409958, 0.263112829634638, 0.728492392955404)),
    ],
    19: [
        (0.097135796282799, (1 / 3,)),
        (0.031334700227139, (0.020634961602525, 0.489682519198738)),
        (0.077827541004774, (0.125820817014127, 0.437089591492937)),
        (0.079647738927210, (0.623592928761935, 0.188203535619033)),
        (0.025577675658698, (0.910540973211095, 0.044729513394453)),
        (0.043283539377289, (0.036838412054736, 0.221962989160766, 0.741198598784498)),
    ],
    25: [
        (0.090817990382754, (1 / 3,)),
        (0.036725957756467, (0.028844733232685, 0.485577633383657)),
        (0.045321059435528, (0.781036849029926, 0.109481575485037)),
        (0.072757916845420, (0.141707219414880, 0.307939838764121, 0.550352941820999)),
        (0.028327242531057, (0.025003534762686, 0.246672560639903, 0.728323904597411)),
        (0.009421666963733, (0.009540815400299, 0.066803251012200, 0.923655933587500)),
    ],
    # Dunavant degree-13 79-point rule (1 + 10x3 + 8x6); the
    # reference's finest table (GaussQuadrature.hpp:188-272).  Some
    # weights/abscissae are negative/outside [0,1] — characteristic of
    # the published rule, not typos.
    79: [
        (0.033057055541624, (1 / 3,)),
        (0.000867019185663, (-0.001900928704400, 0.500950464352200)),
        (0.011660052716448, (0.023574084130543, 0.488212957934729)),
        (0.022876936356421, (0.089726636099435, 0.455136681950283)),
        (0.030448982673938, (0.196007481363421, 0.401996259318289)),
        (0.030624891725355, (0.488214180481157, 0.255892909759421)),
        (0.024368057676800, (0.647023488009788, 0.176488255995106)),
        (0.015997432032024, (0.791658289326483, 0.104170855336758)),
        (0.007698301815602, (0.893862072318140, 0.053068963840930)),
        (-0.000632060497488, (0.916762569607942, 0.041618715196029)),
        (0.001751134301193, (0.976836157186356, 0.011581921406822)),
        (0.016465839189576, (0.048741583664839, 0.344855770229001, 0.606402646106160)),
        (0.004839033540485, (0.006314115948605, 0.377843269594854, 0.615842614456541)),
        (0.025804906534650, (0.134316520547348, 0.306635479062357, 0.559048000390295)),
        (0.008471091054441, (0.013973893962392, 0.249419362774742, 0.736606743262866)),
        (0.018354914106280, (0.075549132909764, 0.212775724802802, 0.711675142287434)),
        (0.000704404677908, (-0.008368153208227, 0.146965436053239, 0.861402717154987)),
        (0.010112684927462, (0.026686063258714, 0.137726978828923, 0.835586957912363)),
        (0.003573909385950, (0.010547719294141, 0.059696109149007, 0.929756171556853)),
    ],
}


def duffy_rule(n):
    """n^2-point collapsed-square Gauss-Legendre rule on the unit
    triangle, returned in barycentric coordinates (weights sum to 1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    u = 0.5 * (x + 1.0)
    wu = 0.5 * w
    U, V = np.meshgrid(u, u, indexing="ij")
    WU, WV = np.meshgrid(wu, wu, indexing="ij")
    # map square -> triangle: (x, y) = (u, v(1-u)), |J| = (1-u)
    xs = U.ravel()
    ys = (V * (1.0 - U)).ravel()
    wts = (WU * WV * (1.0 - U)).ravel()
    lam1 = 1.0 - xs - ys
    pts = np.stack([lam1, xs, ys], axis=1)
    return pts, wts * 2.0  # unit right triangle has area 1/2 -> normalise


@functools.lru_cache(maxsize=None)
def get_rule(K: int):
    """(points [K', 3] barycentric, weights [K'] summing to 1).

    Supported K: {1, 3, 4, 7, 13, 16, 17, 19, 25, 79} mirroring the
    reference's set.  K=17 -> the degree-8 16-point Dunavant rule: the
    reference's "17-point" table (GaussQuadrature.hpp:86-112) actually
    lists 1+3+3+3+6 = 16 points, so this mapping is exact, not a
    substitute.  K=79 -> the true Dunavant degree-13 79-point table.
    Other K >= 30 fall back to the nearest Duffy product rule.
    """
    if K == 17:
        K = 16
    if K in _RULES:
        return _sym(_RULES[K])
    if K >= 30:
        n = max(3, int(round(np.sqrt(K))))
        return duffy_rule(n)
    raise ValueError(
        f"unsupported quadrature size K={K}; available: 1,3,4,7,13,16,17,19,25,>=30"
    )


# 1-D Gauss-Legendre 5-point rule on [-1, 1] for edge line integrals
GAUSS_1D_5 = np.polynomial.legendre.leggauss(5)
