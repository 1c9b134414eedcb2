"""Panel fields: the array form of the reference's Panel struct
(kernel/LaplaceSphericalBEM.hpp:38-118).

A panel set is a dict of numpy arrays (the FmmPlan ``fields``):
  xyz      [N, 3]      panel centroids (the tree/bodies positions)
  normal   [N, 3]      unit normals (right-hand rule on v0,v1,v2)
  area     [N]
  vertices [N, 3, 3]   triangle vertices (host-side assembly only)
  qp_off   [N, K, 3]   quadrature points relative to the centroid
  qw       [N, K]      quadrature weights (barycentric weights, sum 1)
  bc       [N]         boundary-condition flag: 0 = POTENTIAL,
                       1 = NORMAL_DERIV (ref Panel::BC)
"""

from __future__ import annotations

import numpy as np

from fmm_bem_tpu_torch.bem.quadrature import get_rule

#: BC flag values (ref Panel::BoundaryType)
POTENTIAL = 0
NORMAL_DERIV = 1


def make_panels(tris, K=3, bc=POTENTIAL):
    """Build panel fields from a [N, 3, 3] triangulation.

    Mirrors the reference Panel constructor (LaplaceSphericalBEM.hpp:
    64-96): centroid, cross-product normal/area, K quadrature points.
    """
    tris = np.asarray(tris, dtype=np.float64)
    n = len(tris)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    center = (v0 + v1 + v2) / 3.0
    # ref: L0 = v2-v0, L1 = v1-v0, c = cross(L0, L1)
    c = np.cross(v2 - v0, v1 - v0)
    area = 0.5 * np.linalg.norm(c, axis=1)
    normal = c / (2.0 * area[:, None])

    pts, wts = get_rule(K)
    # quad point = sum_j lambda_j * vertex_j
    qp = np.einsum("kj,njd->nkd", pts, tris)
    return {
        "xyz": center,
        "normal": normal,
        "area": area,
        "vertices": tris,
        "qp_off": qp - center[:, None, :],
        "qw": np.broadcast_to(wts, (n, len(wts))).copy(),
        "bc": np.full(n, float(bc)),
    }


def switch_bc(fields):
    """Flip every panel's BC flag (ref Panel::switch_BC) — used to
    evaluate the RHS operator without rebuilding anything."""
    out = dict(fields)
    out["bc"] = 1.0 - np.asarray(fields["bc"])
    return out


def total_area(fields):
    return float(np.sum(fields["area"]))
