"""The plain reference of the Laplace BEM configurations.

Rows of the two discrete boundary operators of a surface of flat
triangles, collocated at the centroids (after the reference's
LaplaceSphericalBEM.hpp and SemiAnalytical.hpp), computed densely in
float64:

- ``G[i, j]``, the single layer: the integral of ``1/|c_i - y|`` over
  panel j by its K-point rule, or semi-analytically where
  ``sqrt(2 A_j) / |c_i - c_j| >= 0.5``;
- ``dG[i, j]``, the double layer: the integral of
  ``(y - c_i) . n_j / |y - c_i|^3`` by the K-point rule, by the fine
  rule where the same test holds, and ``2 pi`` on the diagonal.

A panel whose data is a potential (the first kind) is a row of ``G``
against the unknown normal derivatives and of ``dG`` against the data;
the second kind swaps the two.  The check of a solve is the relative
residual of the program's solution on the sampled rows:
``|S x - R d| / |R d|``, with ``S`` the system's rows and ``R`` the
right-hand side's.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference.panel_integrals import rule, semi_analytical_G

#: (system operator, right-hand-side operator) of each kind
OPERATORS = {"first_kind": ("G", "dG"), "second_kind": ("dG", "G")}


def panel_geometry(tris):
    """Centroids, unit normals and areas of flat triangles (float64)."""
    tris = np.asarray(tris, np.float64)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    c = np.cross(v2 - v0, v1 - v0)
    area = 0.5 * np.linalg.norm(c, axis=1)
    return (v0 + v1 + v2) / 3.0, c / (2.0 * area[:, None]), area


def surface_rows(config, tris, rows, device):
    """``SurfaceRows`` with the panel rules of a configuration's
    kernel arguments (``K``, ``fine_K``)."""
    args = config["kernel"]["args"]
    return SurfaceRows(tris, rows, device, K=args["K"],
                       fine_K=args.get("fine_K", 17))


class SurfaceRows:
    """Rows ``rows`` of ``G`` and ``dG`` on ``device`` in float64."""

    def __init__(self, tris, rows, device, K=3, fine_K=17, chunk=128):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        tris = np.asarray(tris, np.float64)
        centers, normals, area = panel_geometry(tris)
        rows = np.asarray(rows)
        f64 = torch.float64
        pts, wts = rule(K)
        qp = torch.as_tensor(np.einsum("kj,njd->nkd", pts, tris), dtype=f64,
                             device=device)
        wa = torch.as_tensor(wts[None, :] * area[:, None], dtype=f64,
                             device=device)
        nrm = torch.as_tensor(normals, dtype=f64, device=device)
        tgt = torch.as_tensor(centers[rows], dtype=f64, device=device)
        S, N = len(rows), len(tris)
        self.G = torch.empty((S, N), dtype=f64, device=device)
        self.dG = torch.empty((S, N), dtype=f64, device=device)
        for a in range(0, S, chunk):
            t = tgt[a:a + chunk]
            g = torch.zeros((len(t), N), dtype=f64, device=device)
            dg = torch.zeros_like(g)
            for k in range(qp.shape[1]):
                d = qp[None, :, k, :] - t[:, None, :]
                r2 = (d * d).sum(-1)
                r = r2.sqrt()
                g += wa[None, :, k] / r
                dg += wa[None, :, k] * (d * nrm[None]).sum(-1) / (r2 * r)
            self.G[a:a + chunk] = g
            self.dG[a:a + chunk] = dg
        # the near entries, on the host
        ctr = torch.as_tensor(centers, dtype=f64, device=device)
        lim = torch.as_tensor(np.sqrt(2.0 * area), dtype=f64, device=device)
        ii, jj = [], []
        for a in range(0, S, chunk):
            dist = torch.cdist(tgt[a:a + chunk], ctr)
            i, j = torch.nonzero(lim[None, :] >= 0.5 * dist, as_tuple=True)
            ii.append(i + a)
            jj.append(j)
        i = torch.cat(ii).cpu().numpy()
        j = torch.cat(jj).cpu().numpy()
        t = centers[rows[i]]
        g_near = semi_analytical_G(tris[j], t)
        fpts, fw = rule(fine_K)
        fqp = np.einsum("kj,njd->nkd", fpts, tris[j])
        d = fqp - t[:, None, :]
        r2 = (d * d).sum(-1)
        dn = (d * normals[j][:, None, :]).sum(-1)
        same = np.linalg.norm(t - centers[j], axis=1) < 1e-8
        # the fine rule holds the centroid: a self row divides by 0 and
        # is replaced by 2 pi
        with np.errstate(divide="ignore", invalid="ignore"):
            dg_near = ((fw[None, :] * dn / (r2 * np.sqrt(r2))).sum(1)
                       * area[j])
        dg_near = np.where(same, 2.0 * np.pi, dg_near)
        it = torch.as_tensor(i, device=device)
        jt = torch.as_tensor(j, device=device)
        self.G[it, jt] = torch.as_tensor(g_near, dtype=f64, device=device)
        self.dG[it, jt] = torch.as_tensor(dg_near, dtype=f64, device=device)
        self.near_entries = len(i)

    def apply(self, which, x):
        """``rows`` of ``G @ x`` (``which="G"``) or ``dG @ x``."""
        A = self.G if which == "G" else self.dG
        return A @ torch.as_tensor(np.asarray(x), dtype=A.dtype,
                                   device=A.device)

    def residual(self, kind, x, data):
        """The relative residual of the solution ``x`` of the ``kind``
        system with boundary data ``data``, on the rows."""
        sys_op, rhs_op = OPERATORS[kind]
        rhs = self.apply(rhs_op, data)
        r = self.apply(sys_op, x) - rhs
        return float(r.norm() / rhs.norm())
