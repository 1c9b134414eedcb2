"""The plain reference of the Yukawa (screened-Laplace) BEM
configurations.

Rows of the two discrete boundary operators of a surface of flat
triangles for the kernel ``e^{-kappa r} / r``, collocated at the
centroids (after the reference's YukawaCartesianBEM.hpp and the YUKAWA
branch of SemiAnalytical.hpp), computed densely in float64 with TF32
off:

- ``G[i, j]``, the single layer: the integral of
  ``e^{-kappa r} / r``, ``r = |c_i - y|``, over panel j by its K-point
  rule; where ``sqrt(2 A_j) / |c_i - c_j| >= 0.5`` (near), the Laplace
  part ``1 / r`` semi-analytically (``panel_integrals``) plus the
  bounded remainder ``(e^{-kappa r} - 1) / r`` by the fine rule;
- ``dG[i, j]``, the double layer: the integral of
  ``(kappa r + 1) e^{-kappa r} (y - c_i) . n_j / r^3`` by the K-point
  rule, by the fine rule where the same test holds, and ``-2 pi`` on
  the diagonal (the source's Yukawa self-term, SemiAnalytical.hpp).

The sign of the double layer is the Laplace reference's: at kappa = 0
every entry off the diagonal is ``laplace_bem.py``'s, and the diagonal
is ``-2 pi`` here against ``+2 pi`` there.

Departures from the source, each independent of the program's own
near-field method: the source integrates the screened single layer
semi-analytically, as three edge line integrals of
``e^{-kappa R}`` in panel-local polar coordinates; here only its
Laplace part is, and the smooth remainder, which is ``-kappa`` at
``r = 0`` and has no singularity, goes to the fine rule.  The far
entries, the near double layer and the self-terms follow the source.
``OPERATORS``, ``surface_rows``, ``SurfaceRows.apply`` and
``.residual`` are those of ``laplace_bem.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference import laplace_bem
from bench_h100.reference.laplace_bem import OPERATORS, panel_geometry
from bench_h100.reference.panel_integrals import rule, semi_analytical_G

__all__ = ["OPERATORS", "SurfaceRows", "surface_rows"]

#: the double layer's self-term of the screened equation
SELF_DG = -2.0 * np.pi


def surface_rows(config, tris, rows, device):
    """``SurfaceRows`` with the panel rules and the screening of a
    configuration's kernel arguments (``K``, ``fine_K``, ``kappa``)."""
    args = config["kernel"]["args"]
    return SurfaceRows(tris, rows, device, K=args["K"],
                       fine_K=args.get("fine_K", 17), kappa=args["kappa"])


def _screened_remainder(r, kappa):
    """``(e^{-kappa r} - 1) / r``, with its limit ``-kappa`` at 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(r > 0, np.expm1(-kappa * r) / r, -kappa)


class SurfaceRows(laplace_bem.SurfaceRows):
    """Rows ``rows`` of the screened ``G`` and ``dG`` on ``device`` in
    float64."""

    def __init__(self, tris, rows, device, K=3, fine_K=17, kappa=0.125,
                 chunk=128):
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
                e = torch.exp(-kappa * r)
                g += wa[None, :, k] * e / r
                dg += (wa[None, :, k] * (kappa * r + 1.0) * e
                       * (d * nrm[None]).sum(-1) / (r2 * r))
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
        fpts, fw = rule(fine_K)
        fqp = np.einsum("kj,njd->nkd", fpts, tris[j])
        d = fqp - t[:, None, :]
        r2 = (d * d).sum(-1)
        r = np.sqrt(r2)
        g_near = semi_analytical_G(tris[j], t) + (
            (fw[None, :] * _screened_remainder(r, kappa)).sum(1) * area[j])
        dn = (d * normals[j][:, None, :]).sum(-1)
        same = np.linalg.norm(t - centers[j], axis=1) < 1e-8
        # the fine rule holds the centroid: a self row divides by 0 and
        # is replaced by the self-term
        with np.errstate(divide="ignore", invalid="ignore"):
            dg_near = ((fw[None, :] * (kappa * r + 1.0) * np.exp(-kappa * r)
                        * dn / (r2 * r)).sum(1) * area[j])
        dg_near = np.where(same, SELF_DG, dg_near)
        it = torch.as_tensor(i, device=device)
        jt = torch.as_tensor(j, device=device)
        self.G[it, jt] = torch.as_tensor(g_near, dtype=f64, device=device)
        self.dG[it, jt] = torch.as_tensor(dg_near, dtype=f64, device=device)
        self.near_entries = len(i)
