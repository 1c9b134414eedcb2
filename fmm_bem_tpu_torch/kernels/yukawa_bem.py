"""Yukawa BEM panel kernel (screened-Laplace boundary integrals).

Counterpart of kernel/YukawaCartesianBEM.hpp: a two-component
Cartesian-Taylor expansion per box — component 0 from quadrature
monopoles of int G, component 1 from quadrature dipoles of int dG/dn
(ref P2M :240-297) — selected at evaluation by the panel BC exactly like
the Laplace BEM kernel (ref operator() :213-230).  Near-field entries
reuse the semi-analytical/fine/plain quadrature assembly of
fmm_bem_tpu_torch.bem.integrals with kappa > 0 (ref eval_G/eval_dGdn
:145-204 and SemiAnalytical's YUKAWA branch).

The kernel has no ``near_regular_entries`` and no ``otf_tile`` marker,
so ``near_mode="otf"`` builds the cached near store for it, as the JAX
package does; its regular-quadrature blocks come from the Laplace BEM
kernel's ``near_block_device`` with the screening factors switched on by
``kappa``.
"""

from __future__ import annotations

import numpy as np
import torch

from fmm_bem_tpu_torch.bem.integrals import near_entries_laplace
from fmm_bem_tpu_torch.kernels import cartesian as ct
from fmm_bem_tpu_torch.kernels.cartesian import YukawaKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel


class YukawaBEMKernel(YukawaKernel):
    """Single/double-layer Yukawa panel kernel (ncomp = 2, scalar)."""

    name = "yukawa_bem"
    ncomp = 2
    charge_dim = 1
    result_dim = 1
    near_sparse = True
    #: the M2P evaluation runs as the leaf-tile kernel it names,
    #: ops/m2p_cart_tile.py (this class's ``m2p`` math)
    m2p_tile = "m2p_cart_tile"
    #: the L2P evaluation runs as the leaf-tile kernel it names,
    #: ops/l2p_cart_tile.py (this class's ``l2p`` math)
    l2p_tile = "l2p_cart_tile"

    def __init__(self, K=3, fine_K=17, kappa=0.125):
        super().__init__(kappa=kappa)
        self.K = K
        self.fine_K = fine_K

    # ----- device ops -----
    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        qd = fields["qp_off"] * inv_sigma[:, None, None] + d_norm[:, None, :]
        w = (fields["qw"] * fields["area"][:, None]) * charges[:, None]  # [N,K]
        nrm = fields["normal"][:, None, :].expand(qd.shape).contiguous()

        pw, dpw = torch.func.jvp(lambda z: ct.powers(-z, p), (qd,), (nrm,))
        m0 = torch.sum(w[..., None] * pw, dim=1)
        # dipole moments: (n . grad_x) of the monomial moments; the
        # jvp direction n with the -z argument carries the sign
        m1 = torch.sum(w[..., None] * dpw, dim=1) * inv_sigma[:, None]

        bc = fields["bc"]
        m0 = m0 * (1.0 - bc)[:, None]
        m1 = m1 * bc[:, None]
        return torch.stack([m0, m1], dim=1)  # [N, 2, T]

    def _eval_pair(self, fields, r0, r1):
        bc = fields["bc"]
        return torch.where(bc == 0.0, r0, -r1)[:, None]

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        del inv_sigma
        pw = ct.powers(d_norm, p)
        r0 = torch.sum(L[:, 0, :] * pw, dim=-1)
        r1 = torch.sum(L[:, 1, :] * pw, dim=-1)
        return self._eval_pair(fields, r0, r1)

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        w = ct.taylor_weights(d_norm, inv_sigma, self.kappa, p, M)
        r0 = torch.sum(w * M[:, 0], dim=-1)
        r1 = torch.sum(w * M[:, 1], dim=-1)
        return self._eval_pair(fields, r0, r1)

    # ----- near field -----
    def near_values(self, tgt_fields, src_fields, rows, cols):
        G, dG = near_entries_laplace(
            tgt_fields, src_fields, rows, cols,
            fine_K=self.fine_K, kappa=self.kappa,
        )
        return np.stack([G, dG], axis=1)

    def near_select(self, vals, bc_rows):
        """Host-side BC selection for the leaf-panel near field."""
        return np.where(np.asarray(bc_rows) == 0.0, vals[:, 0], vals[:, 1])

    #: device regular-quadrature block builder shared with Laplace BEM
    #: (the kappa attribute switches on the screening factors)
    near_block_device = LaplaceBEMKernel.near_block_device
    #: the COO replay's BC-selected product, shared with Laplace BEM
    near_matvec = LaplaceBEMKernel.near_matvec

    # ----- dense oracle -----
    def dense_matrix(self, fields):
        n = len(fields["xyz"])
        rows = np.repeat(np.arange(n, dtype=np.int64), n)
        cols = np.tile(np.arange(n, dtype=np.int64), n)
        G, dG = near_entries_laplace(
            fields, fields, rows, cols, fine_K=self.fine_K, kappa=self.kappa
        )
        bc = np.asarray(fields["bc"])[rows]
        vals = np.where(bc == 0.0, G, dG)
        return vals.reshape(n, n)
