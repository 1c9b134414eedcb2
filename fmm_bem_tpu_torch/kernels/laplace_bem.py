"""Laplace BEM panel kernel.

Counterpart of kernel/LaplaceSphericalBEM.hpp: the expansion carries two
components per box — a single-layer (G) part built from panel
quadrature monopoles and a double-layer (dGdn) part built from
quadrature dipoles (ref P2M :307-352) — and every evaluation selects
G vs -dGdn by the panel's boundary-condition flag (ref operator()
:273-297, M2P/L2P :394-476).  The BC flag is a runtime *tensor*, so the
same matvec produces both the system operator and the RHS operator (the
reference rebuilds a whole plan after switch_BC, LaplaceBEM.cpp:218-232).

Near-field entries (singular/near-singular panel integrals) are
precomputed on the host into sparse value pairs (G, dGdn) — see
fmm_bem_tpu_torch.bem.integrals — exactly as the reference's
EvalInteractionLazySparse caches its CSR matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from fmm_bem_tpu_torch.bem.integrals import near_entries_laplace
from fmm_bem_tpu_torch.kernels import harmonics as hm
from fmm_bem_tpu_torch.kernels.laplace import (
    eval_regular,
    eval_singular,
    im_part,
    re_part,
    to_interleaved_ri,
)


def _term_weights(p, like):
    return torch.as_tensor(
        hm.term_weights(p), dtype=like.dtype, device=like.device
    )


class LaplaceBEMKernel:
    """Single/double-layer Laplace panel kernel (ncomp = 2)."""

    name = "laplace_bem"
    ncomp = 2
    charge_dim = 1
    result_dim = 1
    near_sparse = True
    scale_invariant = True
    kappa = 0.0  # Yukawa subclassing hook for the shared block routine
    #: the on-the-fly near product runs as the leaf-tile kernel of
    #: ops/otf_tile.py (this class's ``near_block_device`` math)
    otf_tile = True

    def __init__(self, K=3, fine_K=17):
        self.K = K
        self.fine_K = fine_K

    # ----- expansion layout / host matrices: shared with the point kernel
    def width(self, p):
        return hm.real_width(p)

    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2m_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2l_matrix(dr, sigma_src, sigma_tgt, p)

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.l2l_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_pair_scale(self, sigma_src):
        return 1.0 / sigma_src

    # ----- device ops -----
    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        """Panel P2M: quadrature monopoles into component 0 (G) when the
        panel carries POTENTIAL data, quadrature dipoles into component 1
        (dGdn) when it carries NORMAL_DERIV data (ref
        LaplaceSphericalBEM.hpp:307-352)."""
        qp = fields["qp_off"] * inv_sigma[:, None, None] + d_norm[:, None, :]
        w = (fields["qw"] * fields["area"][:, None]) * charges[:, None]  # [N,K]

        nrm = fields["normal"][:, None, :].expand(qp.shape).contiguous()
        (yr, yi), (dyr, dyi) = torch.func.jvp(
            lambda z: eval_regular(z, p), (qp,), (nrm,)
        )
        # component 0: sum_k w_k conj(R(qp_k))  (conj = negate im plane)
        m0r = torch.sum(w[..., None] * yr, dim=1)
        m0i = -torch.sum(w[..., None] * yi, dim=1)
        # component 1: sum_k w_k (n . grad) conj(R), with the 1/sigma
        # chain-rule factor from normalised coordinates
        m1r = torch.sum(w[..., None] * dyr, dim=1) * inv_sigma[:, None]
        m1i = -torch.sum(w[..., None] * dyi, dim=1) * inv_sigma[:, None]

        sel0 = (1.0 - fields["bc"])[:, None]
        sel1 = fields["bc"][:, None]
        return torch.stack(
            [
                to_interleaved_ri(m0r * sel0, m0i * sel0),
                to_interleaved_ri(m1r * sel1, m1i * sel1),
            ],
            dim=1,
        )  # [N, 2(comp), W]

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        """Evaluate at panel centers: +r0 for POTENTIAL targets, -r1 for
        NORMAL_DERIV targets (ref L2P :448-476)."""
        del inv_sigma
        re, im = eval_regular(d_norm, p)
        w = _term_weights(p, L)
        r0 = torch.sum(w * (re_part(L[:, 0]) * re - im_part(L[:, 0]) * im), dim=-1)
        r1 = torch.sum(w * (re_part(L[:, 1]) * re - im_part(L[:, 1]) * im), dim=-1)
        bc = fields["bc"]
        return torch.where(bc == 0.0, r0, -r1)[:, None]

    def l2p_table(self, fields, d_norm, inv_sigma, p):
        """Precomputed linear L2P map: res[n] = sum_cw L[n,c,w] T[n,c,w]
        (charge-independent — evaluated once per BC variant so the
        harmonic recurrences never re-run inside solver loops)."""
        del inv_sigma
        re, im = eval_regular(d_norm, p)
        w = _term_weights(p, re)
        base = to_interleaved_ri(w * re, -(w * im))  # [n, W]
        bc = fields["bc"][:, None]
        zero = torch.zeros_like(base)
        t0 = torch.where(bc == 0.0, base, zero)
        t1 = torch.where(bc == 0.0, zero, -base)
        return torch.stack([t0, t1], dim=1)[..., None]  # [n, 2, W, 1]

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        """Treecode/skew far-field evaluation (ref M2P :394-422)."""
        re, im = eval_singular(d_norm, p)
        w = _term_weights(p, M)
        r0 = torch.sum(w * (re_part(M[:, 0]) * re - im_part(M[:, 0]) * im), dim=-1)
        r1 = torch.sum(w * (re_part(M[:, 1]) * re - im_part(M[:, 1]) * im), dim=-1)
        bc = fields["bc"]
        return (inv_sigma * torch.where(bc == 0.0, r0, -r1))[:, None]

    # ----- near field -----
    def near_values(self, tgt_fields, src_fields, rows, cols):
        """Host assembly of (G, dGdn) entry pairs (ref eval_G/eval_dGdn
        with SA/fine/plain quadrature selection)."""
        G, dG = near_entries_laplace(
            tgt_fields, src_fields, rows, cols, fine_K=self.fine_K
        )
        return np.stack([G, dG], axis=1)

    def near_regular_entries(self, tgt_fields, src_fields, rows, cols):
        """Plain K-point quadrature (G, dGdn) at the given entries —
        the value ``near_block_device`` produces for them on the fly.
        Used by the on-the-fly near mode (FMMConfig.near_mode="otf") to
        turn the host corrections into DELTAS: the per-iteration device
        product recomputes the regular quadrature for every entry and
        a small cached store adds (corrected - regular) on top
        (ref EvalInteractionLazy.hpp:239-252, the memory-free near
        field this mode mirrors)."""
        t = np.asarray(tgt_fields["xyz"])[rows]
        c = np.asarray(src_fields["xyz"])[cols]
        qp = np.asarray(src_fields["qp_off"])[cols] + c[:, None, :]
        w = (
            np.asarray(src_fields["qw"])[cols]
            * np.asarray(src_fields["area"])[cols][:, None]
        )
        nrm = np.asarray(src_fields["normal"])[cols]
        d = t[:, None, :] - qp
        r2 = np.maximum((d * d).sum(-1), 1e-30)
        r = np.sqrt(r2)
        if self.kappa:
            scr = np.exp(-self.kappa * r)
            G = (w * scr / r).sum(-1)
            dn = -(d * nrm[:, None, :]).sum(-1)
            dG = (w * dn * (self.kappa * r + 1.0) * scr / (r2 * r)).sum(-1)
        else:
            G = (w / r).sum(-1)
            dn = -(d * nrm[:, None, :]).sum(-1)
            dG = (w * dn / (r2 * r)).sum(-1)
        return np.stack([G, dG], axis=1)

    def near_select(self, vals, bc_rows):
        """Host-side BC selection of near entries for the leaf-panel
        path (G for POTENTIAL rows, dGdn for NORMAL_DERIV rows)."""
        return np.where(np.asarray(bc_rows) == 0.0, vals[:, 0], vals[:, 1])

    def near_matvec(self, vals, rows, cols, fields, qm, n):
        """COO replay of the near field (``near_panel=False``): each
        entry's value selected by its target row's BC flag (ref
        operator() :273-297), summed into the rows -> [n, 1]."""
        bc_rows = fields["bc"][rows]
        v = torch.where(bc_rows == 0.0, vals[:, 0], vals[:, 1])
        out = torch.zeros(n, dtype=qm.dtype, device=qm.device)
        return out.index_add_(0, rows, v * qm[cols])[:, None]

    def near_block_device(self, tf_rows, sf_rows, tmask, smask):
        """Regular K-point quadrature interaction blocks of a batch of
        leaf pairs, evaluated on device (the smooth branch of ref
        eval_G/eval_dGdn, LaplaceSphericalBEM.hpp:195-203,241-263) —
        near-singular entries are overwritten by host corrections.

        Every argument carries a leading pair dimension: target rows
        ``[P, KT, ...]``, source rows ``[P, KS, ...]``, masks ``[P, KT]``
        / ``[P, KS]``; the result is ``[P, KT, KS]``."""
        t = tf_rows["xyz"]                                   # [P, KT, 3]
        qp = sf_rows["qp_off"] + sf_rows["xyz"][:, :, None, :]  # [P,KS,K,3]
        w = sf_rows["qw"] * sf_rows["area"][:, :, None]         # [P,KS,K]
        d = t[:, :, None, None, :] - qp[:, None, :, :, :]    # [P,KT,KS,K,3]
        r2 = torch.clamp_min(torch.sum(d * d, dim=-1), 1e-30)
        r = torch.sqrt(r2)
        nrm = sf_rows["normal"][:, None, :, None, :]
        if self.kappa:
            scr = torch.exp(-self.kappa * r)
            G = torch.sum(w[:, None] * scr / r, dim=-1)
            dn = torch.sum(-d * nrm, dim=-1)
            dG = torch.sum(
                w[:, None] * dn * (self.kappa * r + 1.0) * scr / (r2 * r),
                dim=-1,
            )
        else:
            G = torch.sum(w[:, None] / r, dim=-1)
            dn = torch.sum(-d * nrm, dim=-1)
            dG = torch.sum(w[:, None] * dn / (r2 * r), dim=-1)
        bc = tf_rows["bc"][:, :, None]
        blk = torch.where(bc == 0.0, G, dG)
        keep = tmask[:, :, None] & smask[:, None, :]
        return torch.where(keep, blk, torch.zeros_like(blk))

    # ----- dense oracle (ref Direct.hpp over panel kernels) -----
    def dense_matrix(self, fields):
        """Full dense operator matrix honoring each target's BC flag —
        O(N^2) host assembly for tests/small problems."""
        n = len(fields["xyz"])
        rows = np.repeat(np.arange(n, dtype=np.int64), n)
        cols = np.tile(np.arange(n, dtype=np.int64), n)
        G, dG = near_entries_laplace(
            fields, fields, rows, cols, fine_K=self.fine_K
        )
        bc = np.asarray(fields["bc"])[rows]
        vals = np.where(bc == 0.0, G, dG)
        return vals.reshape(n, n)

    def eval_exterior(self, fields, charges, targets, layer="G"):
        """Off-surface evaluation of the single ('G') or double ('dGdn')
        layer at arbitrary points (the example program's exterior-potential check,
        LaplaceBEM.cpp:352-371).  Host numpy, O(targets x panels)."""
        targets = np.asarray(targets, dtype=np.float64)
        nt = len(targets)
        ns = len(fields["xyz"])
        rows = np.repeat(np.arange(nt, dtype=np.int64), ns)
        cols = np.tile(np.arange(ns, dtype=np.int64), nt)
        G, dG = near_entries_laplace(
            {"xyz": targets}, fields, rows, cols, fine_K=self.fine_K
        )
        vals = G if layer == "G" else dG
        return (vals.reshape(nt, ns) @ np.asarray(charges)).reshape(nt)
