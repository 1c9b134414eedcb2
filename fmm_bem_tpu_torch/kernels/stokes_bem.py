"""Stokes BEM panel kernel: single-layer (stokeslet) and double-layer
(stresslet) velocity integrals over triangular panels.

Counterpart of kernel/StokesSphericalBEM.hpp: the expansion carries TWO
4-component Tornberg-Greengard sets per box (ncomp = 8) — components
0-3 from VELOCITY panels (stokeslet quadrature monopoles, ref P2M
:416-431) and components 4-7 from TRACTION panels (stresslet quadrature
dipoles, ref :433-466).  Far-field evaluation picks the set and scale
by the target's BC: velocity targets read set 0 scaled by 1/(2 mu),
traction targets read set 1 scaled by -0.5 = -3 * (1/6): the set
evaluates to six times the stresslet integral (the 1/6 of the point
stresslet, kernels/stokes.py), and the near-field blocks carry the
factor -3 (ref M2P/L2P :478-529).  The JAX package scales by +0.5, which
gives its far field the opposite sign of its own near field; the
double-layer identity on a sphere (the integral of a uniform velocity
is 4 pi u) holds with -0.5 and fails with +0.5 as soon as the tree has
a far field.

Near-field entries are 3x3 blocks assembled on the host:
  velocity  (ref eval_velocity_integral :261-375):
      self -> singular single-layer integral, closed form
              (bem/analytical.py, the Fata role) / (2 mu)
      near -> K_fine-point quadrature of (r^2 I + dx dx)/r^3 / (2 mu)
      far  -> K-point quadrature of the same
  traction  (ref eval_traction_integral :160-258):
      self -> 2 pi I
      near/far -> -3 * quadrature of (dx.n) dx dx / r^5

There is no ``near_block_device`` and no ``l2p_table``: the plan takes
the host assembly of the near store and this kernel's own ``l2p``.
"""

from __future__ import annotations

import numpy as np
import torch

from fmm_bem_tpu_torch.bem.quadrature import duffy_rule, get_rule
from fmm_bem_tpu_torch.kernels import harmonics as hm
from fmm_bem_tpu_torch.kernels.laplace import eval_regular, to_interleaved_ri
from fmm_bem_tpu_torch.kernels.stokes import tornberg_velocity_sets

#: BC flag values (ref StokesSphericalBEM Panel::BC)
VELOCITY = 0
TRACTION = 1

#: entries per pass of ``stokes_near_entries``: the quadrature keeps
#: [chunk, K, 3, 3] blocks of both kinds alive, so a whole mesh's near
#: entries at once would take many gigabytes
ENTRY_CHUNK = 1 << 20


def _stokeslet_block(dx, r2, eps2=1e-8):
    """(r^2 I + dx dx)/r^3 for a batch of offsets dx [..., 3]."""
    inv_r2 = np.where(r2 < eps2, 0.0, 1.0 / np.maximum(r2, 1e-100))
    inv_r3 = inv_r2 * np.sqrt(inv_r2)
    eye = np.eye(3)
    return inv_r3[..., None, None] * (
        r2[..., None, None] * eye + dx[..., :, None] * dx[..., None, :]
    )


def _stresslet_block(dx, r2, normal, eps2=1e-8):
    """(dx.n) dx dx / r^5 for offsets dx [..., 3], per-source normal."""
    inv_r2 = np.where(r2 < eps2, 0.0, 1.0 / np.maximum(r2, 1e-100))
    inv_r5 = inv_r2 * inv_r2 * np.sqrt(inv_r2)
    dxdotn = (dx * normal).sum(-1)
    return (inv_r5 * dxdotn)[..., None, None] * (
        dx[..., :, None] * dx[..., None, :]
    )


def _self_velocity_integral(verts, x, n_duffy=24):
    """Split-Duffy quadrature of the singular single-layer integral
    (numerical fallback / cross-check for the closed form): split at x
    into 3 sub-triangles, Duffy-collapse the singular vertex."""
    pts, wts = duffy_rule(n_duffy)
    out = np.zeros((len(x), 3, 3))
    v = [verts[:, 0], verts[:, 1], verts[:, 2]]
    for a, b in ((0, 1), (1, 2), (2, 0)):
        sub = np.stack([x, v[a], v[b]], axis=1)  # [B, 3, 3]
        qp = np.einsum("kj,bjd->bkd", pts, sub)
        area = 0.5 * np.linalg.norm(
            np.cross(sub[:, 2] - sub[:, 0], sub[:, 1] - sub[:, 0]), axis=1
        )
        dx = x[:, None, :] - qp
        r2 = np.maximum((dx * dx).sum(-1), 1e-100)
        inv_r3 = 1.0 / (r2 * np.sqrt(r2))
        eye = np.eye(3)
        blocks = inv_r3[..., None, None] * (
            r2[..., None, None] * eye + dx[..., :, None] * dx[..., None, :]
        )
        out += area[:, None, None] * np.einsum("k,bkij->bij", wts, blocks)
    return out


def stokes_near_entries(tgt_fields, src_fields, t_idx, s_idx, mu,
                        fine_K=19, analytical=True, chunk=None):
    """(velocity_block, traction_block) 3x3 entries per (target, source)
    pair, following the reference's near/far selection.

    Near-singular NON-self entries use the general off-plane closed
    forms (bem/analytical.py stokes_single_layer/stresslet_layer — the
    full Fata surface, FataAnalytical.hpp:236-420) instead of the
    reference's K_fine quadrature: exact where fine quadrature is at
    its worst (target a fraction of a panel size away).  Pass
    ``analytical=False`` for the reference's fine-K behaviour
    (convergence cross-checks).

    The entries are walked ``chunk`` at a time (default ENTRY_CHUNK):
    every value belongs to its own entry, so the result does not depend
    on the chunk."""
    t_idx = np.asarray(t_idx)
    s_idx = np.asarray(s_idx)
    chunk = int(chunk or ENTRY_CHUNK)
    vel = np.zeros((len(t_idx), 3, 3))
    trac = np.zeros((len(t_idx), 3, 3))
    for e0 in range(0, len(t_idx), chunk):
        sl = slice(e0, e0 + chunk)
        vel[sl], trac[sl] = _near_entries_chunk(
            tgt_fields, src_fields, t_idx[sl], s_idx[sl], mu, fine_K,
            analytical,
        )
    return vel, trac


def _near_entries_chunk(tgt_fields, src_fields, t_idx, s_idx, mu, fine_K,
                        analytical):
    centers = np.asarray(src_fields["xyz"])
    verts = np.asarray(src_fields["vertices"])
    area = np.asarray(src_fields["area"])
    normal = np.asarray(src_fields["normal"])
    qw = np.asarray(src_fields["qw"])

    t = np.asarray(tgt_fields["xyz"])[t_idx]
    sv = verts[s_idx]
    sa = area[s_idx]
    sn = normal[s_idx]

    dist = np.linalg.norm(t - centers[s_idx], axis=1)
    self_ = dist < 1e-8
    near = (np.sqrt(2.0 * sa) / np.maximum(dist, 1e-300) >= 0.5) & ~self_

    def quad_blocks(sel, K_pts, K_wts, kind):
        qpts = np.einsum("kj,njd->nkd", K_pts, sv[sel])
        w = K_wts[None, :] * sa[sel][:, None]
        dx = t[sel][:, None, :] - qpts
        r2 = (dx * dx).sum(-1)
        if kind == "vel":
            blocks = _stokeslet_block(dx, r2)
        else:
            blocks = _stresslet_block(dx, r2, sn[sel][:, None, :])
        return np.einsum("nk,nkij->nij", w, blocks)

    nK = qw.shape[1]
    Kp, Kw = get_rule(nK)
    Fp, Fw = get_rule(fine_K)

    vel = np.zeros((len(t_idx), 3, 3))
    trac = np.zeros((len(t_idx), 3, 3))

    far = ~near & ~self_
    if far.any():
        vel[far] = quad_blocks(far, Kp, Kw, "vel")
        trac[far] = quad_blocks(far, Kp, Kw, "trac")
    if near.any():
        if analytical:
            from fmm_bem_tpu_torch.bem.analytical import (
                stokes_single_layer,
                stokes_stresslet_layer,
            )

            vel[near] = stokes_single_layer(sv[near], t[near])
            # the closed form derives its normal from the vertex
            # winding; align with the stored panel normal
            e1 = sv[near][:, 1] - sv[near][:, 0]
            e2 = sv[near][:, 2] - sv[near][:, 0]
            wn = np.cross(e1, e2)
            sgn = np.sign(np.einsum("bi,bi->b", wn, sn[near]))
            trac[near] = (
                sgn[:, None, None]
                * stokes_stresslet_layer(sv[near], t[near])
            )
        else:
            vel[near] = quad_blocks(near, Fp, Fw, "vel")
            trac[near] = quad_blocks(near, Fp, Fw, "trac")
    if self_.any():
        # closed-form Fata-role integral (exact for the flat panel;
        # ref StokesSphericalBEM.hpp:279-293 / FataAnalytical.hpp)
        from fmm_bem_tpu_torch.bem.analytical import stokes_single_layer_self

        vel[self_] = stokes_single_layer_self(sv[self_], t[self_])
        trac[self_] = 2.0 * np.pi * np.eye(3)

    vel = vel / (2.0 * mu)
    trac = trac * -3.0
    trac[self_] = 2.0 * np.pi * np.eye(3)  # self overrides the -3 scale
    return vel, trac


class StokesBEMKernel:
    """Stokes BEM panel kernel (ncomp = 8, 3-vector charges/results)."""

    name = "stokes_bem"
    ncomp = 8
    charge_dim = 3
    result_dim = 3
    near_sparse = True

    def __init__(self, K=4, fine_K=19, mu=1e-3):
        self.K = K
        self.fine_K = fine_K
        self.mu = mu

    scale_invariant = True
    #: far-field scale of the stresslet set at traction targets (see the
    #: module docstring; the JAX package has +0.5 here)
    traction_far_scale = -0.5

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
        """Quadrature-point stokeslets (VELOCITY panels, comps 0-3) and
        stresslets (TRACTION panels, comps 4-7); ref P2M :391-470."""
        qp_n = fields["qp_off"] * inv_sigma[:, None, None] + d_norm[:, None, :]
        qp_g = fields["qp_off"] + fields["xyz"][:, None, :]  # global coords
        w = fields["qw"] * fields["area"][:, None]  # [N, K]
        f = charges[:, None, :] * w[:, :, None]  # [N, K, 3] area*gw*q
        nv = fields["normal"][:, None, :].expand(qp_n.shape).contiguous()

        (yr, yi), (dnr, dni) = torch.func.jvp(
            lambda z: eval_regular(z, p), (qp_n,), (nv,)
        )

        # stokeslet set (comps 0-3); conj(R) = (yr, -yi)
        fdotx = torch.sum(f * qp_g, dim=-1)  # [N, K]
        st = torch.stack([f[..., 0], f[..., 1], f[..., 2], fdotx], dim=2)
        mvr = torch.sum(st[..., None] * yr[:, :, None, :], dim=1)  # [N,4,T]
        mvi = -torch.sum(st[..., None] * yi[:, :, None, :], dim=1)

        # stresslet set (comps 4-7): rdotn = (grad conj R).n_hat,
        # rdotg = (grad conj R).g2 with g2 = area*gw*q (ref :447-466)
        qb = charges[:, None, :].expand(qp_n.shape).contiguous()
        _, (dqr, dqi) = torch.func.jvp(
            lambda z: eval_regular(z, p), (qp_n,), (qb,)
        )
        rnr = dnr * inv_sigma[:, None, None]
        rni = -dni * inv_sigma[:, None, None]
        wg = (w * inv_sigma[:, None])[..., None]
        rgr = dqr * wg
        rgi = -dqi * wg
        xdotg = torch.sum(qp_g * f, dim=-1)[..., None]  # [N, K, 1]
        ndotx = torch.sum(
            fields["normal"][:, None, :] * qp_g, dim=-1
        )[..., None]

        def stress(i):
            a = f[..., i : i + 1]
            b = nv[..., i : i + 1]
            return (
                torch.sum(rnr * a + rgr * b, dim=1),
                torch.sum(rni * a + rgi * b, dim=1),
            )

        s4r, s4i = stress(0)
        s5r, s5i = stress(1)
        s6r, s6i = stress(2)
        s7r = torch.sum(rnr * xdotg + rgr * ndotx, dim=1)
        s7i = torch.sum(rni * xdotg + rgi * ndotx, dim=1)

        mr = torch.stack(
            [mvr[:, 0], mvr[:, 1], mvr[:, 2], mvr[:, 3], s4r, s5r, s6r, s7r],
            dim=1,
        )
        mi = torch.stack(
            [mvi[:, 0], mvi[:, 1], mvi[:, 2], mvi[:, 3], s4i, s5i, s6i, s7i],
            dim=1,
        )

        bc = fields["bc"]
        sel = torch.cat(
            [(1.0 - bc)[:, None].expand(-1, 4), bc[:, None].expand(-1, 4)],
            dim=1,
        )[..., None]
        return to_interleaved_ri(mr * sel, mi * sel)

    def _eval_set(self, fields, E, d_norm, inv_sigma, p, singular):
        """Target-BC-selected Tornberg evaluation of the two sets."""
        u = tornberg_velocity_sets(
            E.reshape(E.shape[0], 2, 4, E.shape[-1]), d_norm, inv_sigma,
            fields["xyz"], p, singular,
        )
        scale_vel = 1.0 / (2.0 * self.mu)
        return torch.where(
            (fields["bc"] == VELOCITY)[:, None],
            scale_vel * u[:, 0], self.traction_far_scale * u[:, 1],
        )

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        return self._eval_set(fields, L, d_norm, inv_sigma, p, False)

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        return self._eval_set(fields, M, d_norm, inv_sigma, p, True)

    # ----- near field -----
    def near_values(self, tgt_fields, src_fields, rows, cols):
        vel, trac = stokes_near_entries(
            tgt_fields, src_fields, rows, cols, self.mu, fine_K=self.fine_K
        )
        return np.stack([vel, trac], axis=1)  # [nnz, 2, 3, 3]

    def near_select(self, vals, bc_rows):
        """Host-side BC selection (3x3 blocks) for the leaf-panel near
        field: single-layer for VELOCITY rows, double-layer otherwise."""
        sel = (np.asarray(bc_rows) == VELOCITY)[:, None, None]
        return np.where(sel, vals[:, 0], vals[:, 1])

    def near_matvec(self, vals, rows, cols, fields, qm, n):
        """COO replay of the near field (``near_panel=False``): each
        entry's 3x3 block chosen by its target row's BC flag, applied to
        the source's 3-vector and summed into the rows -> [n, 3]."""
        bc_rows = fields["bc"][rows]
        blocks = torch.where(
            (bc_rows == VELOCITY)[:, None, None], vals[:, 0], vals[:, 1]
        )
        contrib = torch.einsum("eij,ej->ei", blocks, qm[cols])
        out = torch.zeros((n, 3), dtype=qm.dtype, device=qm.device)
        return out.index_add_(0, rows, contrib)

    # ----- dense oracle -----
    def dense_matrix(self, fields):
        """[3N, 3N] dense operator honoring target BC flags."""
        n = len(fields["xyz"])
        rows = np.repeat(np.arange(n, dtype=np.int64), n)
        cols = np.tile(np.arange(n, dtype=np.int64), n)
        vel, trac = stokes_near_entries(
            fields, fields, rows, cols, self.mu, fine_K=self.fine_K
        )
        bc = np.asarray(fields["bc"])[rows]
        blocks = np.where((bc == VELOCITY)[:, None, None], vel, trac)
        A = blocks.reshape(n, n, 3, 3).transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)
        return A
