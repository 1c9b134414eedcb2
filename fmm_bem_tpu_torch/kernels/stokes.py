"""Stokes point kernels: stokeslet (single layer) and stresslet
(double layer) velocities.

Counterpart of kernel/StokesSpherical.hpp — the Tornberg & Greengard
decomposition: a Stokes velocity field is assembled from FOUR harmonic
(Laplace) expansions, components 0-2 carrying the force/charge vector
and component 3 carrying f.x (ref P2M :123-146).  Evaluation combines
the four scalar potentials and their gradients (ref M2P :207-291):

    u = scale * ( phi_{0..2} + grad phi_3 - sum_k t_k grad phi_k )

with scale = 1 (stokeslet) or 1/6 (stresslet) and t the *global* target
coordinates.  The potentials are linear in the expansions, so their
gradients are the expansions contracted with the derivatives of the
harmonics along the three axes: three forward-mode derivatives of the
harmonic recurrence over the whole batch — no hand-coded
YnmTheta/sph2cart chains and no per-target graph.

M2M/M2L/L2L act componentwise with the *same* Laplace translation
matrices (ref :190-196,293-307), so the executor just carries ncomp=4.
"""

from __future__ import annotations

import torch

from fmm_bem_tpu_torch.kernels import harmonics as hm
from fmm_bem_tpu_torch.kernels.laplace import (
    eval_regular,
    eval_singular,
    im_part,
    re_part,
    term_weights_like,
    to_interleaved_ri,
)


def _phys_potentials(E, yr, yi, w):
    """Re(sum w * E * Y) per component: E [..., C, W] interleaved,
    (yr, yi) [..., T] real pair -> [..., C]."""
    return torch.sum(
        w * (re_part(E) * yr[..., None, :] - im_part(E) * yi[..., None, :]),
        dim=-1,
    )


def tornberg_velocity_sets(E, d_norm, inv_sigma, t_global, p, singular):
    """Velocities from S four-component harmonic expansion sets at a
    batch of targets, the harmonics and their derivatives evaluated
    once for all sets.

    E [B, S, 4, W] interleaved expansions (multipole if ``singular``
    else local), d_norm [B, 3] normalised offsets, inv_sigma [B],
    t_global [B, 3] the targets' global coordinates (the formulation's
    explicit x_target dependence).  Returns [B, S, 3], unscaled.
    """
    w = term_weights_like(p, E)
    harm = eval_singular if singular else eval_regular
    E2 = E.reshape(E.shape[0], -1, E.shape[-1])  # [B, S*4, W]

    ph = None
    grads = []
    for k in range(3):
        e_k = torch.zeros_like(d_norm)
        e_k[..., k] = 1.0
        (yr, yi), (dyr, dyi) = torch.func.jvp(
            lambda z: harm(z, p), (d_norm,), (e_k,)
        )
        if ph is None:
            ph = _phys_potentials(E2, yr, yi, w)
        grads.append(_phys_potentials(E2, dyr, dyi, w))
    jac = torch.stack(grads, dim=-1)  # [B, S*4, 3], d/d d_norm
    if singular:
        ph = ph * inv_sigma[:, None]
        jac = jac * inv_sigma[:, None, None]
    jac = jac * inv_sigma[:, None, None]  # d/d t_global
    S = E.shape[1]
    ph = ph.reshape(-1, S, 4)
    jac = jac.reshape(-1, S, 4, 3)
    t = t_global[:, None, :]
    return ph[..., :3] + jac[..., 3, :] - (
        t[..., 0:1] * jac[..., 0, :]
        + t[..., 1:2] * jac[..., 1, :]
        + t[..., 2:3] * jac[..., 2, :]
    )


def tornberg_velocity(E, d_norm, inv_sigma, t_global, p, singular, scale):
    """Velocity from one four-component expansion set per target:
    E [B, 4, W] -> [B, 3] (see tornberg_velocity_sets)."""
    return scale * tornberg_velocity_sets(
        E[:, None], d_norm, inv_sigma, t_global, p, singular
    )[:, 0]


class StokesKernel:
    """Stokeslet point kernel: u_i = sum_s (r^2 d_ij + dx_i dx_j)/r^3 f_j
    (ref StokesSpherical.hpp operator() :67-84)."""

    name = "stokes"
    ncomp = 4
    charge_dim = 3
    result_dim = 3
    eps2 = 1e-8
    #: overall evaluation scale (1 stokeslet, 1/6 stresslet)
    scale = 1.0

    scale_invariant = True

    # ----- host matrices: componentwise Laplace -----
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
        """4 harmonic moment sets: f_i and f.x_global (ref :123-146)."""
        del inv_sigma
        yr, yi = eval_regular(d_norm, p)  # [N, T]
        x = fields["xyz"]
        fdotx = torch.sum(charges * x, dim=-1)
        comps = torch.stack(
            [charges[:, 0], charges[:, 1], charges[:, 2], fdotx], dim=1
        )  # [N, 4]
        # conj(R): negate the imaginary plane
        return to_interleaved_ri(
            comps[:, :, None] * yr[:, None, :],
            -comps[:, :, None] * yi[:, None, :],
        )

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        return tornberg_velocity(
            L, d_norm, inv_sigma, fields["xyz"], p, False, self.scale
        )

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        return tornberg_velocity(
            M, d_norm, inv_sigma, fields["xyz"], p, True, self.scale
        )

    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        del src_mask
        return self.p2p(tgt_fields["xyz"], src_fields["xyz"], charges)

    def p2p(self, tgt_xyz, src_xyz, charges):
        dist = src_xyz[None, :, :] - tgt_xyz[:, None, :]
        r2 = torch.sum(dist * dist, dim=-1)
        inv_r2 = torch.where(
            r2 < self.eps2, 0.0, 1.0 / torch.clamp_min(r2, self.eps2)
        )
        inv_r3 = inv_r2 * torch.sqrt(inv_r2)
        fdotd = torch.einsum("tsd,sd->ts", dist, charges)
        u = inv_r3[..., None] * (
            r2[..., None] * charges[None, :, :] + fdotd[..., None] * dist
        )
        return torch.sum(u, dim=1)

    def direct(self, tgt_xyz, src_xyz, charges, chunk=2048):
        outs = []
        for i in range(0, tgt_xyz.shape[0], chunk):
            outs.append(self.p2p(tgt_xyz[i : i + chunk], src_xyz, charges))
        return torch.cat(outs, dim=0)


class StressletKernel(StokesKernel):
    """Stresslet (double-layer) variant: charge = {g, n} 6-vector
    (ref #ifdef STRESSLET, StokesSpherical.hpp:20-26,84-117,147-189)."""

    name = "stresslet"
    charge_dim = 6
    scale = 1.0 / 6.0
    #: P2M mixes g and n components (g_i n_j products) — BILINEAR in
    #: the packed 6-vector, so the executor's unit-charge linear-table
    #: shortcut does not apply
    linear_p2m = False

    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        """Dipole moments: M_i += rdotn g_i + rdotg n_i, M_3 += rdotn
        (x.g) + rdotg (n.x), with rdot* = (grad conj R).v (ref
        :147-189); the 1/sigma chain-rule factor maps normalised
        coordinates to physical gradients."""
        g = charges[:, :3]
        nv = charges[:, 3:]
        x = fields["xyz"]

        def ddir(v):
            return torch.func.jvp(
                lambda z: eval_regular(z, p), (d_norm,),
                (v.expand(d_norm.shape).contiguous(),),
            )[1]

        dnr, dni = ddir(nv)
        dgr, dgi = ddir(g)
        # rdot* = (grad conj R).v : conj = negate im plane
        rnr = dnr * inv_sigma[:, None]
        rni = -dni * inv_sigma[:, None]
        rgr = dgr * inv_sigma[:, None]
        rgi = -dgi * inv_sigma[:, None]
        xdotg = torch.sum(x * g, dim=-1)[:, None]
        ndotx = torch.sum(nv * x, dim=-1)[:, None]

        coeff_n = torch.stack([g[:, 0:1], g[:, 1:2], g[:, 2:3], xdotg], dim=1)
        coeff_g = torch.stack(
            [nv[:, 0:1], nv[:, 1:2], nv[:, 2:3], ndotx], dim=1
        )
        mr = rnr[:, None, :] * coeff_n + rgr[:, None, :] * coeff_g
        mi = rni[:, None, :] * coeff_n + rgi[:, None, :] * coeff_g
        return to_interleaved_ri(mr, mi)

    def p2p(self, tgt_xyz, src_xyz, charges):
        """u_i = (dx.n)/r^5 * dx_i (dx.g), dx = t - s (ref P2P :86-117)."""
        g = charges[:, :3]
        nv = charges[:, 3:]
        dist = tgt_xyz[:, None, :] - src_xyz[None, :, :]
        r2 = torch.sum(dist * dist, dim=-1)
        inv_r2 = torch.where(
            r2 < self.eps2, 0.0, 1.0 / torch.clamp_min(r2, self.eps2)
        )
        H = torch.sqrt(inv_r2) * inv_r2 * inv_r2  # 1/r^5
        dxdotn = torch.einsum("tsd,sd->ts", dist, nv)
        dxdotg = torch.einsum("tsd,sd->ts", dist, g)
        u = (H * dxdotn * dxdotg)[..., None] * dist
        return torch.sum(u, dim=1)
