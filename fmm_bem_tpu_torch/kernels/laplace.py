"""Laplace solid harmonics on torch tensors.

Counterpart of kernel/LaplaceSpherical.hpp's evalMultipole/evalLocal.
Device-side operators are batched functions over bodies; translation
matrices come from :mod:`fmm_bem_tpu_torch.kernels.harmonics`.  The
harmonics are carried as explicit (re, im) planes so every expansion is
a real vector and truncation to a lower order is a prefix slice.
"""

from __future__ import annotations

import torch

from fmm_bem_tpu_torch.kernels import harmonics as hm


def eval_regular(d, p):
    """Regular solid harmonics R_n^m(d), m >= 0, flat (n,m) index.

    Batched over leading dims of ``d`` [..., 3]; returns a REAL pair
    (re [..., T], im [..., T]) from the Cartesian two-term recurrence
    (no trig, no sin(theta) division — cf. the reference's polar
    recurrence, LaplaceSpherical.hpp:455-488).
    """
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z
    T = hm.num_terms(p)
    re = [None] * T
    im = [None] * T
    br = torch.ones_like(x)
    bi = torch.zeros_like(x)
    for m in range(p):
        if m > 0:
            c = -(2 * m - 1)
            br, bi = c * (br * x - bi * yc), c * (br * yc + bi * x)
        pr2 = pi2 = None
        pr1, pi1 = br, bi
        for n in range(m, p):
            if n > m:
                if pr2 is None:
                    nr = (2 * n - 1) * z * pr1 / (n - m)
                    ni = (2 * n - 1) * z * pi1 / (n - m)
                else:
                    nr = ((2 * n - 1) * z * pr1 - (n + m - 1) * rho2 * pr2) / (n - m)
                    ni = ((2 * n - 1) * z * pi1 - (n + m - 1) * rho2 * pi2) / (n - m)
                pr2, pi2 = pr1, pi1
                pr1, pi1 = nr, ni
            f = float(hm.prefac(n, m))
            idx = n * (n + 1) // 2 + m
            re[idx] = f * pr1
            im[idx] = f * pi1
    return torch.stack(re, dim=-1), torch.stack(im, dim=-1)


def eval_singular(d, p, eps=0.0):
    """Singular solid harmonics S_n^m(d), m >= 0, flat (n,m) index —
    real-pair form (see eval_regular)."""
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z + eps
    inv_rho2 = 1.0 / rho2
    T = hm.num_terms(p)
    re = [None] * T
    im = [None] * T
    br = torch.sqrt(inv_rho2)
    bi = torch.zeros_like(br)
    for m in range(p):
        if m > 0:
            c = -(2 * m - 1)
            br, bi = (
                c * inv_rho2 * (br * x - bi * yc),
                c * inv_rho2 * (br * yc + bi * x),
            )
        pr2 = pi2 = None
        pr1, pi1 = br, bi
        for n in range(m, p):
            if n > m:
                if pr2 is None:
                    nr = (2 * n - 1) * z * pr1 * inv_rho2 / (n - m)
                    ni = (2 * n - 1) * z * pi1 * inv_rho2 / (n - m)
                else:
                    nr = ((2 * n - 1) * z * pr1 - (n + m - 1) * pr2) * inv_rho2 / (n - m)
                    ni = ((2 * n - 1) * z * pi1 - (n + m - 1) * pi2) * inv_rho2 / (n - m)
                pr2, pi2 = pr1, pi1
                pr1, pi1 = nr, ni
            f = float(hm.prefac(n, m))
            idx = n * (n + 1) // 2 + m
            re[idx] = f * pr1
            im[idx] = f * pi1
    return torch.stack(re, dim=-1), torch.stack(im, dim=-1)


def to_interleaved_ri(re, im):
    """(re, im) [..., T] pairs -> real [..., 2T] interleaved.

    Coefficients are degree-ordered, so truncating to a lower p is a
    prefix slice — the property the per-p device tables rely on.
    """
    return torch.stack([re, im], dim=-1).reshape(
        re.shape[:-1] + (2 * re.shape[-1],)
    )


def re_part(E):
    """Interleaved real view [..., 2T] -> re [..., T]."""
    return E[..., 0::2]


def im_part(E):
    return E[..., 1::2]


def _grad_rows(phi_fn, d):
    """Row-wise gradient of ``phi_fn(d) -> [B]`` with respect to
    ``d`` [B, 3], where row b of the result depends on row b of ``d``
    only: the gradient of the sum is then the per-row gradient.  Exact
    (reverse-mode) derivative of the same recurrence that gives the
    potential, so force and potential stay consistent."""
    with torch.enable_grad():
        dv = d.detach().clone().requires_grad_(True)
        phi = phi_fn(dv)
        if not phi.requires_grad:  # order 1: the potential is constant
            return phi, torch.zeros_like(d)
        (grad,) = torch.autograd.grad(phi.sum(), dv)
    return phi.detach(), grad


class LaplaceKernel:
    """Point Laplace kernel (ref kernel/LaplaceSpherical.hpp).

    charge: scalar; result: [potential, fx, fy, fz] (Vec<4> in the ref,
    LaplaceSpherical.hpp:66-68).
    """

    name = "laplace"
    ncomp = 1      # expansion components per box
    charge_dim = 1
    result_dim = 4
    #: translation operators depend only on normalised offsets ->
    #: octant/offset classes are shared across levels
    scale_invariant = True
    #: self-interaction exclusion threshold on R^2 (ref :158)
    eps2 = 1e-8
    #: the P2P pass runs as the leaf-tile kernel of ops/p2p_tile.py
    #: (pot + difference-form force, this kernel's exact math); other
    #: point kernels take the batched ``p2p_block`` path
    p2p_tile = True

    # ----- expansion layout -----
    def width(self, p):
        """Real slots per expansion component."""
        return hm.real_width(p)

    # ----- host-side translation matrices (numpy, physical args) -----
    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2m_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2l_matrix(dr, sigma_src, sigma_tgt, p)

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.l2l_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_pair_scale(self, sigma_src):
        """Per-pair factor applied to the class-matrix product (the
        physical 1/r falloff the scale-normalised matrix factors out)."""
        return 1.0 / sigma_src

    # ----- device-side operators (torch, batched over bodies) -----
    def p2m(self, src, charges, d_norm, inv_sigma, p):
        """Scale-normalised multipole contributions per source.

        M_hat[n,m] = q * conj(R_n^m(d/sigma)) (ref P2M :186-202, with the
        per-box sigma^n normalisation folded into the argument).
        Returns real [B, ncomp, W].
        """
        del src, inv_sigma  # points carry no extra fields
        yr, yi = eval_regular(d_norm, p)
        # conj(R): negate the imaginary plane
        return to_interleaved_ri(
            charges[..., None] * yr, -charges[..., None] * yi
        )[..., None, :]

    def l2p(self, tgt, L, d_norm, inv_sigma, p):
        """Potential + force at targets from their leaf's local
        expansion ``L`` [B, ncomp, W].

        Force = grad_t phi by automatic differentiation; the 1/sigma
        chain-rule factor accounts for the normalised coordinates.
        """
        del tgt
        w = torch.as_tensor(hm.term_weights(p), dtype=L.dtype, device=L.device)
        Lr, Li = re_part(L[:, 0]), im_part(L[:, 0])

        def phi_fn(d):
            yr, yi = eval_regular(d, p)
            return torch.sum(w * (Lr * yr - Li * yi), dim=-1)

        phi, grad = _grad_rows(phi_fn, d_norm)
        return torch.cat([phi[:, None], grad * inv_sigma[:, None]], dim=-1)

    def m2p(self, tgt, M, d_norm, inv_sigma, p):
        """Far-field evaluation from a multipole expansion (ref M2P
        :340-368): the physical potential is (1/sigma) * phi_hat(d/sigma)."""
        del tgt
        w = torch.as_tensor(hm.term_weights(p), dtype=M.dtype, device=M.device)
        Mr, Mi = re_part(M[:, 0]), im_part(M[:, 0])

        def phi_fn(d):
            sr, si = eval_singular(d, p)
            return torch.sum(w * (Mr * sr - Mi * si), dim=-1) * inv_sigma

        phi, grad = _grad_rows(phi_fn, d_norm)
        return torch.cat([phi[:, None], grad * inv_sigma[:, None]], dim=-1)

    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        """P2P tile for the plan executor: padded source slots carry zero
        charge, and the eps2 self-exclusion also kills padded sources
        that alias a target position."""
        del src_mask
        return self.p2p(tgt_fields["xyz"], src_fields["xyz"], charges)

    def p2p(self, tgt_xyz, src_xyz, charges):
        """Direct pairwise block: tgt [Bt,3] x src [Bs,3] -> [Bt, 4].

        Mirrors Direct.hpp's double loop / operator() (ref
        LaplaceSpherical.hpp:153-162) as one broadcast block.

        The force keeps the difference form sum_s w*(s_d - t_d) per
        component: the algebraically equivalent (w @ s_d) - t_d*sum(w)
        cancels two O(|x|) terms and costs about three decimal digits of
        f64 agreement between differently-partitioned sums.
        """
        dds = [
            src_xyz[..., d][None, :] - tgt_xyz[..., d][:, None]
            for d in range(3)
        ]
        r2 = dds[0] * dds[0] + dds[1] * dds[1] + dds[2] * dds[2]
        inv_r2 = torch.where(
            r2 < self.eps2, 0.0, 1.0 / torch.clamp_min(r2, self.eps2)
        )
        inv_r = torch.sqrt(inv_r2)
        pot = torch.sum(charges[None, :] * inv_r, dim=1)
        w = charges[None, :] * inv_r * inv_r2  # [Bt, Bs]
        f = [torch.sum(w * dds[d], dim=1) for d in range(3)]
        return torch.stack([pot] + f, dim=-1)

    def p2p_matrix(self, tgt_fields, src_fields):
        """Dense potential-entry block K(t,s) (no charge applied)."""
        dist = src_fields["xyz"][None, :, :] - tgt_fields["xyz"][:, None, :]
        r2 = torch.sum(dist * dist, dim=-1)
        return torch.where(
            r2 < self.eps2, 0.0,
            1.0 / torch.sqrt(torch.clamp_min(r2, self.eps2)),
        )

    # ----- dense oracle for tests (ref include/Direct.hpp) -----
    def direct(self, tgt_xyz, src_xyz, charges, chunk=2048):
        """O(N^2) direct summation, chunked over targets."""
        outs = []
        for i in range(0, tgt_xyz.shape[0], chunk):
            outs.append(self.p2p(tgt_xyz[i : i + chunk], src_xyz, charges))
        return torch.cat(outs, dim=0)
