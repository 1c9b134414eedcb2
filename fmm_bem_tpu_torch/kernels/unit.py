"""Unit kernel: K(t,s) = 1 (0 when t == s).

Exact under FMM by construction (expansions are plain counts), so a
full-plan matvec must equal direct summation to machine precision — the
tree/traversal/list correctness oracle (ref kernel/UnitKernel.hpp and
tests/correctness.cpp:21-80, tolerance 1e-13): every pair is counted
exactly once by the far field plus the near field."""

from __future__ import annotations

import numpy as np
import torch


class UnitKernel:
    name = "unit"
    ncomp = 1
    charge_dim = 1
    result_dim = 1

    scale_invariant = True

    def width(self, p):
        return 1  # a single real counter

    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        return np.eye(1)

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return np.eye(1)

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return np.eye(1)

    def m2l_pair_scale(self, sigma_src):
        return np.ones_like(sigma_src)

    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        return charges.reshape(-1, 1, 1)

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        return L[:, 0, :]

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        return M[:, 0, :]

    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        return self.direct(tgt_fields["xyz"], src_fields["xyz"], charges)

    def direct(self, tgt_xyz, src_xyz, charges):
        same = torch.all(tgt_xyz[:, None, :] == src_xyz[None, :, :], dim=-1)
        val = torch.where(same, 0.0, 1.0).to(charges.dtype)
        return (val @ charges)[:, None]
