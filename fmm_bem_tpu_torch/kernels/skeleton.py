"""Kernel skeleton: the documented no-op template for adding kernels.

Counterpart of kernel/KernelSkeleton.hpp (:28-347): lists every member
of the kernel protocol the executor probes, with the batched-array
signatures this framework uses instead of the reference's per-pair
scalar operators.  Where the reference detects optional capabilities at
compile time with SFINAE (include/KernelTraits.hpp), here the plan uses
``getattr`` defaults at build time (``scale_invariant``,
``near_sparse``).

Copy this file to start a new kernel; every method marked OPTIONAL may
be omitted if the corresponding flag/feature is unused.  The device-side
operators take and return torch tensors on the plan's device.
"""

from __future__ import annotations

import numpy as np


class SkeletonKernel:
    """Minimal kernel: K(t, s) = 0 everywhere.

    Shapes
    ------
    W = width(p)    real coefficients per expansion component
    ncomp           expansion components per box (e.g. 2 for a BEM
                    kernel carrying single- and double-layer parts)
    charge_dim      trailing dims of the charge array ([N] if 1,
                    else [N, charge_dim])
    result_dim      per-target result vector length
    """

    name = "skeleton"
    ncomp = 1
    charge_dim = 1
    result_dim = 1
    #: True if translation matrices depend only on offset/sigma ratios
    #: (classes shared across levels); False for screened kernels
    scale_invariant = True
    #: True to precompute a sparse near field on the host (BEM); False
    #: to evaluate P2P tiles on the device
    near_sparse = False

    # ----- expansion layout -----
    def width(self, p: int) -> int:
        """Real slots per component at order p.  MUST be monotone in p
        with degree-ordered coefficients: truncation = prefix slice."""
        return 1

    # ----- host-side translation matrices (numpy, [W, W]) -----
    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        """hat-M_target = mat @ hat-M_source; dr = c_tgt - c_src."""
        return np.zeros((self.width(p), self.width(p)))

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        """hat-L_target contribution per unit hat-M_source (excluding
        m2l_pair_scale)."""
        return np.zeros((self.width(p), self.width(p)))

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return np.zeros((self.width(p), self.width(p)))

    def m2l_pair_scale(self, sigma_src):
        """Per-pair scalar applied to the M2L product (1/sigma for the
        Laplace family's factored 1/r; ones when folded into the
        matrix)."""
        return np.ones_like(sigma_src)

    # ----- device-side batched operators (torch) -----
    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        """[N_src, ...] -> scale-normalised multipole contributions
        [N_src, ncomp, W].  ``d_norm`` = (x - box_center)/sigma."""
        n = d_norm.shape[0]
        return d_norm.new_zeros((n, self.ncomp, self.width(p)))

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        """Evaluate per-target local expansions [N_tgt, ncomp, W] ->
        results [N_tgt, result_dim]."""
        return d_norm.new_zeros((d_norm.shape[0], self.result_dim))

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        """Treecode/skew far-field evaluation (same shapes as l2p)."""
        return d_norm.new_zeros((d_norm.shape[0], self.result_dim))

    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        """OPTIONAL unless near_sparse=False: one leaf-pair tile
        [K_tgt rows x K_src sources] -> [K_tgt, result_dim].  Padded
        source slots carry zero charge; also receive ``src_mask``."""
        k = tgt_fields["xyz"].shape[0]
        return tgt_fields["xyz"].new_zeros((k, self.result_dim))

    # ----- OPTIONAL: precomputed sparse near field (near_sparse=True) --
    def near_values(self, tgt_fields, src_fields, rows, cols):
        """Host (numpy): entry data per (row=target body, col=source
        body) pair; any trailing shape (the kernel's near_matvec
        interprets it)."""
        raise NotImplementedError

    def near_matvec(self, vals, rows, cols, tgt_fields, qm, n_tgt):
        """Device: sparse near-field product -> [n_tgt, result_dim]."""
        raise NotImplementedError
