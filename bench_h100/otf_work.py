"""The work one call of ``otf_tile.cu`` needs, and its least time on the
card: the yardstick of ``layers/otf_tile_roofline.py``.

The work is counted from what the plan is, not from how the kernel is
fed: the near pair list (``p2p_tgt_slot``, ``p2p_src_slot``), the leaf
body masks and indices of the two trees, the targets' BC flags and the
quadrature order of the source panels.  A later kernel that packs its
tables otherwise, or walks more than it needs, is read against the same
work.  The arithmetic follows ``chip_smoke.py::otf_needed_work``.
"""

from __future__ import annotations

import numpy as np

#: special-function results (rsqrt, exp) a second: 16 per SM and clock
#: on 132 SMs at the 1.98 GHz boost clock the f32 peak is stated at
PEAK_SFU_PER_S = 132 * 16 * 1.98e9

#: flops of one Laplace evaluation (target, source panel, quadrature
#: point), by the target's BC flag, as ``(G, dG)``: a G target needs 3
#: differences, r^2 (5), w/r (1) and one accumulation = 10; a dG target
#: the normal projection (5), 1/r^2 (1) and two more products on top = 18
OTF_FLOPS = (10, 18)
#: flops of one (target, source panel) pair: the product with the
#: charge and its sum
PAIR_FLOPS = 2


def needed_work(plan, flipped=False):
    """What one on-the-fly near product of ``plan`` needs, for the plan's
    own BC flags or, with ``flipped``, every flag flipped (the
    right-hand side's operator).  Returns a dict:

    - ``pairs_g`` / ``pairs_dg``: (target, source panel) pairs over the
      near leaf pairs, the real targets of each BC flag (0: G, else dG)
      times the real source panels, padded slots not counted;
    - ``evaluations``: those pairs times the quadrature order KQ;
    - ``flops``: KQ times each pair at its flag's ``OTF_FLOPS``, plus
      ``PAIR_FLOPS`` a pair;
    - ``sfu``: special-function results, one rsqrt an evaluation;
    - ``bytes``: each input read once and the result written once: a
      real source panel's KQ quadrature points (3 values each), KQ
      weights, its normal (3) and its charge; a real target's position
      (3) and flag, and its result; one 4-byte source index a near leaf
      pair and one 4-byte row start a target leaf.

    Laplace kernels only: a screened kernel's evaluations are not
    counted here (ValueError).
    """
    if float(getattr(plan.kernel, "kappa", 0.0) or 0.0):
        raise ValueError("otf_work counts the Laplace kernel's work only")
    src, tgt = plan.src, plan.tgt
    KQ = int(np.asarray(src.fields["qp_off"]).shape[1])
    esz = np.dtype(plan.config.dtype).itemsize
    t_mask = np.asarray(tgt.leaf_body_mask, bool)
    bc = np.asarray(tgt.fields["bc"])[np.asarray(tgt.leaf_body_idx)]
    is_g = (bc == 0) != bool(flipped)
    n_g = (t_mask & is_g).sum(axis=1).astype(np.int64)
    n_dg = (t_mask & ~is_g).sum(axis=1).astype(np.int64)
    n_src = np.asarray(src.leaf_body_mask, bool).sum(axis=1).astype(np.int64)
    ts = np.asarray(plan.p2p_tgt_slot, np.int64)
    ss = np.asarray(plan.p2p_src_slot, np.int64)
    pairs_g = int((n_g[ts] * n_src[ss]).sum())
    pairs_dg = int((n_dg[ts] * n_src[ss]).sum())
    f_g, f_dg = OTF_FLOPS
    evals = KQ * (pairs_g + pairs_dg)
    nbytes = (int(n_src.sum()) * (4 * KQ + 4) * esz
              + int(t_mask.sum()) * 5 * esz
              + 4 * len(ss) + 4 * (t_mask.shape[0] + 1))
    return {
        "pairs_g": pairs_g, "pairs_dg": pairs_dg, "evaluations": evals,
        "flops": KQ * (pairs_g * f_g + pairs_dg * f_dg)
        + PAIR_FLOPS * (pairs_g + pairs_dg),
        "sfu": evals,
        "bytes": nbytes,
    }


def bound_s(work, peaks, dtype="float32"):
    """The least time of one call: the largest of the needed bytes over
    the memory rate, the flops over the f32 (f64) peak and the
    special-function results over ``PEAK_SFU_PER_S``.  ``peaks``:
    ``yardstick.CHIP_PEAKS``' (f32 FLOP/s, f64 FLOP/s, bytes/s)."""
    peak = peaks[0] if np.dtype(dtype) == np.float32 else peaks[1]
    return max(work["bytes"] / peaks[2], work["flops"] / peak,
               work["sfu"] / PEAK_SFU_PER_S)
