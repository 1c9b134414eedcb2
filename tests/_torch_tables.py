"""Bad count tables and pair lists for the port's two leaf-tile kernels,
shared by ``tests/test_torch_otf.py`` and ``tests/test_torch_point.py``."""

import torch

#: a count far above K, a negative count, source leaf indices past the
#: leaf table and below 0
BAD_TABLES = ["count_above_K", "negative_count", "source_index_out_of_range"]


def spoil_tables(case, row_ptr, src_idx, counts, K):
    """(bad, corrected) tables ``(row_ptr, src_idx, counts)`` from a pair
    list and its count tables (``(src_cnt, tgt_cnt)``, or one table
    serving both sides).  The bad ones give a source leaf of a pair and
    a target leaf with pairs a bad count, or two pairs of that target
    leaf a bad source index; the corrected ones hold what the kernels
    read from them: counts clamped to [0, K], the pairs of a bad index
    dropped (an empty leaf adds nothing)."""
    nl_s = len(counts[0]) - 1
    npair = (row_ptr[1:] - row_ptr[:-1]).long()
    tleaf = int(torch.nonzero(npair > 0)[1])
    sleaf = int(src_idx[int(row_ptr[tleaf])])
    bad = [row_ptr, src_idx.clone(), [c.clone() for c in counts]]
    good = [row_ptr, src_idx, [c.clone() for c in counts]]
    if case == "source_index_out_of_range":
        hit = [int(row_ptr[tleaf]), int(row_ptr[tleaf + 1]) - 1]
        bad[1][hit[0]] = nl_s + 7
        bad[1][hit[1]] = -2
        keep = torch.ones(len(src_idx), dtype=torch.bool)
        keep[hit] = False
        npair[tleaf] -= len(set(hit))
        good[0] = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum(npair, 0)]).to(torch.int32)
        good[1] = src_idx[keep].contiguous()
    else:
        value, clamped = ((1 << 20, K) if case == "count_above_K"
                          else (-3, 0))
        for side, leaf in ((0, sleaf), (len(counts) - 1, tleaf)):
            bad[2][side][leaf] = value
            good[2][side][leaf] = clamped
    return tuple(bad), tuple(good)
