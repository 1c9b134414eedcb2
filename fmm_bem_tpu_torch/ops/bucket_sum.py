"""Scatter-free segmented reduction: bucketed gather-and-sum.

Every OUTPUT row gathers the input rows that map to it and reduces them
densely, instead of scatter-adding inputs into outputs: the result is
independent of any atomics' order.  Variable fan-in is handled exactly
like the near-field panels: output rows are bucketed by fan-in, each
bucket padded to its edge, and dummy slots are masked to zero.

Used for the M2L pair->target-box reduction; the same structure works
for any sorted/unsorted segment reduction with bounded fan-in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: finer steps in the FMM's typical fan-in range (tens of source boxes
#: per target) bound padding waste at ~15% instead of ~50%
DEFAULT_EDGES = (
    1, 2, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 128,
    192, 256, 384, 512, 1024,
)


@dataclasses.dataclass
class BucketSum:
    """Host-side plan for a gather-sum reduction of [P, ...] -> [R, ...]."""

    #: per bucket: idx [r_b, m_b] int32 positions into the P inputs
    #: (dummy = P, clamped on device and masked to zero)
    idx: list
    #: output reorder: row r of the result = concat-row inv_order[r]
    inv_order: np.ndarray
    nin: int
    nrows: int

    def device(self, device, dtype=torch.float32):
        """Index tensors on ``device``: dummies clamped to a real row,
        with a 0/1 mask in ``dtype`` beside them."""
        return {
            "idx": tuple(
                torch.as_tensor(
                    np.minimum(i, max(self.nin - 1, 0)).astype(np.int64),
                    device=device,
                )
                for i in self.idx
            ),
            "mask": tuple(
                torch.as_tensor(i < self.nin, dtype=dtype, device=device)
                for i in self.idx
            ),
            "inv_order": torch.as_tensor(
                self.inv_order.astype(np.int64), device=device
            ),
        }


def build_bucket_sum(targets, nin, nrows, edges=DEFAULT_EDGES):
    """Plan the reduction ``out[r] = sum(x[i] for i where targets[i]==r)``.

    targets : [P] int row id per input (ids >= nrows are dropped).
    """
    targets = np.asarray(targets)
    keep = targets < nrows
    pos = np.arange(len(targets), dtype=np.int64)[keep]
    tg = targets[keep]
    order = np.argsort(tg, kind="stable")
    tg, pos = tg[order], pos[order]
    row_ptr = np.searchsorted(tg, np.arange(nrows + 1))
    m_per = np.diff(row_ptr)
    mmax = int(m_per.max(initial=1))
    edges = [e for e in edges if e <= mmax]
    if not edges or edges[-1] < mmax:
        edges = list(edges) + [mmax]

    idx_buckets, order_rows = [], []
    lo = 0
    for hi in edges:
        sel = np.where((m_per > lo) & (m_per <= hi))[0]
        lo = hi
        if len(sel) == 0:
            continue
        idx = np.full((len(sel), hi), nin, np.int32)
        for k, r in enumerate(sel):
            p0, p1 = row_ptr[r], row_ptr[r + 1]
            idx[k, : p1 - p0] = pos[p0:p1]
        idx_buckets.append(idx)
        order_rows.append(sel)

    order_rows = (
        np.concatenate(order_rows) if order_rows else np.zeros(0, np.int64)
    )
    inv_order = np.full(nrows, len(order_rows), np.int32)
    inv_order[order_rows] = np.arange(len(order_rows), dtype=np.int32)
    return BucketSum(
        idx=idx_buckets, inv_order=inv_order, nin=nin, nrows=nrows
    )


def bucket_sum_apply(dev, x):
    """Evaluate the planned reduction for inputs x [P, ...]."""
    parts = []
    for idx, mask in zip(dev["idx"], dev["mask"]):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        g = x[idx] * m
        parts.append(torch.sum(g, dim=1))
    parts.append(
        torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    )
    out = torch.cat(parts, dim=0)
    return out[dev["inv_order"]]
