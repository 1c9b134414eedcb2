"""Locally-essential-tree (LET) distributed FMM: explicit Morton-range
domain decomposition over ranks, with the collectives done by a small
communicator of the plan's own.

The reference parallelises with OpenMP loops over shared-memory lists
(EvalInteractionLazy.hpp:242-300); the JAX package distributes the FMM
itself over a device mesh with ``shard_map``.  Here the ranks are one
process's: rank ``r`` lives on ``devices[r]``, several ranks may share a
card (or the CPU), and ranks on distinct cards of one machine exchange
their halos by ``Tensor.to``.

ownership
    Bodies are Morton-sorted, so rank d owns a contiguous body range
    (= a compact spatial subdomain), aligned to leaf boundaries.  A box
    is OWNED by d when its body range fits inside d's range; boxes that
    span a range boundary are SHARED: they form the small top of the
    tree (O(depth x ndev) boxes) and are replicated on every rank.

per-rank state (on the rank's device; nothing O(N) replicated)
    - its target leaves' near-field store (``ops/near_panel.py``), built
      in a local numbering: charge columns [own | import | 0]
    - its M2L/M2P pair tiles (assigned by target-box owner)
    - its slice of the body tables (P2M/L2P linear maps, fields)
    - a local box table [shared | own | import | zero | sink] holding
      multipoles/locals for owned boxes, the replicated shared top, and
      the imported halo

one matvec (every rank is a generator that yields at each collective;
``LetPlan`` advances all ranks to their next collective, does it, and
sends each rank its share)
    1. leaf charge tiles of the boundary leaves  -> all_gather  (halo)
    2. local P2M + local M2M (contributions into shared rows)
    3. psum of the shared-M block                               (tiny)
    4. replicated top-of-tree M2M
    5. all_gather of EXPORTED multipoles (the LET halo: only boxes some
       other rank's M2L/M2P lists touch: O(boundary), not O(boxes))
    6. local M2L class-tile matmuls + bucketed gather-sum; local near
       field (``panel_matvec`` on the rank's store, or the kernel's
       ``p2p_block`` over chunks of pairs for point kernels)
    7. psum of the shared-L block
    8. replicated shared L2L, then local L2L / L2P / M2P
    Four collectives (five and six on a two-level layout), all
    O(boundary or tree-top); near-field stores, M2L tiles and
    expansions never move between ranks.

The host tables (partition, box tables, halo plans, M2L tiles and their
bucketed reductions, padded ``[ndev, ...]`` stacks) are the JAX
package's, copied so that they can be held to it array for array; rank
``r`` takes slice ``[r]`` of each stack.

Use ``LetPlan(plan, ndev_or_layout)`` on a built FmmPlan, then
``apply(q, p)`` / ``solver_ops()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fmm_bem_tpu_torch import resolve_device
from fmm_bem_tpu_torch.executor.plan import apply_flat_trans
from fmm_bem_tpu_torch.ops.bucket_sum import DEFAULT_EDGES as BS_EDGES
from fmm_bem_tpu_torch.ops.bucket_sum import bucket_sum_apply
from fmm_bem_tpu_torch.ops.near_panel import (
    build_near_panels,
    build_near_panels_on_device,
    choose_m0,
    panel_matvec,
)


# ----------------------------------------------------------------------
# host-side partition and table construction
# ----------------------------------------------------------------------


def _pad_stack(arrs, fill, dtype=None, min_len=1):
    """Stack per-rank 1/2-D arrays padded to a common leading shape."""
    arrs = [np.asarray(a) for a in arrs]
    nd = len(arrs)
    shp = tuple(
        max(min_len if ax == 0 else 0, *(a.shape[ax] for a in arrs))
        for ax in range(arrs[0].ndim)
    )
    dt = dtype or arrs[0].dtype
    out = np.full((nd,) + shp, fill, dt)
    for d, a in enumerate(arrs):
        out[(d,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


def _index(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


@dataclasses.dataclass
class _BucketSumStack:
    """Per-rank bucket_sum plans with common shapes (stacked)."""

    idx: list          # per bucket: [ndev, rows_b, m_b]
    inv_order: np.ndarray  # [ndev, nrows]
    nin: int           # dummy index threshold (common across ranks)

    def rank(self, r, device, dtype):
        """Rank ``r``'s plan as the dict ``bucket_sum_apply`` reads:
        dummies clamped to a real row, with a 0/1 mask beside them (see
        ops/bucket_sum.BucketSum.device)."""
        return {
            "idx": tuple(
                _index(np.minimum(i[r], max(self.nin - 1, 0)), device)
                for i in self.idx
            ),
            "mask": tuple(
                torch.as_tensor(i[r] < self.nin, dtype=dtype, device=device)
                for i in self.idx
            ),
            "inv_order": _index(self.inv_order[r], device),
        }


def _build_bucket_sums(per_dev_targets, nins, nrows, edges=BS_EDGES):
    """build_bucket_sum per rank with bucket shapes unified across
    ranks so the plans stack into [ndev, ...] arrays."""
    if isinstance(nins, (list, tuple)):
        raise ValueError("stacked bucket plans need a common dummy threshold")
    nd = len(per_dev_targets)
    plans = []
    for d in range(nd):
        tg = np.asarray(per_dev_targets[d])
        keep = tg < nrows
        pos = np.arange(len(tg), dtype=np.int64)[keep]
        t = tg[keep]
        order = np.argsort(t, kind="stable")
        t, pos = t[order], pos[order]
        row_ptr = np.searchsorted(t, np.arange(nrows + 1))
        plans.append((pos, row_ptr, np.diff(row_ptr)))
    mmax = max(int(p[2].max(initial=1)) for p in plans)
    es = [e for e in edges if e <= mmax]
    if not es or es[-1] < mmax:
        es = list(es) + [mmax]

    # rows per bucket unified to the max across ranks
    rows_per_edge = []
    lo = 0
    for hi in es:
        rows_per_edge.append(
            max(
                1,
                *(
                    int(((p[2] > lo) & (p[2] <= hi)).sum())
                    for p in plans
                ),
            )
        )
        lo = hi

    idx_buckets = [[] for _ in es]
    inv_orders = []
    for d in range(nd):
        pos, row_ptr, m_per = plans[d]
        order_rows = []
        lo = 0
        for bi, hi in enumerate(es):
            sel = np.where((m_per > lo) & (m_per <= hi))[0]
            lo = hi
            rows_b = rows_per_edge[bi]
            idx = np.full((rows_b, hi), nins, np.int32)
            for k, r in enumerate(sel):
                p0, p1 = row_ptr[r], row_ptr[r + 1]
                idx[k, : p1 - p0] = pos[p0:p1]
            idx_buckets[bi].append(idx)
            order_rows.append(
                np.concatenate(
                    [sel, np.full(rows_b - len(sel), nrows, np.int64)]
                )
            )
        order_rows = np.concatenate(order_rows)
        total = len(order_rows)
        inv = np.full(nrows, total, np.int32)  # appended zero row
        valid = order_rows < nrows
        inv[order_rows[valid]] = np.arange(total, dtype=np.int32)[valid]
        inv_orders.append(inv)
    return _BucketSumStack(
        idx=[np.stack(b) for b in idx_buckets],
        inv_order=np.stack(inv_orders),
        nin=int(nins),
    )


# ----------------------------------------------------------------------
# the communicator
# ----------------------------------------------------------------------


class LocalComm:
    """Collectives over the ranks of one process, each rank on
    ``devices[r]``, on a ``(ndcn, nsp)`` layout with ranks outer-major
    (rank ``g * nsp + i`` is member ``i`` of group ``g``).

    An axis is ``"sp"`` (the inner axis: the ranks of one group) or
    ``("dp", "sp")`` (both axes: every rank).  A collective takes the
    list of per-rank tensors and returns the list of per-rank results,
    each on its rank's device; ranks that share a device share one
    result tensor, which they must not write to.

    ``log`` holds, for the current matvec (``start`` clears it), one
    ``(op, axis, bytes a rank receives from the other ranks)`` per
    collective: the payloads are padded to one shape on every rank.
    """

    def __init__(self, devices, layout):
        self.devices = list(devices)
        self.ndcn, self.nsp = layout
        if self.ndcn * self.nsp != len(self.devices):
            raise ValueError(
                f"layout {layout} does not fit {len(self.devices)} ranks")
        self.log = []

    def start(self):
        self.log = []

    def groups(self, axis):
        if axis == "sp":
            return [list(range(g * self.nsp, (g + 1) * self.nsp))
                    for g in range(self.ndcn)]
        if tuple(axis) == ("dp", "sp"):
            return [list(range(self.ndcn * self.nsp))]
        raise ValueError(f"unknown mesh axis {axis!r}")

    def _collect(self, op, xs, axis, combine):
        out = [None] * len(xs)
        for grp in self.groups(axis):
            per_device = {}
            for r in grp:
                dev = self.devices[r]
                if dev not in per_device:
                    per_device[dev] = combine([xs[s].to(dev) for s in grp])
                out[r] = per_device[dev]
        x = xs[0]
        nrecv = (len(self.groups(axis)[0]) - 1) * x.numel() * x.element_size()
        self.log.append((op, axis if axis == "sp" else tuple(axis), nrecv))
        return out

    def all_gather(self, xs, axis):
        """Every rank gets ``stack(xs of its group)`` ([g, ...], rank
        order)."""
        return self._collect("all_gather", xs, axis, torch.stack)

    def psum(self, xs, axis):
        """Every rank gets the sum of its group's ``xs``, added in rank
        order on its own device: the same bits on every rank."""

        def add_in_order(parts):
            acc = parts[0]
            for x in parts[1:]:
                acc = acc + x
            return acc

        return self._collect("psum", xs, axis, add_in_order)

    def max_received(self):
        """The largest ``(bytes, "op axis")`` of the log (``(0, "")`` if
        it is empty)."""
        worst = (0, "")
        for op, axis, nbytes in self.log:
            if nbytes > worst[0]:
                ax = axis if isinstance(axis, str) else ",".join(axis)
                worst = (nbytes, f"{op} {ax}")
        return worst


def _drive(bodies, comm):
    """Advance the rank generators ``bodies`` to their collectives in
    lockstep: each yields ``(op, axis, tensor)``, ``comm`` does the
    collective, and each rank is sent its share of the result.  Returns
    the ranks' return values."""
    nd = len(bodies)
    outs = [None] * nd
    sends = [None] * nd
    while True:
        reqs = []
        for r, body in enumerate(bodies):
            try:
                reqs.append(body.send(sends[r]))
            except StopIteration as stop:
                outs[r] = stop.value
                reqs.append(None)
        if all(q is None for q in reqs):
            return outs
        kinds = {None if q is None else q[:2] for q in reqs}
        if len(kinds) != 1:
            raise RuntimeError("the ranks reached different collectives: "
                               f"{sorted(map(str, kinds))}")
        op, axis = reqs[0][:2]
        sends = getattr(comm, op)([q[2] for q in reqs], axis)


class LetPlan:
    """Distribute a built FmmPlan over ranks on a list of devices.

    Parameters
    ----------
    plan : FmmPlan (single-tree, cached panel store or point P2P).
    ndev_or_layout : rank count (a 1-D layout), or ``(ndcn, nsp)`` for
        the two-level layout of the JAX package (SURVEY.md §5.8): the
        inner axis ``"sp"`` is a group of ranks (one host's chips), the
        outer axis ``"dp"`` crosses groups.  Morton ranges are laid out
        so the rank order is (outer-major, inner-minor) and the
        multipole/charge halos are exchanged hierarchically: intra-group
        exports ride ONLY the inner axis, and the cross-group all_gather
        carries only the boxes some other group imports.
    flipped : distribute the BC-flipped operator variant (the
        reference's switch_BC system matrix).
    devices : the device of each rank (default: every rank on the
        plan's device).  Its length must be the rank count.
    """

    AXIS = "sp"
    AXIS_DCN = "dp"

    def __init__(self, plan, ndev_or_layout, flipped=False, devices=None):
        if plan.dual:
            raise ValueError(
                "LetPlan distributes single-tree plans only; this plan has "
                "a target tree of its own (target_fields)")
        if plan._otf_near:
            raise NotImplementedError(
                "LetPlan: the distributed near field covers only cached "
                "panel stores and point P2P; this plan's near_mode='otf' "
                "recomputes the regular quadrature per matvec and caches "
                "only the near-singular corrections, which a rank's store "
                "cannot stand in for")
        if plan.near_rows is not None and not plan._use_panels:
            raise NotImplementedError(
                "LET distribution needs the panel near field "
                "(near_panel=True) or a direct-P2P kernel; the COO replay "
                "mode is not distributed")
        if plan.near_only:
            raise NotImplementedError(
                "LetPlan distributes the full FMM operator; a near-field-"
                "only plan (local_evaluation / block_diagonal) is not "
                "distributed")
        self.plan = plan
        if isinstance(ndev_or_layout, (tuple, list)):
            self.ndcn, self.nsp = (int(v) for v in ndev_or_layout)
        else:
            self.ndcn, self.nsp = 1, int(ndev_or_layout)
        if self.ndcn < 1 or self.nsp < 1:
            raise ValueError(f"bad rank layout {ndev_or_layout!r}")
        self.ndev = self.ndcn * self.nsp
        if devices is None:
            devices = [plan.device] * self.ndev
        devices = [resolve_device(d) for d in devices]
        if len(devices) != self.ndev:
            raise ValueError(
                f"LetPlan: {len(devices)} devices for {self.ndev} ranks")
        self.devices = devices
        self.comm = LocalComm(devices, (self.ndcn, self.nsp))
        #: rank -> outer-group id (outer-major order)
        self.dev_group = np.arange(self.ndev) // self.nsp
        self.flipped = flipped
        self.dtype = plan.dtype
        self._partition()
        self._build_box_tables()
        self._build_m2l()
        self._build_m2p()
        self._build_near()
        self._build_body_tables()
        self._rank_common = None
        self._shared_cache = {}
        self._op_cache = {}
        self._near_variant_cache = {}
        self._pad_maps = None

    # ------------------------------------------------------------------
    def _partition(self):
        plan = self.plan
        tree = plan.src.tree
        nd = self.ndev
        leaves = plan.src.leaf_ids
        starts = tree.box_body_start[leaves]
        counts = tree.box_body_count[leaves]
        lorder = np.argsort(starts, kind="stable")
        cum = np.cumsum(counts[lorder])
        n = tree.num_bodies
        # split leaf sequence at ~equal body counts
        targets = (np.arange(1, nd) * n) // nd
        cut = np.searchsorted(cum, targets, side="left") + 1
        cut = np.concatenate([[0], cut, [len(leaves)]])
        self.dev_leaf_slots = [
            np.sort(lorder[cut[d] : cut[d + 1]]).astype(np.int32)
            for d in range(nd)
        ]
        # body ranges per rank (contiguous by construction)
        self.dev_lo = np.array(
            [
                starts[ls].min() if len(ls) else n
                for ls in (self.dev_leaf_slots)
            ],
            dtype=np.int64,
        )
        self.dev_hi = np.array(
            [
                (starts[ls] + counts[ls]).max() if len(ls) else n
                for ls in self.dev_leaf_slots
            ],
            dtype=np.int64,
        )
        # box ownership: owned iff the body range fits one rank's range
        bs = tree.box_body_start.astype(np.int64)
        be = bs + tree.box_body_count
        owner = np.searchsorted(self.dev_lo, bs, side="right") - 1
        owner = np.clip(owner, 0, nd - 1)
        contained = (bs >= self.dev_lo[owner]) & (be <= self.dev_hi[owner])
        self.box_owner = np.where(contained, owner, -1).astype(np.int32)
        self.shared_boxes = np.where(self.box_owner < 0)[0].astype(np.int32)
        self.own_boxes = [
            np.where(self.box_owner == d)[0].astype(np.int32)
            for d in range(nd)
        ]
        # pair/tile assignment for shared targets: rank at box start
        self.assign_dev = np.where(
            self.box_owner >= 0,
            self.box_owner,
            np.clip(
                np.searchsorted(self.dev_lo, bs, side="right") - 1, 0, nd - 1
            ),
        ).astype(np.int32)

    def _build_box_tables(self):
        plan = self.plan
        tree = plan.src.tree
        nd = self.ndev
        n_sh = len(self.shared_boxes)
        n_own_max = max(1, max(len(o) for o in self.own_boxes))
        self.n_sh = n_sh
        self.n_own_max = n_own_max

        # import sets: M2L/M2P sources not owned-by-d and not shared
        need = [set() for _ in range(nd)]
        cls = plan.m2l_classes
        for ci in range(len(cls.src)):
            s, t = cls.src[ci], cls.tgt[ci]
            dv = self.assign_dev[t]
            for d in range(nd):
                sel = s[dv == d]
                rem = sel[
                    (self.box_owner[sel] != d) & (self.box_owner[sel] >= 0)
                ]
                need[d].update(rem.tolist())
        ms, mt = plan.m2p_src, plan.m2p_tgt_slot
        if len(ms):
            tgt_boxes = plan.tgt.leaf_ids[mt]
            dv = self.assign_dev[tgt_boxes]
            for d in range(nd):
                sel = ms[dv == d]
                rem = sel[
                    (self.box_owner[sel] != d) & (self.box_owner[sel] >= 0)
                ]
                need[d].update(rem.tolist())
        self.import_boxes = [
            np.array(sorted(need[d]), dtype=np.int64) for d in range(nd)
        ]
        n_imp_max = max(1, max(len(i) for i in self.import_boxes))
        self.n_imp_max = n_imp_max

        # local row layout
        self.ZERO = n_sh + n_own_max + n_imp_max
        self.SINK = self.ZERO + 1
        self.R = self.SINK + 1          # M-table rows
        self.R_red = n_sh + n_own_max   # L-table live rows (no imports)
        self.ZERO_L = self.R_red
        self.SINK_L = self.R_red + 1
        self.R_L = self.R_red + 2

        g2l = np.full((nd, tree.num_boxes), self.ZERO, np.int32)
        for d in range(nd):
            g2l[d, self.shared_boxes] = np.arange(n_sh, dtype=np.int32)
            g2l[d, self.own_boxes[d]] = n_sh + np.arange(
                len(self.own_boxes[d]), dtype=np.int32
            )
            g2l[d, self.import_boxes[d]] = (
                n_sh + n_own_max
                + np.arange(len(self.import_boxes[d]), dtype=np.int32)
            )
        self.g2l = g2l

        # M exports: per owner, own-row indices of boxes others import
        exported = [set() for _ in range(nd)]
        for d in range(nd):
            for b in self.import_boxes[d]:
                exported[self.box_owner[b]].add(int(b))
        exp_boxes = [np.array(sorted(e), dtype=np.int64) for e in exported]
        self.n_bexp_max = max(1, max(len(e) for e in exp_boxes))
        # exporter-side gather rows (local own rows); pad -> ZERO row
        self.m_export_rows = _pad_stack(
            [g2l[d, exp_boxes[d]] if len(exp_boxes[d]) else
             np.zeros(0, np.int32) for d in range(nd)],
            self.ZERO, np.int32, min_len=self.n_bexp_max,
        )
        # importer-side positions into the all_gathered [nd * n_bexp_max]
        flat_pos = {}
        for o in range(nd):
            for k, b in enumerate(exp_boxes[o]):
                flat_pos[int(b)] = o * self.n_bexp_max + k
        imp_pos = []
        for d in range(nd):
            imp_pos.append(
                np.array(
                    [flat_pos[int(b)] for b in self.import_boxes[d]],
                    dtype=np.int32,
                )
            )
        # pad -> appended zero row (index nd * n_bexp_max)
        self.m_import_pos = _pad_stack(
            imp_pos, nd * self.n_bexp_max, np.int32, min_len=self.n_imp_max
        )
        if self.ndcn > 1:
            # two-level layout: hierarchical multipole halo (intra-group
            # over the inner axis; only cross-group boxes over both)
            (
                self.m_exp_intra,
                self.m_exp_inter,
                self.m_import_pos2,
            ) = self._halo_split(
                self.import_boxes,
                self.box_owner,
                lambda o, ids: g2l[o, ids]
                if len(ids)
                else np.zeros(0, np.int32),
                self.ZERO,
            )

        # M2M / L2L class lists.  local: children owned by d (parent is
        # then owned-by-d or shared).  shared: child and parent shared.
        side = plan.src
        self.num_levels = tree.num_levels
        loc_up, shr_up = [], []
        for lvl in range(1, tree.num_levels):
            per_class = side.levels[lvl - 1]
            lc, sc = [], []
            for c in range(8):
                e = per_class[c]
                if e is None:
                    lc.append(None)
                    sc.append(None)
                    continue
                ch, pa, mi = e[0], tree.box_parent[e[0]], e[2]
                own = self.box_owner[ch]
                sh_sel = own < 0
                if sh_sel.any():
                    sc.append(
                        (
                            g2l[0, ch[sh_sel]],
                            g2l[0, pa[sh_sel]],
                            mi,
                        )
                    )
                else:
                    sc.append(None)
                per_dev_ch, per_dev_pa = [], []
                any_local = False
                for d in range(nd):
                    sel = own == d
                    per_dev_ch.append(g2l[d, ch[sel]])
                    per_dev_pa.append(g2l[d, pa[sel]])
                    any_local = any_local or sel.any()
                if any_local:
                    lc.append(
                        (
                            _pad_stack(per_dev_ch, self.ZERO, np.int32),
                            _pad_stack(per_dev_pa, self.SINK, np.int32),
                            mi,
                        )
                    )
                else:
                    lc.append(None)
            loc_up.append(lc)
            shr_up.append(sc)
        self.levels_local = loc_up
        self.levels_shared = shr_up

    def _halo_split(self, imports, owner_of_item, row_of, exp_pad_row):
        """Two-level halo exchange tables (2-D layout only).

        Splits each owner's export set into items imported only within
        its outer group (exchanged by an all_gather over the inner axis:
        per group, never crossing groups) and items some other group
        imports (exchanged by one all_gather over every rank, which
        carries ONLY these).  An item imported on both sides appears in
        both tables.

        Parameters
        ----------
        imports : per-rank arrays of global item ids.
        owner_of_item : [num_items] owner rank per global id.
        row_of : callable ``(owner, ids) -> local row indices``.
        exp_pad_row : exporter-side pad row (a zero row).

        Returns (exp_intra [nd, ni], exp_inter [nd, ne], imp_pos
        [nd, n_imp_max]) with positions into
        ``concat[intra (nsp*ni) | inter (nd*ne) | zero]``.
        """
        nd, nsp, grp = self.ndev, self.nsp, self.dev_group
        intra = [{} for _ in range(nd)]
        inter = [{} for _ in range(nd)]
        for d in range(nd):
            for b in imports[d]:
                o = int(owner_of_item[int(b)])
                tab = intra[o] if grp[d] == grp[o] else inter[o]
                if int(b) not in tab:
                    tab[int(b)] = len(tab)
        bi = [np.array(sorted(t), dtype=np.int64) for t in intra]
        be = [np.array(sorted(t), dtype=np.int64) for t in inter]
        ni = max(1, max(len(b) for b in bi))
        ne = max(1, max(len(b) for b in be))
        exp_intra = _pad_stack(
            [row_of(o, bi[o]) for o in range(nd)],
            exp_pad_row, np.int32, min_len=ni,
        )
        exp_inter = _pad_stack(
            [row_of(o, be[o]) for o in range(nd)],
            exp_pad_row, np.int32, min_len=ne,
        )
        pos_intra = {
            (o, int(b)): (o % nsp) * ni + k
            for o in range(nd)
            for k, b in enumerate(bi[o])
        }
        pos_inter = {
            (o, int(b)): nsp * ni + o * ne + k
            for o in range(nd)
            for k, b in enumerate(be[o])
        }
        zero_pos = nsp * ni + nd * ne
        imp_pos = []
        for d in range(nd):
            rows = []
            for b in imports[d]:
                o = int(owner_of_item[int(b)])
                rows.append(
                    pos_intra[(o, int(b))]
                    if grp[d] == grp[o]
                    else pos_inter[(o, int(b))]
                )
            imp_pos.append(np.array(rows, dtype=np.int32))
        n_imp_max = max(1, max(len(r) for r in imp_pos))
        imp_pos = _pad_stack(imp_pos, zero_pos, np.int32, min_len=n_imp_max)
        return exp_intra, exp_inter, imp_pos

    def _build_m2l(self):
        plan = self.plan
        nd = self.ndev
        cls = plan.m2l_classes
        TS = plan.m2l_tile_size
        G = plan.m2l_tile_group
        per_dev = [
            {"src": [], "tgt": [], "cls": []}
            for _ in range(nd)
        ]
        for ci in range(len(cls.src)):
            s, t = cls.src[ci], cls.tgt[ci]
            dv = self.assign_dev[t]
            for d in range(nd):
                sel = dv == d
                n = int(sel.sum())
                if n == 0:
                    continue
                ntile = -(-n // TS)
                pad = ntile * TS - n
                per_dev[d]["src"].append(self.g2l[d, s[sel]])
                per_dev[d]["tgt"].append(self.g2l[d, t[sel]])
                if pad:
                    per_dev[d]["src"].append(
                        np.full(pad, self.ZERO, np.int32)
                    )
                    per_dev[d]["tgt"].append(
                        np.full(pad, self.R_L, np.int32)  # dropped
                    )
                per_dev[d]["cls"].append(np.full(ntile, ci, np.int32))

        srcs, tgts, clss = [], [], []
        for d in range(nd):
            pd = per_dev[d]
            if pd["src"]:
                srcs.append(np.concatenate(pd["src"]))
                tgts.append(np.concatenate(pd["tgt"]))
                clss.append(np.concatenate(pd["cls"]))
            else:
                srcs.append(np.zeros(0, np.int32))
                tgts.append(np.zeros(0, np.int32))
                clss.append(np.zeros(0, np.int32))
        self.has_m2l = len(cls.mats) > 0
        ntile_max = max(1, max(len(c) for c in clss))
        ntile_max = -(-ntile_max // G) * G
        self.m2l_ntile = ntile_max
        self.m2l_src = _pad_stack(
            srcs, self.ZERO, np.int32, min_len=ntile_max * TS
        )
        self.m2l_tgt = _pad_stack(
            tgts, self.R_L, np.int32, min_len=ntile_max * TS
        )
        self.m2l_cls = _pad_stack(clss, 0, np.int32, min_len=ntile_max)
        self.m2l_bsum = _build_bucket_sums(
            [self.m2l_tgt[d] for d in range(nd)],
            ntile_max * TS,
            self.R_red,
        )

    def _build_m2p(self):
        plan = self.plan
        nd = self.ndev
        ms, mt = plan.m2p_src, plan.m2p_tgt_slot
        self.has_m2p = len(ms) > 0
        if not self.has_m2p:
            return
        tgt_boxes = plan.tgt.leaf_ids[mt]
        dv = self.assign_dev[tgt_boxes]
        src_rows, tgt_loc, isig = [], [], []
        for d in range(nd):
            sel = dv == d
            src_rows.append(self.g2l[d, ms[sel]])
            tgt_loc.append(self.leaf_g2l(d)[mt[sel]])
            isig.append(plan.m2p_inv_sigma[sel])
        self.m2p_rows = _pad_stack(src_rows, self.ZERO, np.int32)
        # padded pairs scatter into an extra segment (nl_d_max)
        self.m2p_tslot = _pad_stack(
            tgt_loc, self.nl_max, np.int32
        )
        self.m2p_isig = _pad_stack(isig, 0.0, np.float64)
        self.m2p_srcbox = _pad_stack(
            [ms[dv == d] for d in range(nd)], 0, np.int32
        )

    def leaf_g2l(self, d):
        """Global leaf slot -> local own-leaf index for rank d."""
        if not hasattr(self, "_leaf_g2l"):
            nl = len(self.plan.src.leaf_ids)
            self.nl_max = max(
                1, max(len(ls) for ls in self.dev_leaf_slots)
            )
            m = np.full((self.ndev, nl), self.nl_max, np.int32)
            for dd in range(self.ndev):
                m[dd, self.dev_leaf_slots[dd]] = np.arange(
                    len(self.dev_leaf_slots[dd]), dtype=np.int32
                )
            self._leaf_g2l = m
        return self._leaf_g2l[d]

    def _build_near(self):
        """Per-rank near field tables: a locally-renumbered source-leaf
        charge table [own | import | 0] and the charge-tile halo
        exchange plan (the stores themselves are built per BC variant,
        ``_near_panels_local``)."""
        plan = self.plan
        nd = self.ndev
        self.leaf_g2l(0)  # materialise nl_max
        kern = plan.kernel
        self.cdim = getattr(kern, "charge_dim", 1)
        self.rdim = getattr(kern, "result_dim", 1)
        K = plan.src.leaf_pad
        self.K = K

        pp_s = plan.p2p_src_slot
        pp_t = plan.p2p_tgt_slot
        tgt_leaf_box = plan.tgt.leaf_ids[pp_t]
        pair_dev = self.assign_dev[tgt_leaf_box]
        # leaf-slot owner (leaves are always owned)
        leaf_owner = self.box_owner[plan.src.leaf_ids]

        # per rank: imported source leaf slots (global numbering)
        imp_leaves = []
        for d in range(nd):
            sel = pair_dev == d
            rem = np.unique(pp_s[sel][leaf_owner[pp_s[sel]] != d])
            imp_leaves.append(rem.astype(np.int64))
        self.n_limp_max = max(1, max(len(i) for i in imp_leaves))
        self.imp_leaves = imp_leaves

        # source-leaf local charge-table column map:
        # [own leaves (nl_max) | imports (n_limp_max) | zero]
        nl = len(plan.src.leaf_ids)
        src_l2c = np.full(
            (nd, nl), self.nl_max + self.n_limp_max, np.int32
        )
        for d in range(nd):
            src_l2c[d, self.dev_leaf_slots[d]] = np.arange(
                len(self.dev_leaf_slots[d]), dtype=np.int32
            )
            src_l2c[d, imp_leaves[d]] = self.nl_max + np.arange(
                len(imp_leaves[d]), dtype=np.int32
            )
        self.src_l2c = src_l2c
        self.n_ctab = self.nl_max + self.n_limp_max + 1

        # charge-tile exports (local own-leaf indices per owner)
        exported = [set() for _ in range(nd)]
        for d in range(nd):
            for s in imp_leaves[d]:
                exported[leaf_owner[s]].add(int(s))
        exp_leaves = [np.array(sorted(e), dtype=np.int64) for e in exported]
        self.n_lexp_max = max(1, max(len(e) for e in exp_leaves))
        self.q_export_rows = _pad_stack(
            [
                self._leaf_g2l[d, exp_leaves[d]]
                if len(exp_leaves[d])
                else np.zeros(0, np.int32)
                for d in range(nd)
            ],
            self.nl_max,  # pad -> local zero-pad row (tile of zeros)
            np.int32,
            min_len=self.n_lexp_max,
        )
        flat_pos = {}
        for o in range(nd):
            for k, s in enumerate(exp_leaves[o]):
                flat_pos[int(s)] = o * self.n_lexp_max + k
        self.q_import_pos = _pad_stack(
            [
                np.array(
                    [flat_pos[int(s)] for s in imp_leaves[d]],
                    dtype=np.int32,
                )
                for d in range(nd)
            ],
            nd * self.n_lexp_max,
            np.int32,
            min_len=self.n_limp_max,
        )
        if self.ndcn > 1:
            # two-level layout: hierarchical charge-tile halo
            (
                self.q_exp_intra,
                self.q_exp_inter,
                self.q_import_pos2,
            ) = self._halo_split(
                imp_leaves,
                leaf_owner.astype(np.int64),
                lambda o, ids: self._leaf_g2l[o, ids]
                if len(ids)
                else np.zeros(0, np.int32),
                self.nl_max,
            )

        self.pair_dev = pair_dev
        self.use_panels = plan._use_panels
        self.use_p2p = (
            plan.near_rows is None and len(plan.p2p_src_slot) > 0
        )

    def _near_panels_local(self, tgt_fields_host):
        """Per-rank near stores ``[(device dict, NearPanels meta)]``,
        each on its rank's device, built by ops/near_panel.py's builders
        in the local target / source renumbering; cached per BC
        variant."""
        plan = self.plan
        key = np.asarray(tgt_fields_host.get("bc", np.zeros(0))).tobytes()
        if key in self._near_variant_cache:
            return self._near_variant_cache[key]
        pp_s, pp_t = plan.p2p_src_slot, plan.p2p_tgt_slot
        rows, cols = plan.near_rows, plan.near_cols
        bc = np.asarray(tgt_fields_host.get("bc", np.zeros(0)))
        vsel = plan.kernel.near_select(
            plan.near_vals, bc[rows] if len(bc) else None
        )
        t_slot_of_body = plan.tgt.box_to_slot[plan.tgt.tree.body_leaf]

        # one chunk width for ALL ranks; a target leaf belongs to exactly
        # one rank, so the global per-leaf pair counts are exactly the
        # union of the per-rank ones
        m_per_global = np.bincount(
            np.asarray(pp_t), minlength=len(plan.tgt.leaf_ids)
        )
        m0 = choose_m0(m_per_global, self.K * self.cdim)
        blocks_on_plan = (
            plan._near_blocks_fn(tgt_fields_host)
            if plan._device_near else None
        )

        stores = []
        for d in range(self.ndev):
            dev = self.devices[d]
            psel = self.pair_dev == d
            ss_d = pp_s[psel]
            ts_d = pp_t[psel]
            # entries whose target body lies in a target leaf of a pair
            # assigned to d (a target leaf's pairs all go to one rank)
            tgt_set = np.zeros(len(plan.tgt.leaf_ids) + 1, bool)
            tgt_set[ts_d] = True
            esel = tgt_set[t_slot_of_body[rows]]
            local = dict(
                tgt_slot_local=self.leaf_g2l(d).astype(np.int64),
                src_slot_local=self.src_l2c[d].astype(np.int64),
                nl_src_local=self.n_ctab - 1,
            )
            if blocks_on_plan is not None:

                def blocks_fn(ss, ts, _dev=dev):
                    return blocks_on_plan(
                        ss.to(plan.device), ts.to(plan.device)).to(_dev)

                store = build_near_panels_on_device(
                    ss_d, ts_d, plan.src, plan.tgt, self.nl_max, blocks_fn,
                    corr=(rows[esel], cols[esel], vsel[esel]),
                    rdim=self.rdim, cdim=self.cdim, m0=m0,
                    dtype=self.dtype, device=dev, **local,
                )
            else:
                meta = build_near_panels(
                    ss_d, ts_d, rows[esel], cols[esel], vsel[esel],
                    plan.src, plan.tgt, self.nl_max, m0=m0,
                    dtype=np.dtype(plan.config.dtype), **local,
                )
                store = (meta.device(self.dtype, dev), meta)
            stores.append(store)
        self._near_variant_cache[key] = stores
        if len(self._near_variant_cache) > 2:
            self._near_variant_cache.pop(next(iter(self._near_variant_cache)))
        return stores

    def _build_body_tables(self):
        plan = self.plan
        nd = self.ndev
        tree = plan.src.tree
        self.nb_max = int(
            max(self.dev_hi[d] - self.dev_lo[d] for d in range(nd))
        )
        side = plan.src
        K = self.K
        # per-rank leaf tiles: local body ids (global - lo), masked
        lb_idx, lb_mask, leaf_rows = [], [], []
        flat_slot = []
        body_leaf_row = []
        for d in range(nd):
            ls = self.dev_leaf_slots[d]
            idx = side.leaf_body_idx[ls] - self.dev_lo[d]
            msk = side.leaf_body_mask[ls]
            idx = np.where(msk, idx, 0).astype(np.int32)
            lb_idx.append(idx)
            lb_mask.append(msk)
            leaf_rows.append(
                self.g2l[d, plan.src.leaf_ids[ls]]
            )
            # body -> local (leaf-local slot * K + pos)
            sl = self.leaf_g2l(d)[
                side.box_to_slot[tree.body_leaf[
                    self.dev_lo[d] : self.dev_hi[d]
                ]]
            ]
            pos = (
                np.arange(self.dev_lo[d], self.dev_hi[d])
                - tree.box_body_start[
                    tree.body_leaf[self.dev_lo[d] : self.dev_hi[d]]
                ]
            )
            flat_slot.append((sl * K + pos).astype(np.int32))
            body_leaf_row.append(
                self.g2l[
                    d, tree.body_leaf[self.dev_lo[d] : self.dev_hi[d]]
                ].astype(np.int32)
            )
        self.leaf_body_idx = _pad_stack(lb_idx, 0, np.int32)
        self.leaf_body_mask = _pad_stack(lb_mask, False, bool)
        self.leaf_rows = _pad_stack(
            leaf_rows, self.SINK, np.int32, min_len=self.nl_max
        )
        # padded body slots -> appended zero row of the leaf result tile
        self.body_flat_slot = _pad_stack(
            flat_slot, self.nl_max * K, np.int32, min_len=self.nb_max
        )
        self.body_leaf_row = _pad_stack(
            body_leaf_row, self.ZERO_L, np.int32, min_len=self.nb_max
        )

    def _body_slice(self, arr, d, device):
        """Rank d's rows ``[dev_lo, dev_hi)`` of a per-body host array or
        tensor, zero-padded to ``nb_max`` rows, on ``device``."""
        lo, hi = int(self.dev_lo[d]), int(self.dev_hi[d])
        if isinstance(arr, torch.Tensor):
            seg = arr[lo:hi].to(device)
        else:
            seg = torch.as_tensor(np.ascontiguousarray(np.asarray(arr)[lo:hi]),
                                  device=device)
        if seg.is_floating_point():
            seg = seg.to(self.dtype)
        out = seg.new_zeros((self.nb_max,) + tuple(seg.shape[1:]))
        out[: hi - lo] = seg
        return out

    # ------------------------------------------------------------------
    # device data (per rank; per p and BC variant)
    # ------------------------------------------------------------------
    def _rank_tables(self):
        """The p- and variant-independent index tensors of every rank,
        on its device (built once)."""
        if self._rank_common is not None:
            return self._rank_common
        names = ["m2l_src", "m2l_cls", "leaf_body_idx", "leaf_rows",
                 "body_flat_slot", "body_leaf_row", "m_export_rows",
                 "m_import_pos", "q_export_rows", "q_import_pos"]
        if self.ndcn > 1:
            names += ["m_exp_intra", "m_exp_inter", "q_exp_intra",
                      "q_exp_inter"]
        if self.has_m2p:
            names += ["m2p_rows", "m2p_tslot"]
        tables = []
        for d, dev in enumerate(self.devices):
            t = {k: _index(getattr(self, k)[d], dev) for k in names}
            if self.ndcn > 1:
                # the two-level positions replace the one-level ones
                t["m_import_pos"] = _index(self.m_import_pos2[d], dev)
                t["q_import_pos"] = _index(self.q_import_pos2[d], dev)
            t["leaf_body_mask"] = torch.as_tensor(
                self.leaf_body_mask[d], device=dev)
            t["body_valid"] = torch.as_tensor(
                np.arange(self.nb_max) < self.dev_hi[d] - self.dev_lo[d],
                device=dev)
            t["m2l_bsum"] = self.m2l_bsum.rank(d, dev, self.dtype)
            t["lvl_loc"] = [
                [None if e is None else
                 (_index(e[0][d], dev), _index(e[1][d], dev))
                 for e in per_class]
                for per_class in self.levels_local
            ]
            t["lvl_sh"] = self._on_device(dev)["lvl_sh"]
            tables.append(t)
        self._rank_common = tables
        return tables

    def _on_device(self, dev, p=None):
        """Tensors every rank on ``dev`` reads alike, built once per
        device: the shared top's level lists, and (with ``p``) the
        translation matrices prefix-sliced to width(p)."""
        key = (str(dev), p)
        if key not in self._shared_cache:
            plan = self.plan
            if p is None:
                val = {"lvl_sh": [
                    [None if e is None else
                     (_index(e[0], dev), _index(e[1], dev))
                     for e in per_class]
                    for per_class in self.levels_shared
                ]}
            else:
                def mats(m):
                    return torch.as_tensor(
                        np.ascontiguousarray(plan._slice_mats(m, p)),
                        dtype=self.dtype, device=dev)

                val = {"m2m_mats": mats(plan.src.m2m_mats),
                       "l2l_mats": mats(plan.tgt.l2l_mats),
                       "m2l_mats": mats(plan.m2l_classes.mats)}
            self._shared_cache[key] = val
        return self._shared_cache[key]

    def _variant_fields(self, tgt_fields_host):
        if tgt_fields_host is not None:
            return tgt_fields_host
        return self.plan._flipped_fields() if self.flipped \
            else self.plan.src.fields

    def _operand(self, p, tgt_fields_host=None):
        """Per-rank operand dicts for order ``p`` and a BC variant (the
        plan's own, flipped with ``flipped``, or ``tgt_fields_host``).
        Returns (list of per-rank dicts, p, cW)."""
        plan = self.plan
        key = (
            int(p),
            None
            if tgt_fields_host is None
            else np.asarray(tgt_fields_host["bc"]).tobytes(),
        )
        if key in self._op_cache:
            return self._op_cache[key]
        p = min(int(p), plan.config.max_p)
        tfh = self._variant_fields(tgt_fields_host)
        aux = plan.variant_aux(p, src_host=tfh, tgt_host=tfh)
        cW = plan.kernel.ncomp * plan.kernel.width(p)
        panels = self._near_panels_local(tfh) if self.use_panels else None
        need_fields = (self.use_p2p or self.has_m2p
                       or "p2m_tab" not in aux or "l2p_tab" not in aux)
        host_fields = {k: np.asarray(v) for k, v in tfh.items()
                       if k != "vertices"}
        ops = []
        for d, dev in enumerate(self.devices):
            o = dict(self._rank_tables()[d])
            o.update(self._on_device(dev, p))
            if "p2m_tab" in aux:
                tab = aux["p2m_tab"]  # [n, cW] or [cdim, n, cW]
                if tab.ndim == 2:
                    o["p2m_tab"] = self._body_slice(tab, d, dev)
                else:
                    o["p2m_tab"] = torch.stack(
                        [self._body_slice(t, d, dev) for t in tab])
            if "l2p_tab" in aux:
                o["l2p_tab"] = self._body_slice(aux["l2p_tab"], d, dev)
            if panels is not None:
                o["panels"], o["near_meta"] = panels[d]
            if need_fields:
                o["fields"] = {k: self._body_slice(v, d, dev)
                               for k, v in host_fields.items()}
            if "p2m_tab" not in aux or "l2p_tab" not in aux:
                o["body_dnorm"] = self._body_slice(
                    plan.src.body_dnorm, d, dev)
                o["body_inv_sigma"] = self._body_slice(
                    plan.src.body_inv_sigma, d, dev)
            if self.use_p2p:
                o.update(self._p2p_tables(d, dev, host_fields))
            if self.has_m2p:
                o["m2p_isig"] = torch.as_tensor(
                    self.m2p_isig[d], dtype=self.dtype, device=dev)
                o["m2p_center"] = torch.as_tensor(
                    plan.src.tree.box_center[self.m2p_srcbox[d]],
                    dtype=self.dtype, device=dev)
            ops.append(o)
        self._op_cache[key] = (ops, p, cW)
        if len(self._op_cache) > 6:
            self._op_cache.pop(next(iter(self._op_cache)))
        return self._op_cache[key]

    def _p2p_tables(self, d, dev, host_fields):
        """Rank d's point-P2P inputs: source-leaf FIELD tiles and masks
        over the charge-table columns [own | import | zero], its pair
        lists (local charge-table columns, local target leaves) and its
        target-leaf field tiles."""
        plan = self.plan
        own_ls, imp_ls = self.dev_leaf_slots[d], self.imp_leaves[d]
        pad_own = self.nl_max - len(own_ls)
        pad_imp = self.n_limp_max - len(imp_ls) + 1

        def columns(tiles):
            z = np.zeros((1,) + tiles.shape[1:], tiles.dtype)
            return np.concatenate([
                tiles[own_ls], np.repeat(z, pad_own, 0),
                tiles[imp_ls], np.repeat(z, pad_imp, 0)])

        out = {"src_leaf_fields": {}, "tgt_leaf_fields": {}}
        lo, hi = int(self.dev_lo[d]), int(self.dev_hi[d])
        for k, v in host_fields.items():
            out["src_leaf_fields"][k] = torch.as_tensor(
                columns(v[plan.src.leaf_body_idx]), dtype=self.dtype,
                device=dev)
            body = np.zeros((self.nb_max,) + v.shape[1:], v.dtype)
            body[: hi - lo] = v[lo:hi]
            out["tgt_leaf_fields"][k] = torch.as_tensor(
                body[self.leaf_body_idx[d]], dtype=self.dtype, device=dev)
        out["src_leaf_mask"] = torch.as_tensor(
            columns(plan.src.leaf_body_mask), device=dev)
        sel = self.pair_dev == d
        out["p2p_src_col"] = _index(
            self.src_l2c[d, plan.p2p_src_slot[sel]], dev)
        out["p2p_tgt_loc"] = _index(
            self.leaf_g2l(d)[plan.p2p_tgt_slot[sel]], dev)
        return out

    # ------------------------------------------------------------------
    # the distributed matvec
    # ------------------------------------------------------------------
    def _local_matvec(self, d, q_loc, p, cW):
        """One rank's matvec: a generator that yields
        ``(op, axis, tensor)`` at each collective, is sent its
        share of the result, and returns the rank's results
        [nb_max, rdim] (padded rows zero).  ``d`` is the rank's operand
        dict, ``q_loc`` its block of the padded charges."""
        plan = self.plan
        kern = plan.kernel
        AX = self.AXIS
        K = self.K
        cdim, rdim = self.cdim, self.rdim
        KSc = K * cdim
        ncomp = kern.ncomp
        W = cW // ncomp
        dev = q_loc.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=dev)

        # ---- 1. leaf charge tiles + halo all_gather
        qg = q_loc[d["leaf_body_idx"]]
        if cdim > 1:
            qg = torch.where(d["leaf_body_mask"][..., None], qg, 0.0)
            ql_own = qg.reshape(qg.shape[0], KSc)
        else:
            ql_own = torch.where(d["leaf_body_mask"], qg, 0.0)
        ql_own_z = torch.cat([ql_own, zeros(1, KSc)])
        if self.ndcn > 1:
            # hierarchical halo: intra-group tiles ride the inner axis
            # only; the all-rank gather carries just the leaves some
            # other group imports
            gi = yield ("all_gather", AX, ql_own_z[d["q_exp_intra"]])
            ge = yield ("all_gather", (self.AXIS_DCN, AX),
                        ql_own_z[d["q_exp_inter"]])
            gathered = torch.cat(
                [gi.reshape(-1, KSc), ge.reshape(-1, KSc), zeros(1, KSc)])
        else:
            g = yield ("all_gather", AX, ql_own_z[d["q_export_rows"]])
            gathered = torch.cat([g.reshape(-1, KSc), zeros(1, KSc)])
        imports = gathered[d["q_import_pos"]]
        # charge table [own | import | zero]
        xq = torch.cat([ql_own, imports, zeros(1, KSc)])

        # ---- 2. P2M + local M2M
        if "p2m_tab" in d:
            tab = d["p2m_tab"]
            if q_loc.ndim == 1:
                contrib = q_loc[:, None] * tab
            else:
                contrib = torch.einsum("nc,cnw->nw", q_loc, tab)
        else:
            contrib = kern.p2m(
                d["fields"], q_loc, d["body_dnorm"], d["body_inv_sigma"], p
            ).reshape(-1, cW)
        ct = contrib[d["leaf_body_idx"]]
        ct = torch.where(d["leaf_body_mask"][..., None], ct, 0.0)
        # padded leaf rows add into SINK; padded child gathers read the
        # ZERO row, which nothing ever writes: no resets needed
        M = zeros(self.R, cW).index_add_(0, d["leaf_rows"], ct.sum(dim=1))
        for lvl in range(self.num_levels - 1, 0, -1):
            for c in range(8):
                e = self.levels_local[lvl - 1][c]
                if e is None:
                    continue
                ch, pa = d["lvl_loc"][lvl - 1][c]
                M.index_add_(
                    0, pa, apply_flat_trans(M[ch], d["m2m_mats"][e[2]], ncomp)
                )

        # ---- 3./4. shared top: psum + replicated M2M
        AX_ALL = (self.AXIS_DCN, AX) if self.ndcn > 1 else AX
        if self.n_sh:
            sh = yield ("psum", AX_ALL, M[: self.n_sh])
            M[: self.n_sh] = sh
            for lvl in range(self.num_levels - 1, 0, -1):
                for c in range(8):
                    e = self.levels_shared[lvl - 1][c]
                    if e is None:
                        continue
                    ch, pa = d["lvl_sh"][lvl - 1][c]
                    M.index_add_(
                        0, pa, apply_flat_trans(M[ch], d["m2m_mats"][e[2]],
                                                ncomp)
                    )

        # ---- 5. LET halo: export owned multipoles, import remote ones
        if self.ndcn > 1:
            gi = yield ("all_gather", AX, M[d["m_exp_intra"]])
            ge = yield ("all_gather", (self.AXIS_DCN, AX),
                        M[d["m_exp_inter"]])
            gm = torch.cat(
                [gi.reshape(-1, cW), ge.reshape(-1, cW), zeros(1, cW)])
        else:
            g = yield ("all_gather", AX, M[d["m_export_rows"]])
            gm = torch.cat([g.reshape(-1, cW), zeros(1, cW)])
        lo_imp = self.n_sh + self.n_own_max
        M[lo_imp : lo_imp + self.n_imp_max] = gm[d["m_import_pos"]]

        # ---- 6. M2L tiles + bucketed reduction into local L
        if self.has_m2l:
            TS = plan.m2l_tile_size
            npairs = self.m2l_ntile * TS
            # component axis folded into matmul rows (see plan._phase_m2l)
            Mg = M[d["m2l_src"]].reshape(self.m2l_ntile, TS * ncomp, W)
            mats = d["m2l_mats"][d["m2l_cls"]]  # [ntile, W, W]
            outp = torch.einsum("tpw,tvw->tpv", Mg, mats).reshape(npairs, cW)
            L_red = bucket_sum_apply(d["m2l_bsum"], outp)  # [R_red, cW]
        else:
            L_red = zeros(self.R_red, cW)

        near_leaf = None
        if self.use_panels:
            near_leaf = panel_matvec(d["panels"], d["near_meta"], xq)
        p2p_leaf = None
        if self.use_p2p:
            p2p_leaf = self._p2p_local(d, xq)

        if self.n_sh:
            # ---- 7. shared-L psum
            shL = yield ("psum", AX_ALL, L_red[: self.n_sh])
            L_red[: self.n_sh] = shL

        L = torch.cat([L_red, zeros(2, cW)])  # + ZERO_L, SINK_L

        if plan.config.evaluator.value == "fmm":
            # ---- 8. shared L2L (replicated), then local L2L top-down
            for lvl in range(1, self.num_levels):
                for c in range(8):
                    e = self.levels_shared[lvl - 1][c]
                    if e is not None:
                        ch, pa = d["lvl_sh"][lvl - 1][c]
                        L.index_add_(
                            0, ch,
                            apply_flat_trans(L[pa], d["l2l_mats"][e[2]],
                                             ncomp))
                for c in range(8):
                    e = self.levels_local[lvl - 1][c]
                    if e is not None:
                        ch, pa = d["lvl_loc"][lvl - 1][c]
                        # local lists carry M-table pad rows (ZERO/SINK
                        # beyond R_red); clamp onto the L layout's
                        # zero-read / garbage-sink rows
                        L.index_add_(
                            0, torch.clamp(ch, max=self.SINK_L),
                            apply_flat_trans(
                                L[torch.clamp(pa, max=self.ZERO_L)],
                                d["l2l_mats"][e[2]], ncomp))
            Lb = L[d["body_leaf_row"]]
            if "l2p_tab" in d:
                res = torch.einsum("nw,nwr->nr", Lb, d["l2p_tab"])
            else:
                res = kern.l2p(
                    d["fields"], Lb.reshape(-1, ncomp, W),
                    d["body_dnorm"], d["body_inv_sigma"], p,
                )
        else:
            res = zeros(self.nb_max, rdim)

        # ---- M2P (treecode / skew fallback)
        if self.has_m2p:
            res = res + self._m2p_local(d, M, p, W)

        # near results -> body rows (panel_matvec already applied the
        # leaf reorder: [nl_max, KT*rdim])
        for leaf in (near_leaf, p2p_leaf):
            if leaf is not None:
                rows = torch.cat(
                    [leaf.reshape(self.nl_max * K, rdim), zeros(1, rdim)])
                res = res + rows[d["body_flat_slot"]]
        # padded body rows stay exactly zero: the padded layout is the
        # solver's vector, where they must not count
        return torch.where(d["body_valid"][:, None], res, 0.0)

    def _p2p_local(self, d, xq):
        """Point P2P of one rank: the kernel's ``p2p_block`` over chunks
        of ``config.p2p_chunk`` local pairs, summed per target leaf.
        Returns [nl_max, K * rdim]."""
        plan = self.plan
        kern = plan.kernel
        K, cdim = self.K, self.cdim
        scol, tloc = d["p2p_src_col"], d["p2p_tgt_loc"]
        # padded pairs point at the dropped segment nl_max; their target
        # rows read a real tile (the charges are the zero column's)
        trow = torch.clamp(tloc, max=self.nl_max - 1)
        block = torch.vmap(kern.p2p_block)
        seg = torch.zeros((self.nl_max + 1, K, self.rdim), dtype=self.dtype,
                          device=xq.device)
        npair = scol.shape[0]
        chunk = plan.config.p2p_chunk if plan.config.p2p_chunk > 0 else npair
        for c0 in range(0, npair, chunk):
            sc, tl = scol[c0 : c0 + chunk], tloc[c0 : c0 + chunk]
            mrow = d["src_leaf_mask"][sc]
            qgp = xq[sc]
            if cdim > 1:
                qgp = torch.where(mrow[..., None],
                                  qgp.reshape(-1, K, cdim), 0.0)
            else:
                qgp = torch.where(mrow, qgp, 0.0)
            vals = block(
                {k: v[trow[c0 : c0 + chunk]]
                 for k, v in d["tgt_leaf_fields"].items()},
                {k: v[sc] for k, v in d["src_leaf_fields"].items()},
                qgp, mrow,
            )
            seg.index_add_(0, tl, vals)
        return seg[: self.nl_max].reshape(self.nl_max, K * self.rdim)

    def _m2p_local(self, d, M, p, W):
        """M2P of one rank's pairs (treecode far field and skewed
        pairs), in chunks of ``config.p2p_chunk`` pairs, gathered back to
        the rank's body rows."""
        plan = self.plan
        kern = plan.kernel
        K = self.K
        tslot = d["m2p_tslot"]
        bidx_z = torch.cat(
            [d["leaf_body_idx"], d["leaf_body_idx"].new_zeros((1, K))])
        xyz = d["fields"]["xyz"]
        seg = torch.zeros((self.nl_max + 1, K, self.rdim), dtype=self.dtype,
                          device=M.device)
        npair = tslot.shape[0]
        chunk = plan.config.p2p_chunk if plan.config.p2p_chunk > 0 else npair
        for c0 in range(0, npair, chunk):
            sl = slice(c0, c0 + chunk)
            ts = tslot[sl]
            rows_b = bidx_z[ts]  # [P, K] local body ids
            P = ts.shape[0]
            isig = d["m2p_isig"][sl]
            dn = (xyz[rows_b] - d["m2p_center"][sl][:, None, :]) \
                * isig[:, None, None]
            Ms = M[d["m2p_rows"][sl]].reshape(P, 1, kern.ncomp, W).expand(
                P, K, kern.ncomp, W)
            vals = kern.m2p(
                {k: v[rows_b].reshape((P * K,) + tuple(v.shape[1:]))
                 for k, v in d["fields"].items()},
                Ms.reshape(P * K, kern.ncomp, W),
                dn.reshape(P * K, 3),
                isig[:, None].expand(P, K).reshape(P * K),
                p,
            )
            seg.index_add_(0, ts, vals.reshape(P, K, -1))
        rows = torch.cat([
            seg[: self.nl_max].reshape(self.nl_max * K, self.rdim),
            seg.new_zeros((1, self.rdim))])
        return rows[d["body_flat_slot"]]

    def _matvec(self, ops, q, p, cW):
        """The distributed matvec on the padded vector ``q``
        [ndev * nb_max(, cdim)]: each rank takes its block (a view where
        it shares the vector's device), the ranks run in lockstep
        between collectives, and their results are concatenated on the
        vector's device.  Returns [ndev * nb_max, rdim]."""
        nb = self.nb_max
        self.comm.start()
        bodies = [
            self._local_matvec(
                ops[r], q[r * nb : (r + 1) * nb].to(self.devices[r]), p, cW)
            for r in range(self.ndev)
        ]
        outs = _drive(bodies, self.comm)
        return torch.cat([o.to(q.device) for o in outs])

    def matvec_fn(self, p, tgt_fields_host=None):
        """The distributed matvec for order ``p`` and a BC variant:
        ``(fn, operand)`` with ``fn(operand, q)`` taking padded charges
        [ndev * nb_max(, cdim)] (zero-padded per range, on
        ``devices[0]``) to padded results [ndev * nb_max, rdim]."""
        ops, p_eff, cW = self._operand(p, tgt_fields_host)

        def fn(operand, q):
            return self._matvec(operand, q, p_eff, cW)

        return fn, ops

    # ------------------------------------------------------------------
    # layout conversion + public API
    # ------------------------------------------------------------------
    def _user_pos(self):
        """[n] position of each user-order body in the padded layout."""
        if self._pad_maps is None:
            plan = self.plan
            n = plan.src.tree.num_bodies
            pad_pos = np.zeros(n, np.int64)
            for d in range(self.ndev):
                lo, hi = self.dev_lo[d], self.dev_hi[d]
                pad_pos[lo:hi] = d * self.nb_max + np.arange(hi - lo)
            inv = np.argsort(plan.src.tree.perm)
            self._pad_maps = _index(pad_pos[inv], self.devices[0])
        return self._pad_maps

    def to_padded(self, q):
        """User-order charges [n(, cdim)] -> the padded Morton layout
        [ndev * nb_max(, cdim)] on ``devices[0]``."""
        q = torch.as_tensor(
            np.array(q) if isinstance(q, np.ndarray) else q,
            dtype=self.dtype, device=self.devices[0],
        )
        n = self.plan.src.tree.num_bodies
        q = q.reshape(n) if self.cdim == 1 else q.reshape(n, self.cdim)
        out = q.new_zeros((self.ndev * self.nb_max,) + tuple(q.shape[1:]))
        out[self._user_pos()] = q
        return out

    def from_padded(self, x):
        """Padded results [ndev * nb_max, ...] -> user order [n, ...] on
        ``devices[0]``."""
        x = torch.as_tensor(
            np.array(x) if isinstance(x, np.ndarray) else x,
            device=self.devices[0],
        )
        return x[self._user_pos()]

    def apply(self, q, p=None):
        """One distributed matvec; user order in, [n, rdim] user order
        out (a tensor on ``devices[0]``)."""
        p = int(p if p is not None else self.plan.config.max_p)
        fn, ops = self.matvec_fn(p)
        return self.from_padded(fn(ops, self.to_padded(q)))

    def solver_ops(self):
        """(matvec, operand_for_p) for ``solver/gmres.py::gmres_device``:
        vectors live in the padded Morton layout on ``devices[0]`` (the
        padded rows are zero on the way in and out, so they take no part
        in the dot products)."""
        rdim, cdim = self.rdim, self.cdim

        def operand_for_p(p):
            return self.matvec_fn(int(p))[1]

        def matvec(operand, x, p):
            fn, _ = self.matvec_fn(int(p))
            q = x if cdim == 1 else x.reshape(-1, cdim)
            out = fn(operand, q)
            return out[:, 0] if rdim == 1 else out.reshape(-1)

        return matvec, operand_for_p

    def stats(self):
        """Per-rank memory/work accounting (the scaling evidence)."""
        panel_bytes = 0
        if self.use_panels:
            stores = self._near_panels_local(self._variant_fields(None))
            panel_bytes = max(
                s["A"].numel() * s["A"].element_size() for s, _ in stores)
        W = self.plan.kernel.width(self.plan.config.max_p)
        cW = self.plan.kernel.ncomp * W
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return {
            "ndev": self.ndev,
            "bodies_per_dev": self.nb_max,
            "own_boxes_max": self.n_own_max,
            "shared_boxes": self.n_sh,
            "halo_boxes_max": self.n_imp_max,
            "halo_leaves_max": self.n_limp_max,
            "m2l_pairs_per_dev": int(self.m2l_ntile)
            * self.plan.m2l_tile_size,
            "near_panel_bytes_per_dev": int(panel_bytes),
            "expansion_bytes_per_dev": int(self.R * cW * itemsize),
            "halo_multipole_bytes": int(
                self.ndev * self.n_bexp_max * cW * itemsize
            ),
            "halo_charge_bytes": int(
                self.ndev * self.n_lexp_max * self.K * self.cdim * itemsize
            ),
        }


def rank_devices(ndev, device="cuda"):
    """One device per rank: ``cuda:r % count`` for the CUDA cards there
    are (ranks share them round robin; with one card, every rank is on
    it), else ``device`` for every rank."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * ndev
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(ndev)]

