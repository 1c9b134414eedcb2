"""FMM execution plan: tree + interaction lists + batched device matvec.

Re-design of the reference execution layer (include/FMM_plan.hpp +
include/executor/ExecutorSingleTree.hpp + EvalInteractionLazy*.hpp) for
PyTorch: one host-side *plan build* (numpy + the native helper)
materialises every charge-independent structure — the octree, the
traversal lists, the translation-class grouping, per-body normalised
offsets — and the per-iteration matvec replays them as batched tensor
ops on the plan's device:

    P2M   slot-ordered linear table contracted with the charge tiles
    M2M   octant-class matmuls per level, bottom-up
    M2L   family path (one dense [8W, 8W] operator per parent-offset
          class) + residual pair tiles, reduced by bucketed gather-sums
    L2L   octant-class matmuls per level, top-down
    L2P   slot-ordered linear table contracted with the leaf locals
    M2P   treecode far field, and fallback for level-skewed pairs
    near  BEM kernels: the cached leaf-panel store (ops/near_panel.py:
          the fused kernel for scalar entries, the two-stage route
          through the chunk-contraction kernel for the 3x3 blocks of
          Stokes BEM) or, with ``near_mode="otf"``, the regular
          quadrature recomputed per matvec (ops/otf_tile.py) plus a
          small cached store of near-singular correction deltas; point
          kernels: the direct leaf-pair P2P (ops/p2p_tile.py for the
          Laplace tile math, the kernel's own ``p2p_block`` otherwise).
          Each of the four hand-written CUDA kernels runs on the GPU
          and its plain version on the CPU.

The matvec runs in one of two layouts.  In the SLOT layout charges
and results live in padded leaf tiles end to end (``_matvec_slots``,
the solver's operator wherever the plan has one): scalar (Laplace BEM,
point Laplace) or vector-valued (Stokes BEM with 3-vector charges and
results, the point stokeslet): a kernel with ``charge_dim = c > 1``
sees its charges as ``[n, c]`` and the solver vector as the flattened
``[n*c]`` layout.  In BODY order (``_matvec``) charges come in and
results go out per body, gathered into leaf tiles for the near pass and
back: the layout of the plans without a slot operator — a dual-tree
plan (``target_fields``: a distinct target set with its own tree in
the sources' root box), the COO near-field replay
(``near_panel=False``, with its ``droptol``), a kernel whose charge
and result dimensions differ (the stresslet, point kernels with
forces).  Kernels whose translations are not scale-invariant
(the Yukawa kernels: kappa sets a length) get their M2M / L2L octant
matrices and M2L class and family operators per level.  The treecode
evaluator (``Evaluator.TREECODE``) replaces M2L / L2L / L2P by M2P from
the far boxes straight to the target leaves.  The near-field-only
operators (``FMMConfig.local_evaluation``: every near leaf pair;
``FMMConfig.block_diagonal``: the leaf self pairs only; ref
EvalLocalSparse / EvalDiagonalSparse) run the near pass alone, with no
far-field work at all.  A kernel without a linear P2M table (the
stresslet, ``linear_p2m = False``) runs its own ``p2m`` per matvec.

The relaxation hook (``K.set_p(p)`` in the reference, GMRES.hpp:195-196)
is an argument: every degree-ordered term dimension is prefix-sliced to
``width(p)``, so a smaller p genuinely costs less, with no table
rebuilds.

The table layouts (k-major P2M ``[K, nl, cW]``, w-major L2P
``[rdim, cW, nl, K]``, flat component-major expansions
``[nbox, ncomp*W]``) are the JAX package's, kept so that state carries
across array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fmm_bem_tpu_torch.config import Evaluator, FMMConfig
from fmm_bem_tpu_torch.ops.bucket_sum import bucket_sum_apply, build_bucket_sum
from fmm_bem_tpu_torch.ops.near_panel import (
    build_near_panels,
    build_near_panels_on_device,
    chunk_row_ptr,
    leaf_counts,
    panel_matvec,
)
from fmm_bem_tpu_torch.ops.otf_tile import (
    otf_leaf_tiles,
    pack_otf_src,
    pack_otf_tgt,
)
from fmm_bem_tpu_torch.ops.p2p_tile import (
    p2p_leaf_tiles,
    pack_xyzq,
    sorted_pair_rows,
)
from fmm_bem_tpu_torch.tree.octree import Tree, bounding_cube, build_tree
from fmm_bem_tpu_torch.traversal.lists import (
    InteractionLists,
    build_interaction_lists,
    expand_to_leaves,
)
from fmm_bem_tpu_torch.utils.metrics import log


#: correction-window store budget: beyond it the OTF mode keeps
#: padded-row entry lists instead (see FmmPlan._build_near_otf)
_OTF_WINDOW_LIMIT = 1 << 30


def apply_flat_trans(rows, mat, ncomp):
    """Translate FLAT [n, ncomp*W] expansions by a per-component [W, W]
    operator: ``rows @ kron(I_ncomp, mat).T`` without the kron.

    The flat layout is component-major, so folding the component axis
    into rows is a pure reshape and the matmul is [n*ncomp, W] x [W, W]
    — no structural zeros."""
    W = mat.shape[-1]
    if ncomp == 1:
        return rows @ mat.T
    n = rows.shape[0]
    return (rows.reshape(n * ncomp, W) @ mat.T).reshape(n, ncomp * W)


def check_kernel(kernel, config):
    """Validate the kernel's batched-operator protocol for the requested
    evaluation mode BEFORE any device work — the array-era analogue of
    the reference's compile-time capability check (FMM_plan.hpp:115-127,
    check_kernel via ExpansionTraits::is_valid_fmm/treecode).  A
    malformed kernel otherwise fails with an opaque error deep inside
    the matvec.
    """
    missing = []

    def need(attr, why, callable_=True):
        v = getattr(kernel, attr, None)
        if v is None or (callable_ and not callable(v)):
            missing.append(f"  .{attr}  — {why}")

    kname = type(kernel).__name__
    need("width", "expansion width(p) (terms per component)")
    need("ncomp", "expansion components per box", callable_=False)
    need("result_dim", "per-target result vector length", callable_=False)

    near_only = config.local_evaluation or config.block_diagonal
    if not near_only:
        need("p2m", "source -> multipole (ref ExpansionTraits has_P2M)")
        need("m2m_matrix", "child->parent translation (ref has_M2M)")
        if config.evaluator == Evaluator.FMM:
            need("m2l_matrix", "multipole->local translation (ref has_M2L)")
            need("m2l_pair_scale", "per-pair M2L kernel scale")
            need("l2l_matrix", "parent->child translation (ref has_L2L)")
            if not (
                callable(getattr(kernel, "l2p", None))
                or callable(getattr(kernel, "l2p_table", None))
            ):
                missing.append(
                    "  .l2p or .l2p_table  — local evaluation at targets"
                    " (ref has_L2P)"
                )
        # treecode far field and the skew-pair fallback both need M2P
        need("m2p", "multipole evaluation at targets (ref has_M2P)")

    # near field: precomputed sparse values (BEM) or direct P2P tiles
    if getattr(kernel, "near_sparse", False):
        need("near_values", "host assembly of near-field entries")
        need("near_select", "BC selection of near entries for the "
             "leaf-panel near field")
    else:
        need("p2p_block", "leaf-pair direct tile (ref KernelTraits"
             " has_eval_op / vector P2P)")

    if missing:
        mode = (
            "near-field-only" if near_only else config.evaluator.value
        )
        raise TypeError(
            f"kernel {kname} does not satisfy the batched operator "
            f"protocol for {mode} evaluation (ref FMM_plan.hpp:115-127 "
            f"check_kernel); missing:\n" + "\n".join(missing)
            + "\nsee fmm_bem_tpu_torch/kernels/laplace_bem.py for the protocol."
        )


@dataclasses.dataclass
class _ClassedPairs:
    """M2L pairs grouped by translation class.  Classes are keyed by
    (level gap, absolute source level, normalised offset), so the
    kernel's per-pair scale (a function of the source box size only)
    is CONSTANT per class and folded into the class matrix instead of
    being a per-pair multiply."""

    src: list          # per-class source box ids (source tree)
    tgt: list          # per-class target box ids (target tree)
    mats: np.ndarray   # [ncls, W, W], kernel scale folded in


@dataclasses.dataclass
class _M2LFamilies:
    """Same-level M2L pairs regrouped by (source-parent, target-parent).

    A family's child pairs share ONE dense [8W, 8W] class operator (64
    child-translation blocks, zeroed where the combo is near-field),
    keyed by the quantised parent offset: with the tie-consistent MAC
    (traversal/lists.py) the per-family combo set is exactly
    ``class_union_mask & existing_children`` — verified at build, with
    deviant families demoted to the residual tile path.  Missing source
    children contribute zero rows; missing target children are dropped
    by the output gather.  Motive: a per-pair expansion gather moves
    sub-cache-line rows in class order; family rows are 8x wider and
    far fewer, and the per-class [F_c*ncomp, 8W] x [8W, 8W] products
    are real matmuls.
    """

    #: [nusp, 8] child box id per used source parent (-1 = missing)
    src_child: np.ndarray
    #: [nusp] per-pair kernel scale (m2l_pair_scale of the child sigma),
    #: folded into the staging so class operators are level-free for
    #: scale-invariant kernels
    src_scale: np.ndarray
    #: per class: rows into the used-source-parent table [F_c_pad]
    cls_sp: list
    #: per class: target-parent rows [F_c_pad] (dummy = nutp)
    cls_tp: list
    #: [ncls, 8, Wm, 8, Wm] class operators (combo blocks, masked)
    mats: np.ndarray
    #: [num_tgt_boxes] row into the [nutp*8] family-output table
    #: (dummy = nutp*8 for boxes not covered by the family path)
    out_idx: np.ndarray
    #: family -> target-parent reduction plan (class-concatenated order)
    bsum: object
    nusp: int
    nutp: int
    #: diagnostics
    npairs: int


@dataclasses.dataclass
class _TreeSide:
    """Per-tree executor structures (leaf tiles, body offsets, octant
    classes) — one for the source side, one for the target side (same
    object in the single-tree case)."""

    tree: Tree
    fields: dict
    leaf_ids: np.ndarray
    box_to_slot: np.ndarray
    leaf_pad: int
    leaf_body_idx: np.ndarray
    leaf_body_mask: np.ndarray
    body_flat_slot: np.ndarray
    body_dnorm: np.ndarray
    body_inv_sigma: np.ndarray
    body_leaf_box: np.ndarray
    #: per level: class -> (child_ids, parent_ids, mat_idx) or None
    levels: list
    m2m_mats: np.ndarray
    l2l_mats: np.ndarray


def _build_side(tree, fields, kern, pmax, scale_inv, leaf_pad=None):
    n = tree.num_bodies
    leaves = tree.leaves.astype(np.int32)
    nl = len(leaves)
    box_to_slot = np.full(tree.num_boxes, -1, dtype=np.int32)
    box_to_slot[leaves] = np.arange(nl, dtype=np.int32)
    K = int(tree.box_body_count[leaves].max())
    if leaf_pad is not None:
        # pinned leaf-tile width: keeps P2P/near block shapes constant
        # across problem sizes (scaling sweeps) and across LET shards
        if leaf_pad < K:
            raise ValueError(
                f"config.leaf_pad={leaf_pad} < max leaf occupancy {K}"
            )
        K = int(leaf_pad)
    counts = tree.box_body_count[leaves]
    starts = tree.box_body_start[leaves]
    pos = np.arange(K)[None, :]
    mask = pos < counts[:, None]
    idx = np.where(mask, starts[:, None] + pos, 0).astype(np.int32)
    slot_of_body = box_to_slot[tree.body_leaf]
    pos_of_body = np.arange(n) - tree.box_body_start[tree.body_leaf]
    flat_slot = (slot_of_body * K + pos_of_body).astype(np.int32)

    sigma_b = tree.box_radius[tree.body_leaf]
    dnorm = (tree.points - tree.box_center[tree.body_leaf]) / sigma_b[:, None]

    # octant classes for M2M (this tree as source) and L2L (as target)
    child_boxes = np.arange(1, tree.num_boxes, dtype=np.int32)
    octant = None
    if len(child_boxes):
        par = tree.box_parent[child_boxes]
        off = tree.box_center[child_boxes] - tree.box_center[par]
        octant = (
            (off[:, 0] > 0).astype(np.int32)
            + 2 * (off[:, 1] > 0).astype(np.int32)
            + 4 * (off[:, 2] > 0).astype(np.int32)
        )
    m2m_mats, l2l_mats, levels = [], [], []
    mat_key = {}
    for lvl in range(1, tree.num_levels):
        lo, hi = tree.level_offset[lvl], tree.level_offset[lvl + 1]
        ids = child_boxes[(child_boxes >= lo) & (child_boxes < hi)]
        per_class = []
        for c in range(8):
            sel = ids[octant[ids - 1] == c]
            if len(sel) == 0:
                per_class.append(None)
                continue
            key = (None if scale_inv else lvl, c)
            if key not in mat_key:
                b = int(sel[0])
                pb = int(tree.box_parent[b])
                sig_c = tree.box_radius[b]
                sig_p = tree.box_radius[pb]
                drm = tree.box_center[pb] - tree.box_center[b]
                mat_key[key] = len(m2m_mats)
                m2m_mats.append(kern.m2m_matrix(drm, sig_c, sig_p, pmax))
                l2l_mats.append(kern.l2l_matrix(-drm, sig_p, sig_c, pmax))
            per_class.append(
                (
                    sel.astype(np.int32),
                    tree.box_parent[sel].astype(np.int32),
                    mat_key[key],
                )
            )
        levels.append(per_class)
    W = kern.width(pmax)
    if not m2m_mats:
        m2m_mats = [np.eye(W)]
        l2l_mats = [np.eye(W)]
    return _TreeSide(
        tree=tree,
        fields=fields,
        leaf_ids=leaves,
        box_to_slot=box_to_slot,
        leaf_pad=K,
        leaf_body_idx=idx,
        leaf_body_mask=mask,
        body_flat_slot=flat_slot,
        body_dnorm=dnorm,
        body_inv_sigma=1.0 / sigma_b,
        body_leaf_box=tree.body_leaf.astype(np.int32),
        levels=levels,
        m2m_mats=np.stack(m2m_mats),
        l2l_mats=np.stack(l2l_mats),
    )


def _widen_tiles(idx, mask, K):
    """Leaf tiles ``idx`` / ``mask`` [nl, K0] widened to K >= K0
    columns of padded slots (index 0, mask False)."""
    pad = K - idx.shape[1]
    if pad == 0:
        return idx, mask
    return (
        np.pad(idx, ((0, 0), (0, pad))),
        np.pad(mask, ((0, 0), (0, pad)), constant_values=False),
    )


def _check_supported(config):
    """Raise at plan build, never deep in a matvec, for a near mode the
    plan does not know."""
    if config.near_mode not in ("cached", "otf"):
        raise ValueError(
            f"FMMConfig.near_mode={config.near_mode!r}: expected 'cached' "
            "or 'otf'"
        )


class FmmPlan:
    """FMM matvec plan (single or dual tree) for a BEM panel
    kernel (cached or on-the-fly near field) or a point kernel (direct
    P2P near field).

    Parameters
    ----------
    kernel : kernel object following the batched operator protocol
        (p2m / l2p or l2p_table / m2p / the *_matrix functions, and
        near_values + near_select + near_block_device for a BEM kernel
        or p2p_block for a point kernel).
    fields : dict of per-body numpy arrays; must contain "xyz" [N,3].
        Extra arrays (panel normals, areas, BC flags, ...) are permuted
        into Morton order and passed to the kernel's batched operators.
    config : FMMConfig.
    target_fields : optional dict for a distinct target point set
        (dual-tree mode, ref ExecutorDualTree.hpp): both trees share the
        root box of sources and targets together.  Charges are indexed
        by sources, results by targets.
    device : where the device tables live and the matvec runs
        (default ``"cuda"``; CPU runs ask for ``"cpu"``).
    """

    def __init__(
        self,
        kernel,
        fields,
        config: Optional[FMMConfig] = None,
        target_fields=None,
        device="cuda",
    ):
        from fmm_bem_tpu_torch import resolve_device, torch_dtype

        self.kernel = kernel
        self.config = config or FMMConfig()
        cfg = self.config
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        _check_supported(cfg)
        check_kernel(kernel, cfg)
        scale_inv = getattr(kernel, "scale_invariant", True)

        src_xyz = np.asarray(fields["xyz"], dtype=np.float64)
        self.dual = target_fields is not None
        if self.dual:
            # one root box around both sets: the M2L classes and the
            # near list compare boxes of the two trees by level
            tgt_xyz = np.asarray(target_fields["xyz"], dtype=np.float64)
            pmin, side = bounding_cube(np.concatenate([src_xyz, tgt_xyz]))
            stree = build_tree(src_xyz, cfg.ncrit, cfg.max_level, pmin, side)
            ttree = build_tree(tgt_xyz, cfg.ncrit, cfg.max_level, pmin, side)
        else:
            stree = self._single_tree(src_xyz, cfg)
            ttree = stree

        self.lists: InteractionLists = build_interaction_lists(
            stree, cfg.theta, tgt_tree=ttree if self.dual else None,
            treecode=cfg.evaluator == Evaluator.TREECODE,
        )
        sfields = {k: np.asarray(v)[stree.perm] for k, v in fields.items()}
        tfields = (
            {k: np.asarray(v)[ttree.perm] for k, v in target_fields.items()}
            if self.dual else sfields
        )

        pmax = cfg.max_p
        with log.phase("build.sides"):
            self.src = _build_side(
                stree, sfields, kernel, pmax, scale_inv,
                leaf_pad=cfg.leaf_pad,
            )
            self.tgt = (
                _build_side(
                    ttree, tfields, kernel, pmax, scale_inv,
                    leaf_pad=cfg.leaf_pad,
                )
                if self.dual else self.src
            )
        with log.phase("build.m2l_classes"):
            self._build_m2l_classes()
        with log.phase("build.near"):
            self._build_near()
        # value caches: device tables per order / per BC variant
        self._ddata_common = None
        self._ddata_cache = {}
        self._fields_id_cache = {}
        self._aux_cache = {}
        self._aux_slots_cache = {}
        self._p2m_tab_cache = {}
        self._l2p_tab_cache = {}
        self._flipped_host = None
        self._slot_maps = None

    @staticmethod
    def _single_tree(src_xyz, cfg):
        """The single tree, with the ``auto_ncrit`` retune (the dual
        plan keeps its two trees as built)."""
        stree = build_tree(src_xyz, cfg.ncrit, cfg.max_level)
        # pad-pathology guard: every leaf tile is padded to the
        # MAXIMUM leaf occupancy, so one full leaf against a low
        # mean multiplies every near tile by the ratio (e.g. ncrit
        # 125, mean occupancy ~33, one 125-body leaf).  When the ratio
        # blows past 2x, rebuild once with ncrit ~ 2x the mean
        # (the reference ships tests/ncrit_search.cpp for exactly
        # this tuning; here the plan self-tunes).
        if cfg.auto_ncrit and cfg.leaf_pad is None:
            occ = stree.box_body_count[stree.box_is_leaf]
            mean_occ = float(occ.mean())
            if (
                len(occ)
                and occ.max() > 2.0 * mean_occ
                and mean_occ >= 8.0
            ):
                ncrit2 = max(8, int(np.ceil(2.0 * mean_occ)))
                if ncrit2 < cfg.ncrit:
                    tree2 = build_tree(src_xyz, ncrit2, cfg.max_level)
                    occ2 = tree2.box_body_count[tree2.box_is_leaf]
                    # keep the retuned tree only if it shrinks the
                    # padded-slot total (a full leaf at max depth
                    # cannot split, and then the rebuild only
                    # churns the rest of the tree)
                    if len(occ2) * occ2.max() < len(occ) * occ.max():
                        import warnings

                        warnings.warn(
                            f"leaf occupancy max {int(occ.max())} "
                            f"vs mean {mean_occ:.1f}: padding "
                            f"would waste >2x; retuned ncrit="
                            f"{ncrit2} (was {cfg.ncrit}).  Pass "
                            f"auto_ncrit=False or an explicit "
                            f"leaf_pad to keep the original.",
                            stacklevel=4,
                        )
                        stree = tree2

        return stree

    # convenience accessors (single-tree compatibility)
    @property
    def tree(self):
        return self.src.tree

    @property
    def fields(self):
        return self.src.fields

    @property
    def leaf_pad(self):
        return self.src.leaf_pad

    @property
    def near_only(self):
        """A near-field-only operator (local evaluation or block
        diagonal): its matvec is the near pass alone."""
        return bool(
            self.config.local_evaluation or self.config.block_diagonal
        )

    @property
    def leaf_ids(self):
        return self.src.leaf_ids

    # ------------------------------------------------------------------
    # host-side build
    # ------------------------------------------------------------------
    def _build_m2l_classes(self):
        st = self.src.tree
        tt = self.tgt.tree
        kern = self.kernel
        pmax = self.config.max_p
        pairs = self.lists.m2l_pairs
        m2p_extra_s, m2p_extra_t = [], []

        if len(pairs):
            s, tg = pairs[:, 0], pairs[:, 1]
            sig_s = st.box_radius[s]
            sig_t = tt.box_radius[tg]
            # route pairs whose target is much larger than the source to
            # the M2P path: their normalised offsets are unbounded and
            # would explode the class count
            skew = sig_t > 2.0 * sig_s + 1e-12
            if skew.any():
                leaves, rows = expand_to_leaves(tt, tg[skew])
                m2p_extra_s.append(s[skew][rows])
                m2p_extra_t.append(leaves)
                s, tg, sig_s, sig_t = (
                    s[~skew],
                    tg[~skew],
                    sig_s[~skew],
                    sig_t[~skew],
                )
        else:
            s = np.zeros(0, dtype=np.int32)
            tg = s
            sig_s = np.zeros(0)
            sig_t = sig_s

        src_list, tgt_list, mats = [], [], []
        cls_of_pair = []
        if len(s):
            offn = (tt.box_center[tg] - st.box_center[s]) / sig_s[:, None]
            ki = np.round(offn * 64.0).astype(np.int64) + 4096
            # pairs whose normalised offset escapes the class-key range
            # (extreme level skew past the 2-sigma guard above) degrade
            # to the M2P path instead of crashing plan build
            over = ((ki < 0) | (ki >= 8192)).any(axis=1)
            if over.any():
                leaves, rows = expand_to_leaves(tt, tg[over])
                m2p_extra_s.append(s[over][rows])
                m2p_extra_t.append(leaves)
                keep = ~over
                s, tg = s[keep], tg[keep]
                sig_s, sig_t = sig_s[keep], sig_t[keep]
                offn, ki = offn[keep], ki[keep]
        if len(s):
            dlvl = (
                st.box_level[s].astype(np.int64)
                - tt.box_level[tg].astype(np.int64)
                + 8
            )
            # the key includes the ABSOLUTE source level (not just the
            # gap) for every kernel: non-scale-invariant kernels
            # (Yukawa) need per-level matrices anyway, and for the rest
            # it makes the per-pair kernel scale class-constant so it
            # folds into the matrix (see _ClassedPairs)
            lkey = dlvl * 16 + st.box_level[s].astype(np.int64)
            key = ((lkey * 8192 + ki[:, 0]) * 8192 + ki[:, 1]) * 8192 + ki[:, 2]
            uniq, inv = np.unique(key, return_inverse=True)
            order = np.argsort(inv, kind="stable")
            bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
            for ci in range(len(uniq)):
                sel = order[bounds[ci] : bounds[ci + 1]]
                rep = sel[0]
                drm = tt.box_center[tg[rep]] - st.box_center[s[rep]]
                scale_c = float(
                    np.asarray(
                        kern.m2l_pair_scale(sig_s[rep : rep + 1])
                    ).reshape(-1)[0]
                )
                mats.append(
                    scale_c
                    * kern.m2l_matrix(drm, sig_s[rep], sig_t[rep], pmax)
                )
                src_list.append(s[sel].astype(np.int32))
                tgt_list.append(tg[sel].astype(np.int32))
        W = kern.width(pmax)
        mats_arr = np.stack(mats) if mats else np.zeros((0, W, W))
        self.m2l_classes = _ClassedPairs(
            src=src_list, tgt=tgt_list, mats=mats_arr
        )
        # family regrouping (same-level pairs); the LET layer keeps
        # consuming the full m2l_classes above, the single-device matvec
        # runs family path + residual tiles
        self.m2l_fam = None
        keep_res = None
        if len(s) and self.config.m2l_family:
            keep_res = self._build_m2l_families(s, tg, inv)
        if self.m2l_fam is not None:
            self._build_m2l_tiles(
                subset=(s[keep_res], tg[keep_res], inv[keep_res])
            )
        else:
            self._build_m2l_tiles()

        # ---- M2P list: treecode far field + skew fallback
        mp = self.lists.m2p_pairs
        parts_s = [mp[:, 0]] + m2p_extra_s
        parts_t = [mp[:, 1]] + m2p_extra_t
        ms = np.concatenate(parts_s).astype(np.int32)
        mt = np.concatenate(parts_t).astype(np.int32)
        self.m2p_src = ms
        self.m2p_tgt_slot = self.tgt.box_to_slot[mt].astype(np.int32)
        self.m2p_inv_sigma = (
            1.0 / st.box_radius[ms] if len(ms) else np.zeros(0)
        )

    @staticmethod
    def _octants(tree, boxes):
        """Child octant (0..7, x|y<<1|z<<2 by center offset sign) of
        each box within its parent."""
        par = tree.box_parent[boxes]
        off = tree.box_center[boxes] - tree.box_center[par]
        return (
            (off[:, 0] > 0).astype(np.int64)
            + 2 * (off[:, 1] > 0).astype(np.int64)
            + 4 * (off[:, 2] > 0).astype(np.int64)
        )

    def _build_m2l_families(self, s, tg, cls_of_pair):
        """Group same-level M2L pairs into (source-parent, target-parent)
        families sharing a dense per-offset-class [8W, 8W] operator (see
        _M2LFamilies).  Returns the boolean residual-pair selector for
        the tile path, or None (sets ``self.m2l_fam``)."""
        del cls_of_pair  # families re-key by PARENT offset
        st, tt = self.src.tree, self.tgt.tree
        kern = self.kernel
        pmax = self.config.max_p
        scale_inv = getattr(kern, "scale_invariant", True)

        sl = st.box_level[s]
        tl = tt.box_level[tg]
        sp = st.box_parent[s]
        tp = tt.box_parent[tg]
        cand = (sl == tl) & (sp >= 0) & (tp >= 0)
        if not cand.any():
            return None
        ci_ = np.nonzero(cand)[0]
        o_s = self._octants(st, s[ci_])
        o_t = self._octants(tt, tg[ci_])
        fam_key = sp[ci_].astype(np.int64) * tt.num_boxes + tp[ci_]
        uf, fam_inv = np.unique(fam_key, return_inverse=True)
        combo = (o_s * 8 + o_t).astype(np.uint64)
        fmask = np.zeros(len(uf), dtype=np.uint64)
        np.bitwise_or.at(fmask, fam_inv, np.uint64(1) << combo)

        fam_sp = (uf // tt.num_boxes).astype(np.int64)
        fam_tp = (uf % tt.num_boxes).astype(np.int64)
        rp = st.box_radius[fam_sp]
        dvec = tt.box_center[fam_tp] - st.box_center[fam_sp]
        ki = np.round(dvec / rp[:, None] * 8.0).astype(np.int64) + 2048
        in_range = ((ki >= 0) & (ki < 4096)).all(axis=1)
        # the per-pair kernel scale (m2l_pair_scale of the CHILD sigma)
        # is folded into the Mfam STAGING (one scalar per used source
        # parent), so scale-invariant kernels share one class operator
        # across levels — the [8W, 8W] matrices are the phase's
        # dominant byte stream and this cuts their count ~3x
        lkey = (
            st.box_level[fam_sp].astype(np.int64)
            if not scale_inv
            else np.zeros(len(uf), np.int64)
        )
        ckey = (
            (lkey * 4096 + ki[:, 0]) * 4096 + ki[:, 1]
        ) * 4096 + ki[:, 2]
        ckey = np.where(in_range, ckey, -1)
        ucls, cls_inv = np.unique(ckey, return_inverse=True)
        umask = np.zeros(len(ucls), dtype=np.uint64)
        np.bitwise_or.at(umask, cls_inv, fmask)

        # existing-children bitmasks per parent
        def child_bits(tree):
            ch = np.nonzero(tree.box_parent >= 0)[0]
            oc = self._octants(tree, ch)
            bits = np.zeros(tree.num_boxes, dtype=np.uint64)
            np.bitwise_or.at(
                bits, tree.box_parent[ch], np.uint64(1) << oc.astype(np.uint64)
            )
            return bits

        sbits = child_bits(st)[fam_sp]
        tbits = child_bits(tt)[fam_tp]
        exist = np.zeros(len(uf), dtype=np.uint64)
        for o in range(8):
            have = (sbits >> np.uint64(o)) & np.uint64(1)
            exist |= np.where(have == 1, tbits, np.uint64(0)) << np.uint64(
                8 * o
            )
        # exactness guard: a family joins the path only if its actual
        # combo set equals the class union restricted to its existing
        # children (holds for 100% of families with the tie-consistent
        # MAC; anything else — out-of-range offsets included — demotes
        # to the residual tile path)
        good = in_range & (fmask == (umask[cls_inv] & exist)) & (
            ucls[cls_inv] >= 0
        )
        if not good.any():
            return None

        pair_good = good[fam_inv]
        keep_res = np.ones(len(s), dtype=bool)
        keep_res[ci_[pair_good]] = False

        # compact to good families / their classes
        gsel = np.nonzero(good)[0]
        fam_sp_g = fam_sp[gsel]
        fam_tp_g = fam_tp[gsel]
        gckey = ckey[gsel]
        gucls, gcls_inv = np.unique(gckey, return_inverse=True)
        gumask = np.zeros(len(gucls), dtype=np.uint64)
        np.bitwise_or.at(gumask, gcls_inv, fmask[gsel])

        usp, sp_loc = np.unique(fam_sp_g, return_inverse=True)
        utp, tp_loc = np.unique(fam_tp_g, return_inverse=True)

        # per-used-source-parent child table (octant -> box id, -1 miss)
        src_child = np.full((len(usp), 8), -1, dtype=np.int32)
        src_scale = np.asarray(
            kern.m2l_pair_scale(0.5 * st.box_radius[usp])
        ).reshape(-1)
        ch = np.nonzero(st.box_parent >= 0)[0]
        par = st.box_parent[ch]
        pos = np.searchsorted(usp, par)
        pos = np.minimum(pos, len(usp) - 1)
        hit = usp[pos] == par
        oc = self._octants(st, ch[hit])
        src_child[pos[hit], oc] = ch[hit].astype(np.int32)

        # target-box output map: box -> row of [nutp*8]
        out_idx = np.full(tt.num_boxes, len(utp) * 8, dtype=np.int32)
        cht = np.nonzero(tt.box_parent >= 0)[0]
        part = tt.box_parent[cht]
        post = np.searchsorted(utp, part)
        post = np.minimum(post, len(utp) - 1)
        hitt = utp[post] == part
        oct_t = self._octants(tt, cht[hitt])
        out_idx[cht[hitt]] = (post[hitt] * 8 + oct_t).astype(np.int32)

        # class operators: 64 child-translation blocks, zero where the
        # union mask lacks the combo.  Individual child matrices are
        # cached by normalised offset (scale-invariant kernels share
        # them across levels).
        W = kern.width(pmax)
        sig_oct = np.array(
            [[1.0 if (o >> a) & 1 else -1.0 for a in range(3)]
             for o in range(8)]
        )
        mats = np.zeros((len(gucls), 8, W, 8, W))
        mat_cache = {}
        # one representative family per class
        rep = np.zeros(len(gucls), dtype=np.int64)
        rep[gcls_inv[::-1]] = np.arange(len(gsel))[::-1]
        for ci in range(len(gucls)):
            f = rep[ci]
            rpf = st.box_radius[fam_sp_g[f]]
            rc = 0.5 * rpf
            lvl = int(st.box_level[fam_sp_g[f]])
            dd = tt.box_center[fam_tp_g[f]] - st.box_center[fam_sp_g[f]]
            m = int(gumask[ci])
            for o_s in range(8):
                for o_t in range(8):
                    if not (m >> (o_s * 8 + o_t)) & 1:
                        continue
                    drm = dd + 0.5 * rpf * (sig_oct[o_t] - sig_oct[o_s])
                    ckey_m = (
                        tuple(np.round(drm / rc * 8.0).astype(np.int64)),
                        lvl if not scale_inv else -1,
                    )
                    blk = mat_cache.get(ckey_m)
                    if blk is None:
                        blk = kern.m2l_matrix(drm, rc, rc, pmax)
                        mat_cache[ckey_m] = blk
                    # transposed: the family matmul is rows @ T, the
                    # kernel matrix convention is out = mat @ M; the
                    # per-pair kernel scale is NOT folded here (it is
                    # per-level) — it rides the Mfam staging
                    mats[ci, o_s, :, o_t, :] = blk.T

        # per-class family lists, padded to a multiple of 8 (layout parity); padded
        # rows clamp to source row 0 and scatter to the dummy target
        PAD = 8
        cls_sp, cls_tp = [], []
        order = np.argsort(gcls_inv, kind="stable")
        bounds = np.searchsorted(
            gcls_inv[order], np.arange(len(gucls) + 1)
        )
        for ci in range(len(gucls)):
            sel = order[bounds[ci]: bounds[ci + 1]]
            n = len(sel)
            npad = (-n) % PAD
            spv = np.concatenate(
                [sp_loc[sel], np.zeros(npad, np.int64)]
            ).astype(np.int32)
            tpv = np.concatenate(
                [tp_loc[sel], np.full(npad, len(utp), np.int64)]
            ).astype(np.int32)
            cls_sp.append(spv)
            cls_tp.append(tpv)

        all_tp = np.concatenate(cls_tp)
        bsum = build_bucket_sum(all_tp, len(all_tp), len(utp))

        self.m2l_fam = _M2LFamilies(
            src_child=src_child,
            src_scale=src_scale,
            cls_sp=cls_sp,
            cls_tp=cls_tp,
            mats=mats,
            out_idx=out_idx,
            bsum=bsum,
            nusp=len(usp),
            nutp=len(utp),
            npairs=int(pair_good.sum()),
        )
        return keep_res

    def _slice_fam_mats(self, p):
        """Per-order family class operators: prefix-slice every child
        block to width(p) and flatten to [ncls, 8W, 8W]."""
        W = self.kernel.width(p)
        m = self.m2l_fam.mats[:, :, :W, :, :W]
        n = m.shape[0]
        return np.ascontiguousarray(m).reshape(n, 8 * W, 8 * W)

    def _build_m2l_tiles(self, subset=None):
        """Flatten the per-class pair lists into fixed-size tiles so the
        device M2L is ONE scan of batched [tile, W] x [W, W] matmuls
        instead of one op per class: each class's pairs are padded to a
        multiple of ``m2l_tile``; padded pairs carry scale 0 and scatter
        into a dummy box.

        ``subset=(s, t, cls)`` restricts the tiles to the given pairs
        (the family path's residual); class ids keep indexing the full
        ``m2l_classes.mats`` table."""
        TS = max(8, int(self.config.m2l_tile))
        cls = self.m2l_classes
        dummy_tgt = self.tgt.tree.num_boxes  # extra segment, dropped
        if subset is None:
            groups = [
                (ci, cls.src[ci], cls.tgt[ci])
                for ci in range(len(cls.src))
            ]
        else:
            s_arr, t_arr, c_arr = subset
            groups = []
            if len(s_arr):
                order = np.argsort(c_arr, kind="stable")
                so, to, co = s_arr[order], t_arr[order], c_arr[order]
                b = np.searchsorted(co, np.arange(co.max() + 2))
                for ci in range(len(b) - 1):
                    if b[ci + 1] > b[ci]:
                        groups.append(
                            (ci, so[b[ci]: b[ci + 1]], to[b[ci]: b[ci + 1]])
                        )
        srcs, tgts, tile_cls = [], [], []
        for ci, src_c, tgt_c in groups:
            n = len(src_c)
            ntile = -(-n // TS)
            pad = ntile * TS - n
            srcs.append(src_c)
            tgts.append(tgt_c)
            if pad:
                # padded pairs produce finite garbage (M[0] through the
                # class matrix) that the bucket reduction DROPS via the
                # dummy target segment — no per-pair zero scale needed
                srcs.append(np.zeros(pad, np.int32))
                tgts.append(np.full(pad, dummy_tgt, np.int32))
            tile_cls.append(np.full(ntile, ci, np.int32))
        G = 32  # tiles per scan step (batched einsum width)
        if srcs:
            src = np.concatenate(srcs)
            tgt = np.concatenate(tgts)
            cls_arr = np.concatenate(tile_cls)
            # pad the tile count to a multiple of G with dummy tiles
            ntile = len(cls_arr)
            padt = (-ntile) % G
            if padt:
                src = np.concatenate([src, np.zeros(padt * TS, np.int32)])
                tgt = np.concatenate(
                    [tgt, np.full(padt * TS, dummy_tgt, np.int32)]
                )
                cls_arr = np.concatenate([cls_arr, np.zeros(padt, np.int32)])
            self.m2l_tile_src = src
            self.m2l_tile_tgt = tgt
            self.m2l_tile_cls = cls_arr
        else:
            self.m2l_tile_src = np.zeros(0, np.int32)
            self.m2l_tile_tgt = np.zeros(0, np.int32)
            self.m2l_tile_cls = np.zeros(0, np.int32)
        self.m2l_tile_size = TS
        self.m2l_tile_group = G
        # scatter-free pair -> target-box reduction plan
        self.m2l_bsum = build_bucket_sum(
            self.m2l_tile_tgt,
            len(self.m2l_tile_src),
            self.tgt.tree.num_boxes,
        )

    def _build_near(self):
        """Near leaf pairs and the precomputed sparse near field (the
        array form of EvalInteractionLazySparse's CSR: entry values are
        charge-independent, branchy, p-independent)."""
        st, tt = self.src.tree, self.tgt.tree
        pp = self.lists.p2p_pairs
        if self.config.block_diagonal:
            # leaf self-blocks only (ref EvalDiagonalSparse.hpp:34-50),
            # before any list, table or store is built from the pairs
            pp = pp[pp[:, 0] == pp[:, 1]]
        self.p2p_src_slot = self.src.box_to_slot[pp[:, 0]].astype(np.int32)
        self.p2p_tgt_slot = self.tgt.box_to_slot[pp[:, 1]].astype(np.int32)

        self.near_rows = self.near_cols = self.near_vals = None
        self._near_panel_cache = {}
        self._near_meta = None
        self._otf_near = False
        self._device_near = False
        self._use_panels = False
        self._p2p_rows = None
        sparse = getattr(self.kernel, "near_sparse", False)
        if not sparse:
            # point kernel: direct P2P over the near leaf pairs.  The
            # leaf-tile kernel (ops/p2p_tile.py) walks them by target
            # leaf: target-sorted source list + row pointer.  A dual
            # plan runs the kernel's own p2p_block (one count table
            # serves both sides of the single tree only)
            if (
                getattr(self.kernel, "p2p_tile", False) and len(pp)
                and not self.dual
            ):
                self._p2p_rows = sorted_pair_rows(
                    self.p2p_src_slot, self.p2p_tgt_slot,
                    len(self.tgt.leaf_ids),
                )
            return
        # on-the-fly near mode (ref EvalInteractionLazy.hpp:239-252):
        # no cached panel store — the regular quadrature is recomputed
        # inside every matvec and only the O(N) near-singular
        # corrections are cached, as DELTAS vs the regular values
        cfg = self.config
        if (
            cfg.near_mode == "otf"
            and cfg.near_panel
            and getattr(self.kernel, "otf_tile", False)
            and hasattr(self.kernel, "near_block_device")
            and hasattr(self.kernel, "near_regular_entries")
            and getattr(self.kernel, "result_dim", 1) == 1
            and getattr(self.kernel, "charge_dim", 1) == 1
            and len(pp) > 0
        ):
            self._build_near_otf(pp)
            return
        # device-near mode: the regular-quadrature bulk of the near
        # field is evaluated on the device directly in panel-block
        # layout; the host only assembles the near-singular CORRECTION
        # entries (branchy semi-analytical integrals) — see
        # ops/near_panel.build_near_panels_on_device
        self._device_near = (
            cfg.near_panel
            and hasattr(self.kernel, "near_block_device")
            and len(pp) > 0
        )
        if self._device_near:
            rows, cols = self._near_candidate_entries(pp)
            self.near_rows = np.asarray(rows, np.int32)
            self.near_cols = np.asarray(cols, np.int32)
            self.near_vals = self.kernel.near_values(
                self.tgt.fields, self.src.fields,
                self.near_rows, self.near_cols,
            )
            self._use_panels = True
            return
        # host-near mode (kernels without near_block_device, or
        # near_panel=False): every entry of every near leaf pair is
        # assembled on the host as COO, packed into panels by
        # ops/near_panel.build_near_panels or, with near_panel=False,
        # replayed as COO by the kernel's near_matvec
        from fmm_bem_tpu_torch import native

        nat = native.near_coo(pp, st, tt) if len(pp) else None
        if nat is not None:
            rows, cols = nat
        else:
            rows, cols = [], []
            for s, tg in pp:
                ts, tc = tt.box_body_start[tg], tt.box_body_count[tg]
                ss, sc = st.box_body_start[s], st.box_body_count[s]
                tb = np.arange(ts, ts + tc, dtype=np.int32)
                sb = np.arange(ss, ss + sc, dtype=np.int32)
                rows.append(np.repeat(tb, sc))
                cols.append(np.tile(sb, tc))
            rows = np.concatenate(rows) if rows else np.zeros(0, np.int32)
            cols = np.concatenate(cols) if cols else np.zeros(0, np.int32)
            order = np.argsort(rows, kind="stable")
            rows, cols = rows[order], cols[order]
        self.near_rows = rows
        self.near_cols = cols
        self.near_vals = self.kernel.near_values(
            self.tgt.fields, self.src.fields, rows, cols
        )
        if cfg.droptol > 0.0 and len(self.near_rows):
            # drop-tolerance inexact near field (ref
            # SparseMatrix.hpp:51-74): an entry survives if ANY of
            # its value components exceeds the threshold (BEM
            # kernels store (G, dGdn) pairs per entry)
            v = np.abs(np.asarray(self.near_vals))
            keep = v.reshape(len(self.near_rows), -1).max(axis=1) \
                > cfg.droptol
            self.near_rows = self.near_rows[keep]
            self.near_cols = self.near_cols[keep]
            self.near_vals = self.near_vals[keep]
        self._use_panels = (
            cfg.near_panel
            and len(self.near_rows) > 0
            and hasattr(self.kernel, "near_select")
        )

    def _near_candidate_entries(self, pp):
        """Near-SINGULAR entry candidates (sqrt(2A)/d >= 0.5, the ref's
        eval_G branch switch) within the near leaf pairs."""
        st, tt = self.src.tree, self.tgt.tree
        from fmm_bem_tpu_torch import native

        st_xyz = self.src.fields["xyz"]
        tt_xyz = self.tgt.fields["xyz"]
        s_area = self.src.fields["area"]
        nat = native.near_candidates(pp, st, tt, tt_xyz, st_xyz, s_area)
        if nat is not None:
            return nat
        rows, cols = [], []
        ta = np.asarray(tt_xyz)
        sa_ = np.asarray(st_xyz)
        ar = np.asarray(s_area)
        for s, tg in pp:
            tsl = slice(
                tt.box_body_start[tg],
                tt.box_body_start[tg] + tt.box_body_count[tg],
            )
            ssl = slice(
                st.box_body_start[s],
                st.box_body_start[s] + st.box_body_count[s],
            )
            tb = np.arange(tsl.start, tsl.stop, dtype=np.int32)
            sb = np.arange(ssl.start, ssl.stop, dtype=np.int32)
            d2 = ((ta[tsl, None, :] - sa_[None, ssl, :]) ** 2).sum(-1)
            near = 2.0 * ar[None, ssl] >= 0.25 * d2
            ti, si = np.nonzero(near)
            rows.append(tb[ti])
            cols.append(sb[si])
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int32)
        return rows, cols

    def _build_near_otf(self, pp):
        """On-the-fly near mode (FMMConfig.near_mode="otf"): cache only
        the near-singular corrections as DELTAS vs the regular K-point
        quadrature; the per-iteration device product recomputes the
        regular quadrature for every near pair (see _near_otf_core) —
        the reference's memory-free plain lazy evaluator
        (EvalInteractionLazy.hpp:239-252) as a leaf-tile product."""
        kern = self.kernel
        rows, cols = self._near_candidate_entries(pp)
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        corr = np.asarray(
            kern.near_values(self.tgt.fields, self.src.fields, rows, cols)
        )
        reg = np.asarray(
            kern.near_regular_entries(
                self.tgt.fields, self.src.fields, rows, cols
            )
        )
        # correction DELTAS in leaf-aligned value windows: a target
        # body's near-singular corrections cluster in a few source
        # LEAVES, so grouping per (target slot, source leaf) lets the
        # per-iteration product gather whole charge tiles and
        # dense-reduce instead of gathering scalar charges per entry
        row_slot = self.tgt.body_flat_slot[rows]
        order = np.argsort(row_slot, kind="stable")
        self.near_rows = rows[order]
        self.near_cols = cols[order]
        self.near_vals = (corr - reg)[order]
        self._otf_corr_rows = row_slot[order].astype(np.int32)
        self._otf_corr_cols = self.src.body_flat_slot[
            self.near_cols
        ].astype(np.int32)
        K_s = self.src.leaf_pad
        nl_s = len(self.src.leaf_ids)
        gk = self._otf_corr_rows.astype(np.int64) * (nl_s + 1) + (
            self._otf_corr_cols // K_s
        )
        ug, ginv = np.unique(gk, return_inverse=True)
        G = len(ug)
        self._otf_corr_ginv = ginv.astype(np.int64)
        self._otf_corr_gleaf = (ug % (nl_s + 1)).astype(np.int32)
        grow = (ug // (nl_s + 1)).astype(np.int64)
        # per-target-slot group lists (groups are row-major sorted)
        urow, rinv = np.unique(grow, return_inverse=True)
        R = len(urow)
        fan = np.bincount(rinv)
        Fw = int(max(fan.max(initial=1), 1))
        gidx = np.full((R, Fw), G, np.int32)
        korder = np.argsort(rinv, kind="stable")
        kk = np.concatenate([np.arange(c) for c in fan]) if R else \
            np.zeros(0, np.int64)
        gidx[rinv[korder], kk] = korder.astype(np.int32)
        nslots_t = len(self.tgt.leaf_ids) * self.tgt.leaf_pad
        row_of_slot = np.full(nslots_t, R, np.int32)
        row_of_slot[urow] = np.arange(R, dtype=np.int32)
        self._otf_corr_gidx = gidx
        self._otf_corr_rowof = row_of_slot
        # beyond the window budget of (mostly-empty) leaf windows, fall
        # back to padded-row entry lists: slower per iteration (scalar
        # charge gathers) but several times smaller
        self._otf_corr_windowed = (
            G * K_s * np.dtype(self.config.dtype).itemsize
            <= _OTF_WINDOW_LIMIT
        )
        if not self._otf_corr_windowed:
            erow, einv = np.unique(
                self._otf_corr_rows, return_inverse=True
            )
            Re = len(erow)
            fan_e = np.bincount(einv)
            We = int(-(-int(fan_e.max(initial=1)) // 8) * 8)
            colp = np.zeros((Re, We), np.int32)
            eorder = np.argsort(einv, kind="stable")
            ke = np.concatenate([np.arange(c) for c in fan_e])
            colp[einv[eorder], ke] = self._otf_corr_cols[eorder]
            self._otf_corr_colp = colp
            self._otf_corr_eorder = (einv[eorder], ke, eorder)
            rowse = np.full(nslots_t, Re, np.int32)
            rowse[erow] = np.arange(Re, dtype=np.int32)
            self._otf_corr_rowof_e = rowse
        self._otf_near = True
        self._use_panels = True
        # full near-pair slot arrays, sorted by target leaf: the
        # leaf-tile product walks them through a row pointer
        ss, ts = self.p2p_src_slot, self.p2p_tgt_slot
        order = np.lexsort((ss, ts))
        self._otf_sslot = ss[order].astype(np.int32)
        self._otf_tslot = ts[order].astype(np.int32)
        self._otf_KQ = int(np.asarray(self.src.fields["qp_off"]).shape[1])
        self._otf_src_dev = None

    # ------------------------------------------------------------------
    # device tables
    # ------------------------------------------------------------------
    def _tensor(self, a, dtype=None):
        """Host array -> tensor on the plan's device (floats in the
        plan's dtype unless ``dtype`` says otherwise)."""
        return torch.as_tensor(
            np.ascontiguousarray(a), dtype=dtype or self.dtype,
            device=self.device,
        )

    def _index(self, a):
        return self._tensor(np.asarray(a, np.int64), torch.int64)

    def near_panels(self, tgt_fields_host=None):
        """Leaf-panel form of the near field for one BC variant (see
        ops/near_panel.py) — device tensors, cached per variant.
        Returns (device_dict, meta) or (None, None)."""
        if not self._use_panels:
            return None, None
        tf = tgt_fields_host if tgt_fields_host is not None else \
            self.tgt.fields
        bc = np.asarray(tf.get("bc", np.zeros(0)))
        key = bc.tobytes()
        if key not in self._near_panel_cache:
            vsel = self.kernel.near_select(
                self.near_vals, bc[self.near_rows] if len(bc) else None
            )
            if self._otf_near:
                dev, meta = self._otf_panels(tf, vsel), None
            elif self._device_near:
                dev, meta = build_near_panels_on_device(
                    self.p2p_src_slot,
                    self.p2p_tgt_slot,
                    self.src,
                    self.tgt,
                    len(self.tgt.leaf_ids),
                    self._near_blocks_fn(tf),
                    corr=(self.near_rows, self.near_cols, vsel),
                    dtype=self.dtype,
                    device=self.device,
                )
            else:
                meta = build_near_panels(
                    self.p2p_src_slot,
                    self.p2p_tgt_slot,
                    self.near_rows,
                    self.near_cols,
                    vsel,
                    self.src,
                    self.tgt,
                    len(self.tgt.leaf_ids),
                    dtype=np.dtype(self.config.dtype),
                )
                dev = meta.device(self.dtype, self.device)
            self._near_meta = meta
            self._near_panel_cache[key] = dev
            if len(self._near_panel_cache) > 4:
                self._near_panel_cache.pop(
                    next(iter(self._near_panel_cache))
                )
        return self._near_panel_cache[key], self._near_meta

    def _otf_panels(self, tgt_fields_host, vsel):
        """Device state of the on-the-fly near field for one BC
        variant: the packed leaf tiles and the BC-selected correction
        deltas, as leaf windows (``corr_valw``) or, past the window
        budget, as padded entry rows (``corr_colp``)."""
        dev = {"otf_tiles": self._otf_tiles(tgt_fields_host)}
        if len(self.near_rows) and self._otf_corr_windowed:
            K_s = self.src.leaf_pad
            G = len(self._otf_corr_gleaf)
            valw = np.zeros((G, K_s), np.dtype(self.config.dtype))
            valw[self._otf_corr_ginv, self._otf_corr_cols % K_s] = vsel
            dev["corr_valw"] = self._tensor(valw)
            dev["corr_gleaf"] = self._index(self._otf_corr_gleaf)
            dev["corr_gidx"] = self._index(self._otf_corr_gidx)
            dev["corr_rowof"] = self._index(self._otf_corr_rowof)
        elif len(self.near_rows):
            ei, ke, eorder = self._otf_corr_eorder
            valp = np.zeros(
                self._otf_corr_colp.shape, np.dtype(self.config.dtype)
            )
            valp[ei, ke] = vsel[eorder]
            dev["corr_colp"] = self._index(self._otf_corr_colp)
            dev["corr_valp"] = self._tensor(valp)
            dev["corr_rowof_e"] = self._index(self._otf_corr_rowof_e)
        return dev

    def _otf_tiles(self, tgt_fields_host):
        """Packed leaf tiles for the on-the-fly near product
        (ops/otf_tile.py), their count tables and the target-sorted pair
        list.  The source tiles, the counts and the pair list are plan
        constants; the target tiles carry the variant's BC flags.  Both
        sides are packed at one width ``max(K_s, K_t)`` (a dual plan's
        trees may differ in leaf pad): the count tables keep the walk to
        the real slots, so the wider side costs staging bytes only."""
        npdt = np.dtype(self.config.dtype)
        K = max(self.src.leaf_pad, self.tgt.leaf_pad)
        t_idx, t_mask = _widen_tiles(
            self.tgt.leaf_body_idx, self.tgt.leaf_body_mask, K)
        if self._otf_src_dev is None:
            s_idx, s_mask = _widen_tiles(
                self.src.leaf_body_idx, self.src.leaf_body_mask, K)
            tiled = {
                k: np.asarray(self.src.fields[k])[s_idx]
                for k in ("xyz", "qp_off", "qw", "area", "normal")
            }
            nl_t = len(self.tgt.leaf_ids)
            self._otf_src_dev = {
                "sb_src": self._tensor(
                    pack_otf_src(tiled, s_mask, self._otf_KQ, npdt)
                ),
                "sslot": self._tensor(self._otf_sslot, torch.int32),
                "row_ptr": self._tensor(
                    chunk_row_ptr(self._otf_tslot, nl_t), torch.int32
                ),
                "src_cnt": self._tensor(leaf_counts(s_mask), torch.int32),
                "tgt_cnt": self._tensor(leaf_counts(t_mask), torch.int32),
            }
        bc = tgt_fields_host.get("bc", self.tgt.fields.get("bc"))
        out = dict(self._otf_src_dev)
        out["sb_tgt"] = self._tensor(pack_otf_tgt(
            np.asarray(self.tgt.fields["xyz"])[t_idx],
            np.asarray(bc)[t_idx], t_mask, npdt,
        ))
        return out

    def _near_otf_core(self, dev, ql):
        """On-the-fly near product from leaf-tiled charges: the regular
        quadrature of every near pair recomputed on the device + the
        cached correction-delta product.  Returns [nl_t, KT]."""
        ot = dev["otf_tiles"]
        K = ot["sb_src"].shape[2]
        qk = ql if ql.shape[1] == K else torch.nn.functional.pad(
            ql, (0, K - ql.shape[1]))
        res = otf_leaf_tiles(
            ot["sb_src"], qk.contiguous(), ot["sb_tgt"], ot["row_ptr"],
            ot["sslot"], self._otf_KQ,
            kappa=float(getattr(self.kernel, "kappa", 0.0) or 0.0),
            src_cnt=ot["src_cnt"], tgt_cnt=ot["tgt_cnt"],
        )
        return self._near_otf_corr(dev, ql, res[:, : self.tgt.leaf_pad])

    def _near_otf_corr(self, dev, ql, res):
        """Correction-delta product: leaf-tile charge gathers per
        (target slot, source leaf) group, dense window reduce, then
        two small gathers back to slot rows (scatter-free).  The
        padded-row variant (corr_colp) trades scalar charge gathers
        for a several times smaller store at multi-million-panel
        sizes."""

        def with_zero(x):
            return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])

        if "corr_valw" in dev:
            qg = with_zero(ql)[dev["corr_gleaf"]]      # [G, K] tiles
            s_g = with_zero(torch.sum(dev["corr_valw"] * qg, dim=1))
            rs = with_zero(torch.sum(s_g[dev["corr_gidx"]], dim=1))
            return res + rs[dev["corr_rowof"]].reshape(res.shape)
        if "corr_colp" in dev:
            qlf = ql.reshape(-1)
            rows = with_zero(
                torch.sum(dev["corr_valp"] * qlf[dev["corr_colp"]], dim=1)
            )
            return res + rows[dev["corr_rowof_e"]].reshape(res.shape)
        return res

    def _near_blocks_fn(self, tgt_fields_host):
        """Device routine for the regular-quadrature interaction blocks
        for (source leaf slot, target leaf slot) index tensors."""
        kern = self.kernel
        sfd = self.device_fields(None)
        tfd = dict(self.device_fields(None, "tgt"))
        tfd["bc"] = self._tensor(
            tgt_fields_host.get("bc", self.tgt.fields.get("bc"))
        )
        sbi = self._index(self.src.leaf_body_idx)
        sbm = self._tensor(self.src.leaf_body_mask, torch.bool)
        tbi = self._index(self.tgt.leaf_body_idx)
        tbm = self._tensor(self.tgt.leaf_body_mask, torch.bool)

        def build(ss, ts):
            sf_rows = {k: v[sbi[ss]] for k, v in sfd.items()}
            tf_rows = {k: v[tbi[ts]] for k, v in tfd.items()}
            return kern.near_block_device(
                tf_rows, sf_rows, tbm[ts], sbm[ss]
            )

        return build

    def _slice_mats(self, mats, p):
        """Prefix-truncate translation matrices to width(p) (degree-
        ordered layouts make lower p a prefix slice)."""
        W = self.kernel.width(p)
        return mats[..., :W, :W]

    def _device_data(self, p):
        # p-independent tensors are built ONCE and shared by reference
        # across every per-p dict
        if self._ddata_common is None:
            self._ddata_common = self._device_data_common()
        d = dict(self._ddata_common)
        d["m2m_mats"] = self._tensor(self._slice_mats(self.src.m2m_mats, p))
        d["l2l_mats"] = self._tensor(self._slice_mats(self.tgt.l2l_mats, p))
        d["m2l_mats"] = self._tensor(
            self._slice_mats(self.m2l_classes.mats, p)
        )
        if self.m2l_fam is not None:
            d["fam_mats"] = self._tensor(self._slice_fam_mats(p))
        return d

    def _side_data(self, side, prefix):
        return {
            f"{prefix}xyz": self._tensor(side.tree.points),
            f"{prefix}perm": self._index(side.tree.perm),
            f"{prefix}inv_perm": self._index(np.argsort(side.tree.perm)),
            f"{prefix}leaf_ids": self._index(side.leaf_ids),
            f"{prefix}body_dnorm": self._tensor(side.body_dnorm),
            f"{prefix}body_inv_sigma": self._tensor(side.body_inv_sigma),
            f"{prefix}body_leaf_box": self._index(side.body_leaf_box),
            f"{prefix}body_flat_slot": self._index(side.body_flat_slot),
            f"{prefix}leaf_body_idx": self._index(side.leaf_body_idx),
            f"{prefix}leaf_body_mask": self._tensor(
                side.leaf_body_mask, torch.bool
            ),
            # flat [nl*K] mask for the slot-space matvec
            f"{prefix}slot_mask": self._tensor(
                side.leaf_body_mask.reshape(-1), torch.bool
            ),
        }

    def _device_data_common(self):
        d = self._side_data(self.src, "s_")
        d.update(
            self._side_data(self.tgt, "t_") if self.dual else
            {k.replace("s_", "t_", 1): v for k, v in d.items()}
        )
        d.update(
            {
                "m2l_tile_src": self._index(self.m2l_tile_src),
                "m2l_tile_tgt": self._index(self.m2l_tile_tgt),
                "m2l_tile_cls": self._index(self.m2l_tile_cls),
                "m2l_bsum": self.m2l_bsum.device(self.device, self.dtype),
                "p2p_src_slot": self._index(self.p2p_src_slot),
                "p2p_tgt_slot": self._index(self.p2p_tgt_slot),
                "m2p_src": self._index(self.m2p_src),
                "m2p_tgt_slot": self._index(self.m2p_tgt_slot),
                "m2p_inv_sigma": self._tensor(self.m2p_inv_sigma),
                "s_box_center": self._tensor(self.src.tree.box_center),
            }
        )
        if self._p2p_rows is not None:
            src_sorted, row_ptr = self._p2p_rows
            d["p2p_src_sorted"] = self._tensor(src_sorted, torch.int32)
            d["p2p_row_ptr"] = self._tensor(row_ptr, torch.int32)
            # real points per leaf, 0 for the dummy tile: the kernel
            # walks only those (one table: targets and sources share
            # the single tree)
            d["p2p_cnt"] = self._tensor(
                leaf_counts(self.src.leaf_body_mask), torch.int32
            )
            # plan-constant [nl, 3, K] leaf xyz tiles for the packed
            # charge ride-along (ops/p2p_tile.pack_xyzq)
            d["p2p_xyz3"] = self._tensor(
                self.src.tree.points[self.src.leaf_body_idx]
                .transpose(0, 2, 1)
            )
        if self.m2l_fam is not None:
            f = self.m2l_fam
            d.update(
                {
                    "fam_src_child": self._index(np.maximum(f.src_child, 0)),
                    "fam_src_mask": self._tensor(
                        (f.src_child >= 0) * f.src_scale[:, None]
                    ),
                    "fam_cls_sp": tuple(self._index(a) for a in f.cls_sp),
                    "fam_bsum": f.bsum.device(self.device, self.dtype),
                    "fam_out_idx": self._index(
                        np.minimum(f.out_idx, max(f.nutp * 8 - 1, 0))
                    ),
                    "fam_out_mask": self._tensor(f.out_idx < f.nutp * 8),
                }
            )
        if self.near_rows is not None and not self._use_panels:
            # the COO replay (near_panel=False): the entry lists
            # themselves, in place of a panel store
            d["near_rows"] = self._tensor(self.near_rows, torch.int32)
            d["near_cols"] = self._tensor(self.near_cols, torch.int32)
            d["near_vals"] = self._tensor(self.near_vals)

        def level_tensors(levels):
            return [
                [
                    (self._index(e[0]), self._index(e[1]))
                    if e is not None else None
                    for e in per_class
                ]
                for per_class in levels
            ]

        d["src_levels"] = level_tensors(self.src.levels)
        d["tgt_levels"] = (
            level_tensors(self.tgt.levels) if self.dual else d["src_levels"]
        )
        return d

    def device_fields(self, fields=None, side="src"):
        """Per-body field tensors (Morton order) on the plan's device:
        the plan's own fields of ``side`` ("src" or "tgt"), or a host
        override dict (cached by identity: the flipped-BC variant and a
        few overrides)."""
        if fields is None:
            fields = (self.src if side == "src" else self.tgt).fields
        key = id(fields)
        cache = self._fields_id_cache
        if key not in cache:
            # the dict is kept beside its tensors so its id stays taken
            cache[key] = (fields, {
                k: self._tensor(v)
                for k, v in fields.items()
                if k != "vertices"  # host-only geometry
            })
            if len(cache) > 8:
                cache.pop(next(iter(cache)))
        return cache[key][1]

    def device_data(self, p):
        """Per-order device tensors (cached): translation matrices are
        prefix-sliced to width(p), lists/indices are shared."""
        if p not in self._ddata_cache:
            self._ddata_cache[p] = self._device_data(p)
        return self._ddata_cache[p]

    # ------------------------------------------------------------------
    # per-variant tables
    # ------------------------------------------------------------------
    def variant_aux(self, p, src_host=None, tgt_host=None):
        """Per-(BC-variant, p) device auxiliaries: near panels + the
        precomputed linear P2M / L2P tables (L2P only where the kernel
        provides ``l2p_table``).

        P2M and L2P are linear maps (multipole of a charge distribution
        / evaluation of a local expansion) whose harmonic recurrences
        would otherwise re-run in every matvec.  The tables bake them
        once at ``max_p``; a lower order is a prefix slice:
            P2M:  contrib = q * T_p2m         (unit-charge trick)
            L2P:  res     = sum_cw L * T_l2p  (kernel-provided table)
        Tables depend on the BC flags (component selection), hence the
        per-variant cache keyed like the near panels.
        """
        kern = self.kernel
        sfh = src_host if src_host is not None else self.src.fields
        tfh = tgt_host if tgt_host is not None else self.tgt.fields
        bc_s = np.asarray(sfh.get("bc", np.zeros(0)))
        bc_t = np.asarray(tfh.get("bc", np.zeros(0)))
        p = min(int(p), self.config.max_p)
        key = (bc_s.tobytes(), bc_t.tobytes(), p)
        if key in self._aux_cache:
            return self._aux_cache[key]

        aux = {}
        panels, meta = self.near_panels(tfh)
        if panels is not None:
            aux["panels"] = panels
            aux["near_meta"] = meta
        if self.near_only:
            # no far field: the P2M / L2P tables would never be read
            self._aux_cache[key] = aux
            return aux

        pmax = self.config.max_p
        W = kern.width(p)
        full_key = (bc_s.tobytes(), bc_t.tobytes(), pmax)
        # a kernel without a linear P2M (linear_p2m = False: the
        # stresslet) gets no table and runs its own p2m per matvec
        if getattr(kern, "linear_p2m", True):
            fcache = self._p2m_tab_cache
            if full_key not in fcache:
                n = self.src.tree.num_bodies
                cdim = getattr(kern, "charge_dim", 1)
                sfd = self.device_fields(sfh)
                dn = self._tensor(self.src.body_dnorm)
                isig = self._tensor(self.src.body_inv_sigma)
                if cdim == 1:
                    q1 = torch.ones(n, dtype=self.dtype, device=self.device)
                    tab = kern.p2m(sfd, q1, dn, isig, pmax)  # [n, ncomp, Wmax]
                else:
                    # one unit-charge evaluation per charge component
                    cols = []
                    for c in range(cdim):
                        e = torch.zeros(
                            (n, cdim), dtype=self.dtype, device=self.device
                        )
                        e[:, c] = 1.0
                        cols.append(kern.p2m(sfd, e, dn, isig, pmax))
                    tab = torch.stack(cols)  # [cdim, n, ncomp, Wmax]
                fcache[full_key] = tab
                if len(fcache) > 4:
                    fcache.pop(next(iter(fcache)))
            t3 = fcache[full_key][..., :W]  # [(cdim,) n, ncomp, W]
            aux["p2m_tab"] = t3.reshape(t3.shape[:-2] + (-1,))
        if callable(getattr(kern, "l2p_table", None)):
            lcache = self._l2p_tab_cache
            if full_key not in lcache:
                lcache[full_key] = kern.l2p_table(
                    self.device_fields(tfh),
                    self._tensor(self.tgt.body_dnorm),
                    self._tensor(self.tgt.body_inv_sigma),
                    pmax,
                )  # [n, ncomp, Wmax, rdim]
                if len(lcache) > 4:
                    lcache.pop(next(iter(lcache)))
            t4 = lcache[full_key][..., :W, :]
            aux["l2p_tab"] = t4.reshape(t4.shape[0], -1, t4.shape[-1])
        self._aux_cache[key] = aux
        if len(self._aux_cache) > 8:
            self._aux_cache.pop(next(iter(self._aux_cache)))
        return aux

    def variant_aux_slots(self, p, src_host=None, tgt_host=None):
        """variant_aux extended with SLOT-layout tables for the
        tile-resident matvec: the per-body P2M/L2P tables gathered ONCE
        into the padded leaf-tile ordering, so the per-iteration matvec
        does no body-index gathers at all.

        Layouts: k-major P2M ``[K, nl, cW]`` (``[cdim, K, nl, cW]`` for
        a kernel with vector charges) and w-major L2P
        ``[rdim, cW, nl, K]`` — the contraction axis leads.  A kernel
        without ``l2p_table`` gets its field rows, normalised offsets
        and scales in slot order instead."""
        sfh = src_host if src_host is not None else self.src.fields
        tfh = tgt_host if tgt_host is not None else self.tgt.fields
        bc_s = np.asarray(sfh.get("bc", np.zeros(0)))
        bc_t = np.asarray(tfh.get("bc", np.zeros(0)))
        p = min(int(p), self.config.max_p)
        key = (bc_s.tobytes(), bc_t.tobytes(), p)
        if key in self._aux_slots_cache:
            return self._aux_slots_cache[key]

        aux = dict(self.variant_aux(p, src_host, tgt_host))
        if self.near_only:
            self._aux_slots_cache[key] = aux
            return aux
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        s_idx = self._index(self.src.leaf_body_idx.reshape(-1))
        s_msk = self._tensor(self.src.leaf_body_mask.reshape(-1), torch.bool)
        t_idx = self._index(self.tgt.leaf_body_idx.reshape(-1))
        t_msk = self._tensor(self.tgt.leaf_body_mask.reshape(-1), torch.bool)

        if "p2m_tab" in aux:
            tab = aux["p2m_tab"]  # [n, cW] or [cdim, n, cW]
            g = tab[..., s_idx, :] * s_msk[:, None].to(tab.dtype)
            if tab.ndim == 2:
                aux["p2m_tab_t"] = (
                    g.reshape(nl_s, K_s, -1).permute(1, 0, 2).contiguous()
                )
            else:
                aux["p2m_tab_t"] = (
                    g.reshape(tab.shape[0], nl_s, K_s, -1)
                    .permute(0, 2, 1, 3)
                    .contiguous()
                )
        else:
            # no linear table: the kernel's own P2M runs per matvec on
            # slot-ordered field rows
            sfd = self.device_fields(sfh)
            aux["s_fields_t"] = {k: v[s_idx] for k, v in sfd.items()}
            aux["s_dn_t"] = self._tensor(self.src.body_dnorm)[s_idx]
            aux["s_isig_t"] = self._tensor(self.src.body_inv_sigma)[s_idx]
        if "l2p_tab" in aux:
            tab = aux["l2p_tab"]  # [n, cW, rdim]
            g = tab[t_idx] * t_msk[:, None, None].to(tab.dtype)
            aux["l2p_tab_t"] = (
                g.reshape(nl_t, K_t, tab.shape[1], tab.shape[2])
                .permute(3, 2, 0, 1)
                .contiguous()
            )
        else:
            # no linear table: the kernel's own L2P runs per matvec on
            # slot-ordered field rows
            tfd = self.device_fields(tfh)
            aux["t_fields_t"] = {k: v[t_idx] for k, v in tfd.items()}
            aux["t_dn_t"] = self._tensor(self.tgt.body_dnorm)[t_idx]
            aux["t_isig_t"] = self._tensor(self.tgt.body_inv_sigma)[t_idx]
        self._aux_slots_cache[key] = aux
        if len(self._aux_slots_cache) > 8:
            self._aux_slots_cache.pop(next(iter(self._aux_slots_cache)))
        return aux

    # ------------------------------------------------------------------
    # the matvec
    # ------------------------------------------------------------------
    def _phase_m2m(self, d, M):
        """M2M bottom-up (level-synchronous octant-class matmuls;
        replaces the reference's serial child->parent walk).  Updates
        ``M`` in place.  Within one octant class every parent occurs
        once, so the sum does not depend on any atomics' order."""
        st = self.src.tree
        nc = self.kernel.ncomp
        for lvl in range(st.num_levels - 1, 0, -1):
            per_class = self.src.levels[lvl - 1]
            for c in range(8):
                if per_class[c] is None:
                    continue
                mi = per_class[c][2]
                ch, pa = d["src_levels"][lvl - 1][c]
                M.index_add_(
                    0, pa, apply_flat_trans(M[ch], d["m2m_mats"][mi], nc)
                )
        return M

    def _matvec_slots(self, d, aux, sfields, tfields, q_t, p):
        """Tile-resident matvec: charges and results live in the padded
        leaf-slot layout (flattened [nl*K] tiles) end to end, so the
        Krylov vectors need body<->slot conversions only at solve entry
        and exit (``solver_ops_slots``):

        - P2M consumes the slot-ordered linear table directly;
        - the near-field panels and the P2P / M2P leaf passes are
          natively tile-shaped (ref EvalInteractionLazySparse.hpp:134-150
          role);
        - L2P broadcasts each leaf's local expansion over its tile.

        Padded slots stay exactly zero through every phase, so solver
        dot products and norms need no masking.  ``q_t`` holds
        ``nl*K*cdim`` charges (slot-major, the charge components of a
        slot adjacent).  Returns [nl*K, rdim].
        """
        cdim = getattr(self.kernel, "charge_dim", 1)
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad

        if cdim > 1:
            q_t = torch.where(
                d["s_slot_mask"][:, None], q_t.reshape(nl_s * K_s, cdim), 0.0
            )
        else:
            q_t = torch.where(d["s_slot_mask"], q_t.reshape(nl_s * K_s), 0.0)

        if self.near_only:
            # near-field-only operator (ref EvalLocalSparse /
            # EvalDiagonalSparse): the near pass alone.  The reference
            # computes P2M and M2M before its early return and lets its
            # compiler drop them; eagerly they would run, so they are
            # skipped here (the result is the same)
            res_t = torch.zeros(
                (nl_t * K_t, self.kernel.result_dim), dtype=q_t.dtype,
                device=q_t.device,
            )
        else:
            M = self._p2m_slots(d, aux, q_t, p)
            M = self._phase_m2m(d, M)
            L = self._phase_m2l(d, M, p)
            L = self._phase_l2l(d, L)
            res_t = self._l2p_slots(d, aux, L, p)
            if len(self.m2p_src):
                res_t = res_t + self._m2p_pass(d, tfields, M, p, nl_t, K_t)
        if self.near_rows is not None and "panels" in aux:
            res_t = res_t + self._near_pass_slots(aux, q_t)
        elif self.near_rows is None and len(self.p2p_src_slot):
            res_t = res_t + self._p2p_pass(
                d, sfields, tfields, q_t, nl_t, K_t
            )
        return res_t

    def _p2m_slots(self, d, aux, q_t, p):
        """Slot-space P2M (ref EvalInteractionLazy.hpp:254-260 role):
        k-major table [(cdim,) K, nl, cW] contracted against the
        charge tiles, then one row write of the nl leaf expansions into
        the box table."""
        st = self.src.tree
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        if "p2m_tab_t" in aux:
            tabk = aux["p2m_tab_t"]
            if tabk.ndim == 3:
                qk = q_t.reshape(nl_s, K_s).T
                contrib = torch.einsum("knw,kn->nw", tabk, qk)
            else:
                qk = q_t.reshape(nl_s, K_s, tabk.shape[0])
                contrib = torch.einsum("nkc,cknw->nw", qk, tabk)
        else:
            kern = self.kernel
            cW = kern.ncomp * kern.width(p)
            contrib = kern.p2m(
                aux["s_fields_t"], q_t, aux["s_dn_t"], aux["s_isig_t"], p
            ).reshape(-1, cW)
            contrib = torch.where(d["s_slot_mask"][:, None], contrib, 0.0)
            contrib = contrib.reshape(nl_s, K_s, cW).sum(dim=1)
        M = torch.zeros(
            (st.num_boxes, contrib.shape[-1]), dtype=contrib.dtype,
            device=contrib.device,
        )
        M[d["s_leaf_ids"]] = contrib
        return M

    def _near_pass_slots(self, aux, q_t):
        """Near field with charges already in leaf-tile layout: the
        panel contraction's native shape, zero index moves."""
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        ql = q_t.reshape(nl_s, K_s * getattr(self.kernel, "charge_dim", 1))
        if "otf_tiles" in aux["panels"]:
            out_leaf = self._near_otf_core(aux["panels"], ql)
        else:
            out_leaf = panel_matvec(aux["panels"], aux["near_meta"], ql)
        return out_leaf.reshape(nl_t * K_t, self.kernel.result_dim)

    def _l2p_slots(self, d, aux, L, p):
        """L2P in slot layout: each leaf's local expansion broadcasts
        over its tile through the w-major table [rdim, cW, nl, K], or
        through the kernel's own ``l2p`` where it has no table."""
        kern = self.kernel
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        Ll = L[d["t_leaf_ids"]]  # [nl, cW]
        if "l2p_tab_t" in aux:
            out = torch.einsum("rwnk,nw->rnk", aux["l2p_tab_t"], Ll)
            return out.reshape(-1, nl_t * K_t).T
        W = kern.width(p)
        Lb = Ll[:, None, :].expand(nl_t, K_t, kern.ncomp * W).reshape(
            nl_t * K_t, kern.ncomp, W
        )
        out = kern.l2p(
            aux["t_fields_t"], Lb, aux["t_dn_t"], aux["t_isig_t"], p
        )
        return torch.where(d["t_slot_mask"][:, None], out, 0.0)

    def _phase_m2l(self, d, M, p):
        """M2L = family path (same-level pairs grouped by parents, one
        dense [8W, 8W] operator per parent-offset class — see
        _M2LFamilies) + residual tile path (cross-level pairs and
        family-demoted stragglers: ONE batched class matmul over pair
        tiles, then a scatter-free bucketed gather-sum,
        ops/bucket_sum.py)."""
        kern = self.kernel
        W = kern.width(p)
        cW = kern.ncomp * W
        L = None
        npairs_pad = len(self.m2l_tile_src)
        if npairs_pad:
            TS = self.m2l_tile_size
            ntile = npairs_pad // TS
            # fold the component axis into matmul rows (flat layout is
            # component-major): [TS*ncomp, W] x [W, W] per tile
            Mg = M[d["m2l_tile_src"]].reshape(ntile, TS * kern.ncomp, W)
            mats = d["m2l_mats"][d["m2l_tile_cls"]]  # [ntile, W, W]
            outp = torch.einsum("tpw,tvw->tpv", Mg, mats).reshape(
                npairs_pad, cW
            )
            L = bucket_sum_apply(d["m2l_bsum"], outp)
        if self.m2l_fam is not None:
            Lf = self._phase_m2l_family(d, M, p)
            L = Lf if L is None else L + Lf
        if L is None:
            L = torch.zeros(
                (self.tgt.tree.num_boxes, cW), dtype=M.dtype,
                device=M.device,
            )
        return L

    def _phase_m2l_family(self, d, M, p):
        """Family M2L (see _M2LFamilies): stage sibling expansions as
        [nusp, ncomp*8W] family rows ONCE (a single pass over M), then
        per offset class one [F_c*ncomp, 8W] x [8W, 8W] matmul whose
        64 child-translation blocks serve every child pair at once;
        reduce families into target parents (bucketed gather-sum) and
        broadcast parent rows back to child boxes with one gather."""
        f = self.m2l_fam
        nc = self.kernel.ncomp
        W = self.kernel.width(p)

        # [nusp, 8, cW] sibling stage; missing children -> zero rows
        g = M[d["fam_src_child"]] * d["fam_src_mask"][..., None]
        # component-major family rows [nusp, nc*8W] so each class
        # matmul is [F_c*nc, 8W] x [8W, 8W] with no structural zeros
        Mfam = (
            g.reshape(f.nusp, 8, nc, W)
            .permute(0, 2, 1, 3)
            .reshape(f.nusp, nc * 8 * W)
        )
        outs = []
        for ci, sp_rows in enumerate(d["fam_cls_sp"]):
            rows = Mfam[sp_rows]  # [F_c_pad, nc*8W]
            out_c = rows.reshape(-1, 8 * W) @ d["fam_mats"][ci]
            outs.append(out_c.reshape(-1, nc, 8 * W))
        out = torch.cat(outs, dim=0)  # [F_pad, nc, 8W]
        # -> per-family [8, nc*W] rows (octant-major, matching L layout)
        Fp = out.shape[0]
        out = (
            out.reshape(Fp, nc, 8, W)
            .permute(0, 2, 1, 3)
            .reshape(Fp, 8 * nc * W)
        )
        Lred = bucket_sum_apply(d["fam_bsum"], out)  # [nutp, 8cW]
        rows = Lred.reshape(f.nutp * 8, nc * W)
        return rows[d["fam_out_idx"]] * d["fam_out_mask"][:, None]

    def _phase_l2l(self, d, L):
        """L2L top-down.  Updates ``L`` in place (every child occurs
        once per class)."""
        tt = self.tgt.tree
        nc = self.kernel.ncomp
        for lvl in range(1, tt.num_levels):
            per_class = self.tgt.levels[lvl - 1]
            for c in range(8):
                if per_class[c] is None:
                    continue
                mi = per_class[c][2]
                ch, pa = d["tgt_levels"][lvl - 1][c]
                L.index_add_(
                    0, ch, apply_flat_trans(L[pa], d["l2l_mats"][mi], nc)
                )
        return L

    def _m2p_pass(self, d, tfields, M, p, nl, K, slots=True):
        """Multipole evaluation at the target tiles of level-skewed
        pairs (and the treecode's far boxes), in slot layout, or
        (``slots=False``) gathered back to target body rows.  Pairs run
        in chunks of ``config.p2p_chunk`` to bound the transient
        harmonics."""
        kern = self.kernel
        W = kern.width(p)
        txyz_lt = d["t_xyz"][d["t_leaf_body_idx"]]  # [nl, K, 3]
        lt_f = {k: v[d["t_leaf_body_idx"]] for k, v in tfields.items()}
        npair = d["m2p_src"].shape[0]
        chunk = self.config.p2p_chunk if self.config.p2p_chunk > 0 else npair
        seg = torch.zeros(
            (nl, K, kern.result_dim), dtype=M.dtype, device=M.device
        )
        for c0 in range(0, npair, chunk):
            sl = slice(c0, c0 + chunk)
            tgt_slots = d["m2p_tgt_slot"][sl]
            src_ids = d["m2p_src"][sl]
            inv_sig = d["m2p_inv_sigma"][sl]
            P = tgt_slots.shape[0]
            dn = (
                txyz_lt[tgt_slots] - d["s_box_center"][src_ids][:, None, :]
            ) * inv_sig[:, None, None]
            # flat [*, ncomp*W] expansions -> per-body [ncomp, W] views
            Ms = M[src_ids].reshape(P, 1, kern.ncomp, W).expand(
                P, K, kern.ncomp, W
            )
            rows = {
                k: v[tgt_slots].reshape((P * K,) + tuple(v.shape[2:]))
                for k, v in lt_f.items()
            }
            vals = kern.m2p(
                rows,
                Ms.reshape(P * K, kern.ncomp, W),
                dn.reshape(P * K, 3),
                inv_sig[:, None].expand(P, K).reshape(P * K),
                p,
            )
            seg.index_add_(0, tgt_slots, vals.reshape(P, K, -1))
        out = seg.reshape(nl * K, -1)
        if not slots:
            return out[d["t_body_flat_slot"]]
        # padded slots hold kernel values at dummy bodies — zero them
        return torch.where(d["t_slot_mask"][:, None], out, 0.0)

    def _p2p_pass(self, d, sfields, tfields, q_t, nl, K):
        """Direct P2P over the near leaf pairs of a point kernel.
        ``q_t`` holds the per-source-leaf charge tiles (flat [nl_s*K_s],
        or [nl_s*K_s, cdim] for vector charges; padded slots already
        zeroed).  Kernels with the Laplace tile
        math go through ops/p2p_tile.py; any other point kernel runs
        its own ``p2p_block`` batched over chunks of pairs.  Returns
        [nl*K, rdim] with padded slots zero."""
        kern = self.kernel
        if "p2p_row_ptr" in d:
            return self._p2p_pass_tiles(d, q_t, nl, K)
        sslot, tslot = d["p2p_src_slot"], d["p2p_tgt_slot"]
        sidx, tidx = d["s_leaf_body_idx"], d["t_leaf_body_idx"]
        lt_s = {k: v[sidx] for k, v in sfields.items()}
        lt_t = {k: v[tidx] for k, v in tfields.items()}
        cdim = getattr(kern, "charge_dim", 1)
        qt = q_t.reshape(
            (-1, self.src.leaf_pad) + ((cdim,) if cdim > 1 else ())
        )
        block = torch.vmap(kern.p2p_block)
        seg = torch.zeros(
            (nl, K, kern.result_dim), dtype=q_t.dtype, device=q_t.device
        )
        npair = sslot.shape[0]
        chunk = self.config.p2p_chunk if self.config.p2p_chunk > 0 else npair
        for c0 in range(0, npair, chunk):
            ss, ts = sslot[c0 : c0 + chunk], tslot[c0 : c0 + chunk]
            vals = block(
                {k: v[ts] for k, v in lt_t.items()},
                {k: v[ss] for k, v in lt_s.items()},
                qt[ss], d["s_leaf_body_mask"][ss],
            )
            seg.index_add_(0, ts, vals)
        out = seg.reshape(nl * K, -1)
        return torch.where(d["t_slot_mask"][:, None], out, 0.0)

    def _p2p_pass_tiles(self, d, q_t, nl, K):
        """Point P2P through the leaf-tile product (ops/p2p_tile.py):
        the whole pair computation stays on chip instead of
        materialising npairs*[K, K] planes in device memory."""
        xyzq = pack_xyzq(d["p2p_xyz3"], q_t.reshape(nl, 1, K))
        out = p2p_leaf_tiles(
            xyzq, d["p2p_row_ptr"], d["p2p_src_sorted"], self.kernel.eps2,
            d["p2p_cnt"],
        )  # [nl, 4, K] in leaf order, padded slots exactly 0
        return out.permute(0, 2, 1).reshape(nl * K, 4)

    # ------------------------------------------------------------------
    # the body-order matvec (plans without a slot operator)
    # ------------------------------------------------------------------
    def _leaf_tiles(self, d, qm):
        """Morton-order charges [n(, cdim)] -> masked source leaf tiles
        [nl_s, K_s*cdim], padded slots zero."""
        qg = qm[d["s_leaf_body_idx"]]
        mask = d["s_leaf_body_mask"]
        if qg.ndim == 3:
            qg = torch.where(mask[..., None], qg, 0.0)
            return qg.reshape(qg.shape[0], -1)
        return torch.where(mask, qg, 0.0)

    def _phase_p2m(self, d, aux, sfields, qm, p):
        """P2M from body-order charges (ref EvalInteractionLazy.hpp:
        254-260, batched): the linear table where the kernel has one,
        else the kernel's own ``p2m``; bodies summed per leaf tile, then
        one row write of the nl leaf expansions into the box table."""
        kern = self.kernel
        cW = kern.ncomp * kern.width(p)
        if "p2m_tab" in aux:
            tab = aux["p2m_tab"]  # [n, cW] or [cdim, n, cW]
            if qm.ndim == 1:
                contrib = qm[:, None] * tab
            else:
                contrib = torch.einsum("nc,cnw->nw", qm, tab)
        else:
            contrib = kern.p2m(
                sfields, qm, d["s_body_dnorm"], d["s_body_inv_sigma"], p
            ).reshape(-1, cW)
        ct = contrib[d["s_leaf_body_idx"]]
        ct = torch.where(d["s_leaf_body_mask"][..., None], ct, 0.0)
        M = torch.zeros(
            (self.src.tree.num_boxes, cW), dtype=ct.dtype, device=ct.device
        )
        M[d["s_leaf_ids"]] = ct.sum(dim=1)
        return M

    def _phase_l2p(self, d, aux, tfields, L, p):
        """L2P at the target bodies: the linear table where the kernel
        has one, else the kernel's own ``l2p``."""
        kern = self.kernel
        Lb = L[d["t_body_leaf_box"]]
        if "l2p_tab" in aux:
            return torch.einsum("nw,nwr->nr", Lb, aux["l2p_tab"])
        return kern.l2p(
            tfields, Lb.reshape(-1, kern.ncomp, kern.width(p)),
            d["t_body_dnorm"], d["t_body_inv_sigma"], p,
        )

    def _near_pass(self, d, aux, qm):
        """Near field from body-order charges: gathered into source leaf
        tiles, the panel product (or the on-the-fly one) per target
        leaf, then back to target body rows."""
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        ql = self._leaf_tiles(d, qm)
        if "otf_tiles" in aux["panels"]:
            out_leaf = self._near_otf_core(aux["panels"], ql)
        else:
            out_leaf = panel_matvec(aux["panels"], aux["near_meta"], ql)
        return out_leaf.reshape(nl_t * K_t, self.kernel.result_dim)[
            d["t_body_flat_slot"]
        ]

    def _matvec(self, d, aux, sfields, tfields, q, p):
        """Body-order matvec (ref FMM_plan::execute): charges ``q``
        [n_src(, cdim)] in user order -> results [n_tgt, rdim] in user
        order.  The layout of the plans without a slot operator: dual
        trees, the COO near-field replay, a BEM kernel whose charge and
        result dimensions differ."""
        kern = self.kernel
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        qm = q[d["s_perm"]]
        res_m = torch.zeros(
            (self.tgt.tree.num_bodies, kern.result_dim), dtype=qm.dtype,
            device=qm.device,
        )
        if not self.near_only:
            # a near-field-only operator skips the far field entirely
            M = self._phase_m2m(d, self._phase_p2m(d, aux, sfields, qm, p))
            if self.config.evaluator == Evaluator.FMM:
                L = self._phase_l2l(d, self._phase_m2l(d, M, p))
                res_m = res_m + self._phase_l2p(d, aux, tfields, L, p)
            if len(self.m2p_src):
                res_m = res_m + self._m2p_pass(
                    d, tfields, M, p, nl_t, K_t, slots=False
                )
        if self.near_rows is not None:
            if "panels" in aux:
                res_m = res_m + self._near_pass(d, aux, qm)
            elif len(self.near_rows):
                # the COO replay (near_panel=False, droptol)
                res_m = res_m + kern.near_matvec(
                    d["near_vals"], d["near_rows"], d["near_cols"],
                    tfields, qm, self.tgt.tree.num_bodies,
                )
        elif len(self.p2p_src_slot):
            out = self._p2p_pass(
                d, sfields, tfields, self._leaf_tiles(d, qm).reshape(-1),
                nl_t, K_t,
            )
            res_m = res_m + out[d["t_body_flat_slot"]]
        # back to user order (inverse-permutation gather)
        return res_m[d["t_inv_perm"]]

    @property
    def has_slot_route(self):
        """Whether ``apply`` runs the slot-layout matvec: every plan but
        a dual one, the COO replay and a BEM kernel whose charge and
        result dimensions differ (those run in body order)."""
        kern = self.kernel
        coo = (
            self.near_rows is not None and not self._use_panels
            and len(self.near_rows) > 0
        )
        bem_nonsquare = getattr(kern, "near_sparse", False) and getattr(
            kern, "charge_dim", 1) != kern.result_dim
        return not (self.dual or coo or bem_nonsquare)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def solver_ops_slots(self, flipped=False):
        """Slot-space operator form for the device solver: the Krylov
        vectors live in the padded leaf-tile layout, so the matvec does
        ZERO body-order index gathers per iteration (see
        ``_matvec_slots``).  Returns

            (matvec, operand_for_p, to_slots, from_slots, nslots)

        with ``matvec(operand, x_slot, p) -> A @ x_slot``,
        ``operand_for_p(p)`` the per-order device tables, and
        ``to_slots(x_user) -> x_slot`` / ``from_slots(r_slot) ->
        r_user`` the one-time solve entry/exit conversions.  A
        vector-valued kernel (Stokes, ``charge_dim = result_dim = c``)
        sees the solver vector as the flattened ``[n*c]`` layout (ref
        GMRES_Stokes.hpp VecToArray/ArrayToVec :85-110), ``nslots`` is
        ``nl*K*c``.

        ``flipped=True`` applies the BC-flipped operator (the
        reference's switch_BC system matrix, LaplaceBEM.cpp:218-232).
        Returns ``None`` where the plan has no slot operator (a dual
        plan, the COO replay) or no square one (charge and result
        dimensions differ: a point kernel with forces); ``solver_ops``
        is the body-order operator.
        """
        rdim = self.kernel.result_dim
        if getattr(self.kernel, "charge_dim", 1) != rdim or not (
            self.has_slot_route
        ):
            return None
        sfh = self._flipped_fields() if flipped else None
        mv, op4p, to_s, from_s, nslots = self._slot_ops(sfh)

        def flat(r):
            return r[:, 0] if rdim == 1 else r.reshape(-1)

        return (
            lambda operand, x, p: flat(mv(operand, x, p)),
            op4p, to_s, lambda rt: flat(from_s(rt)), nslots,
        )

    def _slot_ops(self, fields_host):
        """The slot-space operator with full result rows:
        ``matvec -> [nl*K, rdim]``, ``from_slots -> [n, rdim]``;
        ``to_slots`` takes ``[n]`` (``[n, cdim]`` or its flattening for
        vector charges) and gives the flat ``[nl*K*cdim]`` slot vector."""
        cdim = getattr(self.kernel, "charge_dim", 1)
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        n = self.src.tree.num_bodies
        sf = self.device_fields(fields_host)

        def operand_for_p(p):
            p = min(int(p), self.config.max_p)
            aux = self.variant_aux_slots(
                p, src_host=fields_host, tgt_host=fields_host
            )
            return (self.device_data(p), aux, sf, sf)

        def matvec(operand, x, p):
            d, aux, sfo, tfo = operand
            return self._matvec_slots(
                d, aux, sfo, tfo, x, min(int(p), self.config.max_p)
            )

        # solve entry/exit index maps (user order <-> slot order)
        if self._slot_maps is None:
            self._slot_maps = (
                self._index(
                    self.src.tree.perm[self.src.leaf_body_idx.reshape(-1)]
                ),
                self._tensor(
                    self.src.leaf_body_mask.reshape(-1), torch.bool
                ),
                self._index(
                    self.tgt.body_flat_slot[np.argsort(self.tgt.tree.perm)]
                ),
            )
        slot_user, smask, user_slot = self._slot_maps

        def to_slots(xu):
            xu = torch.as_tensor(
                np.array(xu) if isinstance(xu, np.ndarray) else xu,
                dtype=self.dtype, device=self.device,
            )
            if cdim > 1:
                g = xu.reshape(n, cdim)[slot_user]
                return torch.where(smask[:, None], g, 0.0).reshape(-1)
            return torch.where(smask, xu.reshape(n)[slot_user], 0.0)

        def from_slots(rt):
            return rt.reshape(-1, self.kernel.result_dim)[user_slot]

        return matvec, operand_for_p, to_slots, from_slots, nl_s * K_s * cdim

    def solver_ops(self, flipped=False):
        """Body-order operator form for the device-resident solver
        (``gmres_device``): returns ``(matvec, operand_for_p)`` with
        ``matvec(operand, x, p) -> A @ x`` on the flattened ``[n*c]``
        user-order vector (ref GMRES_Stokes.hpp VecToArray/ArrayToVec
        :85-110) and ``operand_for_p(p)`` the per-order device tables.
        ``flipped=True`` applies the BC-flipped operator (the
        reference's switch_BC system matrix, LaplaceBEM.cpp:218-232) on
        both sides of a dual plan."""
        rdim = self.kernel.result_dim
        cdim = getattr(self.kernel, "charge_dim", 1)
        sfh, tfh = self._flipped_pair() if flipped else (None, None)
        sf = self.device_fields(sfh, "src")
        tf = self.device_fields(tfh, "tgt") if self.dual else sf

        def operand_for_p(p):
            p = min(int(p), self.config.max_p)
            aux = self.variant_aux(p, src_host=sfh, tgt_host=tfh)
            return (self.device_data(p), aux, sf, tf)

        def matvec(operand, x, p):
            d, aux, sfo, tfo = operand
            q = x if cdim == 1 else x.reshape(-1, cdim)
            out = self._matvec(
                d, aux, sfo, tfo, q, min(int(p), self.config.max_p)
            )
            return out[:, 0] if rdim == 1 else out.reshape(-1)

        return matvec, operand_for_p

    def apply(self, charges, p=None, fields=None, target_fields=None):
        """One FMM matvec at truncation order ``p`` (ref
        FMM_plan::execute, FMM_plan.hpp:75-90 + the set_p relaxation
        hook): charges [n] (or [n, cdim]) in user order -> result
        [n_tgt, rdim] tensor on the plan's device, through the
        slot-space matvec where the plan has one (``has_slot_route``),
        else in body order.

        ``fields`` / ``target_fields`` override the per-body arrays at
        call time (already in Morton order) — e.g. flipped BC flags to
        evaluate the RHS operator, replacing the reference's full plan
        rebuild (LaplaceBEM.cpp:218-232) with a pure input change.
        """
        p = int(p if p is not None else self.config.max_p)
        p = min(p, self.config.max_p)
        if self.has_slot_route and (
            target_fields is None or target_fields is fields
        ):
            mv, op4p, to_s, from_s, _ = self._slot_ops(fields)
            return from_s(mv(op4p(p), to_s(charges), p))
        return self.apply_body_order(charges, p, fields, target_fields)

    def apply_body_order(self, charges, p=None, fields=None,
                         target_fields=None):
        """``apply`` through the body-order matvec (``_matvec``) on any
        plan: the route of the plans without a slot operator, and on the
        others the same operator in the other layout."""
        p = min(int(p if p is not None else self.config.max_p),
                self.config.max_p)
        host_tgt = target_fields if target_fields is not None else (
            fields if not self.dual else None)
        aux = self.variant_aux(p, src_host=fields, tgt_host=host_tgt)
        sf = self.device_fields(fields, "src")
        tf = (
            self.device_fields(host_tgt, "tgt")
            if self.dual or target_fields is not None else sf
        )
        q = torch.as_tensor(
            np.array(charges) if isinstance(charges, np.ndarray) else charges,
            dtype=self.dtype, device=self.device,
        )
        cdim = getattr(self.kernel, "charge_dim", 1)
        n = self.src.tree.num_bodies
        q = q.reshape(n) if cdim == 1 else q.reshape(n, cdim)
        return self._matvec(self.device_data(p), aux, sf, tf, q, p)

    def calibrate_eps(self, q=None, ps=None, seed=0):
        """Measure the matvec truncation-error decay eps(p) and fit
        ``eps(p) = c * gamma**p``.

        The reference hardcodes eps ~ 2^-p into its relaxation schedule
        and flags it as Laplace-sphere-specific (SolverOptions.hpp:32
        "predict p for Spherical Laplace kernel -- abstract out").
        Here the model is calibrated per plan: matvecs at a few sample
        orders are compared against the max_p matvec on a random
        probe charge, and the fitted (c, gamma) drive
        SolverConfig.predict_p via ``SolverConfig.calibrated``.

        Returns (c, gamma); the raw samples land in ``self.eps_samples``.
        """
        pmax = self.config.max_p
        if ps is None:
            lo = max(1, pmax // 4)
            mid = max(lo + 1, pmax // 2)
            hi = max(mid + 1, pmax - 1)
            ps = sorted({lo, mid, hi})
        ps = [p for p in ps if p < pmax]
        cdim = getattr(self.kernel, "charge_dim", 1)
        n = self.src.tree.num_bodies
        if q is None:
            rng = np.random.default_rng(seed)
            q = rng.choice(
                [-1.0, 1.0], size=(n,) if cdim == 1 else (n, cdim)
            )
        ref = self.apply(q, p=pmax).cpu().numpy()
        rnorm = float(np.linalg.norm(ref))
        eps = {}
        for p in ps:
            out = self.apply(q, p=p).cpu().numpy()
            eps[p] = float(np.linalg.norm(out - ref)) / max(rnorm, 1e-300)
        self.eps_samples = eps
        # least-squares fit of log eps = log c + p log gamma, using only
        # samples above the noise floor of the arithmetic in use
        floor = 50 * np.finfo(np.dtype(self.config.dtype)).eps
        pts = [(p, e) for p, e in eps.items() if e > floor]
        if len(pts) >= 2:
            parr = np.array([p for p, _ in pts], dtype=np.float64)
            larr = np.log(np.array([e for _, e in pts]))
            slope, icept = np.polyfit(parr, larr, 1)
            gamma = float(np.exp(slope))
            c = float(np.exp(icept))
        elif len(pts) == 1:
            p0, e0 = pts[0]
            gamma = 0.5
            c = e0 / gamma**p0
        else:
            # truncation indistinguishable from max_p on this plan
            # (e.g. a near-field-dominated small tree): no model —
            # SolverConfig keeps the reference's 2^-p default
            return None, None
        # clamp to a sane contraction so the schedule stays monotone and
        # can always reach max_p
        gamma = min(max(gamma, 1e-4), 0.95)
        c = min(max(c, 1e-12), 1e3)
        return c, gamma

    def _flipped_fields(self):
        """Host field dict of the sources with every panel's BC flag
        flipped (the reference's switch_BC trick) — cached so the
        derived device tensors are reused across calls."""
        return self._flipped_pair()[0]

    def _flipped_pair(self):
        """``(source, target)`` host field dicts with every BC flag
        flipped; one dict on a single tree."""
        if self._flipped_host is None:
            def flip(side):
                f = dict(side.fields)
                f["bc"] = 1.0 - np.asarray(f["bc"])
                return f

            sf = flip(self.src)
            self._flipped_host = (sf, flip(self.tgt) if self.dual else sf)
        return self._flipped_host

    def apply_flipped_bc(self, charges, p=None):
        """Matvec with every panel's BC flag flipped (the reference's
        switch_BC RHS trick), on both sides of a dual plan — same plan,
        same tree and lists."""
        sf, tf = self._flipped_pair()
        return self.apply(charges, p=p, fields=sf, target_fields=tf)

    # alias matching the reference naming (FMM_plan::execute)
    execute = apply
