"""Dual-tree MAC traversal -> static interaction lists.

Equivalent of the reference's lazy evaluator constructor
(include/executor/EvalInteractionLazy.hpp:79-231 and
EvalInteraction.hpp:20-89): one host-side traversal materialises
charge-independent call lists that the device executor replays every
GMRES iteration.  Unlike the reference's per-pair work queue, the
traversal here advances a whole *front* of candidate box pairs per round
with vectorised numpy ops, so a million-pair traversal is a handful of
array passes instead of a million queue pops.

Lists produced (ref EvalInteractionLazy.hpp):
- ``m2l_pairs``  (src_box, tgt_box) passing the MAC       -> far field (FMM)
- ``m2p_pairs``  (src_box, tgt_leaf) for treecode mode    -> far field (treecode)
- ``p2p_pairs``  (src_leaf, tgt_leaf)                     -> near field

The traversal follows the reference's split rule exactly
(EvalInteraction.hpp:33-61): leaf x leaf -> P2P; otherwise split the box
with the larger side (ties and leaf-vs-internal: split the non-leaf /
the target); children are MAC-tested on creation (M2L on accept,
re-queued on reject).  Treecode M2P targets are expanded down to the
target's descendant leaves so device-side gathers stay rectangular.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fmm_bem_tpu_torch.tree.octree import Tree


@dataclasses.dataclass
class InteractionLists:
    """Charge-independent FMM call lists (box-id pairs, numpy int32)."""

    #: (n, 2) [src_box, tgt_box] far-field pairs for M2L
    m2l_pairs: np.ndarray
    #: (n, 2) [src_box, tgt_leaf_box] far-field pairs for treecode M2P
    m2p_pairs: np.ndarray
    #: (n, 2) [src_leaf_box, tgt_leaf_box] near-field pairs
    p2p_pairs: np.ndarray

    @property
    def stats(self):
        return {
            "m2l": int(self.m2l_pairs.shape[0]),
            "m2p": int(self.m2p_pairs.shape[0]),
            "p2p": int(self.p2p_pairs.shape[0]),
        }


def _expand_children(tree: Tree, boxes: np.ndarray):
    """(child_box_ids, repeat_index) for the children of each box."""
    counts = tree.box_child_count[boxes]
    starts = tree.box_child_start[boxes]
    rep = np.repeat(np.arange(len(boxes)), counts)
    # children of box i are starts[i] .. starts[i]+counts[i]-1 (contiguous)
    offsets = np.arange(counts.sum()) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    children = np.repeat(starts, counts) + offsets
    return children.astype(np.int32), rep


def expand_to_leaves(tree: Tree, boxes: np.ndarray):
    """Map each box to its descendant leaves: returns (leaf_ids, origin_row).

    Used to flatten treecode M2P targets (whose body range spans the
    subtree, ref Octree body-range containment) into uniform leaf tiles.
    """
    boxes = np.asarray(boxes, dtype=np.int32)
    rows = np.arange(len(boxes))
    out_leaves = []
    out_rows = []
    cur_boxes, cur_rows = boxes, rows
    while len(cur_boxes):
        leaf_mask = tree.box_is_leaf[cur_boxes]
        out_leaves.append(cur_boxes[leaf_mask])
        out_rows.append(cur_rows[leaf_mask])
        internal = cur_boxes[~leaf_mask]
        internal_rows = cur_rows[~leaf_mask]
        if not len(internal):
            break
        children, rep = _expand_children(tree, internal)
        cur_boxes, cur_rows = children, internal_rows[rep]
    return np.concatenate(out_leaves), np.concatenate(out_rows)


def build_interaction_lists(
    src_tree: Tree,
    theta: float = 0.5,
    tgt_tree: Tree | None = None,
    treecode: bool = False,
) -> InteractionLists:
    """Run the dual-tree traversal between ``src_tree`` and ``tgt_tree``
    (defaults to the same tree, the single-tree case of
    ExecutorSingleTree) and emit interaction lists.

    MAC (ref FMMOptions.hpp:21-31): accept iff
    ``|c_s - c_t|^2 > ((r_s + r_t)/theta)^2``.
    """
    st = src_tree
    tt = tgt_tree if tgt_tree is not None else src_tree

    # native C++ traversal when available (identical semantics)
    from fmm_bem_tpu_torch import native

    nat = native.traverse(st, tt, theta)
    if nat is not None:
        m2l, near = nat
        return _package_lists(tt, m2l[:, 0], m2l[:, 1], near, treecode)

    m2l_s, m2l_t = [], []
    p2p_s, p2p_t = [], []

    # the traversal front: candidate pairs that failed (or skipped) the MAC
    cur_s = np.array([0], dtype=np.int32)
    cur_t = np.array([0], dtype=np.int32)

    inv_theta = 1.0 / theta
    while len(cur_s):
        s_leaf = st.box_is_leaf[cur_s]
        t_leaf = tt.box_is_leaf[cur_t]

        # both leaves -> P2P
        both = s_leaf & t_leaf
        if both.any():
            p2p_s.append(cur_s[both])
            p2p_t.append(cur_t[both])

        rest_s = cur_s[~both]
        rest_t = cur_t[~both]
        if not len(rest_s):
            break
        rs_leaf = st.box_is_leaf[rest_s]
        rt_leaf = tt.box_is_leaf[rest_t]
        side_s = st.box_radius[rest_s]
        side_t = tt.box_radius[rest_t]
        # split source iff it is internal AND (target is a leaf OR source
        # is strictly larger); ties split the target (EvalInteraction.hpp:44-59)
        split_src = (~rs_leaf) & (rt_leaf | (side_s > side_t))

        new_s, new_t = [], []
        if split_src.any():
            ss, tfix = rest_s[split_src], rest_t[split_src]
            children, rep = _expand_children(st, ss)
            new_s.append(children)
            new_t.append(tfix[rep])
        if (~split_src).any():
            sfix, tsplit = rest_s[~split_src], rest_t[~split_src]
            children, rep = _expand_children(tt, tsplit)
            new_s.append(sfix[rep])
            new_t.append(children)
        cand_s = np.concatenate(new_s)
        cand_t = np.concatenate(new_t)

        # MAC test on the freshly created pairs (EvalInteraction.hpp:63-76)
        cs = st.box_center[cand_s]
        ct = tt.box_center[cand_t]
        d2 = ((cs - ct) ** 2).sum(axis=1)
        rhs = (st.box_radius[cand_s] + tt.box_radius[cand_t]) * inv_theta
        # tie-consistent MAC: same-level boxes exactly at the threshold
        # (|offset|^2 == (2*side)^2 at theta=0.5) otherwise compare at
        # float-rounding mercy — the outcome flips per instance because
        # centers are reconstructed through different roundings.  Ties
        # uniformly PASS, which makes the (src-parent, tgt-parent)
        # family combo masks a pure function of the parent offset (see
        # executor/plan._build_m2l_families).
        accept = d2 > rhs * rhs * (1.0 - 1e-12)

        if accept.any():
            m2l_s.append(cand_s[accept])
            m2l_t.append(cand_t[accept])
        cur_s = cand_s[~accept]
        cur_t = cand_t[~accept]

    def _cat(parts):
        if not parts:
            return np.zeros((0,), dtype=np.int32)
        return np.concatenate(parts).astype(np.int32)

    far_s, far_t = _cat(m2l_s), _cat(m2l_t)
    near = np.stack([_cat(p2p_s), _cat(p2p_t)], axis=1) if p2p_s else np.zeros(
        (0, 2), dtype=np.int32
    )
    return _package_lists(tt, far_s, far_t, near, treecode)


def _package_lists(tt, far_s, far_t, near, treecode):
    if treecode:
        # expand far-field targets to their descendant leaves for M2P
        if len(far_t):
            leaves, rows = expand_to_leaves(tt, far_t)
            m2p = np.stack([far_s[rows], leaves], axis=1).astype(np.int32)
        else:
            m2p = np.zeros((0, 2), dtype=np.int32)
        m2l = np.zeros((0, 2), dtype=np.int32)
    else:
        m2l = np.stack([far_s, far_t], axis=1).astype(np.int32) if len(
            far_s
        ) else np.zeros((0, 2), dtype=np.int32)
        m2p = np.zeros((0, 2), dtype=np.int32)

    return InteractionLists(m2l_pairs=m2l, m2p_pairs=m2p, p2p_pairs=near)
