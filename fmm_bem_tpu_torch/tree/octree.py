"""Adaptive Morton octree as a structure-of-arrays.

Array re-design of the reference Octree (include/tree/Octree.hpp):
instead of proxy Box/Body objects over a ``box_data`` array, the tree is
a set of flat numpy arrays built once on the host.  Bodies are argsorted
by full-depth Morton code (equivalent to the reference's per-box MSD
bucket sort, Octree.hpp:617-692, which is a stable radix sort), and boxes
are produced in BFS order so each level occupies a contiguous id range
(``level_offset``, ref Octree.hpp:673-684).

A box's body range covers its whole subtree (bodies are Morton-
contiguous), which is what lets treecode M2P and box-wise gathers be
simple slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fmm_bem_tpu_torch.tree import morton


@dataclasses.dataclass
class Tree:
    """Flat SoA octree over 3-D points.

    Bodies are stored in Morton order; ``perm[i]`` is the original index
    of morton-ordered body ``i`` (ref Octree.hpp:686-691 permute_).
    """

    #: morton-ordered copy of the input points, shape (N, 3)
    points: np.ndarray
    #: original index of each morton-ordered body, shape (N,)
    perm: np.ndarray
    #: full-depth morton code per body, shape (N,)
    codes: np.ndarray

    # --- box table (B boxes, BFS order, level-contiguous ids) ---
    box_level: np.ndarray        # (B,) int32
    box_parent: np.ndarray       # (B,) int32, -1 for root
    box_child_start: np.ndarray  # (B,) int32 first child box id (0 if none)
    box_child_count: np.ndarray  # (B,) int32
    box_body_start: np.ndarray   # (B,) int32 into morton-ordered bodies
    box_body_count: np.ndarray   # (B,) int32
    box_is_leaf: np.ndarray      # (B,) bool
    box_center: np.ndarray       # (B, 3) float64
    box_radius: np.ndarray       # (B,) float64 half side length
    #: first box id of each level; len = nlevels + 1
    level_offset: np.ndarray
    #: leaf box id owning each morton-ordered body, shape (N,)
    body_leaf: np.ndarray

    # bbox bookkeeping
    pmin: np.ndarray
    root_side: float

    @property
    def num_bodies(self) -> int:
        return self.points.shape[0]

    @property
    def num_boxes(self) -> int:
        return self.box_level.shape[0]

    @property
    def num_levels(self) -> int:
        return len(self.level_offset) - 1

    @property
    def leaves(self) -> np.ndarray:
        """Box ids of all leaves."""
        return np.nonzero(self.box_is_leaf)[0]

    @property
    def max_leaf_bodies(self) -> int:
        return int(self.box_body_count[self.box_is_leaf].max())

    def side_length(self, level) -> np.ndarray:
        return self.root_side / (2.0 ** np.asarray(level, dtype=np.float64))

    def format_tree(self, max_boxes=None) -> str:
        """ASCII outline of the box hierarchy (2-space indent per
        level, depth-first), the reference's tree printer
        (Octree.hpp:736-753 / FMMOptions printTree).  ``max_boxes``
        truncates huge trees."""
        lines = []

        def walk(b):
            if max_boxes is not None and len(lines) >= max_boxes:
                return
            lines.append(
                "{}Box {}: level {}, {} bodies [{}, {}), center "
                "({:.4g}, {:.4g}, {:.4g}){}".format(
                    "  " * int(self.box_level[b]),
                    b,
                    int(self.box_level[b]),
                    int(self.box_body_count[b]),
                    int(self.box_body_start[b]),
                    int(self.box_body_start[b] + self.box_body_count[b]),
                    *self.box_center[b],
                    " leaf" if self.box_is_leaf[b] else "",
                )
            )
            if not self.box_is_leaf[b]:
                c0 = int(self.box_child_start[b])
                for c in range(c0, c0 + int(self.box_child_count[b])):
                    walk(c)

        walk(0)
        if max_boxes is not None and len(lines) >= max_boxes:
            lines.append(f"... ({self.num_boxes} boxes total)")
        return "\n".join(lines)


def bounding_cube(points):
    """Cubic, slightly inflated bounding box of ``points``.

    Matches the reference convention (Octree.hpp:66-79): pmin = min over
    points, side = largest extent * (1 + 1e-6), so every point is
    strictly inside.
    """
    points = np.asarray(points, dtype=np.float64)
    pmin = points.min(axis=0)
    side = float((points.max(axis=0) - pmin).max()) * (1.0 + 1e-6)
    if side == 0.0:
        side = 1.0
    return pmin, side


def build_tree(points, ncrit=64, max_level=morton.LEVELS, pmin=None, side=None):
    """Build the adaptive octree: split any box with more than ``ncrit``
    bodies (ref Octree.hpp:641-644) until ``max_level``.

    ``pmin``/``side`` may be supplied to embed several trees (e.g. a
    source and a target tree) in one common cube.  Uses the native C++
    routine (fmm_bem_tpu_torch.native) when available, with this numpy code as
    the identical-semantics fallback.
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n == 0:
        raise ValueError("cannot build a tree over zero points")
    if pmin is None or side is None:
        pmin, side = bounding_cube(points)
    pmin = np.asarray(pmin, dtype=np.float64)

    from fmm_bem_tpu_torch import native

    nat = native.build_tree_arrays(points, ncrit, max_level, pmin, side)
    if nat is not None:
        return _finalize_tree(
            points[nat["perm"]],
            nat["perm"],
            nat["codes"],
            nat["level"],
            nat["parent"].astype(np.int32),
            nat["child_start"],
            nat["child_count"],
            nat["body_start"],
            nat["body_count"],
            nat["is_leaf"].astype(bool),
            nat["prefix"],
            nat["body_leaf"],
            pmin,
            side,
        )
    cell = side / morton.CELLS_PER_SIDE

    codes = morton.morton_encode(points, pmin, cell)
    perm = np.argsort(codes, kind="stable").astype(np.int64)
    codes = codes[perm]
    pts = points[perm]

    # BFS over boxes; each queue entry: (prefix_code, level, body_start, body_end, parent)
    box_level = [0]
    box_parent = [-1]
    box_child_start = [0]
    box_child_count = [0]
    box_body_start = [0]
    box_body_count = [n]
    box_is_leaf = [False]
    box_prefix = [0]

    head = 0
    while head < len(box_level):
        b = head
        head += 1
        start = box_body_start[b]
        count = box_body_count[b]
        level = box_level[b]
        if count <= ncrit or level >= max_level:
            box_is_leaf[b] = True
            continue
        # split on the next 3 morton bits below this box's level
        shift = 3 * (morton.LEVELS - level - 1)
        prefix = box_prefix[b]
        bounds = prefix + (np.arange(9, dtype=np.int64) << shift)
        # child body ranges via binary search inside the parent's slice
        cuts = np.searchsorted(codes[start : start + count], bounds, side="left")
        cuts += start
        first_child = len(box_level)
        nchild = 0
        for d in range(8):
            lo, hi = int(cuts[d]), int(cuts[d + 1])
            if hi == lo:
                continue
            box_level.append(level + 1)
            box_parent.append(b)
            box_child_start.append(0)
            box_child_count.append(0)
            box_body_start.append(lo)
            box_body_count.append(hi - lo)
            box_is_leaf.append(False)
            box_prefix.append(prefix + (np.int64(d) << shift))
            nchild += 1
        box_child_start[b] = first_child
        box_child_count[b] = nchild

    box_level = np.asarray(box_level, dtype=np.int32)
    box_parent = np.asarray(box_parent, dtype=np.int32)
    box_child_start = np.asarray(box_child_start, dtype=np.int32)
    box_child_count = np.asarray(box_child_count, dtype=np.int32)
    box_body_start = np.asarray(box_body_start, dtype=np.int32)
    box_body_count = np.asarray(box_body_count, dtype=np.int32)
    box_is_leaf = np.asarray(box_is_leaf, dtype=bool)
    box_prefix = np.asarray(box_prefix, dtype=np.int64)

    # leaf ownership per body
    body_leaf = np.empty(n, dtype=np.int32)
    for b in np.nonzero(box_is_leaf)[0]:
        body_leaf[box_body_start[b] : box_body_start[b] + box_body_count[b]] = b

    return _finalize_tree(
        pts,
        perm,
        codes,
        box_level,
        box_parent,
        box_child_start,
        box_child_count,
        box_body_start,
        box_body_count,
        box_is_leaf,
        box_prefix,
        body_leaf,
        pmin,
        side,
    )


def _finalize_tree(
    pts,
    perm,
    codes,
    box_level,
    box_parent,
    box_child_start,
    box_child_count,
    box_body_start,
    box_body_count,
    box_is_leaf,
    box_prefix,
    body_leaf,
    pmin,
    side,
):
    """Derive geometric/level metadata shared by the native and numpy
    routines."""
    box_level = np.asarray(box_level, dtype=np.int32)
    # BFS order => levels contiguous and sorted ascending
    nlevels = int(box_level.max()) + 1
    level_offset = np.searchsorted(box_level, np.arange(nlevels + 1)).astype(
        np.int32
    )

    # geometric centers from the morton prefix at each box's level
    # (ref Octree.hpp:350-355: center of the morton cell)
    ix, iy, iz = morton.deinterleave(np.asarray(box_prefix, dtype=np.int64))
    shift_per_box = morton.LEVELS - box_level
    cell_idx = np.stack(
        [ix >> shift_per_box, iy >> shift_per_box, iz >> shift_per_box],
        axis=-1,
    ).astype(np.float64)
    side_per_box = side / (2.0 ** box_level.astype(np.float64))
    box_center = pmin[None, :] + (cell_idx + 0.5) * side_per_box[:, None]
    box_radius = side_per_box / 2.0

    return Tree(
        points=np.asarray(pts, dtype=np.float64),
        perm=np.asarray(perm, dtype=np.int64),
        codes=np.asarray(codes, dtype=np.int64),
        box_level=box_level,
        box_parent=np.asarray(box_parent, dtype=np.int32),
        box_child_start=np.asarray(box_child_start, dtype=np.int32),
        box_child_count=np.asarray(box_child_count, dtype=np.int32),
        box_body_start=np.asarray(box_body_start, dtype=np.int32),
        box_body_count=np.asarray(box_body_count, dtype=np.int32),
        box_is_leaf=np.asarray(box_is_leaf, dtype=bool),
        box_center=box_center,
        box_radius=box_radius,
        level_offset=level_offset,
        body_leaf=np.asarray(body_leaf, dtype=np.int32),
        pmin=np.asarray(pmin, dtype=np.float64),
        root_side=float(side),
    )
