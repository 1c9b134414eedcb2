"""ctypes bindings to the native host runtime (native/libfmm_native.so).

The C++ library accelerates the plan-build hot paths — octree
construction, dual-tree MAC traversal, near-field COO expansion — with
semantics identical to the numpy fallbacks (`fmm_bem_tpu_torch.tree.octree`,
`fmm_bem_tpu_torch.traversal.lists`).  If the .so is missing it is compiled
on demand with g++; if that fails the callers silently use the numpy
paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_HERE, "native", "libfmm_native.so")
_SRC = os.path.join(_HERE, "native", "fmm_native.cpp")


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO) and os.path.exists(_SRC):
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-std=c++17", "-fopenmp", "-shared", "-o", _SO, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.fmm_tree_build.restype = ctypes.c_void_p
    lib.fmm_tree_num_boxes.restype = ctypes.c_int64
    lib.fmm_traverse.restype = ctypes.c_void_p
    lib.fmm_near_coo_size.restype = ctypes.c_int64
    if hasattr(lib, "fmm_near_candidates"):
        lib.fmm_near_candidates.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def build_tree_arrays(points, ncrit, max_level, pmin, side):
    """Native octree build -> dict of box/body arrays (None if the
    library is unavailable)."""
    lib = get_lib()
    if lib is None:
        return None
    pts = _f64(points)
    n = len(pts)
    pmin = _f64(pmin)
    h = lib.fmm_tree_build(
        _ptr(pts),
        ctypes.c_int64(n),
        ctypes.c_int(ncrit),
        ctypes.c_int(max_level),
        _ptr(pmin),
        ctypes.c_double(side),
    )
    nb = lib.fmm_tree_num_boxes(ctypes.c_void_p(h))
    out = {
        "level": np.empty(nb, np.int32),
        "parent": np.empty(nb, np.int32),
        "child_start": np.empty(nb, np.int32),
        "child_count": np.empty(nb, np.int32),
        "body_start": np.empty(nb, np.int32),
        "body_count": np.empty(nb, np.int32),
        "is_leaf": np.empty(nb, np.uint8),
        "prefix": np.empty(nb, np.int64),
        "perm": np.empty(n, np.int64),
        "codes": np.empty(n, np.int64),
        "body_leaf": np.empty(n, np.int32),
    }
    lib.fmm_tree_fill(
        ctypes.c_void_p(h),
        *[_ptr(out[k]) for k in (
            "level", "parent", "child_start", "child_count", "body_start",
            "body_count", "is_leaf", "prefix", "perm", "codes", "body_leaf",
        )],
    )
    lib.fmm_tree_free(ctypes.c_void_p(h))
    return out


def traverse(src_tree, tgt_tree, theta):
    """Native dual-tree traversal -> (m2l_pairs, p2p_pairs) or None."""
    lib = get_lib()
    if lib is None:
        return None

    def args_for(t):
        return (
            ctypes.c_int64(t.num_boxes),
            _ptr(_i32(t.box_is_leaf.astype(np.int32))),
            _ptr(_i32(t.box_child_start)),
            _ptr(_i32(t.box_child_count)),
            _ptr(_f64(t.box_center)),
            _ptr(_f64(t.box_radius)),
        )

    sa = args_for(src_tree)
    ta = args_for(tgt_tree)
    h = lib.fmm_traverse(*sa, *ta, ctypes.c_double(theta))
    n_m2l = ctypes.c_int64()
    n_p2p = ctypes.c_int64()
    lib.fmm_lists_sizes(
        ctypes.c_void_p(h), ctypes.byref(n_m2l), ctypes.byref(n_p2p)
    )
    m2l = np.empty((n_m2l.value, 2), np.int32)
    p2p = np.empty((n_p2p.value, 2), np.int32)
    lib.fmm_lists_fill(ctypes.c_void_p(h), _ptr(m2l), _ptr(p2p))
    lib.fmm_lists_free(ctypes.c_void_p(h))
    return m2l, p2p


def near_coo(pairs, src_tree, tgt_tree):
    """Native near-field COO expansion -> (rows, cols) sorted by row,
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    pairs = _i32(pairs)
    sc = _i32(src_tree.box_body_count)
    ss = _i32(src_tree.box_body_start)
    tc = _i32(tgt_tree.box_body_count)
    ts = _i32(tgt_tree.box_body_start)
    nnz = lib.fmm_near_coo_size(
        ctypes.c_int64(len(pairs)), _ptr(pairs), _ptr(sc), _ptr(tc)
    )
    rows = np.empty(nnz, np.int32)
    cols = np.empty(nnz, np.int32)
    lib.fmm_near_coo_fill(
        ctypes.c_int64(len(pairs)),
        _ptr(pairs),
        _ptr(ss),
        _ptr(sc),
        _ptr(ts),
        _ptr(tc),
        _ptr(rows),
        _ptr(cols),
    )
    return rows, cols


def near_laplace(tgt_fields, src_fields, t_idx, s_idx, fine_K, kappa):
    """Native Laplace/Yukawa BEM near-entry assembly -> (G, dGdn) or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "fmm_near_laplace"):
        return None
    from fmm_bem_tpu_torch.bem.quadrature import get_rule

    rows = _i32(t_idx)
    cols = _i32(s_idx)
    nnz = len(rows)
    tc = _f64(tgt_fields["xyz"])
    sc = _f64(src_fields["xyz"])
    sv = _f64(src_fields["vertices"]).reshape(len(sc), 9)
    sa = _f64(src_fields["area"])
    sn = _f64(src_fields["normal"])
    qp = _f64(np.asarray(src_fields["qp_off"]) + np.asarray(src_fields["xyz"])[:, None, :])
    qw = _f64(src_fields["qw"])
    K = qw.shape[1]
    fp, fw = get_rule(fine_K)
    fp = _f64(fp)
    fw = _f64(fw)
    G = np.empty(nnz, np.float64)
    dG = np.empty(nnz, np.float64)
    lib.fmm_near_laplace(
        ctypes.c_int64(nnz),
        _ptr(rows),
        _ptr(cols),
        _ptr(tc),
        _ptr(sc),
        _ptr(sv),
        _ptr(sa),
        _ptr(sn),
        _ptr(qp),
        _ptr(qw),
        ctypes.c_int(K),
        _ptr(fp),
        _ptr(fw),
        ctypes.c_int(len(fw)),
        ctypes.c_double(kappa),
        _ptr(G),
        _ptr(dG),
    )
    return G, dG


def panel_fill(rows, cols, vals3, t_slot, s_slot, t_pos, s_pos,
               pair_key_sorted, mult, rdim, cdim, KT, KS, blocks):
    """Native near-panel block fill (see fmm_panel_fill); returns False
    when the library is unavailable so callers use the numpy fallback."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "fmm_panel_fill"):
        return False
    rows = _i32(rows)
    cols = _i32(cols)
    vals3 = np.ascontiguousarray(vals3, np.float32)
    t_slot = _i32(t_slot)
    s_slot = _i32(s_slot)
    t_pos = _i32(t_pos)
    s_pos = _i32(s_pos)
    pk = np.ascontiguousarray(pair_key_sorted, np.int64)
    assert blocks.dtype == np.float32 and blocks.flags.c_contiguous
    lib.fmm_panel_fill(
        ctypes.c_int64(len(rows)),
        _ptr(rows),
        _ptr(cols),
        _ptr(vals3),
        _ptr(t_slot),
        _ptr(s_slot),
        _ptr(t_pos),
        _ptr(s_pos),
        _ptr(pk),
        ctypes.c_int64(len(pk)),
        ctypes.c_int64(mult),
        ctypes.c_int(rdim),
        ctypes.c_int(cdim),
        ctypes.c_int(KT),
        ctypes.c_int(KS),
        _ptr(blocks),
    )
    return True


def near_candidates(pairs, src_tree, tgt_tree, t_xyz, s_xyz, s_area):
    """COO entries triggering the near-singular branch (see
    fmm_near_candidates) -> (rows, cols), or None without the library."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "fmm_near_candidates"):
        return None
    pairs = _i32(pairs)
    sc = _i32(src_tree.box_body_count)
    ss = _i32(src_tree.box_body_start)
    tc = _i32(tgt_tree.box_body_count)
    ts = _i32(tgt_tree.box_body_start)
    t_xyz = _f64(t_xyz)
    s_xyz = _f64(s_xyz)
    s_area = _f64(s_area)
    cap = 0
    rows = np.empty(0, np.int32)
    cols = np.empty(0, np.int32)
    n = lib.fmm_near_candidates(
        ctypes.c_int64(len(pairs)), _ptr(pairs), _ptr(ss), _ptr(sc),
        _ptr(ts), _ptr(tc), _ptr(t_xyz), _ptr(s_xyz), _ptr(s_area),
        _ptr(rows), _ptr(cols), ctypes.c_int64(cap),
    )
    rows = np.empty(n, np.int32)
    cols = np.empty(n, np.int32)
    lib.fmm_near_candidates(
        ctypes.c_int64(len(pairs)), _ptr(pairs), _ptr(ss), _ptr(sc),
        _ptr(ts), _ptr(tc), _ptr(t_xyz), _ptr(s_xyz), _ptr(s_area),
        _ptr(rows), _ptr(cols), ctypes.c_int64(n),
    )
    return rows, cols
