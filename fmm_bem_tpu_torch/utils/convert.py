"""State carried across from the JAX package, as numpy.

``operand_from_numpy`` turns what the reference plan exposes — its
``device_data(p)``, its ``variant_aux_slots(p)`` (the ``"panels"`` dict
included) and the fields of its near-panel meta, all converted to numpy
arrays (and nested lists of them) by the caller — into the operand
``(d, aux, sf, tf)`` that ``FmmPlan._matvec_slots`` of this package
takes.  The table layouts of the two packages are the same, so nothing
is transposed: integers become index tensors, floats take the working
dtype, and the near-panel index arrays get the int32 form and the row
pointer the CUDA kernel reads.  Where the plan has level-skewed pairs
and the target fields carry BC flags, the M2P pair tables
(``d["m2p_tiles"]``) and the BC tile of the variant (``aux["m2p_bc"]``)
that ``ops/m2p_tile.py`` reads are built here from ``d``, once.

``otf_panels_from_numpy`` does the same for the on-the-fly near mode:
the reference plan's ``near_panels()`` dict (leaf-tiled panel fields,
target-sorted pair lists, correction deltas and their index structures)
becomes the ``"panels"`` dict this package's ``_near_otf_core`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from fmm_bem_tpu_torch.ops.m2p_tile import pair_tables
from fmm_bem_tpu_torch.ops.near_panel import (
    NearPanels,
    chunk_row_ptr,
    leaf_counts,
)
from fmm_bem_tpu_torch.ops.otf_tile import pack_otf_src, pack_otf_tgt


def _to_torch(obj, device, dtype):
    """Nested dict/list/tuple of numpy arrays -> the same nest of
    tensors: floats in ``dtype``, integers as int64 index tensors,
    booleans as bool masks; ``None`` stays."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: _to_torch(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v, device, dtype) for v in obj)
    a = np.array(obj)  # a writable, contiguous copy
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    raise TypeError(f"operand_from_numpy: unsupported array dtype {a.dtype}")


#: what a kernel carries beside its class: the parameters both packages'
#: kernels must agree on before state crosses between them
KERNEL_PARAMETERS = ("kappa", "K", "fine_K", "mu")


def check_kernels_agree(ref_kernel, kernel):
    """Raise ``ValueError`` unless the reference plan's kernel and this
    package's are the same kernel: the same ``name`` and the same
    parameters (``KERNEL_PARAMETERS``; the tables carried across were
    built from them, and the kernel's own device operators use them)."""
    names = (getattr(ref_kernel, "name", None), getattr(kernel, "name", None))
    if names[0] != names[1]:
        raise ValueError(f"kernels differ: {names[0]!r} against {names[1]!r}")
    for attr in KERNEL_PARAMETERS:
        a = getattr(ref_kernel, attr, None)
        b = getattr(kernel, attr, None)
        if a != b:
            raise ValueError(
                f"kernel {names[1]!r}: {attr} = {a!r} in the reference, "
                f"{b!r} here"
            )


def operand_from_numpy(d, aux, panels, meta, device="cuda",
                       dtype=torch.float32, fields=None, kernels=None):
    """Build the ``_matvec_slots`` operand from numpy state.

    d : the reference ``plan.device_data(p)`` as numpy.
    aux : the reference ``plan.variant_aux_slots(p)`` as numpy, without
        its ``"panels"`` entry (or with: it is replaced).
    panels : that ``"panels"`` dict as numpy (``A``, ``pidx``,
        ``chunk_tgt``), or ``None`` for a point kernel (no near store).
    meta : mapping or object with the near-panel meta fields ``nl_t,
        m0, block_rows, npairs, rdim, cdim, KT, KS`` (``None`` with
        ``panels``).
    fields : per-body field arrays in Morton order (numpy): the target
        side of the M2P pass (its BC flags give ``aux["m2p_bc"]``) and
        of a table-less L2P, both sides of a point kernel's P2P; may be
        omitted for a BEM plan with no level-skewed pairs.
    kernels : optional ``(reference kernel, this package's kernel)``,
        held to each other by ``check_kernels_agree`` first.
    Returns ``(d, aux, sf, tf)`` on ``device``.
    """
    if kernels is not None:
        check_kernels_agree(*kernels)
    device = torch.device(device)
    out_aux = _to_torch(
        {k: v for k, v in aux.items() if k != "panels"}, device, dtype
    )
    sf = _to_torch(
        {k: v for k, v in (fields or {}).items() if k != "vertices"},
        device, dtype,
    )
    out_d = _to_torch(d, device, dtype)
    if len(d.get("m2p_src", ())) and "bc" in (fields or {}):
        _m2p_tables(d, fields["bc"], out_d, out_aux, device, dtype)
    if panels is None:
        return out_d, out_aux, sf, sf
    get = meta.get if isinstance(meta, dict) else lambda k: getattr(meta, k)
    near_meta = NearPanels(
        A=None,
        pidx=np.array(panels["pidx"], np.int32),
        chunk_tgt=np.array(panels["chunk_tgt"], np.int32),
        **{
            k: int(get(k))
            for k in ("nl_t", "m0", "block_rows", "npairs", "rdim",
                      "cdim", "KT", "KS")
        },
    )
    dev_panels = near_meta.index_tensors(device)
    dev_panels["A"] = torch.as_tensor(
        np.array(panels["A"]), dtype=dtype, device=device
    )
    out_aux["panels"] = dev_panels
    out_aux["near_meta"] = near_meta
    return out_d, out_aux, sf, sf


def _m2p_tables(d, bc, out_d, out_aux, device, dtype):
    """The M2P pair tables of ``ops/m2p_tile.py::pair_tables`` from the
    numpy ``d`` into ``out_d["m2p_tiles"]`` (int32 tables, floats in
    ``dtype``), and the BC tile [nb, K] of the pairs' target leaves from
    the per-body flags ``bc`` into ``out_aux["m2p_bc"]``."""
    idx = np.asarray(d["t_leaf_body_idx"])
    rows = pair_tables(
        d["m2p_src"], d["m2p_tgt_slot"], d["m2p_inv_sigma"], idx,
        np.asarray(d["t_slot_mask"]).reshape(idx.shape), d["t_xyz"],
    )
    out_d["m2p_tiles"] = {
        k: torch.as_tensor(
            v, dtype=torch.int32 if v.dtype.kind in "iu" else dtype,
            device=device)
        for k, v in rows.items()
    }
    out_aux["m2p_bc"] = torch.as_tensor(
        np.asarray(bc)[idx[rows["leaves"]]], dtype=dtype, device=device)


def otf_panels_from_numpy(panels, device="cuda", dtype=torch.float32):
    """Build the on-the-fly ``"panels"`` dict from numpy state.

    panels : the reference plan's OTF ``near_panels()[0]`` as numpy:
        ``otf_tiles`` with the leaf-tiled fields ``s_tiles`` / ``t_tiles``
        (one dummy leaf row appended), their masks and the target-sorted
        chunk-padded pair lists ``sslot`` / ``tslot``, plus the
        correction deltas (``corr_valw`` + ``corr_gleaf`` / ``corr_gidx``
        / ``corr_rowof``, or ``corr_colp`` + ``corr_valp`` /
        ``corr_rowof_e``).
    The leaf tiles are packed here, in ``dtype``, into the source and
    target tables of ops/otf_tile.py; the pair lists lose their chunk
    padding and get the int32 form, the row pointer and the count tables
    the CUDA kernel reads.
    """
    device = torch.device(device)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    ot = panels["otf_tiles"]
    s_mask = np.asarray(ot["s_mask"])[:-1]
    t_mask = np.asarray(ot["t_mask"])[:-1]
    s_tiles = {k: np.asarray(v)[:-1] for k, v in ot["s_tiles"].items()}
    KQ = s_tiles["qp_off"].shape[2]
    # the reference pads both lists to whole chunks with the dummy leaf
    tslot = np.asarray(ot["tslot"], np.int32)
    real = tslot < len(t_mask)
    sslot = np.asarray(ot["sslot"], np.int32)[real]
    tslot = tslot[real]

    def put(a, dt):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    out = _to_torch(
        {k: v for k, v in panels.items() if k != "otf_tiles"}, device, dtype
    )
    out["otf_tiles"] = {
        "sb_src": put(pack_otf_src(s_tiles, s_mask, KQ, npdt), dtype),
        "sb_tgt": put(
            pack_otf_tgt(
                np.asarray(ot["t_tiles"]["xyz"])[:-1],
                np.asarray(ot["t_tiles"]["bc"])[:-1], t_mask, npdt,
            ),
            dtype,
        ),
        "sslot": put(sslot, torch.int32),
        "row_ptr": put(chunk_row_ptr(tslot, len(t_mask)), torch.int32),
        "src_cnt": put(leaf_counts(s_mask), torch.int32),
        "tgt_cnt": put(leaf_counts(t_mask), torch.int32),
    }
    return out
