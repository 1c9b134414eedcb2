"""State carried across from the JAX package, as numpy.

``operand_from_numpy`` turns what the reference plan exposes — its
``device_data(p)``, its ``variant_aux_slots(p)`` (the ``"panels"`` dict
included) and the fields of its near-panel meta, all converted to numpy
arrays (and nested lists of them) by the caller — into the operand
``(d, aux, sf, tf)`` that ``FmmPlan._matvec_slots`` of this package
takes.  The table layouts of the two packages are the same, so nothing
is transposed: integers become index tensors, floats take the working
dtype, and the near-panel index arrays get the int32 form and the row
pointer the CUDA kernel reads.
"""

from __future__ import annotations

import numpy as np
import torch

from fmm_bem_tpu_torch.ops.near_panel import NearPanels


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


def operand_from_numpy(d, aux, panels, meta, device="cuda",
                       dtype=torch.float32, fields=None):
    """Build the ``_matvec_slots`` operand from numpy state.

    d : the reference ``plan.device_data(p)`` as numpy.
    aux : the reference ``plan.variant_aux_slots(p)`` as numpy, without
        its ``"panels"`` entry (or with: it is replaced).
    panels : that ``"panels"`` dict as numpy (``A``, ``pidx``,
        ``chunk_tgt``).
    meta : mapping or object with the near-panel meta fields ``nl_t,
        m0, block_rows, npairs, rdim, cdim, KT, KS``.
    fields : per-panel field arrays in Morton order (numpy) for the
        target side of the M2P pass; may be omitted when the plan has
        no level-skewed pairs.
    Returns ``(d, aux, sf, tf)`` on ``device``.
    """
    device = torch.device(device)
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
    out_aux = _to_torch(
        {k: v for k, v in aux.items() if k != "panels"}, device, dtype
    )
    out_aux["panels"] = dev_panels
    out_aux["near_meta"] = near_meta
    sf = _to_torch(
        {k: v for k, v in (fields or {}).items() if k != "vertices"},
        device, dtype,
    )
    return _to_torch(d, device, dtype), out_aux, sf, sf
