"""Checkpoint / resume of solver state.

The reference has no checkpointing (SURVEY.md §5.4 — its only
persistence is mesh/solution dumps).  For long relaxed-GMRES solves on
shared accelerators this subsystem saves and restores:

- the Krylov state (basis V, Hessenberg H, Givens terms, iterate x)
- the plan's charge-independent structures are NOT saved — they are
  deterministic functions of (points, config) and rebuild quickly; the
  near-field sparse values CAN be saved since their assembly (singular
  quadrature) dominates BEM plan builds.

Format: a single .npz per checkpoint (atomic rename), self-describing.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def save_checkpoint(path, **arrays):
    """Atomically save named arrays (scalars allowed) to ``path``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # numpy appends ".npz" unless the name already ends with it
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path):
    """Load a checkpoint into a dict of numpy arrays (None if absent)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def save_near_field(path, plan):
    """Persist the expensive near-field assembly of a BEM plan."""
    if plan.near_rows is None:
        raise ValueError("plan has no sparse near field")
    save_checkpoint(
        path,
        near_rows=plan.near_rows,
        near_cols=plan.near_cols,
        near_vals=plan.near_vals,
        n_bodies=plan.tree.num_bodies,
    )


def load_near_field(path, plan):
    """Restore near-field values into a freshly built plan (validates
    the sparsity pattern)."""
    data = load_checkpoint(path)
    if data is None:
        return False
    if int(data["n_bodies"]) != plan.tree.num_bodies or not np.array_equal(
        data["near_rows"], plan.near_rows
    ):
        return False
    plan.near_vals = data["near_vals"]
    plan._apply_cache.clear()
    plan._near_panel_cache.clear()  # panels derive from near_vals
    return True
