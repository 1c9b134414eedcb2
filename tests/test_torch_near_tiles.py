"""How the port's near_panel kernel cuts a store into blocks, on the CPU.

``ops/near_panel.py::near_tiling`` picks the chunks per block ``S`` and
the grid from the store's shapes; ``panel_matvec_tiled_reference`` models
the kernel's two passes (per-block partial sums, carries of the leaves
cut by block edges, the fix-up in block order).  Both are held here on
ragged stores made with numpy from a seed: the model against the plain
version ``panel_matvec_reference`` and the JAX package's
``panel_matvec(..., use_pallas=False)`` at f64 within 1e-12 (the sums
associate differently), leaves without chunks exactly 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmm_bem_tpu.ops import near_panel as jnp_mod
from fmm_bem_tpu_torch.ops import near_panel as tnp_mod

TOL = 1e-12


def ragged_store(counts, rng, KTr=5, KSc=6, m0=3, Lb=128, nl_src=9,
                 dummies=4):
    """``ops/near_panel.py::ragged_store_arrays`` of the given chunks per
    leaf, f64 from ``rng``, as torch and JAX stores.  Returns (torch
    store, meta, JAX store, meta, charges)."""
    arrays, meta = tnp_mod.ragged_store_arrays(counts, rng, KTr, KSc, m0,
                                               Lb, nl_src, dummies)
    ql = rng.standard_normal((nl_src, KSc))
    tstore = {k: torch.as_tensor(v) for k, v in arrays.items()}
    jstore = {k: jnp.asarray(arrays[k]) for k in ("A", "pidx", "chunk_tgt")}
    return tstore, meta, jstore, meta, ql


def blocks_of(row_ptr, C, S):
    """Per block of the first pass: its real chunks and the leaves it
    holds, each with whether the leaf is cut (its chunks leave the
    block)."""
    n_real = int(row_ptr[-1])
    out = []
    for b in range(-(-C // S)):
        c0, c1 = b * S, min((b + 1) * S, n_real)
        leaves = sorted({int(np.searchsorted(row_ptr, c, "right") - 1)
                         for c in range(c0, c1)})
        out.append((list(range(c0, c1)), [
            (l, bool(row_ptr[l] < c0 or row_ptr[l + 1] > c0 + S))
            for l in leaves]))
    return out


# (C, KTr, Lb, itemsize, sms): the stores the card path runs at 131,072
# panels (the cached store in f32 and f64, the dual ones of leaf pad 64
# and of K_s 136, the Yukawa program's) and edges (KTr past one row
# tile, a row of 8,192 columns, an empty store, one chunk, many narrow
# chunks)
SHAPES = [
    (39936, 64, 128, 4, 132), (39936, 64, 128, 8, 132),
    (25152, 64, 128, 4, 132), (4776, 64, 896, 4, 132),
    (320, 50, 128, 4, 132), (997, 136, 256, 8, 132),
    (2400, 72, 128, 4, 132), (37, 45, 8192, 8, 132), (0, 64, 128, 4, 132),
    (1, 1, 128, 4, 1), (100000, 8, 128, 4, 132),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_near_tiling(shape):
    C, KTr, Lb, itemsize, sms = shape
    t = tnp_mod.near_tiling(C, KTr, Lb, itemsize, sms)
    assert t.S >= 1 and t.nblocks == -(-C // t.S)
    assert t.nblocks * t.S >= C and (t.nblocks - 1) * t.S < max(C, 1)
    assert 1 <= t.warps <= tnp_mod.MAX_WARPS
    tile = t.warps * tnp_mod.ROWS_PER_WARP
    assert t.row_tiles * tile >= KTr and tile <= 64
    assert (t.row_tiles - 1) * tile < KTr  # no row tile is all idle
    assert t.grid == (t.nblocks, t.row_tiles)
    assert t.carry_shape(KTr) == (t.nblocks, 2, KTr)
    if t.S > 1:  # the staged charge rows fit, the blocks spread
        assert t.S * Lb * itemsize <= tnp_mod.STAGE_BYTES
        assert t.nblocks * t.row_tiles >= sms * tnp_mod.MIN_BLOCKS_PER_SM
        assert t.S * -(-KTr // t.row_tiles) * Lb * itemsize \
            <= tnp_mod.TILE_BYTES
    if KTr <= 64:
        assert t.row_tiles == 1 and tile - KTr < tnp_mod.ROWS_PER_WARP
    # the cached and dual stores of leaf pad 64 take two chunks a block
    if shape in ((39936, 64, 128, 4, 132), (25152, 64, 128, 4, 132)):
        assert t.S == 2 and t.nblocks == C // 2


@pytest.mark.parametrize("S", [1, 2, 3, 8, 64])
def test_blocks_cover_every_chunk_once(S):
    rng = np.random.default_rng(S)
    counts = tnp_mod.ragged_leaf_counts(S, rng)
    arrays, _ = tnp_mod.ragged_store_arrays(counts, rng, 5, 6, 3, 128, 9, 4)
    C = arrays["A"].shape[0]
    holds, lacks = tnp_mod.ragged_cases(counts, S, arrays["pidx"], 9, C)
    assert lacks == [] and holds["most_blocks_of_a_leaf"] >= 3
    rp = np.concatenate([[0], np.cumsum(counts)])
    blocks = blocks_of(rp, C, S)
    seen = [c for chunks, _ in blocks for c in chunks]
    assert seen == list(range(int(rp[-1])))  # each real chunk once, in order
    for chunks, leaves in blocks:
        assert len(chunks) <= S
        cut = [l for l, is_cut in leaves if is_cut]
        assert len(cut) <= 2
        # only the first and the last leaf of a block can be cut
        assert all(l in (leaves[0][0], leaves[-1][0]) for l in cut)
    # a leaf of 163 chunks spreads over ceil(163 / S) blocks or more,
    # and some leaf over three at least
    spans = [(rp[l + 1] - 1) // S - rp[l] // S + 1
             for l in range(len(counts)) if counts[l]]
    assert max(spans) >= max(3, -(-163 // S))


@pytest.mark.parametrize("S,n_real", [(1, None), (10, None), (10, 12000),
                                      (3, 2400)])
def test_ragged_cases_name_what_a_store_lacks(S, n_real):
    """The shared builder meets every case at the sizes of the tests and
    of chip_smoke.py's ragged stores, and the check names a case that a
    store without it lacks."""
    rng = np.random.default_rng(S)
    counts = tnp_mod.ragged_leaf_counts(S, rng, n_real)
    if n_real is not None:
        assert counts.sum() == n_real
    pidx = np.zeros((int(counts.sum()) + 1, 2), np.int32)
    pidx[0, 0] = 64
    _, lacks = tnp_mod.ragged_cases(counts, S, pidx, 64, len(pidx))
    assert lacks == []
    short = counts[counts != 163]
    _, lacks = tnp_mod.ragged_cases(short, S, pidx[:, 1:], 64,
                                    int(short.sum()))
    assert {"chunks_per_leaf", "dummy_chunks",
            "dummy_charge_tiles"} <= set(lacks)


@pytest.mark.parametrize("S", [1, 2, 3, 8, 64])
def test_tiled_reference_matches_plain_and_jax(S):
    rng = np.random.default_rng(100 + S)
    counts = tnp_mod.ragged_leaf_counts(S, rng)
    tstore, meta, jstore, jmeta, ql = ragged_store(counts, rng)
    # the store has what the kernel must get right
    _, lacks = tnp_mod.ragged_cases(counts, S, tstore["pidx"].numpy(), 9,
                                    tstore["A"].shape[0])
    assert lacks == []
    assert (tstore["chunk_tgt"] == meta.nl_t).any()
    got = tnp_mod.panel_matvec_tiled_reference(tstore, meta,
                                               torch.as_tensor(ql), S)
    assert got.shape == (meta.nl_t, 5) and torch.isfinite(got).all()
    assert (got[torch.as_tensor(counts == 0)] == 0).all()
    want = tnp_mod.panel_matvec_reference(tstore, meta, torch.as_tensor(ql))
    jwant = np.asarray(jnp_mod.panel_matvec(jstore, jmeta, jnp.asarray(ql),
                                            use_pallas=False))
    scale = float(np.abs(jwant).max())
    assert float((got - want).abs().max()) <= TOL * scale
    assert float(np.abs(got.numpy() - jwant).max()) <= TOL * scale
    # the wrapper takes the plain version on the CPU, no kernel launch
    before = tnp_mod.panel_matvec_fused.launches
    fused = tnp_mod.panel_matvec_fused(tstore, meta, torch.as_tensor(ql))
    assert tnp_mod.panel_matvec_fused.launches == before
    assert torch.equal(fused, want)


def test_tiled_reference_on_a_plan_store():
    """The model at the tiling the card would pick, and at S = 3, on the
    store of a small JAX-equal sphere plan (real chunks, dummies)."""
    from fmm_bem_tpu_torch.bem.panels import make_panels
    from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
    import fmm_bem_tpu_torch as T
    from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel

    plan = T.FmmPlan(LaplaceBEMKernel(K=3), make_panels(unit_sphere(3), K=3),
                     T.FMMConfig(ncrit=16, dtype="float64", max_p=4),
                     device="cpu")
    panels, meta = plan.near_panels()
    ql = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (len(plan.leaf_ids), meta.KS)))
    want = tnp_mod.panel_matvec_reference(panels, meta, ql)
    C, KTr, Lb = panels["A"].shape
    for S in (tnp_mod.near_tiling(C, KTr, Lb, 4, 132).S, 3):
        got = tnp_mod.panel_matvec_tiled_reference(panels, meta, ql, S)
        assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
