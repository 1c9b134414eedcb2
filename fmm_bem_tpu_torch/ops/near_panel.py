"""Near-field leaf-panel matvec (the array form of EvalInteractionLazySparse).

The reference caches the singular/near-singular panel integrals in a CSR
matrix and replays ``results += A @ charges`` every GMRES iteration
(EvalInteractionLazySparse.hpp:112,134-150).  Here every target leaf's
near field is a row of dense interaction blocks against its m near-field
source leaves.  Those rows are packed into fixed-width CHUNKS of m0
source leaves each —

    A  [C, KT*rdim, m0 * KS*cdim]      (C = sum_l ceil(m_l / m0))

so the whole near field is ONE uniformly-shaped batched matvec that
touches the panel bytes exactly once: it is bound by the device-memory
rate.  Chunks are sorted by target leaf, so a row pointer over
``chunk_tgt`` gives each leaf a contiguous chunk range.

The product has two routes, picked by ``near_route`` from the store's
entry shape alone, on CPU and CUDA tensors alike:

- ``"fused"`` (scalar entries, ``rdim * cdim == 1``: Laplace and Yukawa
  BEM): ``panel_matvec_fused``.  On CUDA tensors one hand-written
  kernel, ``csrc/near_panel.cu``, gathers the charge tiles, contracts
  and reduces per leaf: blocks take equal runs of ``S`` chunks
  (``near_tiling``), and a second small launch sums the leaves cut by
  block edges.  On CPU tensors the plain PyTorch version
  ``panel_matvec_reference`` runs; ``panel_matvec_tiled_reference``
  models the kernel's two passes for the tests.
- ``"two_stage"`` (matrix entries, ``rdim * cdim > 1``: Stokes BEM):
  ``panel_matvec_two_stage``.  The charge tiles are gathered into chunk
  rows ``[Cpad, Lb]`` by plain tensor ops, ``panel_contract`` computes
  ``out[c] = A[c] @ x[c]`` for every chunk (on CUDA tensors the
  hand-written kernel ``csrc/panel_contract.cu``, on CPU tensors the
  plain version ``panel_contract_reference``), and the leaf-sorted chunk
  rows are summed per leaf by segments (no atomics: the bits repeat).

Neither wrapper gives way to its plain version on a CUDA tensor: it
launches its kernel or raises.

``m0`` is chosen per plan to minimise padded bytes (see choose_m0).  The
store layout (``Lb`` rounded up to 128 columns, ``Cpad`` rounded up to
``block_rows``) is the JAX package's, kept so that state carries across
array for array.

Supports scalar entries (Laplace/Yukawa BEM: rdim = cdim = 1) and
matrix entries (Stokes BEM: 3x3 blocks) by expanding to DOF-level
rows/columns.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types

import numpy as np
import torch

#: candidate chunk widths (source leaves per chunk)
M0_CANDIDATES = (2, 4, 6, 8, 12, 16, 24, 32)

#: device-assembly one-shot limit: above this transient-bytes estimate
#: the quadrature blocks + A gather run in row chunks (tests shrink it
#: to force the chunked path on small meshes)
ONE_SHOT_LIMIT = 2 << 30

#: transient-bytes budget of one row chunk of the chunked assembly
CHUNK_BUDGET = 1 << 30


def choose_m0(m_per, KSc, candidates=M0_CANDIDATES):
    """Chunk width minimising total padded panel bytes.

    Cost of width m0: sum_l ceil(m_l/m0) chunks, each storing
    roundup(m0*KSc, 128) columns.  Ties prefer the larger width (fewer
    rows -> fewer reduction terms).
    """
    m_per = np.asarray(m_per)
    m_per = m_per[m_per > 0]
    if len(m_per) == 0:
        return candidates[0]
    best, best_cost = None, None
    for m0 in candidates:
        lanes = -(-m0 * KSc // 128) * 128
        cost = int((-(-m_per // m0)).sum()) * lanes
        if best_cost is None or cost < best_cost or (
            cost == best_cost and m0 > best
        ):
            best, best_cost = m0, cost
    return best


def _block_rows(KTr, Lb, target_bytes=2 << 20):
    """Chunk-count granularity of the store (``Cpad`` is a multiple of
    it): the JAX package's rows per grid step, kept for layout parity."""
    row_bytes = KTr * Lb * 4
    bl = max(1, target_bytes // max(row_bytes, 1))
    # power of two, capped
    bl = 1 << (int(bl).bit_length() - 1)
    return int(min(bl, 256))


def chunk_row_ptr(chunk_tgt, nl_t):
    """Row pointer [nl_t + 1] over the leaf-sorted ``chunk_tgt``: leaf l
    owns chunks ``row_ptr[l] : row_ptr[l + 1]``; dummy chunks
    (``chunk_tgt == nl_t``) sort last and belong to no leaf."""
    chunk_tgt = np.asarray(chunk_tgt)
    if len(chunk_tgt) > 1 and np.any(np.diff(chunk_tgt) < 0):
        raise ValueError("chunk_tgt must be sorted by target leaf")
    return np.searchsorted(chunk_tgt, np.arange(nl_t + 1)).astype(np.int32)


def leaf_counts(mask):
    """Count table [nl + 1] int32 of a leaf body mask [nl, K]: the real
    slots of each leaf, then 0 for the closing dummy tile.  Raises if a
    leaf's real slots do not lead its tile (``mask[l] == arange(K) <
    count[l]``), which is what the leaf-tile kernels ``otf_tile`` and
    ``p2p_tile`` rely on."""
    mask = np.asarray(mask, bool)
    cnt = mask.sum(axis=1)
    if not np.array_equal(mask, np.arange(mask.shape[1]) < cnt[:, None]):
        raise ValueError("leaf_counts: real slots do not lead every tile")
    return np.append(cnt, 0).astype(np.int32)


@dataclasses.dataclass
class NearPanels:
    """Host-side chunk structure; ``device()`` uploads the arrays."""

    #: [C, KTr, Lb] chunk panels (None when assembled on device)
    A: object
    #: [C, m0] source-leaf slot per chunk column group (dummy = nl_src)
    pidx: np.ndarray
    #: [C] local target-leaf index per chunk (dummy = nl_t)
    chunk_tgt: np.ndarray
    nl_t: int
    m0: int
    block_rows: int
    npairs: int
    rdim: int
    cdim: int
    KT: int
    KS: int

    def index_tensors(self, device):
        """pidx / chunk_tgt / row_ptr as int32 tensors on ``device``."""
        return {
            "pidx": torch.as_tensor(
                np.ascontiguousarray(self.pidx, np.int32), device=device
            ),
            "chunk_tgt": torch.as_tensor(
                np.ascontiguousarray(self.chunk_tgt, np.int32), device=device
            ),
            "row_ptr": torch.as_tensor(
                chunk_row_ptr(self.chunk_tgt, self.nl_t), device=device
            ),
        }

    def device(self, dtype, device):
        out = self.index_tensors(device)
        out["A"] = torch.as_tensor(self.A, dtype=dtype, device=device)
        return out

    @property
    def nbytes(self):
        return 0 if self.A is None else self.A.nbytes


def _sorted_pairs(pair_src_slot, pair_tgt_slot, tgt_slot_local,
                  src_slot_local, nl_t):
    """Sort pairs by (target slot, source slot) and build the per-leaf
    row pointer (target-contiguous panels + strictly increasing pair
    keys for entry searchsorted)."""
    pair_tgt_slot = np.asarray(pair_tgt_slot)
    pair_src_slot = np.asarray(pair_src_slot)
    po = np.lexsort((pair_src_slot, pair_tgt_slot))
    ts = pair_tgt_slot[po]
    ss = pair_src_slot[po]
    # bucket rows by the (local) target index; a monotone local map
    # preserves the sort order above
    ts_b = ts if tgt_slot_local is None else tgt_slot_local[ts]
    ss_l = ss if src_slot_local is None else src_slot_local[ss]
    row_ptr = np.searchsorted(ts_b, np.arange(nl_t + 1))
    return ts, ss, ss_l, row_ptr


def _chunk_layout(row_ptr, m0, npairs, ss_l, nl_src, nl_t, bl):
    """Vectorised chunk bookkeeping.

    Returns (pair_ids [Cpad, m0] with dummy = npairs,
             pidx [Cpad, m0] with dummy = nl_src,
             chunk_tgt [Cpad] with dummy = nl_t).
    """
    m_per = np.diff(row_ptr)
    nchunk = -(-m_per // m0)  # ceil
    C = int(nchunk.sum())
    Cpad = max(-(-max(C, 1) // bl) * bl, bl)
    pair_ids = np.full((Cpad, m0), npairs, np.int32)
    pidx = np.full((Cpad, m0), nl_src, np.int32)
    chunk_tgt = np.full(Cpad, nl_t, np.int32)
    if C:
        l_of_c = np.repeat(np.arange(nl_t), nchunk)
        cum = np.concatenate([[0], np.cumsum(nchunk)])
        j_of_c = np.arange(C) - cum[l_of_c]
        starts = row_ptr[l_of_c] + j_of_c * m0
        counts = np.minimum(row_ptr[l_of_c + 1] - starts, m0)
        k = np.arange(m0)
        pid = starts[:, None] + k[None, :]
        valid = k[None, :] < counts[:, None]
        pair_ids[:C] = np.where(valid, pid, npairs)
        pidx[:C] = np.where(
            valid, ss_l[np.clip(pid, 0, max(npairs - 1, 0))], nl_src
        )
        chunk_tgt[:C] = l_of_c
    return pair_ids, pidx, chunk_tgt


def build_near_panels(
    pair_src_slot,
    pair_tgt_slot,
    rows,
    cols,
    vals,
    src_side,
    tgt_side,
    nl_t,
    m0=None,
    dtype=np.float32,
    tgt_slot_local=None,
    src_slot_local=None,
    nl_src_local=None,
):
    """Assemble uniform chunk panels from COO near-field entries.

    Parameters
    ----------
    pair_src_slot / pair_tgt_slot : leaf-slot ids per near leaf pair.
    rows / cols : Morton body indices per entry (target, source).
    vals : [nnz] scalar or [nnz, rdim, cdim] matrix entry values,
        already BC-selected for the operator variant.
    src_side / tgt_side : plan _TreeSide objects (leaf tiles).
    m0 : chunk width override.
    tgt_slot_local / src_slot_local : optional monotone global->local
        slot maps (chunk rows / charge-table columns indexed in a local
        numbering while entry bookkeeping stays global).  ``nl_t`` then
        counts LOCAL target leaves and ``nl_src_local`` sizes the local
        charge table.
    """
    vals = np.asarray(vals)
    if vals.ndim == 1:
        rdim = cdim = 1
        vals3 = vals[:, None, None]
    else:
        rdim, cdim = vals.shape[1], vals.shape[2]
        vals3 = vals
    KT, KS = tgt_side.leaf_pad, src_side.leaf_pad
    KTr, KSc = KT * rdim, KS * cdim

    ts, ss, ss_l, row_ptr = _sorted_pairs(
        pair_src_slot, pair_tgt_slot, tgt_slot_local, src_slot_local,
        nl_t,
    )
    npairs = len(ts)

    # entry -> (pair, in-block position)
    st_leaf = src_side.tree.body_leaf
    tt_leaf = tgt_side.tree.body_leaf
    s_slot = src_side.box_to_slot[st_leaf]
    t_slot = tgt_side.box_to_slot[tt_leaf]
    s_pos = np.arange(src_side.tree.num_bodies) - \
        src_side.tree.box_body_start[st_leaf]
    t_pos = np.arange(tgt_side.tree.num_bodies) - \
        tgt_side.tree.box_body_start[tt_leaf]
    mult = int(len(src_side.leaf_ids)) + 1
    pair_key = ts.astype(np.int64) * mult + ss

    blocks = np.zeros((npairs, KTr, KSc), dtype)
    from fmm_bem_tpu_torch import native

    filled = np.dtype(dtype) == np.float32 and native.panel_fill(
        rows, cols, np.ascontiguousarray(vals3, np.float32),
        t_slot, s_slot, t_pos, s_pos, pair_key, mult,
        rdim, cdim, KT, KS, blocks,
    )
    if not filled:
        # numpy fallback (f64 accuracy runs / missing .so)
        entry_key = t_slot[rows].astype(np.int64) * mult + s_slot[cols]
        pidx_e = np.searchsorted(pair_key, entry_key)
        rr = t_pos[rows] * rdim
        cc = s_pos[cols] * cdim
        for i in range(rdim):
            for j in range(cdim):
                blocks[pidx_e, rr + i, cc + j] = vals3[:, i, j]

    if m0 is None:
        m0 = choose_m0(np.diff(row_ptr), KSc)
    Lb = -(-m0 * KSc // 128) * 128
    bl = _block_rows(KTr, Lb)
    nl_src = (
        len(src_side.leaf_ids) if nl_src_local is None else nl_src_local
    )
    pair_ids, pidx, chunk_tgt = _chunk_layout(
        row_ptr, m0, npairs, ss_l, nl_src, nl_t, bl
    )

    blocks_z = np.concatenate(
        [blocks, np.zeros((1, KTr, KSc), dtype)], axis=0
    )
    Cpad = pair_ids.shape[0]
    A = np.zeros((Cpad, KTr, Lb), dtype)
    A[:, :, : m0 * KSc] = (
        blocks_z[pair_ids]
        .transpose(0, 2, 1, 3)
        .reshape(Cpad, KTr, m0 * KSc)
    )
    return NearPanels(
        A=A,
        pidx=pidx,
        chunk_tgt=chunk_tgt,
        nl_t=nl_t,
        m0=m0,
        block_rows=bl,
        npairs=npairs,
        rdim=rdim,
        cdim=cdim,
        KT=KT,
        KS=KS,
    )


def build_near_panels_on_device(
    pair_src_slot,
    pair_tgt_slot,
    src_side,
    tgt_side,
    nl_t,
    blocks_fn,
    corr=None,
    rdim=1,
    cdim=1,
    m0=None,
    dtype=torch.float32,
    device="cuda",
    tgt_slot_local=None,
    src_slot_local=None,
    nl_src_local=None,
):
    """Assemble uniform chunk panels with the interaction blocks
    computed ON the device.

    The regular K-point quadrature entries (the overwhelming bulk) are
    smooth closed-form evaluations — ideal device work — so only the
    near-singular corrections (``corr``) are computed on the host
    (branchy semi-analytical integrals, a few % of entries).

    Parameters
    ----------
    blocks_fn : callable ``(ss, ts) -> [npairs, KT*rdim, KS*cdim]``
        device blocks for the given (src leaf slot, tgt leaf slot)
        pair index tensors (the plan wraps the kernel's
        ``near_block_device``).
    corr : optional ``(rows, cols, vals)`` host COO of near-singular
        entries (Morton body ids; vals already BC-selected,
        [nnz] or [nnz, rdim, cdim]) overwriting the quadrature values.
    Returns (device_dict, NearPanels meta).
    """
    device = torch.device(device)
    KT, KS = tgt_side.leaf_pad, src_side.leaf_pad
    KTr, KSc = KT * rdim, KS * cdim
    ts, ss, ss_l, row_ptr = _sorted_pairs(
        pair_src_slot, pair_tgt_slot, tgt_slot_local, src_slot_local,
        nl_t,
    )
    npairs = len(ts)
    nl_src = (
        len(src_side.leaf_ids) if nl_src_local is None else nl_src_local
    )

    # host: near-singular corrections as FLAT indices into the block
    # array (one 1-D indexed assignment)
    if corr is not None and len(corr[0]):
        rows, cols, vals = corr
        vals = np.asarray(vals)
        vals3 = vals[:, None, None] if vals.ndim == 1 else vals
        s_slot = src_side.box_to_slot[src_side.tree.body_leaf]
        t_slot = tgt_side.box_to_slot[tgt_side.tree.body_leaf]
        s_pos = np.arange(src_side.tree.num_bodies) - \
            src_side.tree.box_body_start[src_side.tree.body_leaf]
        t_pos = np.arange(tgt_side.tree.num_bodies) - \
            tgt_side.tree.box_body_start[tgt_side.tree.body_leaf]
        # GLOBAL slot multiplier: ss and s_slot are global leaf slots
        # even when the charge table is locally renumbered
        mult = int(len(src_side.leaf_ids)) + 1
        pair_key = ts.astype(np.int64) * mult + ss
        entry_key = t_slot[rows].astype(np.int64) * mult + s_slot[cols]
        pidx_e = np.searchsorted(pair_key, entry_key)
        rr = (t_pos[rows] * rdim).astype(np.int64)
        cc = (s_pos[cols] * cdim).astype(np.int64)
    else:
        pidx_e = np.zeros(0, np.int64)
        rr = cc = np.zeros(0, np.int64)
        vals3 = np.zeros((0, rdim, cdim))

    def _flat_idx(pe, rre, cce):
        """Flat indices into a [*, KTr, KSc] block array for the
        near-singular correction entries."""
        base = pe.astype(np.int64) * KTr * KSc
        return (
            base[:, None, None]
            + (rre[:, None] + np.arange(rdim))[:, :, None] * KSc
            + (cce[:, None] + np.arange(cdim))[:, None, :]
        ).reshape(-1)

    if m0 is None:
        m0 = choose_m0(np.diff(row_ptr), KSc)
    Lb = -(-m0 * KSc // 128) * 128
    bl = _block_rows(KTr, Lb)
    pair_ids, pidx, chunk_tgt = _chunk_layout(
        row_ptr, m0, npairs, ss_l, nl_src, nl_t, bl
    )
    Cpad = pair_ids.shape[0]

    def _idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def assemble(blocks, corr_idx, corr_vals, pair_ids_l, out):
        """Overwrite the corrected entries of ``blocks`` [P, KTr, KSc],
        gather them by ``pair_ids_l`` [rows, m0] (dummy = P, a zero
        block) and write the chunk rows into ``out`` [rows, KTr, Lb]."""
        nrow = pair_ids_l.shape[0]
        blocks = blocks.contiguous()
        flat = blocks.view(-1)
        flat[_idx(corr_idx)] = torch.as_tensor(
            corr_vals, dtype=dtype, device=device
        )
        blocks_z = torch.cat(
            [blocks, torch.zeros((1, KTr, KSc), dtype=dtype, device=device)],
            dim=0,
        )
        blk = blocks_z[_idx(pair_ids_l)]  # [rows, m0, KTr, KSc]
        out[:, :, : m0 * KSc] = blk.permute(0, 2, 1, 3).reshape(
            nrow, KTr, m0 * KSc
        )

    # the quadrature-block computation materialises per-pair
    # [KT, KS, K, 3] geometry.  Past the one-shot limit the assembly
    # runs in row-chunks, computing only each chunk's pair RANGE (pairs
    # are target-sorted, so a row chunk's pairs are contiguous) and
    # writing it in place into the preallocated store.
    A_dev = torch.zeros((Cpad, KTr, Lb), dtype=dtype, device=device)
    one_shot_bytes = npairs * KT * KS * 16
    if one_shot_bytes <= ONE_SHOT_LIMIT:
        blocks = blocks_fn(_idx(ss), _idx(ts))
        assemble(
            blocks, _flat_idx(pidx_e, rr, cc), vals3.reshape(-1),
            pair_ids, A_dev,
        )
    else:
        budget_pairs = CHUNK_BUDGET // (KT * KS * 16)
        CH = max(bl, (budget_pairs // max(m0, 1)) // bl * bl)
        for c0 in range(0, Cpad, CH):
            pids = pair_ids[c0 : c0 + CH]
            real = pids[pids < npairs]
            if len(real) == 0:  # dummy rows only: the store is zero there
                continue
            lo, hi = int(real.min()), int(real.max()) + 1
            pl = np.where(pids < npairs, pids - lo, hi - lo)
            sel = (pidx_e >= lo) & (pidx_e < hi)
            blocks = blocks_fn(_idx(ss[lo:hi]), _idx(ts[lo:hi]))
            assemble(
                blocks, _flat_idx(pidx_e[sel] - lo, rr[sel], cc[sel]),
                vals3[sel].reshape(-1), pl, A_dev[c0 : c0 + CH],
            )

    meta = NearPanels(
        A=None,
        pidx=pidx,
        chunk_tgt=chunk_tgt,
        nl_t=nl_t,
        m0=m0,
        block_rows=bl,
        npairs=npairs,
        rdim=rdim,
        cdim=cdim,
        KT=KT,
        KS=KS,
    )
    dev = meta.index_tensors(device)
    dev["A"] = A_dev
    return dev, meta


def panel_matvec_reference(panels, meta, ql):
    """Plain PyTorch version of the near-field product: gather the
    charge tiles (dummy ``pidx == nl_src`` reads an appended zero row),
    contract every chunk with its panel, and sum each leaf's chunks
    (dummy ``chunk_tgt == nl_t`` lands in a dropped tail row)."""
    A = panels["A"]
    pidx = panels["pidx"].long()
    chunk_tgt = panels["chunk_tgt"].long()
    C, KTr, Lb = A.shape
    m0 = pidx.shape[1]
    KSc = meta.KS * meta.cdim
    xq = torch.cat(
        [ql, torch.zeros((1, KSc), dtype=ql.dtype, device=ql.device)], dim=0
    )
    xb = xq[pidx].reshape(C, m0 * KSc)
    if Lb > m0 * KSc:
        xb = torch.nn.functional.pad(xb, (0, Lb - m0 * KSc))
    out = torch.einsum("lts,ls->lt", A, xb)
    seg = torch.zeros(
        (meta.nl_t + 1, KTr), dtype=out.dtype, device=out.device
    )
    seg.index_add_(0, chunk_tgt, out)
    return seg[: meta.nl_t]


#: bytes of ``A`` one block of the near_panel kernel aims to stream
TILE_BYTES = 64 << 10
#: fewest blocks per SM the near_panel tiling aims for
MIN_BLOCKS_PER_SM = 8
#: shared memory a block's staged charge rows may take (above it, S = 1)
STAGE_BYTES = 32 << 10
#: output rows per warp and warps per block at most of the kernel
ROWS_PER_WARP, MAX_WARPS = 8, 8


@dataclasses.dataclass(frozen=True)
class NearTiling:
    """How ``csrc/near_panel.cu`` cuts one store: block ``b`` takes the
    chunks ``[b * S, (b + 1) * S)`` of the leaf-sorted list and row tile
    ``y`` of ``row_tiles``; ``warps`` warps of ``ROWS_PER_WARP`` rows
    each make a row tile."""

    S: int
    nblocks: int
    warps: int
    row_tiles: int

    @property
    def grid(self):
        return (self.nblocks, self.row_tiles)

    def carry_shape(self, KTr):
        """Two carry slots of a row per block: the leaves its first and
        last edge cut."""
        return (self.nblocks, 2, KTr)


@functools.lru_cache(maxsize=256)  # once per store shape: host time per call
def near_tiling(C, KTr, Lb, itemsize, sms):
    """Chunks per block ``S`` and the grid of the near_panel kernel for a
    store ``[C, KTr, Lb]`` of ``itemsize``-byte entries on a card of
    ``sms`` SMs, from the shapes alone (no read of the store).

    Row tiles of at most 64 rows split ``KTr`` evenly, ``ceil(rows / 8)``
    warps each.  ``S`` is the largest count that keeps a block's bytes of
    ``A`` near ``TILE_BYTES``, leaves ``MIN_BLOCKS_PER_SM`` blocks per SM
    and fits the staged charge rows in ``STAGE_BYTES``; never below 1.
    A block's carries (two rows) are then at most ``2 / (S * Lb)`` of
    its bytes: 1.6 % at ``Lb`` 128 and ``S`` 1."""
    row_tiles = max(1, -(-KTr // (ROWS_PER_WARP * MAX_WARPS)))
    rows = -(-KTr // row_tiles)
    warps = max(1, -(-rows // ROWS_PER_WARP))
    chunk_bytes = max(1, rows * Lb * itemsize)
    S = max(1, min(
        TILE_BYTES // chunk_bytes,
        C * row_tiles // (max(sms, 1) * MIN_BLOCKS_PER_SM),
        STAGE_BYTES // max(1, Lb * itemsize),
    ))
    return NearTiling(S=int(S), nblocks=int(-(-C // S)), warps=int(warps),
                      row_tiles=int(row_tiles))


_SM_COUNTS = {}


def sm_count(device):
    """SMs of the card ``device`` (read once per card: no sync)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNTS[idx]


def panel_matvec_tiled_reference(panels, meta, ql, S):
    """Plain PyTorch model of the near_panel kernel's two passes at ``S``
    chunks per block, for tests and ``chip_smoke.py`` only: per-block
    partial sums of each leaf (chunk order), written to the result when
    the leaf lies in one block and to the block's carry slot (0 where
    the leaf starts at or before the block, else 1) when it is cut;
    then each cut leaf sums its carries in block order and a leaf
    without chunks gets 0.  Slots the first pass leaves unwritten hold
    NaN, so reading one shows.  Same arguments and result as
    ``panel_matvec_reference``."""
    A = panels["A"]
    C, KTr, Lb = A.shape
    rp = panels["row_ptr"].long()
    n_real = int(rp[-1])
    xb = chunk_charge_rows(panels, ql)[:n_real]
    part = torch.einsum("lts,ls->lt", A[:n_real], xb)
    leaf = panels["chunk_tgt"][:n_real].long()
    blk = torch.arange(n_real, device=A.device) // S
    new = torch.ones(n_real, dtype=torch.bool, device=A.device)
    new[1:] = (blk[1:] != blk[:-1]) | (leaf[1:] != leaf[:-1])
    seg = torch.cumsum(new.long(), 0) - 1
    nseg = int(seg[-1]) + 1 if n_real else 0
    sums = torch.zeros((nseg, KTr), dtype=A.dtype, device=A.device)
    sums.index_add_(0, seg, part)
    s_leaf, s_blk = leaf[new], blk[new]
    r0, r1 = rp[s_leaf], rp[s_leaf + 1]
    cut = r0 // S != (r1 - 1) // S
    out = torch.full((meta.nl_t, KTr), float("nan"), dtype=A.dtype,
                     device=A.device)
    out[s_leaf[~cut]] = sums[~cut]
    nblocks = -(-C // S)
    carry = torch.full((nblocks, 2, KTr), float("nan"), dtype=A.dtype,
                       device=A.device)
    slot = (r0 > s_blk * S).long()
    carry[s_blk[cut], slot[cut]] = sums[cut]
    # the fix-up: leaves without chunks, then the cut ones
    r0, r1 = rp[:-1], rp[1:]
    out[r1 <= r0] = 0
    lcut = torch.nonzero((r1 > r0) & (r0 // S != (r1 - 1) // S)).flatten()
    if lcut.numel():
        b0, b1 = r0[lcut] // S, (r1[lcut] - 1) // S
        acc = carry[b0, (r0[lcut] > b0 * S).long()]
        for k in range(1, int((b1 - b0).max()) + 1):
            more = b0 + k <= b1
            acc[more] += carry[b0[more] + k, 0]
        out[lcut] = acc
    return out


def ragged_leaf_counts(S, rng, n_real=None):
    """Chunks per target leaf of a ragged store that meets every way a
    leaf can fall on the near_panel kernel's block edges at ``S`` chunks
    per block: empty first and last leaves, leaves of 0, 1, S - 1, S,
    S + 1 and 163 chunks, a leaf that starts on a block edge and (for S
    > 1) one that starts inside a block, each cut across three blocks or
    more; then random leaves of 0 to 2S + 2 chunks from ``rng``: twelve,
    or as many as make ``n_real`` chunks in all.  For tests and
    ``chip_smoke.py`` only (``ragged_store_arrays``, ``ragged_cases``)."""
    counts = [0, 1, max(S - 1, 0), S, S + 1, 163, 0]
    counts.append(-sum(counts) % S)  # the next leaf starts on a block edge
    counts.append(2 * S + 1)
    if S > 1:
        counts += [1, 2 * S + 1]  # ... and the next inside a block
    if n_real is None:
        counts.extend(rng.integers(0, 2 * S + 3, 12).tolist())
    else:
        while sum(counts) < n_real:
            counts.append(int(rng.integers(0, 2 * S + 3)))
        counts[-1] -= sum(counts) - n_real
    counts.append(0)
    return np.asarray(counts, np.int64)


def ragged_store_arrays(counts, rng, KTr, KSc, m0, Lb, nl_src, dummies):
    """numpy arrays of a scalar-entry store with ``counts[l]`` chunks for
    target leaf l, then ``dummies`` dummy chunks, and a dummy charge tile
    (``pidx == nl_src``) in about one tile of eight; ``A`` f64 from
    ``rng``, its padding columns past ``m0 * KSc`` zero as a plan's are.
    Returns (store dict of ``A``, ``pidx``, ``chunk_tgt``, ``row_ptr``;
    meta of the store)."""
    nl_t = len(counts)
    n_real = int(np.sum(counts))
    C = n_real + dummies
    ct = np.full(C, nl_t, np.int32)
    ct[:n_real] = np.repeat(np.arange(nl_t), counts)
    pidx = rng.integers(0, nl_src, (C, m0)).astype(np.int32)
    pidx[rng.random((C, m0)) < 0.125] = nl_src
    A = rng.standard_normal((C, KTr, Lb))
    A[:, :, m0 * KSc:] = 0
    store = {"A": A, "pidx": pidx, "chunk_tgt": ct,
             "row_ptr": chunk_row_ptr(ct, nl_t)}
    meta = types.SimpleNamespace(KT=KTr, KS=KSc, rdim=1, cdim=1, m0=m0,
                                 nl_t=nl_t, block_rows=1)
    return store, meta


def ragged_cases(counts, S, pidx, nl_src, C):
    """What a ragged store of ``counts`` chunks per leaf (``C`` chunks in
    all, dummies last) holds of the cases ``ragged_leaf_counts`` aims at,
    at ``S`` chunks per block; and the names of those it lacks."""
    counts = np.asarray(counts)
    rp = np.concatenate([[0], np.cumsum(counts)])
    busy = counts > 0
    spans = (rp[1:] - 1) // S - rp[:-1] // S + 1
    wide = busy & (spans >= 3)
    holds = {
        "S": int(S),
        "chunks_per_leaf": sorted({int(c) for c in counts
                                   if c in (0, 1, S - 1, S, S + 1, 163)}),
        "empty_first_and_last": bool(counts[0] == 0 and counts[-1] == 0),
        "most_blocks_of_a_leaf": int(spans[busy].max()),
        "cut_leaves_from_an_edge": int((wide & (rp[:-1] % S == 0)).sum()),
        "cut_leaves_from_inside": int((wide & (rp[:-1] % S != 0)).sum()),
        "dummy_chunks": int(C - rp[-1]),
        "dummy_charge_tiles": int((np.asarray(pidx) == nl_src).sum()),
    }
    lacks = [name for name, ok in (
        ("chunks_per_leaf", holds["chunks_per_leaf"]
         == sorted({0, 1, max(S - 1, 0), S, S + 1, 163})),
        ("empty_first_and_last", holds["empty_first_and_last"]),
        ("cut_leaves_from_an_edge", holds["cut_leaves_from_an_edge"] > 0),
        ("cut_leaves_from_inside",
         S == 1 or holds["cut_leaves_from_inside"] > 0),
        ("dummy_chunks", holds["dummy_chunks"] > 0),
        ("dummy_charge_tiles", holds["dummy_charge_tiles"] > 0),
    ) if not ok]
    return holds, lacks


_C_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)  # the handle, typed once per dtype
def _kernel_fn(dtype):
    from fmm_bem_tpu_torch.ops import _build

    lib = _build.load("near_panel")
    fn = lib.near_panel_f32 if dtype == torch.float32 else lib.near_panel_f64
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def panel_contract_reference(A, xb):
    """Plain PyTorch version of the chunk contraction:
    ``out[c, t] = sum_s A[c, t, s] * xb[c, s]``."""
    return torch.einsum("lts,ls->lt", A, xb)


def _contract_fn(dtype):
    from fmm_bem_tpu_torch.ops import _build

    lib = _build.load("panel_contract")
    fn = (
        lib.panel_contract_f32 if dtype == torch.float32
        else lib.panel_contract_f64
    )
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def panel_contract(A, xb):
    """Chunk contraction ``out[c] = A[c] @ xb[c]`` of a panel store.

    A : [Cpad, KTr, Lb] chunk panels; xb : [Cpad, Lb] gathered charge
    rows (zero beyond ``m0 * KSc`` and in dummy chunks).
    Returns [Cpad, KTr], every row computed (dummies give zeros).

    Tensors on the CPU take the plain version; CUDA tensors launch the
    hand-written kernel (and only there is ``panel_contract.launches``
    incremented) or raise.
    """
    if A.device.type == "cpu":
        return panel_contract_reference(A, xb)
    if A.device.type != "cuda":
        raise RuntimeError(f"panel_contract: unsupported device {A.device}")
    if A.dtype not in (torch.float32, torch.float64) or xb.dtype != A.dtype:
        raise TypeError(
            f"panel_contract: A {A.dtype} / xb {xb.dtype} must both be "
            "float32 or both float64"
        )
    if xb.device != A.device:
        raise RuntimeError(
            f"panel_contract: xb on {xb.device}, A on {A.device}"
        )
    for name, t in (("A", A), ("xb", xb)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"panel_contract: {name} must be contiguous and 16-byte "
                "aligned")
    if A.ndim != 3 or xb.shape != (A.shape[0], A.shape[2]) \
            or A.shape[2] % 128 != 0:
        raise ValueError(
            f"panel_contract: shapes A {tuple(A.shape)} xb "
            f"{tuple(xb.shape)} do not fit [C, KTr, Lb] x [C, Lb] with "
            "Lb a multiple of 128"
        )
    C, KTr, Lb = A.shape
    out = torch.empty((C, KTr), dtype=A.dtype, device=A.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(A.device):
        err = _contract_fn(A.dtype)(
            A.data_ptr(), xb.data_ptr(), out.data_ptr(), C, KTr, Lb,
            torch.cuda.current_stream().cuda_stream,
        )
    panel_contract.launches += 1
    if err != 0:
        raise RuntimeError(
            f"panel_contract kernel launch failed: CUDA error {err}"
        )
    return out


#: number of kernel launches made by ``panel_contract`` in this process
panel_contract.launches = 0


def chunk_charge_rows(panels, ql):
    """The chunk rows ``[Cpad, Lb]`` of the two-stage route: the ``m0``
    charge tiles of every chunk gathered by ``pidx`` (a dummy
    ``pidx == nl_src`` reads an appended zero tile), zero in the columns
    ``m0 * KSc .. Lb``."""
    C, _, Lb = panels["A"].shape
    xq = torch.cat([ql, torch.zeros_like(ql[:1])], dim=0)
    xb = xq[panels["pidx"].long()].reshape(C, -1)
    return torch.nn.functional.pad(xb, (0, Lb - xb.shape[1])).contiguous()


def panel_matvec_two_stage(panels, meta, ql):
    """Near-field product by the two-stage route: gather the charge
    tiles of every chunk into a row (``chunk_charge_rows``), contract
    every chunk with its panel (``panel_contract``), and sum each
    leaf's chunk rows through the row pointer over the leaf-sorted
    chunks.  The sum is taken segment by segment, without atomics, so
    it gives the same bits on every run; leaves without chunks get 0
    and dummy chunks (past ``row_ptr[-1]``) belong to no segment.
    Same arguments and result as ``panel_matvec``."""
    out = panel_contract(panels["A"], chunk_charge_rows(panels, ql))
    return torch.segment_reduce(
        out, "sum", offsets=panels["row_ptr"], axis=0
    )


def near_route(meta):
    """Which route a store takes: matrix entries (``rdim * cdim > 1``,
    Stokes BEM) the two-stage one, scalar entries the fused kernel."""
    return "two_stage" if meta.rdim * meta.cdim > 1 else "fused"


def panel_matvec(panels, meta, ql):
    """Near-field product from leaf-tiled charges, by the store's route
    (``near_route``).

    Parameters
    ----------
    panels : dict with ``A`` [Cpad, KTr, Lb], ``pidx`` [Cpad, m0] int32,
        ``chunk_tgt`` [Cpad] int32 and ``row_ptr`` [nl_t + 1] int32 (from
        NearPanels.device() or build_near_panels_on_device).
    meta : the NearPanels (static chunk shapes).
    ql : [nl_src, KS*cdim] masked per-source-leaf charge tiles.
    Returns [nl_t, KT*rdim] leaf result tiles in leaf-slot order.
    """
    if near_route(meta) == "two_stage":
        return panel_matvec_two_stage(panels, meta, ql)
    return panel_matvec_fused(panels, meta, ql)


def panel_matvec_fused(panels, meta, ql):
    """Near-field product by the fused route.  Same arguments and
    result as ``panel_matvec``.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    hand-written kernel (its two passes, cut by ``near_tiling``; only
    there is ``panel_matvec_fused.launches`` incremented, once per call)
    or raise.
    """
    dev = ql.device
    if dev.type == "cpu":
        return panel_matvec_reference(panels, meta, ql)
    if dev.type != "cuda":
        raise RuntimeError(f"panel_matvec: unsupported device {dev}")
    A, pidx, row_ptr = panels["A"], panels["pidx"], panels["row_ptr"]
    chunk_tgt = panels["chunk_tgt"]
    C, KTr, Lb = A.shape
    m0 = pidx.shape[1]
    KSc = meta.KS * meta.cdim
    if A.dtype not in (torch.float32, torch.float64) or ql.dtype != A.dtype:
        raise TypeError(
            f"panel_matvec: A {A.dtype} / ql {ql.dtype} must both be "
            "float32 or both float64"
        )
    if (pidx.dtype != torch.int32 or row_ptr.dtype != torch.int32
            or chunk_tgt.dtype != torch.int32):
        raise TypeError(
            "panel_matvec: pidx, chunk_tgt and row_ptr must be int32")
    for name, t in (("A", A), ("pidx", pidx), ("chunk_tgt", chunk_tgt),
                    ("row_ptr", row_ptr), ("ql", ql)):
        if t.device != dev:
            raise RuntimeError(
                f"panel_matvec: {name} on {t.device}, ql on {dev}"
            )
        if not t.is_contiguous():
            raise ValueError(f"panel_matvec: {name} must be contiguous")
    if (
        ql.ndim != 2 or ql.shape[1] != KSc or pidx.shape[0] != C
        or chunk_tgt.shape != (C,) or row_ptr.shape != (meta.nl_t + 1,)
        or Lb % 128 != 0 or m0 * KSc > Lb
    ):
        raise ValueError(
            f"panel_matvec: shapes A {tuple(A.shape)} pidx "
            f"{tuple(pidx.shape)} chunk_tgt {tuple(chunk_tgt.shape)} "
            f"row_ptr {tuple(row_ptr.shape)} ql {tuple(ql.shape)} do not "
            f"fit KSc={KSc}, nl_t={meta.nl_t}"
        )
    if meta.nl_t * KTr == 0:
        return torch.empty((meta.nl_t, KTr), dtype=A.dtype, device=dev)
    esz = A.element_size()
    tiling = near_tiling(C, KTr, Lb, esz, sm_count(dev))
    # one allocation a call: the result's rows, then the carry slots'
    # (a second torch.empty took 3-9 us of host time a call on an H100
    # host: near_panel_ab.py)
    buf = torch.empty((meta.nl_t + tiling.nblocks * 2, KTr), dtype=A.dtype,
                      device=dev)
    out = buf[:meta.nl_t]
    with torch.cuda.device(dev):
        err = _kernel_fn(A.dtype)(
            A.data_ptr(), pidx.data_ptr(), chunk_tgt.data_ptr(),
            row_ptr.data_ptr(), ql.data_ptr(), buf.data_ptr(),
            buf.data_ptr() + meta.nl_t * KTr * esz, meta.nl_t, KTr, Lb, m0,
            KSc, ql.shape[0], C, tiling.S, tiling.warps,
            torch.cuda.current_stream().cuda_stream,
        )
    panel_matvec_fused.launches += 1
    if err != 0:
        raise RuntimeError(
            f"near_panel kernel launch failed: CUDA error {err}"
        )
    return out


#: number of kernel launches made by ``panel_matvec_fused`` in this process
panel_matvec_fused.launches = 0
