"""The on-the-fly near mode (``FMMConfig.near_mode="otf"``) of the PyTorch
port, on the CPU (f64 unless said).

- The port's own twin of ``tests/test_near_otf.py``: the OTF operator
  equals the cached-panel operator to 1e-12, and its store is small.
- The port's OTF slot matvec against the JAX plan's on a 2,048-panel
  sphere, on its own tables and on the JAX plan's arrays carried across
  as numpy; both forms of the correction-delta store.
- The plain version of the leaf-tile product against
  ``near_block_device`` + einsum (f64, 1e-12) and against the JAX
  package's Pallas kernel run in interpret mode (f32, 1e-5 of the
  output's max: the kernel inverts r with rsqrt, the plain version with
  sqrt, and both sum 64 x 3 terms per entry in another order).
- The count tables the kernel walks by (real slots per leaf, a closing
  0) and the invariant they rest on: the real slots of a leaf lead its
  tile, on the port's plans and on the JAX package's alike.  Bad tables
  (a count above K or below 0, a source index out of range) read as
  the kernel reads them, and the kernel's argument checks.
- A relaxed solve through the OTF operator takes the same iterations
  with the same orders as through the cached one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.executor import plan as jplan_mod
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu.ops.otf_tile import otf_superblock_bem
from fmm_bem_tpu_torch.executor import plan as tplan_mod
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel
from fmm_bem_tpu_torch.ops.near_panel import leaf_counts
from fmm_bem_tpu_torch.ops.otf_tile import (
    check_kernel_args,
    otf_leaf_tiles,
    otf_leaf_tiles_reference,
)
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.utils.convert import otf_panels_from_numpy

from _torch_tables import BAD_TABLES, spoil_tables

TOL = 1e-12


class TScreened(TKernel):
    """The Laplace BEM block routine with a screening parameter: the
    ``kappa > 0`` branch of the near-field math (the far field of the
    Yukawa kernel is not ported yet, so only near-field functions are
    called on it)."""

    kappa = 0.5


def relmax(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def tplan(fields, mode, **cfg):
    cfg = {"ncrit": 64, "max_p": 5, "dtype": "float64", **cfg}
    return T.FmmPlan(
        TKernel(K=3), fields, T.FMMConfig(near_mode=mode, **cfg),
        device="cpu",
    )


def jplan(fields, mode, **cfg):
    cfg = {"ncrit": 64, "max_p": 5, "dtype": "float64", **cfg}
    return J.FmmPlan(
        JKernel(K=3), fields, J.FMMConfig(near_mode=mode, **cfg)
    )


# ----------------------------------------------------------------------
# the port's twin of tests/test_near_otf.py
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sphere4():
    # leaf tiles wider than the fullest leaf: every leaf has padded slots
    tris = unit_sphere(4)
    fields = make_panels(tris, K=3)
    return (
        len(tris), tplan(fields, "cached", leaf_pad=72),
        tplan(fields, "otf", leaf_pad=72),
    )


@pytest.mark.parametrize("flipped", [False, True])
def test_otf_matches_cached(sphere4, flipped):
    n, cached, otf = sphere4
    assert otf._otf_near and not cached._otf_near
    q = np.random.default_rng(0).normal(size=n)
    name = "apply_flipped_bc" if flipped else "apply"
    a = getattr(cached, name)(q, p=5)
    b = getattr(otf, name)(q, p=5)
    assert a.shape == (n, 1)
    assert relmax(b, a.numpy()) <= TOL


def test_otf_slots_path(sphere4):
    n, _, otf = sphere4
    ref = otf.apply(np.ones(n), p=5)[:, 0].numpy()
    mv, op4p, to_s, from_s, nslots = otf.solver_ops_slots()
    y = mv(op4p(5), to_s(np.ones(n)), 5)
    assert y.shape == (nslots,)
    assert relmax(from_s(y), ref) <= TOL
    # padded slots stay exactly zero through the OTF near field
    mask = torch.as_tensor(otf.src.leaf_body_mask.reshape(-1))
    assert (~mask).any() and bool((y[~mask] == 0).all())


def test_otf_store_is_small(sphere4):
    _, cached, otf = sphere4
    big_dev, _ = cached.near_panels()
    otf_dev, meta = otf.near_panels()
    assert meta is None
    nbytes = lambda t: t.numel() * t.element_size()
    small = sum(
        nbytes(otf_dev[k])
        for k in ("corr_valw", "corr_gleaf", "corr_gidx", "corr_rowof")
    )
    # the O(N) correction store is a small fraction of the cached one
    assert small < 0.25 * nbytes(big_dev["A"])


# ----------------------------------------------------------------------
# against the JAX plan, 2,048 panels
# ----------------------------------------------------------------------
def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class OtfPair:
    """One sphere planned in OTF mode by both packages."""

    def __init__(self, recursion, **cfg):
        tris = unit_sphere(recursion)
        self.fields = make_panels(tris, K=3)
        self.n = len(tris)
        self.jp = jplan(self.fields, "otf", **cfg)
        self.tp = tplan(self.fields, "otf", **cfg)
        assert self.jp._otf_near and self.tp._otf_near
        self.q = np.random.default_rng(5).standard_normal(self.n)

    def jax_slots(self, p, flipped=False):
        mv, op4p, to_s, _, _ = self.jp.solver_ops_slots(flipped=flipped)
        qs = to_s(self.q)
        return np.asarray(qs), np.asarray(mv(op4p(p), qs, p))

    def carried_panels(self, flipped=False):
        fh = self.jp._flipped_fields()[0] if flipped else None
        dev, _ = self.jp.near_panels(fh)
        return otf_panels_from_numpy(
            to_numpy(dev), device="cpu", dtype=torch.float64
        )


@pytest.fixture(scope="module")
def pair2048():
    return OtfPair(5)


HOST_ARRAYS = (
    "near_rows", "near_cols", "near_vals", "_otf_corr_rows",
    "_otf_corr_cols", "_otf_corr_ginv", "_otf_corr_gleaf", "_otf_corr_gidx",
    "_otf_corr_rowof", "_otf_corr_windowed",
)


def same(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-14, err_msg=name)
    else:
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_otf_host_state_is_the_jax_plans(pair2048):
    """The delta store, its index structures and the pair lists, array
    for array."""
    assert pair2048.n == 2048 and len(pair2048.tp.near_rows) > 0
    for name in HOST_ARRAYS:
        same(getattr(pair2048.jp, name), getattr(pair2048.tp, name), name)
    # the JAX plan pads its pair lists to whole chunks with the dummy
    # leaf; the port's row-pointer walk needs no padding
    npairs = len(pair2048.tp.p2p_src_slot)
    assert np.all(pair2048.jp._otf_tslot[npairs:] == len(pair2048.jp.leaf_ids))
    for name in ("_otf_sslot", "_otf_tslot"):
        same(getattr(pair2048.jp, name)[:npairs],
             getattr(pair2048.tp, name), name)


@pytest.mark.parametrize("tables", ["carried", "own"])
@pytest.mark.parametrize("p", [3, 5])
def test_otf_matvec_slots_matches_jax(pair2048, p, tables):
    qs, want = pair2048.jax_slots(p)
    mv, op4p, _, _, _ = pair2048.tp.solver_ops_slots()
    d, aux, sf, tf = op4p(p)
    if tables == "carried":
        aux = dict(aux, panels=pair2048.carried_panels())
    got = mv((d, aux, sf, tf), torch.tensor(qs), p)
    assert relmax(got, want) <= TOL


def test_otf_matvec_flipped_matches_jax(pair2048):
    qs, want = pair2048.jax_slots(5, flipped=True)
    mv, op4p, _, _, _ = pair2048.tp.solver_ops_slots(flipped=True)
    assert relmax(mv(op4p(5), torch.tensor(qs), 5), want) <= TOL
    d, aux, sf, tf = op4p(5)
    aux = dict(aux, panels=pair2048.carried_panels(flipped=True))
    assert relmax(mv((d, aux, sf, tf), torch.tensor(qs), 5), want) <= TOL


def test_otf_padded_rows_fallback(monkeypatch, sphere4):
    """Past the window budget the deltas are kept as padded entry rows
    (``corr_colp``): lower the budget on both sides and hold the port to
    the JAX plan and to its own windowed form."""
    monkeypatch.setattr(jplan_mod, "_OTF_WINDOW_LIMIT", 0)
    monkeypatch.setattr(tplan_mod, "_OTF_WINDOW_LIMIT", 0)
    pair = OtfPair(4)
    assert not pair.tp._otf_corr_windowed and not pair.jp._otf_corr_windowed
    for name in ("_otf_corr_colp", "_otf_corr_rowof_e"):
        same(getattr(pair.jp, name), getattr(pair.tp, name), name)
    dev, _ = pair.tp.near_panels()
    assert "corr_colp" in dev and "corr_valw" not in dev
    qs, want = pair.jax_slots(5)
    mv, op4p, _, from_s, _ = pair.tp.solver_ops_slots()
    d, aux, sf, tf = op4p(5)
    got = mv((d, aux, sf, tf), torch.tensor(qs), 5)
    assert relmax(got, want) <= TOL
    aux = dict(aux, panels=pair.carried_panels())
    assert "corr_colp" in aux["panels"]
    assert relmax(mv((d, aux, sf, tf), torch.tensor(qs), 5), want) <= TOL
    # the windowed plan of the same sphere computes the same operator
    _, _, windowed = sphere4
    assert windowed._otf_corr_windowed
    a = windowed.apply(pair.q, p=5)
    assert relmax(pair.tp.apply(pair.q, p=5), a.numpy()) <= TOL


# ----------------------------------------------------------------------
# the leaf-tile product itself
# ----------------------------------------------------------------------
def leaf_tile_inputs(plan, flipped, dtype=torch.float64, seed=3):
    """(tiles, masked charge tiles) of a port OTF plan."""
    fh = plan._flipped_fields() if flipped else None
    dev, _ = plan.near_panels(fh)
    ot = dev["otf_tiles"]
    nl, K = len(plan.leaf_ids), plan.leaf_pad
    ql = np.random.default_rng(seed).standard_normal((nl, K))
    ql = torch.tensor(ql * plan.src.leaf_body_mask, dtype=dtype)
    return ot, ql


@pytest.mark.parametrize("flipped", [False, True], ids=["bc0", "bc1"])
@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_plain_version_matches_near_block_device(sphere4, kappa, flipped):
    """The plain version on the packed tiles against the kernel class's
    own block routine on the unpacked fields, contracted by einsum and
    summed per target leaf."""
    _, _, plan = sphere4
    kern = TScreened(K=3) if kappa else plan.kernel
    ot, ql = leaf_tile_inputs(plan, flipped)
    got = otf_leaf_tiles_reference(
        ot["sb_src"], ql, ot["sb_tgt"], ot["row_ptr"], ot["sslot"],
        plan._otf_KQ, kappa=kappa, chunk=7,
    )
    # on CPU tensors the entry point is the plain version (chunking
    # only moves the order of the per-leaf sums)
    via_entry = otf_leaf_tiles(
        ot["sb_src"], ql, ot["sb_tgt"], ot["row_ptr"], ot["sslot"],
        plan._otf_KQ, kappa=kappa,
    )
    assert relmax(got, via_entry.numpy()) <= 1e-14

    fields = plan._flipped_fields() if flipped else plan.src.fields
    idx = torch.as_tensor(plan.src.leaf_body_idx, dtype=torch.int64)
    msk = torch.as_tensor(plan.src.leaf_body_mask)
    tiles = {
        k: torch.as_tensor(np.asarray(v), dtype=torch.float64)[idx]
        for k, v in fields.items() if k != "vertices"
    }
    npairs = len(plan.p2p_src_slot)
    assert len(plan._otf_sslot) == npairs  # no chunk padding
    ss = torch.as_tensor(plan._otf_sslot, dtype=torch.int64)
    ts = torch.as_tensor(plan._otf_tslot, dtype=torch.int64)
    blocks = kern.near_block_device(
        {k: v[ts] for k, v in tiles.items()},
        {k: v[ss] for k, v in tiles.items()}, msk[ts], msk[ss],
    )
    want = torch.zeros_like(got).index_add_(
        0, ts, torch.einsum("cts,cs->ct", blocks, ql[ss])
    )
    assert relmax(got, want.numpy()) <= TOL
    assert bool((got[~msk] == 0).all())


@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_plain_version_matches_interpreted_pallas_kernel(kappa):
    """f32: the plain version on the port's tiles against the JAX
    package's fused kernel, run by the Pallas interpreter on the JAX
    plan's own tiles.  Every other panel carries the other BC flag, so
    one run selects both G and dG/dn (the interpreter walks the kernel's
    whole padded grid, which takes a while)."""
    fields = dict(make_panels(unit_sphere(3), K=3))
    fields["bc"] = (np.arange(len(fields["xyz"])) % 2).astype(np.float64)
    cfg = dict(ncrit=16, max_p=4, dtype="float32", leaf_pad=24)
    # the tiles do not depend on kappa: the Laplace plan's serve both
    # branches of the kernel (the JAX package's Yukawa BEM kernel has no
    # near_regular_entries and so never takes its OTF path)
    jp = jplan(fields, "otf", **cfg)
    tp = tplan(fields, "otf", **cfg)
    ot, ql = leaf_tile_inputs(tp, False, dtype=torch.float32)
    mask = tp.src.leaf_body_mask
    assert (~mask).any()
    flags = ot["sb_tgt"][:-1, 3].numpy()[mask]
    assert (flags == 0).any() and (flags == 1).any()

    jot = jp.near_panels()[0]["otf_tiles"]
    np.testing.assert_array_equal(
        np.asarray(jot["sb_src"]), ot["sb_src"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jot["sb_tgt"]), ot["sb_tgt"].numpy())
    qt = jnp.concatenate(
        [jnp.asarray(ql.numpy()), jnp.zeros((1, ql.shape[1]), jnp.float32)]
    )[:, None, :]
    want = np.asarray(otf_superblock_bem(
        jot["sb_src"], qt, jot["sb_tgt"],
        {"loc_src": jot["sb_loc_src"], "loc_tgt": jot["sb_loc_tgt"],
         "cmeta": jot["sb_cmeta"]},
        jp._otf_sb, jp._otf_KQ, kappa=kappa, interpret=True,
    )[jot["sb_rowof"]])
    got = otf_leaf_tiles_reference(
        ot["sb_src"], ql, ot["sb_tgt"], ot["row_ptr"], ot["sslot"],
        tp._otf_KQ, kappa=kappa,
    ).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    scale = np.abs(want[mask]).max()
    assert np.abs(got - want)[mask].max() <= 1e-5 * scale
    # the fused kernel applies no target mask: its padded slots hold
    # rounding-sized values; the port's are exactly zero
    assert (got[~mask] == 0).all()
    assert np.abs(want[~mask]).max() <= 1e-5 * scale


# ----------------------------------------------------------------------
# the count tables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("side", ["src", "tgt"])
def test_count_table_is_body_mask_sum(sphere4, side):
    _, _, plan = sphere4
    ot = plan.near_panels()[0]["otf_tiles"]
    mask = getattr(plan, side).leaf_body_mask
    cnt = ot[f"{side}_cnt"]
    assert cnt.dtype == torch.int32 and cnt.shape == (len(mask) + 1,)
    np.testing.assert_array_equal(
        cnt.numpy(), np.append(mask.sum(axis=1), 0))
    assert (cnt[:-1] > 0).all() and (cnt[:-1] < mask.shape[1]).any()


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("recursion,cfg", [
    (4, dict(leaf_pad=72)), (5, dict(ncrit=32)),
    (3, dict(ncrit=16, leaf_pad=24)),
], ids=["rec4_pad72", "rec5_ncrit32", "rec3_ncrit16_pad24"])
def test_real_slots_lead_each_tile(package, recursion, cfg):
    """``leaf_body_mask == arange(K) < count``: the kernel walks slots
    [0, count) of each leaf, so a real slot past a padded one would be
    lost."""
    fields = make_panels(unit_sphere(recursion), K=3)
    build = tplan if package == "port" else jplan
    plan = build(fields, "otf", **cfg)
    for side in (plan.src, plan.tgt):
        mask = np.asarray(side.leaf_body_mask)
        cnt = mask.sum(axis=1)
        np.testing.assert_array_equal(
            mask, np.arange(mask.shape[1])[None, :] < cnt[:, None])
        np.testing.assert_array_equal(leaf_counts(mask)[:-1], cnt)
    assert (cnt < mask.shape[1]).any()  # padded slots exist


def test_leaf_counts_refuses_a_gap():
    mask = np.array([[True, False, True], [True, True, False]])
    with pytest.raises(ValueError, match="lead"):
        leaf_counts(mask)
    np.testing.assert_array_equal(leaf_counts(mask[1:]), [2, 0])


@pytest.mark.parametrize("flipped", [False, True], ids=["bc0", "bc1"])
@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_plain_version_same_with_count_tables(sphere4, kappa, flipped):
    """Padded slots contribute exactly zero either way: masking by the
    count tables gives the sentinel's result."""
    _, _, plan = sphere4
    ot, ql = leaf_tile_inputs(plan, flipped)
    args = (ot["sb_src"], ql, ot["sb_tgt"], ot["row_ptr"], ot["sslot"],
            plan._otf_KQ)
    without = otf_leaf_tiles_reference(*args, kappa=kappa)
    with_cnt = otf_leaf_tiles_reference(
        *args, kappa=kappa, src_cnt=ot["src_cnt"], tgt_cnt=ot["tgt_cnt"])
    assert relmax(with_cnt, without.numpy()) <= 1e-14
    via_entry = otf_leaf_tiles(
        *args, kappa=kappa, src_cnt=ot["src_cnt"], tgt_cnt=ot["tgt_cnt"])
    assert torch.equal(via_entry, with_cnt)
    with pytest.raises(ValueError, match="both"):
        otf_leaf_tiles_reference(*args, src_cnt=ot["src_cnt"])


# ----------------------------------------------------------------------
# a relaxed solve through the OTF operator
# ----------------------------------------------------------------------
def test_otf_relaxed_solve_same_iterations_as_cached(sphere4):
    n, cached, otf = sphere4
    b = cached.apply_flipped_bc(np.ones(n), p=5)[:, 0].numpy()
    cfg = T.SolverConfig(
        residual=1e-5, max_iters=100, restart=100, max_p=5, p_min=1,
        p_tiers=(2, 3, 5),
    )
    xc, ic, _ = solve_plan(cached, b, cfg, device="cpu")
    xo, io, mode = solve_plan(otf, b, cfg, device="cpu")
    assert mode == "device-slots" and ic.converged and io.converged
    assert io.iterations == ic.iterations
    assert [h[2] for h in io.history] == [h[2] for h in ic.history]
    assert len({h[2] for h in io.history}) > 1  # the order did relax
    assert np.abs(xo - xc).max() <= 1e-9


# ----------------------------------------------------------------------
# bad tables and the kernel's argument checks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kappa", [0.0, 0.5])
@pytest.mark.parametrize("case", BAD_TABLES)
def test_plain_version_reads_bad_tables_as_the_kernel(sphere4, case, kappa):
    """The plain version on bad count tables or a bad pair list gives
    its result on the corrected tables; a source index out of range
    adds nothing, in both masking modes."""
    _, _, plan = sphere4
    ot, ql = leaf_tile_inputs(plan, False)
    K = ql.shape[1]
    bad, good = spoil_tables(case, ot["row_ptr"], ot["sslot"],
                             (ot["src_cnt"], ot["tgt_cnt"]), K)

    def run(tabs, counts=True):
        row_ptr, src_idx, (src_cnt, tgt_cnt) = tabs
        return otf_leaf_tiles_reference(
            ot["sb_src"], ql, ot["sb_tgt"], row_ptr, src_idx, plan._otf_KQ,
            kappa=kappa, src_cnt=src_cnt if counts else None,
            tgt_cnt=tgt_cnt if counts else None)

    orig = (ot["row_ptr"], ot["sslot"], ot["src_cnt"], ot["tgt_cnt"])
    assert any(a.shape != b.shape or not torch.equal(a, b)
               for a, b in zip((*good[:2], *good[2]), orig))
    got, want = run(bad), run(good)
    assert relmax(got, want.numpy()) <= 1e-15
    if case == "source_index_out_of_range":
        assert relmax(run(bad, False), run(good, False).numpy()) <= 1e-15


def otf_kernel_args(plan):
    ot, ql = leaf_tile_inputs(plan, False)
    return dict(src_tab=ot["sb_src"], ql=ql, tgt_tab=ot["sb_tgt"],
                row_ptr=ot["row_ptr"], src_idx=ot["sslot"],
                KQ=plan._otf_KQ, src_cnt=ot["src_cnt"],
                tgt_cnt=ot["tgt_cnt"])


@pytest.mark.parametrize("fault,exc", [
    ("no_src_cnt", ValueError), ("no_tgt_cnt", ValueError),
    ("src_cnt_int64", TypeError), ("tgt_cnt_short", ValueError),
    ("src_cnt_strided", ValueError), ("row_ptr_int64", TypeError),
    ("src_idx_int64", TypeError), ("ql_float32", TypeError),
    ("src_tab_float16", TypeError), ("src_tab_KQ", ValueError),
    ("tgt_tab_rows", ValueError), ("ql_leaves", ValueError),
    ("row_ptr_long", ValueError), ("ql_strided", ValueError),
    ("tgt_cnt_meta", RuntimeError),
])
def test_kernel_argument_checks(sphere4, fault, exc):
    """What the CUDA entry point checks before it loads the kernel,
    held on CPU tensors: each bad dtype, shape, layout or device
    raises."""
    _, _, plan = sphere4
    args = otf_kernel_args(plan)
    nl, K = args["ql"].shape
    assert check_kernel_args(**args) == (nl, K, plan._otf_KQ)
    a = args
    bad = {
        "no_src_cnt": dict(src_cnt=None),
        "no_tgt_cnt": dict(tgt_cnt=None),
        "src_cnt_int64": dict(src_cnt=a["src_cnt"].long()),
        "tgt_cnt_short": dict(tgt_cnt=a["tgt_cnt"][:-1].contiguous()),
        "src_cnt_strided": dict(
            src_cnt=torch.stack([a["src_cnt"], a["src_cnt"]], 1)[:, 0]),
        "row_ptr_int64": dict(row_ptr=a["row_ptr"].long()),
        "src_idx_int64": dict(src_idx=a["src_idx"].long()),
        "ql_float32": dict(ql=a["ql"].float()),
        "src_tab_float16": dict(src_tab=a["src_tab"].half()),
        "src_tab_KQ": dict(KQ=a["KQ"] + 1),
        "tgt_tab_rows": dict(tgt_tab=a["tgt_tab"][:, :3].contiguous()),
        "ql_leaves": dict(ql=a["ql"][:-1].contiguous()),
        "row_ptr_long": dict(
            row_ptr=torch.zeros(nl + 3, dtype=torch.int32)),
        "ql_strided": dict(ql=a["ql"].t().contiguous().t()),
        "tgt_cnt_meta": dict(tgt_cnt=a["tgt_cnt"].to("meta")),
    }[fault]
    with pytest.raises(exc):
        check_kernel_args(**{**args, **bad})
