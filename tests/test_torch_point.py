"""The point-Laplace path of the PyTorch port (potential + force,
``result_dim = 4``) against the JAX package, on the CPU at f64 unless
said.  Inputs are made with numpy from a seed and go through both sides.

- ``LaplaceKernel`` operator by operator (p2m, l2p and m2p with forces,
  p2p with the eps2 exclusion), 1e-12 relative.
- The plain version of the leaf-tile P2P against the JAX plan's batched
  ``p2p_block`` pass (f64, 1e-12) and against the JAX package's Pallas
  kernel run in interpret mode (f32, 1e-5 of each component's max: the
  two sum a leaf's sources in another order).
- ``FmmPlan.apply`` on 4,096 points against the JAX plan (1e-12) and
  against direct summation (p = 10: 3e-5 at the default opening angle,
  1e-6 at theta = 0.35).
- The count table of the leaf-tile P2P (``p2p_cnt``, ``leaf_counts``)
  on both packages' point plans; the plain version with it against the
  plain version without it (1e-15, padded target slots exactly 0) and
  against the interpreted Pallas kernel; bad tables (a count above K or
  below 0, a source index out of range) read as the kernel reads them;
  the kernel's argument checks.
- The unit kernel: far plus near count every pair exactly once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.kernels.laplace import LaplaceKernel as JLaplace
from fmm_bem_tpu.kernels.unit import UnitKernel as JUnit
from fmm_bem_tpu.ops.p2p_tile import p2p_superblock_laplace
from fmm_bem_tpu.ops.p2p_tile import pack_xyzq as j_pack_xyzq
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.unit import UnitKernel as TUnit
from fmm_bem_tpu_torch.ops.near_panel import leaf_counts
from fmm_bem_tpu_torch.ops.p2p_tile import (
    check_kernel_args,
    p2p_leaf_tiles,
    p2p_leaf_tiles_reference,
    pack_xyzq,
)
from fmm_bem_tpu_torch.solver.api import solve_plan

from _torch_tables import BAD_TABLES, spoil_tables

TOL = 1e-12


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tt(a):
    return torch.tensor(np.asarray(a))


# ----------------------------------------------------------------------
# LaplaceKernel, operator by operator
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def op_inputs():
    rng = np.random.default_rng(11)
    B, p = 40, 6
    W = TLaplace().width(p)
    assert W == JLaplace().width(p)
    return {
        "p": p,
        "q": rng.standard_normal(B),
        "d_in": rng.uniform(-0.6, 0.6, (B, 3)),     # inside the box
        "d_out": rng.uniform(1.5, 3.0, (B, 3)) * rng.choice([-1, 1], (B, 3)),
        "inv_sigma": rng.uniform(0.5, 4.0, B),
        "E": rng.standard_normal((B, 1, W)),
    }


def test_p2m_matches_jax(op_inputs):
    i = op_inputs
    want = JLaplace().p2m({}, jnp.asarray(i["q"]), jnp.asarray(i["d_in"]),
                          jnp.asarray(i["inv_sigma"]), i["p"])
    got = TLaplace().p2m({}, tt(i["q"]), tt(i["d_in"]), tt(i["inv_sigma"]),
                         i["p"])
    assert got.shape == (40, 1, TLaplace().width(i["p"]))
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("p", [1, 3, 6])
def test_l2p_with_force_matches_jax(op_inputs, p):
    i = op_inputs
    W = TLaplace().width(p)
    E = i["E"][..., :W]
    want = JLaplace().l2p({}, jnp.asarray(E), jnp.asarray(i["d_in"]),
                          jnp.asarray(i["inv_sigma"]), p)
    got = TLaplace().l2p({}, tt(E), tt(i["d_in"]), tt(i["inv_sigma"]), p)
    assert got.shape == (40, 4) and not got.requires_grad
    assert rel(got[:, 0], np.asarray(want)[:, 0]) <= TOL
    if p > 1:  # a constant local expansion has no gradient
        assert rel(got[:, 1:], np.asarray(want)[:, 1:]) <= TOL
    else:
        assert float(got[:, 1:].abs().max()) == 0.0


@pytest.mark.parametrize("p", [1, 3, 6])
def test_m2p_with_force_matches_jax(op_inputs, p):
    i = op_inputs
    W = TLaplace().width(p)
    E = i["E"][..., :W]
    want = JLaplace().m2p({}, jnp.asarray(E), jnp.asarray(i["d_out"]),
                          jnp.asarray(i["inv_sigma"]), p)
    got = TLaplace().m2p({}, tt(E), tt(i["d_out"]), tt(i["inv_sigma"]), p)
    assert got.shape == (40, 4)
    assert rel(got[:, 0], np.asarray(want)[:, 0]) <= TOL
    assert rel(got[:, 1:], np.asarray(want)[:, 1:]) <= TOL


def test_l2p_force_is_the_gradient_of_its_potential(op_inputs):
    """Central differences of the potential in physical coordinates."""
    i, p, h = op_inputs, op_inputs["p"], 1e-6
    K = TLaplace()
    E, d, isig = tt(i["E"]), tt(i["d_in"]), tt(i["inv_sigma"])
    out = K.l2p({}, E, d, isig, p)
    for a in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[a] = h
        # a physical step h is a normalised step h / sigma
        up = K.l2p({}, E, d + e * isig[:, None], isig, p)[:, 0]
        dn = K.l2p({}, E, d - e * isig[:, None], isig, p)[:, 0]
        fd = (up - dn) / (2 * h)
        assert rel(out[:, 1 + a], fd.numpy()) < 1e-7


def test_p2p_matches_jax_with_exclusions():
    """The self pair (r = 0), a pair inside the eps2 ball, and a padded
    source that aliases a target position all contribute exactly 0."""
    rng = np.random.default_rng(12)
    tgt = rng.uniform(0, 1, (30, 3))
    src = rng.uniform(0, 1, (50, 3))
    q = rng.standard_normal(50)
    src[0] = tgt[3]                         # coincident
    src[1] = tgt[7] + np.array([5e-5, 0, 0])  # r^2 = 2.5e-9 < eps2
    src[2] = tgt[0]
    q[2] = 0.0                              # a padded slot aliasing a target
    want = np.asarray(
        JLaplace().p2p(jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(q)))
    got = TLaplace().p2p(tt(tgt), tt(src), tt(q))
    assert np.isfinite(got.numpy()).all()
    assert rel(got, want) <= TOL
    # exclusion, not 1 / eps2: dropping the excluded sources changes nothing
    for t, s in ((3, 0), (7, 1), (0, 2)):
        keep = np.arange(50) != s
        sub = TLaplace().p2p(tt(tgt[[t]]), tt(src[keep]), tt(q[keep]))
        assert rel(got[[t]], sub.numpy()) <= 1e-14
    blk = TLaplace().p2p_block({"xyz": tt(tgt)}, {"xyz": tt(src)}, tt(q), None)
    assert torch.equal(blk, got)
    mat = TLaplace().p2p_matrix({"xyz": tt(tgt)}, {"xyz": tt(src)})
    wantm = JLaplace().p2p_matrix(
        {"xyz": jnp.asarray(tgt)}, {"xyz": jnp.asarray(src)})
    assert mat[3, 0] == 0 and mat[7, 1] == 0
    assert rel(mat, wantm) <= TOL
    assert rel(mat @ tt(q), want[:, 0]) <= TOL
    direct = TLaplace().direct(tt(tgt), tt(src), tt(q), chunk=7)
    assert rel(direct, want) <= TOL


# ----------------------------------------------------------------------
# the plans: 4,096 points
# ----------------------------------------------------------------------
class PointPair:
    def __init__(self, n, seed, dtype="float64", **cfg):
        rng = np.random.default_rng(seed)
        self.n = n
        self.pts = rng.uniform(0, 1, (n, 3))
        self.q = rng.standard_normal(n)
        cfg = {"ncrit": 48, "max_p": 10, "dtype": dtype, **cfg}
        self.jp = J.FmmPlan(JLaplace(), {"xyz": self.pts}, J.FMMConfig(**cfg))
        self.tp = T.FmmPlan(
            TLaplace(), {"xyz": self.pts}, T.FMMConfig(**cfg), device="cpu")

    def leaf_charges(self, seed=2):
        """Masked charge tiles [nl, K] in slot layout, as numpy."""
        nl, K = len(self.tp.leaf_ids), self.tp.leaf_pad
        ql = np.random.default_rng(seed).standard_normal((nl, K))
        return ql * self.tp.src.leaf_body_mask


@pytest.fixture(scope="module")
def points():
    return PointPair(4096, 21)


def test_point_plan_host_state_is_the_jax_plans(points):
    jp, tp = points.jp, points.tp
    assert tp.near_rows is None and jp.near_rows is None
    assert tp.leaf_pad == jp.leaf_pad and tp.tree.num_levels >= 3
    for name in ("p2p_src_slot", "p2p_tgt_slot", "m2p_src", "m2p_tgt_slot"):
        np.testing.assert_array_equal(getattr(jp, name), getattr(tp, name))
    # the leaf-tile pair list is the plan's pair list, target-sorted
    src_sorted, row_ptr = tp._p2p_rows
    order = np.lexsort((tp.p2p_src_slot, tp.p2p_tgt_slot))
    np.testing.assert_array_equal(src_sorted, tp.p2p_src_slot[order])
    np.testing.assert_array_equal(
        np.diff(row_ptr), np.bincount(tp.p2p_tgt_slot, minlength=len(tp.leaf_ids)))


def test_plain_p2p_matches_jax_batched_pass(points):
    """The leaf-tile product against ``_p2p_pass`` of the JAX plan in
    slot form (off the TPU that is its batched ``p2p_block`` path)."""
    jp, tp = points.jp, points.tp
    nl, K = len(tp.leaf_ids), tp.leaf_pad
    ql = points.leaf_charges()
    jd = jp.device_data(5)
    jsf = jp.device_fields(None, "src")
    want = np.asarray(
        jp._p2p_pass(jd, jsf, jsf, jnp.asarray(ql.reshape(-1)), nl, K,
                     slots=True))
    d = tp.device_data(5)
    sf = tp.device_fields(None)
    got = tp._p2p_pass(d, sf, sf, tt(ql.reshape(-1)), nl, K)
    assert got.shape == (nl * K, 4)
    assert rel(got, want) <= TOL
    mask = tp.src.leaf_body_mask.reshape(-1)
    assert (~mask).any() and bool((got[~mask] == 0).all())
    # the same pass through the kernel class's own p2p_block, batched
    d_generic = {k: v for k, v in d.items() if not k.startswith("p2p_row")}
    generic = tp._p2p_pass(d_generic, sf, sf, tt(ql.reshape(-1)), nl, K)
    assert rel(generic, want) <= TOL
    # chunking only moves the order of the per-leaf sums
    xyzq = pack_xyzq(d["p2p_xyz3"], tt(ql)[:, None, :])
    a = p2p_leaf_tiles_reference(
        xyzq, d["p2p_row_ptr"], d["p2p_src_sorted"], 1e-8, d["p2p_cnt"],
        chunk=37)
    b = p2p_leaf_tiles(xyzq, d["p2p_row_ptr"], d["p2p_src_sorted"], 1e-8,
                       d["p2p_cnt"])
    assert rel(a, b.numpy()) <= 1e-14


def test_plain_p2p_matches_interpreted_pallas_kernel():
    """f32, 600 points: the plain version against the JAX package's fused
    super-block kernel run by the Pallas interpreter."""
    pair = PointPair(600, 22, dtype="float32", ncrit=16, max_p=4,
                     leaf_pad=20)
    jp, tp = pair.jp, pair.tp
    assert jp._p2p_sb is not None
    nl, K = len(tp.leaf_ids), tp.leaf_pad
    ql = pair.leaf_charges().astype(np.float32)
    jd = jp.device_data(4)
    jxyzq = j_pack_xyzq(jd["p2p_sb_xyz3"], jnp.asarray(ql)[:, None, :])
    want = np.asarray(p2p_superblock_laplace(
        jxyzq,
        {"loc_src": jd["p2p_sb_loc_src"], "loc_tgt": jd["p2p_sb_loc_tgt"],
         "cmeta": jd["p2p_sb_cmeta"]},
        jp._p2p_sb, jp.kernel.eps2, interpret=True,
    )[jd["p2p_sb_rowof"]])
    d = tp.device_data(4)
    xyzq = pack_xyzq(d["p2p_xyz3"], torch.tensor(ql)[:, None, :])
    np.testing.assert_array_equal(xyzq.numpy(), np.asarray(jxyzq))
    got = p2p_leaf_tiles_reference(
        xyzq, d["p2p_row_ptr"], d["p2p_src_sorted"], tp.kernel.eps2).numpy()
    assert got.shape == want.shape == (nl, 4, K)
    mask = tp.src.leaf_body_mask
    assert (~mask).any() and np.isfinite(got).all()
    for c in range(4):
        scale = np.abs(want[:, c][mask]).max()
        assert np.abs(got[:, c] - want[:, c])[mask].max() <= 1e-5 * scale


# ----------------------------------------------------------------------
# the count table: the kernel walks only the real points of each leaf
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def points600():
    return PointPair(600, 22, dtype="float32", ncrit=16, max_p=4,
                     leaf_pad=20)


@pytest.mark.parametrize("name", ["points", "points600"])
def test_point_leaf_counts_hold_on_both_plans(name, request):
    """Real slots lead every tile of both packages' point plans, the two
    give the same table, and ``device_data`` carries it as ``p2p_cnt``
    (int32, [nl + 1], 0 for the dummy tile)."""
    pair = request.getfixturevalue(name)
    mask = np.asarray(pair.tp.src.leaf_body_mask)
    cnt = leaf_counts(mask)
    np.testing.assert_array_equal(
        cnt, leaf_counts(np.asarray(pair.jp.src.leaf_body_mask)))
    np.testing.assert_array_equal(cnt[:-1], mask.sum(axis=1))
    assert cnt[-1] == 0 and (cnt[:-1] < mask.shape[1]).any()
    for p in (3, 4):
        d = pair.tp.device_data(p)
        assert d["p2p_cnt"].dtype == torch.int32
        np.testing.assert_array_equal(d["p2p_cnt"].numpy(), cnt)


@pytest.mark.parametrize("name", ["points", "points600"])
def test_plain_p2p_with_counts_matches_without(name, request):
    """The count table changes nothing on real slots (1e-15) and makes
    padded target slots exactly 0, also when the padded slots carry
    charges and positions that would count if they were walked."""
    pair = request.getfixturevalue(name)
    tp = pair.tp
    d = tp.device_data(4)
    ql = torch.tensor(pair.leaf_charges(), dtype=d["p2p_xyz3"].dtype)
    xyzq = pack_xyzq(d["p2p_xyz3"], ql[:, None, :])
    args = (d["p2p_row_ptr"], d["p2p_src_sorted"], tp.kernel.eps2)
    cnt = d["p2p_cnt"]
    without = p2p_leaf_tiles_reference(xyzq, *args)
    with_cnt = p2p_leaf_tiles_reference(xyzq, *args, cnt=cnt)
    mask = torch.as_tensor(tp.src.leaf_body_mask)
    real = mask[:, None, :].expand_as(with_cnt)
    err = (with_cnt - without)[real].abs().max()
    assert float(err) <= 1e-15 * float(without[real].abs().max())
    assert bool((with_cnt[~real] == 0).all())
    assert bool((without[~real] != 0).any())  # masked only by the table
    # the entry point on CPU tensors is the plain version, table and all
    assert torch.equal(p2p_leaf_tiles(xyzq, *args, cnt), with_cnt)
    # slots past the count are not read
    noisy = xyzq.clone()
    pad = ~torch.cat([mask, torch.zeros_like(mask[:1])])
    rng = np.random.default_rng(3)
    for row in range(4):
        noisy[:, row][pad] = torch.tensor(
            rng.uniform(0, 1, int(pad.sum())), dtype=noisy.dtype)
    assert torch.equal(p2p_leaf_tiles_reference(noisy, *args, cnt=cnt),
                       with_cnt)


def test_plain_p2p_with_counts_matches_interpreted_pallas_kernel(points600):
    """f32: the plain version given the count table against the JAX
    package's super-block kernel run by the Pallas interpreter, on real
    slots, to 1e-5 of each component's max."""
    jp, tp = points600.jp, points600.tp
    ql = points600.leaf_charges().astype(np.float32)
    jd = jp.device_data(4)
    jxyzq = j_pack_xyzq(jd["p2p_sb_xyz3"], jnp.asarray(ql)[:, None, :])
    want = np.asarray(p2p_superblock_laplace(
        jxyzq,
        {"loc_src": jd["p2p_sb_loc_src"], "loc_tgt": jd["p2p_sb_loc_tgt"],
         "cmeta": jd["p2p_sb_cmeta"]},
        jp._p2p_sb, jp.kernel.eps2, interpret=True,
    )[jd["p2p_sb_rowof"]])
    d = tp.device_data(4)
    xyzq = pack_xyzq(d["p2p_xyz3"], torch.tensor(ql)[:, None, :])
    got = p2p_leaf_tiles_reference(
        xyzq, d["p2p_row_ptr"], d["p2p_src_sorted"], tp.kernel.eps2,
        cnt=d["p2p_cnt"]).numpy()
    mask = tp.src.leaf_body_mask
    assert got.shape == want.shape and (~mask).any()
    for c in range(4):
        scale = np.abs(want[:, c][mask]).max()
        assert np.abs(got[:, c] - want[:, c])[mask].max() <= 1e-5 * scale
        assert (got[:, c][~mask] == 0).all()


@pytest.mark.parametrize("case", BAD_TABLES)
def test_plain_p2p_reads_bad_tables_as_the_kernel(points600, case):
    """The plain version on a bad count table or pair list gives its
    result on the corrected ones: counts clamped to [0, K], the pairs of
    a source index past the leaf table (or below 0) dropped."""
    tp = points600.tp
    d = tp.device_data(4)
    ql = torch.tensor(points600.leaf_charges(), dtype=d["p2p_xyz3"].dtype)
    xyzq = pack_xyzq(d["p2p_xyz3"], ql[:, None, :])
    row_ptr, src_idx, cnt = d["p2p_row_ptr"], d["p2p_src_sorted"], d["p2p_cnt"]
    bad, good = spoil_tables(case, row_ptr, src_idx, (cnt,), ql.shape[1])
    eps2 = tp.kernel.eps2
    got = p2p_leaf_tiles_reference(xyzq, bad[0], bad[1], eps2, cnt=bad[2][0])
    want = p2p_leaf_tiles_reference(xyzq, good[0], good[1], eps2,
                                    cnt=good[2][0])
    orig = p2p_leaf_tiles_reference(xyzq, row_ptr, src_idx, eps2, cnt=cnt)
    assert torch.equal(got, want) and not torch.equal(want, orig)


def kernel_args(pair):
    d = pair.tp.device_data(4)
    xyzq = pack_xyzq(d["p2p_xyz3"],
                     torch.zeros_like(d["p2p_xyz3"][:, :1]))
    return xyzq, d["p2p_row_ptr"], d["p2p_src_sorted"], d["p2p_cnt"]


@pytest.mark.parametrize("fault,exc", [
    ("no_cnt", ValueError), ("cnt_int64", TypeError),
    ("cnt_short", ValueError), ("cnt_strided", ValueError),
    ("row_ptr_int64", TypeError), ("xyzq_float16", TypeError),
    ("xyzq_rows", ValueError), ("row_ptr_long", ValueError),
])
def test_kernel_argument_checks(points600, fault, exc):
    """What the CUDA entry point checks before it loads the kernel,
    held on CPU tensors: a missing, mistyped or misshapen count table
    (or any other argument the kernel does not take) raises."""
    xyzq, row_ptr, src_idx, cnt = kernel_args(points600)
    nl = xyzq.shape[0] - 1
    assert check_kernel_args(xyzq, row_ptr, src_idx, cnt) == (
        len(row_ptr) - 1, xyzq.shape[2])
    bad = {
        "no_cnt": dict(cnt=None),
        "cnt_int64": dict(cnt=cnt.long()),
        "cnt_short": dict(cnt=cnt[:-1].contiguous()),
        "cnt_strided": dict(cnt=torch.stack([cnt, cnt], 1)[:, 0]),
        "row_ptr_int64": dict(row_ptr=row_ptr.long()),
        "xyzq_float16": dict(xyzq=xyzq.half()),
        "xyzq_rows": dict(xyzq=xyzq[:, :3].contiguous()),
        "row_ptr_long": dict(row_ptr=torch.zeros(nl + 2, dtype=torch.int32)),
    }[fault]
    args = dict(xyzq=xyzq, row_ptr=row_ptr, src_idx=src_idx, cnt=cnt)
    args.update(bad)
    with pytest.raises(exc):
        check_kernel_args(**args)


def test_kernel_entry_refuses_other_devices(points600):
    """Only CPU tensors take the plain version: any other device that
    is not CUDA raises, with or without the table."""
    xyzq, row_ptr, src_idx, cnt = (
        t.to("meta") for t in kernel_args(points600))
    with pytest.raises(RuntimeError, match="unsupported device"):
        p2p_leaf_tiles(xyzq, row_ptr, src_idx, 1e-8, cnt)


@pytest.mark.parametrize("p", [5, 10])
def test_point_apply_matches_jax(points, p):
    want = np.asarray(points.jp.apply(points.q, p=p))
    got = points.tp.apply(points.q, p=p)
    assert got.shape == (points.n, 4)
    assert rel(got[:, 0], want[:, 0]) <= TOL
    assert rel(got[:, 1:], want[:, 1:]) <= TOL


def test_point_apply_matches_direct(points):
    """At the default opening angle (theta = 0.5) the p = 10 matvec is
    within the 3e-5 that the JAX package's own test of it accepts; with
    a tighter angle (theta = 0.35) it is within 1e-6."""
    K = points.tp.kernel
    exact = K.direct(tt(points.pts), tt(points.pts), tt(points.q)).numpy()
    got = points.tp.apply(points.q, p=10).numpy()
    assert rel(got[:, 0], exact[:, 0]) < 3e-5
    assert rel(got[:, 1:], exact[:, 1:]) < 3e-5
    # and a lower order is worse: the expansions do the far field
    low = points.tp.apply(points.q, p=3).numpy()
    assert rel(low[:, 0], exact[:, 0]) > 1e-4
    tight = T.FmmPlan(
        TLaplace(), {"xyz": points.pts},
        T.FMMConfig(ncrit=48, max_p=10, dtype="float64", theta=0.35),
        device="cpu",
    ).apply(points.q, p=10).numpy()
    assert rel(tight[:, 0], exact[:, 0]) < 1e-6
    assert rel(tight[:, 1:], exact[:, 1:]) < 1e-6


def test_point_kernel_has_no_square_operator(points):
    assert points.tp.solver_ops_slots() is None
    assert points.jp.solver_ops_slots() is None
    with pytest.raises(ValueError, match="square"):
        solve_plan(points.tp, np.ones(points.n), device="cpu")


# ----------------------------------------------------------------------
# the unit kernel: every pair counted exactly once
# ----------------------------------------------------------------------
def clustered(rng):
    a = rng.normal(0, 1e-2, (600, 3))
    b = rng.normal(0, 1e-2, (600, 3)) + 5.0
    c = rng.uniform(-3, 8, (300, 3))
    return np.concatenate([a, b, c])


@pytest.mark.parametrize(
    "cloud,ncrit", [("uniform", 16), ("uniform", 64), ("clustered", 24)])
def test_unit_kernel_counts_every_pair_once(cloud, ncrit):
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1, 1, (2500, 3)) if cloud == "uniform" else clustered(rng)
    q = rng.standard_normal(len(pts))
    cfg = dict(ncrit=ncrit, dtype="float64")
    tp = T.FmmPlan(TUnit(), {"xyz": pts}, T.FMMConfig(**cfg), device="cpu")
    got = tp.apply(q, p=3)
    exact = TUnit().direct(tt(pts), tt(pts), tt(q)).numpy()
    assert got.shape == (len(pts), 1)
    assert rel(got, exact) < 1e-13
    np.testing.assert_allclose(
        exact, np.asarray(JUnit().direct(pts, pts, q)), rtol=1e-13)
    # with unit charges the result is the pair count itself: n - 1 each
    ones = tp.apply(np.ones(len(pts)), p=3).numpy()
    np.testing.assert_allclose(ones[:, 0], len(pts) - 1, rtol=1e-13)
    # the slot-space operator of a square point kernel (no linear L2P
    # table, batched p2p_block near field)
    mv, op4p, to_s, from_s, _ = tp.solver_ops_slots()
    y = from_s(mv(op4p(3), to_s(q), 3))
    assert rel(y, exact[:, 0]) < 1e-13
