"""The M2P of the Yukawa BEM plans as one kernel (``ops/m2p_cart_tile.py``,
``csrc/m2p_cart_tile.cu``).

On the CPU, in f64: the plain version ``m2p_cart_tiles_reference``,
which the plan's ``_m2p_pass`` takes for a ``YukawaBEMKernel`` (its
``m2p_tile`` marker names ``m2p_cart_tile``), against the eager pass
every other kernel keeps (the marker switched off on the instance), on a
plan with level-skewed pairs: orders 1 to 8, both BC variants and a
mixed one, added into a seeded result and into zeros; whole matvecs
and a relaxed solve; bad tables; the wrapper's checks; and a model of the
kernel's walk (one degree shell at a time, each term's parents at fixed
offsets, the scale-free form) against the eager Taylor weights.  The
tests marked ``card`` hold the CUDA kernel to the plain version on the
card and skip without one.  This file does not import JAX, so they run
where JAX is not installed: ``python3 -m pytest -o addopts=""
--noconftest tests/test_torch_m2p_cart_tile.py -m card``."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels import cartesian as ct
from fmm_bem_tpu_torch.kernels import harmonics as hm
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.ops import m2p_cart_tile as mc
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.utils.metrics import log

KAPPA = 0.125
MAX_P = 8
ORDERS = (1, 3, 5, MAX_P)
VARIANTS = ("plain", "flipped", "mixed")


def skewed_plan(device="cpu", dtype="float64", max_p=MAX_P, kappa=KAPPA):
    """A Yukawa BEM plan on a unit sphere beside a sphere fifty times
    smaller: the adaptive tree gets level-skewed pairs, which go to
    M2P."""
    small = unit_sphere(3) * 0.02 + np.array([1.3, 0.0, 0.0])
    tris = np.concatenate([unit_sphere(3), small])
    return T.FmmPlan(YukawaBEMKernel(K=3, kappa=kappa),
                     make_panels(tris, K=3),
                     T.FMMConfig(ncrit=8, dtype=dtype, max_p=max_p),
                     device=device)


@pytest.fixture(scope="module")
def skewed():
    plan = skewed_plan()
    assert plan.kernel.m2p_tile == "m2p_cart_tile"
    assert len(plan.m2p_src) > 0 and plan._m2p_rows is not None
    return plan


def variant_fields(plan, variant):
    """Host fields of a BC variant (Morton order): the plan's own (every
    flag 0), the flipped ones (every flag 1), or seeded mixed flags."""
    if variant == "plain":
        return plan.src.fields
    if variant == "flipped":
        return plan._flipped_fields()
    fields = dict(plan.src.fields)
    n = len(fields["bc"])
    fields["bc"] = np.random.default_rng(5).integers(0, 2, n).astype(float)
    return fields


@contextlib.contextmanager
def eager(plan):
    """The plan's kernel without its ``m2p_tile`` marker: the eager pass."""
    plan.kernel.m2p_tile = None
    try:
        yield
    finally:
        del plan.kernel.m2p_tile


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def pass_inputs(plan, p, variant, seed=3):
    """(d, aux, tf, M, nl, K) of one order and variant: seeded multipole
    rows (the pass is linear in them, so every term weighs alike)."""
    fh = variant_fields(plan, variant)
    d = plan.device_data(p)
    aux = plan.variant_aux(p, src_host=fh, tgt_host=fh)
    tf = plan.device_fields(fh)
    rng = np.random.default_rng(seed)
    M = torch.as_tensor(
        rng.standard_normal((plan.src.tree.num_boxes, 2 * ct.num_terms(p))),
        dtype=plan.dtype, device=plan.device)
    return d, aux, tf, M, len(plan.tgt.leaf_ids), plan.tgt.leaf_pad


@pytest.mark.parametrize("start", ["given", "zero"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("p", ORDERS)
def test_pass_matches_the_eager_pass(skewed, p, variant, start):
    """``_m2p_pass`` through ``m2p_cart_tiles`` (the plain version on the
    CPU) gives the eager ``YukawaBEMKernel.m2p`` pass's sums to 1e-12,
    added in place to the slot result it is given (seeded, as an FMM
    matvec's L2P rows, or zeros, as a treecode's), with padded slots left
    exactly 0."""
    plan = skewed
    d, aux, tf, M, nl, K = pass_inputs(plan, p, variant)
    rng = np.random.default_rng(9)
    res = torch.as_tensor(rng.standard_normal((nl * K, 1))) * \
        d["t_slot_mask"][:, None]
    if start == "zero":
        res = torch.zeros_like(res)
    with eager(plan):
        want = plan._m2p_pass(d, aux, tf, M, p, nl, K, res.clone())
    given = res.clone()
    got = plan._m2p_pass(d, aux, tf, M, p, nl, K, given)
    assert rel(got - res, want - res) <= 1e-12
    assert rel(got, want) <= 1e-12
    assert got.data_ptr() == given.data_ptr()
    assert bool((got[~d["t_slot_mask"]] == 0).all())
    body = d["t_leaf_body_idx"][d["m2p_tiles"]["leaves"].long()]
    assert torch.equal(aux["m2p_bc"], tf["bc"][body])


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("p", [3, MAX_P])
def test_matvec_slots_unchanged(skewed, p, flipped):
    """A whole slot matvec through the kernel route equals the eager
    one to 1e-12."""
    mv, op4p, to_s, _, _ = skewed.solver_ops_slots(flipped=flipped)
    q = np.random.default_rng(4).standard_normal(skewed.src.tree.num_bodies)
    x = to_s(q)
    got = mv(op4p(p), x, p)
    with eager(skewed):
        want = mv(op4p(p), x, p)
    assert rel(got, want) <= 1e-12


def test_relaxed_solve_unchanged(skewed):
    """The relaxed first-kind solve (tiers 3, 5, 8, as the benchmark's
    Yukawa cell) through the kernel route takes the eager route's
    iterations, orders and residuals, and its solution to 1e-10.  (On
    this small plan the order stays at 8.)"""
    pts = skewed.src.fields["xyz"]
    phi = 1.0 / np.linalg.norm(pts - np.array([0.2, 1.8, 0.3]), axis=1)
    cfg = T.SolverConfig(residual=1e-5, restart=100, max_p=MAX_P, p_min=1,
                         p_tiers=(3, 5, MAX_P))
    b = skewed.apply_flipped_bc(phi[np.argsort(skewed.src.tree.perm)],
                                p=MAX_P).numpy()
    x, info, mode = solve_plan(skewed, b, cfg)
    with eager(skewed):
        xe, infoe, _ = solve_plan(skewed, b, cfg)
    assert mode == "device-slots" and info.converged
    assert info.iterations == infoe.iterations
    assert [h[2] for h in info.history] == [h[2] for h in infoe.history]
    np.testing.assert_allclose([h[1] for h in info.history],
                               [h[1] for h in infoe.history], rtol=1e-8)
    assert np.abs(x - xe).max() / np.abs(xe).max() <= 1e-10


def shell_walk(d, g, kappa, p):
    """A model of the kernel's walk for one evaluation, on the host: the
    Taylor weights a! a_a(d / g; kappa) g^-|a| from the scale-free
    recurrence at kappa / g, one degree shell at a time, each term's
    parents read at their fixed offsets in shells n - 1 and n - 2 and
    the factors taken from ``term_table``."""
    tab = mc.term_table(p, torch.float64, "cpu").numpy()
    nt = ct.num_terms(p)
    fac, dfac = tab[:nt], tab[nt:].reshape(p + 1, 3)
    x, y, z = d
    R2 = x * x + y * y + z * z
    R = np.sqrt(R2)
    kp = kappa / g
    A = [np.array([np.exp(-kp * R) / R])]
    B = [np.array([np.exp(-kp * R)])]
    for n in range(1, p + 1):
        c1, c2, c3 = dfac[n]
        kc = kp * c3
        a, b = [], []
        for u in range(n + 1):          # position u(u+1)/2 + k
            for k in range(u + 1):
                pos, j = u * (u + 1) // 2 + k, u - k
                s = np.zeros(4)         # sa1, sb1, sa2, sb2
                for ok, f, sh, off in (
                        (u < n, x, 1, pos), (j >= 1, y, 1, pos - u),
                        (k >= 1, z, 1, pos - u - 1),
                        (u < n - 1, 1.0, 2, pos),
                        (j >= 2, 1.0, 2, pos - 2 * u + 1),
                        (k >= 2, 1.0, 2, pos - 2 * u - 1)):
                    if ok:
                        i = 0 if sh == 1 else 2
                        s[i] += f * A[n - sh][off]
                        s[i + 1] += f * B[n - sh][off]
                a.append((-kc * (s[1] + s[3]) - c1 * s[0] - c2 * s[2]) / R2)
                b.append(-kc * (s[0] + s[2]))
        A.append(np.array(a))
        B.append(np.array(b))
    return np.concatenate(A) * fac * g


@pytest.mark.parametrize("kappa", [0.0, KAPPA, 2.0])
@pytest.mark.parametrize("p", [1, 3, 8, 10])
def test_shell_walk_is_the_taylor_weights(p, kappa):
    """The kernel's arithmetic (``shell_walk``) gives the eager
    ``kernels/cartesian.py::taylor_weights`` to 1e-13 over offsets and
    box sizes of every level."""
    rng = np.random.default_rng(p)
    for _ in range(4):
        d = rng.uniform(-3.0, 3.0, 3)
        d *= rng.uniform(1.5, 4.0) / np.linalg.norm(d)
        g = 10.0 ** rng.uniform(-0.5, 3.0)
        want = ct.taylor_weights(
            torch.as_tensor(d)[None], torch.tensor([g], dtype=torch.float64),
            kappa, p, torch.zeros(1, dtype=torch.float64))[0].numpy()
        got = shell_walk(d, g, kappa, p)
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_term_table():
    """The kernel's table: a! per flat term, then (2n - 1) / n,
    (n - 1) / n and 1 / n per degree; cached per (p, dtype, device)."""
    p = 5
    tab = mc.term_table(p, torch.float64, "cpu").numpy()
    alphas, _, _, _, _ = ct.index_set(p)
    nt = ct.num_terms(p)
    assert tab.shape == (nt + 3 * (p + 1),)
    for t, (i, j, k) in enumerate(alphas):
        assert tab[t] == float(np.prod([np.prod(np.arange(1, e + 1))
                                        for e in (i, j, k)]))
    deg = tab[nt:].reshape(p + 1, 3)
    assert list(deg[0]) == [0.0, 0.0, 0.0]
    for n in range(1, p + 1):
        assert deg[n] == pytest.approx([(2 * n - 1) / n, (n - 1) / n, 1 / n])
    assert mc.term_table(p, torch.float64, "cpu") is \
        mc.term_table(p, torch.float64, "cpu")


def profiled_counts(fn):
    log.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    counts = {}
    for (name, _), n in log.counts().items():
        counts[name] = counts.get(name, 0) + n
    log.clear_spans()
    return counts


def small_tables(dtype=torch.float64, device="cpu", p=3):
    """Hand-made tables over 3 boxes, 2 target leaves of 4 slots: leaf 0
    has 3 real slots and 2 pairs, leaf 1 has 2 real slots and 1 pair."""
    rng = np.random.default_rng(1)

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return dict(
        M=f(rng.standard_normal((3, 2 * ct.num_terms(p)))),
        centers=f(rng.uniform(-1, 1, (3, 3))),
        leaves=i([0, 2]), row_ptr=i([0, 2, 3]), src=i([0, 2, 1]),
        isig=f([0.5, 0.8, 0.6]), cnt=i([3, 2]),
        xyz=f(rng.uniform(3, 4, (2, 4, 3))),
        bc=f([[0, 1, 0, 0], [1, 0, 1, 1]]),
        out=f(np.full((3, 4), 7.0)), p=p, kappa=KAPPA,
    )


def bad_table_cases(tb):
    """(name, bad tables, the tables they read as) for the kernel's
    reading of bad tables: a source box outside [0, nbox) is an empty
    pair, a count above K reads as K, a negative count as 0."""
    i32 = torch.int32
    dev = tb["M"].device
    drop = dict(tb, src=torch.tensor([0, 1], dtype=i32, device=dev),
                isig=tb["isig"][[0, 2]],
                row_ptr=torch.tensor([0, 1, 2], dtype=i32, device=dev))
    return [
        ("src_past_nbox",
         dict(tb, src=torch.tensor([0, 9, 1], dtype=i32, device=dev)), drop),
        ("src_negative",
         dict(tb, src=torch.tensor([0, -1, 1], dtype=i32, device=dev)),
         drop),
        ("count_past_K", dict(tb, cnt=torch.tensor([99, 2], dtype=i32,
                                                   device=dev)),
         dict(tb, cnt=torch.tensor([4, 2], dtype=i32, device=dev))),
        ("count_negative", dict(tb, cnt=torch.tensor([3, -3], dtype=i32,
                                                     device=dev)),
         dict(tb, cnt=torch.tensor([3, 0], dtype=i32, device=dev))),
    ]


def test_reference_on_good_tables():
    """Padded slots and leaves without pairs keep their values; real
    slots get their sums."""
    tb = small_tables()
    want = mc.m2p_cart_tiles_reference(**{**tb, "out": tb["out"].clone()})
    assert bool((want[0, 3:] == 7.0).all() and (want[1] == 7.0).all()
                and (want[2, 2:] == 7.0).all())
    assert bool((want[0, :3] != 7.0).all() and (want[2, :2] != 7.0).all())


@pytest.mark.parametrize("case", ["src_past_nbox", "src_negative",
                                  "count_past_K", "count_negative"])
def test_reference_on_bad_tables(case):
    """The plain version reads bad tables as the kernel reads them."""
    tb = small_tables()
    bad, fixed = next((b, f) for n, b, f in bad_table_cases(tb) if n == case)
    got = mc.m2p_cart_tiles_reference(**{**bad, "out": tb["out"].clone()})
    want = mc.m2p_cart_tiles_reference(**{**fixed, "out": tb["out"].clone()})
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    "M_int", "src_int64", "bc_f32", "out_device", "out_shape", "M_width",
    "xyz_shape", "not_contiguous", "p_past_smem",
])
def test_kernel_args_are_checked(case):
    """What the CUDA entry point refuses, checked on CPU tensors: a wrong
    dtype, device, shape or contiguity, and an order whose shared memory
    does not fit a block."""
    tb = small_tables()
    del tb["kappa"]
    bad = {
        "M_int": dict(M=tb["M"].long()),
        "src_int64": dict(src=tb["src"].long()),
        "bc_f32": dict(bc=tb["bc"].float()),
        "out_device": dict(out=torch.empty((3, 4), dtype=torch.float64,
                                           device="meta")),
        "out_shape": dict(out=tb["out"][:, :3].contiguous()),
        # the spherical rows of the same order: the Laplace kernel's width
        "M_width": dict(M=tb["M"][:, :2 * hm.real_width(3)].contiguous()),
        "xyz_shape": dict(xyz=tb["xyz"][:1].contiguous()),
        "not_contiguous": dict(out=tb["out"].T.contiguous().T),
        "p_past_smem": dict(small_tables(p=13)),
    }[case]
    args = {**tb, **bad}
    args.pop("kappa", None)
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        mc.check_kernel_args(**args)
    assert mc.check_kernel_args(**tb) == (2, 4)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_every_order_to_ten_fits(itemsize):
    """The shared memory of orders 1 to 10 fits a block in both dtypes
    (f64 to 11, f32 to 15); one past does not."""
    fits = [p for p in range(1, 20)
            if mc.smem_bytes(p, itemsize) <= mc.SMEM_MAX]
    assert fits == list(range(1, {4: 16, 8: 12}[itemsize]))


@pytest.mark.parametrize("kernel", ["yukawa_bem", "yukawa_points"])
def test_the_marker_picks_the_route(kernel):
    """Only ``YukawaBEMKernel`` names the Cartesian tile kernel; the point
    Yukawa and Cartesian Laplace kernels it derives from have no
    marker."""
    from fmm_bem_tpu_torch.kernels.cartesian import (
        LaplaceCartesianKernel,
        YukawaKernel,
    )

    if kernel == "yukawa_bem":
        assert YukawaBEMKernel().m2p_tile == "m2p_cart_tile"
    else:
        assert getattr(YukawaKernel(), "m2p_tile", None) is None
        assert getattr(LaplaceCartesianKernel(), "m2p_tile", None) is None


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


def kernel_against_plain(plan, p, variant):
    d, aux, tf, M, nl, K = pass_inputs(plan, p, variant)
    t = d["m2p_tiles"]
    args = (M, d["s_box_center"], t["leaves"], t["row_ptr"], t["src"],
            t["isig"], t["cnt"], t["xyz"], aux["m2p_bc"])
    zeros = torch.zeros((nl, K), dtype=M.dtype, device=M.device)
    got = mc.m2p_cart_tiles(*args, zeros.clone(), p, KAPPA)
    again = mc.m2p_cart_tiles(*args, zeros.clone(), p, KAPPA)
    want = mc.m2p_cart_tiles_reference(*args, zeros.clone(), p, KAPPA)
    torch.cuda.synchronize()
    pad = ~d["t_slot_mask"].reshape(nl, K)
    return got, again, want, pad


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_kernel_matches_plain_on_the_card(card, dtype, tol):
    """The kernel against the plain version on the card, every order to
    the plan's and every BC variant: relative to the largest value,
    padded slots exactly 0, two launches bit-equal."""
    plan = skewed_plan(device=card, dtype=dtype, max_p=10)
    for p in (1, 2, 3, 5, 8, 10):
        for variant in VARIANTS:
            got, again, want, pad = kernel_against_plain(plan, p, variant)
            assert rel(got, want) <= tol, (p, variant)
            assert bool((got[pad] == 0).all())
            assert torch.equal(got, again)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_reads_bad_tables_on_the_card(card, dtype):
    """The kernel reads bad tables as the plain version does."""
    tb = small_tables(dtype=dtype, device=card)
    for name, bad, _ in bad_table_cases(tb):
        got = mc.m2p_cart_tiles(**{**bad, "out": tb["out"].clone()})
        want = mc.m2p_cart_tiles_reference(**{**bad,
                                              "out": tb["out"].clone()})
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert rel(got - 7.0, want - 7.0) <= tol, name


@pytest.mark.card
def test_smem_bytes_is_the_library_s(card):
    """The wrapper's shared-memory sum is the kernel's own."""
    for p in range(1, 18):
        for itemsize in (4, 8):
            assert mc.smem_bytes(p, itemsize) == \
                mc.library_smem_bytes(p, itemsize), (p, itemsize)


@pytest.mark.card
def test_kernel_launches_once_a_matvec_on_the_card(card):
    """On the card a Yukawa BEM matvec launches the kernel once, its
    results (the plain and the flipped operator and a target-field
    override) match the plain route on the CPU, and the
    eager route never runs."""
    plan = skewed_plan(device=card)
    cpu = skewed_plan()
    q = np.random.default_rng(6).standard_normal(plan.src.tree.num_bodies)
    before = mc.m2p_cart_tiles.launches
    counts = profiled_counts(lambda: (plan.apply(q, p=MAX_P),
                                      plan.apply_flipped_bc(q, p=5)))
    assert mc.m2p_cart_tiles.launches - before == 2
    assert counts.get("m2p.kernel") == 2 and "m2p.eager" not in counts

    def runs(pl):
        return {"apply": pl.apply(q, p=MAX_P),
                "apply_flipped_bc": pl.apply_flipped_bc(q, p=MAX_P),
                "target_fields": pl.apply(
                    q, p=MAX_P, target_fields=pl._flipped_fields())}

    want = runs(cpu)
    for fn, got in runs(plan).items():
        assert rel(got.cpu(), want[fn]) <= 1e-12, fn
