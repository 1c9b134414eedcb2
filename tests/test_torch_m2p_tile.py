"""The M2P of the Laplace BEM plans as one kernel (``ops/m2p_tile.py``,
``csrc/m2p_tile.cu``).

On the CPU, in f64: the plain version ``m2p_tiles_reference``, which the
plan's ``_m2p_pass`` takes for a ``LaplaceBEMKernel`` (its ``m2p_tile``
marker), against the eager pass every other kernel keeps (the marker
switched off on the instance), on a plan with level-skewed pairs: every
order, both BC variants and a mixed one, the slot and the body-order
route; whole matvecs and a relaxed solve; the tables of an operand
carried across from numpy; a plan without M2P pairs; the counters of
the two routes; bad tables; the wrapper's checks.  The tests marked ``card``
hold the CUDA kernel to the plain version on the card and skip without
one.  This file does not import JAX, so they run where JAX is not
installed: ``python3 -m pytest -o addopts="" --noconftest
tests/test_torch_m2p_tile.py -m card``."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.executor import plan as plan_mod
from fmm_bem_tpu_torch.kernels import harmonics as hm
from fmm_bem_tpu_torch.kernels.cartesian import YukawaKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.ops import m2p_tile as mt
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.utils.convert import operand_from_numpy
from fmm_bem_tpu_torch.utils.metrics import log

MAX_P = 12
ORDERS = (1, 3, 5, 10, MAX_P)
VARIANTS = ("plain", "flipped", "mixed")


def two_spheres():
    """A unit sphere beside a sphere fifty times smaller: the adaptive
    tree gets level-skewed pairs, which go to M2P."""
    small = unit_sphere(4) * 0.02 + np.array([1.3, 0.0, 0.0])
    return np.concatenate([unit_sphere(3), small])


def skewed_plan(device="cpu", dtype="float64", kernel=None, max_p=MAX_P):
    return T.FmmPlan(kernel or LaplaceBEMKernel(K=3),
                     make_panels(two_spheres(), K=3),
                     T.FMMConfig(ncrit=8, dtype=dtype, max_p=max_p),
                     device=device)


@pytest.fixture(scope="module")
def skewed():
    plan = skewed_plan()
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
    plan.kernel.m2p_tile = False
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
        rng.standard_normal((plan.src.tree.num_boxes,
                             2 * hm.real_width(p))),
        dtype=plan.dtype, device=plan.device)
    return d, aux, tf, M, len(plan.tgt.leaf_ids), plan.tgt.leaf_pad


@pytest.mark.parametrize("route", ["slots", "body"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("p", ORDERS)
def test_pass_matches_the_eager_pass(skewed, p, variant, route):
    """``_m2p_pass`` through ``m2p_tiles`` (the plain version on the CPU)
    gives the eager pass's sums to 1e-12, added to the result it is
    given; on the slot route in place, with padded slots left exactly
    0."""
    plan = skewed
    d, aux, tf, M, nl, K = pass_inputs(plan, p, variant)
    rng = np.random.default_rng(9)
    slots = route == "slots"
    if slots:
        res = torch.as_tensor(rng.standard_normal((nl * K, 1))) * \
            d["t_slot_mask"][:, None]
    else:
        res = torch.as_tensor(
            rng.standard_normal((plan.tgt.tree.num_bodies, 1)))
    with eager(plan):
        want = plan._m2p_pass(d, aux, tf, M, p, nl, K, res.clone(),
                              slots=slots)
    given = res.clone()
    got = plan._m2p_pass(d, aux, tf, M, p, nl, K, given, slots=slots)
    assert rel(got - res, want - res) <= 1e-12
    assert rel(got, want) <= 1e-12
    if slots:
        assert got.data_ptr() == given.data_ptr()
        assert bool((got[~d["t_slot_mask"]] == 0).all())
    # the variant's BC tile is its target slots' flags
    body = d["t_leaf_body_idx"][d["m2p_tiles"]["leaves"].long()]
    assert torch.equal(aux["m2p_bc"], tf["bc"][body])


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("p", [3, 10])
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
    """The relaxed first-kind solve (tiers 3, 5, 10, as the benchmark's)
    through the kernel route takes the eager route's iterations and
    orders, and its solution to 1e-10."""
    pts = skewed.src.fields["xyz"]
    phi = 1.0 / np.linalg.norm(pts - np.array([0.2, 1.8, 0.3]), axis=1)
    cfg = T.SolverConfig(residual=1e-5, restart=100, max_p=10, p_min=1,
                         p_tiers=(3, 5, 10))
    b = skewed.apply_flipped_bc(phi[np.argsort(skewed.src.tree.perm)],
                                p=10).numpy()
    x, info, mode = solve_plan(skewed, b, cfg)
    with eager(skewed):
        xe, infoe, _ = solve_plan(skewed, b, cfg)
    assert mode == "device-slots" and info.converged
    assert info.iterations == infoe.iterations
    assert [h[2] for h in info.history] == [h[2] for h in infoe.history]
    assert len({h[2] for h in info.history}) > 1  # the order relaxed
    assert np.abs(x - xe).max() / np.abs(xe).max() <= 1e-10


def test_operand_carried_without_tables(skewed):
    """An operand carried across without the pair tables and the BC tile
    (``utils/convert.py::operand_from_numpy``, from numpy state) gets
    them built there, once, from its ``d`` and its target fields: the
    plan's own tables and the same sums."""
    p = 5
    d, aux, tf, M, nl, K = pass_inputs(skewed, p, "mixed")
    fh = variant_fields(skewed, "mixed")
    bare_d = {k: v.numpy() for k, v in d.items() if torch.is_tensor(v)}
    bare_aux = {k: v.numpy() for k, v in aux.items()
                if torch.is_tensor(v) and k != "m2p_bc"}
    cd, caux, _, _ = operand_from_numpy(
        bare_d, bare_aux, None, None, device="cpu", dtype=torch.float64,
        fields={k: np.asarray(v) for k, v in fh.items()})
    assert cd["m2p_tiles"].keys() == d["m2p_tiles"].keys()
    for k, v in d["m2p_tiles"].items():
        assert cd["m2p_tiles"][k].dtype == v.dtype
        assert torch.equal(cd["m2p_tiles"][k], v), k
    assert torch.equal(caux["m2p_bc"], aux["m2p_bc"])
    res = torch.zeros((nl * K, 1), dtype=M.dtype)
    want = skewed._m2p_pass(d, aux, tf, M, p, nl, K, res.clone())
    got = skewed._m2p_pass(cd, caux, tf, M, p, nl, K, res.clone())
    assert torch.equal(got, want)


def test_pair_tables_group_the_pairs(skewed):
    """``pair_tables``: every pair once, grouped by ascending target
    leaf in its original order; the counts, slot coordinates and bodies
    are the target leaves'."""
    rows = skewed._m2p_rows
    leaves, row_ptr = rows["leaves"], rows["row_ptr"]
    assert np.all(np.diff(leaves) > 0) and row_ptr[0] == 0
    assert row_ptr[-1] == len(skewed.m2p_src)
    for b, leaf in enumerate(leaves):
        mine = np.flatnonzero(skewed.m2p_tgt_slot == leaf)
        sl = slice(row_ptr[b], row_ptr[b + 1])
        np.testing.assert_array_equal(rows["src"][sl], skewed.m2p_src[mine])
        np.testing.assert_array_equal(rows["isig"][sl],
                                      skewed.m2p_inv_sigma[mine])
    tgt = skewed.tgt
    np.testing.assert_array_equal(
        rows["cnt"], tgt.leaf_body_mask[leaves].sum(axis=1))
    np.testing.assert_array_equal(
        rows["xyz"], tgt.tree.points[tgt.leaf_body_idx[leaves]])


def test_plan_without_m2p_pairs():
    """A plan with no level-skewed pairs builds no pair tables and no BC
    tile, and ``m2p_tiles`` on empty tables leaves its result alone."""
    plan = T.FmmPlan(LaplaceBEMKernel(K=3), make_panels(unit_sphere(3), K=3),
                     T.FMMConfig(ncrit=16, dtype="float64", max_p=6),
                     device="cpu")
    assert len(plan.m2p_src) == 0 and plan._m2p_rows is None
    assert "m2p_tiles" not in plan.device_data(5)
    assert "m2p_bc" not in plan.variant_aux(5)
    rows = mt.pair_tables(
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0),
        plan.tgt.leaf_body_idx, plan.tgt.leaf_body_mask,
        plan.tgt.tree.points)
    assert rows["leaves"].shape == (0,)
    np.testing.assert_array_equal(rows["row_ptr"], [0])
    t = plan._m2p_device(rows)
    K = plan.tgt.leaf_pad
    out = torch.ones((len(plan.tgt.leaf_ids), K), dtype=torch.float64)
    M = torch.ones((plan.src.tree.num_boxes, 2 * hm.real_width(5)),
                   dtype=torch.float64)
    got = mt.m2p_tiles(
        M, plan.device_data(5)["s_box_center"], t["leaves"], t["row_ptr"],
        t["src"], t["isig"], t["cnt"], t["xyz"].reshape(0, K, 3),
        torch.zeros((0, K), dtype=torch.float64), out, 5)
    assert torch.equal(got, torch.ones_like(out))


def profiled_counts(fn):
    log.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    counts = {}
    for (name, _), n in log.counts().items():
        counts[name] = counts.get(name, 0) + n
    log.clear_spans()
    return counts


@pytest.mark.parametrize("kernel", ["laplace_bem", "yukawa_bem",
                                    "unmarked"])
def test_which_route_runs(kernel, monkeypatch):
    """Each ``_m2p_pass`` counts its route: ``m2p.kernel`` on a Laplace BEM
    plan and on a Yukawa BEM plan (one a matvec, ``m2p.eager`` never),
    each through the wrapper its kernel's marker names and never the
    other; a kernel without the marker (the Yukawa BEM plan's kernel
    given the point ``YukawaKernel``'s none) takes the eager pass and
    calls neither wrapper."""
    if kernel == "laplace_bem":
        plan = skewed_plan(max_p=4)
    else:
        # per-level translations: a low order keeps the build short
        plan = skewed_plan(kernel=YukawaBEMKernel(K=3, kappa=0.125), max_p=4)
        assert plan.kernel.m2p_tile == "m2p_cart_tile"
        assert plan._m2p_rows is not None and len(plan.m2p_src) > 0
    if kernel == "unmarked":
        monkeypatch.setattr(plan.kernel, "m2p_tile",
                            getattr(YukawaKernel(), "m2p_tile", None))
    called = []
    for name in ("m2p_tiles", "m2p_cart_tiles"):
        wrapper = getattr(plan_mod, name)

        def counted(*a, _name=name, _wrapper=wrapper, **k):
            called.append(_name)
            return _wrapper(*a, **k)

        monkeypatch.setattr(plan_mod, name, counted)
    q = np.random.default_rng(2).standard_normal(plan.src.tree.num_bodies)
    counts = profiled_counts(lambda: (plan.apply(q, p=4),
                                      plan.apply_body_order(q, p=4)))
    route = "m2p.eager" if kernel == "unmarked" else "m2p.kernel"
    other = "m2p.kernel" if kernel == "unmarked" else "m2p.eager"
    assert counts.get(route) == 2 and other not in counts
    assert called == {"laplace_bem": ["m2p_tiles"] * 2,
                      "yukawa_bem": ["m2p_cart_tiles"] * 2,
                      "unmarked": []}[kernel]


def small_tables(dtype=torch.float64, device="cpu"):
    """Hand-made tables over 3 boxes, 2 target leaves of 4 slots, p=3:
    leaf 0 has 3 real slots and 2 pairs, leaf 1 has 2 real slots and 1
    pair."""
    rng = np.random.default_rng(1)
    p = 3

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return dict(
        M=f(rng.standard_normal((3, 2 * hm.real_width(p)))),
        centers=f(rng.uniform(-1, 1, (3, 3))),
        leaves=i([0, 2]), row_ptr=i([0, 2, 3]), src=i([0, 2, 1]),
        isig=f([0.5, 0.8, 0.6]), cnt=i([3, 2]),
        xyz=f(rng.uniform(3, 4, (2, 4, 3))),
        bc=f([[0, 1, 0, 0], [1, 0, 1, 1]]),
        out=f(np.full((3, 4), 7.0)), p=p,
    )


def test_reference_on_bad_tables():
    """Padded slots and leaves without pairs keep their values; a source
    box outside the table is an empty pair; a count past K reads as K."""
    tb = small_tables()
    want = mt.m2p_tiles_reference(**{**tb, "out": tb["out"].clone()})
    assert bool((want[0, 3:] == 7.0).all() and (want[1] == 7.0).all()
                and (want[2, 2:] == 7.0).all())
    assert bool((want[0, :3] != 7.0).all() and (want[2, :2] != 7.0).all())
    # an out-of-range source box: the pair adds nothing
    bad = dict(tb, src=torch.tensor([0, 9, 1], dtype=torch.int32),
               out=tb["out"].clone())
    drop = dict(tb, src=torch.tensor([0, 1], dtype=torch.int32),
                isig=tb["isig"][[0, 2]],
                row_ptr=torch.tensor([0, 1, 2], dtype=torch.int32),
                out=tb["out"].clone())
    assert torch.equal(mt.m2p_tiles_reference(**bad),
                       mt.m2p_tiles_reference(**drop))
    # a count past K is K
    full = dict(tb, cnt=torch.tensor([4, 2], dtype=torch.int32),
                out=tb["out"].clone())
    over = dict(tb, cnt=torch.tensor([99, 2], dtype=torch.int32),
                out=tb["out"].clone())
    assert torch.equal(mt.m2p_tiles_reference(**full),
                       mt.m2p_tiles_reference(**over))


@pytest.mark.parametrize("case", [
    "M_int", "src_int64", "bc_f32", "out_shape", "M_width", "xyz_shape",
    "not_contiguous",
])
def test_kernel_args_are_checked(case):
    """What the CUDA entry point refuses, checked on CPU tensors."""
    tb = small_tables()
    bad = {
        "M_int": dict(M=tb["M"].long()),
        "src_int64": dict(src=tb["src"].long()),
        "bc_f32": dict(bc=tb["bc"].float()),
        "out_shape": dict(out=tb["out"][:, :3].contiguous()),
        "M_width": dict(M=tb["M"][:, :-2].contiguous()),
        "xyz_shape": dict(xyz=tb["xyz"][:1].contiguous()),
        "not_contiguous": dict(out=tb["out"].T.contiguous().T),
    }[case]
    args = {**tb, **bad}
    with pytest.raises((TypeError, ValueError)):
        mt.check_kernel_args(**args)
    assert mt.check_kernel_args(**tb) == (2, 4)


def test_recurrence_coefficients():
    """The kernel's [3, T] factors: the weighted prefactors and the two
    recurrence ratios per (n, m)."""
    p = 5
    tab = mt.recurrence_coefficients(p, torch.float64, "cpu").numpy()
    n, m = hm.term_degrees(p), hm.term_orders(p)
    for k in range(hm.num_terms(p)):
        w = 1.0 if m[k] == 0 else 2.0
        assert tab[0, k] == pytest.approx(w * float(hm.prefac(n[k], m[k])))
        if n[k] > m[k]:
            assert tab[1, k] == pytest.approx((2 * n[k] - 1) / (n[k] - m[k]))
            assert tab[2, k] == pytest.approx(
                (n[k] + m[k] - 1) / (n[k] - m[k]))
        else:
            assert tab[1, k] == 0.0 and tab[2, k] == 0.0


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
    got = mt.m2p_tiles(*args, zeros.clone(), p)
    again = mt.m2p_tiles(*args, zeros.clone(), p)
    want = mt.m2p_tiles_reference(*args, zeros.clone(), p)
    torch.cuda.synchronize()
    pad = ~d["t_slot_mask"].reshape(nl, K)
    return got, again, want, pad


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_kernel_matches_plain_on_the_card(card, dtype, tol):
    """The kernel against the plain version on the card, every order and
    BC variant: relative to the largest value, padded slots exactly 0,
    two launches bit-equal."""
    plan = skewed_plan(device=card, dtype=dtype)
    for p in ORDERS:
        for variant in VARIANTS:
            got, again, want, pad = kernel_against_plain(plan, p, variant)
            assert rel(got, want) <= tol, (p, variant)
            assert bool((got[pad] == 0).all())
            assert torch.equal(got, again)


@pytest.mark.card
def test_kernel_launches_once_a_matvec_on_the_card(card):
    """On the card a Laplace BEM matvec launches the kernel once, its
    slot and body-order results match the plain route on the CPU, and
    the eager route never runs."""
    plan = skewed_plan(device=card, dtype="float64")
    cpu = skewed_plan()
    q = np.random.default_rng(6).standard_normal(plan.src.tree.num_bodies)
    before = mt.m2p_tiles.launches
    counts = profiled_counts(lambda: (plan.apply(q, p=10),
                                      plan.apply_flipped_bc(q, p=5)))
    assert mt.m2p_tiles.launches - before == 2
    assert counts.get("m2p.kernel") == 2 and "m2p.eager" not in counts
    for fn in ("apply", "apply_flipped_bc", "apply_body_order"):
        got = getattr(plan, fn)(q, p=10).cpu()
        want = getattr(cpu, fn)(q, p=10)
        assert rel(got, want) <= 1e-12, fn
