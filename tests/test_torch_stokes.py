"""The Stokes slice of the PyTorch port against the JAX package, on the CPU
at f64: the closed-form panel integrals and the host near-field assembly
(array for array), the stokeslet / stresslet / Stokes-BEM operators, the
3x3-block panel store and the two-stage near-field route with its chunk
contraction, and the slice as a whole (``apply``, ``apply_flipped_bc``,
the slot matvec on tables carried across as numpy, ``solve_plan``).
Inputs are made with numpy from a seed and handed to both packages.
Tolerance 1e-12 relative unless said: the two sides do the same
arithmetic and take their sums in another order."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem import analytical as jana
from fmm_bem_tpu.bem.panels import make_panels, switch_bc
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels import stokes as jst
from fmm_bem_tpu.kernels import stokes_bem as jsb
from fmm_bem_tpu.ops import near_panel as jnp_mod
from fmm_bem_tpu.solver.api import solve_plan as j_solve_plan
from fmm_bem_tpu_torch.bem import analytical as tana
from fmm_bem_tpu_torch.kernels import stokes as tst
from fmm_bem_tpu_torch.kernels import stokes_bem as tsb
from fmm_bem_tpu_torch.ops import near_panel as tnp_mod
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.utils.convert import operand_from_numpy

TOL = 1e-12
MU = 1e-3
META_FIELDS = ("nl_t", "m0", "block_rows", "npairs", "rdim", "cdim", "KT", "KS")


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair(stokes_plan64):
    """The shared reference plan (``stokes_plan64``) and the port's plan
    from the same panels (rec-3 sphere, ncrit=32, f64, max_p=10)."""
    tris, fields, jkern, jp = stokes_plan64
    tp = T.FmmPlan(
        tsb.StokesBEMKernel(K=4, fine_K=19, mu=MU), fields,
        T.FMMConfig(ncrit=32, dtype="float64", max_p=10), device="cpu",
    )
    return fields, jp, tp


# ----------------------------------------------------------------------
# host side: copies, held array for array
# ----------------------------------------------------------------------


def _panels_and_points(seed, n=40):
    rng = np.random.default_rng(seed)
    verts = rng.standard_normal((n, 3, 3))
    cent = verts.mean(axis=1)
    nrm = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1)[:, None]
    off = cent + 0.3 * rng.standard_normal((n, 1)) * nrm \
        + 0.2 * rng.standard_normal((n, 3))
    return verts, cent, off


@pytest.mark.parametrize(
    "name,in_plane",
    [
        ("laplace_single_layer_self", True),
        ("stokes_single_layer_self", True),
        ("solid_angle", False),
        ("laplace_layers", False),
        ("stokes_single_layer", False),
        ("stokes_stresslet_layer", False),
    ],
)
def test_analytical_integrals_are_a_copy(name, in_plane):
    verts, cent, off = _panels_and_points(1)
    x = cent if in_plane else off
    want = getattr(jana, name)(verts, x)
    got = getattr(tana, name)(verts, x)
    if isinstance(want, tuple):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(np.asarray(got if not isinstance(got, tuple) else got[0])).all()


def test_host_blocks_are_a_copy():
    rng = np.random.default_rng(2)
    dx = rng.standard_normal((5, 7, 3))
    dx[0, 0] = 0.0  # below eps2: a zero block
    r2 = (dx * dx).sum(-1)
    nrm = rng.standard_normal((5, 1, 3))
    np.testing.assert_array_equal(
        tsb._stokeslet_block(dx, r2), jsb._stokeslet_block(dx, r2))
    np.testing.assert_array_equal(
        tsb._stresslet_block(dx, r2, nrm), jsb._stresslet_block(dx, r2, nrm))
    verts, cent, _ = _panels_and_points(3, n=6)
    np.testing.assert_array_equal(
        tsb._self_velocity_integral(verts, cent, n_duffy=8),
        jsb._self_velocity_integral(verts, cent, n_duffy=8),
    )


def test_near_values_on_the_plans_entries(pair):
    _, jp, tp = pair
    assert len(tp.near_rows) > 0
    for name in ("p2p_src_slot", "p2p_tgt_slot", "near_rows", "near_cols"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert tp.near_vals.shape == (len(tp.near_rows), 2, 3, 3)
    np.testing.assert_allclose(
        tp.near_vals, jp.near_vals, rtol=1e-14, atol=1e-14)
    # self, near-singular and regular entries are all present
    d = np.linalg.norm(
        tp.tgt.fields["xyz"][tp.near_rows] - tp.src.fields["xyz"][tp.near_cols],
        axis=1,
    )
    ratio = np.sqrt(2.0 * tp.src.fields["area"][tp.near_cols]) / np.maximum(d, 1e-300)
    assert (d < 1e-8).any() and ((ratio >= 0.5) & (d >= 1e-8)).any()
    assert (ratio < 0.5).any()


@pytest.mark.parametrize("analytical", [True, False])
def test_near_entries_in_chunks(pair, analytical):
    """Walking the entries in chunks smaller than their count gives the
    array the reference computes in one pass."""
    _, jp, tp = pair
    rows, cols = tp.near_rows[:3000], tp.near_cols[:3000]
    want = jsb.stokes_near_entries(
        jp.tgt.fields, jp.src.fields, rows, cols, MU, analytical=analytical)
    for chunk in (700, None):
        got = tsb.stokes_near_entries(
            tp.tgt.fields, tp.src.fields, rows, cols, MU,
            analytical=analytical, chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-14, atol=1e-14)


def test_near_select_and_dense_matrix():
    fields = make_panels(unit_sphere(2), K=4)
    assert len(fields["xyz"]) == 32
    fields["bc"] = (np.arange(32) % 3 == 0).astype(np.float64)  # both kinds
    jk = jsb.StokesBEMKernel(K=4, fine_K=19, mu=MU)
    tk = tsb.StokesBEMKernel(K=4, fine_K=19, mu=MU)
    np.testing.assert_allclose(
        tk.dense_matrix(fields), jk.dense_matrix(fields),
        rtol=1e-14, atol=1e-14)
    vals = np.random.default_rng(4).standard_normal((50, 2, 3, 3))
    bc_rows = fields["bc"][np.arange(50) % 32]
    np.testing.assert_array_equal(
        tk.near_select(vals, bc_rows), jk.near_select(vals, bc_rows))
    assert (tsb.VELOCITY, tsb.TRACTION) == (jsb.VELOCITY, jsb.TRACTION)


# ----------------------------------------------------------------------
# operators
# ----------------------------------------------------------------------


def _points(seed, n=60):
    rng = np.random.default_rng(seed)
    return {
        "xyz": rng.uniform(-1, 1, (n, 3)),
        "dn": rng.uniform(-0.5, 0.5, (n, 3)),
        "isig": rng.uniform(0.5, 2.0, n),
    }


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("p", [1, 5, 10])
def test_tornberg_velocity(p, singular):
    pts = _points(p)
    n = len(pts["isig"])
    W = 2 * (p * (p + 1) // 2)
    E = np.random.default_rng(7).standard_normal((n, 4, W))
    dn = pts["dn"] + (2.5 if singular else 0.0)  # off the expansion centre
    want = jax.vmap(
        lambda e, d, s, t: jst.tornberg_velocity(e, d, s, t, p, singular, 0.7)
    )(jnp.asarray(E), jnp.asarray(dn), jnp.asarray(pts["isig"]),
      jnp.asarray(pts["xyz"]))
    got = tst.tornberg_velocity(
        torch.as_tensor(E), torch.as_tensor(dn), torch.as_tensor(pts["isig"]),
        torch.as_tensor(pts["xyz"]), p, singular, 0.7)
    assert rel(got, want) <= TOL


POINT_KERNELS = {
    "stokeslet": (jst.StokesKernel, tst.StokesKernel),
    "stresslet": (jst.StressletKernel, tst.StressletKernel),
}


@pytest.mark.parametrize("op", ["p2m", "l2p", "m2p", "p2p"])
@pytest.mark.parametrize("which", sorted(POINT_KERNELS))
def test_point_kernel_operators(which, op):
    jk, tk = (cls() for cls in POINT_KERNELS[which])
    for name in ("ncomp", "charge_dim", "result_dim", "scale", "eps2"):
        assert getattr(jk, name) == getattr(tk, name)
    assert getattr(tk, "linear_p2m", True) == getattr(jk, "linear_p2m", True)
    p = 6
    pts = _points(11)
    n = len(pts["isig"])
    rng = np.random.default_rng(12)
    q = rng.standard_normal((n, tk.charge_dim))
    jf, tf = {"xyz": jnp.asarray(pts["xyz"])}, {"xyz": torch.as_tensor(pts["xyz"])}
    if op == "p2m":
        want = jk.p2m(jf, jnp.asarray(q), jnp.asarray(pts["dn"]),
                      jnp.asarray(pts["isig"]), p)
        got = tk.p2m(tf, torch.as_tensor(q), torch.as_tensor(pts["dn"]),
                     torch.as_tensor(pts["isig"]), p)
        assert got.shape == (n, 4, tk.width(p))
    elif op == "p2p":
        src = rng.uniform(-1, 1, (45, 3))
        src[0] = pts["xyz"][0]  # a coincident pair: excluded by eps2
        qs = rng.standard_normal((45, tk.charge_dim))
        want = jk.p2p(jf["xyz"], jnp.asarray(src), jnp.asarray(qs))
        got = tk.p2p(tf["xyz"], torch.as_tensor(src), torch.as_tensor(qs))
        close_d = tk.direct(tf["xyz"], torch.as_tensor(src),
                            torch.as_tensor(qs), chunk=16)
        assert rel(close_d, want) <= TOL
    else:
        E = rng.standard_normal((n, 4, tk.width(p)))
        dn = pts["dn"] + (2.5 if op == "m2p" else 0.0)
        want = getattr(jk, op)(jf, jnp.asarray(E), jnp.asarray(dn),
                               jnp.asarray(pts["isig"]), p)
        got = getattr(tk, op)(tf, torch.as_tensor(E), torch.as_tensor(dn),
                              torch.as_tensor(pts["isig"]), p)
        assert got.shape == (n, 3)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("op", ["p2m", "l2p", "m2p"])
@pytest.mark.parametrize("p", [3, 8])
def test_stokes_bem_operators(p, op):
    fields = make_panels(unit_sphere(2), K=4)
    n = len(fields["xyz"])
    fields["bc"] = (np.arange(n) % 2).astype(np.float64)  # both kinds
    jk = jsb.StokesBEMKernel(K=4, mu=MU)
    tk = tsb.StokesBEMKernel(K=4, mu=MU)
    for name in ("ncomp", "charge_dim", "result_dim", "near_sparse", "mu"):
        assert getattr(jk, name) == getattr(tk, name)
    assert not hasattr(tk, "l2p_table") and not hasattr(tk, "near_block_device")
    rng = np.random.default_rng(20 + p)
    dn = rng.uniform(-0.5, 0.5, (n, 3))
    isig = rng.uniform(0.5, 2.0, n)
    dev = {k: v for k, v in fields.items() if k != "vertices"}
    jf = {k: jnp.asarray(v, jnp.float64) for k, v in dev.items()}
    tf = {k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in dev.items()}
    if op == "p2m":
        q = rng.standard_normal((n, 3))
        want = jk.p2m(jf, jnp.asarray(q), jnp.asarray(dn), jnp.asarray(isig), p)
        got = tk.p2m(tf, torch.as_tensor(q), torch.as_tensor(dn),
                     torch.as_tensor(isig), p)
        assert got.shape == (n, 8, tk.width(p))
        # velocity panels fill set 0 only, traction panels set 1 only
        g = got.numpy()
        assert not g[fields["bc"] == 0, 4:].any()
        assert not g[fields["bc"] == 1, :4].any()
    else:
        E = rng.standard_normal((n, 8, tk.width(p)))
        if op == "m2p":
            dn = dn + 2.5
        want = getattr(jk, op)(jf, jnp.asarray(E), jnp.asarray(dn),
                               jnp.asarray(isig), p)
        got = getattr(tk, op)(tf, torch.as_tensor(E), torch.as_tensor(dn),
                              torch.as_tensor(isig), p)
        assert got.shape == (n, 3)
        # the stresslet set at traction targets: the port scales it by
        # -0.5, the sign of the near-field blocks, the JAX package by +0.5
        assert tk.traction_far_scale == -0.5
        want = np.where((fields["bc"] == 1)[:, None], -1.0, 1.0) * np.asarray(want)
    assert rel(got, want) <= TOL


def test_traction_far_field_has_the_near_fields_sign():
    """A cluster's stresslet moments evaluated at distant traction
    targets against the quadrature blocks of the same pairs (the values
    the near store would hold): the far field continues the near one."""
    fields = make_panels(unit_sphere(3), K=4)
    c = fields["xyz"]
    src = np.where(c[:, 0] > 0.8)[0]
    tgt = np.where(c[:, 0] < -0.5)[0][:12]
    assert len(src) >= 5 and len(tgt) == 12
    q = np.random.default_rng(23).standard_normal((len(src), 3))
    tk = tsb.StokesBEMKernel(K=4, mu=MU)
    centre, sigma, p = c[src].mean(0), 0.5, 12

    def side(idx, bc):
        f = {k: torch.as_tensor(np.asarray(v, np.float64)[idx])
             for k, v in fields.items() if k not in ("bc", "vertices")}
        f["bc"] = torch.full((len(idx),), float(bc), dtype=torch.float64)
        dn = torch.as_tensor((c[idx] - centre) / sigma)
        return f, dn, torch.full((len(idx),), 1.0 / sigma, dtype=torch.float64)

    for bc in (tsb.VELOCITY, tsb.TRACTION):
        sf, sdn, sis = side(src, bc)
        tf, tdn, tis = side(tgt, bc)
        M = tk.p2m(sf, torch.as_tensor(q), sdn, sis, p).sum(0)
        got = tk.m2p(tf, M[None].expand(len(tgt), -1, -1), tdn, tis, p)
        blocks = tsb.stokes_near_entries(
            fields, fields, np.repeat(tgt, len(src)), np.tile(src, len(tgt)), MU
        )[bc].reshape(len(tgt), len(src), 3, 3)
        # order-12 truncation; the wrong sign would give 2
        assert rel(got, np.einsum("tsij,sj->ti", blocks, q)) < 1e-3


# ----------------------------------------------------------------------
# the 3x3-block panel store and its two-stage product
# ----------------------------------------------------------------------


def test_block_panels_built_on_the_host_match(pair):
    """``build_near_panels`` with ``rdim = cdim = 3`` on random,
    unsymmetric blocks (a transposed block would show): the same arrays."""
    _, jp, tp = pair
    vals = np.random.default_rng(30).standard_normal((len(tp.near_rows), 3, 3))
    args = (tp.near_rows, tp.near_cols, vals)
    nl = len(tp.leaf_ids)
    for dtype in (np.float64, np.float32):  # numpy fill / native fill
        tm = tnp_mod.build_near_panels(
            tp.p2p_src_slot, tp.p2p_tgt_slot, *args, tp.src, tp.tgt, nl,
            dtype=dtype)
        jm = jnp_mod.build_near_panels(
            jp.p2p_src_slot, jp.p2p_tgt_slot, *args, jp.src, jp.tgt, nl,
            dtype=dtype)
        assert (tm.rdim, tm.cdim) == (3, 3)
        for name in META_FIELDS:
            assert getattr(tm, name) == getattr(jm, name), name
        assert tm.A.shape[1] == 3 * tp.leaf_pad and tm.A.shape[2] % 128 == 0
        np.testing.assert_array_equal(tm.A, jm.A)
        np.testing.assert_array_equal(tm.pidx, jm.pidx)
        np.testing.assert_array_equal(tm.chunk_tgt, jm.chunk_tgt)


@pytest.mark.parametrize("flipped", [False, True])
def test_plan_store_and_two_stage_product(pair, flipped):
    _, jp, tp = pair
    jdev, jmeta = jp.near_panels(jp._flipped_fields()[1] if flipped else None)
    tdev, tmeta = tp.near_panels(tp._flipped_fields() if flipped else None)
    for name in ("A", "pidx", "chunk_tgt"):
        np.testing.assert_array_equal(tdev[name].numpy(), np.asarray(jdev[name]))
    nl, KSc = len(tp.leaf_ids), 3 * tp.leaf_pad
    # dummy charge tiles and pad columns are present in this store
    assert (tdev["pidx"].numpy() == nl).any()
    assert tdev["A"].shape[2] > tmeta.m0 * KSc or (tdev["chunk_tgt"].numpy() == nl).any()
    ql = np.random.default_rng(31).standard_normal((nl, KSc))
    want = jnp_mod.panel_matvec(jdev, jmeta, jnp.asarray(ql), use_pallas=False)
    got = tnp_mod.panel_matvec_two_stage(tdev, tmeta, torch.as_tensor(ql))
    assert rel(got, want) <= TOL
    assert rel(tnp_mod.panel_matvec_reference(
        tdev, tmeta, torch.as_tensor(ql)), want) <= TOL
    again = tnp_mod.panel_matvec_two_stage(tdev, tmeta, torch.as_tensor(ql))
    assert torch.equal(got, again)


@pytest.mark.parametrize("m0", [2, 5])
def test_two_stage_product_with_dummy_chunks_and_empty_leaves(m0):
    """A hand-made store: leaves without chunks get zeros, dummy chunks
    (beyond the row pointer) and pad columns add nothing."""
    rng = np.random.default_rng(32 + m0)
    nl_t, nl_s, KT, KS = 6, 5, 4, 8
    KTr, KSc = 3 * KT, 3 * KS
    chunk_tgt = np.array([0, 0, 2, 3, 3, 3, 5, 6, 6], np.int32)  # 6 = dummy
    C = len(chunk_tgt)
    pidx = rng.integers(0, nl_s + 1, (C, m0)).astype(np.int32)
    pidx[chunk_tgt == nl_t] = nl_s
    Lb = -(-m0 * KSc // 128) * 128
    assert Lb > m0 * KSc
    A = rng.standard_normal((C, KTr, Lb))
    A[:, :, m0 * KSc:] = 0.0
    A[chunk_tgt == nl_t] = 0.0
    meta = tnp_mod.NearPanels(
        A=A, pidx=pidx, chunk_tgt=chunk_tgt, nl_t=nl_t, m0=m0, block_rows=1,
        npairs=0, rdim=3, cdim=3, KT=KT, KS=KS)
    dev = meta.device(torch.float64, "cpu")
    ql = rng.standard_normal((nl_s, KSc))
    want = jnp_mod.panel_matvec(
        {k: jnp.asarray(v) for k, v in (("A", A), ("pidx", pidx),
                                        ("chunk_tgt", chunk_tgt))},
        meta, jnp.asarray(ql), use_pallas=False)
    got = tnp_mod.panel_matvec(dev, meta, torch.as_tensor(ql))
    assert got.shape == (nl_t, KTr)
    assert rel(got, want) <= TOL
    assert not got[1].any() and not got[4].any()


@pytest.mark.parametrize("shape,bl", [((8, 48, 384), 4), ((6, 192, 256), 2),
                                      ((5, 33, 128), 1)])
def test_plain_contraction_matches_interpreted_pallas_body(monkeypatch, shape, bl):
    """``panel_contract_reference`` against the body of the TPU kernel it
    stands for, run by the Pallas interpreter at f32 (the JAX package
    itself only reaches that kernel on a TPU)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(33)
    A = rng.standard_normal(shape).astype(np.float32)
    A[-1] = 0.0  # a dummy chunk
    x = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    x[-1] = 0.0
    want = np.asarray(jnp_mod._contract_pallas(jnp.asarray(A), jnp.asarray(x), bl))
    einsum = np.asarray(jnp_mod._contract_einsum(jnp.asarray(A), jnp.asarray(x)))
    before = tnp_mod.panel_contract.launches
    got = tnp_mod.panel_contract(torch.as_tensor(A), torch.as_tensor(x)).numpy()
    assert tnp_mod.panel_contract.launches == before  # no kernel on the CPU
    assert got.shape == want.shape == shape[:2]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - einsum).max() <= 1e-5 * scale
    assert not got[-1].any()


def test_panel_contract_rejects_other_devices():
    A = torch.zeros((2, 3, 128), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tnp_mod.panel_contract(A, torch.zeros((2, 128), device="meta"))


def test_route_by_entry_shape(pair, monkeypatch):
    """A Stokes store takes the two-stage route, a Laplace store the
    fused one, by the entry shape alone."""
    from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel

    _, _, tp = pair
    lp = T.FmmPlan(
        LaplaceBEMKernel(K=3), make_panels(unit_sphere(2), K=3),
        T.FMMConfig(ncrit=8, dtype="float64", max_p=4), device="cpu")
    calls = {"two_stage": 0, "fused": 0, "contract": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tnp_mod, "panel_matvec_two_stage",
                        counting("two_stage", tnp_mod.panel_matvec_two_stage))
    monkeypatch.setattr(tnp_mod, "panel_matvec_fused",
                        counting("fused", tnp_mod.panel_matvec_fused))
    monkeypatch.setattr(tnp_mod, "panel_contract",
                        counting("contract", tnp_mod.panel_contract))
    for plan, want in ((tp, "two_stage"), (lp, "fused")):
        dev, meta = plan.near_panels()
        assert tnp_mod.near_route(meta) == want
        cdim = plan.kernel.charge_dim
        ql = torch.ones((len(plan.leaf_ids), plan.leaf_pad * cdim),
                        dtype=torch.float64)
        before = dict(calls)
        tnp_mod.panel_matvec(dev, meta, ql)
        other = "fused" if want == "two_stage" else "two_stage"
        assert calls[want] == before[want] + 1 and calls[other] == before[other]
    assert calls["contract"] == 1
    # the whole matvec of the Stokes plan goes the same way
    n = tp.src.tree.num_bodies
    tp.apply(np.ones((n, 3)), p=3)
    assert calls == {"two_stage": 2, "fused": 1, "contract": 2}


# ----------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------


@pytest.mark.parametrize("flipped", [False, True])
def test_apply_matches_jax(pair, flipped):
    fields, jp, tp = pair
    n = len(fields["xyz"])
    q = np.random.default_rng(40).standard_normal((n, 3))
    if flipped:
        want, got = jp.apply_flipped_bc(q, p=10), tp.apply_flipped_bc(q, p=10)
    else:
        want, got = jp.apply(q, p=10), tp.apply(q, p=10)
    assert got.shape == (n, 3)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("flipped", [False, True])
def test_matvec_matches_dense_matrix(pair, flipped):
    """Within the bar the JAX package's own Stokes test accepts."""
    fields, _, tp = pair
    n = len(fields["xyz"])
    q = np.random.default_rng(0).standard_normal((n, 3))
    if flipped:
        A = tp.kernel.dense_matrix(switch_bc(fields))
        got = tp.apply_flipped_bc(q, p=10)
    else:
        A = tp.kernel.dense_matrix(fields)
        got = tp.apply(q, p=10)
    assert rel(got.reshape(-1), A @ q.reshape(-1)) < 5e-4


def _far_field_pair():
    """512 panels in a three-level tree: M2L families and residual tiles
    carry part of the product (the shared 128-panel plan is all near
    field at p=10)."""
    fields = make_panels(unit_sphere(4), K=4)
    jp = J.FmmPlan(
        jsb.StokesBEMKernel(K=4, mu=MU), fields,
        J.FMMConfig(ncrit=32, dtype="float64", max_p=6))
    tp = T.FmmPlan(
        tsb.StokesBEMKernel(K=4, mu=MU), fields,
        T.FMMConfig(ncrit=32, dtype="float64", max_p=6), device="cpu")
    return fields, jp, tp


@pytest.fixture(scope="module")
def far_pair():
    return _far_field_pair()


@pytest.mark.parametrize("tables", ["carried", "own"])
@pytest.mark.parametrize("flipped", [False, True])
def test_matvec_slots_matches_jax(far_pair, flipped, tables, monkeypatch):
    """The slot matvec with a far field, on the port's own tables and on
    the reference plan's tables carried across as numpy.  The far field
    at traction targets is held to the reference with the reference's
    sign put in; the port's own sign is held to the dense matrix in
    ``test_flipped_matvec_with_a_far_field``."""
    fields, jp, tp = far_pair
    monkeypatch.setattr(tp.kernel, "traction_far_scale", 0.5)
    assert tp.tree.num_levels >= 3 and len(tp.lists.m2l_pairs) > 0
    n, p = len(fields["xyz"]), 5
    q = np.random.default_rng(41).standard_normal(3 * n)
    jmv, jop, jto, _, jn = jp.solver_ops_slots(flipped=flipped)
    qs = np.asarray(jto(jnp.asarray(q)))
    want = np.asarray(jmv(jop(p), jnp.asarray(qs), p))
    mv, op4p, to_s, from_s, nslots = tp.solver_ops_slots(flipped=flipped)
    assert nslots == jn == len(qs) == 3 * len(tp.leaf_ids) * tp.leaf_pad
    np.testing.assert_array_equal(to_s(q).numpy(), qs)
    np.testing.assert_array_equal(to_s(q.reshape(n, 3)).numpy(), qs)
    if tables == "own":
        operand = op4p(p)
    else:
        fh = jp._flipped_fields()[0] if flipped else None
        aux = dict(jp.variant_aux_slots(p, src_host=fh, tgt_host=fh))
        panels = aux.pop("panels")
        assert aux["p2m_tab_t"].shape[0] == 3 and "l2p_tab_t" not in aux
        assert {"t_fields_t", "t_dn_t", "t_isig_t"} <= set(aux)
        operand = operand_from_numpy(
            to_numpy(jp.device_data(p)), to_numpy(aux), to_numpy(panels),
            {k: getattr(jp._near_meta, k) for k in META_FIELDS},
            device="cpu", dtype=torch.float64,
            fields={k: np.asarray(v)
                    for k, v in (fh or jp.src.fields).items()},
        )
        assert (operand[1]["near_meta"].rdim, operand[1]["near_meta"].cdim) == (3, 3)
    got = mv(operand, torch.tensor(qs), p)
    assert got.shape == (nslots,)
    assert rel(got, want) <= TOL
    # padded slots stay exactly zero
    mask = np.repeat(tp.src.leaf_body_mask.reshape(-1), 3)
    assert not got.numpy()[~mask].any()
    assert from_s(got).shape == (3 * n,)


def test_solve_plan_matches_jax(pair):
    """Uniform flow past the unit sphere: the relaxed solve takes the
    reference's iterations and orders (none below the floor of 5), ends
    at its solution, and the drag meets Stokes' law as in the JAX
    package's own test."""
    fields, jp, tp = pair
    n = len(fields["xyz"])
    b = np.tile([4 * np.pi, 0.0, 0.0], (n, 1)).reshape(-1)
    kw = dict(residual=1e-5, max_iters=100, restart=100, max_p=10, p_min=5,
              p_tiers=T.config.default_p_tiers(10))
    xj, ij, jmode = j_solve_plan(jp, b, J.SolverConfig(**kw), prefer_device=True)
    xt, it, mode = solve_plan(tp, b, T.SolverConfig(**kw), device="cpu")
    assert mode == jmode == "device-slots"
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations
    sched = [h[2] for h in it.history]
    assert sched == [h[2] for h in ij.history]
    assert min(sched) >= 5
    assert xt.shape == (3 * n,)
    assert np.abs(xt - np.asarray(xj)).max() <= 1e-9 * np.abs(xj).max()
    fx = float((xt.reshape(n, 3)[:, 0] * fields["area"]).sum())
    exact = 6 * np.pi * MU
    assert abs(fx - exact) / exact < 5e-2


def test_rhs_sanity(pair):
    """Double-layer identity: the traction operator on a uniform velocity
    gives 4 pi u on the sphere."""
    fields, _, tp = pair
    n = len(fields["xyz"])
    u = np.tile([1.0, 0.0, 0.0], (n, 1))
    b = tp.apply_flipped_bc(u, p=10).numpy()
    assert np.abs(b[:, 0] - 4 * np.pi).mean() / (4 * np.pi) < 5e-2
    assert np.abs(b[:, 1:]).max() < 0.5


def test_flipped_matvec_with_a_far_field(far_pair):
    """Both BC variants on the 512-panel tree, where M2L carries part of
    the product: against the dense matrix within the order-6 truncation,
    and the double-layer identity on a uniform velocity."""
    fields, _, tp = far_pair
    n = len(fields["xyz"])
    q = np.random.default_rng(0).standard_normal((n, 3))
    A = tp.kernel.dense_matrix(fields)
    assert rel(tp.apply(q, p=6).reshape(-1), A @ q.reshape(-1)) < 2e-3
    Af = tp.kernel.dense_matrix(switch_bc(fields))
    assert rel(tp.apply_flipped_bc(q, p=6).reshape(-1), Af @ q.reshape(-1)) < 2e-3
    u = np.tile([1.0, 0.0, 0.0], (n, 1))
    b = tp.apply_flipped_bc(u, p=6).numpy()
    assert np.abs(b[:, 0] - 4 * np.pi).mean() / (4 * np.pi) < 5e-3
    assert np.abs(b[:, 1:]).max() < 5e-2


def test_calibrate_eps_matches_jax(far_pair):
    _, jp, tp = far_pair
    c_j, g_j = jp.calibrate_eps(seed=3)
    c_t, g_t = tp.calibrate_eps(seed=3)
    assert sorted(tp.eps_samples) == sorted(jp.eps_samples)
    np.testing.assert_allclose([c_t, g_t], [c_j, g_j], rtol=1e-6)


def test_point_stokeslet_through_the_plan():
    """``FmmPlan(StokesKernel())``: vector charges through the generic
    ``p2p_block`` route, against the reference plan and direct summation
    (the bar of the JAX package's own test)."""
    rng = np.random.default_rng(5)
    n = 2000
    pts = rng.uniform(0, 1, (n, 3))
    q = rng.standard_normal((n, 3))
    cfg = dict(ncrit=32, dtype="float64", max_p=10)
    jplan = J.FmmPlan(jst.StokesKernel(), {"xyz": pts}, J.FMMConfig(**cfg))
    tplan = T.FmmPlan(tst.StokesKernel(), {"xyz": pts}, T.FMMConfig(**cfg),
                      device="cpu")
    assert tplan._p2p_rows is None  # not the Laplace tile kernel
    got = tplan.apply(q, p=10)
    assert got.shape == (n, 3)
    assert rel(got, jplan.apply(q, p=10)) <= TOL
    exact = tplan.kernel.direct(
        torch.as_tensor(pts), torch.as_tensor(pts), torch.as_tensor(q))
    assert rel(got, exact) < 5e-4
    assert tplan.solver_ops_slots() is not None  # a square operator


@pytest.mark.parametrize("which", ["stokes_bem", "stokeslet", "stresslet"])
def test_check_supported(which):
    if which == "stokes_bem":
        T.FmmPlan(
            tsb.StokesBEMKernel(), make_panels(unit_sphere(1), K=4),
            T.FMMConfig(ncrit=8, dtype="float64", max_p=3), device="cpu")
        return
    pts = np.random.default_rng(6).uniform(0, 1, (80, 3))
    cfg = T.FMMConfig(ncrit=16, dtype="float64", max_p=3)
    if which == "stokeslet":
        T.FmmPlan(tst.StokesKernel(), {"xyz": pts}, cfg, device="cpu")
    else:
        # once a refusal: the stresslet builds and runs, see
        # test_stresslet_through_the_plan
        plan = T.FmmPlan(tst.StressletKernel(), {"xyz": pts}, cfg,
                         device="cpu")
        assert "p2m_tab" not in plan.variant_aux(3)
        assert plan.solver_ops_slots() is None  # 6 charges, 3 results


def test_stresslet_through_the_plan():
    """``FmmPlan(StressletKernel())``: no linear P2M table (the kernel's
    own ``p2m`` runs per matvec on the slot-gathered fields), 6-vector
    charges and 3-vector results; against the JAX plan (1e-12), direct
    summation (5e-4, the bar of the JAX package's own test) and its own
    body-order matvec (1e-12)."""
    rng = np.random.default_rng(5)
    n = 1200
    pts = rng.uniform(0, 1, (n, 3))
    q = rng.standard_normal((n, 6))
    cfg = dict(ncrit=32, dtype="float64", max_p=10)
    jplan = J.FmmPlan(jst.StressletKernel(), {"xyz": pts},
                      J.FMMConfig(**cfg))
    tplan = T.FmmPlan(tst.StressletKernel(), {"xyz": pts},
                      T.FMMConfig(**cfg), device="cpu")
    got = tplan.apply(q, p=10)
    assert got.shape == (n, 3)
    assert rel(got, jplan.apply(q, p=10)) <= TOL
    exact = tplan.kernel.direct(
        torch.as_tensor(pts), torch.as_tensor(pts), torch.as_tensor(q))
    assert rel(got, exact) < 5e-4
    assert rel(tplan.apply_body_order(q, p=10), got) <= TOL


@pytest.mark.parametrize("near_panel", [True, False],
                         ids=["slot_route", "coo_body_order"])
def test_nonlinear_p2m_instance(near_panel):
    """A Laplace BEM kernel instance with ``linear_p2m = False`` (as in
    the JAX package's tests/test_ops.py): no P2M table, the kernel's own
    ``p2m`` per matvec — in the slot route (cached panels) and in body
    order (the COO replay) — gives the table plan's matvec (1e-11) and
    the JAX plan's (1e-12)."""
    from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JLB
    from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TLB

    fields = make_panels(unit_sphere(3), K=3)
    q = np.random.default_rng(3).standard_normal(len(fields["xyz"]))
    cfg = dict(ncrit=8, dtype="float64", max_p=6)  # a tree with M2L pairs
    table = T.FmmPlan(TLB(K=3), fields, T.FMMConfig(**cfg), device="cpu")
    assert len(table.lists.m2l_pairs) > 0
    tk, jk = TLB(K=3), JLB(K=3)
    tk.linear_p2m = jk.linear_p2m = False
    cfg["near_panel"] = near_panel
    tp = T.FmmPlan(tk, fields, T.FMMConfig(**cfg), device="cpu")
    jp = J.FmmPlan(jk, fields, J.FMMConfig(**cfg))
    assert "p2m_tab" not in tp.variant_aux(5)
    assert tp.has_slot_route == near_panel
    got = tp.apply(q, p=5)
    assert (got - table.apply(q, p=5)).abs().max() <= 1e-11
    assert rel(got, jp.apply(q, p=5)) <= TOL
