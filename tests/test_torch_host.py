"""Host side of the PyTorch port against the JAX package: the trees,
interaction lists, M2L classes / families / tiles and near-field entries
of the two plans, built from the same panels, are the same arrays —
integers exactly, floats to 1e-14 (the port's host modules are copies of
the numpy code); the numpy parts of the Yukawa kernels (index tables,
recurrences, Bessel series, translation matrices) are the same arrays
bit for bit.  Also: importing the port pulls in neither jax nor the
JAX package (at run time, and in the text of every source file), and
what earlier slices refused at plan build now builds and matches the
JAX plan."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels import cartesian as j_ct
from fmm_bem_tpu.kernels import spherical_yukawa as j_sy
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu.ops import otf_tile as j_otf
from fmm_bem_tpu_torch.config import Evaluator
from fmm_bem_tpu_torch.kernels import cartesian as t_ct
from fmm_bem_tpu_torch.kernels import spherical_yukawa as t_sy
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel
from fmm_bem_tpu_torch.kernels.unit import UnitKernel as TUnit
from fmm_bem_tpu_torch.ops import otf_tile as t_otf
from fmm_bem_tpu_torch.ops import p2p_tile as t_p2p

#: (sphere recursion, ncrit): both trees have three levels, M2L families
#: and residual tiles
CASES = {"rec3": (3, 8), "rec4": (4, 32)}


@pytest.fixture(scope="module", params=sorted(CASES))
def plans(request):
    rec, ncrit = CASES[request.param]
    fields = make_panels(unit_sphere(rec), K=3)
    jp = J.FmmPlan(
        JKernel(K=3), fields,
        J.FMMConfig(ncrit=ncrit, dtype="float64", max_p=6),
    )
    tp = T.FmmPlan(
        TKernel(K=3), fields,
        T.FMMConfig(ncrit=ncrit, dtype="float64", max_p=6), device="cpu",
    )
    return jp, tp


def same(a, b, name=""):
    """Integers (and bools) exactly, floats to 1e-14."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-14, err_msg=name)
    else:
        assert a.dtype == b.dtype, f"{name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(b, a, err_msg=name)


def same_fields(ja, ta, skip=()):
    """Every array / scalar / list-of-arrays field of two dataclasses."""
    names = [f.name for f in dataclasses.fields(ta) if f.name not in skip]
    assert names
    for name in names:
        jv, tv = getattr(ja, name), getattr(ta, name)
        if isinstance(tv, (list, tuple)):
            assert len(jv) == len(tv), name
            for k, (x, y) in enumerate(zip(jv, tv)):
                same(x, y, f"{name}[{k}]")
        else:
            same(jv, tv, name)


def test_tree_arrays(plans):
    jp, tp = plans
    same_fields(jp.src.tree, tp.src.tree)
    assert tp.src.tree.num_levels >= 3


def test_interaction_lists(plans):
    jp, tp = plans
    same_fields(jp.lists, tp.lists)
    assert len(tp.lists.m2l_pairs) and len(tp.lists.p2p_pairs)


def test_tree_side(plans):
    jp, tp = plans
    same_fields(jp.src, tp.src, skip=("tree", "fields", "levels"))
    assert len(jp.src.levels) == len(tp.src.levels)
    for jl, tl in zip(jp.src.levels, tp.src.levels):
        for je, te in zip(jl, tl):
            assert (je is None) == (te is None)
            if je is not None:
                same(je[0], te[0]), same(je[1], te[1])
                assert je[2] == te[2]
    for k in tp.src.fields:
        same(jp.src.fields[k], tp.src.fields[k], k)


def test_m2l_classes(plans):
    jp, tp = plans
    same_fields(jp.m2l_classes, tp.m2l_classes)
    assert len(tp.m2l_classes.src) > 0


def test_m2l_families(plans):
    jp, tp = plans
    assert tp.m2l_fam is not None
    same_fields(jp.m2l_fam, tp.m2l_fam, skip=("bsum",))
    same_fields(jp.m2l_fam.bsum, tp.m2l_fam.bsum)
    for p in (3, 6):
        same(jp._slice_fam_mats(p), tp._slice_fam_mats(p))


def test_m2l_tiles(plans):
    jp, tp = plans
    assert len(tp.m2l_tile_src) > 0
    for name in ("m2l_tile_src", "m2l_tile_tgt", "m2l_tile_cls",
                 "m2l_tile_size", "m2l_tile_group", "m2p_src",
                 "m2p_tgt_slot", "m2p_inv_sigma"):
        same(getattr(jp, name), getattr(tp, name), name)
    same_fields(jp.m2l_bsum, tp.m2l_bsum)


def test_near_entries(plans):
    jp, tp = plans
    assert len(tp.near_rows) > 0
    for name in ("p2p_src_slot", "p2p_tgt_slot", "near_rows", "near_cols",
                 "near_vals"):
        same(getattr(jp, name), getattr(tp, name), name)


@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_near_regular_entries(plans, kappa):
    """The host K-point rule the OTF deltas are taken against."""
    jp, tp = plans
    jk, tk = JKernel(K=3), TKernel(K=3)
    jk.kappa = tk.kappa = kappa
    rows, cols = tp.near_rows, tp.near_cols
    want = jk.near_regular_entries(jp.tgt.fields, jp.src.fields, rows, cols)
    got = tk.near_regular_entries(tp.tgt.fields, tp.src.fields, rows, cols)
    assert got.shape == (len(rows), 2)
    same(want, got, "near_regular_entries")


def test_otf_packers(plans):
    """The packed leaf tiles of the on-the-fly near product, at the JAX
    package's f32 and, for the f64 tests, at f64."""
    jp, tp = plans
    side = tp.src
    idx, mask = side.leaf_body_idx, side.leaf_body_mask
    tiled = {
        k: np.asarray(side.fields[k])[idx]
        for k in ("xyz", "qp_off", "qw", "area", "normal")
    }
    bc = np.asarray(side.fields["bc"])[idx]
    assert j_otf.SENTINEL == t_otf.SENTINEL == t_p2p.SENTINEL
    src32 = t_otf.pack_otf_src(tiled, mask, 3)
    tgt32 = t_otf.pack_otf_tgt(tiled["xyz"], bc, mask)
    same(j_otf.pack_otf_src(tiled, mask, 3), src32, "pack_otf_src")
    same(j_otf.pack_otf_tgt(tiled["xyz"], bc, mask), tgt32, "pack_otf_tgt")
    assert src32.shape == (len(idx) + 1, 15, side.leaf_pad)
    src64 = t_otf.pack_otf_src(tiled, mask, 3, np.float64)
    tgt64 = t_otf.pack_otf_tgt(tiled["xyz"], bc, mask, np.float64)
    assert src64.dtype == tgt64.dtype == np.float64
    np.testing.assert_array_equal(src64.astype(np.float32), src32)
    np.testing.assert_array_equal(tgt64.astype(np.float32), tgt32)
    # padded panels and the closing dummy tile: at the sentinel, with
    # zero weight
    pad = np.concatenate([~mask, np.ones((1, side.leaf_pad), bool)])
    pts = src64[:, :9].transpose(0, 2, 1)[pad]
    wts = src64[:, 9:12].transpose(0, 2, 1)[pad]
    assert (pts == t_otf.SENTINEL).all() and (wts == 0).all()
    assert (tgt64[:, :3].transpose(0, 2, 1)[pad] == t_otf.SENTINEL).all()


def test_sorted_pair_rows(plans):
    """The target-sorted pair list of the leaf-tile kernels is the pair
    order of the JAX package's super-block construction (``np.lexsort`` by
    target then source), with a row pointer in place of its chunks."""
    jp, tp = plans
    nl = len(tp.leaf_ids)
    src_sorted, row_ptr = t_p2p.sorted_pair_rows(
        tp.p2p_src_slot, tp.p2p_tgt_slot, nl)
    order = np.lexsort((jp.p2p_src_slot, jp.p2p_tgt_slot))
    np.testing.assert_array_equal(src_sorted, jp.p2p_src_slot[order])
    assert src_sorted.dtype == row_ptr.dtype == np.int32
    ts = jp.p2p_tgt_slot[order]
    for leaf in (0, nl // 2, nl - 1):
        assert (ts[row_ptr[leaf]:row_ptr[leaf + 1]] == leaf).all()
    assert row_ptr[0] == 0 and row_ptr[-1] == len(order)


@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_cartesian_host_copies(kappa, p):
    """Index tables, factorials, the numpy recurrences and the three
    host translation matrices of ``kernels/cartesian.py``."""
    for a, b in zip(j_ct.index_set(p), t_ct.index_set(p)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j_ct._factorial_prod(p),
                                  t_ct._factorial_prod(p))
    assert j_ct.num_terms(p) == t_ct.num_terms(p)
    rng = np.random.default_rng(5)
    dX = rng.uniform(-1, 1, (50, 3)) + np.array([0.0, 2.0, 0.0])
    np.testing.assert_array_equal(j_ct.eval_coeffs_np(dX, kappa, p),
                                  t_ct.eval_coeffs_np(dX, kappa, p))
    np.testing.assert_array_equal(j_ct.powers_np(dX, p), t_ct.powers_np(dX, p))
    jk, tk = j_ct.YukawaKernel(kappa), t_ct.YukawaKernel(kappa)
    dr = np.array([0.25, -0.25, 0.25])
    far = np.array([1.0, 0.5, -1.5])
    for name, args in (("m2m_matrix", (dr, 0.25, 0.5)),
                       ("m2l_matrix", (far, 0.25, 0.25)),
                       ("l2l_matrix", (-dr, 0.5, 0.25))):
        np.testing.assert_array_equal(getattr(jk, name)(*args, p),
                                      getattr(tk, name)(*args, p))


@pytest.mark.parametrize("p", [4, 8])
def test_spherical_yukawa_host_copies(p):
    """The Bessel series and polynomials, the fit sphere, the folded
    basis and the projection-built translation matrices of
    ``kernels/spherical_yukawa.py``."""
    x = np.array([0.01, 0.3, 1.7, 6.0])
    for fn in ("bessel_i", "bessel_k"):
        np.testing.assert_array_equal(getattr(j_sy, fn)(x, p),
                                      getattr(t_sy, fn)(x, p))
    np.testing.assert_array_equal(j_sy._series_coeffs(p),
                                  t_sy._series_coeffs(p))
    np.testing.assert_array_equal(j_sy._kn_poly(p), t_sy._kn_poly(p))
    for a, b in zip(j_sy._sphere_points(p), t_sy._sphere_points(p)):
        np.testing.assert_array_equal(a, b)
    dirs = j_sy._sphere_points(p)[0]
    np.testing.assert_array_equal(j_sy._angular_flat(dirs, p),
                                  t_sy._angular_flat(dirs, p))
    # complex slot values [Q, T] at T = p(p+1)/2 terms
    vals = np.exp(1j * np.arange(3.0 * p * (p + 1) // 2)).reshape(3, -1)
    np.testing.assert_array_equal(j_sy._fold_real(vals, p),
                                  t_sy._fold_real(vals, p))
    jk = j_sy.YukawaSphericalKernel(0.5)
    tk = t_sy.YukawaSphericalKernel(0.5)
    dr = np.array([0.25, -0.25, 0.25])
    far = np.array([1.0, 0.5, -1.5])
    for name, args in (("m2m_matrix", (dr, 0.25, 0.5)),
                       ("m2l_matrix", (far, 0.25, 0.25)),
                       ("l2l_matrix", (-dr, 0.5, 0.25))):
        np.testing.assert_array_equal(getattr(jk, name)(*args, p),
                                      getattr(tk, name)(*args, p))


PORT_SOURCES = sorted(
    str(p.relative_to(pathlib.Path(T.__file__).parents[1]))
    for p in [
        *pathlib.Path(T.__file__).parent.rglob("*.py"),
        pathlib.Path(T.__file__).parents[1] / "chip_smoke.py",
        pathlib.Path(T.__file__).parents[1] / "near_panel_ab.py",
    ]
)


@pytest.mark.parametrize("source", PORT_SOURCES)
def test_source_imports_no_jax_and_no_triton_at_module_level(source):
    """Every file of the port, ``chip_smoke.py`` and ``near_panel_ab.py``:
    no import of jax or of the JAX package anywhere, and no import of
    triton outside a function (there is none on a machine without a
    GPU)."""
    path = pathlib.Path(T.__file__).parents[1] / source
    tree = ast.parse(path.read_text(), filename=source)

    def roots(node):
        if isinstance(node, ast.Import):
            return [a.name.split(".")[0] for a in node.names]
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            return [(node.module or "").split(".")[0]]
        return []

    everywhere = {r for n in ast.walk(tree) for r in roots(n)}
    assert not everywhere & {"jax", "jaxlib", "fmm_bem_tpu"}, source
    top = {r for n in tree.body for r in roots(n)}
    assert "triton" not in top, source


def test_port_sources_were_found():
    assert len(PORT_SOURCES) > 25 and "chip_smoke.py" in PORT_SOURCES
    assert "near_panel_ab.py" in PORT_SOURCES
    for name in ("cartesian", "yukawa_bem", "spherical_yukawa"):
        assert f"fmm_bem_tpu_torch/kernels/{name}.py" in PORT_SOURCES


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fmm_bem_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'fmm_bem_tpu' or "
        "m.startswith('fmm_bem_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def _vector_results(base):
    """A BEM kernel with 3-vector results and scalar charges (result
    component c is c+1 times ``base``'s scalar result), for both
    packages: the far-field evaluations and the COO replay are
    ``base``'s, widened."""
    scale = np.array([1.0, 2.0, 3.0])

    class VectorBEM(base):
        result_dim = 3

        def l2p_table(self, fields, d_norm, inv_sigma, p):
            t = super().l2p_table(fields, d_norm, inv_sigma, p)
            return t * _like(t, scale)

        def l2p(self, fields, L, d_norm, inv_sigma, p):
            return super().l2p(fields, L, d_norm, inv_sigma, p) * _like(
                L, scale)

        def m2p(self, fields, M, d_norm, inv_sigma, p):
            return super().m2p(fields, M, d_norm, inv_sigma, p) * _like(
                M, scale)

        def near_matvec(self, vals, rows, cols, fields, qm, n):
            return super().near_matvec(vals, rows, cols, fields, qm, n) * (
                _like(qm, scale))

    return VectorBEM


def _like(x, a):
    """``a`` as an array of ``x``'s package, device and dtype."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)
    import jax.numpy as jnp

    return jnp.asarray(a, x.dtype)


def _nonlinear_p2m(base):
    class NonLinearP2M(base):
        linear_p2m = False

    return NonLinearP2M


@pytest.mark.parametrize(
    "what,kwargs",
    [
        # the ids these cases were reported under while they were
        # refusals; each now builds and matches the JAX plan
        pytest.param("target_fields", {"target_fields": True},
                     id="target_fields-kwargs0"),
        pytest.param("near_panel=False", {"config": {"near_panel": False}},
                     id="near_panel=False-kwargs4"),
        pytest.param("vector-valued", {"kernel": _vector_results,
                                       "config": {"near_panel": False}},
                     id="vector-valued-kwargs5"),
        pytest.param("linear P2M", {"kernel": _nonlinear_p2m},
                     id="linear P2M-kwargs6"),
    ],
)
def test_unported_features_raise_at_plan_build(what, kwargs):
    """What these cases refused before the port covered them (a dual
    plan, the COO replay, a BEM kernel whose result and charge
    dimensions differ, a kernel without a linear P2M table) builds, and
    its ``apply`` and ``apply_flipped_bc`` are the JAX plan's (a
    128-panel sphere at ncrit 8: M2L pairs beside the near field)."""
    fields = make_panels(unit_sphere(3), K=3)
    cfg = dict(ncrit=8, dtype="float64", max_p=4, **kwargs.get("config", {}))
    wrap = kwargs.get("kernel", lambda k: k)
    tfields = fields if "target_fields" in kwargs else None
    jp = J.FmmPlan(wrap(JKernel)(K=3), fields, J.FMMConfig(**cfg),
                   target_fields=tfields)
    tp = T.FmmPlan(wrap(TKernel)(K=3), fields, T.FMMConfig(**cfg),
                   target_fields=tfields, device="cpu")
    q = np.random.default_rng(9).standard_normal(len(fields["xyz"]))
    for fn in ("apply", "apply_flipped_bc"):
        want = np.asarray(getattr(jp, fn)(q, p=3))
        got = getattr(tp, fn)(q, p=3).numpy()
        assert got.shape == want.shape, what
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), what
    if what == "target_fields":
        # the same panels as targets: the single-tree operator
        single = T.FmmPlan(TKernel(K=3), fields, T.FMMConfig(**cfg),
                           device="cpu")
        want = single.apply(q, p=3)
        got = tp.apply(q, p=3)
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    elif what == "vector-valued":
        got = tp.apply(q, p=3).numpy()
        np.testing.assert_allclose(got[:, 1], 2.0 * got[:, 0], rtol=1e-15)
    elif what == "linear P2M":
        assert "p2m_tab" not in tp.variant_aux(3)
        assert "s_fields_t" in tp.variant_aux_slots(3)


@pytest.mark.parametrize(
    "what,kwargs",
    [
        # the ids these cases had as refusals, before the port covered them
        pytest.param("local_evaluation",
                     {"config": {"local_evaluation": True}},
                     id="local_evaluation-kwargs2"),
        pytest.param("block_diagonal", {"config": {"block_diagonal": True}},
                     id="block_diagonal-kwargs3"),
    ],
)
def test_near_only_plans_build_and_match(what, kwargs):
    """What the refusal cases above asked for: the near-field-only
    operators build, and their ``apply`` is the JAX plan's."""
    fields = make_panels(unit_sphere(2), K=3)
    cfg = dict(ncrit=8, dtype="float64", max_p=4, **kwargs["config"])
    jp = J.FmmPlan(JKernel(K=3), fields, J.FMMConfig(**cfg))
    tp = T.FmmPlan(TKernel(K=3), fields, T.FMMConfig(**cfg), device="cpu")
    assert tp.near_only
    same(tp.p2p_src_slot, jp.p2p_src_slot, "p2p_src_slot")
    same(tp.p2p_tgt_slot, jp.p2p_tgt_slot, "p2p_tgt_slot")
    q = np.random.default_rng(8).standard_normal(len(fields["xyz"]))
    for fn in ("apply", "apply_flipped_bc"):
        want = np.asarray(getattr(jp, fn)(q, p=3))
        got = getattr(tp, fn)(q, p=3).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize(
    "what", ["near_mode_otf", "point_kernel", "unit_kernel", "treecode"])
def test_ported_features_build(what):
    """What earlier slices refused: the on-the-fly near mode, kernels
    without ``near_sparse`` (point kernels) and the treecode
    evaluator."""
    fields = make_panels(unit_sphere(2), K=3)
    if what == "treecode":
        fields = make_panels(unit_sphere(3), K=3)  # far pairs at ncrit 8
        plan = T.FmmPlan(
            TKernel(K=3), fields,
            T.FMMConfig(ncrit=8, dtype="float64", max_p=4,
                        evaluator=Evaluator.TREECODE),
            device="cpu",
        )
        assert len(plan.lists.m2l_pairs) == 0 and len(plan.m2p_src) > 0
    elif what == "near_mode_otf":
        plan = T.FmmPlan(
            TKernel(K=3), fields,
            T.FMMConfig(ncrit=8, dtype="float64", max_p=4, near_mode="otf"),
            device="cpu",
        )
        assert plan._otf_near and plan.near_panels()[1] is None
    else:
        kern = TLaplace() if what == "point_kernel" else TUnit()
        plan = T.FmmPlan(
            kern, {"xyz": fields["xyz"]},
            T.FMMConfig(ncrit=8, dtype="float64", max_p=4), device="cpu",
        )
        assert plan.near_rows is None and plan.near_panels() == (None, None)
        assert (plan._p2p_rows is not None) == (what == "point_kernel")
    out = plan.apply(np.ones(len(fields["xyz"])), p=3)
    assert out.shape == (len(fields["xyz"]), plan.kernel.result_dim)
    assert bool(torch.isfinite(out).all())


def test_unknown_near_mode_is_refused():
    fields = make_panels(unit_sphere(2), K=3)
    with pytest.raises(ValueError, match="near_mode"):
        T.FmmPlan(
            TKernel(K=3), fields,
            T.FMMConfig(ncrit=8, max_p=4, near_mode="lazy"), device="cpu",
        )


def test_cuda_is_the_default_device_and_does_not_fall_back():
    fields = make_panels(unit_sphere(2), K=3)
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        T.FmmPlan(TKernel(K=3), fields, T.FMMConfig(ncrit=8, max_p=4))
