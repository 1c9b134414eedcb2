"""Host side of the PyTorch port against the JAX package: the trees,
interaction lists, M2L classes / families / tiles and near-field entries
of the two plans, built from the same panels, are the same arrays —
integers exactly, floats to 1e-14 (the port's host modules are copies of
the numpy code).  Also: importing the port pulls in neither jax nor the
JAX package, and what this slice does not cover raises at plan build."""

import dataclasses
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
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu_torch.config import Evaluator
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel

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


class _PointKernel(TKernel):
    near_sparse = False

    def p2p_block(self, *a):
        raise AssertionError("never reached")


@pytest.mark.parametrize(
    "what,kwargs",
    [
        ("target_fields", {"target_fields": True}),
        ("TREECODE", {"config": {"evaluator": Evaluator.TREECODE}}),
        ("near_mode", {"config": {"near_mode": "otf"}}),
        ("local_evaluation", {"config": {"local_evaluation": True}}),
        ("block_diagonal", {"config": {"block_diagonal": True}}),
        ("near_sparse", {"kernel": _PointKernel(K=3)}),
    ],
)
def test_unported_features_raise_at_plan_build(what, kwargs):
    fields = make_panels(unit_sphere(2), K=3)
    cfg = T.FMMConfig(
        ncrit=8, dtype="float64", max_p=4, **kwargs.get("config", {})
    )
    with pytest.raises(NotImplementedError, match=what):
        T.FmmPlan(
            kwargs.get("kernel", TKernel(K=3)), fields, cfg,
            target_fields=fields if "target_fields" in kwargs else None,
            device="cpu",
        )


def test_cuda_is_the_default_device_and_does_not_fall_back():
    fields = make_panels(unit_sphere(2), K=3)
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        T.FmmPlan(TKernel(K=3), fields, T.FMMConfig(ncrit=8, max_p=4))
