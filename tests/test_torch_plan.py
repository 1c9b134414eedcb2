"""The slot-space FMM matvec of the PyTorch port against the JAX package's,
on the CPU at f64.  The same charges, made with numpy from a seed, go
through ``plan.solver_ops_slots()`` of both plans: once with the port's
matvec running on the JAX plan's own tables, carried across as numpy by
``operand_from_numpy``, and once on the tables the port built itself.
Tolerance 1e-12 relative: the two sides take their sums in another
order."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel
from fmm_bem_tpu_torch.utils.convert import operand_from_numpy

TOL = 1e-12
META_FIELDS = ("nl_t", "m0", "block_rows", "npairs", "rdim", "cdim", "KT", "KS")


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_numpy(tree):
    """A JAX pytree (dicts, lists, tuples, None) as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def two_spheres():
    """A unit sphere beside a sphere fifty times smaller: the adaptive
    tree gets level-skewed pairs, which the matvec serves by M2P."""
    small = unit_sphere(4) * 0.02 + np.array([1.3, 0.0, 0.0])
    return np.concatenate([unit_sphere(3), small])


class Pair:
    """One mesh, planned by both packages, with the JAX results cached."""

    def __init__(self, tris, ncrit, max_p):
        self.fields = make_panels(tris, K=3)
        self.n = len(tris)
        self.jp = J.FmmPlan(
            JKernel(K=3), self.fields,
            J.FMMConfig(ncrit=ncrit, dtype="float64", max_p=max_p),
        )
        self.tp = T.FmmPlan(
            TKernel(K=3), self.fields,
            T.FMMConfig(ncrit=ncrit, dtype="float64", max_p=max_p),
            device="cpu",
        )
        self.q = np.random.default_rng(7).standard_normal(self.n)
        self._want = {}

    def jax_slots(self, p, flipped):
        """(q_slot, A @ q_slot) of the JAX plan, as numpy."""
        key = (p, flipped)
        if key not in self._want:
            mv, op4p, to_s, _, _ = self.jp.solver_ops_slots(flipped=flipped)
            qs = to_s(self.q)
            self._want[key] = (np.asarray(qs), np.asarray(mv(op4p(p), qs, p)))
        return self._want[key]

    def carried_operand(self, p, flipped):
        """The JAX plan's tables for (p, variant), carried across."""
        jp = self.jp
        fh = jp._flipped_fields()[0] if flipped else None
        aux = dict(jp.variant_aux_slots(p, src_host=fh, tgt_host=fh))
        panels = aux.pop("panels")
        meta = {k: getattr(jp._near_meta, k) for k in META_FIELDS}
        fields = fh if flipped else jp.src.fields
        return operand_from_numpy(
            to_numpy(jp.device_data(p)), to_numpy(aux), to_numpy(panels),
            meta, device="cpu", dtype=torch.float64,
            fields={k: np.asarray(v) for k, v in fields.items()},
        )


@pytest.fixture(scope="module")
def sphere():
    return Pair(unit_sphere(4), ncrit=32, max_p=10)


@pytest.fixture(scope="module")
def skewed():
    return Pair(two_spheres(), ncrit=8, max_p=6)


@pytest.mark.parametrize("tables", ["carried", "own"])
@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("p", [3, 5, 10])
def test_matvec_slots_matches_jax(sphere, p, flipped, tables):
    qs, want = sphere.jax_slots(p, flipped)
    tp = sphere.tp
    mv, op4p, to_s, _, nslots = tp.solver_ops_slots(flipped=flipped)
    assert nslots == len(qs)
    np.testing.assert_array_equal(to_s(sphere.q).numpy(), qs)
    operand = (
        sphere.carried_operand(p, flipped) if tables == "carried" else op4p(p)
    )
    assert rel(mv(operand, torch.tensor(qs), p), want) <= TOL


@pytest.mark.parametrize("tables", ["carried", "own"])
def test_matvec_slots_with_level_skewed_pairs(skewed, tables):
    tp = skewed.tp
    assert len(tp.m2p_src) > 0 and tp.m2l_fam is not None
    qs, want = skewed.jax_slots(5, False)
    mv, op4p, _, _, _ = tp.solver_ops_slots()
    operand = (
        skewed.carried_operand(5, False) if tables == "carried" else op4p(5)
    )
    assert rel(mv(operand, torch.tensor(qs), 5), want) <= TOL


def test_own_tables_match_carried_tables(sphere):
    """Table by table: what the port builds is what the JAX plan holds."""
    p = 5
    own = sphere.tp.solver_ops_slots()[1](p)
    carried = sphere.carried_operand(p, False)

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in b:
                if k in a:
                    walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        elif isinstance(a, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert torch.allclose(
                a.double(), b.double(), rtol=1e-13, atol=1e-13
            ), path

    for name, a, b in zip("d aux".split(), own[:2], carried[:2]):
        assert set(b) - {"near_meta"} <= set(a), name
        walk(a, b, name)
    assert own[1]["p2m_tab_t"].shape[0] == sphere.tp.leaf_pad   # k-major
    assert own[1]["l2p_tab_t"].shape[2:] == (
        len(sphere.tp.leaf_ids), sphere.tp.leaf_pad)             # w-major


@pytest.mark.parametrize("flipped", [False, True])
def test_apply_matches_jax(sphere, flipped):
    jp, tp, q = sphere.jp, sphere.tp, sphere.q
    if flipped:
        want, got = jp.apply_flipped_bc(q, p=5), tp.apply_flipped_bc(q, p=5)
    else:
        want, got = jp.apply(q, p=5), tp.apply(q, p=5)
    assert got.shape == (sphere.n, 1)
    assert rel(got, want) <= TOL


def test_matvec_matches_dense_matrix(sphere):
    """G and dGdn operators against the dense BC-switched entry matrix at
    high order, within the error the JAX package's own test of its matvec
    accepts (2e-4)."""
    plan, q, fields = sphere.tp, sphere.q, sphere.fields
    assert len(plan.m2l_tile_src) > 0
    A = plan.kernel.dense_matrix(fields)
    assert rel(plan.apply(q, p=10)[:, 0], A @ q) < 2e-4
    flipped = dict(fields)
    flipped["bc"] = 1.0 - np.asarray(fields["bc"])
    Af = plan.kernel.dense_matrix(flipped)
    assert rel(plan.apply_flipped_bc(q, p=10)[:, 0], Af @ q) < 2e-4


def test_calibrate_eps_matches_jax(sphere):
    c_j, g_j = sphere.jp.calibrate_eps(seed=3)
    c_t, g_t = sphere.tp.calibrate_eps(seed=3)
    assert sorted(sphere.tp.eps_samples) == sorted(sphere.jp.eps_samples)
    np.testing.assert_allclose([c_t, g_t], [c_j, g_j], rtol=1e-6)
