"""The Yukawa kernels of the PyTorch port against the JAX package, on the
CPU at f64.  Inputs are made with numpy from a seed and go through both
sides.

- The Cartesian-Taylor recurrences on torch tensors (``eval_coeffs``,
  ``powers``) against the JAX ones, 1e-13 relative, kappa 0 and 0.5,
  p 3 and 8.
- ``YukawaKernel``, ``YukawaSphericalKernel`` and ``YukawaBEMKernel``
  operator by operator (p2m, l2p and m2p, with gradients for the point
  kernels; p2p), 1e-12 relative; the P2M -> M2M -> M2L -> L2L -> L2P
  chain of the port against direct summation (the JAX package's own
  1e-3 bar).
- The BEM plan against the JAX plan, 1e-12 relative, on the port's own
  tables and on the JAX plan's carried across as numpy, on a 512-panel
  sphere: slot matvec, ``apply`` and ``apply_flipped_bc`` at p 3, 5
  and 8.  It runs the per-level translation classes (no kernel here is
  scale-invariant) and the table-less L2P.  The point plans are held to
  the JAX plans in ``tests/test_torch_yukawa_points.py``.
- The BEM kernel under ``near_mode="otf"`` builds the cached store in
  both packages (it has no regular-entry routine), with the cached
  result; the dense oracle (5e-4); the relaxed first-kind solve against
  the JAX package's device solve (same iterations and orders, solution
  to 1e-9) and the interior analytic value (5e-2).
"""

import dataclasses

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
from fmm_bem_tpu.kernels import cartesian as jct
from fmm_bem_tpu.kernels.cartesian import YukawaKernel as JYukawa
from fmm_bem_tpu.kernels.spherical_yukawa import (
    YukawaSphericalKernel as JSpherical,
)
from fmm_bem_tpu.kernels.yukawa_bem import YukawaBEMKernel as JBem
from fmm_bem_tpu.solver import gmres as jgm
from fmm_bem_tpu_torch.config import default_p_tiers
from fmm_bem_tpu_torch.kernels import cartesian as tct
from fmm_bem_tpu_torch.kernels.cartesian import YukawaKernel as TYukawa
from fmm_bem_tpu_torch.kernels.spherical_yukawa import (
    YukawaSphericalKernel as TSpherical,
)
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel as TBem
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.utils.convert import operand_from_numpy

TOL = 1e-12
META_FIELDS = ("nl_t", "m0", "block_rows", "npairs", "rdim", "cdim", "KT", "KS")


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tt(a):
    return torch.tensor(np.asarray(a))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------------------------------
# the Cartesian-Taylor recurrences
# ----------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_taylor_recurrences_match_jax(kappa, p):
    rng = np.random.default_rng(1)
    dX = rng.uniform(-1, 1, (200, 3)) + np.array([1.5, 0.0, 0.0])
    got = tct.eval_coeffs(tt(dX), kappa, p)
    want = jct.eval_coeffs(jnp.asarray(dX), kappa, p)
    assert got.shape == (200, tct.num_terms(p))
    assert rel(got, want) <= 1e-13
    np.testing.assert_allclose(got.numpy(), jct.eval_coeffs_np(dX, kappa, p),
                               rtol=1e-13, atol=0)
    v = rng.uniform(-1, 1, (200, 3))
    assert rel(tct.powers(tt(v), p), jct.powers(jnp.asarray(v), p)) <= 1e-13


# ----------------------------------------------------------------------
# operator by operator
# ----------------------------------------------------------------------
POINT_KERNELS = {
    "yukawa_k0": (lambda: JYukawa(0.0), lambda: TYukawa(0.0)),
    "yukawa_k0.5": (lambda: JYukawa(0.5), lambda: TYukawa(0.5)),
    "spherical_k0.5": (lambda: JSpherical(0.5), lambda: TSpherical(0.5)),
}


def op_inputs(width, ncomp, seed=0, B=40):
    """Normalised offsets near the box (p2m, l2p) and past the MAC
    (m2p), per-body scales, charges and expansions."""
    rng = np.random.default_rng(seed)
    return dict(
        d=rng.uniform(-0.5, 0.5, (B, 3)),
        d_far=rng.uniform(-0.5, 0.5, (B, 3)) + np.array([3.0, -1.0, 0.5]),
        isig=rng.uniform(1.0, 4.0, B),
        q=rng.standard_normal(B),
        E=rng.standard_normal((B, ncomp, width)),
        xyz=rng.uniform(0, 1, (B, 3)),
    )


@pytest.mark.parametrize("op", ["p2m", "l2p", "m2p", "p2p"])
@pytest.mark.parametrize("name", sorted(POINT_KERNELS))
def test_point_operators_match_jax(name, op):
    """p2m, l2p and m2p (potential and gradient) and p2p of the point
    kernels at p = 8."""
    jk, tk = (make() for make in POINT_KERNELS[name])
    p = 8
    x = op_inputs(tk.width(p), 1)
    if op == "p2m":
        want = jk.p2m({}, jnp.asarray(x["q"]), jnp.asarray(x["d"]),
                      jnp.asarray(x["isig"]), p)
        got = tk.p2m({}, tt(x["q"]), tt(x["d"]), tt(x["isig"]), p)
    elif op == "p2p":
        want = jk.p2p(jnp.asarray(x["xyz"][:25]), jnp.asarray(x["xyz"]),
                      jnp.asarray(x["q"]))
        got = tk.p2p(tt(x["xyz"][:25]), tt(x["xyz"]), tt(x["q"]))
        assert rel(tk.direct(tt(x["xyz"][:25]), tt(x["xyz"]), tt(x["q"]),
                             chunk=7), want) <= TOL
    else:
        d = x["d"] if op == "l2p" else x["d_far"]
        want = getattr(jk, op)({}, jnp.asarray(x["E"]), jnp.asarray(d),
                               jnp.asarray(x["isig"]), p)
        got = getattr(tk, op)({}, tt(x["E"]), tt(d), tt(x["isig"]), p)
        assert got.shape == (40, 4)
        assert rel(got[:, 1:], np.asarray(want)[:, 1:]) <= TOL
    assert rel(got, want) <= TOL


@pytest.fixture(scope="module")
def panel_fields():
    """128 panels; every other one carries the other BC flag."""
    f = dict(make_panels(unit_sphere(3), K=3))
    f["bc"] = (np.arange(len(f["xyz"])) % 2).astype(np.float64)
    return f


@pytest.mark.parametrize("op", ["p2m", "l2p", "m2p"])
def test_bem_operators_match_jax(panel_fields, op):
    """p2m (quadrature monopoles and, by forward mode along the normal,
    dipoles), l2p and m2p of the BEM kernel, both BC flags, p = 8."""
    jk, tk = JBem(K=3, kappa=0.5), TBem(K=3, kappa=0.5)
    p = 8
    x = op_inputs(tk.width(p), 2, seed=4)
    B = len(x["q"])
    jf = {k: jnp.asarray(np.asarray(v)[:B]) for k, v in panel_fields.items()
          if k != "vertices"}
    tf = {k: tt(np.asarray(v)[:B]) for k, v in panel_fields.items()
          if k != "vertices"}
    if op == "p2m":
        want = jk.p2m(jf, jnp.asarray(x["q"]), jnp.asarray(x["d"]),
                      jnp.asarray(x["isig"]), p)
        got = tk.p2m(tf, tt(x["q"]), tt(x["d"]), tt(x["isig"]), p)
        assert got.shape == (B, 2, tk.width(p))
        assert float(got[:, 1].abs().max()) > 0  # dipoles were formed
    else:
        d = x["d"] if op == "l2p" else x["d_far"]
        want = getattr(jk, op)(jf, jnp.asarray(x["E"]), jnp.asarray(d),
                               jnp.asarray(x["isig"]), p)
        got = getattr(tk, op)(tf, tt(x["E"]), tt(d), tt(x["isig"]), p)
        assert got.shape == (B, 1)
    assert rel(got, want) <= TOL


def test_bem_kernel_carries_no_otf_route():
    """As in the JAX package: no regular-entry routine and no leaf-tile
    marker, so the on-the-fly near mode is not taken for this kernel."""
    for k in (TBem(), JBem()):
        assert not hasattr(k, "near_regular_entries")
        assert not getattr(k, "otf_tile", False)
        assert callable(k.near_block_device)


@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_full_chain_telescopes(kappa):
    """P2M -> M2M -> M2L -> L2L -> L2P of the port against direct
    summation, the JAX package's own bar (tests/test_yukawa.py)."""
    kern = TYukawa(kappa=kappa)
    rng = np.random.default_rng(1)
    sigma = 0.5
    c_s = np.zeros(3)
    c_t = np.array([6.0, 0.4, -0.1])
    src = c_s + rng.uniform(-0.5, 0.5, (40, 3)) * sigma
    tgt = c_t + rng.uniform(-0.5, 0.5, (25, 3)) * sigma
    q = rng.standard_normal(40)
    p = 8
    exact = kern.direct(tt(tgt), tt(src), tt(q)).numpy()
    inv_s = torch.full((40,), 1.0 / sigma, dtype=torch.float64)
    M_c = kern.p2m({}, tt(q), tt((src - c_s) / sigma), inv_s, p)
    M_c = M_c.sum(dim=0)[0].numpy()
    sig_p = 2 * sigma
    c_ps = c_s + np.array([sigma, sigma, -sigma])
    M_p = kern.m2m_matrix(c_ps - c_s, sigma, sig_p, p) @ M_c
    c_pt = c_t + np.array([-sigma, sigma, sigma])
    L_p = kern.m2l_matrix(c_pt - c_ps, sig_p, sig_p, p) @ M_p
    L_c = kern.l2l_matrix(c_t - c_pt, sig_p, sigma, p) @ L_p
    Lb = tt(L_c)[None, None, :].expand(25, 1, len(L_c))
    approx = kern.l2p({}, Lb, tt((tgt - c_t) / sigma),
                      torch.full((25,), 1 / sigma, dtype=torch.float64), p)
    assert rel(approx[:, 0], exact[:, 0]) < 1e-3


# ----------------------------------------------------------------------
# whole plans against the JAX plans
# ----------------------------------------------------------------------
class BemPair:
    """The Yukawa BEM kernel on one mesh, planned by both packages."""

    def __init__(self, tris, near_mode="cached", kappa=0.5, max_p=8):
        self.fields = make_panels(tris, K=3)
        self.n = len(tris)
        cfg = dict(ncrit=32, dtype="float64", max_p=max_p,
                   near_mode=near_mode)
        self.jp = J.FmmPlan(JBem(K=3, kappa=kappa), self.fields,
                            J.FMMConfig(**cfg))
        self.tp = T.FmmPlan(TBem(K=3, kappa=kappa), self.fields,
                            T.FMMConfig(**cfg), device="cpu")
        self.q = np.random.default_rng(7).standard_normal(self.n)
        self._want = {}

    def want(self, p, flipped):
        """The JAX plan's ``apply`` (or ``apply_flipped_bc``) on ``q``,
        computed once per order and variant."""
        if (p, flipped) not in self._want:
            run = self.jp.apply_flipped_bc if flipped else self.jp.apply
            self._want[p, flipped] = np.asarray(run(self.q, p=p))
        return self._want[p, flipped]

    def carried_operand(self, p, flipped):
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
            kernels=(jp.kernel, self.tp.kernel),
        )


@pytest.fixture(scope="module")
def bem():
    return BemPair(unit_sphere(4))


@pytest.mark.parametrize("tables", ["carried", "own"])
@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("p", [3, 5, 8])
def test_bem_matvec_slots_matches_jax(bem, p, flipped, tables):
    """The slot matvec on the port's own tables and on the JAX plan's
    carried across, against the JAX plan's ``apply``
    (``apply_flipped_bc``) brought back to user order."""
    jp, tp = bem.jp, bem.tp
    _, _, jto, _, _ = jp.solver_ops_slots(flipped=flipped)
    qs = np.asarray(jto(bem.q))
    mv, op4p, to_s, from_s, nslots = tp.solver_ops_slots(flipped=flipped)
    assert nslots == len(qs)
    np.testing.assert_array_equal(to_s(bem.q).numpy(), qs)
    operand = (bem.carried_operand(p, flipped) if tables == "carried"
               else op4p(p))
    assert "l2p_tab_t" not in operand[1]  # the kernel's own L2P runs
    got = from_s(mv(operand, torch.tensor(qs), p))
    assert rel(got, bem.want(p, flipped)[:, 0]) <= TOL


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("p", [3, 5, 8])
def test_bem_apply_matches_jax(bem, p, flipped):
    tp, q = bem.tp, bem.q
    got = tp.apply_flipped_bc(q, p=p) if flipped else tp.apply(q, p=p)
    assert got.shape == (bem.n, 1)
    assert rel(got, bem.want(p, flipped)) <= TOL


def test_bem_plan_runs_per_level_classes(bem):
    tp, jp = bem.tp, bem.jp
    assert tp.m2l_fam is not None and len(tp.m2l_tile_src) > 0
    np.testing.assert_allclose(tp.m2l_fam.mats, jp.m2l_fam.mats, rtol=1e-14,
                               atol=1e-14)
    np.testing.assert_allclose(tp.m2l_classes.mats, jp.m2l_classes.mats,
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(tp.src.m2m_mats, jp.src.m2m_mats, rtol=1e-14,
                               atol=1e-14)
    # one octant class per level and octant: more than the 8 a
    # scale-invariant kernel shares across levels
    assert len(tp.src.m2m_mats) == len(jp.src.m2m_mats) > 8


def test_otf_near_mode_takes_the_cached_store():
    """``near_mode="otf"`` with this kernel builds the cached store in
    both packages, and the operator is the cached one (on 128 panels:
    the choice is made at plan build, whatever the mesh)."""
    pairs = {mode: BemPair(unit_sphere(3), near_mode=mode, max_p=5)
             for mode in ("otf", "cached")}
    for plan in (pairs["otf"].tp, pairs["otf"].jp):
        assert not plan._otf_near and plan._device_near
    q = pairs["cached"].q
    got = pairs["otf"].tp.apply(q, p=5)
    assert rel(got, pairs["cached"].tp.apply(q, p=5).numpy()) <= 1e-14
    # the JAX package's store is its cached one as well
    for a, b in zip(
            jax.tree_util.tree_leaves(pairs["otf"].jp.near_panels()[0]),
            jax.tree_util.tree_leaves(pairs["cached"].jp.near_panels()[0])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bem_matvec_against_dense_matrix(bem):
    A = bem.tp.kernel.dense_matrix(bem.fields)
    assert rel(bem.tp.apply(bem.q, p=8)[:, 0], A @ bem.q) < 5e-4


def test_first_kind_solve_matches_jax(bem):
    """The screened first-kind problem (phi = 1 on the sphere, RHS by
    the flipped operator), relaxed with the tiers of the reference
    program: the same iterations and orders as the JAX package's device
    solve, the solution to 1e-9, and the interior analytic value
    dphi/dn = -(kappa coth kappa - 1) to 5e-2."""
    jp, tp = bem.jp, bem.tp
    b = np.asarray(jp.apply_flipped_bc(np.ones(bem.n), p=8)[:, 0])
    cfg = T.SolverConfig(residual=1e-7, max_iters=100, restart=100, max_p=8,
                         p_tiers=default_p_tiers(8))
    jcfg = dataclasses.replace(
        cfg, relax_type=J.config.RelaxType(cfg.relax_type.value))
    mv, op4p, to_s, from_s, _ = jp.solver_ops_slots()
    xj, ij = jgm.gmres_device(
        mv, to_s(jnp.asarray(b)), operand_for_p=op4p,
        config=J.SolverConfig(**dataclasses.asdict(jcfg)))
    xj = np.asarray(from_s(xj))
    xt, it, mode = solve_plan(tp, b, cfg, device="cpu")
    assert mode == "device-slots" and ij.converged and it.converged
    assert it.iterations == ij.iterations
    assert [h[2] for h in it.history] == [h[2] for h in ij.history]
    assert len({h[2] for h in it.history}) > 1  # the order did relax
    assert np.abs(xt - xj).max() <= 1e-9
    kappa = tp.kernel.kappa
    exact = -(kappa / np.tanh(kappa) - 1.0)
    assert abs(xt.mean() - exact) / abs(exact) < 5e-2
