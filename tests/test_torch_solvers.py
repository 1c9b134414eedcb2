"""The solver layer of the PyTorch port against the JAX package, on the
CPU at f64: the host GMRES / FGMRES loop, ``solve_plan``'s ``"host"``
mode, the preconditioners, ``eval_exterior`` and the ``Logger`` (FMGMRES:
tests/test_torch_fmgmres.py; the near-field-only plans:
tests/test_torch_near_only.py).  The same numpy inputs from a seed go through both packages.

Parity is judged as set out in ROADMAP.md: the same iteration counts and
orders, residual histories to 1e-12 (of ``||b||``: the residuals are
already relative), solutions and operators to 1e-12 (1e-9 for whole
solves through FMM plans), sums in another order being the only
difference.  Where the JAX package is at fault (the host loop's
back-substitution when ``max_iters`` cuts a restart cycle,
ROADMAP.md C), the port is held to the mathematics instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace import LaplaceKernel as JLaplace
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu.solver import gmres as jgm
from fmm_bem_tpu.solver import preconditioners as jpc
from fmm_bem_tpu.solver.api import solve_plan as j_solve_plan
from fmm_bem_tpu.utils import metrics as jmet
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel
from fmm_bem_tpu_torch.solver import gmres as tgm
from fmm_bem_tpu_torch.solver import preconditioners as tpc
from fmm_bem_tpu_torch.solver.api import solve_plan as t_solve_plan
from fmm_bem_tpu_torch.utils import metrics as tmet


def jcfg(**kw):
    return J.SolverConfig(**kw)


def tcfg(**kw):
    return T.SolverConfig(**kw)


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def same_solve(ij, it, xj, xt, tol=1e-12, hist_tol=1e-12):
    """Same iterations, orders and convergence; residual histories to
    ``hist_tol`` of ||b||; solutions to ``tol`` of their largest entry."""
    assert it.iterations == ij.iterations
    assert it.converged == ij.converged
    assert [h[0] for h in it.history] == [h[0] for h in ij.history]
    assert [h[2] for h in it.history] == [h[2] for h in ij.history]
    rj = np.array([h[1] for h in ij.history])
    rt = np.array([h[1] for h in it.history])
    assert np.abs(rt - rj).max(initial=0.0) <= hist_tol
    assert rel(torch.as_tensor(xt).cpu().numpy(), xj) <= tol


# ----------------------------------------------------------------------
# the host loop on dense systems (the systems of tests/test_gmres.py)
# ----------------------------------------------------------------------


def dense_system(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "shifted":  # A + n I: a few iterations
        n = 80
        A = rng.standard_normal((n, n)) + n * np.eye(n)
    else:  # condition 1e2: many iterations, stalls under relaxation
        n = 90
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = Q @ np.diag(np.logspace(0, 2, n)) @ Q.T
    return A, rng.standard_normal(n)


#: (system, config, p_fixed, flexible, diagonal M)
DENSE = {
    "plain": ("shifted", dict(residual=1e-10), None, False, False),
    "restart": ("ill", dict(residual=1e-9, restart=12, max_iters=300),
                1, False, False),
    "restart_flexible_M": ("ill", dict(residual=1e-9, restart=12,
                                       max_iters=300), 1, True, True),
    "M": ("ill", dict(residual=1e-9, max_iters=200), 1, False, True),
    "relaxed_stall_boost": ("ill", dict(residual=1e-4, max_p=16, p_min=1),
                            None, False, False),
    "relaxed_tiers": ("ill", dict(residual=1e-8, max_p=10, p_min=1,
                                  p_tiers=(3, 5, 10)), None, True, False),
}


@pytest.mark.parametrize("case", sorted(DENSE))
def test_host_gmres_matches_jax_on_dense_systems(case):
    kind, kw, p_fixed, flexible, with_m = DENSE[case]
    A, b = dense_system(kind, 30)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    dinv = 1.0 / np.diag(A)
    Mj = (lambda r: r * jnp.asarray(dinv)) if with_m else None
    Mt = (lambda r: r * torch.as_tensor(dinv)) if with_m else None
    xj, ij = jgm.gmres(lambda v, p: Aj @ v, b, config=jcfg(**kw),
                       p_fixed=p_fixed, flexible=flexible, M=Mj)
    xt, it = tgm.gmres(lambda v, p: At @ v, torch.as_tensor(b),
                       config=tcfg(**kw), p_fixed=p_fixed,
                       flexible=flexible, M=Mt)
    assert ij.converged
    same_solve(ij, it, xj, xt)
    if case == "relaxed_stall_boost":
        # the boost fired: some order lies above what the schedule asks
        # for at the residual before it
        cfg = tcfg(**kw)
        ps = [h[2] for h in it.history]
        res = [1.0] + [h[1] for h in it.history]
        assert any(p > cfg.schedule_p(r) for p, r in zip(ps, res))
    if case.startswith("restart"):
        assert it.iterations > kw["restart"]


@pytest.mark.parametrize("flexible", [False, True])
def test_host_gmres_when_max_iters_cuts_a_cycle(flexible):
    """The JAX loop back-substitutes one column too many when max_iters
    stops a restart cycle early: a zero pivot gives nan (or an
    IndexError in the flexible update).  The port solves with the
    columns it has: its estimated residual is the true one, and its
    history is the JAX one."""
    A, b = dense_system("ill", 31)
    kw = dict(residual=1e-12, restart=12, max_iters=30)
    mv = lambda v, p: jnp.asarray(A) @ v
    if flexible:
        with pytest.raises(IndexError):
            jgm.gmres(mv, b, config=jcfg(**kw), p_fixed=1, flexible=True)
        ij = None
    else:
        xj, ij = jgm.gmres(mv, b, config=jcfg(**kw), p_fixed=1)
        assert not np.isfinite(np.asarray(xj)).all()
    At = torch.as_tensor(A)
    xt, it = tgm.gmres(lambda v, p: At @ v, torch.as_tensor(b),
                       config=tcfg(**kw), p_fixed=1, flexible=flexible)
    assert it.iterations == 30 and not it.converged
    true = np.linalg.norm(b - A @ xt.numpy()) / np.linalg.norm(b)
    assert abs(true - it.residual) <= 1e-12 * max(true, 1.0)
    if ij is not None:
        assert [h[1] for h in it.history] == pytest.approx(
            [h[1] for h in ij.history], abs=1e-12)


class _Killed(RuntimeError):
    """Simulated process death mid-solve."""


@pytest.mark.parametrize("restart,die_after,flexible", [
    (300, 9, False), (12, 17, False), (12, 17, True)])
def test_host_checkpoint_resume_is_bit_identical(tmp_path, restart,
                                                 die_after, flexible):
    """A solve killed mid-cycle (or in its second restart cycle) and
    resumed from its host checkpoint ends with the uninterrupted solve's
    bits."""
    A, b = dense_system("ill", 32)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    path = str(tmp_path / "krylov.npz")
    cfg = tcfg(residual=1e-9, max_iters=300, restart=restart)
    kw = dict(config=cfg, p_fixed=1, flexible=flexible,
              checkpoint_path=path, checkpoint_every=3)
    x_ref, info_ref = tgm.gmres(lambda v, p: At @ v, bt, **kw)
    assert info_ref.converged and info_ref.iterations > die_after
    calls = [0]

    def mv_dying(v, p):
        calls[0] += 1
        if calls[0] > die_after:
            raise _Killed()
        return At @ v

    with pytest.raises(_Killed):
        tgm.gmres(mv_dying, bt, **kw)
    ck = np.load(path)
    assert bytes(ck["kind"]) == b"host"
    x_res, info_res = tgm.gmres(lambda v, p: At @ v, bt, **kw)
    assert info_res.iterations == info_ref.iterations
    assert info_res.history[-1] == info_ref.history[-1]
    assert torch.equal(x_res, x_ref)


# ----------------------------------------------------------------------
# relaxed host solves through FMM plans, and solve_plan's host mode
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def sphere128():
    fields = make_panels(unit_sphere(3), K=3)
    cfg = dict(ncrit=8, dtype="float64", max_p=6)
    jp = J.FmmPlan(JKernel(K=3), fields, J.FMMConfig(**cfg))
    tp = T.FmmPlan(TKernel(K=3), fields, T.FMMConfig(**cfg), device="cpu")
    return fields, jp, tp


@pytest.mark.parametrize("tiers", [None, (3, 6)])
def test_host_gmres_relaxed_on_the_128_panel_sphere(sphere128, tiers):
    """The first-kind system on a seeded right-hand side (on 1 the
    128-panel sphere converges in two steps), its order relaxed from the
    residual, the matvec of each package's own plan."""
    fields, jp, tp = sphere128
    n = len(fields["xyz"])
    b = np.random.default_rng(7).standard_normal(n)
    kw = dict(residual=1e-6, max_iters=60, restart=60, max_p=6, p_min=1,
              p_tiers=tiers)
    xj, ij = jgm.gmres(lambda v, p: jp.apply(v, p=p)[:, 0], b,
                       config=jcfg(**kw))
    xt, it = tgm.gmres(lambda v, p: tp.apply(v, p=p)[:, 0],
                       torch.as_tensor(b), config=tcfg(**kw))
    assert ij.converged and len({h[2] for h in ij.history}) > 1
    same_solve(ij, it, xj, xt, tol=1e-9)


@pytest.fixture(scope="module")
def sphere512():
    fields = make_panels(unit_sphere(4), K=3)
    cfg = dict(ncrit=32, dtype="float64", max_p=10)
    jp = J.FmmPlan(JKernel(K=3), fields, J.FMMConfig(**cfg))
    tp = T.FmmPlan(TKernel(K=3), fields, T.FMMConfig(**cfg), device="cpu")
    n = len(fields["xyz"])
    kern = TKernel(K=3)
    from fmm_bem_tpu_torch.bem.integrals import near_entries_laplace

    idx = np.arange(n)
    G, dG = near_entries_laplace(fields, fields, idx, idx,
                                 fine_K=kern.fine_K)
    return fields, jp, tp, G, dG


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("with_diag", [False, True])
def test_solve_plan_host_mode_matches_jax(sphere512, flipped, with_diag):
    """``solve_plan(prefer_device=False)``: the first-kind system (G,
    RHS dGdn . 1) or, flipped, the second-kind one (dGdn, RHS G . 1),
    relaxed with tiers, with and without the diagonal preconditioner."""
    fields, jp, tp, G, dG = sphere512
    n = len(fields["xyz"])
    ones = np.ones(n)
    if flipped:
        b = np.asarray(jp.apply(ones, p=10)[:, 0])
        diag = dG
    else:
        b = np.asarray(jp.apply_flipped_bc(ones, p=10)[:, 0])
        diag = G
    kw = dict(residual=1e-5, max_iters=100, restart=100, max_p=10, p_min=1,
              p_tiers=(3, 5, 10))
    M = diag if with_diag else None
    xj, ij, mj = j_solve_plan(jp, b, jcfg(**kw), flipped=flipped,
                              M_diag=M, prefer_device=False)
    xt, it, mt = t_solve_plan(tp, b, tcfg(**kw), flipped=flipped,
                              M_diag=M, prefer_device=False)
    assert mt == mj == "host"
    assert isinstance(xt, np.ndarray) and xt.shape == (n,)
    same_solve(ij, it, xj, xt, tol=1e-9)
    assert np.linalg.norm(xt - 1.0) / np.sqrt(n) < 5e-2
    # the device-resident solver stays the default
    assert t_solve_plan(tp, b, tcfg(**kw), flipped=flipped)[2] == \
        "device-slots"


# ----------------------------------------------------------------------
# preconditioners
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def points600():
    """The shifted 600-point system of tests/test_utils.py."""
    rng = np.random.default_rng(0)
    n = 600
    pts = rng.uniform(0, 1, (n, 3))
    cfg = dict(ncrit=24, dtype="float64", max_p=8)
    jp = J.FmmPlan(JLaplace(), {"xyz": pts}, J.FMMConfig(**cfg))
    tp = T.FmmPlan(TLaplace(), {"xyz": pts}, T.FMMConfig(**cfg),
                   device="cpu")
    return pts, jp, tp, rng.standard_normal(n)


SHIFT = 30.0


def test_diagonal_matches_jax():
    rng = np.random.default_rng(5)
    d, r = rng.uniform(1, 2, 50), rng.standard_normal(50)
    want = np.asarray(jpc.diagonal(d)(jnp.asarray(r)))
    got = tpc.diagonal(d, device="cpu")(torch.as_tensor(r))
    assert rel(got.numpy(), want) <= 1e-15
    assert tpc.identity()(got) is got


@pytest.mark.parametrize("assemble", ["shifted", "p2p_matrix"])
def test_block_diagonal_from_plan_matches_jax(points600, assemble):
    pts, jp, tp, r = points600
    if assemble == "shifted":
        jas = lambda tf, sf: (JLaplace().p2p_matrix(tf, sf)
                              + SHIFT * jnp.eye(tf["xyz"].shape[0]))
        tas = lambda tf, sf: (tp.kernel.p2p_matrix(tf, sf)
                              + SHIFT * torch.eye(tf["xyz"].shape[0],
                                                  dtype=torch.float64))
    else:
        # the kernel's own entries: a leaf of one point has a singular
        # block, which both packages invert to non-finite values
        jas = tas = None
    Mj = jpc.block_diagonal_from_plan(jp, p=6, assemble_block=jas)
    Mt = tpc.block_diagonal_from_plan(tp, p=6, assemble_block=tas)
    want = np.asarray(Mj(jnp.asarray(r)))
    got = Mt(torch.as_tensor(r)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() > 0.9 * len(r)
    assert rel(got[fin], want[fin]) <= 1e-12


def test_block_diagonal_preconditioner_cuts_iterations(points600):
    """The assertion of tests/test_utils.py, on the port: exact leaf
    block solves cut the FGMRES iterations on the shifted system."""
    pts, jp, tp, b = points600

    def tas(tf, sf):
        return (tp.kernel.p2p_matrix(tf, sf)
                + SHIFT * torch.eye(tf["xyz"].shape[0], dtype=torch.float64))

    M = tpc.block_diagonal_from_plan(tp, p=6, assemble_block=tas)
    mv = lambda x, p: tp.apply(x, p=p)[:, 0] + SHIFT * x
    # within 60 iterations: the plain solve needs about 200
    cfg = tcfg(residual=1e-8, max_p=8, max_iters=60, restart=60)
    _, info_id = tgm.gmres(mv, torch.as_tensor(b), config=cfg, p_fixed=8)
    _, info_pc = tgm.fgmres(mv, torch.as_tensor(b), config=cfg, M=M,
                            p_fixed=8)
    assert info_pc.converged and not info_id.converged
    assert info_pc.iterations < info_id.iterations


def test_local_inner_matches_jax():
    """The near-field inner solve of tests/test_utils.py (300 points,
    two inner iterations at p=3) on a local-evaluation plan of each
    package."""
    rng = np.random.default_rng(1)
    n = 300
    pts = rng.uniform(0, 1, (n, 3))
    cfg = dict(ncrit=32, dtype="float64", max_p=6, local_evaluation=True)
    jp = J.FmmPlan(JLaplace(), {"xyz": pts}, J.FMMConfig(**cfg))
    tp = T.FmmPlan(TLaplace(), {"xyz": pts}, T.FMMConfig(**cfg),
                   device="cpu")
    r = rng.standard_normal(n)
    Mj = jpc.local_inner(
        lambda x: np.asarray(jp.apply(x, p=3)[:, 0]) + SHIFT * x,
        iters=2, p=3)
    Mt = tpc.local_inner(lambda x: tp.apply(x, p=3)[:, 0] + SHIFT * x,
                         iters=2, p=3)
    want = np.asarray(Mj(r))
    got = Mt(torch.as_tensor(r)).numpy()
    assert np.isfinite(got).all() and rel(got, want) <= 1e-12


# ----------------------------------------------------------------------
# eval_exterior and the Logger
# ----------------------------------------------------------------------


@pytest.mark.parametrize("layer", ["G", "dGdn"])
def test_eval_exterior_matches_jax(layer):
    fields = make_panels(unit_sphere(2), K=3)
    q = np.random.default_rng(6).standard_normal(len(fields["xyz"]))
    pts = np.array([[3.0, 3.0, 3.0], [0.0, 0.0, 1.5], [-2.0, 0.5, 0.1]])
    want = JKernel(K=3).eval_exterior(fields, q, pts, layer=layer)
    got = TKernel(K=3).eval_exterior(fields, q, pts, layer=layer)
    assert got.shape == (3,) and rel(got, want) <= 1e-12


def test_logger_matches_jax():
    events = [("matvec", 100.0), ("matvec", 100.0), ("near", 0.0),
              ("solve", 7.5)]
    logs = []
    for mod in (jmet, tmet):
        log = mod.Logger()
        for name, work in events:
            with log.phase(name, work=work, sync=torch.zeros(1)):
                pass
        log.add("build", 0.25, work=3.0)
        logs.append(log.report())
    rj, rt = logs
    assert sorted(rt) == sorted(rj) == ["build", "matvec", "near", "solve"]
    for name in rj:
        assert rt[name]["hits"] == rj[name]["hits"]
        assert rt[name]["work"] == rj[name]["work"]
        assert ("rate_per_s" in rt[name]) == ("rate_per_s" in rj[name])
    assert rt["build"]["total_s"] == rj["build"]["total_s"] == 0.25
    assert callable(tmet.get_time) and tmet.get_time() > 0
    # the plan's build phases carry the JAX package's names
    before = {k: v["hits"] for k, v in tmet.log.report().items()}
    T.FmmPlan(TKernel(K=3), make_panels(unit_sphere(1), K=3),
              T.FMMConfig(ncrit=8, dtype="float64", max_p=4), device="cpu")
    after = tmet.log.report()
    for name in ("build.sides", "build.m2l_classes", "build.near"):
        assert after[name]["hits"] == before.get(name, 0) + 1
