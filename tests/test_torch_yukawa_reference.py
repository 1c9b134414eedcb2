"""The plain float64 reference of the Yukawa BEM cells
(``bench_h100/reference/yukawa_bem.py``) on the CPU at 512 panels:

- its rows of the screened single and double layer against the port's
  Yukawa plan (``apply`` at p=8, both BC variants), on a plan with a far
  field;
- a relaxed ``solve_plan`` of the cell's own configuration (at the
  rehearsal size) against the reference's residual;
- at kappa = 0, against the Laplace reference (``laplace_bem.py``);
- its own rows solved densely read a residual of 0.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from bench_h100 import inputs
from bench_h100.reference import laplace_bem, yukawa_bem
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.solver.api import solve_plan

KAPPA = 0.125
#: the cell's relaxed solve (``bench_h100/traffic/relaxed_pc_p8.json``)
RELAXED = dict(residual=1e-5, max_iters=100, restart=100, max_p=8, p_min=1,
               p_tiers=(3, 5, 8))


@pytest.fixture(scope="module")
def tris():
    return inputs.unit_sphere(4)  # 512 panels


@pytest.fixture(scope="module")
def ref(tris):
    return yukawa_bem.SurfaceRows(tris, np.arange(len(tris)), "cpu",
                                  kappa=KAPPA)


def yukawa_plan(tris, ncrit):
    """The port's Yukawa plan in f64 at max_p 8: with a far field at
    ``ncrit`` 32; every pair in the near store at the cell's 64."""
    return T.FmmPlan(YukawaBEMKernel(K=3, fine_K=17, kappa=KAPPA),
                     make_panels(tris, K=3),
                     T.FMMConfig(ncrit=ncrit, leaf_pad=64, dtype="float64",
                                 max_p=8), device="cpu")


#: relative L2 error of the port's rows at p=8 on seeded charges, with
#: its reason.  G: the near single layer is integrated two ways (the
#: port's semi-analytical screened kernel; the reference's Laplace part
#: semi-analytically plus the bounded remainder by the fine rule), whose
#: five-point angular rules differ by 3.3e-4 on this coarse mesh (an
#: all-near plan reads the same); dG: the p=8 Cartesian-Taylor truncation
#: of the far field, 1.2e-4 (an all-near plan reads 6e-16).  A wrong
#: sign, self-term or screening reads 1e-2 or more.
ROW_TOL = {"G": 6e-4, "dG": 3e-4}


@pytest.fixture(scope="module")
def far_plan(tris):
    return yukawa_plan(tris, ncrit=32)


@pytest.mark.parametrize("which", ["G", "dG"])
def test_rows_match_the_port(which, tris, ref, far_plan):
    plan = far_plan
    assert len(plan.lists.m2l_pairs) > 0  # a far field at p=8
    x = np.random.default_rng(0).standard_normal(len(tris))
    apply = plan.apply if which == "G" else plan.apply_flipped_bc
    got = apply(x, p=8)[:, 0].numpy()
    want = ref.apply(which, x).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < ROW_TOL[which]


def test_relaxed_solve_residual(tris, ref):
    """The cell's configuration at its rehearsal size (every pair in the
    near store at 512 panels), in f64: the reference's residual of the
    relaxed solution of each charge stays under ten times the solver's
    tolerance (it reads 3.6e-5 to 4.9e-5, from the two near-field methods
    of the single layer)."""
    plan = yukawa_plan(tris, ncrit=64)
    pool, _ = inputs.point_charge_pool(tris, 7, 4, (2.0, 2.0), "potential",
                                       dtype=np.float64)
    cfg = T.SolverConfig(**RELAXED)
    for data in pool:
        b = plan.apply_flipped_bc(data, p=8)[:, 0].numpy()
        x, info, mode = solve_plan(plan, b, cfg)
        assert mode == "device-slots" and info.converged
        assert ref.residual("first_kind", x, data) < 10 * RELAXED["residual"]


def test_kappa_zero_is_the_laplace_reference(tris):
    """At kappa = 0 the rows are the Laplace reference's: G to 1e-12;
    dG off the diagonal to 1e-12, and on it the screened equation's
    self-term, -2 pi, against the Laplace +2 pi.  The double layer has
    the same sign in both references."""
    rows = inputs.sample_rows(len(tris), 128, 3)
    y = yukawa_bem.SurfaceRows(tris, rows, "cpu", kappa=0.0)
    lap = laplace_bem.SurfaceRows(tris, rows, "cpu")
    assert float((y.G - lap.G).abs().max() / lap.G.abs().max()) < 1e-12
    diag = torch.zeros_like(y.dG, dtype=torch.bool)
    diag[torch.arange(len(rows)), torch.as_tensor(rows)] = True
    off = (y.dG - lap.dG)[~diag].abs().max() / lap.dG.abs().max()
    assert float(off) < 1e-12
    assert torch.allclose(y.dG[diag], torch.tensor(-2.0 * np.pi,
                                                   dtype=torch.float64))
    assert torch.allclose(lap.dG[diag], torch.tensor(2.0 * np.pi,
                                                     dtype=torch.float64))


def test_residual_of_an_exact_solution_is_zero(tris, ref):
    data = np.random.default_rng(1).standard_normal(len(tris))
    x = torch.linalg.solve(ref.G, ref.dG @ torch.as_tensor(data)).numpy()
    assert ref.residual("first_kind", x, data) < 1e-12
    assert ref.residual("first_kind", 1.01 * x, data) > 5e-3
