"""The plain references agree with the port on the CPU in float64: the
Laplace BEM operator rows at 2,048 panels and the point potential and
field at 4,096 points, the port at p=10 where its truncation is small."""

import numpy as np
import torch

from bench_h100 import inputs
from bench_h100.reference.laplace_bem import SurfaceRows
from bench_h100.reference.laplace_points import direct_rows, errors


def test_bem_rows_match_the_port():
    import fmm_bem_tpu_torch as fbt
    from fmm_bem_tpu_torch.bem.panels import make_panels
    from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel

    tris = inputs.unit_sphere(5)
    n = len(tris)
    rows = inputs.sample_rows(n, 512, 1)
    ref = SurfaceRows(tris, rows, "cpu")
    plan = fbt.FmmPlan(
        LaplaceBEMKernel(K=3), make_panels(tris, K=3),
        fbt.FMMConfig(ncrit=64, leaf_pad=64, dtype="float64", max_p=10),
        device="cpu")
    x = np.random.default_rng(0).standard_normal(n)
    for which, got in (("G", plan.apply(x, p=10)),
                       ("dG", plan.apply_flipped_bc(x, p=10))):
        got = got[:, 0].numpy()[rows]
        want = ref.apply(which, x).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-5


def test_bem_residual_of_an_exact_solution_is_zero():
    tris = inputs.unit_sphere(4)
    n = len(tris)
    ref = SurfaceRows(tris, np.arange(n), "cpu")
    data = np.random.default_rng(1).standard_normal(n)
    # solve the dense first-kind system the rows make
    x = torch.linalg.solve(ref.G, ref.dG @ torch.as_tensor(data)).numpy()
    assert ref.residual("first_kind", x, data) < 1e-12
    assert ref.residual("first_kind", 1.01 * x, data) > 5e-3


def test_points_match_the_port():
    import fmm_bem_tpu_torch as fbt
    from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel

    pts = inputs.uniform_cube(4096, 2)
    q = inputs.charge_pool(4096, 1, [{"low": -1.0, "high": 1.0}], 2, "cpu",
                          torch.float64)
    plan = fbt.FmmPlan(LaplaceKernel(), {"xyz": pts},
                       fbt.FMMConfig(ncrit=64, dtype="float64", max_p=10),
                       device="cpu")
    got = plan.apply(q[0], p=10)
    rows = inputs.sample_rows(4096, 512, 3)
    want = direct_rows(pts, rows, q, "cpu")[0]
    ep, ef = errors(got[torch.as_tensor(rows)], want)
    # the p=10 truncation of charges of both signs: 1.9e-5 for the
    # potential on this input; a wrong sign or a missed source reads ~1
    assert ep < 1e-4 and ef < 1e-4
