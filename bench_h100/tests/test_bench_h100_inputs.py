"""The generators repeat under one seed."""

import numpy as np
import torch

from bench_h100 import inputs

RANGES = [{"low": -1.0, "high": 1.0}, {"low": 0.5, "high": 1.5}]


def test_sphere_is_fixed_and_outward():
    tris = inputs.unit_sphere(3)
    assert tris.shape == (128, 3, 3)
    c, n = inputs.centroids_normals(tris)
    assert np.all((c * n).sum(1) > 0)
    np.testing.assert_array_equal(tris, inputs.unit_sphere(3))


def test_point_charge_pool_repeats_and_keeps_its_positions():
    tris = inputs.unit_sphere(3)
    big = 2**31 + 12345
    a, xa = inputs.point_charge_pool(tris, big, 8, (1.5, 3.0), "potential")
    b, xb = inputs.point_charge_pool(tris, big, 8, (1.5, 3.0), "potential")
    np.testing.assert_array_equal(a, b)
    _, xc = inputs.point_charge_pool(tris, 7, 8, (1.5, 3.0), "potential")
    assert not np.allclose(xa, xc)
    # every seed: the same positions, in another order
    np.testing.assert_allclose(xa[np.lexsort(xa.T)], xc[np.lexsort(xc.T)])
    d = np.linalg.norm(xa, axis=1)
    assert d.min() >= 1.5 and d.max() <= 3.0


def test_normal_derivative_is_the_gradient_along_the_normal():
    tris = inputs.unit_sphere(3)
    c, n = inputs.centroids_normals(tris)
    x0 = np.array([0.0, 2.0, 0.5])
    h = 1e-6
    up = inputs.point_charge_values(c + h * n, n, x0, "potential")
    dn = inputs.point_charge_values(c - h * n, n, x0, "potential")
    want = (up - dn) / (2 * h)
    got = inputs.point_charge_values(c, n, x0, "normal_derivative")
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cube_charges_and_rows_repeat():
    a, b = inputs.uniform_cube(100, 5), inputs.uniform_cube(100, 6)
    np.testing.assert_array_equal(a, inputs.uniform_cube(100, 5))
    # one set of points, in another order
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
    p = inputs.charge_pool(50, 3, RANGES, 9, "cpu", torch.float32)
    q = inputs.charge_pool(50, 3, RANGES, 9, "cpu", torch.float32)
    assert torch.equal(p, q) and p[0].min() >= -1 and p[0].max() < 1
    assert p[1].min() >= 0.5 and p[1].max() < 1.5
    np.testing.assert_array_equal(inputs.sample_rows(1000, 10, 4),
                                  inputs.sample_rows(1000, 10, 4))
