"""Input generators: everything a run feeds the program, made from the
run's seed.  The same seed gives the same inputs.

- ``unit_sphere``: a copy of ``fmm_bem_tpu_torch/bem/triangulation.py``
  (octahedron subdivision, after the reference's Triangulation.hpp),
  8 * 4^(rec - 1) flat triangles.
- ``uniform_cube``: the points of ``examples/serialrun.py`` and
  ``examples/scaling.py``: uniform in [0, 1]^3, one set in an order
  drawn from the seed.
- ``point_charge_pool``: the boundary data of one unit point charge
  outside the surface, the exterior-charge form of
  ``examples/laplace_bem.py``'s right-hand-side flow.  Every seed gets
  the same set of charge positions in another order: the position sets
  the solver's work, so seeds change its order and not its amount.
"""

from __future__ import annotations

import numpy as np
import torch

#: the seed of the one set of cube points every run permutes
CUBE_SET = 20261017

_OCT_VERTS = np.array([
    [1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0],
    [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0],
])
_OCT_FACES = np.array([
    [0, 4, 2], [2, 4, 1], [1, 4, 3], [3, 4, 0],
    [0, 2, 5], [2, 1, 5], [1, 3, 5], [3, 0, 5],
])


def rng(seed, stream):
    """A numpy generator for one use (``stream``) of a run's seed; any
    whole number is a seed."""
    return np.random.default_rng([int(seed) & (2**64 - 1), int(stream)])


def torch_generator(seed, stream, device):
    """A torch generator on ``device`` for one use of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(2**62)))
    return g


def _subdivide(tris):
    """4-way split with the new midpoints projected to the unit sphere."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    a = 0.5 * (v0 + v2)
    b = 0.5 * (v0 + v1)
    c = 0.5 * (v1 + v2)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    out = np.stack([
        np.stack([v0, b, a], axis=1),
        np.stack([b, v1, c], axis=1),
        np.stack([a, b, c], axis=1),
        np.stack([a, c, v2], axis=1),
    ], axis=1)
    return out.reshape(-1, 3, 3)


def unit_sphere(recursions):
    """Triangles ``[8 * 4^(rec-1), 3, 3]`` of the unit sphere, vertices
    ordered so that ``cross(v2 - v0, v1 - v0)`` points outwards."""
    tris = _OCT_VERTS[_OCT_FACES]
    for _ in range(max(0, recursions - 1)):
        tris = _subdivide(tris)
    return tris


def centroids_normals(tris):
    """Centroids and unit outward normals of flat triangles."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    c = np.cross(v2 - v0, v1 - v0)
    return (v0 + v1 + v2) / 3.0, c / np.linalg.norm(c, axis=1,
                                                    keepdims=True)


def uniform_cube(n, seed):
    """``n`` points uniform in the unit cube, ``[n, 3]`` float64: one
    fixed set for every seed, in an order drawn from the seed (the tree,
    and so the work and the memory, do not depend on the order)."""
    pts = np.random.default_rng(CUBE_SET).uniform(0.0, 1.0, (n, 3))
    return pts[rng(seed, 1).permutation(n)]


def charge_sources(seed, count, distance):
    """``count`` exterior charge positions: the same set for every seed
    (directions on a Fibonacci lattice of the sphere, distances evenly
    spread over ``[lo, hi]`` and paired with them by a fixed stride),
    in an order drawn from the seed."""
    lo, hi = distance
    k = np.arange(count) + 0.5
    z = 1.0 - 2.0 * k / count
    phi = np.pi * (1.0 + 5.0**0.5) * k
    r = np.sqrt(1.0 - z * z)
    u = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)
    stride = next(s for s in range(count // 2 + 1, count + 1)
                  if np.gcd(s, count) == 1)
    d = lo + (hi - lo) * ((np.arange(count) * stride) % count + 0.5) / count
    return (u * d[:, None])[rng(seed, 2).permutation(count)]


def point_charge_values(centers, normals, x0, value):
    """The potential ``1 / |y - x0|`` of a unit charge at ``x0``
    (``value="potential"``) or its normal derivative
    ``-(y - x0) . n / |y - x0|^3`` (``"normal_derivative"``) at the
    panel centroids ``y``."""
    d = centers - x0[None, :]
    r = np.sqrt((d * d).sum(1))
    if value == "potential":
        return 1.0 / r
    if value == "normal_derivative":
        return -(d * normals).sum(1) / r**3
    raise ValueError(f"unknown boundary value {value!r}")


def point_charge_pool(tris, seed, count, distance, value,
                      dtype=np.float32):
    """The boundary data of ``count`` exterior unit charges (rows of a
    ``[count, n]`` host array) and their positions ``[count, 3]``."""
    centers, normals = centroids_normals(tris)
    x0 = charge_sources(seed, count, distance)
    pool = np.stack([point_charge_values(centers, normals, x, value)
                     for x in x0]).astype(dtype)
    return pool, x0


def charge_pool(n, count, ranges, seed, device, dtype):
    """``count`` charge vectors, made on ``device`` in one call:
    ``[count, n]``; vector k is uniform in ``ranges[k % len(ranges)]``
    (each a dict with ``low`` and ``high``)."""
    g = torch_generator(seed, 3, device)
    u = torch.rand((count, n), generator=g, device=device, dtype=dtype)
    lo = torch.tensor([ranges[k % len(ranges)]["low"] for k in range(count)],
                      device=device, dtype=dtype)
    hi = torch.tensor([ranges[k % len(ranges)]["high"]
                       for k in range(count)], device=device, dtype=dtype)
    return u * (hi - lo)[:, None] + lo[:, None]


def sample_rows(n, count, seed):
    """``count`` distinct indices of ``range(n)``, sorted, from the
    seed: the rows the reference checks."""
    return np.sort(rng(seed, 4).choice(n, min(count, n), replace=False))
