"""The plain reference of the point Laplace configurations.

Direct summation in float64 at sampled targets (after the reference's
Direct.hpp and LaplaceSpherical.hpp:153-162): the potential
``sum_j q_j / r_ij`` and the field ``sum_j q_j (x_j - x_i) / r_ij^3``,
with every source closer than ``sqrt(EPS2)`` left out (the kernel's
self-interaction rule, R^2 < 1e-8).
"""

from __future__ import annotations

import numpy as np
import torch

EPS2 = 1e-8


def direct_rows(points, rows, charges, device, chunk=16):
    """Potential and field at ``points[rows]`` of every charge vector
    (rows of ``charges``, ``[m, n]``): ``[m, len(rows), 4]`` float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f64 = torch.float64
    P = torch.as_tensor(np.asarray(points), dtype=f64, device=device)
    Q = torch.as_tensor(charges, device=device).to(f64).T.contiguous()
    T = P[torch.as_tensor(np.asarray(rows), device=device)]
    out = torch.empty((Q.shape[1], len(T), 4), dtype=f64, device=device)
    for a in range(0, len(T), chunk):
        d = P[None, :, :] - T[a:a + chunk, None, :]
        r2 = (d * d).sum(-1)
        inv_r2 = torch.where(r2 < EPS2, 0.0, 1.0 / r2.clamp_min(EPS2))
        inv_r = inv_r2.sqrt()
        out[:, a:a + chunk, 0] = (inv_r @ Q).T
        w = inv_r * inv_r2
        for c in range(3):
            out[:, a:a + chunk, 1 + c] = ((w * d[..., c]) @ Q).T
    return out


def errors(got, want):
    """(relative L2 error of the potential, of the field) of ``got``
    against ``want``, both ``[rows, 4]``."""
    got = got.to(want.dtype)
    ep = (got[:, 0] - want[:, 0]).norm() / want[:, 0].norm()
    ef = (got[:, 1:] - want[:, 1:]).norm() / want[:, 1:].norm()
    return float(ep), float(ef)
