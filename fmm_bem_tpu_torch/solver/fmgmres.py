"""FMGMRES: inner-outer flexible GMRES with an FMM-GMRES preconditioner.

Counterpart of examples/BEM/fmgmres.hpp (:1-60): the right
preconditioner of a flexible outer GMRES is itself a (cheap, relaxed)
GMRES solve against the same FMM operator — typically at a lower
truncation order and a loose tolerance, so each outer iteration gets a
strong approximate inverse while the relaxed inner matvecs stay cheap
(the paper's inexactness toolkit composed with itself).

Two variants:

- ``fmgmres`` (host loop): the inner solve is a full restarted
  ``gmres`` call with its own relaxation schedule.
- ``make_inner_pc_device`` + ``fgmres_device``: a fixed-k inner Arnoldi
  (no restarts, the small least-squares problem solved on the device)
  as the ``M`` of the device-resident flexible solver.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fmm_bem_tpu_torch.config import SolverConfig
from fmm_bem_tpu_torch.solver.gmres import fgmres, fgmres_device, gmres


def fmgmres(
    matvec: Callable,
    b,
    config: Optional[SolverConfig] = None,
    inner_iters: int = 8,
    inner_tol: float = 1e-1,
    p_inner: Optional[int] = None,
    verbose: bool = False,
):
    """Outer FGMRES right-preconditioned by an inner GMRES on the same
    operator (ref fmgmres.hpp).

    Parameters
    ----------
    matvec : ``(x, p) -> A@x`` (FmmPlan-backed operator).
    inner_iters / inner_tol : inner solve budget (ref uses a loose
        tolerance so the preconditioner stays cheap).
    p_inner : truncation order of the inner matvecs (default: the
        outer config's p_min — cheap but still accurate enough to
        precondition).
    """
    cfg = config or SolverConfig()
    pi = p_inner if p_inner is not None else max(1, cfg.p_min)
    inner_cfg = SolverConfig(
        residual=inner_tol,
        max_iters=inner_iters,
        restart=inner_iters,
        max_p=pi,
        variable_p=False,
    )

    def M(r):
        z, _ = gmres(matvec, r, config=inner_cfg, p_fixed=pi)
        return z

    return fgmres(matvec, b, config=cfg, M=M, verbose=verbose)


def make_inner_pc_device(matvec, operand, p_inner, k=6):
    """Fixed-k GMRES preconditioner for the device solver.

    Returns ``M(r) -> z`` running k Arnoldi steps of GMRES on
    ``x -> matvec(operand, x, p_inner)`` with no restart and the small
    (k+1, k) least-squares problem solved on the device — the flexible
    preconditioner of ``gmres_device``/``fgmres_device``.
    """

    def M(r):
        dt, dev = r.dtype, r.device
        tiny = torch.finfo(dt).tiny * 1e3
        beta = torch.linalg.vector_norm(r)
        V = [r / torch.clamp_min(beta, tiny)]
        H = torch.zeros((k + 1, k), dtype=dt, device=dev)
        for j in range(k):
            w = matvec(operand, V[j], p_inner)
            for i in range(j + 1):
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                H[i, j] = hij
            hlast = torch.linalg.vector_norm(w)
            V.append(w / torch.clamp_min(hlast, tiny))
            H[j + 1, j] = hlast
        # least-squares min ||beta e1 - H y|| via the normal equations
        # of the tiny (k+1, k) system (k ~ 6: conditioning is fine)
        e1 = torch.zeros(k + 1, dtype=dt, device=dev)
        e1[0] = beta
        A = H.T @ H + 1e-30 * torch.eye(k, dtype=dt, device=dev)
        y = torch.linalg.solve(A, H.T @ e1)
        z = y @ torch.stack(V[:k])
        # zero rhs -> zero output (no 0/0 garbage)
        return torch.where(beta > 0, z, torch.zeros_like(r))

    return M


def fmgmres_device(
    matvec,
    b,
    operand_for_p,
    config: Optional[SolverConfig] = None,
    inner_k: int = 6,
    p_inner: Optional[int] = None,
    verbose: bool = False,
    context=None,
):
    """Device-resident inner-outer FMGMRES: fixed-k inner Arnoldi as
    the flexible preconditioner of the tiered outer solve."""
    cfg = config or SolverConfig()
    pi = p_inner if p_inner is not None else max(1, cfg.p_min)
    M = make_inner_pc_device(matvec, operand_for_p(pi), pi, k=inner_k)
    return fgmres_device(
        matvec,
        b,
        operand_for_p=operand_for_p,
        config=cfg,
        M=M,
        verbose=verbose,
        context=context,
    )
