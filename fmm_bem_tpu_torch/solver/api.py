"""The solve entry point of the example programs.

The reference's example programs call GMRES with the plan's matvec
(examples/LaplaceBEM.cpp:281-291).  ``solve_plan`` runs by default the
device-resident solver on the plan's slot-space operator: the Krylov
vectors stay in the padded leaf-tile layout on the plan's device, and
the solution comes back in user ordering.  A plan without a slot
operator (a dual plan, the COO near-field replay) runs the same solver
on its body-order operator (``solver_ops``).  ``prefer_device=False``
runs the host loop instead (``gmres`` / ``fgmres``: Hessenberg and
Givens state in numpy f64) around ``plan.apply`` in user order; the
matvec still runs on the plan's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fmm_bem_tpu_torch.config import SolverConfig
from fmm_bem_tpu_torch.solver.gmres import (
    DeviceGmresContext,
    fgmres,
    fgmres_device,
    gmres,
    gmres_device,
)
from fmm_bem_tpu_torch.solver.preconditioners import diagonal


def solve_plan(
    plan,
    b,
    config: Optional[SolverConfig] = None,
    *,
    flipped: bool = False,
    p_fixed: Optional[int] = None,
    M_diag=None,
    flexible: bool = False,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
    prefer_device: Optional[bool] = None,
    device=None,
    context: Optional[DeviceGmresContext] = None,
):
    """Solve ``A x = b`` where A is the plan's (optionally BC-flipped)
    operator.  Returns ``(x, info, mode)`` with x a numpy array in user
    ordering and mode ``"device-slots"``, ``"device"`` (the body-order
    operator of a plan without a slot operator) or ``"host"``.

    M_diag : optional diagonal-preconditioner entries (user order,
        flattened [n*cdim]); applied as ``z = r / M_diag`` on both
        paths.
    prefer_device : ``None`` or ``True`` runs the device-resident
        solver on the slot-space operator; ``False`` the host loop on
        ``plan.apply`` (the reference program's ``-host_solver``).
    device : where the solve runs.  A plan's tables live on the device
        it was built for, so this must name that device (default: the
        plan's own); anything else raises.
    """
    cfg = config or SolverConfig()
    if device is not None and torch.device(device).type != plan.device.type:
        raise ValueError(
            f"solve_plan(device={device!r}): the plan was built for "
            f"{plan.device}; build the plan with the same device"
        )
    b = np.asarray(b).reshape(-1)
    if prefer_device is False:
        return _solve_host(
            plan, b, cfg, flipped=flipped, p_fixed=p_fixed, M_diag=M_diag,
            flexible=flexible, verbose=verbose,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
        )
    solver = fgmres_device if flexible else gmres_device
    kern = plan.kernel
    if getattr(kern, "charge_dim", 1) != kern.result_dim:
        raise ValueError(
            "solve_plan: the plan's kernel maps charges to results of "
            "another dimension; there is no square operator to solve with"
        )
    ops = plan.solver_ops_slots(flipped=flipped)
    if ops is not None:
        mv, op4p, to_s, from_s, _ = ops
        mode = "device-slots"
    else:
        # no slot operator: the body-order one, in user order
        mv, op4p = plan.solver_ops(flipped=flipped)
        to_s = lambda v: torch.as_tensor(  # noqa: E731
            np.array(v), dtype=plan.dtype, device=plan.device)
        from_s = lambda v: v  # noqa: E731
        mode = "device"
    Mfn = None
    if M_diag is not None:
        dslot = to_s(1.0 / np.asarray(M_diag))
        Mfn = lambda r: r * dslot
    x, info = solver(
        mv,
        to_s(b),
        operand_for_p=op4p,
        config=cfg,
        M=Mfn,
        p_fixed=p_fixed,
        verbose=verbose,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        context=context,
    )
    return from_s(x).cpu().numpy(), info, mode


def _solve_host(plan, b, cfg, *, flipped, p_fixed, M_diag, flexible,
                verbose, checkpoint_path, checkpoint_every):
    """The host loop around ``plan.apply`` (or ``apply_flipped_bc``)
    with the ``[n*cdim]`` flattening of the reference's Stokes solver
    (GMRES_Stokes.hpp VecToArray/ArrayToVec :85-110).  The Krylov basis
    lives on the plan's device in the plan's dtype."""
    cdim = getattr(plan.kernel, "charge_dim", 1)
    rdim = getattr(plan.kernel, "result_dim", 1)
    n = plan.src.tree.num_bodies
    apply = plan.apply_flipped_bc if flipped else plan.apply

    def matvec(v, p):
        q = v if cdim == 1 else v.reshape(n, cdim)
        out = apply(q, p=p)
        return out[:, 0] if rdim == 1 else out.reshape(-1)

    Mfn = None if M_diag is None else diagonal(M_diag, device=plan.device)
    solve = fgmres if flexible else gmres
    x, info = solve(
        matvec,
        torch.as_tensor(b, dtype=plan.dtype, device=plan.device),
        config=cfg,
        M=Mfn,
        p_fixed=p_fixed,
        verbose=verbose,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
    )
    return x.cpu().numpy(), info, "host"
