"""The solve entry point of the example programs.

The reference's example programs call GMRES with the plan's matvec
(examples/LaplaceBEM.cpp:281-291).  ``solve_plan`` runs the
device-resident solver on the plan's slot-space operator: the Krylov
vectors stay in the padded leaf-tile layout on the plan's device, and
the solution comes back in user ordering.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fmm_bem_tpu_torch.config import SolverConfig
from fmm_bem_tpu_torch.solver.gmres import (
    DeviceGmresContext,
    fgmres_device,
    gmres_device,
)


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
    device=None,
    context: Optional[DeviceGmresContext] = None,
):
    """Solve ``A x = b`` where A is the plan's (optionally BC-flipped)
    operator.  Returns ``(x, info, mode)`` with x a numpy array in user
    ordering and mode ``"device-slots"``.

    M_diag : optional diagonal-preconditioner entries (user order);
        applied as ``z = r / M_diag``.
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
    solver = fgmres_device if flexible else gmres_device
    mv, op4p, to_s, from_s, _ = plan.solver_ops_slots(flipped=flipped)
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
    return from_s(x).cpu().numpy(), info, "device-slots"
