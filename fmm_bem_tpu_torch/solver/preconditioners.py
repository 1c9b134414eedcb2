"""Preconditioners for the FMM-BEM Krylov solves.

Counterparts of examples/BEM/Preconditioner.hpp (identity, diagonal),
BlockDiagonalPC.hpp (leaf-block solve) and LocalPC.hpp (near-field
inner solve).  Where the reference runs an inner 1-iteration GMRES
against a near-field-only FMM plan for its block-diagonal
preconditioner, the batched per-leaf dense blocks are inverted
directly — cheaper and exact.
"""

from __future__ import annotations

import torch

from fmm_bem_tpu_torch.config import SolverConfig
from fmm_bem_tpu_torch.solver.gmres import gmres


def identity():
    """Ref Preconditioner.hpp:8-16."""
    return lambda r: r


def diagonal(diag, device="cuda"):
    """Right-preconditioning by 1/diag (ref Preconditioner.hpp:19-41:
    reciprocal of the panel/point self-interaction K(s,s)).  ``diag``
    is moved to ``device``; the result takes the residual's dtype."""
    inv = 1.0 / torch.as_tensor(diag, device=device)
    return lambda r: inv.to(r.dtype) * r


def block_diagonal_from_plan(plan, p=None, assemble_block=None):
    """Batched inverse of each leaf's self-interaction block.

    Equivalent in role to the reference's BlockDiagonalPC (inner GMRES
    on an EvalDiagonalSparse plan, BlockDiagonalPC.hpp:37-58), but
    solved exactly: the padded ``[nleaf, K, K]`` blocks are assembled in
    one batch over the leaves on the plan's device and inverted by one
    batched ``torch.linalg.inv``.

    ``assemble_block(tgt_fields, src_fields) -> [K, K]`` defaults to the
    kernel's scalar P2P matrix entries (``p2p_matrix``).  The returned
    ``apply(r)`` takes and gives vectors in user order on the plan's
    device.
    """
    kern = plan.kernel
    K = plan.leaf_pad
    d = plan.device_data(p or plan.config.max_p)
    bidx = d["s_leaf_body_idx"]
    bmask = d["s_leaf_body_mask"]
    fields = {k: v[bidx] for k, v in plan.device_fields().items()}
    if assemble_block is None:
        assemble_block = kern.p2p_matrix

    blocks = torch.vmap(assemble_block)(fields, fields)  # [nl, K, K]
    # pad invalid rows/cols with the identity so the inverse exists.  A
    # block that is singular all the same (one point whose kernel has no
    # self term) inverts to non-finite values, as in the reference,
    # without raising
    eye = torch.eye(K, dtype=blocks.dtype, device=blocks.device)
    m2 = bmask[:, :, None] & bmask[:, None, :]
    inv = torch.linalg.inv_ex(torch.where(m2, blocks, eye))[0]
    inv = torch.where(m2, inv, 0.0)
    del blocks

    flat_slot = d["s_body_flat_slot"]
    perm, inv_perm = d["s_perm"], d["s_inv_perm"]
    nl = bidx.shape[0]

    def apply(r):
        rm = r[perm]
        rleaf = torch.where(bmask, rm[bidx], 0.0)  # [nl, K]
        z = torch.einsum("lij,lj->li", inv, rleaf)
        return z.reshape(nl * K)[flat_slot][inv_perm]

    return apply


def local_inner(plan_local, config=None, iters=1, p=3):
    """Near-field inner-solve preconditioner (ref LocalPC.hpp:50-59:
    one GMRES iteration on the local-evaluation plan at loose tol).
    ``plan_local(x) -> A_local x`` is the near-field-only operator (for
    example a ``local_evaluation=True`` plan's ``apply``); the inner
    solve is the host ``gmres``."""
    cfg = config or SolverConfig(residual=1e-1, max_iters=iters, restart=iters)

    def apply(r):
        x, _ = gmres(lambda x, _p: plan_local(x), r, config=cfg, p_fixed=p)
        return x

    return apply
