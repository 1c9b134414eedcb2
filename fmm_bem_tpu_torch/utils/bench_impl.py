"""Benchmark record: the Laplace BEM sphere FMM matvec and its solves.

Port of ``fmm_bem_tpu/utils/bench_impl.py``, the record of the paper's
workload: FMM matvec effective interactions per second on the Laplace
BEM sphere (interactions = N^2 source-target pairs served by the O(N)
hierarchical matvec), the second-kind solve, the relaxed first-kind
solve, the near-field kernel against its plain version, and the
per-phase records at p=5 and p=10 (``utils/roofline.py``).

Every stage runs and a failing stage raises: nothing is skipped for
time and nothing falls back to the CPU.

Run as a module:
``python -m fmm_bem_tpu_torch.utils.bench_impl [cuda|cpu] [recursions]``
(default ``cuda 6``).  Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import fmm_bem_tpu_torch as fbt
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.ops.near_panel import (
    panel_matvec,
    panel_matvec_reference,
)
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.solver.gmres import DeviceGmresContext
from fmm_bem_tpu_torch.utils.roofline import (
    device_name,
    per_call_s,
    phase_breakdown,
)


#: chained calls and repeats of the phase records.  The matvec is
#: host-bound on a card and the host's speed drifts over seconds: short
#: chains in many rounds give the minimum of every prefix, and of the
#: reference matvec beside them, from the same fast moments
#: (phase_settings.py compares settings; PERF.md section 5)
PHASE_CHAIN, PHASE_REPEATS = 12, 24


def _note(t_start, msg):
    # progress marks on stderr: stdout carries only the JSON line
    print(f"[bench +{time.perf_counter() - t_start:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def run(device="cuda", recursions=7, p=5, iters=10, chain=50):
    """Build the bench plan on ``device`` and return its record
    (``measure``).  ``device="cuda"`` without a card raises."""
    dev = fbt.resolve_device(device)
    fields = make_panels(unit_sphere(recursions), K=3)
    t0 = time.perf_counter()
    plan = fbt.FmmPlan(
        LaplaceBEMKernel(K=3),
        fields,
        # max_p 10: the phase record runs at both p=5 and p=10, and the
        # first-kind relaxed solve uses tiers (3, 5, 10).  leaf_pad 64:
        # ncrit bounds leaf occupancy at 64 anyway, and the even tile
        # makes the near-field chunk rows m0*KS = 128 columns, no pad
        fbt.FMMConfig(ncrit=64, dtype="float32", max_p=max(p, 10),
                      leaf_pad=64),
        device=dev,
    )
    return measure(plan, time.perf_counter() - t0, p=p, iters=iters,
                   chain=chain)


def measure(plan, build_s, p=5, iters=10, chain=50):
    """The bench record of a Laplace BEM sphere plan (``run``'s, or one
    built with the same configuration): the chained matvec, one
    ``apply``, both solves, the near-field kernel check and the phase
    records, in that order.  ``matvec_s`` is the least over ``iters``
    distinct charge vectors of ``chain`` back-to-back slot-space
    matvecs (``solver_ops_slots``), and ``value = n^2 / matvec_s``."""
    t_start = time.perf_counter()
    dev = plan.device
    if dev.type == "cpu":
        chain = max(2, chain // 10)
        iters = max(1, iters // 5)
    n = plan.src.tree.num_bodies
    _note(t_start, f"start device={device_name(dev)} n={n}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def elapsed():
        return time.perf_counter() - t_start

    # the solve path's operator: slot space, Krylov vectors tile-resident
    mv, op4p, to_slots = plan.solver_ops_slots()[:3]
    operand = op4p(p)
    ones = np.ones(n, np.dtype(plan.config.dtype))
    q = to_slots(ones)
    qs = [q * (1.0 + 1e-5 * r) for r in range(iters)]

    def chained(x):
        for _ in range(chain):
            mv(operand, x, p)

    # the first chained call builds the kernels at first use
    sync()
    t0 = time.perf_counter()
    chained(q)
    sync()
    compile_s = time.perf_counter() - t0
    matvec_s = min(
        per_call_s(lambda: mv(operand, qs[r], p), chain, dev)
        for r in range(iters)
    )
    stage_s = {"chain_done": elapsed()}
    _note(t_start, f"chain timed: {matvec_s * 1e3:.3f} ms per matvec")

    # one apply, user order in and out, the result on the host
    plan.apply(ones, p=p).cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        plan.apply(ones, p=p).cpu()
    dispatched_s = (time.perf_counter() - t0) / iters
    stage_s["dispatched_done"] = elapsed()

    # second kind (the reference's -second_kind mode): dGdn system
    # (flipped BC), RHS = G . 1, analytic solution phi = 1; one solve
    # to fill the context, then the timed one
    b = plan.apply(ones, p=p)[:, 0].cpu().numpy()
    cfg = fbt.SolverConfig(residual=1e-5, max_p=p, max_iters=60, restart=60)
    ctx = DeviceGmresContext()
    solve_plan(plan, b, cfg, flipped=True, p_fixed=p, context=ctx)
    t0 = time.perf_counter()
    x, info, _ = solve_plan(plan, b, cfg, flipped=True, p_fixed=p,
                            context=ctx)
    solve_s = time.perf_counter() - t0
    solution_err = float(np.linalg.norm(x - 1.0) / np.sqrt(n))
    stage_s["solve_done"] = elapsed()
    _note(t_start, f"second kind: {info.iterations} iterations")

    # the reference's default workload (LaplaceBEM.cpp:190): the first
    # kind, G system, RHS = dGdn . 1 by the flipped-BC matvec, analytic
    # dphi/dn = 1, the order relaxed over the tiers (3, 5, 10)
    bfk = plan.apply_flipped_bc(ones, p=10)[:, 0].cpu().numpy()
    cfg_fk = fbt.SolverConfig(
        residual=1e-5, max_iters=100, restart=100,
        max_p=10, p_min=1, p_tiers=(3, 5, 10),
    )
    ctx_fk = DeviceGmresContext()
    solve_plan(plan, bfk, cfg_fk, context=ctx_fk)
    t0 = time.perf_counter()
    xf, infof, _ = solve_plan(plan, bfk, cfg_fk, context=ctx_fk)
    first_kind = {
        "solve_s": time.perf_counter() - t0,
        "iters": infof.iterations,
        "converged": bool(infof.converged),
        "residual": float(infof.residual),
        "err": float(np.linalg.norm(xf - 1.0) / np.sqrt(n)),
        "p_schedule": [int(h[2]) for h in infof.history],
    }
    stage_s["first_kind_done"] = elapsed()
    _note(t_start, f"first kind: {first_kind['p_schedule']}")

    # the near-field kernel against its plain version on the same device
    # tensors; on the CPU both are the plain version, so there is none
    near_equiv = None
    aux = plan.variant_aux(p)
    if dev.type == "cuda" and "A" in aux.get("panels", {}):
        d = plan.device_data(p)
        qm = torch.as_tensor(ones, device=dev)[d["s_perm"]]
        ql = plan._leaf_tiles(d, qm)
        got = panel_matvec(aux["panels"], aux["near_meta"], ql)
        want = panel_matvec_reference(aux["panels"], aux["near_meta"], ql)
        near_equiv = float(
            (got - want).norm() / want.norm().clamp_min(1e-30))
    stage_s["near_equiv_done"] = elapsed()

    # the phases' sum_ratio takes its matvec from the phases' own
    # round-robin, not from the chain above: the host-bound matvec's
    # time drifts between the two moments (PERF.md section 5)
    phases = phase_breakdown(plan, p, chain=PHASE_CHAIN,
                             repeats=PHASE_REPEATS)
    stage_s["phases_p5_done"] = elapsed()
    phases_p10 = phase_breakdown(plan, 10, chain=PHASE_CHAIN,
                                 repeats=PHASE_REPEATS)
    stage_s["phases_p10_done"] = elapsed()
    _note(t_start, "phases done")

    return {
        "backend": dev.type,
        "device": device_name(dev),
        "n_panels": n,
        "p": p,
        "matvec_s": matvec_s,
        "matvec_dispatched_s": dispatched_s,
        "build_s": build_s,
        "compile_s": compile_s,
        "solve_s": solve_s,
        "solve_iters": info.iterations,
        "solve_converged": bool(info.converged),
        "solution_err": solution_err,
        "near_equiv_err": near_equiv,
        "solve_first_kind_relaxed": first_kind,
        "stage_s": stage_s,
        "phases": phases,
        "phases_p10": phases_p10,
        "value": float(n) * float(n) / matvec_s,
    }


if __name__ == "__main__":
    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    rec = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    print(json.dumps(run(device, recursions=rec)))
