"""Laplace BEM program: first/second-kind boundary integral equation on
the unit sphere or a gmsh mesh.

Counterpart of examples/LaplaceBEM.cpp (flags :100-160, workflow
:160-374): build panels, form the RHS by flipping the BC flags (one
plan, no rebuild), solve with (F)GMRES + relaxation, report the
solution error vs the analytic dphi/dn = 1 and the exterior potential
vs 1/r.

Usage:
  python -m fmm_bem_tpu_torch.examples.laplace_bem -recursions 4 -p 5
         -k 3 [-second_kind] [-fixed_p] [-theta 0.5] [-ncrit 64]
         [-solver_tol 1e-5] [-fgmres] [-mesh file.msh]
         [-pc identity|diagonal] [-cpu] [-host_solver]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, prefix_chars="-")
    ap.add_argument("-recursions", type=int, default=4)
    ap.add_argument("-p", type=int, default=5)
    ap.add_argument("-k", type=int, default=3)
    ap.add_argument("-theta", type=float, default=0.5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-solver_tol", type=float, default=1e-5)
    ap.add_argument("-max_iters", type=int, default=500)
    ap.add_argument("-fixed_p", action="store_true")
    ap.add_argument("-calibrate", action="store_true",
                    help="fit eps(p) on this plan and use it for the "
                    "relaxation schedule instead of the 2^-p model")
    ap.add_argument("-p_tiers", default="auto",
                    help="comma-separated orders quantising the relaxed "
                    "schedule; 'auto' = 3,5,max_p; 'none' = the "
                    "reference's continuous schedule")
    # ref scalar GMRES floors the relaxed order at 1 (GMRES.hpp:195);
    # the Stokes program floors at SolverOptions::p_min instead
    ap.add_argument("-pmin", type=int, default=1)
    ap.add_argument("-second_kind", action="store_true")
    ap.add_argument("-fgmres", action="store_true")
    ap.add_argument("-mesh", type=str, default=None)
    ap.add_argument("-pc", choices=["identity", "diagonal"], default="diagonal")
    ap.add_argument("-max_p", type=int, default=None)
    from fmm_bem_tpu_torch.examples import _common

    _common.add_device_flags(ap)
    ap.add_argument("-checkpoint", default=None,
                    help="Krylov checkpoint path (resume if present)")
    ap.add_argument("-checkpoint_every", type=int, default=8)
    args = ap.parse_args(argv)
    device, dtype = _common.device_and_dtype(args)

    from fmm_bem_tpu_torch.bem.integrals import near_entries_laplace
    from fmm_bem_tpu_torch.bem.panels import make_panels, switch_bc
    from fmm_bem_tpu_torch.bem.triangulation import load_msh, unit_sphere
    from fmm_bem_tpu_torch.config import FMMConfig, SolverConfig
    from fmm_bem_tpu_torch.executor.plan import FmmPlan
    from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
    from fmm_bem_tpu_torch.solver.api import solve_plan
    from fmm_bem_tpu_torch.utils.metrics import log

    max_p = args.max_p or max(args.p, 10)
    tris = load_msh(args.mesh) if args.mesh else unit_sphere(args.recursions)
    fields = make_panels(tris, K=args.k)
    if args.second_kind:
        fields = switch_bc(fields)
    n = len(tris)
    print(f"initialised {n} panels "
          f"({'second' if args.second_kind else 'first'}-kind)")

    kern = LaplaceBEMKernel(K=args.k)
    cfg = FMMConfig(
        theta=args.theta, ncrit=args.ncrit, max_p=max_p, dtype=dtype
    )
    t0 = time.time()
    with log.phase("plan_build"):
        plan = FmmPlan(kern, fields, cfg, device=device)
    print(f"plan built in {time.time()-t0:.3f}s "
          f"(near nnz {len(plan.near_rows)}, m2l classes "
          f"{len(plan.m2l_classes.src)})")

    charges = np.ones(n)  # known phi (or dphi/dn for -second_kind)
    t0 = time.time()
    b = plan.apply_flipped_bc(charges, p=max_p)[:, 0].cpu().numpy()
    print(f"RHS via flipped-BC matvec: {time.time()-t0:.3f}s")

    diag = None
    if args.pc == "diagonal":
        idx = np.arange(n)
        G, dG = near_entries_laplace(fields, fields, idx, idx,
                                     fine_K=kern.fine_K)
        diag = np.where(np.asarray(fields["bc"]) == 0.0, G, dG)

    scfg = SolverConfig(
        residual=args.solver_tol,
        max_iters=args.max_iters,
        restart=args.max_iters,
        max_p=max_p,
        p_min=args.pmin,
        variable_p=not args.fixed_p,
        p_tiers=_common.tiers(args, max_p),
    )
    if args.calibrate and not args.fixed_p:
        scfg = scfg.calibrated(plan)
        if scfg.eps_c is not None:
            print(f"calibrated eps(p) = {scfg.eps_c:.3g} * "
                  f"{scfg.eps_gamma:.3g}^p")

    t0 = time.time()
    x, info, mode = solve_plan(
        plan,
        b,
        scfg,
        p_fixed=args.p if args.fixed_p else None,
        M_diag=diag,
        flexible=args.fgmres,
        verbose=True,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        prefer_device=_common.prefer_device(args, device),
    )
    solve_time = time.time() - t0
    print(f"\nTIMING:\n\tsolve : {solve_time:.4e}s  [{mode}] "
          f"({info.iterations} iterations, residual {info.residual:.3e})")

    err = np.linalg.norm(x - 1.0) / np.sqrt(n)
    print(f"relative error: {err:.3e}")

    # exterior potential check (ref LaplaceBEM.cpp:352-371)
    pt = np.array([[3.0, 3.0, 3.0]])
    phi_known = charges if not args.second_kind else x
    dphi = x if not args.second_kind else charges
    phi_ext = (
        kern.eval_exterior(fields, dphi, pt, layer="G")
        - kern.eval_exterior(fields, phi_known, pt, layer="dGdn")
    ) / (4 * np.pi)
    exact = 1.0 / np.linalg.norm(pt)
    print(
        f"external phi: {phi_ext[0]:.5g}, exact: {exact:.5g}, "
        f"error: {abs(phi_ext[0]-exact)/exact:.4e}"
    )
    log.print_report()
    return {"relative_error": float(err), "iterations": info.iterations,
            "mode": mode, "p_schedule": [h[2] for h in info.history],
            "external_error": float(abs(phi_ext[0] - exact) / exact),
            "solve_s": solve_time, "plan": plan}


if __name__ == "__main__":
    main()
