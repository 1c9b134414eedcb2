"""Yukawa (screened-Laplace) BEM program on the unit sphere.

Counterpart of the reference's examples/YukawaBEM.cpp: the first-kind
screened boundary integral equation solved with relaxed GMRES, checked
against the interior analytic solution.

Usage: python -m fmm_bem_tpu_torch.examples.yukawa_bem -recursions 3
       -p 6 -k 3 -kappa 0.125 [-cpu] [-host_solver]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-recursions", type=int, default=3)
    ap.add_argument("-p", type=int, default=6)
    ap.add_argument("-k", type=int, default=3)
    ap.add_argument("-kappa", type=float, default=0.125)
    ap.add_argument("-theta", type=float, default=0.5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-solver_tol", type=float, default=1e-5)
    ap.add_argument("-max_iters", type=int, default=500)
    ap.add_argument("-fixed_p", action="store_true")
    ap.add_argument("-p_tiers", default="auto",
                    help="'auto' = 3,5,max_p tier quantisation of the "
                    "relaxed schedule; 'none' = continuous")
    from fmm_bem_tpu_torch.examples import _common

    _common.add_device_flags(ap)
    args = ap.parse_args(argv)
    device, dtype = _common.device_and_dtype(args)

    from fmm_bem_tpu_torch.bem.panels import make_panels
    from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
    from fmm_bem_tpu_torch.config import FMMConfig, SolverConfig
    from fmm_bem_tpu_torch.executor.plan import FmmPlan
    from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
    from fmm_bem_tpu_torch.solver.api import solve_plan

    tris = unit_sphere(args.recursions)
    fields = make_panels(tris, K=args.k)
    n = len(tris)
    print(f"initialised {n} panels, kappa = {args.kappa}")

    kern = YukawaBEMKernel(K=args.k, kappa=args.kappa)
    cfg = FMMConfig(
        theta=args.theta, ncrit=args.ncrit, max_p=max(args.p, 8),
        dtype=dtype,
    )
    t0 = time.time()
    plan = FmmPlan(kern, fields, cfg, device=device)
    print(f"plan built in {time.time()-t0:.3f}s")

    phi = np.ones(n)
    b = plan.apply_flipped_bc(phi, p=cfg.max_p)[:, 0].cpu().numpy()

    scfg = SolverConfig(
        residual=args.solver_tol,
        max_iters=args.max_iters,
        restart=args.max_iters,
        max_p=cfg.max_p,
        variable_p=not args.fixed_p,
        p_tiers=_common.tiers(args, cfg.max_p),
    )
    t0 = time.time()
    x, info, mode = solve_plan(
        plan,
        b,
        scfg,
        p_fixed=args.p if args.fixed_p else None,
        verbose=True,
        prefer_device=_common.prefer_device(args, device),
    )
    solve_s = time.time() - t0
    print(f"\nTIMING:\n\tsolve : {solve_s:.4e}s [{mode}] "
          f"({info.iterations} its, residual {info.residual:.3e})")

    # analytic check: with the reference's -2pi Yukawa self-term
    # (SemiAnalytical.hpp:196-201) the equation is the INTERIOR screened
    # problem; for phi = 1 on the unit sphere the interior solution is
    # phi(r) = sinh(kappa r)/(r sinh kappa), so dphi/dn (inward normal
    # orientation of the octahedron mesh) = -(kappa coth kappa - 1).
    exact = -(args.kappa / np.tanh(args.kappa) - 1.0)
    err = abs(x.mean() - exact) / abs(exact)
    print(f"solution mean dphi/dn: {x.mean():.6f}  std {x.std():.2e}")
    print(f"analytic (interior): {exact:.6f}  rel. error: {err:.3e}")
    return {"analytic_error": float(err), "mean_dphi_dn": float(x.mean()),
            "iterations": info.iterations, "mode": mode,
            "p_schedule": [h[2] for h in info.history], "solve_s": solve_s,
            "plan": plan}


if __name__ == "__main__":
    main()
