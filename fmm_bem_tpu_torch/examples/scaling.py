"""FMM against direct-summation timing and the ncrit tuning sweep.

Counterpart of the reference's tests/scaling.cpp (N=10,000 Laplace,
3-run average, force error) and tests/ncrit_search.cpp (ncrit 50..400
step 50).  The plan runs in f32, as the reference's does, on the card
(on the host with ``-cpu``); the direct summation on 1,000 targets runs
in f64 on the plan's device and is extrapolated to N targets.

Usage:
  python -m fmm_bem_tpu_torch.examples.scaling                 # scaling run
  python -m fmm_bem_tpu_torch.examples.scaling -ncrit_search   # ncrit sweep
  [-N 10000] [-p 8] [-ncrit 125] [-cpu]
"""

import argparse
import time

import numpy as np
import torch

from fmm_bem_tpu_torch.examples.serialrun import direct, sync


def run_once(pts, q, ncrit, p, dtype, device, runs=3):
    """Seconds per ``apply`` (mean of ``runs`` after one untimed call),
    the last result and the plan."""
    from fmm_bem_tpu_torch.config import FMMConfig
    from fmm_bem_tpu_torch.executor.plan import FmmPlan
    from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel

    plan = FmmPlan(
        LaplaceKernel(), {"xyz": pts},
        FMMConfig(ncrit=ncrit, max_p=max(p, 8), dtype=dtype), device=device,
    )
    res = plan.apply(q, p=p)  # device tables
    sync(device)
    t0 = time.time()
    for _ in range(runs):
        res = plan.apply(q, p=p)
    sync(device)
    return (time.time() - t0) / runs, res, plan


def direct_sample(pts, q, device, nsamp=1000):
    """Potential and force at the first ``nsamp`` bodies by direct
    summation in f64 on ``device`` (numpy), and the seconds it took."""
    from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel

    src = torch.as_tensor(pts, dtype=torch.float64, device=device)
    t0 = time.time()
    exact = direct(LaplaceKernel(), src[:nsamp], src, torch.as_tensor(
        q, dtype=torch.float64, device=device))
    sync(device)
    return exact.cpu().numpy(), time.time() - t0


def force_error(res, exact):
    """Relative L2 error of the forces of the first ``len(exact)``
    bodies of ``res`` against ``exact`` (numpy, f64)."""
    approx = res[: len(exact)].double().cpu().numpy()
    return float(np.linalg.norm(approx[:, 1:] - exact[:, 1:])
                 / np.linalg.norm(exact[:, 1:]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-N", type=int, default=10000)
    ap.add_argument("-p", type=int, default=8)
    ap.add_argument("-ncrit", type=int, default=125)  # ref "optimal ncrit"
    ap.add_argument("-ncrit_search", action="store_true")
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-cpu", action="store_true",
                    help="run on the host instead of the GPU")
    args = ap.parse_args(argv)
    from fmm_bem_tpu_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    dtype = "float32"

    rng = np.random.default_rng(args.seed)
    pts = rng.uniform(0, 1, (args.N, 3))
    q = rng.standard_normal(args.N)

    nsamp = min(1000, args.N)
    if args.ncrit_search:
        # the force errors and plans are returned, not printed, as the
        # reference prints times only
        print("ncrit  t_fmm[s]   interactions/s")
        sweep, errs, plans = [], [], []
        exact, _ = direct_sample(pts, q, device, nsamp)
        for ncrit in range(50, 401, 50):
            dt, res, plan = run_once(pts, q, ncrit, args.p, dtype, device)
            print(f"{ncrit:5d}  {dt:.5f}  {args.N**2/dt:.3e}")
            sweep.append((ncrit, dt))
            errs.append(force_error(res, exact))
            plans.append(plan)
        return {"sweep": sweep, "force_errs": errs, "plans": plans}

    dt_fmm, res, plan = run_once(pts, q, args.ncrit, args.p, dtype, device)
    exact, direct_s = direct_sample(pts, q, device, nsamp)
    dt_direct = direct_s * (args.N / nsamp)
    ef = force_error(res, exact)
    print(f"N = {args.N}, p = {args.p}, ncrit = {args.ncrit}")
    print(f"FMM time    : {dt_fmm:.4f}s")
    print(f"direct time : {dt_direct:.4f}s (extrapolated)")
    print(f"speedup     : {dt_direct/dt_fmm:.1f}x")
    print(f"force error : {ef:.4e}")
    return {"fmm_s": dt_fmm, "direct_s": dt_direct, "force_err": ef,
            "plan": plan, "result": res}


if __name__ == "__main__":
    main()
