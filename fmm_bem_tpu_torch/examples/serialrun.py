"""Point-FMM accuracy program: a random cube of N bodies, the FMM
against direct summation on sampled targets.

Counterpart of the reference's serialrun.cpp:136-208 and
serialrun_stresslet.cpp (the kernel is a flag instead of a #define).
The direct-summation check runs in f64 on the plan's device.

Usage: python -m fmm_bem_tpu_torch.examples.serialrun -N 10000 -p 8
       [-kernel laplace|laplace_cartesian|yukawa|yukawa_spherical|
                stokes|stresslet|unit] [-treecode] [-dtype float32]
       [-cpu]
"""

import argparse
import time

import numpy as np
import torch

KERNELS = ("laplace", "laplace_cartesian", "yukawa", "yukawa_spherical",
           "stokes", "stresslet", "unit")

#: sources x sampled targets per direct-summation block (bounds the
#: [targets, sources, 3] temporaries of a kernel's p2p)
DIRECT_BLOCK = 1 << 25


def make_kernel(name, kappa):
    if name == "laplace":
        from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel

        return LaplaceKernel()
    if name == "laplace_cartesian":
        from fmm_bem_tpu_torch.kernels.cartesian import (
            LaplaceCartesianKernel,
        )

        return LaplaceCartesianKernel()
    if name == "yukawa":
        from fmm_bem_tpu_torch.kernels.cartesian import YukawaKernel

        return YukawaKernel(kappa=kappa)
    if name == "yukawa_spherical":
        from fmm_bem_tpu_torch.kernels.spherical_yukawa import (
            YukawaSphericalKernel,
        )

        return YukawaSphericalKernel(kappa=kappa)
    if name == "stokes":
        from fmm_bem_tpu_torch.kernels.stokes import StokesKernel

        return StokesKernel()
    if name == "stresslet":
        from fmm_bem_tpu_torch.kernels.stokes import StressletKernel

        return StressletKernel()
    if name == "unit":
        from fmm_bem_tpu_torch.kernels.unit import UnitKernel

        return UnitKernel()
    raise SystemExit(f"unknown kernel {name}")


def direct(kern, tgt, src, q):
    """Direct summation at ``tgt`` in blocks of targets."""
    step = max(1, DIRECT_BLOCK // max(src.shape[0], 1))
    return torch.cat([
        kern.direct(tgt[i : i + step], src, q)
        for i in range(0, tgt.shape[0], step)
    ])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-N", type=int, default=10000)
    ap.add_argument("-p", type=int, default=8)
    ap.add_argument("-theta", type=float, default=0.5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-kernel", default="laplace", choices=KERNELS)
    ap.add_argument("-kappa", type=float, default=0.125)
    ap.add_argument("-nsamples", type=int, default=1000)
    ap.add_argument("-treecode", action="store_true")
    ap.add_argument("-seed", type=int, default=0)
    from fmm_bem_tpu_torch.examples import _common

    _common.add_device_flags(ap)
    args = ap.parse_args(argv)
    device, dtype = _common.device_and_dtype(args)

    from fmm_bem_tpu_torch.config import Evaluator, FMMConfig
    from fmm_bem_tpu_torch.executor.plan import FmmPlan

    kern = make_kernel(args.kernel, args.kappa)
    rng = np.random.default_rng(args.seed)
    pts = rng.uniform(0, 1, (args.N, 3))
    qdim = getattr(kern, "charge_dim", 1)
    q = rng.standard_normal((args.N, qdim)).squeeze()

    cfg = FMMConfig(
        theta=args.theta,
        ncrit=args.ncrit,
        max_p=max(args.p, 8),
        dtype=dtype,
        evaluator=Evaluator.TREECODE if args.treecode else Evaluator.FMM,
    )
    t0 = time.time()
    plan = FmmPlan(kern, {"xyz": pts}, cfg, device=device)
    build_s = time.time() - t0
    print(f"plan build: {build_s:.3f}s  "
          f"(boxes {plan.tree.num_boxes}, p2p pairs "
          f"{len(plan.lists.p2p_pairs)}, m2l pairs "
          f"{len(plan.lists.m2l_pairs)})")

    t0 = time.time()
    res = plan.apply(q, p=args.p)
    sync(device)
    print(f"first matvec (incl. table build): {time.time()-t0:.3f}s")
    t0 = time.time()
    res = plan.apply(q, p=args.p)
    sync(device)
    matvec_s = time.time() - t0
    print(f"matvec: {matvec_s:.4f}s  ({args.N**2/matvec_s:.3e} "
          "interactions/s)")

    sample = rng.choice(args.N, min(args.nsamples, args.N), replace=False)
    src = torch.as_tensor(pts, dtype=torch.float64, device=device)
    exact = direct(
        kern, src[torch.as_tensor(sample, device=device)], src,
        torch.as_tensor(q, dtype=torch.float64, device=device),
    ).cpu().numpy()
    approx = res.double().cpu().numpy()[sample]
    out = {"build_s": build_s, "matvec_s": matvec_s, "plan": plan,
           "result": res}
    if exact.ndim == 2 and exact.shape[1] >= 4:
        ep = np.linalg.norm(approx[:, 0] - exact[:, 0]) / np.linalg.norm(
            exact[:, 0])
        ef = np.linalg.norm(approx[:, 1:] - exact[:, 1:]) / np.linalg.norm(
            exact[:, 1:])
        print(f"potential rel. L2 error: {ep:.4e}")
        print(f"force     rel. L2 error: {ef:.4e}")
        out.update(potential_err=float(ep), force_err=float(ef))
    else:
        e = np.linalg.norm(approx - exact) / np.linalg.norm(exact)
        print(f"rel. L2 error: {e:.4e}")
        out["err"] = float(e)
    return out


if __name__ == "__main__":
    main()
