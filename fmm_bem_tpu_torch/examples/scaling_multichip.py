#!/usr/bin/env python
"""Rank-scaling harness for the LET-distributed FMM
(fmm_bem_tpu_torch/parallel/let.py).

Produces the scaling evidence of the JAX package's program of the same
name:
  - ``-mode mem``    per-rank memory/work at fixed N vs rank count
                     (near-field store, M2L pairs, expansions, halo
                     sizes) plus the largest collective a rank receives
                     in one matvec, read from the communicator's log:
                     proof the stores/tiles are distributed and only
                     halo-sized data moves.
  - ``-mode weak``   matvec wall-clock with N scaled by the rank count
                     (weak-scaling efficiency).
  - ``-mode strong`` matvec wall-clock at fixed N vs rank count.

``-devs`` counts ranks.  Rank r runs on card ``r % count`` of the cards
there are: with one card every rank is on it, and the ranks run one
after another from one host thread, so the times measure the cost of
distribution, not a speed-up.  ``-cpu`` puts every rank on the host.

Usage:
  python -m fmm_bem_tpu_torch.examples.scaling_multichip -mode mem
  python -m fmm_bem_tpu_torch.examples.scaling_multichip -mode strong -N 100000
  [-recursions 6] [-devs 1,2,4] [-p 5] [-ncrit 64] [-dtype float32]
  [-pin_leaf_pad K] [-cpu]
"""

import argparse
import time

import numpy as np


def _bem_plan(recursions, ncrit, dtype, max_p, device):
    from fmm_bem_tpu_torch.bem.panels import make_panels
    from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
    from fmm_bem_tpu_torch.config import FMMConfig
    from fmm_bem_tpu_torch.executor.plan import FmmPlan
    from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel

    tris = unit_sphere(recursions)
    fields = make_panels(tris, K=3)
    return FmmPlan(
        LaplaceBEMKernel(K=3),
        fields,
        FMMConfig(ncrit=ncrit, dtype=dtype, max_p=max_p),
        device=device,
    )


def _point_plan(n, ncrit, dtype, max_p, device, seed=0, leaf_pad=None):
    from fmm_bem_tpu_torch.config import FMMConfig
    from fmm_bem_tpu_torch.executor.plan import FmmPlan
    from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel

    pts = np.random.default_rng(seed).uniform(0, 1, (n, 3))
    return FmmPlan(
        LaplaceKernel(),
        {"xyz": pts},
        FMMConfig(ncrit=ncrit, dtype=dtype, max_p=max_p,
                  leaf_pad=leaf_pad),
        device=device,
    )


def _time_matvec(lp, q, p, reps=5):
    """Seconds per distributed matvec (after one untimed call that
    builds the ranks' tables) and its padded result."""
    from fmm_bem_tpu_torch.examples.serialrun import sync

    fn, ops = lp.matvec_fn(p)
    qp = lp.to_padded(q)
    out = fn(ops, qp)
    sync(qp.device)
    t0 = time.time()
    for _ in range(reps):
        out = fn(ops, qp)
    sync(qp.device)
    return (time.time() - t0) / reps, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-mode", choices=["mem", "weak", "strong"],
                    default="mem")
    ap.add_argument("-N", type=int, default=16384,
                    help="base body count (weak/strong, point kernel)")
    ap.add_argument("-recursions", type=int, default=6,
                    help="sphere recursions (mem mode, BEM kernel)")
    ap.add_argument("-p", type=int, default=5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-dtype", default="float32")
    ap.add_argument("-cpu", action="store_true",
                    help="run every rank on the host")
    ap.add_argument("-devs", type=str, default="1,2,4,8",
                    help="comma list of rank counts")
    ap.add_argument("-pin_leaf_pad", type=int, default=None,
                    help="pin the leaf tile width across the sweep "
                    "(default: ncrit in weak/strong modes) so P2P "
                    "block shapes are constant: tree-shape changes "
                    "otherwise masquerade as scaling effects")
    args = ap.parse_args(argv)

    import torch

    from fmm_bem_tpu_torch import resolve_device
    from fmm_bem_tpu_torch.parallel.let import LetPlan, rank_devices

    device = resolve_device("cpu" if args.cpu else "cuda")
    counts = [int(c) for c in args.devs.split(",")]
    if device.type == "cuda":
        ncards = torch.cuda.device_count()
        name = torch.cuda.get_device_name(0)
    else:
        ncards, name = 1, "host CPU"
    print(f"devices available: {ncards} ({device.type}: {name}); ranks per "
          "device: " + ", ".join(
              f"{nd} ranks -> {-(-nd // ncards)}" for nd in counts))

    rows = []
    if args.mode == "mem":
        plan = _bem_plan(args.recursions, args.ncrit, args.dtype,
                         max(args.p, 8), device)
        n = plan.tree.num_bodies
        q = np.ones(n, args.dtype)
        print(f"Laplace BEM sphere, {n} panels, p={args.p}")
        print("ndev  panelMB/dev  m2lpairs/dev  expKB/dev  haloKB  "
              "maxcollKB  collective")
        for nd in counts:
            lp = LetPlan(plan, nd, devices=rank_devices(nd, device))
            st = lp.stats()
            lp.apply(q, p=args.p)
            cb, cdesc = lp.comm.max_received()
            halo = st["halo_multipole_bytes"] + st["halo_charge_bytes"]
            print(
                f"{nd:4d}  {st['near_panel_bytes_per_dev']/1e6:10.2f}"
                f"  {st['m2l_pairs_per_dev']:12d}"
                f"  {st['expansion_bytes_per_dev']/1e3:9.1f}"
                f"  {halo/1e3:7.1f}  {cb/1e3:8.1f}  {cdesc}"
            )
            rows.append({"ndev": nd, "stats": st, "max_collective_bytes": cb,
                         "collective": cdesc, "log": list(lp.comm.log)})
            del lp
        return {"mode": "mem", "n": n, "rows": rows}

    # weak / strong: point Laplace (panel counts quantise by 4x)
    pin = args.pin_leaf_pad if args.pin_leaf_pad else args.ncrit
    base_rate = None
    print(f"Laplace points, p={args.p}, {args.mode} scaling, "
          f"leaf_pad pinned to {pin}")
    print("ndev       N   matvec[ms]    pairs/s    eff(N^2)  eff(work)")
    for nd in counts:
        n = args.N * nd if args.mode == "weak" else args.N
        plan = _point_plan(n, args.ncrit, args.dtype, max(args.p, 6),
                           device, leaf_pad=pin)
        # measured work of THIS tree (flop proxy): padded P2P blocks +
        # M2L class matmuls; normalising by it isolates the cost of
        # distribution (halos, padding to the max range, collectives)
        # from the octree's level transitions
        Wexp = plan.kernel.width(args.p)
        cW = plan.kernel.ncomp * Wexp
        K = plan.src.leaf_pad
        work = (
            20.0 * len(plan.p2p_src_slot) * K * K
            + 2.0 * len(plan.m2l_tile_src) * cW * Wexp
        )
        lp = LetPlan(plan, nd, devices=rank_devices(nd, device))
        q = np.random.default_rng(1).standard_normal(n).astype(args.dtype)
        dt, _ = _time_matvec(lp, q, args.p)
        rate = n * n / dt
        wrate = work / dt
        if base_rate is None:
            base_rate = (rate / nd, wrate / nd) if args.mode == "weak" \
                else (rate, wrate)
        if args.mode == "weak":
            eff = (rate / nd) / base_rate[0]
            effw = (wrate / nd) / base_rate[1]
        else:
            eff = rate / (base_rate[0] * nd)
            effw = wrate / (base_rate[1] * nd)
        print(f"{nd:4d} {n:8d}   {dt*1e3:9.2f}  {rate:.3e}   "
              f"{eff:8.1%}  {effw:8.1%}")
        rows.append({"ndev": nd, "n": n, "matvec_s": dt, "eff": eff,
                     "eff_work": effw,
                     "max_collective_bytes": lp.comm.max_received()[0]})
        del lp, plan
    return {"mode": args.mode, "rows": rows}


if __name__ == "__main__":
    main()
