"""Readings of the numbers that decide ``correct``, many seeds in one
process: the program as it runs (``f32``), and the control that the
limits must reject.

    python3 bench_h100/control.py --workload <cell> --seconds 5 \
        --seeds 11 12 13 --modes f32 tf32 [--rehearse]

Modes:

- ``f32``: the program as configured (full-f32 matmuls);
- ``tf32``: the same program with TF32 switched on for its matmuls
  (``torch.backends.cuda.matmul.allow_tf32``), the precision below the
  configuration's, the step a later change could be tempted by;
- ``unchanged``, ``half``, ``altered``: the program with one of the
  faults of ``faults.py`` planted.

Each seed gets a short window at the cell's own load and the same
check as a run; one JSON line per (mode, seed).  The benchmark's runs
do not run this: the limits in ``limits/`` were set from its readings.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def set_mode(torch, mode):
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def readings(workload, seeds, modes, seconds, rehearse=False,
             config_over=None, device=None):
    """One record per (mode, seed): the check's numbers, which of them
    are over their limits, and the operations of the window."""
    from bench_h100.faults import planted
    from bench_h100.harness import (deep_merge, load_operation,
                                    resolve_cell, run_window)

    _, wl, config, traffic, limits = resolve_cell(workload, rehearse)
    config = deep_merge(config, config_over or {})
    import torch

    import fmm_bem_tpu_torch  # noqa: F401  (pins full-f32 at import)

    if device is None:
        device = torch.device("cpu" if rehearse else "cuda")
    cls = load_operation(traffic["operation"])
    try:
        for mode in modes:
            plan = None
            for seed in seeds:
                # the reference pins full-f32 matmuls as it runs: set
                # the mode anew for each seed
                set_mode(torch, mode)
                op = cls(config, traffic, seed, device, plan=plan)
                fault = (contextlib.nullcontext() if mode in ("f32", "tf32")
                         else planted(mode, traffic["operation"]))
                with fault:
                    op.warm_up()
                    records, window_s = run_window(op, seconds)
                op.finish(records)
                t0 = time.perf_counter()
                checks = op.check(records, device, traffic["check"])
                rec = {"workload": wl["name"], "mode": mode, "seed": seed,
                       "operations": len(records), "window_s": window_s,
                       "check_s": time.perf_counter() - t0,
                       "checks": checks,
                       "over_limit": sorted(
                           k for k, v in checks.items()
                           if not v <= limits[k]["limit"])}
                if "iters" in records[0]:
                    rec["iters"] = [r["iters"] for r in records]
                yield rec
                # a surface that does not depend on the seed keeps its
                # plan
                plan = op.plan if traffic["operation"] == "solve" else None
                if plan is None:
                    op.free()
            del plan
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        set_mode(torch, "f32")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--modes", nargs="+", default=["f32", "tf32"])
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    for rec in readings(args.workload, args.seeds, args.modes,
                        args.seconds, args.rehearse):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
