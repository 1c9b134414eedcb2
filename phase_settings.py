#!/usr/bin/env python3
"""How the phase record's chain and repeats hold up on the card.

Builds the bench plan of ``fmm_bem_tpu_torch/utils/bench_impl.py`` (the
Laplace BEM sphere, ``ncrit=64``, ``leaf_pad=64``, f32, ``max_p=10``) and
runs ``utils/roofline.py::phase_breakdown`` at p=5 with the same number
of matvecs per prefix cut three ways, (chain, repeats) = (96, 3),
(32, 9) and (12, 24), twice each in turns.  One JSON line per run:
seconds, ``sum_ratio``, the pipeline and reference ms, and per phase
its ms and spread.  The matvec is host-bound on a card, so the host's
drift over seconds is what the settings are compared on.

Run from the root of a checkout on a machine with one card:
``python3 phase_settings.py [recursions]`` (default 8: 131,072 panels).
"""

import json
import sys
import time

import fmm_bem_tpu_torch as fbt
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.utils.roofline import device_name, phase_breakdown

SETTINGS = ((96, 3), (32, 9), (12, 24))


def main():
    recursions = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    plan = fbt.FmmPlan(
        LaplaceBEMKernel(K=3), make_panels(unit_sphere(recursions), K=3),
        fbt.FMMConfig(ncrit=64, dtype="float32", max_p=10, leaf_pad=64),
        device="cuda",
    )
    phase_breakdown(plan, 5, chain=2, repeats=1)  # tables, kernel build
    for turn in range(2):
        for chain, repeats in SETTINGS:
            t0 = time.perf_counter()
            out = phase_breakdown(plan, 5, chain=chain, repeats=repeats)
            total = out.pop("total")
            print(json.dumps({
                "turn": turn, "chain": chain, "repeats": repeats,
                "s": time.perf_counter() - t0,
                "sum_ratio": total["sum_ratio"], "ms": total["ms"],
                "matvec_ms": total["matvec_ms"],
                "phases": {k: {"ms": v["ms"], "spread_ms": v["spread_ms"]}
                           for k, v in out.items()},
                "device": device_name(plan.device),
            }), flush=True)


if __name__ == "__main__":
    main()
