#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run as ``python3 chip_smoke.py`` from the root of a checkout.  It imports
only ``fmm_bem_tpu_torch``, builds the CUDA kernels from the sources in
the checkout (``nvcc``, first use), holds every kernel against its plain
PyTorch version on the card, and drives the port's main path at full
size: a Laplace BEM unit sphere of 131,072 panels (K=3, ncrit=64,
leaf_pad=64, f32, max_p=10) -> ``FmmPlan`` -> 50 chained slot-space
matvecs at p=5 -> the second-kind solve at fixed p=5 -> the first-kind
relaxed solve with tiers (3, 5, 10).  Each phase prints one JSON line;
any failure exits non-zero.  There is no CPU fallback: without a GPU the
script fails before it prints anything.

``--recursions R`` runs a smaller sphere (8 * 4**(R-1) panels) for a
quick look; the default is the full size.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write(
        "chip_smoke.py: torch.cuda.is_available() is False; this script "
        "measures the GPU port and does not run on the CPU\n"
    )
    sys.exit(1)

import fmm_bem_tpu_torch as fbt
from fmm_bem_tpu_torch import native
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.ops import _build
from fmm_bem_tpu_torch.ops import near_panel as npl
from fmm_bem_tpu_torch.solver.api import solve_plan

#: H100 SXM data-sheet peaks the bounds are stated against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
#: top eigenvalue of the single-layer operator on the unit sphere; the
#: chained matvecs are scaled by its inverse so they neither grow nor die
SPHERE_G_NORM = 4.0 * np.pi

DEV = torch.device("cuda")


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke.py: FAILED: {msg}\n")
    sys.exit(1)


def gpu_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_plan(recursions, dtype, ncrit=64, leaf_pad=64):
    fields = make_panels(unit_sphere(recursions), K=3)
    plan = fbt.FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        fbt.FMMConfig(ncrit=ncrit, dtype=dtype, max_p=10, leaf_pad=leaf_pad),
        device=DEV,
    )
    return plan, len(fields["xyz"])


def check_near_panel(panels, meta, nl_src, tol, label, time_it=False):
    """The near_panel kernel against its plain version on the card, on a
    seeded charge table; optionally timed beside its plain version, the
    library yardstick and its bound."""
    A = panels["A"]
    gen = torch.Generator(device=DEV).manual_seed(11)
    ql = torch.randn(
        (nl_src, meta.KS * meta.cdim), generator=gen, dtype=A.dtype,
        device=DEV,
    )
    got = npl.panel_matvec(panels, meta, ql)
    torch.cuda.synchronize()
    want = npl.panel_matvec_reference(panels, meta, ql)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"near_panel[{label}]: bad output {tuple(got.shape)}")
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    rec = {
        "case": label, "dtype": str(A.dtype).replace("torch.", ""),
        "A_shape": list(A.shape), "m0": meta.m0, "nl_t": meta.nl_t,
        "max_abs_err": max_abs, "rel_err": rel, "tol": tol,
    }
    if rel > tol:
        emit(rec)
        fail(f"near_panel[{label}] disagrees with its plain version: "
             f"rel {rel:.3e} > {tol:.1e}")
    if time_it:
        C, KTr, Lb = A.shape
        esz = A.element_size()
        n_real = int(panels["row_ptr"][-1])  # dummy chunks are never read
        nbytes = (
            n_real * KTr * Lb * esz + n_real * meta.m0 * 4
            + panels["row_ptr"].numel() * 4 + ql.numel() * esz
            + meta.nl_t * KTr * esz
        )
        flops = 2.0 * n_real * KTr * Lb
        peak = PEAK_F32_FLOPS if A.dtype == torch.float32 else PEAK_F64_FLOPS
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        rec["ms"] = gpu_ms(lambda: npl.panel_matvec(panels, meta, ql), 20)
        rec["plain_ms"] = gpu_ms(
            lambda: npl.panel_matvec_reference(panels, meta, ql), 5
        )
        # yardstick: one library call on charges gathered beforehand
        xq = torch.cat([ql, torch.zeros_like(ql[:1])])
        xb = torch.nn.functional.pad(
            xq[panels["pidx"].long()].reshape(C, -1),
            (0, Lb - meta.m0 * meta.KS * meta.cdim),
        )[:, :, None].contiguous()
        rec["library_ms"] = gpu_ms(lambda: torch.bmm(A, xb), 10)
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["store_bytes"] = C * KTr * Lb * esz
        rec["real_chunks"] = n_real
        del xq, xb
    return rec


def phase_env():
    rec = {
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "gpu": nvidia_smi_line(),
        "native_host_library": native.get_lib() is not None,
    }
    emit(rec)
    return rec


def phase_kernels_small():
    """Build the kernels, then check near_panel at f32 and f64 on a small
    sphere (recursion 5: ragged leaves, dummy chunks and dummy tiles)."""
    t0 = time.time()
    _build.build(["near_panel"])
    build_s = time.time() - t0
    checks = []
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        plan, _ = build_plan(5, dtype, ncrit=32, leaf_pad=None)
        panels, meta = plan.near_panels()
        if not (panels["chunk_tgt"] == meta.nl_t).any() or not (
            panels["pidx"] == len(plan.leaf_ids)
        ).any():
            fail("small near_panel case has no dummy chunk / dummy tile")
        checks.append(check_near_panel(
            panels, meta, len(plan.leaf_ids), tol, "recursion5"
        ))
    return build_s, checks


def phase_main_path(plan, n, p=5, chain=50):
    """Chained matvecs and both solves, with the kernel's launches held
    against the number of matvecs the plan ran."""
    calls = {"matvecs": 0}
    inner = plan._matvec_slots

    def counted(*a, **k):
        calls["matvecs"] += 1
        return inner(*a, **k)

    plan._matvec_slots = counted
    torch.cuda.reset_peak_memory_stats()
    npl.panel_matvec.launches = 0  # every kernel count, just before the run

    mv, op4p, to_s, from_s, nslots = plan.solver_ops_slots()
    t0 = time.time()
    operand = op4p(p)
    torch.cuda.synchronize()
    tables_s = time.time() - t0
    ones = np.ones(n, np.float32)
    x = to_s(ones)
    for _ in range(3):
        x = mv(operand, x, p) / SPHERE_G_NORM
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    a.record()
    for _ in range(chain):
        x = mv(operand, x, p) / SPHERE_G_NORM
    b.record()
    torch.cuda.synchronize()
    chain_host_ms = (time.time() - t0) * 1e3 / chain
    chain_ms = a.elapsed_time(b) / chain
    if not torch.isfinite(x).all() or float(x.abs().max()) == 0.0:
        fail("chained matvecs gave non-finite or zero values")

    # second kind: dGdn system (flipped BC), RHS = G . 1, solution 1
    b2 = plan.apply(ones, p=p)[:, 0].cpu().numpy()
    cfg2 = fbt.SolverConfig(residual=1e-5, max_p=p, max_iters=60, restart=60)
    torch.cuda.synchronize()
    t0 = time.time()
    x2, info2, _ = solve_plan(plan, b2, cfg2, flipped=True, p_fixed=p)
    solve2_s = time.time() - t0
    err2 = float(np.linalg.norm(x2 - 1.0) / np.sqrt(n))

    # first kind: G system, RHS = dGdn . 1, solution 1; relaxed order
    b1 = plan.apply_flipped_bc(ones, p=10)[:, 0].cpu().numpy()
    cfg1 = fbt.SolverConfig(
        residual=1e-5, max_iters=100, restart=100, max_p=10, p_min=1,
        p_tiers=(3, 5, 10),
    )
    torch.cuda.synchronize()
    t0 = time.time()
    x1, info1, _ = solve_plan(plan, b1, cfg1)
    solve1_s = time.time() - t0
    err1 = float(np.linalg.norm(x1 - 1.0) / np.sqrt(n))

    launches = npl.panel_matvec.launches  # ... and read just after it
    plan._matvec_slots = inner
    rec = {
        "phase": "main_path", "n_panels": n, "nslots": nslots, "p": p,
        "tables_s": tables_s,
        "matvec_ms": chain_ms, "matvec_host_ms": chain_host_ms,
        "chain": chain,
        "second_kind": {
            "solve_s": solve2_s, "iterations": info2.iterations,
            "converged": bool(info2.converged), "residual": info2.residual,
            "solution_err": err2,
        },
        "first_kind_relaxed": {
            "solve_s": solve1_s, "iterations": info1.iterations,
            "converged": bool(info1.converged), "residual": info1.residual,
            "err": err1, "p_schedule": [int(h[2]) for h in info1.history],
        },
        "matvecs": calls["matvecs"], "near_panel_launches": launches,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if not (info2.converged and info1.converged):
        fail("a solve did not converge")
    if not (np.isfinite(x1).all() and np.isfinite(x2).all()):
        fail("a solution is not finite")
    if x1.shape != (n,) or x2.shape != (n,):
        fail("a solution has the wrong shape")
    if err2 > 5e-3 or err1 > 5e-3:
        fail(f"solution error above 5e-3: second kind {err2:.3e}, "
             f"first kind {err1:.3e}")
    if launches == 0 or launches != calls["matvecs"]:
        fail(f"near_panel launched {launches} times in "
             f"{calls['matvecs']} matvecs: the main path did not go "
             "through the kernel once per matvec")
    return rec


def phase_profile(plan, n, p=5):
    """The matvec's phases timed by CUDA events, then one matvec under
    torch.profiler: top device operations, launches, busy time."""
    mv, op4p, to_s, _, _ = plan.solver_ops_slots()
    operand = op4p(p)
    d, aux, sf, tf = operand
    x = to_s(np.ones(n, np.float32))
    mv(operand, x, p)
    torch.cuda.synchronize()

    # the matvec's phases, each alone, by CUDA events (before the
    # profiler is switched on)
    q_t = torch.where(d["s_slot_mask"], x, 0.0)
    M0 = plan._p2m_slots(d, aux, q_t, p)
    M = plan._phase_m2m(d, M0.clone())
    L0 = plan._phase_m2l(d, M, p)
    L = plan._phase_l2l(d, L0.clone())
    phase_ms = {
        "p2m": gpu_ms(lambda: plan._p2m_slots(d, aux, q_t, p), 10),
        "m2m": gpu_ms(lambda: plan._phase_m2m(d, M0.clone()), 10),
        "m2l": gpu_ms(lambda: plan._phase_m2l(d, M, p), 10),
        "l2l": gpu_ms(lambda: plan._phase_l2l(d, L0.clone()), 10),
        "l2p": gpu_ms(lambda: plan._l2p_slots(d, aux, L, p), 10),
        "m2p": gpu_ms(
            lambda: plan._m2p_pass(
                d, tf, M, p, len(plan.leaf_ids), plan.leaf_pad), 10
        ) if len(plan.m2p_src) else 0.0,
        "near": gpu_ms(lambda: plan._near_pass_slots(aux, q_t), 10),
        "matvec": gpu_ms(lambda: mv(operand, x, p), 10),
    }

    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        mv(operand, x, p)
        torch.cuda.synchronize()
        window_us = (time.time() - t0) * 1e6

    from torch.autograd import DeviceType

    def dev_us(ev):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, name):
                return float(getattr(ev, name))
        return 0.0

    by_name = {
        e.key: [dev_us(e), int(e.count)]
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    }
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    rec = {
        "phase": "profile", "p": p,
        "device_busy_us": busy_us if busy_us > 0 else None,
        # idle share of one matvec as it runs unprofiled (the profiler
        # slows the host, so its own window overstates the idle time)
        "device_idle_share": (
            max(0.0, 1.0 - busy_us / (phase_ms["matvec"] * 1e3))
            if busy_us > 0 else None
        ),
        "profiled_window_us": window_us,
        "device_launches": sum(v[1] for v in by_name.values()),
        "top_device_ops": [
            {"name": k[:120], "us": v[0], "calls": v[1]} for k, v in top
        ],
        "phase_ms": phase_ms,
    }
    rec["m2l_family_classes"] = (
        0 if plan.m2l_fam is None else len(plan.m2l_fam.cls_sp)
    )
    rec["m2p_pairs"] = int(len(plan.m2p_src))
    emit(rec)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recursions", type=int, default=8,
                    help="sphere refinement (8 = 131,072 panels)")
    args = ap.parse_args()

    env = phase_env()
    build_s, checks = phase_kernels_small()

    t0 = time.time()
    plan, n = build_plan(args.recursions, "float32")
    host_build_s = time.time() - t0
    t0 = time.time()
    panels, meta = plan.near_panels()
    torch.cuda.synchronize()
    near_store_s = time.time() - t0
    emit({
        "phase": "plan_build", "n_panels": n, "host_build_s": host_build_s,
        "near_store_s": near_store_s, "leaves": len(plan.leaf_ids),
        "leaf_pad": plan.leaf_pad, "levels": int(plan.tree.num_levels),
        "near_pairs": int(len(plan.p2p_src_slot)),
        "near_store_bytes": panels["A"].numel() * panels["A"].element_size(),
    })

    # the kernel at the shapes the main path gives it, f32 then f64
    nl = len(plan.leaf_ids)
    full = check_near_panel(panels, meta, nl, 1e-5, "main_path", time_it=True)
    panels64 = dict(panels, A=panels["A"].double())
    full64 = check_near_panel(panels64, meta, nl, 1e-12, "main_path")
    del panels64
    torch.cuda.empty_cache()
    emit({
        "phase": "kernels", "build_s": build_s,
        "nvcc_report": _build.build_logs.get("near_panel", "").strip()
        .splitlines()[-12:],
        "checks": checks + [full, full64], "launches_per_matvec": 1,
    })

    main_rec = phase_main_path(plan, n)
    phase_profile(plan, n)

    emit({"kernels": [{
        "name": "near_panel", "route": "cuda",
        "source": "fmm_bem_tpu_torch/csrc/near_panel.cu",
        "replaces": "fmm_bem_tpu/ops/near_panel.py:539",
        "launches": main_rec["near_panel_launches"],
        "max_abs_err": full["max_abs_err"],
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
    }]})
    print(env["gpu"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
