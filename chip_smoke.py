#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run as ``python3 chip_smoke.py`` from the root of a checkout.  It imports
only ``fmm_bem_tpu_torch``, builds the CUDA kernels from the sources in
the checkout (``nvcc``, first use, one process per source, all started
together), holds every kernel against its plain PyTorch version on the
card, and drives the port's paths at full size:

- the cached path: a Laplace BEM unit sphere of 131,072 panels (K=3,
  ncrit=64, leaf_pad=64, f32, max_p=10) -> ``FmmPlan`` -> 50 chained
  slot-space matvecs at p=5 -> the second-kind solve at fixed p=5 -> the
  first-kind relaxed solve with tiers (3, 5, 10); then the same sphere
  with ``near_mode="otf"``, its matvec and its first-kind solve held
  against the cached ones;
- path A, the on-the-fly near field: the same solves on 524,288 panels
  with ``near_mode="otf"`` (no cached near store), then the first-kind
  solve once more in f64 and the f32 right-hand sides against the f64
  ones;
- path B, the point kernel: one ``FmmPlan.apply`` of ``LaplaceKernel``
  (potential + force) on 1,000,000 points at p=5, held against direct
  summation on a sample of 1,000 targets;
- the Stokes path: flow past a unit sphere of 32,768 panels = 98,304
  unknowns (``StokesBEMKernel(K=4, fine_K=19, mu=1e-3)``, ncrit=64,
  leaf_pad=64, f32, max_p=10): the right-hand side through the
  double-layer variant against 4 pi, the relaxed solve at p=8 with the
  order floor of 5 and the same solve at fixed p=8, the drag against
  Stokes' law, chained matvecs at p=8 and p=5, the profile.  Its near
  field (3x3 blocks) goes through the chunk-contraction kernel.

Each path's kernel launches are counted from zero just before it is
driven and read just after.  Each phase prints one JSON line; any
failure exits non-zero.  There is no CPU fallback: without a GPU the
script fails before it prints anything.

``--quick`` runs every path at a small size (8,192 panels, 50,000
points, 2,048 Stokes panels) for a look of two minutes.
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
from fmm_bem_tpu_torch.config import default_p_tiers
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel
from fmm_bem_tpu_torch.ops import _build
from fmm_bem_tpu_torch.ops import near_panel as npl
from fmm_bem_tpu_torch.ops import otf_tile as otf
from fmm_bem_tpu_torch.ops import p2p_tile as p2p
from fmm_bem_tpu_torch.solver.api import solve_plan

#: H100 SXM data-sheet peaks the bounds are stated against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
#: special-function results (rsqrt, exp) per second: 16 per SM and clock
#: on 132 SMs at the 1.98 GHz boost clock the f32 peak is stated at
PEAK_SFU_PER_S = 132 * 16 * 1.98e9
#: arithmetic the functions need.  OTF, per (target, source panel,
#: quadrature point), by the target's BC flag: a G target needs 3
#: differences, r^2 (5), w/r (1) and one accumulation = 10 flops; a dG
#: target the normal projection (5), 1/r^2 (1) and two more products on
#: top = 18; + 1 rsqrt either way.  With kappa > 0: r, kappa r and the
#: product with the exponential (13), for dG also kappa r + 1 and its
#: product (23), + 1 exp.  Per (target, source panel) 2 more for the
#: charge.  P2P, per (target, source): 3 differences, r^2 (5), q/r (1),
#: 1/r^2 (1), q/r^3 (1), the potential sum (1) and three force
#: multiply-adds (6) = 18, + 1 rsqrt.
OTF_FLOPS = {False: (10, 18), True: (13, 23)}  # kappa > 0: (G, dG)
P2P_FLOPS = 18
#: the four kernels; their wrappers carry the launch counts
WRAPPERS = {
    "near_panel": npl.panel_matvec_fused,
    "otf_tile": otf.otf_leaf_tiles,
    "p2p_tile": p2p.p2p_leaf_tiles,
    "panel_contract": npl.panel_contract,
}
#: top eigenvalue of the single-layer operator on the unit sphere; the
#: chained matvecs are scaled by its inverse so they neither grow nor die
SPHERE_G_NORM = 4.0 * np.pi

#: limits of the on-the-fly checks, each set from a reading on an H100
#: (beside it).  At 131,072 panels the first-kind solve through the
#: on-the-fly near field takes the cached solve's iterations and orders,
#: and its error differs by 9.0 % (the operators differ by 1.1e-6 in
#: relative L2 and the first-kind system amplifies that about 200-fold)
OTF_SOLVE_ERR_REL_DIFF = 0.2
#: at 524,288 panels no cached store fits beside the on-the-fly plan, so
#: the f32 operator is held to the f64 one on the vector 1: G . 1
#: (reading 1.8e-7) and dGdn . 1 (9.7e-6: the f32 double layer loses
#: digits in d . n on a smooth surface), relative L2
OTF_RHS_F32_LIMIT = {"G.1 (p=5)": 1e-6, "dGdn.1 (p=10)": 3e-5}
#: the f64 first-kind solve there meets the 5e-3 of every other solve
#: (2.33e-3 in 5 iterations); the f32 one fits a right-hand side whose
#: rounding noise is as large as the 1e-5 residual it is asked for,
#: takes 8 iterations and ends at 5.506e-3, relaxed or at fixed p=10
OTF_FIRST_KIND_ERR_LIMIT = 7e-3

#: the Stokes path: the reference program's operating point
#: (examples/stokes_bem.py: K=4, K_fine=19, mu=1e-3, p=8, p_min=5,
#: residual 1e-5, tiers default_p_tiers(8))
STOKES_MU = 1e-3
STOKES_P, STOKES_P_MIN = 8, 5
#: limits of its two physical checks.  Both started from the 5e-2 the
#: JAX package's own test accepts at 128 panels (tests/test_bem_stokes.py)
#: and are set from readings on an NVIDIA H100 80GB HBM3 (700.00 W), f32:
#: ``rhs_err`` 1.20e-4 at 32,768 panels and 9.2e-5 at 2,048 (order-8
#: truncation, it does not fall with N); the drag error 1.35e-4 at 32,768
#: panels, relaxed and at fixed p=8 alike, and 2.25e-3 at 2,048 (the flat
#: panels' error, it falls with 1/N: the limit is for 32,768 panels and
#: is scaled by 32,768 / n below that)
STOKES_RHS_ERR_LIMIT = 5e-4
STOKES_DRAG_ERR_LIMIT = 5e-4
#: a host build (tree, lists, near entries) this long at 32,768 panels
#: predicts more than two minutes at four times the panels: the larger
#: sphere is then not run
STOKES_REC8_HOST_BUDGET_S = 120.0

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


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def build_plan(recursions, dtype, ncrit=64, leaf_pad=64, near_mode="cached",
               fields=None):
    if fields is None:
        fields = make_panels(unit_sphere(recursions), K=3)
    plan = fbt.FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        fbt.FMMConfig(ncrit=ncrit, dtype=dtype, max_p=10, leaf_pad=leaf_pad,
                      near_mode=near_mode),
        device=DEV,
    )
    return plan, len(fields["xyz"])


def leaf_charges(plan, dtype, seed=11):
    """Seeded charge tiles [nl, K] on the card, padded slots zero."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    ql = torch.randn(
        (len(plan.leaf_ids), plan.leaf_pad), generator=gen, dtype=dtype,
        device=DEV,
    )
    mask = torch.as_tensor(plan.src.leaf_body_mask, device=DEV)
    return ql * mask, mask


def pair_evaluations(plan):
    """Kernel evaluations the near pairs of ``plan`` need: the sum over
    pairs of (bodies of the target leaf) x (bodies of the source leaf),
    padded slots not counted."""
    cnt = plan.src.leaf_body_mask.sum(axis=1).astype(np.int64)
    return int((cnt[plan.p2p_tgt_slot] * cnt[plan.p2p_src_slot]).sum())


def otf_needed_work(plan, tgt_tab, kappa):
    """(evaluations, flops, special-function results) the on-the-fly
    product needs on this target table: per near pair the real targets
    of each BC flag times the real source panels times KQ, a G target
    at the G count and a dG target at the dG count."""
    KQ = plan._otf_KQ
    real = tgt_tab[:-1, 0] < 0.5 * p2p.SENTINEL
    is_g = tgt_tab[:-1, 3] == 0
    n_g = (real & is_g).sum(dim=1).cpu().numpy().astype(np.int64)
    n_dg = (real & ~is_g).sum(dim=1).cpu().numpy().astype(np.int64)
    n_src = plan.src.leaf_body_mask.sum(axis=1).astype(np.int64)
    n_src = n_src[plan.p2p_src_slot]
    pairs_g = int((n_g[plan.p2p_tgt_slot] * n_src).sum())
    pairs_dg = int((n_dg[plan.p2p_tgt_slot] * n_src).sum())
    f_g, f_dg = OTF_FLOPS[bool(kappa)]
    evals = (pairs_g + pairs_dg) * KQ
    flops = KQ * (pairs_g * f_g + pairs_dg * f_dg) + 2 * (pairs_g + pairs_dg)
    return evals, flops, evals * (2 if kappa else 1), pairs_dg * KQ


def arithmetic_bound(rec, nbytes, flops, sfu, dtype):
    """bound_ms: the largest of bytes over the memory rate, flops over
    the peak rate of the type and special-function results over theirs."""
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_F64_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / peak * 1e3
    t_sfu = sfu / PEAK_SFU_PER_S * 1e3
    rec["bound_ms"] = max(t_bytes, t_flops, t_sfu)
    rec["bound_by"] = "bytes" if t_bytes >= max(t_flops, t_sfu) else "operations"
    rec["bound_terms_ms"] = {"bytes": t_bytes, "flops": t_flops, "sfu": t_sfu}


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_otf_tile(plan, ot, ql, kappa, tol, label, time_it=False):
    """The otf_tile kernel against its plain version on the card.  The
    f32 tolerance is stated relative to the output's largest value: the
    kernel inverts r with rsqrtf (2 ulp) where the plain version takes
    sqrt and divides, and the two add a leaf's K * KQ * pairs terms in
    another order; f64 differs by the order of the sums alone."""
    args = (ot["sb_src"], ql, ot["sb_tgt"], ot["row_ptr"], ot["sslot"],
            plan._otf_KQ)
    got = otf.otf_leaf_tiles(*args, kappa=kappa)
    torch.cuda.synchronize()
    want = otf.otf_leaf_tiles_reference(*args, kappa=kappa)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"otf_tile[{label}]: bad output {tuple(got.shape)} "
             "(every element must be finite, padded slots included)")
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    rec = {
        "kernel": "otf_tile", "case": label,
        "dtype": str(ql.dtype).replace("torch.", ""), "kappa": kappa,
        "tiles": list(ot["sb_src"].shape), "near_pairs": len(plan.p2p_src_slot),
        "max_abs_err": max_abs, "rel_err": rel, "tol": tol,
        "all_finite": True,
    }
    if rel > tol:
        emit(rec)
        fail(f"otf_tile[{label}] disagrees with its plain version: "
             f"rel {rel:.3e} > {tol:.1e}")
    if time_it:
        evals, flops, sfu, evals_dg = otf_needed_work(
            plan, ot["sb_tgt"], kappa)
        if evals != pair_evaluations(plan) * plan._otf_KQ:
            fail("the target table's real slots are not the plan's bodies")
        arithmetic_bound(rec, nbytes_of(*args[:5], got), flops, sfu, ql.dtype)
        rec["kernel_evaluations"] = evals
        rec["kernel_evaluations_dG"] = evals_dg
        rec["ms"] = gpu_ms(lambda: otf.otf_leaf_tiles(*args, kappa=kappa), 10)
        rec["plain_ms"] = gpu_ms(
            lambda: otf.otf_leaf_tiles_reference(*args, kappa=kappa), 2, 1)
        rec["library_ms"] = None  # no single PyTorch call computes this
    return rec


def check_p2p_tile(plan, d, ql, tol, label, time_it=False):
    """The p2p_tile kernel against its plain version on the card, per
    result component (potential, fx, fy, fz) relative to that
    component's largest value: f32 differs by rsqrtf against sqrt and a
    division, and by the order in which a leaf's sources are added."""
    nl, K = ql.shape
    xyzq = p2p.pack_xyzq(d["p2p_xyz3"].to(ql.dtype), ql[:, None, :])
    args = (xyzq, d["p2p_row_ptr"], d["p2p_src_sorted"], plan.kernel.eps2)
    got = p2p.p2p_leaf_tiles(*args)
    torch.cuda.synchronize()
    want = p2p.p2p_leaf_tiles_reference(*args)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"p2p_tile[{label}]: bad output {tuple(got.shape)} "
             "(every element must be finite, padded slots included)")
    err = (got - want).abs().amax(dim=(0, 2))
    scale = want.abs().amax(dim=(0, 2))
    max_abs = float(err.max())
    rel = float((err / scale).max())
    rec = {
        "kernel": "p2p_tile", "case": label,
        "dtype": str(ql.dtype).replace("torch.", ""),
        "tiles": list(xyzq.shape), "near_pairs": len(plan.p2p_src_slot),
        "max_abs_err": max_abs, "rel_err": rel, "tol": tol,
        "all_finite": True,
    }
    if rel > tol:
        emit(rec)
        fail(f"p2p_tile[{label}] disagrees with its plain version: "
             f"rel {rel:.3e} > {tol:.1e}")
    if time_it:
        evals = pair_evaluations(plan)
        arithmetic_bound(
            rec, nbytes_of(*args[:3], got), evals * P2P_FLOPS, evals,
            ql.dtype,
        )
        rec["kernel_evaluations"] = evals
        rec["ms"] = gpu_ms(lambda: p2p.p2p_leaf_tiles(*args), 10)
        rec["plain_ms"] = gpu_ms(
            lambda: p2p.p2p_leaf_tiles_reference(*args), 2, 1)
        rec["library_ms"] = None  # no single PyTorch call computes this
    return rec


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
        "kernel": "near_panel", "case": label,
        "dtype": str(A.dtype).replace("torch.", ""),
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
        xb = npl.chunk_charge_rows(panels, ql)[:, :, None].contiguous()
        rec["library_ms"] = gpu_ms(lambda: torch.bmm(A, xb), 10)
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["store_bytes"] = C * KTr * Lb * esz
        rec["real_chunks"] = n_real
        del xb
    return rec


def check_panel_contract(panels, meta, nl_src, tol, label, time_it=False):
    """The panel_contract kernel against its plain version on the card,
    on the chunk rows gathered from a seeded charge table, and the whole
    two-stage route against the plain near-field product, twice (the
    segment sums take no atomics: the bits must repeat).  The f32
    tolerance is relative to the output's largest value: both sides add
    a row's Lb products in another order.  Optionally timed beside its
    plain version, ``torch.bmm``, its bound, the whole two-stage route
    and the fused ``near_panel`` kernel on the same store."""
    A = panels["A"]
    C, KTr, Lb = A.shape
    KSc = meta.KS * meta.cdim
    gen = torch.Generator(device=DEV).manual_seed(11)
    ql = torch.randn((nl_src, KSc), generator=gen, dtype=A.dtype, device=DEV)
    xb = npl.chunk_charge_rows(panels, ql)
    got = npl.panel_contract(A, xb)
    torch.cuda.synchronize()
    want = npl.panel_contract_reference(A, xb)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"panel_contract[{label}]: bad output {tuple(got.shape)}")
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    two = npl.panel_matvec_two_stage(panels, meta, ql)
    again = npl.panel_matvec_two_stage(panels, meta, ql)
    ref = npl.panel_matvec_reference(panels, meta, ql)
    two_rel = float((two - ref).abs().max() / ref.abs().max())
    n_real = int(panels["row_ptr"][-1])
    rec = {
        "kernel": "panel_contract", "case": label,
        "dtype": str(A.dtype).replace("torch.", ""),
        "A_shape": list(A.shape), "m0": meta.m0, "nl_t": meta.nl_t,
        "rdim": meta.rdim, "cdim": meta.cdim,
        "dummy_chunks": C - n_real, "pad_columns": Lb - meta.m0 * KSc,
        "max_abs_err": max_abs, "rel_err": rel, "tol": tol,
        "two_stage_rel_err": two_rel,
        "two_stage_bit_equal": bool(torch.equal(two, again)),
    }
    if rel > tol or two_rel > tol or not rec["two_stage_bit_equal"]:
        emit(rec)
        fail(f"panel_contract[{label}]: kernel rel {rel:.3e}, two-stage "
             f"route rel {two_rel:.3e} (limit {tol:.1e}), bit-equal "
             f"{rec['two_stage_bit_equal']}")
    if time_it:
        # each input read once, the output written once; dummy chunks
        # are computed like any other, so the whole store counts
        arithmetic_bound(
            rec, nbytes_of(A, xb, got), 2.0 * C * KTr * Lb, 0, A.dtype)
        rec["ms"] = gpu_ms(lambda: npl.panel_contract(A, xb), 20)
        rec["plain_ms"] = gpu_ms(
            lambda: npl.panel_contract_reference(A, xb), 5)
        x3 = xb[:, :, None].contiguous()
        rec["library_ms"] = gpu_ms(lambda: torch.bmm(A, x3), 10)
        del x3
        rec["two_stage_ms"] = gpu_ms(
            lambda: npl.panel_matvec_two_stage(panels, meta, ql), 20)
        # the fused kernel has no size limit: the same store through it
        # (gather, contraction and per-leaf sum in one launch)
        fused = npl.panel_matvec_fused(panels, meta, ql)
        rec["fused_near_panel_rel_err"] = float(
            (fused - ref).abs().max() / ref.abs().max())
        rec["fused_near_panel_ms"] = gpu_ms(
            lambda: npl.panel_matvec_fused(panels, meta, ql), 20)
        rec["store_bytes"] = nbytes_of(A)
        rec["real_chunks"] = n_real
        if rec["fused_near_panel_rel_err"] > tol:
            emit(rec)
            fail(f"near_panel on the store of [{label}] disagrees with "
                 "the plain near-field product")
    return rec


def stokes_plan(recursions, dtype, ncrit=64, leaf_pad=64):
    """``StokesBEMKernel`` plan on the unit sphere at the reference
    program's operating point.  Returns (plan, fields, n, seconds of
    the host's near-entry assembly inside the plan build)."""
    fields = make_panels(unit_sphere(recursions), K=4)
    kern = StokesBEMKernel(K=4, fine_K=19, mu=STOKES_MU)
    timer = {"s": 0.0}
    assemble = kern.near_values

    def timed(*a):
        t0 = time.time()
        out = assemble(*a)
        timer["s"] += time.time() - t0
        return out

    kern.near_values = timed
    plan = fbt.FmmPlan(
        kern, fields,
        fbt.FMMConfig(ncrit=ncrit, dtype=dtype, max_p=10, leaf_pad=leaf_pad),
        device=DEV,
    )
    return plan, fields, len(fields["xyz"]), timer["s"]


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


def point_plan(n, seed, dtype="float32", ncrit=64):
    """``LaplaceKernel`` plan on n points uniform in the unit cube, with
    unit-mean random charges, both from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n, 3))
    q = rng.uniform(0.5, 1.5, n)
    plan = fbt.FmmPlan(
        LaplaceKernel(), {"xyz": pts},
        fbt.FMMConfig(ncrit=ncrit, dtype=dtype, max_p=5), device=DEV,
    )
    return plan, pts, q


def phase_kernels_small():
    """Build the four kernels, then check each at f32 and f64 on a small
    problem with ragged leaves: near_panel (dummy chunks and dummy
    tiles), otf_tile (kappa 0 and 0.5, both BC flags) on a recursion-5
    sphere, p2p_tile on 20,000 points, panel_contract and the two-stage
    route on the scalar store of that sphere and on both 3x3-block
    stores of a recursion-4 Stokes sphere."""
    t0 = time.time()
    _build.build(sorted(WRAPPERS))
    build_s = time.time() - t0
    checks = []
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        tdt = fbt.torch_dtype(dtype)
        plan, _ = build_plan(5, dtype, ncrit=32, leaf_pad=None)
        panels, meta = plan.near_panels()
        if not (panels["chunk_tgt"] == meta.nl_t).any() or not (
            panels["pidx"] == len(plan.leaf_ids)
        ).any():
            fail("small near_panel case has no dummy chunk / dummy tile")
        checks.append(check_near_panel(
            panels, meta, len(plan.leaf_ids), tol, "recursion5"
        ))
        contract = [check_panel_contract(
            panels, meta, len(plan.leaf_ids), tol, "recursion5_scalar"
        )]
        splan, _, _, _ = stokes_plan(4, dtype, ncrit=32, leaf_pad=None)
        for bc, fh in (("bc0", None), ("bc1", splan._flipped_fields())):
            spanels, smeta = splan.near_panels(fh)
            contract.append(check_panel_contract(
                spanels, smeta, len(splan.leaf_ids), tol,
                f"stokes_recursion4_{bc}"
            ))
        if not any(c["dummy_chunks"] for c in contract) or not any(
            c["pad_columns"] for c in contract
        ):
            fail("small panel_contract cases have no dummy chunk / no "
                 "pad column")
        checks.extend(contract)
        del splan, spanels
        oplan, _ = build_plan(5, dtype, ncrit=32, leaf_pad=None,
                              near_mode="otf")
        ql, mask = leaf_charges(oplan, tdt)
        if bool(mask.all()):
            fail("small otf_tile case has no padded slot")
        for bc, fh in (("bc0", None), ("bc1", oplan._flipped_fields())):
            ot = oplan.near_panels(fh)[0]["otf_tiles"]
            for kappa in (0.0, 0.5):
                checks.append(check_otf_tile(
                    oplan, ot, ql, kappa, tol, f"recursion5_{bc}"
                ))
        pplan, _, _ = point_plan(20000, 5, dtype, ncrit=32)
        ql, mask = leaf_charges(pplan, tdt)
        if bool(mask.all()):
            fail("small p2p_tile case has no padded slot")
        checks.append(check_p2p_tile(
            pplan, pplan.device_data(5), ql, tol, "points20000"
        ))
    return build_s, checks


def first_kind_solve(plan, n, p_fixed=None):
    """The first-kind solve on the sphere: G system, RHS = dGdn . 1 at
    p=10, solution 1; relaxed order with tiers (3, 5, 10), or the fixed
    order ``p_fixed``.  Returns (record, solution, RHS)."""
    ones = np.ones(n, np.dtype(plan.config.dtype))
    b1 = plan.apply_flipped_bc(ones, p=10)[:, 0].cpu().numpy()
    cfg1 = fbt.SolverConfig(
        residual=1e-5, max_iters=100, restart=100, max_p=10, p_min=1,
        p_tiers=(3, 5, 10),
    )
    torch.cuda.synchronize()
    t0 = time.time()
    x1, info1, _ = solve_plan(plan, b1, cfg1, p_fixed=p_fixed)
    rec = {
        "solve_s": time.time() - t0, "iterations": info1.iterations,
        "converged": bool(info1.converged), "residual": info1.residual,
        "err": float(np.linalg.norm(x1 - 1.0) / np.sqrt(n)),
        "p_schedule": [int(h[2]) for h in info1.history],
    }
    return rec, x1, b1


def phase_main_path(plan, n, p=5, chain=50, phase="main_path",
                    kernel="near_panel", err1_limit=5e-3, baseline_p=None):
    """Chained matvecs and both solves of a BEM plan, with the launches
    of the path's near-field kernel held against the number of matvecs
    the plan ran.  ``baseline_p`` adds the first-kind solve at that fixed
    order beside the relaxed one.  Returns (record, first-kind solution,
    first-kind RHS, second-kind RHS)."""
    calls = {"matvecs": 0}
    inner = plan._matvec_slots

    def counted(*a, **k):
        calls["matvecs"] += 1
        return inner(*a, **k)

    plan._matvec_slots = counted
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # every kernel count, just before the run

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
    first, x1, b1 = first_kind_solve(plan, n)
    err1 = first["err"]
    fixed = None
    if baseline_p is not None:
        fixed = first_kind_solve(plan, n, p_fixed=baseline_p)[0]
        fixed["p"] = baseline_p

    counts = launch_counts()  # ... and read just after it
    launches = counts[kernel]
    plan._matvec_slots = inner
    rec = {
        "phase": phase, "near_mode": plan.config.near_mode,
        "n_panels": n, "nslots": nslots, "p": p,
        "tables_s": tables_s,
        "matvec_ms": chain_ms, "matvec_host_ms": chain_host_ms,
        "chain": chain,
        "second_kind": {
            "solve_s": solve2_s, "iterations": info2.iterations,
            "converged": bool(info2.converged), "residual": info2.residual,
            "solution_err": err2,
        },
        "first_kind_relaxed": first,
        "first_kind_fixed": fixed,
        "matvecs": calls["matvecs"], "kernel": kernel,
        "kernel_launches": launches, "launch_counts": counts,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if not (info2.converged and first["converged"]):
        fail("a solve did not converge")
    if not (np.isfinite(x1).all() and np.isfinite(x2).all()):
        fail("a solution is not finite")
    if x1.shape != (n,) or x2.shape != (n,):
        fail("a solution has the wrong shape")
    if err2 > 5e-3 or err1 > err1_limit:
        fail(f"solution error above its limit: second kind {err2:.3e} "
             f"(5e-3), first kind {err1:.3e} ({err1_limit:.0e})")
    others = sum(v for k, v in counts.items() if k != kernel)
    if launches == 0 or launches != calls["matvecs"] or others:
        fail(f"{kernel} launched {launches} times in {calls['matvecs']} "
             f"matvecs (all counts: {counts}): the path did not go "
             "through its kernel, and no other, once per matvec")
    return rec, x1, b1, b2


def phase_profile(plan, charges, p=5, phase="profile"):
    """The matvec's phases timed by CUDA events, then one matvec under
    torch.profiler: top device operations, launches, busy time."""
    mv, op4p, to_s, _, _ = plan._slot_ops(None)
    operand = op4p(p)
    d, aux, sf, tf = operand
    x = to_s(charges)
    mv(operand, x, p)
    torch.cuda.synchronize()
    nl, K = len(plan.leaf_ids), plan.leaf_pad

    # the matvec's phases, each alone, by CUDA events (before the
    # profiler is switched on)
    cdim = getattr(plan.kernel, "charge_dim", 1)
    if cdim > 1:
        q_t = torch.where(d["s_slot_mask"][:, None], x.reshape(-1, cdim), 0.0)
    else:
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
        "m2p": gpu_ms(lambda: plan._m2p_pass(d, tf, M, p, nl, K), 10)
        if len(plan.m2p_src) else 0.0,
        "near": gpu_ms(lambda: plan._near_pass_slots(aux, q_t), 10)
        if "panels" in aux
        else gpu_ms(lambda: plan._p2p_pass(d, sf, tf, q_t, nl, K), 10),
        "matvec": gpu_ms(lambda: mv(operand, x, p), 10),
    }
    if plan._otf_near:
        ql = q_t.reshape(nl, K)
        phase_ms["near_corrections"] = gpu_ms(
            lambda: plan._near_otf_corr(aux["panels"], ql, ql), 10)

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
        "phase": phase, "p": p,
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


def emit_plan_build(phase, plan, n, host_build_s, **extra):
    emit({
        "phase": phase, "n_bodies": n, "host_build_s": host_build_s,
        "leaves": len(plan.leaf_ids), "leaf_pad": plan.leaf_pad,
        "levels": int(plan.tree.num_levels),
        "near_pairs": int(len(plan.p2p_src_slot)),
        "m2p_pairs": int(len(plan.m2p_src)), **extra,
    })


def kernel_entry(name, replaces, rec, launches):
    return {
        "name": name, "route": "cuda",
        "source": f"fmm_bem_tpu_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    }


def path_cached(recursions):
    """The cached near field: the kernel at the path's shapes, the
    chained matvecs and both solves, the profile; then the same sphere
    with the on-the-fly near field, matvec against matvec and first-kind
    solve against first-kind solve."""
    fields = make_panels(unit_sphere(recursions), K=3)
    t0 = time.time()
    plan, n = build_plan(recursions, "float32", fields=fields)
    host_build_s = time.time() - t0
    t0 = time.time()
    panels, meta = plan.near_panels()
    torch.cuda.synchronize()
    emit_plan_build(
        "plan_build", plan, n, host_build_s, near_store_s=time.time() - t0,
        near_store_bytes=nbytes_of(panels["A"]),
    )
    nl = len(plan.leaf_ids)
    full = check_near_panel(panels, meta, nl, 1e-5, "main_path", time_it=True)
    panels64 = dict(panels, A=panels["A"].double())
    full64 = check_near_panel(panels64, meta, nl, 1e-12, "main_path")
    del panels64
    torch.cuda.empty_cache()
    main_rec, x1, _, _ = phase_main_path(plan, n)
    phase_profile(plan, np.ones(n, np.float32))

    # the on-the-fly operator on the same sphere and the same charges
    oplan, _ = build_plan(recursions, "float32", near_mode="otf",
                          fields=fields)
    q = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = plan.apply(q, p=5)
    got = oplan.apply(q, p=5)
    want_f = plan.apply_flipped_bc(q, p=5)
    got_f = oplan.apply_flipped_bc(q, p=5)
    store = oplan.near_panels()[0]
    rec = {
        "phase": "otf_vs_cached", "n_panels": n, "p": 5,
        "rel_max_diff": float((got - want).abs().max() / want.abs().max()),
        "rel_l2_diff": float((got - want).norm() / want.norm()),
        "rel_max_diff_flipped": float(
            (got_f - want_f).abs().max() / want_f.abs().max()),
        "rel_l2_diff_flipped": float((got_f - want_f).norm() / want_f.norm()),
        "otf_store_bytes": nbytes_of(
            *[v for k, v in store.items() if k != "otf_tiles"],
            *store["otf_tiles"].values(),
        ),
        "cached_store_bytes": nbytes_of(panels["A"]),
        # f32: the host takes the deltas against its f64 regular
        # quadrature, the card recomputes that quadrature in f32
        "limit": 1e-4,
    }
    # ... and the first-kind solve through it beside the cached one: the
    # deltas are stored in f32 against a regular part recomputed in f32,
    # and a fault there would show as other iterations or another error
    cached1 = main_rec["first_kind_relaxed"]
    otf1, xo, _ = first_kind_solve(oplan, n)
    rec["first_kind_cached"] = cached1
    rec["first_kind_otf"] = otf1
    rec["solution_rms_diff"] = float(np.linalg.norm(xo - x1) / np.sqrt(n))
    rec["err_rel_diff"] = abs(otf1["err"] - cached1["err"]) / cached1["err"]
    rec["err_rel_diff_limit"] = OTF_SOLVE_ERR_REL_DIFF
    emit(rec)
    worst = max(rec["rel_max_diff"], rec["rel_max_diff_flipped"])
    if not worst <= rec["limit"]:
        fail("the on-the-fly matvec is not the cached matvec")
    if not otf1["converged"] or (
        otf1["iterations"] != cached1["iterations"]
        or otf1["p_schedule"] != cached1["p_schedule"]
        or not rec["err_rel_diff"] <= OTF_SOLVE_ERR_REL_DIFF
    ):
        fail("the first-kind solve through the on-the-fly near field is "
             "not the one through the cached near field: "
             f"{otf1} against {cached1}")
    return [full, full64], kernel_entry(
        "near_panel", "fmm_bem_tpu/ops/near_panel.py:539", full,
        main_rec["kernel_launches"],
    )


def path_otf(recursions):
    """Path A: the BEM solves with ``near_mode="otf"``."""
    torch.cuda.empty_cache()
    t0 = time.time()
    plan, n = build_plan(recursions, "float32", near_mode="otf")
    host_build_s = time.time() - t0
    t0 = time.time()
    store = plan.near_panels()[0]
    torch.cuda.synchronize()
    ot = store["otf_tiles"]
    emit_plan_build(
        "otf_plan_build", plan, n, host_build_s,
        near_store_s=time.time() - t0,
        correction_entries=int(len(plan.near_rows)),
        correction_store_bytes=nbytes_of(
            *[v for k, v in store.items() if k != "otf_tiles"]),
        tile_bytes=nbytes_of(*ot.values()),
    )
    ql, _ = leaf_charges(plan, torch.float32)
    full = check_otf_tile(plan, ot, ql, 0.0, 1e-5, "otf_path", time_it=True)
    yukawa = check_otf_tile(plan, ot, ql, 0.5, 1e-5, "otf_path_kappa0.5",
                            time_it=True)
    ot64 = {k: v.double() if v.is_floating_point() else v
            for k, v in ot.items()}
    full64 = check_otf_tile(plan, ot64, ql.double(), 0.0, 1e-12, "otf_path")
    del ot64
    torch.cuda.empty_cache()
    main_rec, _, b1, b2 = phase_main_path(
        plan, n, chain=20, phase="otf_path", kernel="otf_tile",
        err1_limit=OTF_FIRST_KIND_ERR_LIMIT, baseline_p=10)
    phase_profile(plan, np.ones(n, np.float32), phase="otf_profile")
    del plan, store, ot, ql
    phase_otf_f64(recursions, n, main_rec, b1, b2)
    return [full, yukawa, full64], kernel_entry(
        "otf_tile", "fmm_bem_tpu/ops/otf_tile.py:80", full,
        main_rec["kernel_launches"],
    )


def phase_otf_f64(recursions, n, main_rec, b1, b2):
    """The on-the-fly operator in f64 on the sphere of path A: what the
    f32 one is held to where no cached store fits beside it.  Both f32
    right-hand sides (G . 1 and dGdn . 1, whole matvecs through the f32
    tiles and the f32 delta store) against the f64 ones, and the
    first-kind relaxed solve once more in f64."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plan, _ = build_plan(recursions, "float64", near_mode="otf")
    b2_64 = plan.apply(np.ones(n), p=5)[:, 0].cpu().numpy()
    first64, _, b1_64 = first_kind_solve(plan, n)
    first32 = main_rec["first_kind_relaxed"]
    rec = {
        "phase": "otf_f64", "n_panels": n,
        "first_kind_relaxed_f64": first64,
        "first_kind_relaxed_f32": first32,
        "rhs_f32_vs_f64_rel_l2": {
            "G.1 (p=5)": float(
                np.linalg.norm(b2 - b2_64) / np.linalg.norm(b2_64)),
            "dGdn.1 (p=10)": float(
                np.linalg.norm(b1 - b1_64) / np.linalg.norm(b1_64)),
        },
        "rhs_limit": OTF_RHS_F32_LIMIT,
        "first_kind_err_limit": {"f64": 5e-3,
                                 "f32": OTF_FIRST_KIND_ERR_LIMIT},
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if not first64["converged"] or first64["err"] > 5e-3:
        fail(f"the f64 first-kind solve: {first64}")
    if any(v > OTF_RHS_F32_LIMIT[k]
           for k, v in rec["rhs_f32_vs_f64_rel_l2"].items()):
        fail("the f32 on-the-fly matvec is not the f64 one: "
             f"{rec['rhs_f32_vs_f64_rel_l2']}")


def sample_errors(plan, pts, q, result, nsample=1000, seed=17):
    """Relative L2 error of potential and of force against direct
    summation in f64 on a seeded sample of targets."""
    idx = np.random.default_rng(seed).choice(len(pts), nsample, replace=False)
    src = torch.as_tensor(pts, dtype=torch.float64, device=DEV)
    exact = plan.kernel.direct(
        src[torch.as_tensor(idx, device=DEV)], src,
        torch.as_tensor(q, dtype=torch.float64, device=DEV), chunk=50,
    )
    got = result[torch.as_tensor(idx, device=DEV)].double()
    return (
        float((got[:, 0] - exact[:, 0]).norm() / exact[:, 0].norm()),
        float((got[:, 1:] - exact[:, 1:]).norm() / exact[:, 1:].norm()),
    )


def path_points(npoints, nbase):
    """Path B: one ``apply`` of the point Laplace kernel at p=5, against
    direct summation on a sample.  The limit is three times the error
    the same order shows on ``nbase`` points, which is its truncation
    error: the expansions are cut at the same p, only the tree is
    deeper."""
    torch.cuda.empty_cache()
    base, bpts, bq = point_plan(nbase, 31)
    base_err = sample_errors(base, bpts, bq, base.apply(bq, p=5))
    del base

    t0 = time.time()
    plan, pts, q = point_plan(npoints, 32)
    host_build_s = time.time() - t0
    emit_plan_build("points_plan_build", plan, npoints, host_build_s)
    ql, _ = leaf_charges(plan, torch.float32)
    d = plan.device_data(5)
    full = check_p2p_tile(plan, d, ql, 1e-5, "points_path", time_it=True)
    full64 = check_p2p_tile(plan, d, ql.double(), 1e-12, "points_path")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # every kernel count, just before the run
    t0 = time.time()
    out = plan.apply(q, p=5)
    torch.cuda.synchronize()
    first_apply_s = time.time() - t0
    counts = launch_counts()  # ... and read just after it
    apply_ms = gpu_ms(lambda: plan.apply(q, p=5), 5, 1)
    err_pot, err_force = sample_errors(plan, pts, q, out)
    rec = {
        "phase": "points_path", "n_points": npoints, "p": 5,
        "first_apply_s": first_apply_s, "apply_ms": apply_ms,
        "rel_l2_err_potential": err_pot, "rel_l2_err_force": err_force,
        "sample": 1000,
        "truncation_err_at": {"n_points": nbase, "potential": base_err[0],
                              "force": base_err[1]},
        "limit": {"potential": 3 * base_err[0], "force": 3 * base_err[1]},
        "launch_counts": counts,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if out.shape != (npoints, 4) or not torch.isfinite(out).all():
        fail("the point result is not finite values of shape [n, 4]")
    if err_pot > 3 * base_err[0] or err_force > 3 * base_err[1]:
        fail(f"point errors {err_pot:.3e} / {err_force:.3e} above three "
             f"times the truncation error {base_err}")
    if counts != {**dict.fromkeys(WRAPPERS, 0), "p2p_tile": 1}:
        fail(f"one apply launched {counts}: the point path did not go "
             "through p2p_tile once, and no other kernel")
    phase_profile(plan, q, phase="points_profile")
    return [full, full64], kernel_entry(
        "p2p_tile", "fmm_bem_tpu/ops/p2p_tile.py:180", full,
        counts["p2p_tile"],
    )


def stokes_solve(plan, fields, n, p_fixed=None):
    """Uniform flow past the sphere: the single-layer system on
    b = (4 pi, 0, 0), relaxed with the order floor and the tiers of the
    reference program, or at the fixed order ``p_fixed``; the drag
    sum(t_x * area) against Stokes' law 6 pi mu."""
    b = np.tile([4.0 * np.pi, 0.0, 0.0], (n, 1)).reshape(-1)
    cfg = fbt.SolverConfig(
        residual=1e-5, max_iters=200, restart=200, max_p=STOKES_P,
        p_min=STOKES_P_MIN, p_tiers=default_p_tiers(STOKES_P),
    )
    torch.cuda.synchronize()
    t0 = time.time()
    x, info, _ = solve_plan(plan, b, cfg, p_fixed=p_fixed)
    solve_s = time.time() - t0
    exact = 6.0 * np.pi * STOKES_MU
    ok_shape = x.shape == (3 * n,) and bool(np.isfinite(x).all())
    fx = float((x.reshape(n, 3)[:, 0] * fields["area"]).sum()) if ok_shape \
        else float("nan")
    return {
        "solve_s": solve_s, "iterations": info.iterations,
        "converged": bool(info.converged), "residual": info.residual,
        "p_schedule": [int(h[2]) for h in info.history],
        "finite_and_shaped": ok_shape,
        "drag": fx, "drag_exact": exact, "drag_err": abs(fx - exact) / exact,
    }


def phase_stokes_path(plan, fields, n, chain, phase):
    """The Stokes path through the entry points a user calls: the
    right-hand side by ``apply_flipped_bc``, both solves by
    ``solve_plan``, chained slot matvecs at the solve's order and at the
    floor; the launches of ``panel_contract`` held against the matvecs
    the plan ran."""
    calls = {"matvecs": 0}
    inner = plan._matvec_slots

    def counted(*a, **k):
        calls["matvecs"] += 1
        return inner(*a, **k)

    plan._matvec_slots = counted
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # every kernel count, just before the run

    u = np.tile([1.0, 0.0, 0.0], (n, 1))
    t0 = time.time()
    rhs = plan.apply_flipped_bc(u, p=STOKES_P).cpu().numpy()
    rhs_s = time.time() - t0
    rhs_err = float(np.abs(rhs[:, 0] - 4 * np.pi).mean() / (4 * np.pi))

    t0 = time.time()
    mv, op4p, to_s, _, nslots = plan.solver_ops_slots()
    op4p(STOKES_P)
    torch.cuda.synchronize()
    tables_s = time.time() - t0
    relaxed = stokes_solve(plan, fields, n)
    fixed = stokes_solve(plan, fields, n, p_fixed=STOKES_P)

    matvec_ms = {}
    for p in (STOKES_P, STOKES_P_MIN):
        operand = op4p(p)
        x = to_s(u)
        for _ in range(2):
            y = mv(operand, x, p)
            x = y / torch.linalg.vector_norm(y)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(chain):
            y = mv(operand, x, p)
            x = y / torch.linalg.vector_norm(y)
        b.record()
        torch.cuda.synchronize()
        matvec_ms[f"p{p}"] = a.elapsed_time(b) / chain
        if not torch.isfinite(x).all() or float(x.abs().max()) == 0.0:
            fail("chained Stokes matvecs gave non-finite or zero values")

    counts = launch_counts()  # ... and read just after it
    plan._matvec_slots = inner
    drag_limit = STOKES_DRAG_ERR_LIMIT * max(1.0, 32768 / n)
    rec = {
        "phase": phase, "n_panels": n, "unknowns": 3 * n, "nslots": nslots,
        "p": STOKES_P, "p_min": STOKES_P_MIN, "mu": STOKES_MU,
        "rhs_s": rhs_s, "tables_s": tables_s,
        "rhs_err": rhs_err, "rhs_err_limit": STOKES_RHS_ERR_LIMIT,
        "rhs_off_axis_max": float(np.abs(rhs[:, 1:]).max()),
        "relaxed": relaxed, "fixed_p": fixed,
        "drag_err_limit": drag_limit,
        "matvec_ms": matvec_ms, "chain": chain,
        "matvecs": calls["matvecs"], "kernel": "panel_contract",
        "kernel_launches": counts["panel_contract"], "launch_counts": counts,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if rhs.shape != (n, 3) or not np.isfinite(rhs).all():
        fail("the Stokes right-hand side is not finite values of shape [n, 3]")
    if not rhs_err <= STOKES_RHS_ERR_LIMIT:
        fail(f"rhs_err {rhs_err:.3e} above {STOKES_RHS_ERR_LIMIT:.0e}")
    for name, sol in (("relaxed", relaxed), ("fixed p", fixed)):
        if not (sol["converged"] and sol["finite_and_shaped"]):
            fail(f"the {name} Stokes solve: {sol}")
        if not sol["drag_err"] <= drag_limit:
            fail(f"the {name} Stokes solve's drag error {sol['drag_err']:.3e}"
                 f" above {drag_limit:.1e}")
    if min(relaxed["p_schedule"]) < STOKES_P_MIN:
        fail(f"an order below the floor: {relaxed['p_schedule']}")
    others = sum(v for k, v in counts.items() if k != "panel_contract")
    if counts["panel_contract"] == 0 or (
        counts["panel_contract"] != calls["matvecs"]
    ) or others:
        fail(f"panel_contract launched {counts['panel_contract']} times in "
             f"{calls['matvecs']} matvecs (all counts: {counts}): the "
             "Stokes path did not go through its kernel, and no other, "
             "once per matvec")
    return rec


def path_stokes(recursions, chain=20, prefix="stokes"):
    """The Stokes path: plan build (near entries and panel packing timed
    apart), the chunk-contraction kernel at the path's shapes, the
    solves, the profile.  Returns (checks, kernels-line entry, seconds
    of the host build)."""
    torch.cuda.empty_cache()
    t0 = time.time()
    plan, fields, n, near_entries_s = stokes_plan(recursions, "float32")
    host_build_s = time.time() - t0
    t0 = time.time()
    panels, meta = plan.near_panels()
    torch.cuda.synchronize()
    store_s = time.time() - t0
    t0 = time.time()
    plan.near_panels(plan._flipped_fields())
    torch.cuda.synchronize()
    store_flipped_s = time.time() - t0
    C, KTr, Lb = panels["A"].shape
    emit_plan_build(
        f"{prefix}_plan_build", plan, n, host_build_s,
        near_entries_s=near_entries_s, near_entries=int(len(plan.near_rows)),
        near_store_s=store_s, near_store_flipped_s=store_flipped_s,
        near_store_bytes=nbytes_of(panels["A"]), chunks=C,
        real_chunks=int(panels["row_ptr"][-1]), m0=meta.m0, KTr=KTr, Lb=Lb,
        block_rows=meta.block_rows, route=npl.near_route(meta),
    )
    nl = len(plan.leaf_ids)
    full = check_panel_contract(
        panels, meta, nl, 1e-5, f"{prefix}_path", time_it=True)
    panels64 = dict(panels, A=panels["A"].double())
    full64 = check_panel_contract(panels64, meta, nl, 1e-12, f"{prefix}_path")
    del panels64
    torch.cuda.empty_cache()
    main_rec = phase_stokes_path(plan, fields, n, chain, f"{prefix}_path")
    u = np.tile([1.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    phase_profile(plan, u, p=STOKES_P, phase=f"{prefix}_profile")
    phase_profile(plan, u, p=STOKES_P_MIN, phase=f"{prefix}_profile_p5")
    return [full, full64], kernel_entry(
        "panel_contract", "fmm_bem_tpu/ops/near_panel.py:626", full,
        main_rec["kernel_launches"],
    ), host_build_s


def path_stokes_both(recursions, try_larger):
    """The Stokes path, and the next recursion as well where the host
    build measured here says it would take under two minutes."""
    checks, entry, host_build_s = path_stokes(recursions)
    predicted = 4.0 * host_build_s
    ran = try_larger and predicted < STOKES_REC8_HOST_BUDGET_S
    if try_larger:
        emit({
            "phase": "stokes_larger", "recursions": recursions + 1,
            "ran": ran, "host_build_s_here": host_build_s,
            "predicted_host_build_s": predicted,
            "budget_s": STOKES_REC8_HOST_BUDGET_S,
        })
    if ran:
        more, _, _ = path_stokes(recursions + 1, prefix="stokes_larger")
        checks = checks + more
    return checks, entry


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="every path at a small size")
    args = ap.parse_args()
    recursions, otf_recursions, npoints, nbase = 8, 9, 1_000_000, 32768
    stokes_recursions = 7
    if args.quick:
        recursions, otf_recursions, npoints, nbase = 6, 6, 50_000, 8192
        stokes_recursions = 5

    env = phase_env()
    build_s, checks = phase_kernels_small()
    emit({
        "phase": "kernels_small", "build_s": build_s,
        "nvcc_report": {
            name: _build.build_logs.get(name, "").strip().splitlines()[-12:]
            for name in sorted(WRAPPERS)
        },
        "checks": checks,
    })

    paths = {
        "cached": lambda: path_cached(recursions),
        "otf": lambda: path_otf(otf_recursions),
        "points": lambda: path_points(npoints, nbase),
        "stokes": lambda: path_stokes_both(stokes_recursions, not args.quick),
    }
    entries = []
    for drive in paths.values():
        t0 = time.time()
        path_checks, entry = drive()
        emit({"phase": "kernels", "kernel": entry["name"],
              "checks": path_checks,
              "launches_per_matvec": 1, "path_s": time.time() - t0})
        entries.append(entry)

    emit({"kernels": entries})
    print(env["gpu"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
