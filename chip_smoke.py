#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run as ``python3 chip_smoke.py`` from the root of a checkout.  It imports
only ``fmm_bem_tpu_torch``, builds the CUDA kernels from the sources in
the checkout (``nvcc``, first use, one process per source, all started
together), holds every kernel against its plain PyTorch version on the
card (``near_panel`` also against the plain model of its two passes, on
seeded ragged stores that meet every way a target leaf can fall on the
block edges), and drives the port's paths at full size:

- the cached path: a Laplace BEM unit sphere of 131,072 panels (K=3,
  ncrit=64, leaf_pad=64, f32, max_p=10) -> ``FmmPlan`` -> 50 chained
  slot-space matvecs at p=5 -> the second-kind solve at fixed p=5 -> the
  first-kind relaxed solve with tiers (3, 5, 10) -> the bench record of
  ``utils/bench_impl.py`` on the same plan (its solves held to these,
  its phases at p=5 and p=10 by ``utils/roofline.py``, the p=5 ones
  held to telescope to the matvec); then the same sphere with
  ``near_mode="otf"``, its matvec and its first-kind solve held against
  the cached ones;
- path A, the on-the-fly near field: the same solves on 524,288 panels
  with ``near_mode="otf"`` (no cached near store), then the first-kind
  solve once more in f64 and the f32 right-hand sides against the f64
  ones; its phases by ``utils/roofline.py``;
- path B, the point kernel: one ``FmmPlan.apply`` of ``LaplaceKernel``
  (potential + force) on 1,000,000 points at p=5, held against direct
  summation on a sample of 1,000 targets; its phases by
  ``utils/roofline.py``;
- the Stokes path: flow past a unit sphere of 32,768 panels = 98,304
  unknowns (``StokesBEMKernel(K=4, fine_K=19, mu=1e-3)``, ncrit=64,
  leaf_pad=64, f32, max_p=10): the right-hand side through the
  double-layer variant against 4 pi, the relaxed solve at p=8 with the
  order floor of 5 and the same solve at fixed p=8, the drag against
  Stokes' law, chained matvecs at p=8 and p=5, the profile.  Its near
  field (3x3 blocks) goes through the chunk-contraction kernel;
- the Yukawa path: the screened first-kind problem of the reference
  program on the cached path's sphere of 131,072 panels
  (``YukawaBEMKernel(K=3, kappa=0.125)``, ncrit=64, leaf_pad=64, f32,
  max_p=8): the relaxed solve with tiers (3, 5, 8), the mean dphi/dn
  against the interior analytic value, chained matvecs at p=8 and p=5,
  the profiles, ``near_panel`` on its store, the same solve in f64; then
  at 8,192 panels one f32 matvec against the f64 one at p=8 and p=5, and
  the f32 solve against the f64 one;
- the other point kernels at p=5 against direct summation:
  ``YukawaKernel`` on 1,000,000 points, ``LaplaceCartesianKernel`` and
  ``YukawaSphericalKernel`` on 100,000, and ``LaplaceKernel`` through
  the treecode evaluator on 100,000 (its ``p2p_tile`` first held
  against the plain version on that plan's tables).

- the solvers around the matvec, on those paths' plans: the cached
  path's first-kind solve through the host GMRES loop, with the
  diagonal preconditioner on both modes and by FMGMRES on the device; a
  local-evaluation and a block-diagonal plan of its sphere (``near_panel``
  on each store, an FGMRES solve preconditioned by ``local_inner`` on
  each); Stokes FMGMRES; the Yukawa solve through the host loop; a
  block-diagonal point plan on the million points (``p2p_tile`` on its
  self pairs, the block-diagonal preconditioner); then the three BEM
  example programs of the port run in-process;
- the plans without a slot operator: one body-order ``apply`` on each
  plan above against its slot-order one; the COO near-field replay
  (``near_panel=False``) of the cached sphere, its ``droptol`` and its
  first-kind solve on the body-order operator, the Stokes COO plan
  against its panel plan; dual trees: ``LaplaceKernel`` on 1,000,000
  sources and as many targets, the unit kernel exact in f64, the
  cached sphere evaluated at 200,000 off-surface points against
  ``eval_exterior`` (``near_panel`` on the dual store), then dual plans
  of unequal leaf pads (``otf_tile`` on the on-the-fly one); the point
  programs ``serialrun`` and ``scaling`` run in-process (``p2p_tile``
  held on the ``serialrun`` plan's tables);
- the LET distribution (``parallel/let.py``): the cached path's plan
  over 1, 2 and 4 ranks and the (2, 2) layout, every rank on the card
  (and on two cards where there are two): ``apply`` against
  ``plan.apply`` in both BC variants, the bytes each collective brings
  a rank against a rank's store, chained matvecs, the relaxed
  first-kind solve at 4 ranks against the single plan's, ``near_panel``
  on each rank's store; the f64 LET at 8,192 panels; the Stokes plan at
  4 ranks with ``panel_contract`` on each rank's store; the point LET
  on the million points; the ``scaling_multichip`` program in-process.

Each path's kernel launches are counted from zero just before it is
driven and read just after.  Each phase prints one JSON line; any
failure exits non-zero.  There is no CPU fallback: without a GPU the
script fails before it prints anything.

``--quick`` runs every path at a small size (8,192 panels, 50,000
points, 2,048 Stokes panels, the point kernels at a twentieth of their
counts, 20,000 dual targets) for a look of a few minutes.
"""

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import types

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
from fmm_bem_tpu_torch.config import Evaluator, default_p_tiers
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.kernels.cartesian import (
    LaplaceCartesianKernel,
    YukawaKernel,
)
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.spherical_yukawa import YukawaSphericalKernel
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel
from fmm_bem_tpu_torch.kernels.unit import UnitKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.ops import _build
from fmm_bem_tpu_torch.ops import near_panel as npl
from fmm_bem_tpu_torch.ops import otf_tile as otf
from fmm_bem_tpu_torch.ops import p2p_tile as p2p
from fmm_bem_tpu_torch.parallel.let import LetPlan
from fmm_bem_tpu_torch.bem.integrals import near_entries_laplace
from fmm_bem_tpu_torch.solver.api import solve_plan
from fmm_bem_tpu_torch.solver.fmgmres import fmgmres, fmgmres_device
from fmm_bem_tpu_torch.solver.gmres import fgmres, gmres_device
from fmm_bem_tpu_torch.solver.preconditioners import (
    block_diagonal_from_plan,
    local_inner,
)
from fmm_bem_tpu_torch.utils import bench_impl, roofline

#: the peaks every bound is stated against: the H100 SXM row of
#: utils/roofline.py's table, (f32 FLOP/s, f64 FLOP/s, bytes/s)
H100_PEAKS = roofline.CHIP_PEAKS["NVIDIA H100 80GB HBM3"]
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
#: the point Laplace kernel's self-exclusion threshold on r^2
P2P_EPS2 = LaplaceKernel.eps2
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

#: the Yukawa path: the reference program's operating point
#: (examples/yukawa_bem.py: YukawaBEMKernel(K=3, kappa=0.125), theta=0.5,
#: ncrit=64, max_p = max(6, 8) = 8, residual 1e-5, relaxed with the tiers
#: default_p_tiers(8)), on the cached path's sphere with leaf_pad=64
YUKAWA_KAPPA = 0.125
YUKAWA_P = 8
#: the mean dphi/dn against the interior value -(kappa coth kappa - 1):
#: the JAX package's own bar at 512 panels (tests/test_yukawa.py)
YUKAWA_ANALYTIC_LIMIT = 5e-2
#: the f32 solve against the f64 one on the same sphere (recursion 6):
#: the mean dphi/dn, the value the reference program checks, agrees to
#: 1e-4 relative.  The solution vectors differ more, and by design: each
#: solve stops at a residual of 1e-5 of a first-kind system whose
#: right-hand side is a small difference (for kappa -> 0 the double
#: layer on 1 is exactly the -2 pi self term), so two solves that stop
#: after different iterations (f32 rounding slows the f32 one) differ by
#: up to the condition number times 1e-5: 1.03e-3 in relative L2 on an
#: NVIDIA H100 80GB HBM3 (700.00 W; mean 8.0e-7), 1.3e-3 in f32 on a
#: CPU; the limit keeps a factor of ten
YUKAWA_F32_F64_LIMIT = 1e-4
YUKAWA_F32_F64_VECTOR_LIMIT = 1e-2
#: one f32 matvec against the f64 one on the same vector at recursion 6,
#: p=8 and p=5, relative L2, where the stopping point of a solve plays
#: no part: 8.9e-8 to 1.9e-7 on an NVIDIA H100 80GB HBM3 (700.00 W) on
#: the vectors 1 and a seeded normal one; the limit keeps a factor of ten
YUKAWA_F32_F64_MATVEC_LIMIT = 2e-6
#: the point kernels beside it (points uniform in the unit cube, p=5, the
#: seeds of the points path), with their counts: (name, kernel,
#: evaluator, points).  Each is held to three times the error the same
#: kernel and order show on POINT_KERNEL_BASE points
POINT_KERNEL_RUNS = (
    ("yukawa", lambda: YukawaKernel(kappa=YUKAWA_KAPPA), Evaluator.FMM,
     1_000_000),
    ("laplace_cartesian", LaplaceCartesianKernel, Evaluator.FMM, 100_000),
    ("yukawa_spherical", lambda: YukawaSphericalKernel(kappa=YUKAWA_KAPPA),
     Evaluator.FMM, 100_000),
    ("laplace_treecode", LaplaceKernel, Evaluator.TREECODE, 100_000),
)
POINT_KERNEL_BASE = 8192

#: each kernel's time at its path's shapes in PERF.md's table before its
#: last redesign (f32, NVIDIA H100 80GB HBM3 at 700.00 W): near_panel
#: from run W (one block per target leaf, on the cached store: its latest
#: time before the chunk-tiled design) and p2p_tile from run N, launches
#: back to back as now; otf_tile from run C and panel_contract from run
#: G, timed then one synchronised call at a time.  Printed on a line of
#: its own for the reader to set beside this run's times: not measured
#: here
PREVIOUS_MS = {"near_panel": 0.4434, "panel_contract": 0.885,
               "otf_tile": 3.086, "p2p_tile": 2.938}

DEV = torch.device("cuda")


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke.py: FAILED: {msg}\n")
    sys.exit(1)


def gpu_ms(fn, reps, warmup=2, batches=3):
    """Milliseconds per call of ``fn()`` on the card, by CUDA events: the
    median over ``batches`` of ``reps`` calls enqueued back to back
    between two events, so that the device time is timed and not the
    host's launch of each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def graph_ms(fn, reps=20):
    """Milliseconds per call of ``fn()`` replayed from a CUDA graph of
    one call (captured after a warm-up on a side stream): the card's
    time without the host's launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = gpu_ms(graph.replay, reps)
    del graph
    return ms


def host_us(fn, reps=20):
    """Microseconds of the host's time per call of ``fn()``: the median
    of three batches of ``reps`` calls enqueued back to back, each batch
    timed on the host's clock before the card is waited for."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def nvidia_smi_line(fields="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def build_plan(recursions, dtype, ncrit=64, leaf_pad=64, near_mode="cached",
               fields=None, K=3, **config):
    if fields is None:
        fields = make_panels(unit_sphere(recursions), K=K)
    plan = fbt.FmmPlan(
        LaplaceBEMKernel(K=K), fields,
        fbt.FMMConfig(ncrit=ncrit, dtype=dtype, max_p=10, leaf_pad=leaf_pad,
                      near_mode=near_mode, **config),
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
    padded slots not counted (a dual plan's two trees each by its own
    table)."""
    cnt_s = plan.src.leaf_body_mask.sum(axis=1).astype(np.int64)
    cnt_t = plan.tgt.leaf_body_mask.sum(axis=1).astype(np.int64)
    return int((cnt_t[plan.p2p_tgt_slot] * cnt_s[plan.p2p_src_slot]).sum())


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


def peak_flops(dtype):
    return H100_PEAKS[0] if dtype == torch.float32 else H100_PEAKS[1]


def arithmetic_bound(rec, nbytes, flops, sfu, dtype):
    """bound_ms: the largest of bytes over the memory rate, flops over
    the peak rate of the type and special-function results over theirs."""
    t_bytes = nbytes / H100_PEAKS[2] * 1e3
    t_flops = flops / peak_flops(dtype) * 1e3
    t_sfu = sfu / PEAK_SFU_PER_S * 1e3
    rec["bound_ms"] = max(t_bytes, t_flops, t_sfu)
    rec["bound_by"] = "bytes" if t_bytes >= max(t_flops, t_sfu) else "operations"
    rec["bound_terms_ms"] = {"bytes": t_bytes, "flops": t_flops, "sfu": t_sfu}


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_otf_tile(plan, ot, ql, kappa, tol, label, time_it=False,
                   plain_counts=False):
    """The otf_tile kernel against its plain version on the card.  The
    kernel reads the count tables of ``ot``; the plain version is given
    none and masks by the sentinel, so the two also hold the tables to
    the tiles (with ``plain_counts`` it reads the same tables: for bad
    tables, which both read alike).  Padded target slots and target
    leaves without pairs must come out exactly 0.  The f32 tolerance is
    stated relative to the output's largest value: the kernel inverts r
    with rsqrtf (2 ulp) where the plain version takes sqrt and divides,
    and the two add a leaf's K * KQ * pairs terms in another order; f64
    differs by the order of the sums alone."""
    KQ = (ot["sb_src"].shape[1] - 3) // 4
    args = (ot["sb_src"], ql, ot["sb_tgt"], ot["row_ptr"], ot["sslot"], KQ)
    got = otf.otf_leaf_tiles(*args, kappa=kappa, src_cnt=ot["src_cnt"],
                             tgt_cnt=ot["tgt_cnt"])
    torch.cuda.synchronize()
    counts = (dict(src_cnt=ot["src_cnt"], tgt_cnt=ot["tgt_cnt"])
              if plain_counts else {})
    want = otf.otf_leaf_tiles_reference(*args, kappa=kappa, **counts)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"otf_tile[{label}]: bad output {tuple(got.shape)} "
             "(every element must be finite, padded slots included)")
    nl_t, K = got.shape
    real = torch.arange(K, device=DEV) < ot["tgt_cnt"][:nl_t, None]
    no_pairs = ot["row_ptr"][1:] == ot["row_ptr"][:-1]
    zeros_exact = bool((got[~real] == 0).all() and (got[no_pairs] == 0).all())
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    rec = {
        "kernel": "otf_tile", "case": label,
        "dtype": str(ql.dtype).replace("torch.", ""), "kappa": kappa,
        "tiles": list(ot["sb_src"].shape), "near_pairs": len(ot["sslot"]),
        "max_abs_err": max_abs, "rel_err": rel, "tol": tol,
        "all_finite": True, "padded_and_pairless_exact_zero": zeros_exact,
    }
    if rel > tol or not zeros_exact:
        emit(rec)
        fail(f"otf_tile[{label}] disagrees with its plain version: "
             f"rel {rel:.3e} > {tol:.1e}, exact zeros {zeros_exact}")
    if time_it:
        evals, flops, sfu, evals_dg = otf_needed_work(
            plan, ot["sb_tgt"], kappa)
        if evals != pair_evaluations(plan) * KQ:
            fail("the target table's real slots are not the plan's bodies")
        # what the kernel's loops run, worked out on the host from the
        # count tables it reads: real targets x staged real panels
        tslot = torch.repeat_interleave(
            torch.arange(nl_t, device=DEV),
            (ot["row_ptr"][1:] - ot["row_ptr"][:-1]).long())
        walked = KQ * int((ot["tgt_cnt"][tslot].long()
                           * ot["src_cnt"][ot["sslot"].long()].long()).sum())
        counts = (ot["src_cnt"], ot["tgt_cnt"])
        arithmetic_bound(rec, nbytes_of(*args[:5], *counts, got), flops, sfu,
                         ql.dtype)
        rec["kernel_evaluations"] = evals
        rec["kernel_evaluations_dG"] = evals_dg
        rec["evaluations_walked_from_count_tables"] = walked
        rec["evaluations_walked_before_from_tile_shape"] = (
            len(ot["sslot"]) * K * K * KQ)  # every slot: the first design
        if walked != evals:
            emit(rec)
            fail(f"otf_tile walks {walked} evaluations, {evals} needed")
        rec["ms"] = gpu_ms(lambda: otf.otf_leaf_tiles(
            *args, kappa=kappa, src_cnt=counts[0], tgt_cnt=counts[1]), 10)
        rec["plain_ms"] = gpu_ms(
            lambda: otf.otf_leaf_tiles_reference(*args, kappa=kappa), 2, 1,
            batches=1)
        rec["library_ms"] = None  # no single PyTorch call computes this
    return rec


def otf_edge_tiles(ot, ql, mixed_bc):
    """The small case's tables cut to what the kernel's walk relies on:
    a full leaf (count == K) stays, another leaf keeps one real slot, a
    third loses its pairs; with ``mixed_bc`` every other target carries
    the other BC flag, so the first warp of a leaf holds both.  Returns
    (tables, charges, the three leaves)."""
    src, tgt = ot["sb_src"].clone(), ot["sb_tgt"].clone()
    scnt, tcnt = ot["src_cnt"].clone(), ot["tgt_cnt"].clone()
    ql = ql.clone()
    K = ql.shape[1]
    KQ = (src.shape[1] - 3) // 4
    npair = (ot["row_ptr"][1:] - ot["row_ptr"][:-1]).cpu()
    cnt = scnt[:-1].cpu()
    cand = [int(i) for i in torch.nonzero(npair > 0).flatten()]
    full = next((i for i in cand if cnt[i] == K), None)
    one = next((i for i in cand if i != full and cnt[i] >= 2), None)
    none = next((i for i in cand if i not in (full, one)), None)
    if None in (full, one, none):
        fail(f"small otf_tile case lacks a leaf: full {full}, one {one}, "
             f"none {none}")
    src[one, : 3 * KQ, 1:] = p2p.SENTINEL
    src[one, 3 * KQ : 4 * KQ, 1:] = 0.0
    tgt[one, :3, 1:] = p2p.SENTINEL
    ql[one, 1:] = 0.0
    scnt[one] = tcnt[one] = 1
    if mixed_bc:
        tgt[:-1, 3] = (torch.arange(K, device=DEV) % 2).to(tgt.dtype)
    npair[none] = 0
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(npair, 0)]).to(torch.int32).to(DEV)
    keep = torch.ones(len(ot["sslot"]), dtype=torch.bool, device=DEV)
    keep[int(ot["row_ptr"][none]):int(ot["row_ptr"][none + 1])] = False
    tables = dict(sb_src=src, sb_tgt=tgt, row_ptr=row_ptr,
                  sslot=ot["sslot"][keep].contiguous(), src_cnt=scnt,
                  tgt_cnt=tcnt)
    return tables, ql, {"full": full, "one_slot": one, "no_pairs": none}


def p2p_tables(d, ql):
    """The kernel's inputs from a point plan's device data and seeded
    charge tiles ``ql`` [nl, K] (their dtype)."""
    return dict(
        xyzq=p2p.pack_xyzq(d["p2p_xyz3"].to(ql.dtype), ql[:, None, :]),
        row_ptr=d["p2p_row_ptr"], src_idx=d["p2p_src_sorted"],
        cnt=d["p2p_cnt"],
    )


def p2p_walked(tb):
    """Evaluations the kernel's loops run, worked out on the host from
    the tables it reads: per pair, the target leaf's count times the
    source leaf's."""
    cnt = tb["cnt"].long()
    nl_t = tb["row_ptr"].shape[0] - 1
    tslot = torch.repeat_interleave(
        torch.arange(nl_t, device=DEV),
        (tb["row_ptr"][1:] - tb["row_ptr"][:-1]).long())
    return int((cnt[tslot] * cnt[tb["src_idx"].long()]).sum())


def check_p2p_tile(plan, tb, tol, label, time_it=False):
    """The p2p_tile kernel against its plain version on the card, both
    given the count table, per result component (potential, fx, fy, fz)
    relative to that component's largest value: f32 differs by rsqrt
    against sqrt and a division, and by the order in which a leaf's
    sources are added.  Every slot is compared; padded target slots and
    target leaves without pairs must be exactly 0 on both sides, and a
    second launch must give the same bits."""
    args = (tb["xyzq"], tb["row_ptr"], tb["src_idx"], P2P_EPS2, tb["cnt"])
    got = p2p.p2p_leaf_tiles(*args)
    again = p2p.p2p_leaf_tiles(*args)
    torch.cuda.synchronize()
    want = p2p.p2p_leaf_tiles_reference(*args)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"p2p_tile[{label}]: bad output {tuple(got.shape)} "
             "(every element must be finite, padded slots included)")
    nl_t, _, K = got.shape
    real = (torch.arange(K, device=DEV) < tb["cnt"][:nl_t, None])[:, None]
    real = real.expand_as(got)
    no_pairs = tb["row_ptr"][1:] == tb["row_ptr"][:-1]
    zeros_exact = all(bool((x[~real] == 0).all() and (x[no_pairs] == 0).all())
                      for x in (got, want))
    bit_equal = torch.equal(got, again)
    err = (got - want).abs().amax(dim=(0, 2))
    scale = want.abs().amax(dim=(0, 2))
    max_abs = float(err.max())
    rel = float((err / scale).max())
    rec = {
        "kernel": "p2p_tile", "case": label,
        "dtype": str(got.dtype).replace("torch.", ""),
        "tiles": list(tb["xyzq"].shape), "near_pairs": len(tb["src_idx"]),
        "max_abs_err": max_abs, "rel_err": rel, "tol": tol,
        "all_finite": True, "padded_and_pairless_exact_zero": zeros_exact,
        "repeat_bit_equal": bit_equal,
    }
    if rel > tol or not zeros_exact or not bit_equal:
        emit(rec)
        fail(f"p2p_tile[{label}] disagrees with its plain version: "
             f"rel {rel:.3e} > {tol:.1e}, exact zeros {zeros_exact}, "
             f"repeat bit-equal {bit_equal}")
    if time_it:
        evals = pair_evaluations(plan)
        walked = p2p_walked(tb)
        arithmetic_bound(
            rec, nbytes_of(*args[:3], tb["cnt"], got), evals * P2P_FLOPS,
            evals, got.dtype,
        )
        rec["kernel_evaluations"] = evals
        rec["evaluations_walked_from_count_tables"] = walked
        rec["evaluations_walked_before_from_tile_shape"] = (
            len(tb["src_idx"]) * K * K)  # every slot: the first design
        if walked != evals:
            emit(rec)
            fail(f"p2p_tile walks {walked} evaluations, {evals} needed")
        rec["ms"] = gpu_ms(lambda: p2p.p2p_leaf_tiles(*args), 10)
        rec["plain_ms"] = gpu_ms(
            lambda: p2p.p2p_leaf_tiles_reference(*args), 2, 1, batches=1)
        rec["library_ms"] = None  # no single PyTorch call computes this
    return rec


def p2p_edge_tables(tb, K, dtype):
    """The small case's tables cut to what the kernel's walk relies on: a
    full leaf (count == K) stays; another leaf keeps one real point (its
    other slots keep their points and charges: only the count hides
    them); a third loses its pairs; a fourth is given every leaf as a
    source, more real points than two stages hold, so the ring turns
    over (and the pair window slides); a source point of a fifth leaf's
    neighbour is moved onto one of its targets.  Returns (tables, the
    leaves)."""
    cnt = tb["cnt"].cpu().numpy().copy()
    rp = tb["row_ptr"].cpu().numpy()
    src = tb["src_idx"].cpu().numpy()
    nl = len(cnt) - 1
    lists = [src[rp[l]:rp[l + 1]] for l in range(len(rp) - 1)]
    cand = [l for l in range(len(lists)) if len(lists[l])]
    full = next((l for l in cand if cnt[l] == K), None)
    one = next((l for l in cand if l != full and cnt[l] >= 2), None)
    none = next((l for l in cand if l not in (full, one)), None)
    big = next((l for l in cand if l not in (full, one, none)), None)
    taken = (full, one, none, big)
    pair = next(((a, b) for a in cand if a not in taken and cnt[a]
                 for b in lists[a] if b != a and b not in taken and cnt[b]),
                None)
    if None in taken or pair is None:
        fail(f"small p2p_tile case lacks a leaf: full {full}, one {one}, "
             f"none {none}, big {big}, coincident {pair}")
    cap = p2p.stage_capacity(dtype, K)
    cnt[one] = 1
    lists[none] = lists[none][:0]
    lists[big] = np.arange(nl, dtype=src.dtype)
    big_sources = int(cnt[:nl].sum())
    if big_sources <= 2 * cap:
        fail(f"small p2p_tile case: {big_sources} sources fit in two "
             f"stages of {cap}")
    xyzq = tb["xyzq"].clone()
    a, b = pair
    xyzq[b, :3, 0] = xyzq[a, :3, 0]  # real in both leaves, r = 0
    lens = np.array([len(x) for x in lists])
    tables = dict(
        xyzq=xyzq,
        row_ptr=torch.as_tensor(np.append(0, np.cumsum(lens)),
                                dtype=torch.int32, device=DEV),
        src_idx=torch.as_tensor(np.concatenate(lists), dtype=torch.int32,
                                device=DEV),
        cnt=torch.as_tensor(cnt, device=DEV),
    )
    return tables, {"full": full, "one_point": one, "no_pairs": none,
                    "past_two_stages": big, "big_sources": big_sources,
                    "stage_cap": cap, "coincident": [int(a), int(b)]}


#: seconds a kernel check on bad tables may take before the run fails:
#: these small cases finish in milliseconds, and a walk that never ends
#: (a segment planner that takes no pair) would hang the card instead
BAD_TABLE_WATCHDOG_S = 60
#: the bad tables each count-table kernel must survive with the result
#: of the corrected tables: a count far above K (and above any stage's
#: capacity), a negative count, source leaf indices past the table and
#: below 0
BAD_TABLES = ("count_above_K", "negative_count", "source_index_out_of_range")


@contextlib.contextmanager
def watchdog(seconds, what):
    """Fail the run from a timer thread if the body has not finished in
    ``seconds``: a hung kernel blocks the synchronise inside it."""
    def expire():
        sys.stderr.write(f"chip_smoke.py: FAILED: {what} did not finish "
                         f"within {seconds} s\n")
        sys.stderr.flush()
        os._exit(1)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def spoil_tables(case, row_ptr, src_idx, counts, K):
    """(bad, corrected) ``(row_ptr, src_idx, counts)`` on the card from a
    pair list and its count tables (``(src_cnt, tgt_cnt)``, or one table
    serving both sides): a source leaf of a pair and a target leaf with
    pairs get a bad count, or two pairs of that leaf a bad source index.
    The corrected tables hold what the kernels read from the bad ones:
    counts clamped to [0, K], the pairs of a bad index dropped."""
    rp, src = row_ptr.cpu(), src_idx.cpu()
    cnt = [c.cpu() for c in counts]
    npair = (rp[1:] - rp[:-1]).long()
    tleaf = int(torch.nonzero(npair > 0)[1])
    sleaf = int(src[int(rp[tleaf])])
    bad = [rp, src.clone(), [c.clone() for c in cnt]]
    good = [rp, src, [c.clone() for c in cnt]]
    if case == "source_index_out_of_range":
        hit = [int(rp[tleaf]), int(rp[tleaf + 1]) - 1]
        bad[1][hit[0]] = len(cnt[0]) - 1 + 7
        bad[1][hit[1]] = -2
        keep = torch.ones(len(src), dtype=torch.bool)
        keep[hit] = False
        npair[tleaf] -= len(set(hit))
        good[0] = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum(npair, 0)]).to(torch.int32)
        good[1] = src[keep].contiguous()
    else:
        value, clamped = ((1 << 20, K) if case == "count_above_K"
                          else (-3, 0))
        for side, leaf in ((0, sleaf), (len(cnt) - 1, tleaf)):
            bad[2][side][leaf] = value
            good[2][side][leaf] = clamped

    def dev(t):
        rp_, src_, cnt_ = t
        return rp_.to(DEV), src_.to(DEV), [c.to(DEV) for c in cnt_]

    return dev(bad), dev(good)


def check_bad_tables(ot, tb, ql, dtype, tol):
    """The edge cases of the count tables for both kernels that walk by
    them, each under ``watchdog``: every case must finish, agree with the
    plain version on the same tables, and the plain version there must
    give its result on the corrected tables."""
    checks = []
    K = ql.shape[1]
    for case in BAD_TABLES:
        bad, good = spoil_tables(case, ot["row_ptr"], ot["sslot"],
                                 (ot["src_cnt"], ot["tgt_cnt"]), K)
        KQ = (ot["sb_src"].shape[1] - 3) // 4
        for kappa in (0.0, 0.5):
            et = dict(ot, row_ptr=bad[0], sslot=bad[1], src_cnt=bad[2][0],
                      tgt_cnt=bad[2][1])
            label = f"bad_{case}_{dtype}"
            t0 = time.time()
            with watchdog(BAD_TABLE_WATCHDOG_S, f"otf_tile[{label}]"):
                rec = check_otf_tile(None, et, ql, kappa, tol, label,
                                     plain_counts=True)
            rec["finished_s"] = time.time() - t0
            args = (ot["sb_src"], ql, ot["sb_tgt"])
            on_bad = otf.otf_leaf_tiles_reference(
                *args, bad[0], bad[1], KQ, kappa, src_cnt=bad[2][0],
                tgt_cnt=bad[2][1])
            on_good = otf.otf_leaf_tiles_reference(
                *args, good[0], good[1], KQ, kappa, src_cnt=good[2][0],
                tgt_cnt=good[2][1])
            rec["plain_bad_vs_corrected_rel"] = float(
                (on_bad - on_good).abs().max() / on_good.abs().max())
            checks.append(rec)
    for case in BAD_TABLES:
        bad, good = spoil_tables(case, tb["row_ptr"], tb["src_idx"],
                                 (tb["cnt"],), tb["xyzq"].shape[2])
        label = f"bad_{case}_{dtype}"
        t0 = time.time()
        with watchdog(BAD_TABLE_WATCHDOG_S, f"p2p_tile[{label}]"):
            rec = check_p2p_tile(None, dict(tb, row_ptr=bad[0],
                                            src_idx=bad[1], cnt=bad[2][0]),
                                 tol, label)
        rec["finished_s"] = time.time() - t0
        on_bad = p2p.p2p_leaf_tiles_reference(
            tb["xyzq"], bad[0], bad[1], P2P_EPS2, bad[2][0])
        on_good = p2p.p2p_leaf_tiles_reference(
            tb["xyzq"], good[0], good[1], P2P_EPS2, good[2][0])
        rec["plain_bad_vs_corrected_rel"] = float(
            (on_bad - on_good).abs().max() / on_good.abs().max())
        checks.append(rec)
    # the dropped pairs regroup the plain versions' sums: rounding only
    worst = max(c["plain_bad_vs_corrected_rel"] for c in checks)
    if worst > tol:
        fail(f"a plain version reads bad tables other than as the "
             f"corrected ones: rel {worst:.3e} (limit {tol:.0e})")
    return checks


def near_panel_bound(panels, meta, ql):
    """The least time of the near_panel product on this store: the
    larger of its bytes over the memory rate and its multiply-adds over
    the peak of its type.  Bytes: each real chunk's rows up to the last
    needed column ``m0 * KSc`` (the rest of ``Lb`` is zero padding), in
    whole 32-byte sectors (every row starts on one), the chunk's
    indices, the row pointer, the charges and the result, each once;
    dummy chunks are never read."""
    A, rp = panels["A"], panels["row_ptr"]
    _, KTr, _ = A.shape
    esz = A.element_size()
    n_real = int(rp[-1])
    needed = meta.m0 * meta.KS * meta.cdim
    row_bytes = -(-needed * esz // 32) * 32
    nbytes = (n_real * KTr * row_bytes + n_real * meta.m0 * 4
              + rp.numel() * 4 + ql.numel() * esz + meta.nl_t * KTr * esz)
    flops = 2.0 * n_real * KTr * needed
    t_bytes = nbytes / H100_PEAKS[2] * 1e3
    t_ops = flops / peak_flops(A.dtype) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "needed_bytes_of_A": n_real * KTr * row_bytes,
            "needed_columns": needed, "real_chunks": n_real}


def check_near_panel(panels, meta, nl_src, tol, label, time_it=False,
                     tiled_model=False):
    """The near_panel kernel against its plain version on the card, on a
    seeded charge table, twice (no atomics: the bits must repeat), with
    the leaves without chunks exactly 0; the tiling it ran with (chunks
    per block S, grid, carry bytes).  With ``tiled_model`` also against
    the plain model of its two passes at that S.  Optionally timed beside
    its plain version, its bound (the real chunks' needed columns, whole
    sectors, of A), and in turns (three rounds) beside the library
    yardstick and one PyTorch reduction over the bytes of A the kernel
    reads; then the kernel and the yardstick replayed from CUDA graphs,
    which time the card without the host's launches."""
    A = panels["A"]
    C, KTr, Lb = A.shape
    gen = torch.Generator(device=DEV).manual_seed(11)
    ql = torch.randn(
        (nl_src, meta.KS * meta.cdim), generator=gen, dtype=A.dtype,
        device=DEV,
    )
    got = npl.panel_matvec(panels, meta, ql)
    again = npl.panel_matvec(panels, meta, ql)
    torch.cuda.synchronize()
    want = npl.panel_matvec_reference(panels, meta, ql)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"near_panel[{label}]: bad output {tuple(got.shape)}")
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    rp = panels["row_ptr"]
    empty = rp[1:] == rp[:-1]
    tiling = npl.near_tiling(C, KTr, Lb, A.element_size(),
                             npl.sm_count(DEV))
    rec = {
        "kernel": "near_panel", "case": label,
        "dtype": str(A.dtype).replace("torch.", ""),
        "A_shape": list(A.shape), "m0": meta.m0, "nl_t": meta.nl_t,
        "max_abs_err": max_abs, "rel_err": rel, "tol": tol,
        "bit_equal_twice": bool(torch.equal(got, again)),
        "empty_leaves": int(empty.sum()),
        "empty_leaves_exact_zero": bool((got[empty] == 0).all()),
        "S": tiling.S, "grid": list(tiling.grid),
        "threads_per_block": tiling.warps * 32,
        "carry_bytes": math.prod(tiling.carry_shape(KTr))
        * A.element_size(),
    }
    if tiled_model:
        model = npl.panel_matvec_tiled_reference(panels, meta, ql, tiling.S)
        rec["tiled_model_rel_err"] = float(
            (got - model).abs().max() / want.abs().max())
        rec["tiled_model_vs_plain_rel_err"] = float(
            (model - want).abs().max() / want.abs().max())
    worst = max(rel, rec.get("tiled_model_rel_err", 0.0),
                rec.get("tiled_model_vs_plain_rel_err", 0.0))
    if not (worst <= tol and rec["bit_equal_twice"]
            and rec["empty_leaves_exact_zero"]):
        emit(rec)
        fail(f"near_panel[{label}]: rel {worst:.3e} (limit {tol:.1e}), "
             f"two runs bit-equal {rec['bit_equal_twice']}, leaves without "
             f"chunks exactly 0 {rec['empty_leaves_exact_zero']}")
    if time_it:
        esz = A.element_size()
        bound = near_panel_bound(panels, meta, ql)
        n_real, needed = bound["real_chunks"], bound["needed_columns"]
        # yardstick: one library call on charges gathered beforehand;
        # beside it a plain read of the bytes of A the kernel reads (the
        # real chunks' columns up to the last needed group of four)
        xb = npl.chunk_charge_rows(panels, ql)[:, :, None].contiguous()
        real = A[:n_real, :, :-(-needed // 4) * 4]
        timed = {"near_panel": lambda: npl.panel_matvec(panels, meta, ql),
                 "torch.bmm": lambda: torch.bmm(A, xb),
                 "A.sum": lambda: real.sum()}
        rounds = {k: [] for k in timed}
        for order in (list(timed), list(timed)[::-1], list(timed)):
            for k in order:
                rounds[k].append(gpu_ms(timed[k], 20))
        ms = {k: statistics.mean(v) for k, v in rounds.items()}
        rec["timing_rounds_ms"] = rounds
        rec["ms"] = ms["near_panel"]
        rec["library_ms"] = ms["torch.bmm"]
        rec["read_of_A_ms"] = ms["A.sum"]
        rec["plain_ms"] = gpu_ms(
            lambda: npl.panel_matvec_reference(panels, meta, ql), 5
        )
        # the card's time alone: one call replayed from a CUDA graph; and
        # the host's: the wrapper's calls enqueued without waiting
        rec["graph_ms"] = graph_ms(lambda: npl.panel_matvec(panels, meta, ql))
        rec["library_graph_ms"] = graph_ms(lambda: torch.bmm(A, xb))
        rec["host_us_per_call"] = host_us(
            lambda: npl.panel_matvec(panels, meta, ql))
        rec["library_host_us_per_call"] = host_us(lambda: torch.bmm(A, xb))
        rec.update(bound)
        rec["store_bytes"] = C * KTr * Lb * esz
        del xb, real
    return rec


#: seeded ragged near_panel stores (C, KTr, Lb, KSc, m0), 7 dummy chunks
#: last: chunk tiles small enough that the tiling takes several chunks
#: per block (KTr 12: S 10 at f32, 5 at f64 on 132 SMs), and a KTr of two
#: row tiles (72)
NEAR_RAGGED_STORES = {"ragged": (12000, 12, 128, 40, 3),
                      "ragged_rows": (2400, 72, 128, 40, 3)}


def near_ragged_store(label, dtype):
    """A ragged near_panel store at the S the kernel will take for it
    (``ops/near_panel.py::ragged_leaf_counts``: every way a target leaf
    can fall on the block edges, seeded leaves to fill, dummy chunks and
    dummy charge tiles), on the card in ``dtype``.  Fails if the store
    lacks a case (``ragged_cases``).  Returns (store, meta, number of
    source leaves, what it holds)."""
    C, KTr, Lb, KSc, m0 = NEAR_RAGGED_STORES[label]
    esz = torch.empty((), dtype=dtype).element_size()
    tiling = npl.near_tiling(C, KTr, Lb, esz, npl.sm_count(DEV))
    S, nl_src, dummies = tiling.S, 64, 7
    rng = np.random.default_rng(C + KTr)
    counts = npl.ragged_leaf_counts(S, rng, C - dummies)
    arrays, meta = npl.ragged_store_arrays(counts, rng, KTr, KSc, m0, Lb,
                                           nl_src, dummies)
    store = {k: torch.as_tensor(v).to(DEV) for k, v in arrays.items()}
    store["A"] = store["A"].to(dtype)
    holds, lacks = npl.ragged_cases(counts, S, arrays["pidx"], nl_src, C)
    holds["row_tiles"] = tiling.row_tiles
    if lacks:
        fail(f"the near_panel store {label} lacks {lacks}: {holds}")
    return store, meta, nl_src, holds


def check_contract(A, xb, tol, rec):
    """The panel_contract kernel against the plain version on (A, xb),
    twice (the bits must repeat), into ``rec``.  Zero rows of ``xb``
    (dummy chunks) must give exact zeros.  Returns the kernel's result."""
    want = npl.panel_contract_reference(A, xb)
    got = npl.panel_contract(A, xb)
    again = npl.panel_contract(A, xb)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"panel_contract[{rec['case']}]: bad output {tuple(got.shape)}")
    dummy = (xb == 0).all(dim=1)
    rec["max_abs_err"] = float((got - want).abs().max())
    rec["rel_err"] = rec["max_abs_err"] / float(want.abs().max())
    rec["tol"] = tol
    rec["dummy_chunks"] = int(dummy.sum())
    rec["bit_equal_twice"] = bool(torch.equal(got, again))
    rec["dummy_exact_zero"] = bool((got[dummy] == 0).all())
    if (rec["rel_err"] > tol or not rec["bit_equal_twice"]
            or not rec["dummy_exact_zero"]):
        emit(rec)
        fail(f"panel_contract[{rec['case']}]: rel {rec['rel_err']:.3e} "
             f"(limit {tol:.1e}), two runs bit-equal "
             f"{rec['bit_equal_twice']}, dummy chunks exactly 0 "
             f"{rec['dummy_exact_zero']}")
    return got


def check_panel_contract(panels, meta, nl_src, tol, label, time_it=False):
    """The panel_contract kernel against its plain version on the card,
    on the chunk rows gathered from a seeded charge table, and the whole
    two-stage route against the plain near-field product, twice (the
    segment sums take no atomics: the bits must repeat).  The f32
    tolerance is relative to the output's largest value: both sides add
    a row's Lb products in another order.  Optionally timed beside its
    plain version, ``torch.bmm``, its bound, the whole two-stage route
    and the fused ``near_panel`` kernel on the same store; the kernel,
    ``torch.bmm`` and ``A.sum`` in turns, three rounds."""
    A = panels["A"]
    C, KTr, Lb = A.shape
    KSc = meta.KS * meta.cdim
    gen = torch.Generator(device=DEV).manual_seed(11)
    ql = torch.randn((nl_src, KSc), generator=gen, dtype=A.dtype, device=DEV)
    xb = npl.chunk_charge_rows(panels, ql)
    n_real = int(panels["row_ptr"][-1])
    rec = {
        "kernel": "panel_contract", "case": label,
        "dtype": str(A.dtype).replace("torch.", ""),
        "A_shape": list(A.shape), "m0": meta.m0, "nl_t": meta.nl_t,
        "rdim": meta.rdim, "cdim": meta.cdim,
        "pad_columns": Lb - meta.m0 * KSc,
    }
    got = check_contract(A, xb, tol, rec)
    rec["dummy_chunks"] = C - n_real
    two = npl.panel_matvec_two_stage(panels, meta, ql)
    again = npl.panel_matvec_two_stage(panels, meta, ql)
    ref = npl.panel_matvec_reference(panels, meta, ql)
    two_rel = float((two - ref).abs().max() / ref.abs().max())
    rec["two_stage_rel_err"] = two_rel
    rec["two_stage_bit_equal"] = bool(torch.equal(two, again))
    if two_rel > tol or not rec["two_stage_bit_equal"]:
        emit(rec)
        fail(f"panel_contract[{label}]: two-stage route rel {two_rel:.3e} "
             f"(limit {tol:.1e}), bit-equal {rec['two_stage_bit_equal']}")
    if time_it:
        # each input read once, the output written once; dummy chunks
        # are computed like any other, so the whole store counts
        arithmetic_bound(
            rec, nbytes_of(A, xb, got), 2.0 * C * KTr * Lb, 0, A.dtype)
        # in turns, three rounds (the card drifts over a round); beside
        # them one PyTorch reduction that reads the same bytes of A
        x3 = xb[:, :, None].contiguous()
        timed = {"panel_contract": lambda: npl.panel_contract(A, xb),
                 "torch.bmm": lambda: torch.bmm(A, x3),
                 "A.sum": lambda: A.sum()}
        rounds = {k: [] for k in timed}
        for order in (list(timed), list(timed)[::-1], list(timed)):
            for k in order:
                rounds[k].append(gpu_ms(timed[k], 20))
        ms = {k: statistics.mean(v) for k, v in rounds.items()}
        rec["timing_rounds_ms"] = rounds
        rec["clocks_after_timing"] = nvidia_smi_line(
            "clocks.sm,clocks.mem,power.draw,temperature.gpu")
        rec["ms"] = ms["panel_contract"]
        rec["library_ms"] = ms["torch.bmm"]
        rec["read_of_A_ms"] = ms["A.sum"]
        del x3
        rec["plain_ms"] = gpu_ms(
            lambda: npl.panel_contract_reference(A, xb), 5)
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


#: quadrature orders of the small otf_tile cases beside the paths' 3
OTF_SMALL_KQ = (13, 25)

#: synthetic panel_contract stores (C, KTr, Lb), each with a dummy chunk
#: (a zero charge row) last: a row longer than the kernel's staged x tile
#: of 6,144 columns, and a chunk count no multiple of the card's SM count
#: with KTr no multiple of the kernel's row tile of 64
CONTRACT_EDGE_STORES = {"lb8192": (37, 45, 8192), "ragged": (997, 45, 384)}


def check_contract_edges(dtype, tol):
    checks = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (C, KTr, Lb) in CONTRACT_EDGE_STORES.items():
        if label == "ragged" and (C % sms == 0 or KTr % 64 == 0):
            fail("the ragged panel_contract store is not ragged")
        gen = torch.Generator(device=DEV).manual_seed(C)
        A = torch.randn((C, KTr, Lb), generator=gen, dtype=dtype, device=DEV)
        xb = torch.randn((C, Lb), generator=gen, dtype=dtype, device=DEV)
        xb[-1] = 0.0
        rec = {"kernel": "panel_contract", "case": f"edge_{label}",
               "dtype": str(dtype).replace("torch.", ""),
               "A_shape": [C, KTr, Lb], "sms": sms}
        check_contract(A, xb, tol, rec)
        if rec["dummy_chunks"] != 1:
            fail(f"panel_contract edge case {label} has no dummy chunk")
        checks.append(rec)
    return checks


def stokes_plan(recursions, dtype, ncrit=64, leaf_pad=64, **config):
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
        fbt.FMMConfig(ncrit=ncrit, dtype=dtype, max_p=10, leaf_pad=leaf_pad,
                      **config),
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


def point_plan(n, seed, dtype="float32", ncrit=64, kernel=LaplaceKernel,
               evaluator=Evaluator.FMM, **config):
    """A point-kernel plan (``LaplaceKernel`` unless said) on n points
    uniform in the unit cube, with unit-mean random charges, both from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n, 3))
    q = rng.uniform(0.5, 1.5, n)
    plan = fbt.FmmPlan(
        kernel(), {"xyz": pts},
        fbt.FMMConfig(ncrit=ncrit, dtype=dtype, max_p=5,
                      evaluator=evaluator, **config),
        device=DEV,
    )
    return plan, pts, q


def phase_kernels_small():
    """Build the four kernels, then check each at f32 and f64 on a small
    problem with ragged leaves: near_panel (dummy chunks and dummy
    tiles; then the stores of ``NEAR_RAGGED_STORES``, also against the
    plain model of the kernel's two passes), otf_tile (kappa 0 and 0.5,
    both BC flags; then a full leaf, a leaf of one real slot, a target
    leaf without pairs, and a warp of both BC flags) on a recursion-5
    sphere and at the quadrature orders
    of ``OTF_SMALL_KQ`` on a recursion-4 one, and on the pair list of a
    local-evaluation (near-field-only) plan on a recursion-6 sphere
    (timed at f32; returned with the launches of one matvec of that
    plan), p2p_tile on 20,000 points
    (then a full leaf, a leaf of one real point, a target leaf without
    pairs, a leaf with more sources than two stages hold, and coincident
    points in two leaves of a pair), then both count-table kernels on bad
    tables (``BAD_TABLES``, each under a watchdog),
    panel_contract and the two-stage route on the scalar store of that
    sphere, on both 3x3-block stores of a recursion-4
    Stokes sphere and on the synthetic stores of
    ``CONTRACT_EDGE_STORES``."""
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
            panels, meta, len(plan.leaf_ids), tol, "recursion5",
            tiled_model=True,
        ))
        # ragged stores: every way a leaf meets the block edges
        for label in NEAR_RAGGED_STORES:
            store, smeta, nsrc, holds = near_ragged_store(label, tdt)
            rec = check_near_panel(store, smeta, nsrc, tol, f"edge_{label}",
                                   tiled_model=True)
            rec["edge_cases"] = holds
            checks.append(rec)
            del store
        if dtype == "float32" and not any(
                c["case"] == "edge_ragged" and c["S"] > 1 for c in checks):
            fail("the ragged near_panel store ran at one chunk per block")
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
        checks.extend(check_contract_edges(tdt, tol))
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
            # the edge cases: full leaf, one real slot, no pairs; both
            # BC flags in one warp on top of this variant's tables
            for mixed in (False, True):
                et, eq, leaves = otf_edge_tiles(ot, ql, mixed)
                name = f"edge_{bc}{'_mixed_bc' if mixed else ''}"
                for kappa in (0.0, 0.5):
                    rec = check_otf_tile(oplan, et, eq, kappa, tol, name)
                    rec["edge_leaves"] = leaves
                    checks.append(rec)
        # quadrature orders other than 3 take the kernel's run-time KQ;
        # at f64 two stages of 256 panels of KQ = 25 would need 416 KB of
        # shared memory, so the kernel cuts its stages to what fits
        for kq in OTF_SMALL_KQ:
            kplan, _ = build_plan(4, dtype, ncrit=32, leaf_pad=None,
                                  near_mode="otf", K=kq)
            kql, _ = leaf_charges(kplan, tdt)
            kot = kplan.near_panels()[0]["otf_tiles"]
            if (kot["sb_src"].shape[1] - 3) // 4 != kq:
                fail(f"small otf_tile case of KQ = {kq} has another order")
            et, eq, _ = otf_edge_tiles(kot, kql, True)
            for kappa in (0.0, 0.5):
                checks.append(check_otf_tile(
                    kplan, kot, kql, kappa, tol, f"recursion4_KQ{kq}"))
                checks.append(check_otf_tile(
                    kplan, et, eq, kappa, tol, f"edge_KQ{kq}_mixed_bc"))
        # a near-field-only operator (local evaluation) through the
        # on-the-fly near field: the kernel on its pair list alone
        lplan, ln = build_plan(6, dtype, ncrit=32, leaf_pad=None,
                               near_mode="otf", local_evaluation=True)
        lql, _ = leaf_charges(lplan, tdt)
        lot = lplan.near_panels()[0]["otf_tiles"]
        for kappa in (0.0, 0.5):
            rec = check_otf_tile(lplan, lot, lql, kappa, tol,
                                 "local_evaluation_recursion6",
                                 time_it=dtype == "float32")
            checks.append(rec)
            if dtype == "float32" and kappa == 0.0:
                local_otf = rec
        reset_launch_counts()  # one near-only matvec, counted alone
        lplan.apply(np.ones(ln, np.float32), p=5)
        torch.cuda.synchronize()
        local_otf["launch_counts"] = launch_counts()
        if local_otf["launch_counts"] != {**dict.fromkeys(WRAPPERS, 0),
                                          "otf_tile": 1}:
            fail(f"a local-evaluation OTF matvec launched "
                 f"{local_otf['launch_counts']}")
        del lplan, lot, lql
        pplan, _, _ = point_plan(20000, 5, dtype, ncrit=32)
        ql, mask = leaf_charges(pplan, tdt)
        if bool(mask.all()):
            fail("small p2p_tile case has no padded slot")
        tb = p2p_tables(pplan.device_data(5), ql)
        checks.append(check_p2p_tile(pplan, tb, tol, "points20000"))
        # the edge cases: full leaf, one real point, no pairs, more
        # sources than two stages, coincident points across a pair
        et, leaves = p2p_edge_tables(tb, pplan.leaf_pad, tdt)
        rec = check_p2p_tile(pplan, et, tol, "edge_points20000")
        rec["edge_leaves"] = leaves
        checks.append(rec)
        # bad count tables and pair lists, each under a watchdog
        ot = oplan.near_panels()[0]["otf_tiles"]
        oql, _ = leaf_charges(oplan, tdt)
        checks.extend(check_bad_tables(ot, tb, oql, dtype, tol))
    if sum(c["case"].startswith("bad_") for c in checks) != 2 * 9:
        fail("kernels_small lacks a bad-table case")
    return build_s, checks, local_otf


def run_solve(plan, b, cfg, **kw):
    """``solve_plan`` on the card, timed.  Returns (the record every
    solve prints, the solution)."""
    torch.cuda.synchronize()
    t0 = time.time()
    x, info, _ = solve_plan(plan, b, cfg, **kw)
    return {
        "solve_s": time.time() - t0, "iterations": info.iterations,
        "converged": bool(info.converged), "residual": info.residual,
        "p_schedule": [int(h[2]) for h in info.history],
        "residual_history": [float(h[1]) for h in info.history],
    }, x


def first_kind_config():
    """The first-kind solve's configuration: residual 1e-5, the relaxed
    order with tiers (3, 5, 10) and the floor of 1."""
    return fbt.SolverConfig(
        residual=1e-5, max_iters=100, restart=100, max_p=10, p_min=1,
        p_tiers=(3, 5, 10),
    )


def first_kind_solve(plan, n, p_fixed=None):
    """The first-kind solve on the sphere: G system, RHS = dGdn . 1 at
    p=10, solution 1; relaxed order with tiers (3, 5, 10), or the fixed
    order ``p_fixed``.  Returns (record, solution, RHS)."""
    ones = np.ones(n, np.dtype(plan.config.dtype))
    b1 = plan.apply_flipped_bc(ones, p=10)[:, 0].cpu().numpy()
    rec, x1 = run_solve(plan, b1, first_kind_config(), p_fixed=p_fixed)
    rec["err"] = float(np.linalg.norm(x1 - 1.0) / np.sqrt(n))
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
    second, x2 = run_solve(plan, b2, cfg2, flipped=True, p_fixed=p)
    err2 = second["solution_err"] = float(
        np.linalg.norm(x2 - 1.0) / np.sqrt(n))

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
        "second_kind": second,
        "first_kind_relaxed": first,
        "first_kind_fixed": fixed,
        "matvecs": calls["matvecs"], "kernel": kernel,
        "kernel_launches": launches, "launch_counts": counts,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if not (second["converged"] and first["converged"]):
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


def dev_us(ev):
    """Device microseconds of a profiler event, by either attribute
    name torch has used."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def device_ops(fn):
    """One call of ``fn()`` under torch.profiler: its device operations
    by name, {name: [device us, launches]}, and the profiled window in
    us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        window_us = (time.time() - t0) * 1e6
    ops = {e.key: [dev_us(e), int(e.count)] for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA}
    return ops, window_us


def idle_share(ops, ms):
    """The card's idle share of a call that takes ``ms`` as it runs
    unprofiled (the profiler slows the host, so its own window overstates
    the idle time), from the device operations ``ops`` it ran
    (``device_ops``); None where the profiler saw no device time."""
    busy_us = sum(v[0] for v in ops.values())
    return max(0.0, 1.0 - busy_us / (ms * 1e3)) if busy_us > 0 else None


def phase_profile(plan, charges, p=5, phase="profile"):
    """The matvec's phases timed by CUDA events, then one matvec under
    torch.profiler: top device operations, launches, busy time; and the
    device launches of the L2P and M2P phases alone."""
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
    def t(fn):  # one batch of 10: most phases are host-bound
        return gpu_ms(fn, 10, batches=1)

    phase_ms = {
        "p2m": t(lambda: plan._p2m_slots(d, aux, q_t, p)),
        "m2m": t(lambda: plan._phase_m2m(d, M0.clone())),
        "m2l": t(lambda: plan._phase_m2l(d, M, p)),
        "l2l": t(lambda: plan._phase_l2l(d, L0.clone())),
        "l2p": t(lambda: plan._l2p_slots(d, aux, L, p)),
        "m2p": t(lambda: plan._m2p_pass(d, tf, M, p, nl, K))
        if len(plan.m2p_src) else 0.0,
        "near": t(lambda: plan._near_pass_slots(aux, q_t))
        if "panels" in aux
        else t(lambda: plan._p2p_pass(d, sf, tf, q_t, nl, K)),
        "matvec": t(lambda: mv(operand, x, p)),
    }
    if plan._otf_near:
        ql = q_t.reshape(nl, K)
        phase_ms["near_corrections"] = t(
            lambda: plan._near_otf_corr(aux["panels"], ql, ql))

    by_name, window_us = device_ops(lambda: mv(operand, x, p))

    phase_launches = {"l2p": device_launches(
        lambda: plan._l2p_slots(d, aux, L, p))[0]}
    if len(plan.m2p_src):
        phase_launches["m2p"] = device_launches(
            lambda: plan._m2p_pass(d, tf, M, p, nl, K))[0]
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    rec = {
        "phase": phase, "p": p,
        "device_busy_us": busy_us if busy_us > 0 else None,
        "device_idle_share": idle_share(by_name, phase_ms["matvec"]),
        "profiled_window_us": window_us,
        "device_launches": sum(v[1] for v in by_name.values()),
        "top_device_ops": [
            {"name": k[:120], "us": v[0], "calls": v[1]} for k, v in top
        ],
        "phase_ms": phase_ms,
        "phase_launches": phase_launches,
    }
    rec["m2l_family_classes"] = (
        0 if plan.m2l_fam is None else len(plan.m2l_fam.cls_sp)
    )
    rec["m2p_pairs"] = int(len(plan.m2p_src))
    emit(rec)
    return rec


def phase_faults(label, out, plan, near):
    """What a ``roofline.phase_breakdown`` record of ``plan`` must show:
    its phases in the order of the plan's matvec (M2P where the plan
    has level-skewed pairs, ``near`` last), no negative time, no share
    of a peak over 100 % that is not marked ``unreliable``."""
    want = ["p2m", "m2m", "m2l", "l2l", "l2p"]
    want += ["m2p"] * bool(len(plan.m2p_src)) + [near, "total"]
    faults = []
    if list(out) != want:
        faults.append(f"{label}: phases {list(out)}, not {want}")
    for nm, r in out.items():
        if nm == "total":
            continue
        if r["ms"] < 0.0:
            faults.append(f"{label}: {nm} takes {r['ms']} ms")
        over = [k for k in ("pct_mxu", "pct_hbm") if r.get(k, 0.0) > 100.0]
        if over and not r.get("unreliable"):
            faults.append(f"{label}: {nm} reads {over} over 100 %")
    if out["total"]["device"] != torch.cuda.get_device_name(plan.device):
        faults.append(f"{label}: the record names {out['total']['device']}")
    return faults


def phase_bench_record(plan, build_s, main_rec):
    """The bench record of the paper's workload (``utils/bench_impl.py``)
    on the cached path's plan, which is built with the bench's own
    configuration: the chained matvec, both solves, ``near_panel``
    against its plain version, the phases at p=5 and p=10.  The
    first-kind solve must repeat ``main_path``'s and the p=5 phases
    must telescope to the matvec (``sum_ratio`` within 15 %)."""
    reset_launch_counts()
    rec = bench_impl.measure(plan, build_s, p=5)
    counts = launch_counts()
    phases, phases10 = rec.pop("phases"), rec.pop("phases_p10")
    emit({"phase": "bench_record", **rec, "launch_counts": counts})
    emit({"phase": "bench_phases_p5", **phases})
    emit({"phase": "bench_phases_p10", **phases10})
    fk, want = rec["solve_first_kind_relaxed"], main_rec["first_kind_relaxed"]
    faults = phase_faults("p=5", phases, plan, "near")
    faults += phase_faults("p=10", phases10, plan, "near")
    if not (rec["solve_converged"] and fk["converged"]):
        faults.append("a solve did not converge")
    if not (rec["solution_err"] <= 5e-3 and fk["err"] <= 5e-3):
        faults.append(f"solution errors {rec['solution_err']:.3e} / "
                      f"{fk['err']:.3e} above 5e-3")
    if (fk["iters"], fk["p_schedule"]) != (want["iterations"],
                                           want["p_schedule"]):
        faults.append(f"first kind {fk['iters']} {fk['p_schedule']}, "
                      f"main_path {want['iterations']} {want['p_schedule']}")
    if not (rec["near_equiv_err"] is not None
            and rec["near_equiv_err"] <= 1e-5):
        faults.append(f"near_equiv_err {rec['near_equiv_err']} above 1e-5")
    if phases["total"]["suspect"]:
        faults.append(f"the p=5 phases do not telescope to the matvec: "
                      f"sum_ratio {phases['total']['sum_ratio']}")
    if counts["near_panel"] == 0:
        faults.append("the record did not go through near_panel")
    if faults:
        fail("bench_record: " + "; ".join(faults))


def phase_breakdown_record(phase, plan, near):
    """``roofline.phase_breakdown`` once on a path's plan at p=5 (chain
    16, 2 repeats), so that every branch of the phase list runs on the
    card; ``suspect`` and ``sum_ratio`` are printed, not held."""
    out = roofline.phase_breakdown(plan, 5, chain=16, repeats=2)
    emit({"phase": phase, **out})
    faults = phase_faults(phase, out, plan, near)
    if faults:
        fail("; ".join(faults))


def emit_plan_build(phase, plan, host_build_s, **extra):
    """The plan's sizes; a dual plan's per tree as [sources, targets]."""
    sides = (plan.src, plan.tgt) if plan.dual else (plan.src,)

    def per_side(f):
        vals = [f(side) for side in sides]
        return vals if plan.dual else vals[0]

    emit({
        "phase": phase, "host_build_s": host_build_s,
        "n_bodies": per_side(lambda side: side.tree.num_bodies),
        "leaves": per_side(lambda side: len(side.leaf_ids)),
        "leaf_pad": per_side(lambda side: side.leaf_pad),
        "levels": per_side(lambda side: int(side.tree.num_levels)),
        "near_pairs": int(len(plan.p2p_src_slot)),
        "m2l_pairs": int(len(plan.lists.m2l_pairs)),
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
        "plan_build", plan, host_build_s, near_store_s=time.time() - t0,
        near_store_bytes=nbytes_of(panels["A"]),
    )
    nl = len(plan.leaf_ids)
    full = check_near_panel(panels, meta, nl, 1e-5, "main_path", time_it=True)
    panels64 = dict(panels, A=panels["A"].double())
    full64 = check_near_panel(panels64, meta, nl, 1e-12, "main_path")
    del panels64
    torch.cuda.empty_cache()
    main_rec, x1, _, _ = phase_main_path(plan, n)
    phase_bench_record(plan, host_build_s, main_rec)
    phase_profile(plan, np.ones(n, np.float32))
    phase_cached_solvers(plan, fields, n, main_rec["first_kind_relaxed"])
    near_entries = []
    near_checks = phase_near_only(plan, fields, n, near_entries)
    phase_body_order(plan, "cached", "near_panel", 5)

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
    phase_body_order(oplan, "cached_otf", "otf_tile", 5)
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
    del oplan, store
    torch.cuda.empty_cache()
    phase_coo_replay(plan, fields, cached1, recursions)
    let_checks, let_entries = path_let(
        plan, n, cached1, min(LET_F64_RECURSIONS, recursions))
    return [full, full64, *near_checks, *let_checks], [kernel_entry(
        "near_panel", "fmm_bem_tpu/ops/near_panel.py:539", full,
        main_rec["kernel_launches"],
    ), *near_entries, *let_entries]


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
        "otf_plan_build", plan, host_build_s,
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
    yukawa64 = check_otf_tile(plan, ot64, ql.double(), 0.5, 1e-12,
                              "otf_path_kappa0.5")
    del ot64
    torch.cuda.empty_cache()
    main_rec, _, b1, b2 = phase_main_path(
        plan, n, chain=20, phase="otf_path", kernel="otf_tile",
        err1_limit=OTF_FIRST_KIND_ERR_LIMIT, baseline_p=10)
    phase_profile(plan, np.ones(n, np.float32), phase="otf_profile")
    phase_breakdown_record("otf_phases", plan, "near")
    phase_body_order(plan, "otf", "otf_tile", 5)
    del plan, store, ot, ql
    phase_otf_f64(recursions, n, main_rec, b1, b2)
    return [full, yukawa, full64, yukawa64], kernel_entry(
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
    deeper.  Then the point LET on its plan (``phase_let_points``)."""
    torch.cuda.empty_cache()
    base, bpts, bq = point_plan(nbase, 31)
    base_err = sample_errors(base, bpts, bq, base.apply(bq, p=5))
    del base

    t0 = time.time()
    plan, pts, q = point_plan(npoints, 32)
    host_build_s = time.time() - t0
    emit_plan_build("points_plan_build", plan, host_build_s)
    ql, _ = leaf_charges(plan, torch.float32)
    d = plan.device_data(5)
    full = check_p2p_tile(plan, p2p_tables(d, ql), 1e-5, "points_path",
                          time_it=True)
    full64 = check_p2p_tile(plan, p2p_tables(d, ql.double()), 1e-12,
                            "points_path")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # every kernel count, just before the run
    t0 = time.time()
    out = plan.apply(q, p=5)
    torch.cuda.synchronize()
    first_apply_s = time.time() - t0
    counts = launch_counts()  # ... and read just after it
    apply_ms = gpu_ms(lambda: plan.apply(q, p=5), 5, 1, batches=1)
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
    phase_breakdown_record("points_phases", plan, "p2p")
    phase_body_order(plan, "points", "p2p_tile", 5)
    phase_let_points(plan, q)
    return [full, full64], kernel_entry(
        "p2p_tile", "fmm_bem_tpu/ops/p2p_tile.py:180", full,
        counts["p2p_tile"],
    )


def drive_slot_path(plan, kernel, orders, x0, chain, solves):
    """Drive a BEM plan through the entry points a user calls, counting
    the slot matvecs it runs: every launch count is set to 0, the
    operand of the first of ``orders`` is built (``tables_s``),
    ``solves()`` runs (right-hand sides and solves), then ``chain``
    chained slot matvecs from ``x0`` (user order) at each of ``orders``,
    normalised at every step.  Returns (what ``solves`` returned, the
    record's fields); ``hold_launches`` holds the launches of the path's
    near-field ``kernel`` to the matvecs."""
    calls = {"matvecs": 0}
    inner = plan._matvec_slots

    def counted(*a, **k):
        calls["matvecs"] += 1
        return inner(*a, **k)

    plan._matvec_slots = counted
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # every kernel count, just before the run
    try:
        t0 = time.time()
        mv, op4p, to_s, _, nslots = plan.solver_ops_slots()
        op4p(orders[0])
        torch.cuda.synchronize()
        tables_s = time.time() - t0
        out = solves()
        matvec_ms, per_matvec = {}, {}
        for p in orders:
            operand = op4p(p)
            x = to_s(x0)
            for _ in range(2):
                y = mv(operand, x, p)
                x = y / torch.linalg.vector_norm(y)
            torch.cuda.synchronize()
            before = calls["matvecs"], launch_counts()[kernel]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(chain):
                y = mv(operand, x, p)
                x = y / torch.linalg.vector_norm(y)
            b.record()
            torch.cuda.synchronize()
            matvec_ms[f"p{p}"] = a.elapsed_time(b) / chain
            per_matvec[f"p{p}"] = ((launch_counts()[kernel] - before[1])
                                   / (calls["matvecs"] - before[0]))
            if not torch.isfinite(x).all() or float(x.abs().max()) == 0.0:
                fail(f"chained matvecs of {type(plan.kernel).__name__} "
                     "gave non-finite or zero values")
        counts = launch_counts()  # ... and read just after it
    finally:
        plan._matvec_slots = inner
    return out, {
        "nslots": nslots, "tables_s": tables_s, "matvec_ms": matvec_ms,
        "chain": chain, "launches_per_matvec": per_matvec,
        "matvecs": calls["matvecs"], "kernel": kernel,
        "kernel_launches": counts[kernel], "launch_counts": counts,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }


def hold_launches(rec, path):
    """Fail unless the path's kernel launched once per matvec the plan
    ran, and no other kernel launched."""
    kernel, counts = rec["kernel"], rec["launch_counts"]
    others = sum(v for k, v in counts.items() if k != kernel)
    own = rec.get("kernel_launches_per_plan", [rec["matvecs"]])
    per_plan = rec.get("matvecs_per_plan", [rec["matvecs"]])
    if (counts[kernel] == 0 or counts[kernel] != rec["matvecs"] or others
            or own != per_plan):
        fail(f"{kernel} launched {counts[kernel]} times in {rec['matvecs']} "
             f"matvecs ({own} in the matvecs {per_plan} of each plan; all "
             f"counts: {counts}): the {path} path did not go through its "
             "kernel, and no other, once per matvec")


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
    rec, x = run_solve(plan, b, cfg, p_fixed=p_fixed)
    exact = 6.0 * np.pi * STOKES_MU
    ok_shape = x.shape == (3 * n,) and bool(np.isfinite(x).all())
    fx = float((x.reshape(n, 3)[:, 0] * fields["area"]).sum()) if ok_shape \
        else float("nan")
    return {
        **rec, "finite_and_shaped": ok_shape,
        "drag": fx, "drag_exact": exact, "drag_err": abs(fx - exact) / exact,
    }


def phase_stokes_path(plan, fields, n, chain, phase):
    """The Stokes path through the entry points a user calls: the
    right-hand side by ``apply_flipped_bc``, both solves by
    ``solve_plan``, chained slot matvecs at the solve's order and at the
    floor; the launches of ``panel_contract`` held against the matvecs
    the plan ran."""
    u = np.tile([1.0, 0.0, 0.0], (n, 1))

    def solves():
        t0 = time.time()
        rhs = plan.apply_flipped_bc(u, p=STOKES_P).cpu().numpy()
        rhs_s = time.time() - t0
        return (rhs, rhs_s, stokes_solve(plan, fields, n),
                stokes_solve(plan, fields, n, p_fixed=STOKES_P))

    (rhs, rhs_s, relaxed, fixed), driven = drive_slot_path(
        plan, "panel_contract", (STOKES_P, STOKES_P_MIN), u, chain, solves)
    rhs_err = float(np.abs(rhs[:, 0] - 4 * np.pi).mean() / (4 * np.pi))
    drag_limit = STOKES_DRAG_ERR_LIMIT * max(1.0, 32768 / n)
    rec = {
        "phase": phase, "n_panels": n, "unknowns": 3 * n,
        "p": STOKES_P, "p_min": STOKES_P_MIN, "mu": STOKES_MU,
        "rhs_s": rhs_s, "rhs_err": rhs_err,
        "rhs_err_limit": STOKES_RHS_ERR_LIMIT,
        "rhs_off_axis_max": float(np.abs(rhs[:, 1:]).max()),
        "relaxed": relaxed, "fixed_p": fixed,
        "drag_err_limit": drag_limit, **driven,
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
    hold_launches(rec, "Stokes")
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
        f"{prefix}_plan_build", plan, host_build_s,
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
    if prefix == "stokes":
        phase_stokes_fmgmres(plan, fields, n, main_rec["relaxed"])
    u = np.tile([1.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    phase_profile(plan, u, p=STOKES_P, phase=f"{prefix}_profile")
    phase_profile(plan, u, p=STOKES_P_MIN, phase=f"{prefix}_profile_p5")
    phase_body_order(plan, prefix, "panel_contract", STOKES_P)
    entry = kernel_entry(
        "panel_contract", "fmm_bem_tpu/ops/near_panel.py:626", full,
        main_rec["kernel_launches"],
    )
    if prefix != "stokes":
        return [full, full64], [entry], host_build_s
    let_checks, let_entries = phase_let_stokes(plan, n)
    return [full, full64, *let_checks], [entry, *let_entries], host_build_s


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


def yukawa_plan(recursions, dtype):
    """``YukawaBEMKernel`` plan on the unit sphere at the reference
    program's operating point."""
    fields = make_panels(unit_sphere(recursions), K=3)
    plan = fbt.FmmPlan(
        YukawaBEMKernel(K=3, kappa=YUKAWA_KAPPA), fields,
        fbt.FMMConfig(theta=0.5, ncrit=64, leaf_pad=64, max_p=YUKAWA_P,
                      dtype=dtype),
        device=DEV,
    )
    return plan, len(fields["xyz"])


def yukawa_solve(plan, n):
    """The screened first-kind problem of examples/yukawa_bem.py: phi = 1
    on the sphere, RHS = the flipped operator on 1 at p=8, the relaxed
    solve; the mean dphi/dn against the interior analytic value.
    Returns (record, solution)."""
    ones = np.ones(n, np.dtype(plan.config.dtype))
    torch.cuda.synchronize()
    t0 = time.time()
    b = plan.apply_flipped_bc(ones, p=YUKAWA_P)[:, 0].cpu().numpy()
    rhs_s = time.time() - t0
    cfg = fbt.SolverConfig(
        residual=1e-5, max_iters=200, restart=200, max_p=YUKAWA_P,
        p_tiers=default_p_tiers(YUKAWA_P),
    )
    rec, x = run_solve(plan, b, cfg)
    kappa = plan.kernel.kappa
    exact = -(kappa / np.tanh(kappa) - 1.0)
    ok = x.shape == (n,) and bool(np.isfinite(x).all())
    mean = float(x.mean()) if ok else float("nan")
    return {
        "rhs_s": rhs_s, **rec, "finite_and_shaped": ok, "mean_dphi_dn": mean,
        "analytic": exact, "analytic_err": abs(mean - exact) / abs(exact),
    }, x


def hold_yukawa_solve(sol, what):
    if not (sol["converged"] and sol["finite_and_shaped"]):
        fail(f"the {what} Yukawa solve: {sol}")
    if not sol["analytic_err"] <= YUKAWA_ANALYTIC_LIMIT:
        fail(f"the {what} Yukawa mean dphi/dn is {sol['analytic_err']:.3e} "
             f"off the analytic value (limit {YUKAWA_ANALYTIC_LIMIT:.0e})")


def phase_yukawa_path(plan, n, chain=20):
    """The Yukawa BEM path through the entry points a user calls: the
    right-hand side, the relaxed solve, chained slot matvecs at p=8 and
    p=5; the launches of ``near_panel`` held against the matvecs the
    plan ran.  Returns the solve's record."""
    solve, driven = drive_slot_path(
        plan, "near_panel", (YUKAWA_P, 5), np.ones(n, np.float32), chain,
        lambda: yukawa_solve(plan, n)[0])
    rec = {
        "phase": "yukawa_path", "n_panels": n,
        "kappa": plan.kernel.kappa, "p": YUKAWA_P,
        "p_tiers": list(default_p_tiers(YUKAWA_P)),
        "first_kind_relaxed": solve,
        "analytic_limit": YUKAWA_ANALYTIC_LIMIT, **driven,
    }
    emit(rec)
    hold_yukawa_solve(solve, "f32")
    hold_launches(rec, "Yukawa")
    return solve


def phase_yukawa_f64_full(recursions, f32, f32_host):
    """The Yukawa solve once more in f64 on the path's sphere, beside the
    f32 one (``f32``, its record) and the f32 one through the host loop
    (``f32_host``): whether f32 rounding is what keeps the f32 solve at
    p=8 there, and whether the f32 Hessenberg state is the part of it
    that does."""
    torch.cuda.empty_cache()
    t0 = time.time()
    plan, n = yukawa_plan(recursions, "float64")
    host_build_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    sol, _ = yukawa_solve(plan, n)
    del plan
    rel = abs(f32["mean_dphi_dn"] - sol["mean_dphi_dn"]) / abs(
        sol["mean_dphi_dn"])
    emit({
        "phase": "yukawa_f64_full", "n_panels": n,
        "host_build_s": host_build_s, "f64": sol,
        "f32": {k: f32[k] for k in ("iterations", "p_schedule", "residual",
                                    "mean_dphi_dn")},
        "f32_host_loop": {k: f32_host[k] for k in (
            "iterations", "p_schedule", "residual", "mean_dphi_dn")},
        "mean_dphi_dn_f32_vs_f64_rel": rel, "limit": YUKAWA_F32_F64_LIMIT,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    })
    hold_yukawa_solve(sol, f"f64 (recursion {recursions})")
    if not rel <= YUKAWA_F32_F64_LIMIT:
        fail(f"the f32 Yukawa mean dphi/dn is {rel:.3e} off the f64 one at "
             f"recursion {recursions}")


def phase_yukawa_f64(recursions):
    """The Yukawa operator and solve on a smaller sphere in f32 and in
    f64 (the JAX package on a CPU is no f32 oracle for whole matvecs, so
    f32 is held to the port's own f64): one matvec each at p=8 and p=5
    on the same two vectors (1 and a seeded normal one), then the
    solves."""
    torch.cuda.empty_cache()
    plans = {dt: yukawa_plan(recursions, dt)[0]
             for dt in ("float32", "float64")}
    n = plans["float64"].src.tree.num_bodies
    vectors = {"ones": np.ones(n),
               "normal": np.random.default_rng(23).standard_normal(n)}
    matvec = {}
    for name, v in vectors.items():
        for p in (YUKAWA_P, 5):
            y32 = plans["float32"].apply(v, p=p).double()
            y64 = plans["float64"].apply(v, p=p)
            matvec[f"{name}_p{p}"] = float((y32 - y64).norm() / y64.norm())
    out = {dt: yukawa_solve(plan, n) for dt, plan in plans.items()}
    del plans
    x32, x64 = out["float32"][1], out["float64"][1]
    m32 = out["float32"][0]["mean_dphi_dn"]
    m64 = out["float64"][0]["mean_dphi_dn"]
    rec = {
        "phase": "yukawa_f64", "n_panels": n,
        "matvec_f32_vs_f64_rel_l2": matvec,
        "matvec_limit": YUKAWA_F32_F64_MATVEC_LIMIT,
        "f32": out["float32"][0], "f64": out["float64"][0],
        "mean_dphi_dn_f32_vs_f64_rel": abs(m32 - m64) / abs(m64),
        "limit": YUKAWA_F32_F64_LIMIT,
        "solution_f32_vs_f64_rel_l2": float(
            np.linalg.norm(x32 - x64) / np.linalg.norm(x64)),
        "solution_limit": YUKAWA_F32_F64_VECTOR_LIMIT,
    }
    emit(rec)
    for dtype in out:
        hold_yukawa_solve(out[dtype][0],
                          f"{dtype} (recursion {recursions})")
    worst = max(matvec.values())
    if not worst <= YUKAWA_F32_F64_MATVEC_LIMIT:
        fail(f"the f32 Yukawa matvec is {worst:.3e} off the f64 one "
             f"(limit {YUKAWA_F32_F64_MATVEC_LIMIT:.0e}): {matvec}")
    if not (rec["mean_dphi_dn_f32_vs_f64_rel"] <= YUKAWA_F32_F64_LIMIT
            and rec["solution_f32_vs_f64_rel_l2"]
            <= YUKAWA_F32_F64_VECTOR_LIMIT):
        fail("the f32 Yukawa solve is not the f64 one: mean "
             f"{rec['mean_dphi_dn_f32_vs_f64_rel']:.3e}, solution "
             f"{rec['solution_f32_vs_f64_rel_l2']:.3e}")


def path_yukawa(recursions, small_recursions):
    """The Yukawa BEM path: plan build (per-level translation classes),
    ``near_panel`` on its store of screened entries, the solve and the
    chained matvecs, the profiles at p=8 and p=5, the solve in f64; then
    f32 against f64 on a smaller sphere.  Returns the near_panel checks
    on this path's store."""
    torch.cuda.empty_cache()
    t0 = time.time()
    plan, n = yukawa_plan(recursions, "float32")
    host_build_s = time.time() - t0
    t0 = time.time()
    panels, meta = plan.near_panels()
    torch.cuda.synchronize()
    fam = plan.m2l_fam
    emit_plan_build(
        "yukawa_plan_build", plan, host_build_s,
        near_store_s=time.time() - t0,
        near_store_bytes=nbytes_of(panels["A"]),
        m2m_octant_matrices=len(plan.src.m2m_mats),
        m2l_classes=len(plan.m2l_classes.src),
        m2l_family_classes=0 if fam is None else len(fam.cls_sp),
        host_class_operator_bytes_f64=int(
            plan.m2l_classes.mats.nbytes + (0 if fam is None
                                            else fam.mats.nbytes)),
    )
    nl = len(plan.leaf_ids)
    near = check_near_panel(panels, meta, nl, 1e-5, "yukawa_path",
                            time_it=True)
    torch.cuda.empty_cache()
    solve = phase_yukawa_path(plan, n)
    host = phase_yukawa_host(plan, n)
    ones = np.ones(n, np.float32)
    phase_profile(plan, ones, p=YUKAWA_P, phase="yukawa_profile")
    phase_profile(plan, ones, p=5, phase="yukawa_profile_p5")
    phase_body_order(plan, "yukawa", "near_panel", YUKAWA_P)
    del plan, panels
    phase_yukawa_f64_full(recursions, solve, host)
    phase_yukawa_f64(small_recursions)
    return [near]


def path_point_kernels(scale):
    """The other point kernels and the treecode evaluator: one ``apply``
    each at p=5 (the count of ``POINT_KERNEL_RUNS`` times ``scale``),
    errors of potential and force against direct summation in f64 on
    1,000 targets, held to three times the error the same kernel shows on
    ``POINT_KERNEL_BASE`` points.  The Yukawa kernels run no hand-written
    kernel (their near field is the kernel's own batched ``p2p_block``,
    as in the JAX package); the treecode's near field is ``p2p_tile``,
    once per apply, and is first held against its plain version on that
    plan's tables, at f32 and f64."""
    recs = []
    for name, kernel, evaluator, npoints in POINT_KERNEL_RUNS:
        torch.cuda.empty_cache()
        nbase = min(POINT_KERNEL_BASE, int(npoints * scale))
        base, bpts, bq = point_plan(nbase, 31, kernel=kernel,
                                    evaluator=evaluator)
        base_err = sample_errors(base, bpts, bq, base.apply(bq, p=5))
        del base
        n = int(npoints * scale)
        t0 = time.time()
        plan, pts, q = point_plan(n, 32, kernel=kernel, evaluator=evaluator)
        host_build_s = time.time() - t0
        if evaluator == Evaluator.TREECODE:
            # p2p_tile at the shapes the treecode plan gives it
            ql, _ = leaf_charges(plan, torch.float32)
            d = plan.device_data(5)
            checks = [
                check_p2p_tile(plan, p2p_tables(d, ql), 1e-5, name,
                               time_it=True),
                check_p2p_tile(plan, p2p_tables(d, ql.double()), 1e-12, name),
            ]
            del ql, d
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()  # every kernel count, just before the run
        t0 = time.time()
        out = plan.apply(q, p=5)
        torch.cuda.synchronize()
        first_apply_s = time.time() - t0
        counts = launch_counts()  # ... and read just after it
        apply_ms = gpu_ms(lambda: plan.apply(q, p=5), 2, 1, batches=1)
        err_pot, err_force = sample_errors(plan, pts, q, out)
        rec = {
            "phase": f"point_kernel_{name}",
            "kernel": type(plan.kernel).__name__,
            "evaluator": evaluator.value, "n_points": n,
            "count_before_cut": npoints, "p": 5,
            "host_build_s": host_build_s, "first_apply_s": first_apply_s,
            "apply_ms": apply_ms, "leaves": len(plan.leaf_ids),
            "near_pairs": int(len(plan.p2p_src_slot)),
            "m2l_pairs": int(len(plan.lists.m2l_pairs)),
            "m2p_pairs": int(len(plan.m2p_src)),
            "rel_l2_err_potential": err_pot, "rel_l2_err_force": err_force,
            "sample": 1000,
            "truncation_err_at": {"n_points": nbase, "potential": base_err[0],
                                  "force": base_err[1]},
            "limit": {"potential": 3 * base_err[0],
                      "force": 3 * base_err[1]},
            "launch_counts": counts,
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
        }
        emit(rec)
        recs.append(rec)
        if out.shape != (n, 4) or not torch.isfinite(out).all():
            fail(f"the {name} result is not finite values of shape [n, 4]")
        if err_pot > 3 * base_err[0] or err_force > 3 * base_err[1]:
            fail(f"{name}: errors {err_pot:.3e} / {err_force:.3e} above "
                 f"three times the truncation error {base_err}")
        want = dict.fromkeys(WRAPPERS, 0)
        if evaluator == Evaluator.TREECODE:
            want["p2p_tile"] = 1
            if rec["m2l_pairs"] or not rec["m2p_pairs"]:
                fail(f"the treecode plan has {rec['m2l_pairs']} M2L and "
                     f"{rec['m2p_pairs']} M2P pairs")
        if counts != want:
            fail(f"one {name} apply launched {counts}, expected {want}")
        if evaluator == Evaluator.TREECODE:
            emit({"phase": "kernels", "kernel": "p2p_tile", "path": name,
                  "checks": checks, "launches": counts["p2p_tile"]})
        del plan, out
    return recs


# ----------------------------------------------------------------------
# the solvers around the matvec: host GMRES / FGMRES, the diagonal,
# block-diagonal and local-inner preconditioners, FMGMRES, the
# near-field-only plans, and the three example programs
# ----------------------------------------------------------------------


def counted_run(plans, kernel, fn, what):
    """Run ``fn()`` with every launch count set to 0 just before it and
    read just after, counting the slot matvecs each of ``plans`` runs;
    fail unless ``kernel`` launched once per matvec and no other kernel
    launched.  The launches of ``kernel`` are also read around each
    plan's own matvecs (``kernel_launches_per_plan``).  Returns (what
    ``fn`` returned, the record's fields)."""
    calls = [0] * len(plans)
    own = [0] * len(plans)
    inners = [plan._matvec_slots for plan in plans]
    for k, plan in enumerate(plans):
        def wrapped(*a, _k=k, **kw):
            calls[_k] += 1
            before = WRAPPERS[kernel].launches
            out = inners[_k](*a, **kw)
            own[_k] += WRAPPERS[kernel].launches - before
            return out
        plan._matvec_slots = wrapped
    torch.cuda.synchronize()
    reset_launch_counts()  # every kernel count, just before the run
    try:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = launch_counts()  # ... and read just after it
    finally:
        for plan, inner in zip(plans, inners):
            plan._matvec_slots = inner
    rec = {"seconds": seconds, "matvecs": sum(calls),
           "matvecs_per_plan": calls, "kernel": kernel,
           "kernel_launches": counts[kernel],
           "kernel_launches_per_plan": own, "launch_counts": counts}
    hold_launches(rec, what)
    return out, rec


def solve_record(x, info, mode, seconds, n, exact=1.0):
    """The fields every solve prints; ``err`` is the RMS distance of the
    user-order solution from ``exact``."""
    ok = x.shape == (n,) and bool(np.isfinite(x).all())
    return {
        "mode": mode, "solve_s": seconds, "iterations": info.iterations,
        "converged": bool(info.converged), "residual": float(info.residual),
        "p_schedule": [int(h[2]) for h in info.history],
        "finite_and_shaped": ok,
        "err": float(np.linalg.norm(x - exact) / np.sqrt(n)) if ok
        else float("nan"),
    }


def timed_solve(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def laplace_diagonal(fields, kern):
    """The diagonal preconditioner of examples/laplace_bem.py (``-pc
    diagonal``): each panel's self term, G or dG/dn by its BC flag."""
    n = len(fields["xyz"])
    idx = np.arange(n)
    G, dG = near_entries_laplace(fields, fields, idx, idx, fine_K=kern.fine_K)
    return np.where(np.asarray(fields["bc"]) == 0.0, G, dG)


def true_residual(plan, b, x):
    """||b - A x|| / ||b|| with A the plan's operator at p=10, for a
    user-order solution ``x``: what a converged solve promises."""
    b = torch.as_tensor(b, device=DEV)
    ax = plan.apply(x, p=10)[:, 0]
    return float((b - ax).norm() / b.norm())


#: the true residual a solve stopped at 1e-5 must reach: the estimate
#: and the f32 operator's rounding (1.8e-7 relative for G . 1) apart
TRUE_RESIDUAL_LIMIT = 2e-5


def phase_cached_solvers(plan, fields, n, device_first):
    """On the cached path's plan: the first-kind relaxed solve through
    the host loop (``solve_plan(prefer_device=False)``), the same solve
    with the diagonal preconditioner on both modes, and FMGMRES on the
    device (a fixed 6-step inner Arnoldi at p=3), beside the device
    solve of ``phase_main_path`` (``device_first``).  Each solve's true
    residual is held to ``TRUE_RESIDUAL_LIMIT``; the error against the
    exact solution 1 to the first-kind limit 5e-3, but for FMGMRES,
    whose error is reported: on this first-kind system the error at a
    residual of 1e-5 depends on the path the solve took (6.0e-4 to
    3.9e-3 among the other solves)."""
    b1 = plan.apply_flipped_bc(np.ones(n, np.float32), p=10)[:, 0]
    b1 = b1.cpu().numpy()
    diag = laplace_diagonal(fields, plan.kernel)
    cfg = first_kind_config()

    def solves():
        out = {}
        for name, kw in (("host", dict(prefer_device=False)),
                         ("host_pc_diagonal",
                          dict(prefer_device=False, M_diag=diag)),
                         ("device_pc_diagonal", dict(M_diag=diag))):
            (x, info, mode), s = timed_solve(
                lambda: solve_plan(plan, b1, cfg, **kw))
            out[name] = dict(solve_record(x, info, mode, s, n), x=x)
        mv, op4p, to_s, from_s, _ = plan.solver_ops_slots()
        (x, info), s = timed_solve(lambda: fmgmres_device(
            mv, to_s(b1), op4p, config=cfg, inner_k=6, p_inner=3))
        x = from_s(x).cpu().numpy()
        out["fmgmres_device"] = dict(
            solve_record(x, info, "device-slots-fmgmres", s, n), x=x,
            inner_k=6, p_inner=3)
        return out

    out, counted = counted_run([plan], "near_panel", solves, "cached solvers")
    for name, sol in out.items():
        sol["true_residual"] = true_residual(plan, b1, sol.pop("x"))
    rec = {"phase": "cached_solvers", "n_panels": n,
           "device_first_kind": {k: device_first[k] for k in (
               "iterations", "p_schedule", "err", "solve_s")},
           **out, "err_limit": 5e-3,
           "true_residual_limit": TRUE_RESIDUAL_LIMIT, **counted}
    emit(rec)
    for name, sol in out.items():
        if not (sol["converged"] and sol["finite_and_shaped"]
                and sol["true_residual"] <= TRUE_RESIDUAL_LIMIT
                and (sol["err"] <= 5e-3 or name == "fmgmres_device")):
            fail(f"the cached path's {name} solve: {sol}")
    if out["host"]["mode"] != "host" or out["host_pc_diagonal"]["mode"] != \
            "host" or out["device_pc_diagonal"]["mode"] != "device-slots":
        fail("solve_plan did not take the mode it was asked for")
    return rec


def device_launches(fn):
    """Device launches of ``fn()`` under torch.profiler, with the names
    of the operations."""
    ops, _ = device_ops(fn)
    return (sum(v[1] for v in ops.values()),
            {k[:80]: v[1] for k, v in ops.items()})


def phase_near_only(plan, fields, n, entries):
    """A ``local_evaluation=True`` and a ``block_diagonal=True`` plan on
    the cached path's sphere: their pairs and stores, ``near_panel`` on
    each store against its plain version (timed, with its bound), the
    device launches of one near-only matvec, and the first-kind system
    (on ``plan``) solved by the host FGMRES right-preconditioned by
    ``local_inner`` (one inner iteration at p=3) on each.  Appends the
    two kernels-line entries to ``entries``; returns the checks."""
    b1 = torch.as_tensor(
        plan.apply_flipped_bc(np.ones(n, np.float32), p=10)[:, 0])
    cfg = first_kind_config()
    checks = []
    for mode in ("local_evaluation", "block_diagonal"):
        torch.cuda.empty_cache()
        t0 = time.time()
        nplan, _ = build_plan(None, "float32", fields=fields, **{mode: True})
        host_build_s = time.time() - t0
        t0 = time.time()
        panels, meta = nplan.near_panels()
        torch.cuda.synchronize()
        store_s = time.time() - t0
        pairs = int(len(nplan.p2p_src_slot))
        self_pairs = int((nplan.p2p_src_slot == nplan.p2p_tgt_slot).sum())
        if mode == "block_diagonal" and not (
                pairs == self_pairs == len(nplan.leaf_ids)):
            fail(f"the block-diagonal plan has {pairs} pairs, "
                 f"{self_pairs} of them self pairs, on "
                 f"{len(nplan.leaf_ids)} leaves")
        nl = len(nplan.leaf_ids)
        check = check_near_panel(panels, meta, nl, 1e-5, mode, time_it=True)
        checks.append(check)
        mv, op4p, to_s, _, _ = nplan.solver_ops_slots()
        operand = op4p(3)
        x = to_s(np.ones(n, np.float32))
        launches, ops = device_launches(lambda: mv(operand, x, 3))

        def precond_solve():
            M = local_inner(lambda v: nplan.apply(v, p=3)[:, 0], iters=1)
            return timed_solve(lambda: fgmres(
                lambda v, p: plan.apply(v, p=p)[:, 0], b1, config=cfg, M=M))

        ((xs, info), s), counted = counted_run(
            [plan, nplan], "near_panel", precond_solve,
            f"{mode} preconditioned solve")
        sol = solve_record(xs.cpu().numpy(), info, "host-fgmres", s, n)
        sol["true_residual"] = true_residual(plan, b1, xs)
        rec = {
            "phase": f"near_only_{mode}", "n_panels": n,
            "host_build_s": host_build_s, "near_store_s": store_s,
            "near_pairs": pairs, "self_pairs": self_pairs, "leaves": nl,
            "near_pairs_of_the_full_plan": int(len(plan.p2p_src_slot)),
            "near_store_bytes": nbytes_of(panels["A"]),
            "near_panel": {k: check[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "rel_err", "real_chunks", "read_of_A_ms", "graph_ms")},
            "near_only_matvec_device_launches": launches,
            "near_only_matvec_device_ops": ops,
            "fgmres_local_inner": sol, "err_limit": 5e-3, **counted,
        }
        emit(rec)
        if not (sol["converged"] and sol["finite_and_shaped"]
                and sol["err"] <= 5e-3
                and sol["true_residual"] <= TRUE_RESIDUAL_LIMIT):
            fail(f"the FGMRES solve preconditioned on the {mode} plan: {sol}")
        if not counted["kernel_launches_per_plan"][1]:
            fail(f"near_panel never launched on the {mode} store")
        entry = kernel_entry("near_panel",
                             "fmm_bem_tpu/ops/near_panel.py:539", check,
                             counted["kernel_launches_per_plan"][1])
        entry["path"] = f"cached_{mode}"
        entries.append(entry)
        del nplan, panels, meta, operand, x
    return checks


def phase_stokes_fmgmres(plan, fields, n, relaxed):
    """FMGMRES on the Stokes path's plan as examples/stokes_bem.py runs
    it (``-fmgmres``: ten inner iterations at p = p_min = 5, the outer
    relaxed with the floor and the tiers), its outer iterations against
    the relaxed solve's (``relaxed``), the drag against Stokes' law."""
    b = torch.as_tensor(np.tile([4.0 * np.pi, 0.0, 0.0], (n, 1)).reshape(-1),
                        dtype=plan.dtype, device=DEV)
    cfg = fbt.SolverConfig(
        residual=1e-5, max_iters=200, restart=200, max_p=STOKES_P,
        p_min=STOKES_P_MIN, p_tiers=default_p_tiers(STOKES_P),
    )

    def matvec(x, p):
        return plan.apply(x.reshape(n, 3), p=p).reshape(-1)

    ((x, info), s), counted = counted_run(
        [plan], "panel_contract",
        lambda: timed_solve(lambda: fmgmres(
            matvec, b, config=cfg, inner_iters=10, p_inner=STOKES_P_MIN)),
        "Stokes FMGMRES")
    x = x.cpu().numpy()
    sol = solve_record(x, info, "host-fmgmres", s, 3 * n, exact=0.0)
    exact = 6.0 * np.pi * STOKES_MU
    fx = float((x.reshape(n, 3)[:, 0] * fields["area"]).sum()) \
        if sol["finite_and_shaped"] else float("nan")
    drag_limit = STOKES_DRAG_ERR_LIMIT * max(1.0, 32768 / n)
    rec = {"phase": "stokes_fmgmres", "n_panels": n, "inner_iters": 10,
           "p_inner": STOKES_P_MIN, "outer": sol,
           "drag": fx, "drag_err": abs(fx - exact) / exact,
           "drag_err_limit": drag_limit,
           "relaxed_solve": {k: relaxed[k] for k in (
               "iterations", "p_schedule", "drag_err", "solve_s")},
           **counted}
    emit(rec)
    if not (sol["converged"] and sol["finite_and_shaped"]):
        fail(f"Stokes FMGMRES: {sol}")
    if not rec["drag_err"] <= drag_limit:
        fail(f"Stokes FMGMRES drag error {rec['drag_err']:.3e} above "
             f"{drag_limit:.1e}")
    if not sol["iterations"] < relaxed["iterations"]:
        fail(f"Stokes FMGMRES took {sol['iterations']} outer iterations, "
             f"the relaxed solve {relaxed['iterations']}")
    return rec


def phase_yukawa_host(plan, n):
    """The Yukawa path's f32 relaxed solve through the host loop (numpy
    f64 Hessenberg and Givens state around the f32 basis and matvec):
    iterations, orders and the mean dphi/dn, held to the analytic limit
    only.  Returns its record."""
    ones = np.ones(n, np.float32)
    b = plan.apply_flipped_bc(ones, p=YUKAWA_P)[:, 0].cpu().numpy()
    cfg = fbt.SolverConfig(
        residual=1e-5, max_iters=200, restart=200, max_p=YUKAWA_P,
        p_tiers=default_p_tiers(YUKAWA_P),
    )
    ((x, info, mode), s), counted = counted_run(
        [plan], "near_panel",
        lambda: timed_solve(lambda: solve_plan(plan, b, cfg,
                                               prefer_device=False)),
        "Yukawa host-loop solve")
    kappa = plan.kernel.kappa
    exact = -(kappa / np.tanh(kappa) - 1.0)
    sol = solve_record(x, info, mode, s, n)
    del sol["err"]
    mean = float(x.mean()) if sol["finite_and_shaped"] else float("nan")
    sol.update(mean_dphi_dn=mean, analytic=exact,
               analytic_err=abs(mean - exact) / abs(exact),
               residual_history=[float(h[1]) for h in info.history])
    emit({"phase": "yukawa_host_loop", "n_panels": n, "host_loop": sol,
          "analytic_limit": YUKAWA_ANALYTIC_LIMIT, **counted})
    hold_yukawa_solve(sol, "f32 host-loop")
    return sol


#: the diagonal shift of the block-diagonal preconditioner's system (the
#: shifted point system of tests/test_utils.py), and how close the
#: preconditioner built in f64 on the card must come to solving the
#: shifted leaf blocks, rebuilt in numpy f64 on the host for a sample of
#: leaves (relative residual per leaf)
BLOCK_PC_SHIFT = 30.0
BLOCK_PC_SAMPLE_LEAVES = 256
BLOCK_PC_F64_RESIDUAL_LIMIT = 1e-9
#: over every leaf, each preconditioner (f32 and f64) is held to its
#: leaf's relative residual ||A z - r|| / ||r|| over u cond_2(A) (u the
#: unit roundoff of its dtype, A the leaf's shifted block in f64 from the
#: plan's coordinates): a solve through a computed inverse is bounded by
#: a small multiple of n u cond (n the block's order), so the ratio may
#: reach the leaf pad.  Shifted by 30, a block is near-singular where an
#: eigenvalue of its 1/r part lies near -30, and among uniform points
#: some do (on a CPU at 100,000 points: cond up to 2.8e6, the worst
#: eigenvalue -30.0003, the ratio at most 0.28 in f32 and f64 alike)
BLOCK_PC_WITNESS_LEAVES = 4


def block_condition(A, bmask, shift):
    """Per leaf, the 2-norm condition number of the shifted block
    ``A`` [nl, K, K] (f64, symmetric) over its real bodies, and the
    eigenvalue nearest 0.  The padded rows and columns are set to
    ``shift`` times the identity: the real block's diagonal is ``shift``
    (the 1/r part has no self term), so its eigenvalues' mean is
    ``shift`` and the padding's eigenvalue lies among them, leaving the
    largest and the smallest magnitude as they were."""
    K = A.shape[-1]
    m2 = bmask[:, :, None] & bmask[:, None, :]
    eye = torch.eye(K, dtype=A.dtype, device=A.device)
    lam = np.linalg.eigvalsh(torch.where(m2, A, shift * eye).cpu().numpy())
    mag = np.abs(lam)
    nearest = lam[np.arange(len(lam)), mag.argmin(axis=1)]
    return mag.max(axis=1) / mag.min(axis=1), nearest


def leaf_residuals(A, bmask, to_leaf, z, r):
    """Per leaf ||A z - r|| / ||r|| in f64 over the leaf's real bodies,
    for user-order ``z`` and ``r`` gathered into the leaf layout by
    ``to_leaf``."""
    rl = to_leaf(r.double())
    zl = to_leaf(z.double())
    res = torch.where(bmask, torch.einsum("lij,lj->li", A, zl) - rl, 0.0)
    return (res.norm(dim=1) / rl.norm(dim=1)).cpu().numpy()


def path_points_block_diagonal(npoints):
    """A ``block_diagonal=True`` point-Laplace plan on the points path's
    points: ``p2p_tile`` on its self pairs against its plain version
    (timed, with its bound and the evaluations it walks), one ``apply``
    (p2p_tile once, nothing else), and ``block_diagonal_from_plan`` on
    it for the shifted system of tests/test_utils.py (leaf blocks of 1/r
    plus ``BLOCK_PC_SHIFT`` on the diagonal: a leaf of one point has a
    singular block of 1/r alone): build seconds, the bytes of the
    inverse, the f32 preconditioned vector against the f64 one, the f64
    one against the leaf blocks rebuilt on the host for a sample of
    leaves, and both, on every leaf, against that leaf's condition
    number (``BLOCK_PC_WITNESS_LEAVES`` of the worst shown)."""
    torch.cuda.empty_cache()
    t0 = time.time()
    plan, pts, q = point_plan(npoints, 32, block_diagonal=True)
    host_build_s = time.time() - t0
    emit_plan_build("points_block_diagonal_plan_build", plan,
                    host_build_s)
    nl = len(plan.leaf_ids)
    if not len(plan.p2p_src_slot) == nl or not (
            plan.p2p_src_slot == plan.p2p_tgt_slot).all():
        fail("the block-diagonal point plan is not one self pair per leaf")
    ql, _ = leaf_charges(plan, torch.float32)
    check = check_p2p_tile(plan, p2p_tables(plan.device_data(5), ql), 1e-5,
                           "points_block_diagonal", time_it=True)
    out, counted = counted_run([plan], "p2p_tile",
                               lambda: plan.apply(q, p=5),
                               "block-diagonal point apply")
    if out.shape != (npoints, 4) or not torch.isfinite(out).all():
        fail("the block-diagonal point result is not finite [n, 4]")
    kern = plan.kernel

    def shifted(tf, sf):
        eye = torch.eye(tf["xyz"].shape[0], dtype=tf["xyz"].dtype,
                        device=DEV)
        return kern.p2p_matrix(tf, sf) + BLOCK_PC_SHIFT * eye

    def shifted64(tf, sf):
        return shifted({k: v.double() for k, v in tf.items()},
                       {k: v.double() for k, v in sf.items()})

    torch.cuda.synchronize()
    t0 = time.time()
    M = block_diagonal_from_plan(plan, p=5, assemble_block=shifted)
    torch.cuda.synchronize()
    pc_build_s = time.time() - t0
    r = torch.as_tensor(q, dtype=torch.float32, device=DEV)
    z = M(r)
    finite = bool(torch.isfinite(z).all())
    z64 = block_diagonal_from_plan(plan, p=5, assemble_block=shifted64)(
        r.double())
    f32_vs_f64 = float((z.double() - z64).norm() / z64.norm())
    # every leaf: its shifted block in f64 from the plan's coordinates,
    # gathered as the preconditioner gathers them, its condition number,
    # and each preconditioner's residual on it
    t0 = time.time()
    d = plan.device_data(5)
    bidx, bmask, perm = d["s_leaf_body_idx"], d["s_leaf_body_mask"], \
        d["s_perm"]
    lf = {k: v[bidx] for k, v in plan.device_fields().items()}
    A64 = torch.vmap(shifted64)(lf, lf)
    cond, nearest = block_condition(A64, bmask, BLOCK_PC_SHIFT)

    def to_leaf(v):
        return torch.where(bmask, v[perm][bidx], 0.0)

    u = {"f32": 2.0 ** -24, "f64": 2.0 ** -53}
    res = {"f32": leaf_residuals(A64, bmask, to_leaf, z, r),
           "f64": leaf_residuals(A64, bmask, to_leaf, z64, r)}
    ratio = {k: res[k] / (u[k] * cond) for k in res}
    counts = bmask.sum(dim=1).cpu().numpy()
    witness = [{"leaf": int(l), "bodies": int(counts[l]),
                "cond_2": float(cond[l]),
                "eigenvalue_nearest_0": float(nearest[l]),
                "of_the_1_over_r_part": float(nearest[l] - BLOCK_PC_SHIFT),
                "f32_residual": float(res["f32"][l]),
                "f64_residual": float(res["f64"][l])}
               for l in np.argsort(cond)[::-1][:BLOCK_PC_WITNESS_LEAVES]]
    well = cond < 1.0 / u["f32"]
    all_leaves = {
        "seconds": time.time() - t0, "leaves": int(len(cond)),
        "cond_2_max": float(cond.max()),
        "cond_2_median": float(np.median(cond)),
        "leaves_cond_above_1e4": int((cond > 1e4).sum()),
        "leaves_cond_above_1_over_u32": int((~well).sum()),
        "f32_residual_max": float(res["f32"].max()),
        "f32_residual_max_where_cond_below_1_over_u32": float(
            res["f32"][well].max()),
        "f64_residual_max": float(res["f64"].max()),
        "f32_residual_over_u_cond_max": float(ratio["f32"].max()),
        "f64_residual_over_u_cond_max": float(ratio["f64"].max()),
        "residual_over_u_cond_limit": plan.leaf_pad,
        "worst_leaves": witness,
    }
    del A64, lf
    # the f64 preconditioner against the shifted blocks on the host, from
    # the coordinates the plan holds (f32)
    z64 = z64.cpu().numpy()
    t = plan.tree
    xyz = pts.astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(5)
    worst = 0.0
    for leaf in rng.choice(t.leaves, BLOCK_PC_SAMPLE_LEAVES, replace=False):
        s0, c = t.box_body_start[leaf], t.box_body_count[leaf]
        idx = t.perm[s0 : s0 + c]
        r2 = ((xyz[idx][:, None] - xyz[idx][None]) ** 2).sum(-1)
        A = np.where(r2 < kern.eps2, 0.0,
                     1.0 / np.sqrt(np.maximum(r2, kern.eps2)))
        A += BLOCK_PC_SHIFT * np.eye(c)
        rl = r.cpu().numpy()[idx].astype(np.float64)
        worst = max(worst, float(np.linalg.norm(A @ z64[idx] - rl)
                                 / np.linalg.norm(rl)))
    rec = {"phase": "points_block_diagonal", "n_points": npoints,
           "self_pairs": nl, "p2p_tile": {k: check[k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "rel_err",
               "kernel_evaluations", "evaluations_walked_from_count_tables")},
           "block_inverse_build_s": pc_build_s,
           # [nl, K, K] in the plan's dtype
           "block_inverse_bytes": nl * plan.leaf_pad ** 2 * r.element_size(),
           "shift": BLOCK_PC_SHIFT,
           "preconditioned_vector_finite": finite,
           "f32_vs_f64_rel_l2": f32_vs_f64,
           "all_leaves": all_leaves,
           "f64_leaf_residual_max": worst,
           "sample_leaves": BLOCK_PC_SAMPLE_LEAVES,
           "limit": BLOCK_PC_F64_RESIDUAL_LIMIT, **counted}
    emit(rec)
    if not (finite and worst <= BLOCK_PC_F64_RESIDUAL_LIMIT):
        fail(f"the block-diagonal preconditioner does not solve the shifted "
             f"leaf blocks: finite {finite}, f64 residual {worst:.3e}")
    for k, v in ratio.items():
        if not v.max() <= plan.leaf_pad:  # a NaN fails too
            fail(f"the {k} block-diagonal preconditioner's leaf residual "
                 f"reaches {v.max():.3e} u cond_2 (limit {plan.leaf_pad})")
    entry = kernel_entry("p2p_tile", "fmm_bem_tpu/ops/p2p_tile.py:180", check,
                         counted["kernel_launches"])
    entry["path"] = "points_block_diagonal"
    return [check], entry


#: limits of the Laplace example program (-fgmres -pc diagonal, first
#: kind), from the same program in f64 on a CPU at recursions 4, 5 and 6.
#: Its exterior-potential error, an integral of the solution, falls
#: 3.87-fold and then 3.84-fold per recursion (9.074e-3, 2.343e-3,
#: 6.105e-4); it must beat that trend's value one recursion coarser than
#: the program runs (6.105e-4 * 6.105e-4 / 2.343e-3 = 1.591e-4 at
#: recursion 7; 2.343e-3 itself at 5).  Its relative error (1.473e-2,
#: 6.042e-3, 3.614e-3) is the first-kind system's error at a residual of
#: 1e-5, which depends on the path the solve takes as much as on N: at
#: 131,072 panels 6.0e-4 without a preconditioner and 3.87e-3 with the
#: diagonal one, on both solver modes alike (NVIDIA H100 80GB HBM3,
#: 700.00 W, f32); it is held to the first-kind limit of every other
#: solve, 5e-3.  (relative, exterior) by the recursion the program runs
#: at (6 with --quick)
LAPLACE_TWIN_LIMITS = {8: (5e-3, 1.591e-4), 6: (5e-3, 2.343e-3)}


def hold_twin(name, res, n, recursions):
    """The example program's printed errors against the limits of the
    same checks on the paths: Laplace's to ``LAPLACE_TWIN_LIMITS``, the
    Stokes RHS and drag to ``STOKES_RHS_ERR_LIMIT`` and
    ``STOKES_DRAG_ERR_LIMIT`` (scaled by 32,768 / n below 32,768
    panels), Yukawa's mean dphi/dn to ``YUKAWA_ANALYTIC_LIMIT``.
    Returns the limits by printed name."""
    if name == "laplace_bem":
        err, ext = LAPLACE_TWIN_LIMITS[recursions]
        limits = {"relative_error": err, "external_error": ext}
    elif name == "stokes_bem":
        limits = {"rhs_error": STOKES_RHS_ERR_LIMIT,
                  "drag_error": STOKES_DRAG_ERR_LIMIT * max(1.0, 32768 / n)}
    else:
        limits = {"analytic_error": YUKAWA_ANALYTIC_LIMIT}
    for key, limit in limits.items():
        if not res[key] <= limit:  # a NaN fails too
            fail(f"the {name} program's {key} {res[key]:.3e} above "
                 f"{limit:.3e}")
    return limits


def phase_twins(laplace_recursions, small_recursions):
    """The three example programs of the port, run in-process through
    ``main(argv)`` on the card: the Laplace one at ``laplace_recursions``
    with ``-fgmres -pc diagonal``, Stokes (``-fmgmres``) and Yukawa at
    ``small_recursions``, each one's launches counted from 0 and its
    printed errors held to limits (``hold_twin``).  Each program builds
    its plan with the default configuration (no fixed leaf_pad, the
    automatic ncrit), so its near-field kernel is then held against its
    plain version on that plan's own store and timed.  Returns the
    kernels-line entries."""
    import io

    from fmm_bem_tpu_torch.examples import laplace_bem as ex_laplace
    from fmm_bem_tpu_torch.examples import stokes_bem as ex_stokes
    from fmm_bem_tpu_torch.examples import yukawa_bem as ex_yukawa

    runs = (
        ("laplace_bem", ex_laplace, ["-recursions", str(laplace_recursions),
                                     "-fgmres", "-pc", "diagonal"],
         "near_panel"),
        ("stokes_bem", ex_stokes, ["-recursions", str(small_recursions),
                                   "-fmgmres"], "panel_contract"),
        ("yukawa_bem", ex_yukawa, ["-recursions", str(small_recursions)],
         "near_panel"),
    )
    entries = []
    for name, mod, argv, kernel in runs:
        torch.cuda.empty_cache()
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        torch.cuda.synchronize()
        counts = launch_counts()
        seconds = time.time() - t0
        plan = res.pop("plan")
        n = plan.src.tree.num_bodies
        lines = buf.getvalue().splitlines()
        rec = {"phase": f"twin_{name}", "argv": argv, "n_panels": n,
               "leaf_pad": plan.leaf_pad, "seconds": seconds, "result": res,
               "launch_counts": counts,
               "printed": [ln for ln in lines if "error" in ln
                           or "solve :" in ln or "analytic" in ln]}
        others = sum(v for k, v in counts.items() if k != kernel)
        if counts[kernel] == 0 or others:
            emit(rec)
            fail(f"the {name} program launched {counts}")
        rec["limits"] = hold_twin(name, res, n, int(argv[1]))
        panels, meta = plan.near_panels()
        nl = len(plan.leaf_ids)
        check = (check_near_panel if kernel == "near_panel"
                 else check_panel_contract)(
            panels, meta, nl, 1e-5, f"twin_{name}", time_it=True)
        rec[kernel] = {k: check[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "rel_err", "store_bytes", "real_chunks", "A_shape", "S",
            "read_of_A_ms", "graph_ms", "library_graph_ms",
            "host_us_per_call", "library_host_us_per_call",
            "timing_rounds_ms") if k in check}
        emit(rec)
        entry = kernel_entry(
            kernel, "fmm_bem_tpu/ops/near_panel.py:" + (
                "539" if kernel == "near_panel" else "626"),
            check, counts[kernel])
        entry["path"] = f"twin_{name}"
        entries.append(entry)
        del plan, panels, meta
    return entries


# ----------------------------------------------------------------------
# body order, dual trees, the COO replay, the point programs
# ----------------------------------------------------------------------

#: the body-order matvec against the slot-order one on the same plan,
#: order and charges, relative L2: the same operator, its sums in
#: another order (f32)
BODY_ORDER_LIMIT = 1e-5
#: the dual BEM exterior potential against ``eval_exterior`` on 1,000
#: sampled targets, relative L2: the JAX package's own bar
#: (tests/test_dual_tree.py)
DUAL_EXTERIOR_LIMIT = 1e-4
#: the on-the-fly dual plan against the cached dual plan of the same
#: trees, relative to the largest value (no near-singular corrections
#: off the surface: the regular quadrature alone, in f32 both ways)
DUAL_OTF_LIMIT = 1e-5
#: the depth cap of the dual plans with unequal leaf pads: at the full
#: size both trees fill their leaves to ncrit = 64 (K_s = K_t = 64);
#: capped at level 6 the sphere's leaves hold up to 136 panels while the
#: target tree, five levels deep, keeps 64
DUAL_UNEQUAL_MAX_LEVEL = 6
#: the dual unit-kernel FMM and treecode against direct summation, f64
#: (the dual_correctness.cpp oracle)
DUAL_UNIT_LIMIT = 1e-12
#: the COO replay's host build at the full sphere, predicted from the
#: sphere a recursion smaller (times four), must stay under this; else
#: the smaller sphere stands in for it (the pattern of
#: STOKES_REC8_HOST_BUDGET_S)
COO_FULL_HOST_BUDGET_S = 120.0
#: the Stokes COO plan against its panel plan (2,048 panels), relative
#: to the largest value
STOKES_COO_LIMIT = 1e-5
#: the stresslet program's error against direct summation: the bar of
#: the JAX package's own test (tests/test_stokes_ops.py)
STRESSLET_LIMIT = 5e-4


def no_kernel_counts():
    return dict.fromkeys(WRAPPERS, 0)


def phase_body_order(plan, label, kernel, p, seed=21):
    """One body-order ``apply`` (``apply_body_order``: charges in and
    results out per body, ``FmmPlan._matvec``) on a plan of an earlier
    path, against the slot-order ``apply`` on the same seeded charges;
    the launches of the body-order run counted from 0 (its path's
    kernel once, no other), both timed."""
    n = plan.src.tree.num_bodies
    cdim = getattr(plan.kernel, "charge_dim", 1)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n,) if cdim == 1 else (n, cdim)).astype(
        np.float32)
    want = plan.apply(q, p=p)
    torch.cuda.synchronize()
    reset_launch_counts()  # every kernel count, just before the run
    got = plan.apply_body_order(q, p=p)
    torch.cuda.synchronize()
    counts = launch_counts()  # ... and read just after it
    rel = float((got - want).double().norm() / want.double().norm())
    rec = {
        "phase": "body_order", "plan": label, "n_bodies": n, "p": p,
        "rel_l2_diff_vs_slot_order": rel, "limit": BODY_ORDER_LIMIT,
        "kernel": kernel, "launch_counts": counts,
        "body_order_ms": gpu_ms(
            lambda: plan.apply_body_order(q, p=p), 3, 1, batches=1),
        "slot_order_ms": gpu_ms(lambda: plan.apply(q, p=p), 3, 1, batches=1),
    }
    emit(rec)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"body order on the {label} plan: bad result")
    if not rel <= BODY_ORDER_LIMIT:
        fail(f"body order on the {label} plan differs from slot order by "
             f"{rel:.3e}")
    if counts != {**no_kernel_counts(), kernel: 1}:
        fail(f"body order on the {label} plan launched {counts}: not "
             f"{kernel} once and no other kernel")
    return rec


def dual_point_plan(ns, nt, seed, kernel, dtype, evaluator=Evaluator.FMM,
                    lo=(0.0, 1.0), hi=(0.2, 1.2)):
    """A dual point plan: ``ns`` sources uniform in [lo]^3, ``nt``
    targets uniform in [hi]^3 (the overlap of tests/test_dual_tree.py),
    charges from the same seeded generator.  Returns (plan, sources,
    targets, charges, host build seconds)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(*lo, (ns, 3))
    tgt = rng.uniform(*hi, (nt, 3))
    q = rng.uniform(0.5, 1.5, ns) if kernel is LaplaceKernel else \
        rng.standard_normal(ns)
    t0 = time.time()
    plan = fbt.FmmPlan(
        kernel(), {"xyz": src},
        fbt.FMMConfig(ncrit=64, dtype=dtype, max_p=5, evaluator=evaluator),
        target_fields={"xyz": tgt}, device=DEV,
    )
    return plan, src, tgt, q, time.time() - t0


def direct_at(kernel, tgt, src, q, block=1 << 26):
    """Direct summation in f64 on the card at ``tgt``, in blocks of
    targets that keep the [targets, sources] planes near ``block``."""
    src = torch.as_tensor(src, dtype=torch.float64, device=DEV)
    qd = torch.as_tensor(q, dtype=torch.float64, device=DEV)
    tgt = torch.as_tensor(tgt, dtype=torch.float64, device=DEV)
    step = max(1, block // src.shape[0])
    return torch.cat([kernel.direct(tgt[i:i + step], src, qd)
                      for i in range(0, tgt.shape[0], step)])


def dual_errors(plan, src, tgt, q, out, nsample=1000, seed=17):
    """Relative L2 error of potential and force of a dual Laplace plan
    against direct summation on a seeded sample of targets."""
    idx = np.random.default_rng(seed).choice(len(tgt), nsample,
                                             replace=False)
    exact = direct_at(plan.kernel, tgt[idx], src, q)
    got = out[torch.as_tensor(idx, device=DEV)].double()
    return (
        float((got[:, 0] - exact[:, 0]).norm() / exact[:, 0].norm()),
        float((got[:, 1:] - exact[:, 1:]).norm() / exact[:, 1:].norm()),
    )


def path_dual_points(npoints, nunit, nbase):
    """Dual point plans: ``LaplaceKernel`` on ``npoints`` sources and as
    many targets at p=5 (f32; no hand kernel: a dual plan's P2P runs the
    kernel's own ``p2p_block``), held to three times the error of the
    same plan on ``nbase`` points; then ``UnitKernel`` on ``nunit``
    sources and 0.7 times as many targets in f64, FMM and treecode,
    exact against direct summation."""
    torch.cuda.empty_cache()
    base, bsrc, btgt, bq, _ = dual_point_plan(nbase, nbase, 41,
                                              LaplaceKernel, "float32")
    base_err = dual_errors(base, bsrc, btgt, bq, base.apply(bq, p=5))
    del base
    plan, src, tgt, q, host_build_s = dual_point_plan(
        npoints, npoints, 42, LaplaceKernel, "float32")
    emit_plan_build("dual_points_plan_build", plan, host_build_s)
    reset_launch_counts()  # every kernel count, just before the run
    t0 = time.time()
    out = plan.apply(q, p=5)
    torch.cuda.synchronize()
    first_apply_s = time.time() - t0
    counts = launch_counts()  # ... and read just after it
    apply_ms = gpu_ms(lambda: plan.apply(q, p=5), 2, 1, batches=1)
    ops, _ = device_ops(lambda: plan.apply(q, p=5))
    idle = idle_share(ops, apply_ms)
    launches = sum(v[1] for v in ops.values())
    err_pot, err_force = dual_errors(plan, src, tgt, q, out)
    rec = {
        "phase": "dual_points", "n_sources": npoints, "n_targets": npoints,
        "p": 5, "host_build_s": host_build_s,
        "first_apply_s": first_apply_s, "apply_ms": apply_ms,
        "device_idle_share": idle, "device_launches": launches,
        "rel_l2_err_potential": err_pot, "rel_l2_err_force": err_force,
        "truncation_err_at": {"n_points": nbase, "potential": base_err[0],
                              "force": base_err[1]},
        "limit": {"potential": 3 * base_err[0], "force": 3 * base_err[1]},
        "launch_counts": counts,
    }
    if out.shape != (npoints, 4) or not torch.isfinite(out).all():
        emit(rec)
        fail("the dual point result is not finite values of shape [n, 4]")
    rec["unit"] = []
    del plan, out
    torch.cuda.empty_cache()
    for ev in (Evaluator.FMM, Evaluator.TREECODE):
        uplan, usrc, utgt, uq, ubuild = dual_point_plan(
            nunit, int(0.7 * nunit), 43, UnitKernel, "float64", ev,
            lo=(-1.0, 1.0), hi=(-0.8, 1.2))
        got = uplan.apply(uq, p=3)
        exact = direct_at(uplan.kernel, utgt, usrc, uq)
        err = float((got - exact).norm() / exact.norm())
        rec["unit"].append({
            "evaluator": ev.value, "n_sources": nunit,
            "n_targets": len(utgt), "host_build_s": ubuild,
            "rel_l2_err": err, "limit": DUAL_UNIT_LIMIT})
        del uplan
        if not err <= DUAL_UNIT_LIMIT:
            emit(rec)
            fail(f"the dual unit kernel ({ev.value}) is off by {err:.3e}")
    emit(rec)
    if err_pot > 3 * base_err[0] or err_force > 3 * base_err[1]:
        fail(f"dual point errors {err_pot:.3e} / {err_force:.3e} above "
             f"three times those at {nbase} points {base_err}")
    if counts != no_kernel_counts():
        fail(f"the dual point apply launched {counts}: a dual plan's P2P "
             "runs the kernel's own p2p_block")
    return rec


def near_panel_chunk_sweep(panels, meta, nl_s, widths=(2, 4, 8, 16)):
    """``near_panel`` on seeded stores of the bytes and leaf pad of the
    store ``panels`` (KT = KS), each held against its plain version and
    timed.  First at the chunk widths ``widths``, two chunks per target
    leaf: the bytes read (panels and staged charges) stay the same while
    the chunks fall as 1/m0, so the fit of the time to ``rest +
    per_chunk * chunks`` gives the cost of each chunk.  Then at the
    store's own width with its own chunks per target leaf (``row_ptr``):
    a design that walks a leaf's chunks in one block has a tail there
    that the two-per-leaf stores do not have."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    C0, K, Lb0 = panels["A"].shape
    flat = torch.randn(C0 * K * Lb0, generator=gen, device=DEV)

    def timed(store, m, label):
        rec = check_near_panel(store, m, nl_s, 1e-5, label, time_it=True)
        return {k: rec[k] for k in ("m0", "S", "real_chunks", "rel_err",
                                    "ms", "plain_ms", "library_ms",
                                    "read_of_A_ms", "bound_ms")}

    rows = []
    for m0 in widths:
        C = flat.numel() // (K * m0 * K) // 2 * 2
        store = {
            "A": flat[:C * K * m0 * K].view(C, K, m0 * K),
            "pidx": torch.randint(0, nl_s, (C, m0), generator=gen,
                                  device=DEV, dtype=torch.int32),
            "chunk_tgt": torch.arange(C, device=DEV).div(
                2, rounding_mode="floor").int(),
            "row_ptr": torch.arange(0, C + 1, 2, device=DEV,
                                    dtype=torch.int32),
        }
        rows.append(timed(store, types.SimpleNamespace(
            KT=K, KS=K, cdim=1, rdim=1, m0=m0, nl_t=C // 2),
            f"chunk_sweep_m0_{m0}"))
    per_chunk, rest = np.polyfit([r["real_chunks"] for r in rows],
                                 [r["ms"] for r in rows], 1)
    own = dict(panels, A=flat.view(C0, K, Lb0), pidx=torch.randint(
        0, nl_s, panels["pidx"].shape, generator=gen, device=DEV,
        dtype=torch.int32))
    counts = (panels["row_ptr"][1:] - panels["row_ptr"][:-1]).double()
    busy = counts[counts > 0]
    return {
        "store_bytes": C0 * K * Lb0 * 4, "K": K, "widths": rows,
        "fit_per_chunk_us": float(per_chunk) * 1e3,
        "fit_rest_ms": float(rest),
        "own_leaves": timed(own, meta, "chunk_sweep_own_leaves"),
        "chunks_per_target_leaf": {
            "leaves": int(counts.numel()), "with_chunks": int(busy.numel()),
            "mean_of_those": float(busy.mean()), "max": int(busy.max()),
            "p99": float(torch.quantile(busy, 0.99)),
        },
    }


def pseudo_panel_targets(pts, fields):
    """Off-surface evaluation points as zero-area pseudo-panels with the
    POTENTIAL flag (tests/test_dual_tree.py): only their centers are
    read."""
    npts = len(pts)
    return {
        "xyz": pts, "normal": np.zeros((npts, 3)), "area": np.zeros(npts),
        "vertices": np.zeros((npts, 3, 3)),
        "qp_off": np.zeros((npts,) + fields["qp_off"].shape[1:]),
        "qw": np.zeros((npts, fields["qw"].shape[1])),
        "bc": np.zeros(npts),
    }


def dual_bem_plan(fields, tfields, **config):
    t0 = time.time()
    plan = fbt.FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        fbt.FMMConfig(**{**dict(ncrit=64, leaf_pad=64, dtype="float32",
                                max_p=10), **config}),
        target_fields=tfields, device=DEV,
    )
    return plan, time.time() - t0


def path_dual_bem_exterior(recursions, ntargets):
    """Panels as sources, off-surface points as targets: the O(N)
    exterior evaluation (LaplaceBEM.cpp:352-371).  The cached dual plan
    (leaf pad 64): ``near_panel`` on its store, ``apply`` at p=10 against
    ``eval_exterior`` on 1,000 targets.  Then the dual plans of unequal
    leaf pads (K_s != K_t): ``otf_tile`` on the on-the-fly one (both
    sides packed at the wider pad), ``near_panel`` on the cached one
    (KT != KS), their results against each other.  Returns (checks,
    kernels-line entries)."""
    torch.cuda.empty_cache()
    fields = make_panels(unit_sphere(recursions), K=3)
    n = len(fields["xyz"])
    rng = np.random.default_rng(51)
    dirs = rng.standard_normal((ntargets, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = dirs * rng.uniform(1.05, 3.0, (ntargets, 1))
    tfields = pseudo_panel_targets(pts, fields)
    q = rng.standard_normal(n).astype(np.float32)

    plan, host_build_s = dual_bem_plan(fields, tfields)
    t0 = time.time()
    panels, meta = plan.near_panels()
    torch.cuda.synchronize()
    emit_plan_build("dual_bem_exterior_plan_build", plan, host_build_s,
                    near_store_s=time.time() - t0,
                    near_store_bytes=nbytes_of(panels["A"]))
    if len(plan.p2p_src_slot) == 0:
        fail("the dual exterior plan has no near pairs")
    nl_s = len(plan.src.leaf_ids)
    near = check_near_panel(panels, meta, nl_s, 1e-5, "dual_bem_exterior",
                            time_it=True)
    reset_launch_counts()  # every kernel count, just before the run
    out = plan.apply(q, p=10)
    torch.cuda.synchronize()
    counts = launch_counts()  # ... and read just after it
    apply_ms = gpu_ms(lambda: plan.apply(q, p=10), 3, 1, batches=1)
    ops, _ = device_ops(lambda: plan.apply(q, p=10))
    idle = idle_share(ops, apply_ms)
    launches = sum(v[1] for v in ops.values())
    idx = np.random.default_rng(17).choice(ntargets, 1000, replace=False)
    t0 = time.time()
    kern = LaplaceBEMKernel(K=3)
    exact = np.concatenate([
        kern.eval_exterior(fields, q.astype(np.float64), pts[idx[i:i + 100]])
        for i in range(0, len(idx), 100)])
    exact_s = time.time() - t0
    got = out[torch.as_tensor(idx, device=DEV), 0].double().cpu().numpy()
    err = float(np.linalg.norm(got - exact) / np.linalg.norm(exact))
    rec = {
        "phase": "dual_bem_exterior", "n_panels": n, "n_targets": ntargets,
        "p": 10, "apply_ms": apply_ms, "device_idle_share": idle,
        "device_launches": launches, "launch_counts": counts,
        "rel_l2_err_vs_eval_exterior": err, "limit": DUAL_EXTERIOR_LIMIT,
        "sample": 1000, "eval_exterior_s": exact_s,
        # where the kernel's time on this store goes
        "near_panel_chunk_sweep": near_panel_chunk_sweep(panels, meta,
                                                         nl_s),
    }
    emit(rec)
    if out.shape != (ntargets, 1) or not torch.isfinite(out).all():
        fail("the dual exterior result is not finite values of shape [n, 1]")
    if not err <= DUAL_EXTERIOR_LIMIT:
        fail(f"the dual exterior potential is off eval_exterior by {err:.3e}")
    if counts != {**no_kernel_counts(), "near_panel": 1}:
        fail(f"the dual exterior apply launched {counts}")
    entries = [dict(kernel_entry(
        "near_panel", "fmm_bem_tpu/ops/near_panel.py:539", near,
        counts["near_panel"]), path="dual_bem_exterior")]
    del plan, panels, meta, out
    torch.cuda.empty_cache()

    # unequal leaf pads: the on-the-fly plan and the cached one of the
    # same trees
    cfg = dict(leaf_pad=None, max_level=DUAL_UNEQUAL_MAX_LEVEL)
    oplan, o_build_s = dual_bem_plan(fields, tfields, near_mode="otf", **cfg)
    cplan, c_build_s = dual_bem_plan(fields, tfields, **cfg)
    K_s, K_t = oplan.src.leaf_pad, oplan.tgt.leaf_pad
    ot = oplan.near_panels()[0]["otf_tiles"]
    cpanels, cmeta = cplan.near_panels()
    torch.cuda.synchronize()
    emit_plan_build("dual_bem_exterior_otf_plan_build", oplan, o_build_s,
                    cached_host_build_s=c_build_s,
                    otf_tile_width=int(ot["sb_src"].shape[2]),
                    cached_store_bytes=nbytes_of(cpanels["A"]))
    if K_s == K_t or ot["sb_src"].shape[2] != max(K_s, K_t):
        fail(f"the unequal-pad dual plans have K_s {K_s}, K_t {K_t} and "
             f"OTF tiles {tuple(ot['sb_src'].shape)}")
    gen = torch.Generator(device=DEV).manual_seed(11)
    K = max(K_s, K_t)
    smask = torch.zeros((len(oplan.src.leaf_ids), K), dtype=torch.bool,
                        device=DEV)
    smask[:, :K_s] = torch.as_tensor(oplan.src.leaf_body_mask, device=DEV)
    ql = torch.randn(smask.shape, generator=gen, device=DEV) * smask
    otf_rec = check_otf_tile(oplan, ot, ql, 0.0, 1e-5,
                             "dual_bem_exterior_otf", time_it=True)
    near2 = check_near_panel(cpanels, cmeta, len(cplan.src.leaf_ids), 1e-5,
                             "dual_bem_exterior_unequal_pads", time_it=True)
    reset_launch_counts()
    got = oplan.apply(q, p=10)
    torch.cuda.synchronize()
    o_counts = launch_counts()
    want = cplan.apply(q, p=10)
    rel = float((got - want).abs().max() / want.abs().max())
    rec = {
        "phase": "dual_bem_exterior_otf", "K_s": K_s, "K_t": K_t,
        "max_level": DUAL_UNEQUAL_MAX_LEVEL, "p": 10,
        "rel_max_diff_vs_cached": rel, "limit": DUAL_OTF_LIMIT,
        "launch_counts": o_counts,
        "otf_apply_ms": gpu_ms(lambda: oplan.apply(q, p=10), 3, 1, batches=1),
        "cached_apply_ms": gpu_ms(lambda: cplan.apply(q, p=10), 3, 1,
                                  batches=1),
    }
    emit(rec)
    if not rel <= DUAL_OTF_LIMIT:
        fail(f"the on-the-fly dual plan differs from the cached one by "
             f"{rel:.3e}")
    if o_counts != {**no_kernel_counts(), "otf_tile": 1}:
        fail(f"the on-the-fly dual apply launched {o_counts}")
    entries.append(dict(kernel_entry(
        "otf_tile", "fmm_bem_tpu/ops/otf_tile.py:80", otf_rec,
        o_counts["otf_tile"]), path="dual_bem_exterior_otf"))
    return [near, otf_rec, near2], entries


def coo_first_kind(plan, n):
    """The first-kind relaxed solve through ``solve_plan`` (its mode
    beside the record) and its true residual."""
    ones = np.ones(n, np.float32)
    b = plan.apply_flipped_bc(ones, p=10)[:, 0].cpu().numpy()
    (x, info, mode), seconds = timed_solve(
        lambda: solve_plan(plan, b, first_kind_config()))
    rec = solve_record(x, info, mode, seconds, n)
    rec["true_residual"] = true_residual(plan, b, x)
    return rec


def phase_coo_replay(cached, fields, cached_solve, recursions):
    """The COO near-field replay (``near_panel=False``) on the cached
    path's sphere: its host build timed a recursion smaller first, and
    the full sphere built only where that predicts at most
    ``COO_FULL_HOST_BUDGET_S``; the drop tolerance at the 25th percentile
    of the entry magnitudes on the smaller sphere; the first-kind solve
    (mode ``"device"``: the body-order operator) against the cached
    plan's; the Stokes COO plan against its panel plan."""
    small = recursions - 1
    sfields = make_panels(unit_sphere(small), K=3)
    t0 = time.time()
    splan, ns = build_plan(small, "float32", near_panel=False,
                           fields=sfields)
    small_s = time.time() - t0
    predicted = 4.0 * small_s
    full = predicted <= COO_FULL_HOST_BUDGET_S
    rec = {"phase": "coo_replay", "small_panels": ns,
           "small_entries": int(len(splan.near_rows)),
           "small_host_build_s": small_s,
           "predicted_full_host_build_s": predicted,
           "budget_s": COO_FULL_HOST_BUDGET_S, "full_ran": full}

    # the drop tolerance (tests/test_plan.py's case)
    mags = np.abs(np.asarray(splan.near_vals)).max(axis=1)
    tol = float(np.quantile(mags, 0.25))
    dplan, _ = build_plan(small, "float32", near_panel=False, droptol=tol,
                          fields=sfields)
    kept = len(dplan.near_rows) / len(splan.near_rows)
    q = np.random.default_rng(3).standard_normal(ns).astype(np.float32)
    r0 = splan.apply(q, p=8)[:, 0].double()
    r1 = dplan.apply(q, p=8)[:, 0].double()
    drop_diff = float((r1 - r0).norm() / r0.norm())
    rec["droptol"] = {"tol": tol, "kept_fraction": kept,
                      "matvec_rel_diff": drop_diff}
    del dplan
    if not (0.5 < kept < 0.9 and 0.0 < drop_diff < 0.5):
        emit(rec)
        fail(f"droptol: kept {kept:.3f} (want 0.5-0.9), matvec moved "
             f"{drop_diff:.3e} (want 0-0.5)")

    if full:
        del splan
        t0 = time.time()
        plan, n = build_plan(recursions, "float32", near_panel=False,
                             fields=fields)
        rec["full_host_build_s"] = time.time() - t0
        want = cached_solve
    else:
        plan, n = splan, ns
        cplan, _ = build_plan(small, "float32", fields=sfields)
        want = coo_first_kind(cplan, n)
        del cplan
    d = plan.device_data(10)
    rec.update({
        "n_panels": n, "entries": int(len(plan.near_rows)),
        "device_bytes": nbytes_of(d["near_vals"], d["near_rows"],
                                  d["near_cols"]),
        "host_bytes": int(plan.near_vals.nbytes + plan.near_rows.nbytes
                          + plan.near_cols.nbytes),
    })
    reset_launch_counts()
    got = coo_first_kind(plan, n)
    counts = launch_counts()
    ones = np.ones(n, np.float32)
    rec.update({"first_kind_coo": got, "first_kind_cached": want,
                "launch_counts": counts,
                "matvec_ms_p10": gpu_ms(lambda: plan.apply(ones, p=10), 3, 1,
                                        batches=1)})
    del plan
    torch.cuda.empty_cache()

    # Stokes: the COO plan against the panel plan of 2,048 panels
    sp, sfields3, n3, _ = stokes_plan(5, "float32")
    scoo, _, _, _ = stokes_plan(5, "float32", near_panel=False)
    u = np.random.default_rng(4).standard_normal((n3, 3)).astype(np.float32)
    a = sp.apply(u, p=STOKES_P)
    b = scoo.apply(u, p=STOKES_P)
    stokes_rel = float((b - a).abs().max() / a.abs().max())
    rec["stokes"] = {"n_panels": n3, "entries": int(len(scoo.near_rows)),
                     "rel_max_diff_vs_panels": stokes_rel,
                     "limit": STOKES_COO_LIMIT}
    del sp, scoo
    emit(rec)
    if got["mode"] != "device" or not got["converged"]:
        fail(f"the COO solve ran mode {got['mode']}, converged "
             f"{got['converged']}")
    if abs(got["iterations"] - want["iterations"]) > 1:
        fail(f"the COO solve took {got['iterations']} iterations, the "
             f"cached one {want['iterations']}")
    if not (got["true_residual"] <= TRUE_RESIDUAL_LIMIT
            and got["err"] <= 5e-3):
        fail(f"the COO solve: true residual {got['true_residual']:.3e}, "
             f"error {got['err']:.3e}")
    if counts != no_kernel_counts():
        fail(f"the COO solve launched {counts}: the replay runs no hand "
             "kernel")
    if not stokes_rel <= STOKES_COO_LIMIT:
        fail(f"the Stokes COO plan differs from its panel plan by "
             f"{stokes_rel:.3e}")
    return rec


def run_program(mod, argv):
    """An example program's ``main(argv)`` in-process on the card, its
    stdout captured and every launch count read from 0.  Returns (its
    result, printed lines, launch counts, seconds)."""
    import io

    torch.cuda.empty_cache()
    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv)
    torch.cuda.synchronize()
    return res, buf.getvalue().splitlines(), launch_counts(), \
        time.time() - t0


def program_errors(res):
    """The errors a point program returns, by name: ``*_err``, and the
    ncrit sweep's force error of each ncrit."""
    out = {k: v for k, v in res.items() if k.endswith("err")}
    for (ncrit, _), err in zip(res.get("sweep", ()),
                               res.get("force_errs", ())):
        out[f"force_err_ncrit_{ncrit}"] = err
    return out


def program_limits(base):
    """Three times the errors of a program's base run; the ncrit sweep's
    three times the largest of its base sweep: how much of the work is
    near field (exact) moves with ncrit and N, so one ncrit's error
    does not bound the same ncrit's at another N."""
    errs = program_errors(base)
    sweep = [v for k, v in errs.items() if k.startswith("force_err_ncrit_")]
    return {k: 3 * (max(sweep) if k.startswith("force_err_ncrit_") else v)
            for k, v in errs.items()}


def phase_twin_points(npoints, nsmall, nbase):
    """The point programs of the port in-process on the card:
    ``serialrun`` with the Laplace kernel on ``npoints`` at p=8, the
    stresslet on ``nsmall`` at p=10 (to ``STRESSLET_LIMIT``), the
    treecode on ``nsmall``; ``scaling`` on ``npoints`` and its ncrit
    sweep on ``nsmall``.  Every other error is held to three times the
    same program's on ``nbase`` points (``program_limits``).
    ``p2p_tile`` is held against its plain version on the tables of
    every plan these programs launched it on: the sweep's leaf pads run
    from about 60 to several hundred.  Returns the kernels-line entries:
    the ``serialrun`` plan's and the sweep's widest leaf pad, timed."""
    from fmm_bem_tpu_torch.examples import scaling as ex_scaling
    from fmm_bem_tpu_torch.examples import serialrun as ex_serial

    def serial(n, *flags):
        return ["-N", str(n), *flags]

    runs = (
        # name, module, argv, argv of the base run, applies
        ("serialrun_laplace", ex_serial,
         serial(npoints, "-p", "8", "-kernel", "laplace"),
         serial(nbase, "-p", "8", "-kernel", "laplace"), 2),
        ("serialrun_stresslet", ex_serial,
         serial(nsmall, "-p", "10", "-kernel", "stresslet"), None, 2),
        ("serialrun_treecode", ex_serial, serial(nsmall, "-treecode"),
         serial(nbase, "-treecode"), 2),
        ("scaling", ex_scaling, serial(npoints), serial(nbase), 4),
        ("scaling_ncrit_search", ex_scaling,
         serial(nsmall, "-ncrit_search"), serial(nbase, "-ncrit_search"),
         32),
    )
    entries = []
    for name, mod, argv, base_argv, applies in runs:
        if base_argv is not None:
            base, _, _, _ = run_program(mod, base_argv)
            limits = program_limits(base)
            del base
        else:
            limits = {"err": STRESSLET_LIMIT}
        res, lines, counts, seconds = run_program(mod, argv)
        plans = res.pop("plans", None) or [res.pop("plan")]
        res.pop("result", None)
        errors = program_errors(res)
        kernel = None if "stresslet" in name else "p2p_tile"
        want = {**no_kernel_counts(), **({kernel: applies} if kernel
                                         else {})}
        rec = {"phase": f"twin_{name}", "argv": argv, "seconds": seconds,
               "result": {k: v for k, v in res.items()
                          if k not in ("sweep", "force_errs")},
               "errors": errors, "launch_counts": counts,
               "expected_launches": want, "limits": limits,
               "printed": [ln for ln in lines if "error" in ln
                           or "time" in ln or "matvec" in ln][:12]}
        if "sweep" in res:
            rec["sweep"] = res["sweep"]
        if kernel:
            # the programs ran at p=8: its device data is cached
            widest = max(plans, key=lambda pl: pl.leaf_pad)
            timed = name in ("serialrun_laplace", "scaling_ncrit_search")
            rec["p2p_tile"] = []
            for plan in plans:
                ql, _ = leaf_charges(plan, torch.float32)
                check = check_p2p_tile(
                    plan, p2p_tables(plan.device_data(8), ql), 1e-5,
                    f"twin_{name}_K{plan.leaf_pad}",
                    time_it=timed and plan is widest)
                rec["p2p_tile"].append({k: check.get(k) for k in (
                    "case", "tiles", "rel_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "kernel_evaluations")})
                if timed and plan is widest:
                    entries.append(dict(kernel_entry(
                        "p2p_tile", "fmm_bem_tpu/ops/p2p_tile.py:180",
                        check, counts["p2p_tile"]), path=f"twin_{name}"))
        del plans
        emit(rec)
        if counts != want:
            fail(f"the {name} program launched {counts}, not {want}")
        if sorted(errors) != sorted(limits):
            fail(f"the {name} program returned the errors {sorted(errors)},"
                 f" its limits are for {sorted(limits)}")
        for key, limit in limits.items():
            if not errors[key] <= limit:  # a NaN fails too
                fail(f"the {name} program's {key} {errors[key]:.3e} above "
                     f"{limit:.3e}")
    return entries


# ----------------------------------------------------------------------
# the LET distribution (parallel/let.py): ranks that share the card
# ----------------------------------------------------------------------
#: rank layouts of ``let_cached`` (every rank on the card) and the rank
#: count of its solve and of its kernel checks
LET_LAYOUTS = (1, 2, 4, (2, 2))
LET_RANKS = 4
#: an f32 LET apply against the plan's: the same operator, its M2L sums
#: taken in another order (class tiles where the plan takes families)
LET_APPLY_LIMIT = 1e-5
#: the same in f64, on a sphere of this many recursions
LET_F64_LIMIT = 1e-12
LET_F64_RECURSIONS = 6
#: chained LET matvecs timed per layout
LET_CHAIN = 10
#: the LET first-kind solve's solution error: the cached path's limit
LET_SOLVE_ERR_LIMIT = 5e-3


def let_apply(lp, q, p, fields=None):
    """One LET matvec of a BC variant (``fields``: the plan's host
    fields of that variant; None: the LET plan's own), user order in and
    out."""
    fn, ops = lp.matvec_fn(p, fields)
    return lp.from_padded(fn(ops, lp.to_padded(q)))


def let_collectives(lp):
    """The largest bytes a rank received in the last matvec, per
    collective and axis."""
    out = {}
    for op, axis, nbytes in lp.comm.log:
        key = f"{op} {axis if isinstance(axis, str) else ','.join(axis)}"
        out[key] = max(out.get(key, 0), nbytes)
    return out


def let_store_bytes(lp, fields):
    return [nbytes_of(s["A"]) for s, _ in lp._near_panels_local(fields)]


def counted_let(lp, fn):
    """Run ``fn()`` with every launch count set to 0 just before it and
    read just after, counting the LET matvecs it runs.  Returns (what
    ``fn`` returned, matvecs, counts)."""
    calls = {"matvecs": 0}
    inner = lp._matvec

    def counted(*a, **k):
        calls["matvecs"] += 1
        return inner(*a, **k)

    lp._matvec = counted
    torch.cuda.synchronize()
    reset_launch_counts()  # every kernel count, just before the run
    try:
        out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()  # ... and read just after it
    finally:
        lp._matvec = inner
    return out, calls["matvecs"], counts


def hold_let_launches(counts, matvecs, kernel, ranks, what):
    """Fail unless ``kernel`` launched once per rank per matvec and no
    other kernel launched (``kernel`` None: no kernel at all)."""
    want = {**dict.fromkeys(WRAPPERS, 0),
            **({kernel: ranks * matvecs} if kernel else {})}
    if matvecs == 0 or counts != want:
        fail(f"{what}: {matvecs} LET matvecs on {ranks} ranks launched "
             f"{counts}, not {want}")


def let_first_kind_solve(plan, lp, n):
    """The first-kind relaxed solve of ``first_kind_solve`` through the
    LET operator (``solver_ops``) and ``gmres_device``, its launches
    counted from 0 around the solve alone; its true residual on the
    plan's operator at p=10."""
    ones = np.ones(n, np.float32)
    b1 = plan.apply_flipped_bc(ones, p=10)[:, 0]
    mv, op4p = lp.solver_ops()

    def solve():
        return timed_solve(lambda: gmres_device(
            mv, lp.to_padded(b1), operand_for_p=op4p,
            config=first_kind_config()))

    ((x_pad, info), seconds), matvecs, counts = counted_let(lp, solve)
    x = lp.from_padded(x_pad).cpu().numpy()
    rec = solve_record(x, info, "let_device", seconds, n)
    rec["residual_history"] = [float(h[1]) for h in info.history]
    rec["true_residual"] = true_residual(plan, b1.cpu().numpy(), x)
    rec["matvecs"], rec["launch_counts"] = matvecs, counts
    return rec


def phase_let_layout(plan, n, layout, single_first, devices=None):
    """One LET plan of the cached path's plan: its host build and
    per-rank stores, ``apply`` against ``plan.apply`` at p=10 and p=5 in
    both BC variants, the bytes of its collectives, chained matvecs at
    p=5 with the kernel launches counted from 0 and the device launches
    of one matvec; at ``LET_RANKS`` ranks on one card the first-kind
    solve and ``near_panel`` on every rank store.  Returns (record, the
    LET plan)."""
    torch.cuda.synchronize()
    t0 = time.time()
    lp = LetPlan(plan, layout, devices=devices)
    host_build_s = time.time() - t0
    flipped = plan._flipped_fields()
    t0 = time.time()
    own_bytes = let_store_bytes(lp, plan.src.fields)
    flipped_bytes = let_store_bytes(lp, flipped)
    torch.cuda.synchronize()
    store_s = time.time() - t0
    stats = lp.stats()
    rec = {
        "phase": "let_cached", "layout": list(layout)
        if isinstance(layout, tuple) else layout, "ranks": lp.ndev,
        "devices": [str(d) for d in lp.devices], "n_panels": n,
        "host_build_s": host_build_s, "rank_stores_s": store_s,
        "rank_store_bytes": own_bytes,
        "rank_store_bytes_flipped": flipped_bytes,
        "plan_store_bytes": nbytes_of(plan.near_panels()[0]["A"]),
        "stats": stats, "limit": LET_APPLY_LIMIT,
    }
    q = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    diffs, collectives = {}, {}
    for p in (10, 5):
        for name, fields, ref in (("own", None, plan.apply),
                                  ("flipped", flipped,
                                   plan.apply_flipped_bc)):
            want = ref(q, p=p)
            got = let_apply(lp, q, p, fields)
            diffs[f"p{p}_{name}"] = float(
                (got - want).abs().max() / want.abs().max())
            for k, v in let_collectives(lp).items():
                collectives[k] = max(collectives.get(k, 0), v)
    rec["rel_max_diff"] = diffs
    rec["collective_bytes_received"] = collectives

    # chained matvecs at p=5, every launch count from 0
    fn, ops = lp.matvec_fn(5)
    x = lp.to_padded(np.ones(n, np.float32))
    for _ in range(2):
        y = fn(ops, x)
        x = y[:, 0] / torch.linalg.vector_norm(y)

    def chain():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        xx = x
        t0 = time.time()
        a.record()
        for _ in range(LET_CHAIN):
            yy = fn(ops, xx)
            xx = yy[:, 0] / torch.linalg.vector_norm(yy)
        b.record()
        torch.cuda.synchronize()
        return (a.elapsed_time(b) / LET_CHAIN,
                (time.time() - t0) * 1e3 / LET_CHAIN, xx)

    (ms, host_ms, xx), matvecs, counts = counted_let(lp, chain)
    rec["matvec_ms"] = ms
    rec["matvec_host_ms"] = host_ms
    rec["chain"] = LET_CHAIN
    by_name, _ = device_ops(lambda: fn(ops, x))
    rec["device_launches_per_matvec"] = sum(v[1] for v in by_name.values())
    rec["device_busy_us"] = sum(v[0] for v in by_name.values())
    rec["device_idle_share"] = idle_share(by_name, ms)
    rec["launch_counts"] = counts
    rec["matvecs"] = matvecs
    if not torch.isfinite(xx).all() or float(xx.abs().max()) == 0.0:
        fail(f"chained LET matvecs at {layout} gave non-finite or zero "
             "values")
    hold_let_launches(counts, matvecs, "near_panel", lp.ndev,
                      f"let_cached {layout}")
    if lp.ndev == LET_RANKS and lp.ndcn == 1 and devices is None:
        sol = let_first_kind_solve(plan, lp, n)
        sol["single_plan"] = {k: single_first[k] for k in (
            "iterations", "p_schedule", "err")}
        rec["first_kind_relaxed"] = sol
        hold_let_launches(sol["launch_counts"], sol["matvecs"], "near_panel",
                          lp.ndev, "the LET first-kind solve")
    rec["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    emit(rec)
    worst = max(diffs.values())
    if not worst <= LET_APPLY_LIMIT:
        fail(f"the LET apply at {layout} is {worst:.3e} off plan.apply "
             f"(limit {LET_APPLY_LIMIT:.0e}): {diffs}")
    panel_bytes = stats["near_panel_bytes_per_dev"]
    if not collectives or max(collectives.values()) >= panel_bytes:
        fail(f"a LET collective at {layout} brings a rank "
             f"{collectives} bytes, not below its store's {panel_bytes}")
    sol = rec.get("first_kind_relaxed")
    if sol is not None:
        single = sol["single_plan"]
        k = min(len(sol["p_schedule"]), len(single["p_schedule"]))
        if not (sol["converged"] and sol["finite_and_shaped"]
                and abs(sol["iterations"] - single["iterations"]) <= 1
                and sol["p_schedule"][:k] == single["p_schedule"][:k]):
            fail(f"the LET first-kind solve {sol} is not the single "
                 f"plan's {single}")
        if not (sol["err"] <= LET_SOLVE_ERR_LIMIT
                and sol["true_residual"] <= TRUE_RESIDUAL_LIMIT):
            fail(f"the LET first-kind solve: err {sol['err']:.3e} "
                 f"({LET_SOLVE_ERR_LIMIT:.0e}), "
                 f"true residual {sol['true_residual']:.3e} "
                 f"({TRUE_RESIDUAL_LIMIT:.0e})")
    return rec, lp


def let_rank_kernel_entries(lp, fields, check, name, replaces, path,
                            launches):
    """``check`` (``check_near_panel`` / ``check_panel_contract``) on
    every rank store of ``lp``, timed; one kernels-line entry per rank
    with its path and rank (``launches``: that rank's launches in the
    path's counted run)."""
    checks, entries = [], []
    for r, (store, meta) in enumerate(lp._near_panels_local(fields)):
        kw = {"tiled_model": True} if name == "near_panel" else {}
        rec = check(store, meta, lp.n_ctab - 1, 1e-5, f"{path}_rank{r}",
                    time_it=True, **kw)
        rec["rank"] = r
        checks.append(rec)
        entries.append(dict(kernel_entry(name, replaces, rec, launches),
                            path=path, rank=r))
    return checks, entries


def phase_let_f64(recursions):
    """At a small sphere in f64: the LET apply at ``LET_RANKS`` ranks
    against the f64 plan's, both BC variants, p=10 and p=5."""
    plan, n = build_plan(recursions, "float64")
    lp = LetPlan(plan, LET_RANKS)
    q = np.random.default_rng(4).standard_normal(n)
    flipped = plan._flipped_fields()
    diffs = {}
    for p in (10, 5):
        for name, fields, ref in (("own", None, plan.apply),
                                  ("flipped", flipped,
                                   plan.apply_flipped_bc)):
            want = ref(q, p=p)
            diffs[f"p{p}_{name}"] = float(
                (let_apply(lp, q, p, fields) - want).abs().max()
                / want.abs().max())
    rec = {"phase": "let_f64", "n_panels": n, "ranks": LET_RANKS,
           "rel_max_diff": diffs, "limit": LET_F64_LIMIT}
    emit(rec)
    if not max(diffs.values()) <= LET_F64_LIMIT:
        fail(f"the f64 LET apply is off the f64 plan's: {diffs}")
    return rec


def path_let(plan, n, single_first, f64_recursions):
    """The LET phases on the cached path's plan: ``let_cached`` at each
    of ``LET_LAYOUTS`` with every rank on the card (one LET plan at a
    time, freed before the next), across cards where there are two,
    ``near_panel`` on the rank stores at ``LET_RANKS`` ranks, and
    ``let_f64``.  Returns (checks, kernels-line entries)."""
    checks, entries = [], []
    for layout in LET_LAYOUTS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec, lp = phase_let_layout(plan, n, layout, single_first)
        if layout == LET_RANKS:
            launches = rec["launch_counts"]["near_panel"] // lp.ndev
            more, entries = let_rank_kernel_entries(
                lp, plan.src.fields, check_near_panel, "near_panel",
                "fmm_bem_tpu/ops/near_panel.py:539", "let_cached",
                launches)
            checks.extend(more)
        del lp
    torch.cuda.empty_cache()
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        cards = [torch.device("cuda", r) for r in range(2)]
        _, lp = phase_let_layout(plan, n, 2, single_first, devices=cards)
        del lp
    else:
        emit({"phase": "let_cached_distinct_cards", "ran": False,
              "reason": f"torch.cuda.device_count() is {ncards}: every "
                        "rank shares the one card"})
    torch.cuda.empty_cache()
    phase_let_f64(f64_recursions)
    torch.cuda.empty_cache()
    return checks, entries


def phase_let_stokes(plan, n):
    """The Stokes path's plan at ``LET_RANKS`` ranks on the card: the
    LET apply at p=8 against ``plan.apply`` (launches counted from 0:
    ``panel_contract`` once per rank per matvec), then
    ``panel_contract`` on every rank store.  Returns (checks,
    kernels-line entries)."""
    torch.cuda.empty_cache()
    t0 = time.time()
    lp = LetPlan(plan, LET_RANKS)
    host_build_s = time.time() - t0
    t0 = time.time()
    store_bytes = let_store_bytes(lp, plan.src.fields)
    store_s = time.time() - t0
    u = np.random.default_rng(6).standard_normal((n, 3)).astype(np.float32)
    want = plan.apply(u, p=STOKES_P)
    got, matvecs, counts = counted_let(
        lp, lambda: let_apply(lp, u, STOKES_P))
    rel = float((got - want).abs().max() / want.abs().max())
    rec = {"phase": "let_stokes", "n_panels": n, "ranks": LET_RANKS,
           "p": STOKES_P, "host_build_s": host_build_s,
           "rank_stores_s": store_s, "rank_store_bytes": store_bytes,
           "rel_max_diff": rel, "limit": LET_APPLY_LIMIT,
           "collective_bytes_received": let_collectives(lp),
           "near_panel_bytes_per_dev":
               lp.stats()["near_panel_bytes_per_dev"],
           "launch_counts": counts, "matvecs": matvecs}
    emit(rec)
    if not rel <= LET_APPLY_LIMIT:
        fail(f"the Stokes LET apply is {rel:.3e} off plan.apply")
    hold_let_launches(counts, matvecs, "panel_contract", lp.ndev,
                      "let_stokes")
    checks, entries = let_rank_kernel_entries(
        lp, plan.src.fields, check_panel_contract, "panel_contract",
        "fmm_bem_tpu/ops/near_panel.py:626", "let_stokes", matvecs)
    del lp
    torch.cuda.empty_cache()
    return checks, entries


def phase_let_points(plan, q):
    """The point LET of the point path's plan at ``LET_RANKS`` ranks on
    the card (the near field through the kernel's ``p2p_block``, no hand
    kernel) against ``plan.apply`` at p=5."""
    torch.cuda.empty_cache()
    t0 = time.time()
    lp = LetPlan(plan, LET_RANKS)
    host_build_s = time.time() - t0
    want = plan.apply(q, p=5)
    (got, seconds), matvecs, counts = counted_let(
        lp, lambda: timed_solve(lambda: let_apply(lp, q, 5)))
    rel = float((got - want).abs().max() / want.abs().max())
    rel_cols = ((got - want).abs().max(dim=0).values
                / want.abs().max(dim=0).values).tolist()
    rec = {"phase": "let_points", "n_points": len(q), "ranks": LET_RANKS,
           "host_build_s": host_build_s, "first_apply_s": seconds,
           "rel_max_diff": rel, "rel_max_diff_per_column": rel_cols,
           "limit": LET_APPLY_LIMIT,
           "collective_bytes_received": let_collectives(lp),
           "launch_counts": counts, "matvecs": matvecs}
    emit(rec)
    del lp
    torch.cuda.empty_cache()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail("the point LET result is not finite values of the plan's "
             "shape")
    if not rel <= LET_APPLY_LIMIT:
        fail(f"the point LET apply is {rel:.3e} off plan.apply")
    hold_let_launches(counts, matvecs, None, LET_RANKS, "let_points")
    return rec


def phase_twin_scaling_multichip(mem_recursions, strong_points):
    """The port's ``scaling_multichip`` in-process on the card with 1, 2
    and 4 ranks: ``-mode mem`` (every collective below a rank's store)
    and ``-mode strong``."""
    from fmm_bem_tpu_torch.examples import scaling_multichip as ex_multi

    recs = []
    for mode, argv in (
        ("mem", ["-mode", "mem", "-recursions", str(mem_recursions),
                 "-devs", "1,2,4"]),
        ("strong", ["-mode", "strong", "-N", str(strong_points),
                    "-devs", "1,2,4"]),
    ):
        res, lines, counts, seconds = run_program(ex_multi, argv)
        rec = {"phase": f"twin_scaling_multichip_{mode}", "argv": argv,
               "seconds": seconds, "printed": lines,
               "launch_counts": counts, "rows": res["rows"]}
        emit(rec)
        if [r["ndev"] for r in res["rows"]] != [1, 2, 4]:
            fail(f"scaling_multichip -mode {mode} ran {res['rows']}")
        for row in res["rows"]:
            if mode == "mem" and not (
                    row["max_collective_bytes"]
                    < row["stats"]["near_panel_bytes_per_dev"]):
                fail(f"scaling_multichip -mode mem: a collective of "
                     f"{row['max_collective_bytes']} bytes at "
                     f"{row['ndev']} ranks")
            if mode == "strong" and not (
                    math.isfinite(row["matvec_s"]) and row["matvec_s"] > 0):
                fail(f"scaling_multichip -mode strong: {row}")
        recs.append(rec)
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="every path at a small size")
    args = ap.parse_args()
    t_start = time.time()
    recursions, otf_recursions, npoints, nbase = 8, 9, 1_000_000, 32768
    stokes_recursions = 7
    yukawa_recursions, yukawa_small, point_scale = 8, 6, 1.0
    twin_recursions = 5
    dual_targets, nsmall = 200_000, 100_000
    multichip_recursions = 6
    if args.quick:
        recursions, otf_recursions, npoints, nbase = 6, 6, 50_000, 8192
        stokes_recursions = 5
        yukawa_recursions, yukawa_small, point_scale = 6, 5, 0.05
        # the Yukawa program's 512 panels are 5.66 % off the analytic
        # value, above the 5e-2 the twin is held to: 2,048 as in full
        twin_recursions = 5
        dual_targets, nsmall = 20_000, 10_000

    env = phase_env()
    build_s, checks, local_otf = phase_kernels_small()
    emit({
        "phase": "kernels_small", "build_s": build_s,
        "nvcc_report": {
            name: _build.build_logs.get(name, "").strip().splitlines()[-12:]
            for name in sorted(WRAPPERS)
        },
        "checks": checks,
    })
    local_entry = kernel_entry("otf_tile", "fmm_bem_tpu/ops/otf_tile.py:80",
                               local_otf,
                               local_otf["launch_counts"]["otf_tile"])
    local_entry["path"] = "kernels_small_local_evaluation"

    paths = {
        "cached": lambda: path_cached(recursions),
        "otf": lambda: path_otf(otf_recursions),
        "points": lambda: path_points(npoints, nbase),
        "stokes": lambda: path_stokes_both(stokes_recursions, not args.quick),
    }
    entries = []
    for drive in paths.values():
        t0 = time.time()
        path_checks, path_entries = drive()
        if not isinstance(path_entries, list):
            path_entries = [path_entries]
        emit({"phase": "kernels", "kernel": path_entries[0]["name"],
              "checks": path_checks,
              "launches_per_matvec": 1, "path_s": time.time() - t0})
        entries.extend(path_entries)
    t0 = time.time()
    bd_checks, bd_entry = path_points_block_diagonal(npoints)
    emit({"phase": "kernels", "kernel": "p2p_tile",
          "path": "points_block_diagonal", "checks": bd_checks,
          "launches_per_matvec": 1, "path_s": time.time() - t0})
    entries.extend([bd_entry, local_entry])
    # the Yukawa BEM path runs near_panel on a store of screened entries
    t0 = time.time()
    yukawa_checks = path_yukawa(yukawa_recursions, yukawa_small)
    emit({"phase": "kernels", "kernel": "near_panel", "path": "yukawa",
          "checks": yukawa_checks, "launches_per_matvec": 1,
          "path_s": time.time() - t0})
    t0 = time.time()
    path_point_kernels(point_scale)
    emit({"phase": "point_kernels_done", "path_s": time.time() - t0})
    t0 = time.time()
    entries.extend(phase_twins(recursions, twin_recursions))
    emit({"phase": "twins_done", "path_s": time.time() - t0})
    t0 = time.time()
    path_dual_points(npoints, nsmall, nbase)
    emit({"phase": "dual_points_done", "path_s": time.time() - t0})
    t0 = time.time()
    dual_checks, dual_entries = path_dual_bem_exterior(recursions,
                                                       dual_targets)
    emit({"phase": "kernels", "kernel": "near_panel",
          "path": "dual_bem_exterior", "checks": dual_checks,
          "launches_per_matvec": 1, "path_s": time.time() - t0})
    entries.extend(dual_entries)
    t0 = time.time()
    entries.extend(phase_twin_points(npoints, nsmall, nbase))
    emit({"phase": "twin_points_done", "path_s": time.time() - t0})
    t0 = time.time()
    phase_twin_scaling_multichip(multichip_recursions, nsmall)
    emit({"phase": "twin_scaling_multichip_done",
          "path_s": time.time() - t0})

    emit({"phase": "previous_times", "measured_in_this_run": False,
          "source": "PERF.md, table of TPU kernels, before the last "
                    "redesign (f32, NVIDIA H100 80GB HBM3, 700.00 W; one "
                    "synchronised call per sample but for p2p_tile, "
                    "timed back to back)",
          "ms": PREVIOUS_MS})
    emit({"phase": "timing", "script_s": time.time() - t_start})
    emit({"kernels": entries})
    print(env["gpu"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
