"""Per-phase device timing and roofline accounting for the FMM matvec.

The reference prints a per-matvec P2P/M2L wall-clock split
(EvalInteractionLazy.hpp:137-152).  This module (the counterpart of
``fmm_bem_tpu/utils/roofline.py``) answers a stronger question, how
close each phase of the matvec comes to the card's limits: it times
each phase on the plan's device and scores it against an analytic
FLOP/byte model,

- the matmul phases (M2M/M2L/L2L) against the card's peak arithmetic
  rate of the plan's dtype on the CUDA cores (the port pins full-f32
  matmuls, ``fmm_bem_tpu_torch/__init__.py``, so no TF32 tensor-core
  rate applies);
- the streaming phases (the P2M/L2P tables, the near-field store)
  against the memory rate: they touch their operand bytes once.

Timing method: the phases are timed as pipeline *prefixes* (P2M;
P2M+M2M; ...; the full matvec), each run ``chain`` times back to back,
and a phase's time is the difference of consecutive prefix times.  The
last prefix is the matvec, so the phases telescope to the pipeline
total by construction; ``total.sum_ratio`` holds that total against an
independently timed matvec, the credibility check.  Prefixes and the
reference matvec are timed round-robin and the minimum of the repeats
is kept; isotonic (PAVA) regression on the cumulative times removes
negative differences.

The phase list follows ``FmmPlan._matvec_slots`` branch for branch,
M2P included (the JAX package's list leaves M2P out, though its slot
matvec runs it).  Plans without a slot route take the body-order
phases of ``FmmPlan._matvec``.

On a card each chained prefix runs between two CUDA events and is
synchronised after them; on the CPU the host clock times it.  Eager
PyTorch runs every launch it is given, in order, so the steps need no
feedback between them and no dispatch baseline is subtracted.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from fmm_bem_tpu_torch.config import Evaluator

#: per-card peaks: (f32 FLOP/s on the CUDA cores, f64 FLOP/s, memory
#: bytes/s), keyed by the prefix of ``torch.cuda.get_device_name()``.
#: NVIDIA's H100 data sheet, SXM part, dense rates at the 700 W limit.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 34e12, 3.35e12),
}

#: per chained step: a phase below this is timer noise (the JAX
#: package's value, not measured on a card)
TIMER_FLOOR_S = 15e-6
#: per chained step: a phase below this is attribution noise and gets
#: no rates.  The difference of two consecutive prefixes moves from
#: repeat to repeat: three times the largest spread measured on an
#: NVIDIA H100 80GB HBM3 (700 W), rounded up, which was the M2P of the
#: 524,288-panel on-the-fly plan at p=5, 7.05 ms (PERF.md section 5)
PHASE_FLOOR_S = 22e-3
#: the window ``total.sum_ratio`` must fall in for the phases to count
SUM_RATIO_WINDOW = (0.85, 1.15)


def device_name(device):
    """The name a record gives its device: the card's, or ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def chip_peaks(name=None):
    """``(f32 FLOP/s, f64 FLOP/s, bytes/s)`` of the card named ``name``
    (default: the current card, or ``"cpu"`` where there is none);
    ``None`` for the CPU or a card not in ``CHIP_PEAKS``."""
    if name is None:
        name = device_name("cuda" if torch.cuda.is_available() else "cpu")
    for prefix, peaks in CHIP_PEAKS.items():
        if name.startswith(prefix):
            return peaks
    return None


def per_call_s(fn, reps, device):
    """Seconds per call of ``fn()`` over ``reps`` calls enqueued back to
    back: between two CUDA events (then synchronised) on a card, by the
    host clock on the CPU.  The garbage collector is off meanwhile, as
    in ``timeit``: the matvec is host-bound, and a collection would land
    in one prefix's time and not in the next's."""
    device = torch.device(device)
    gc_on = gc.isenabled()
    gc.disable()
    try:
        if device.type == "cuda":
            with torch.cuda.device(device):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    fn()
                b.record()
                b.synchronize()
            return a.elapsed_time(b) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    finally:
        if gc_on:
            gc.enable()


def _flop_byte_model(plan, p):
    """Analytic per-phase FLOPs and device-memory bytes for one matvec
    (the JAX package's model).  M2P, the on-the-fly near field and the
    point P2P have no row: they report their time only."""
    kern = plan.kernel
    W = kern.width(p)
    cW = kern.ncomp * W
    it = plan.dtype.itemsize
    nbox = plan.src.tree.num_boxes
    nl = len(plan.src.leaf_ids)
    K = plan.src.leaf_pad
    rdim = getattr(kern, "result_dim", 1)
    cdim = getattr(kern, "charge_dim", 1)

    model = {}
    # P2M table: one stream of the slot-ordered table + the box write
    model["p2m"] = (
        2.0 * nl * K * cW * cdim,
        (nl * K * cW * cdim + nbox * cW) * it,
    )
    nch = nbox - 1
    # translation matmuls are de-kron'd: [rows*ncomp, W] x [W, W]
    model["m2m"] = (
        2.0 * nch * cW * W,
        (2 * nch * cW + len(plan.src.m2m_mats) * W * W) * it,
    )
    npairs = len(plan.m2l_tile_src)
    ntile = npairs // max(plan.m2l_tile_size, 1) if npairs else 0
    m2l_flops = 2.0 * npairs * cW * W
    # residual tiles: gathered expansions in+out, one W x W matrix per
    # tile, and the bucket-sum re-read
    m2l_bytes = (3 * npairs * cW + ntile * W * W) * it
    fam = plan.m2l_fam
    if fam is not None:
        Fpad = sum(len(a) for a in fam.cls_sp)
        W8 = 8 * W
        m2l_flops += 2.0 * Fpad * kern.ncomp * W8 * W8
        m2l_bytes += (
            2 * fam.nusp * 8 * cW          # sibling stage in+out
            + 3 * Fpad * kern.ncomp * W8   # rows in, out, transpose
            + len(fam.cls_sp) * W8 * W8    # class operator stream
            + 2 * Fpad * 8 * cW            # family bucket in+out
            + plan.tgt.tree.num_boxes * cW  # child broadcast
        ) * it
    model["m2l"] = (m2l_flops, m2l_bytes)
    model["l2l"] = model["m2m"]
    model["l2p"] = (
        2.0 * nl * K * cW * rdim,
        (nl * K * cW * rdim + nl * cW + nl * K * rdim) * it,
    )
    panels, _ = plan.near_panels()
    if panels is not None and "A" in panels:
        # the whole store, padding columns included.  chip_smoke.py's
        # near_panel_bound counts only the columns the kernel needs
        # (m0 * KS * cdim of each row); the two agree on a store
        # without padding, such as the cached sphere's
        pb = panels["A"].numel() * it
        model["near"] = (2.0 * pb / it, pb)
    return model


def _pava_nondecreasing(y):
    """Pool-adjacent-violators: least-squares monotone fit of y."""
    pools = []  # [value, weight]
    for v in y:
        pools.append([float(v), 1.0])
        while len(pools) > 1 and pools[-2][0] > pools[-1][0]:
            v1, w1 = pools.pop()
            v0, w0 = pools.pop()
            pools.append([(v0 * w0 + v1 * w1) / (w0 + w1), w0 + w1])
    out = []
    for v, w in pools:
        out.extend([v] * int(round(w)))
    return out


def _phase_fns(plan, p, aux, slot_ops):
    """Ordered matvec phases as ``(name, fn)``; ``fn(d, aux, sf, tf,
    st)`` advances the state dict ``st``: ``"q"`` the charges, ``"M"``
    and ``"L"`` the multipole and local tables, ``"res"`` the result.

    With ``slot_ops`` (the plan's ``_slot_ops``) the phases are those
    of ``FmmPlan._matvec_slots``: P2M, M2M, M2L, L2L, L2P, then M2P
    where the plan has level-skewed pairs, then the near field (the
    cached store or the on-the-fly tiles) or the point P2P; a
    near-field-only plan has the near phase alone.  Without, those of
    the body-order ``FmmPlan._matvec``.  ``run_phases`` composes them.
    """
    nl_t, K_t = len(plan.tgt.leaf_ids), plan.tgt.leaf_pad
    kern = plan.kernel
    near = plan.near_rows is not None and "panels" in aux
    coo = (plan.near_rows is not None and not near
           and len(plan.near_rows) > 0)
    p2p = plan.near_rows is None and len(plan.p2p_src_slot) > 0
    far = not plan.near_only

    def put(key, f):
        def fn(d, aux, sf, tf, st):
            st[key] = f(d, aux, sf, tf, st)
        return fn

    def plus(f):
        def fn(d, aux, sf, tf, st):
            st["res"] = st["res"] + f(d, aux, sf, tf, st)
        return fn

    m2m = put("M", lambda d, aux, sf, tf, st: plan._phase_m2m(d, st["M"]))
    m2l = put("L", lambda d, aux, sf, tf, st: plan._phase_m2l(d, st["M"], p))
    l2l = put("L", lambda d, aux, sf, tf, st: plan._phase_l2l(d, st["L"]))
    fns = []
    if slot_ops is not None:
        if far:
            fns += [
                ("p2m", put("M", lambda d, aux, sf, tf, st:
                            plan._p2m_slots(d, aux, st["q"], p))),
                ("m2m", m2m), ("m2l", m2l), ("l2l", l2l),
                ("l2p", put("res", lambda d, aux, sf, tf, st:
                            plan._l2p_slots(d, aux, st["L"], p))),
            ]
            if len(plan.m2p_src):
                fns.append(("m2p", plus(lambda d, aux, sf, tf, st:
                                        plan._m2p_pass(d, tf, st["M"], p,
                                                       nl_t, K_t))))
        if near:
            fns.append(("near", plus(lambda d, aux, sf, tf, st:
                                     plan._near_pass_slots(aux, st["q"]))))
        elif p2p:
            fns.append(("p2p", plus(lambda d, aux, sf, tf, st:
                                    plan._p2p_pass(d, sf, tf, st["q"],
                                                   nl_t, K_t))))
        return fns

    # body order: results in Morton order until run_phases' last gather
    if far:
        fns += [
            ("p2m", put("M", lambda d, aux, sf, tf, st:
                        plan._phase_p2m(d, aux, sf, st["q"], p))),
            ("m2m", m2m),
        ]
        if plan.config.evaluator == Evaluator.FMM:
            fns += [
                ("m2l", m2l), ("l2l", l2l),
                ("l2p", plus(lambda d, aux, sf, tf, st:
                             plan._phase_l2p(d, aux, tf, st["L"], p))),
            ]
        if len(plan.m2p_src):
            fns.append(("m2p", plus(lambda d, aux, sf, tf, st:
                                    plan._m2p_pass(d, tf, st["M"], p, nl_t,
                                                   K_t, slots=False))))
    if near:
        fns.append(("near", plus(lambda d, aux, sf, tf, st:
                                 plan._near_pass(d, aux, st["q"]))))
    elif coo:
        # the COO replay (near_panel=False, droptol)
        fns.append(("near", plus(lambda d, aux, sf, tf, st: kern.near_matvec(
            d["near_vals"], d["near_rows"], d["near_cols"], tf, st["q"],
            plan.tgt.tree.num_bodies))))
    elif p2p:
        fns.append(("p2p", plus(lambda d, aux, sf, tf, st: plan._p2p_pass(
            d, sf, tf, plan._leaf_tiles(d, st["q"]).reshape(-1), nl_t, K_t,
        )[d["t_body_flat_slot"]])))
    return fns


def run_phases(plan, fns, operand, q, slots):
    """Phases ``fns`` in order on ``operand = (d, aux, sf, tf)`` and the
    charges ``q`` (slot vector, or user order in body order), with the
    per-call work the matvec does around them: the charge mask (slot
    layout) or the Morton gather of the charges and the final gather of
    the results (body order).  All the phases of ``_phase_fns`` give
    ``_matvec_slots`` / ``_matvec``; a prefix gives its part of it.
    Returns the state dict."""
    d, aux, sf, tf = operand
    kern = plan.kernel
    cdim = getattr(kern, "charge_dim", 1)
    st = {}
    if slots:
        nl_s, K_s = len(plan.src.leaf_ids), plan.src.leaf_pad
        mask = d["s_slot_mask"]
        if cdim > 1:
            st["q"] = torch.where(
                mask[:, None], q.reshape(nl_s * K_s, cdim), 0.0)
        else:
            st["q"] = torch.where(mask, q.reshape(nl_s * K_s), 0.0)
        if plan.near_only:
            nl_t, K_t = len(plan.tgt.leaf_ids), plan.tgt.leaf_pad
            st["res"] = torch.zeros(
                (nl_t * K_t, kern.result_dim), dtype=q.dtype,
                device=q.device)
    else:
        st["q"] = q[d["s_perm"]]
        st["res"] = torch.zeros(
            (plan.tgt.tree.num_bodies, kern.result_dim), dtype=q.dtype,
            device=q.device)
    for _, fn in fns:
        fn(d, aux, sf, tf, st)
    if not slots:
        st["res"] = st["res"][d["t_inv_perm"]]
    return st


def _production(plan, p, q):
    """The matvec ``apply`` runs, as ``(operand, matvec(operand, x),
    x0, slot_ops)``: the slot route where the plan has one, else body
    order; ``x0`` is ``q`` in the matvec's input layout."""
    if plan.has_slot_route:
        slot_ops = plan._slot_ops(None)
        mv, op4p, to_s = slot_ops[:3]
        operand = op4p(p)
        return operand, lambda o, x: mv(o, x, p), to_s(q), slot_ops
    sf = plan.device_fields(None, "src")
    tf = plan.device_fields(None, "tgt") if plan.dual else sf
    operand = (plan.device_data(p), plan.variant_aux(p), sf, tf)
    cdim = getattr(plan.kernel, "charge_dim", 1)
    n = plan.src.tree.num_bodies
    x0 = torch.as_tensor(np.asarray(q), dtype=plan.dtype, device=plan.device)
    x0 = x0.reshape(n) if cdim == 1 else x0.reshape(n, cdim)
    return (operand, lambda o, x: plan._matvec(*o, x, p), x0, None)


def phase_breakdown(plan, p, q=None, chain=96, iters=1, repeats=3,
                    solo=False, mv_ms_ref=None):
    """Measure the matvec phases on the plan's device.

    Returns ``{phase: {"ms", "spread_ms", "gflops", "gbs", "pct_mxu",
    "pct_hbm"}}`` plus a ``"total"`` entry ``{"ms", "matvec_ms",
    "sum_ratio", "suspect", "device"}``, where ``sum_ratio`` = (sum of
    the phases) / (an independently timed matvec): trust the phases
    only when it is within 15 % of 1 (``suspect`` false).  The
    reference matvec is timed in the same round-robin as the prefixes,
    and ``sum_ratio`` is the median over the repeats of the full
    pipeline's time over the matvec's in the same round: the matvec is
    host-bound on a card, and the host's speed drifts over seconds.
    ``ms`` and ``matvec_ms`` are minima over the repeats.  ``ms`` is
    per matvec; ``spread_ms`` the distance between the quartiles of the
    phase's per-repeat differences.  ``pct_mxu`` keeps the JAX
    package's key: here it is the share of the peak FP32 (FP64 for an
    f64 plan) rate of the CUDA cores, ``pct_hbm`` the share of the
    memory rate; both only on a card in ``CHIP_PEAKS`` and for a
    phase the model counts.  A share over 100 % marks the phase
    ``unreliable`` and drops its rates; a phase under the floors is
    marked ``below_timer_floor`` / ``below_attribution_floor`` and
    gets none.  ``device`` is the card's name or ``"cpu"``.

    ``mv_ms_ref`` supplies an externally measured matvec ms in place
    of the round-robin's (then ``sum_ratio`` = ``ms`` / ``mv_ms_ref``);
    it must time the same per-call work (the slot route's charge mask
    included), and on a host-bound matvec it sees the host at another
    moment.
    ``solo=True`` adds ``"ms_solo"``: each phase alone on its
    materialised input (an upper bound; M2M and L2L time a copy of
    the table they update in place with it).  ``iters`` chained runs
    of ``chain`` calls make one timing.
    """
    p = min(int(p), plan.config.max_p)
    dev = plan.device
    n = plan.src.tree.num_bodies
    cdim = getattr(plan.kernel, "charge_dim", 1)
    if q is None:
        q = np.ones(n if cdim == 1 else (n, cdim))
    operand, mv, x0, slot_ops = _production(plan, p, q)
    slots = slot_ops is not None
    fns = _phase_fns(plan, p, operand[1], slot_ops)
    names = [nm for nm, _ in fns]
    reps = chain * iters

    # distinct charges per repeat: every call is unambiguous work
    qs = [x0 * (1.0 + 1e-5 * r) for r in range(repeats)]
    runs = [
        (lambda x, pre=fns[: k + 1]: run_phases(plan, pre, operand, x, slots))
        for k in range(len(fns))
    ]
    if mv_ms_ref is None:
        # the reference matvec joins the round-robin: the host's speed
        # drifts over seconds, and a reference timed at another moment
        # would compare the phases with another host
        runs.append(lambda x: mv(operand, x))
    for run in runs:  # first use: kernel builds, per-order tables
        run(x0)
    times = np.array([
        [per_call_s(lambda: run(qs[r]), reps, dev) for run in runs]
        for r in range(repeats)
    ])
    cum_r = times[:, : len(fns)]
    cum = _pava_nondecreasing(cum_r.min(axis=0))
    per_phase = np.diff(np.concatenate([[0.0], cum]))
    raw = np.diff(np.concatenate([np.zeros((repeats, 1)), cum_r], axis=1),
                  axis=1)
    q1, q3 = np.percentile(raw, [25, 75], axis=0)
    spread = q3 - q1
    mv_t = times[:, -1].min() if mv_ms_ref is None else mv_ms_ref / 1e3
    # the pipeline against the matvec: round by round (the same host
    # moment) where the matvec joined the round-robin
    ratio = (float(np.median(times[:, len(fns) - 1] / times[:, -1]))
             if mv_ms_ref is None else cum[-1] / mv_t)

    solo_ms = {}
    if solo:
        # each phase's input state, materialised by one run
        st = run_phases(plan, [], operand, x0, slots)
        d, aux, sf, tf = operand
        for nm, fn in fns:
            before = dict(st)

            def one(fn=fn, nm=nm, before=before):
                s = dict(before)
                for key in {"m2m": "M", "l2l": "L"}.get(nm, ""):
                    s[key] = s[key].clone()
                fn(d, aux, sf, tf, s)

            one()
            solo_ms[nm] = 1e3 * min(
                per_call_s(one, reps, dev) for _ in range(repeats))
            fn(d, aux, sf, tf, st)

    model = _flop_byte_model(plan, p)
    name = device_name(dev)
    peaks = chip_peaks(name)
    out = {}
    for nm, dt_k, sp in zip(names, per_phase, spread):
        r = {"ms": dt_k * 1e3, "spread_ms": sp * 1e3}
        if nm in solo_ms:
            r["ms_solo"] = solo_ms[nm]
        out[nm] = r
        if dt_k < TIMER_FLOOR_S:
            r["below_timer_floor"] = True
            continue
        if dt_k < PHASE_FLOOR_S:
            # the ms is attribution-limited: report it, but no rates
            r["below_attribution_floor"] = True
            continue
        if nm not in model:
            continue
        flops, bytes_ = model[nm]
        r["gflops"] = flops / dt_k / 1e9
        r["gbs"] = bytes_ / dt_k / 1e9
        if peaks:
            f_peak = peaks[0] if plan.dtype == torch.float32 else peaks[1]
            pct_mxu = 100.0 * (flops / dt_k) / f_peak
            pct_hbm = 100.0 * (bytes_ / dt_k) / peaks[2]
            if pct_mxu > 100.0 or pct_hbm > 100.0:
                # a reading past peak is self-refuting: the phase time
                # is under-attributed, not the card over-achieving
                r["unreliable"] = True
                r.pop("gflops")
                r.pop("gbs")
            else:
                r["pct_mxu"] = pct_mxu
                r["pct_hbm"] = pct_hbm
    total = cum[-1]
    sum_ratio = (
        ratio if mv_t > TIMER_FLOOR_S and total > TIMER_FLOOR_S else None
    )
    lo, hi = SUM_RATIO_WINDOW
    out["total"] = {
        "ms": total * 1e3,
        "matvec_ms": mv_t * 1e3,
        "sum_ratio": sum_ratio,
        # below the timer floor the ratio is noise, not evidence
        "suspect": sum_ratio is None or not (lo <= sum_ratio <= hi),
        "device": name,
    }
    return out
