"""The benchmark's measuring arithmetic, frozen here so that a change
to the program cannot move the yardstick.

- ``CHIP_PEAKS`` and ``per_call_s``: copies of
  ``fmm_bem_tpu_torch/utils/roofline.py`` (the published H100 SXM
  peaks; CUDA events around a chain of calls, then a synchronise).
- ``near_panel_bound``: a copy of ``chip_smoke.py::near_panel_bound``
  (the needed bytes of the cached near store in 32-byte sectors).
- ``p2p_needed_evaluations`` and ``P2P_FLOPS``: the count that
  ``chip_smoke.py::pair_evaluations`` makes and the flops it charges
  each evaluation.
- ``Trace``: the device operations of a profiled segment, by name
  (after ``chip_smoke.py::device_ops``), and the busy time as the
  union of their intervals (``chip_smoke.py::idle_share`` summed the
  operations' times instead, which counts overlap twice).
"""

from __future__ import annotations

import gc
import time

import torch

#: per-card peaks: (f32 FLOP/s on the CUDA cores, f64 FLOP/s, memory
#: bytes/s), keyed by the prefix of ``torch.cuda.get_device_name()``.
#: NVIDIA's H100 data sheet, SXM part, dense rates at the 700 W limit.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 34e12, 3.35e12),
}

#: flops charged to one point-Laplace evaluation (potential and the
#: difference-form force), as ``chip_smoke.py`` charges ``p2p_tile``
P2P_FLOPS = 18


def chip_peaks(name):
    """``CHIP_PEAKS`` of the card ``name``, or None for another device."""
    for prefix, peaks in CHIP_PEAKS.items():
        if name.startswith(prefix):
            return peaks
    return None


def per_call_s(fn, reps, device):
    """Seconds per call of ``fn()`` over ``reps`` calls enqueued back to
    back: between two CUDA events (then synchronised) on a card, by the
    host clock on the CPU; the garbage collector off meanwhile."""
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


def near_panel_bound_s(A, row_ptr, m0, KS, cdim, nl_t, ql_numel, peaks):
    """The least time of one ``near_panel`` product on a cached store:
    the larger of its bytes over the memory rate and its multiply-adds
    over the f32/f64 peak.  Bytes: each real chunk's rows up to the
    last needed column ``m0 * KS * cdim``, in whole 32-byte sectors,
    the chunk's indices, the row pointer, the charges and the result,
    each once; dummy chunks are never read."""
    _, KTr, _ = A.shape
    esz = A.element_size()
    n_real = int(row_ptr[-1])
    needed = m0 * KS * cdim
    row_bytes = -(-needed * esz // 32) * 32
    nbytes = (n_real * KTr * row_bytes + n_real * m0 * 4
              + row_ptr.numel() * 4 + ql_numel * esz + nl_t * KTr * esz)
    flops = 2.0 * n_real * KTr * needed
    peak = peaks[0] if A.dtype == torch.float32 else peaks[1]
    return max(nbytes / peaks[2], flops / peak)


def p2p_needed_evaluations(tgt_mask, src_mask, tgt_slot, src_slot):
    """Kernel evaluations the near pairs need: the sum over pairs of
    (bodies of the target leaf) x (bodies of the source leaf), padded
    slots not counted.  Masks are the ``[leaves, leaf_pad]`` body masks,
    slots the pair list's leaf indices (numpy arrays)."""
    cnt_t = tgt_mask.sum(axis=1).astype("int64")
    cnt_s = src_mask.sum(axis=1).astype("int64")
    return int((cnt_t[tgt_slot] * cnt_s[src_slot]).sum())


def percentile(values, pct):
    """The ``pct`` percentile by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    k = (len(v) - 1) * pct / 100.0
    lo = int(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


# ---------------------------------------------------------------------------
# the trace of a profiled segment


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _union(intervals):
    """Merged ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The device operations and the benchmark's own spans of one
    ``torch.profiler`` segment (CUDA activity), in nanoseconds of the
    profiler's clock.

    ``ops``: ``(name, start, end, is_kernel)`` of every operation that
    ran on the card (kernels, copies, fills), without the annotations
    the profiler mirrors onto the device timeline.  ``spans``:
    ``(name, start, end)`` of the benchmark's ``record_function`` spans,
    whose names begin with ``SPAN_PREFIX``."""

    SPAN_PREFIX = "bench."

    def __init__(self, ops, spans):
        self.ops = ops
        self.spans = spans

    @classmethod
    def from_profile(cls, prof):
        from torch.autograd import DeviceType

        ops, spans = [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if ev.device_type() == DeviceType.CUDA:
                if name.startswith(cls.SPAN_PREFIX):
                    continue
                annot = getattr(ev, "is_user_annotation", None)
                if annot is not None and annot():
                    continue
                kind = getattr(ev, "activity_type", None)
                if kind is not None and "annotation" in str(kind()).lower():
                    continue
                low = name.lower()
                is_kernel = not (low.startswith("memcpy")
                                 or low.startswith("memset"))
                ops.append((name, start, end, is_kernel))
            elif name.startswith(cls.SPAN_PREFIX):
                spans.append((name[len(cls.SPAN_PREFIX):], start, end))
        return cls(ops, spans)

    def window_ns(self):
        """From the start of the first span to the end of the last."""
        if not self.spans:
            return 0
        return (max(e for _, _, e in self.spans)
                - min(s for _, s, _ in self.spans))

    def busy_ns(self):
        """Nanoseconds of the window in which some operation ran on the
        card: the union of the operations' intervals, clipped to it."""
        if not self.spans:
            return 0
        lo = min(s for _, s, _ in self.spans)
        hi = max(e for _, _, e in self.spans)
        busy = 0
        for s, e in _union((max(s, lo), min(e, hi))
                           for _, s, e, _ in self.ops):
            if e > s:
                busy += e - s
        return busy

    def kernel_launches(self):
        return sum(1 for op in self.ops if op[3])

    def kernel_times(self, fragment):
        """Device seconds of every kernel whose name holds
        ``fragment``, one entry per launch."""
        return [(e - s) / 1e9 for n, s, e, k in self.ops
                if k and fragment in n]

    def span_count(self, name):
        return sum(1 for n, _, _ in self.spans if n == name)

    def top_ops(self, k=10):
        """The ``k`` device operations that took most time, by name:
        ``[[name, seconds], ...]``."""
        tot = {}
        for n, s, e, _ in self.ops:
            tot[n] = tot.get(n, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:200], t / 1e9] for n, t in top]

    def idle_gaps(self, k=10):
        """The ``k`` longest stretches of the window with nothing on the
        card, each named by the innermost benchmark span open at its
        midpoint: ``[[span, seconds], ...]``."""
        if not self.spans:
            return []
        lo = min(s for _, s, _ in self.spans)
        hi = max(e for _, _, e in self.spans)
        busy = _union((s, e) for _, s, e, _ in self.ops)
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, min(s, hi)))
            t = max(t, e)
            if t >= hi:
                break
        if t < hi:
            gaps.append((t, hi))
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (s + e) // 2
            open_ = [(ss, n) for n, ss, ee in self.spans if ss <= mid <= ee]
            label = max(open_)[1] if open_ else "between_spans"
            out.append([label, (e - s) / 1e9])
        return out
