"""Phase metrics and structured timing.

Counterpart of the reference's Logger (include/Logger.hpp:49-113 — a
map of event -> {hits, total time} printed at exit) and the scattered
get_time() prints (EvalInteractionLazy.hpp:137-152 per-matvec "P2P: Xs,
M2L(n): Ys").  Phases are explicit context managers, the report
includes derived throughput (interactions/s per phase), and device
work is fenced by synchronising the stream of a CUDA tensor, so that
timings are honest under PyTorch's asynchronous launches.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch


class Logger:
    """Event timer map: hits, total seconds, optional work counters."""

    def __init__(self):
        self._events = defaultdict(lambda: {"hits": 0, "total_s": 0.0, "work": 0.0})

    @contextlib.contextmanager
    def phase(self, name, work=0.0, sync=None):
        """Time a phase; ``work`` adds to the phase's work counter (e.g.
        interactions) so rates can be reported; ``sync`` is an optional
        tensor whose device work is waited for before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(sync, torch.Tensor) and sync.is_cuda:
                torch.cuda.current_stream(sync.device).synchronize()
            ev = self._events[name]
            ev["hits"] += 1
            ev["total_s"] += time.perf_counter() - t0
            ev["work"] += work

    def add(self, name, seconds, work=0.0):
        ev = self._events[name]
        ev["hits"] += 1
        ev["total_s"] += seconds
        ev["work"] += work

    def report(self):
        """Dict report: per-event totals + rates."""
        out = {}
        for name, ev in sorted(self._events.items()):
            r = dict(ev)
            if ev["work"] and ev["total_s"] > 0:
                r["rate_per_s"] = ev["work"] / ev["total_s"]
            out[name] = r
        return out

    def print_report(self):
        """Human-readable dump (ref Logger::operator<<)."""
        for name, ev in sorted(self._events.items()):
            rate = (
                f"  {ev['work'] / ev['total_s']:.3e}/s"
                if ev["work"] and ev["total_s"] > 0
                else ""
            )
            print(
                f"{name:24s} hits {ev['hits']:5d}  total {ev['total_s']:.4f}s{rate}"
            )

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


#: global logger, mirroring the reference's ``Logger Log`` global
#: (FMM_plan.hpp:13)
log = Logger()


def get_time():
    """Wall-clock seconds (ref include/timing.hpp get_time)."""
    return time.perf_counter()
