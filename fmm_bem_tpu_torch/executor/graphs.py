"""CUDA graphs of the matvec's far-field phases.

A matvec's far field is five phases in a chain, each reading what the
one before it wrote: P2M (charges -> M), M2M (M in place), M2L (M ->
L), L2L (L in place), L2P (L -> the slot result).  Eagerly each phase
is tens to hundreds of small launches (per level and octant class, per
M2L family class, per monomial of a Taylor recurrence), and the host
that launches them, not the card, sets the matvec's time.

Here each phase of one operand (a per-order, per-BC-variant entry of
``FmmPlan.variant_aux_slots``) is captured once into a CUDA graph and
replayed from then on, one graph launch a phase.  The phases keep their
spans: the host opens ``log.span(<phase>)`` and replays the phase's
graph inside it, so the span's markers stay outside the graphs and
enclose the graph's kernels on the card.

- Static buffers.  The matvec masks its charges straight into P2M's
  static input (``charges``); each later phase reads the static output
  of the one before it, and the chain's outputs (M, L, the L2P result)
  are the graphs' static outputs.
  Every graph of a plan allocates from one memory pool (the plan's), so
  a capture reuses what earlier captures freed: a chain always replays
  in order and rewrites its statics before it reads them, so no replay
  can clobber what another chain still needs.  ``own`` gives back a
  result that does not alias a static output.
- When.  On a CUDA device only.  An operand's first matvec runs its
  phases eagerly on the capture stream (it fills the kernels' lazy
  caches, cuBLAS's handle and the stream's cuBLAS workspace, which a
  capture cannot make); its second captures each phase and replays it.
  A capture that fails leaves that operand eager from then on.
- Lifetime.  The graphs live in the operand's entry and hold every
  tensor of the operand they read, so an evicted entry drops its graphs
  and no graph reads freed memory.
- Counters (``utils/metrics.py::log.count``): ``matvec.graph`` each
  phase replayed, ``matvec.eager`` each phase run eagerly,
  ``matvec.graph_captures`` each capture.
"""

from __future__ import annotations

import contextlib

import torch

from fmm_bem_tpu_torch.utils.metrics import log


class GraphPool:
    """The memory pool every CUDA graph of one plan allocates from, and
    the stream they are captured on (a capture cannot run on the default
    stream).  Both are made at the plan's first matvec on a card.  A
    capture that failed can leave the allocator recording to its pool
    (``beginAllocateToPool: already recording`` at the next capture on
    it), so ``spoil`` makes the next capture take a new pool and a new
    stream."""

    def __init__(self):
        self.handle = None
        self.stream = None

    def take(self, device):
        """(pool handle, capture stream) on ``device``."""
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device=device)
        return self.handle, self.stream

    def spoil(self):
        self.handle = self.stream = None


class PhaseGraphs:
    """The captured far-field phases of one operand.

    ``keep``: what the graphs read (the device tables ``d`` and the
    operand's entry), held while the graphs live; ``pool``: the plan's
    ``GraphPool``.  ``graphs`` maps a phase to ``(graph, input,
    output)``; ``warm`` holds the phases run once; ``q`` is P2M's static
    input; ``failed`` is set by a capture that failed, ``error`` says
    why."""

    def __init__(self, d, keep, pool):
        self.d = d
        self.keep = keep
        self.pool = pool
        self.graphs = {}
        self.warm = set()
        self.q = self.zero = None
        self.failed = False
        self.error = None

    def charges(self, q, mask):
        """The charges with padded slots zeroed (``mask``), written into
        P2M's static input, which the near pass then reads too."""
        if self.q is None:
            # ``mask`` broadcasts over the charge components of ``q``
            self.q = torch.empty_like(q)
            self.zero = torch.zeros((), dtype=q.dtype, device=q.device)
        return torch.where(mask, q, self.zero, out=self.q)

    @contextlib.contextmanager
    def _on_capture_stream(self, device):
        """Work inside runs on the capture stream, ordered after what
        the current stream holds and before what it is given next."""
        cur = torch.cuda.current_stream(device)
        pool, s = self.pool.take(device)
        s.wait_stream(cur)
        try:
            with torch.cuda.stream(s):
                yield pool
        finally:
            cur.wait_stream(s)

    def _capture(self, fn, x):
        """Capture ``fn(x)``; (graph, output)."""
        g = torch.cuda.CUDAGraph()
        with self._on_capture_stream(x.device) as pool:
            g.capture_begin(pool=pool)
            try:
                out = fn(x)
            except BaseException:
                _abandon(g, x.device, pool)
                self.pool.spoil()
                raise
            g.capture_end()
        return g, out

    def _warm_up(self, fn, x):
        """``fn(x)`` run eagerly on the capture stream: the capture then
        finds the stream's cuBLAS workspace and the kernels' lazy state
        in place, and adds no second workspace beside the eager one."""
        with self._on_capture_stream(x.device):
            return _eager(fn, x)

    def run(self, name, fn, x):
        """Phase ``name`` as ``fn(x)``: eagerly on the capture stream the
        first time, then captured and replayed; eagerly where the
        operand's capture failed or ``x`` is not the input its graph was
        captured on."""
        if self.failed:
            return _eager(fn, x)
        if name not in self.graphs:
            if name not in self.warm:
                self.warm.add(name)
                return self._warm_up(fn, x)
            try:
                g, out = self._capture(fn, x)
            except Exception as e:
                # a capture that failed: this operand runs eagerly from
                # here on, on the outputs the replays so far left
                self.failed, self.error = True, f"{name}: {e!r}"
                self.graphs.clear()
                return _eager(fn, x)
            log.count("matvec.graph_captures")
            self.graphs[name] = (g, x, out)
        g, x_in, out = self.graphs[name]
        if x is not x_in:
            return _eager(fn, x)
        g.replay()
        log.count("matvec.graph")
        return out

    def own(self, res):
        """``res``, or a copy where it is a graph's static output."""
        ptr = res.untyped_storage().data_ptr()
        for _, _, out in self.graphs.values():
            if out.untyped_storage().data_ptr() == ptr:
                return res.clone()
        return res


def _abandon(g, device, pool):
    """End a capture that raised: the stream leaves capture mode and the
    allocator stops routing the stream's allocations to the pool (which
    ``capture_end`` skips when the capture was invalidated)."""
    try:
        g.capture_end()
        return
    except Exception:
        pass
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except Exception:
        pass


def _eager(fn, x):
    log.count("matvec.eager")
    return fn(x)


class Eager:
    """The phases run eagerly, on the current stream (the CPU)."""

    def charges(self, q, mask):
        return torch.where(mask, q, 0.0)

    def run(self, name, fn, x):
        return _eager(fn, x)

    def own(self, res):
        return res


EAGER = Eager()


def phases_for(aux, d, pool):
    """The runner of one matvec's far-field phases on the operand
    ``(d, aux)`` on a CUDA device: its ``PhaseGraphs``, kept in
    ``aux["graphs"]``.  ``pool``: the plan's ``GraphPool``."""
    gs = aux.get("graphs")
    if gs is None or gs.d is not d:
        keep = {k: v for k, v in aux.items() if k != "graphs"}
        gs = aux["graphs"] = PhaseGraphs(d, keep, pool)
    return gs
