"""The readers ``graph_share.solve`` and ``graph_share.apply`` on a
synthetic run: the share of the matvec's far-field phases replayed from
CUDA graphs, from the program's ``matvec.graph`` and ``matvec.eager``
counters; None where the program has neither counter."""

import types

import pytest

from bench_h100 import harness
from bench_h100.yardstick import Trace

#: two operations, each with one matvec: (name, start, end, parent,
#: operation)
SPANS = [
    ("solve", 0, 40, None, 0),
    ("matvec", 10, 30, 0, 0),
    ("solve", 50, 90, None, 2),
    ("matvec", 60, 80, 2, 2),
]


class Log:
    spans_dropped = 0

    def __init__(self, counts):
        self._counts = counts

    def spans(self):
        return SPANS

    def counts(self):
        return self._counts


def run_of(monkeypatch, per, counts):
    from fmm_bem_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "log", Log(counts))
    bench = [(per, 0, 45), (per, 45, 95)]
    return types.SimpleNamespace(trace=Trace([], bench))


@pytest.mark.parametrize("per", ["solve", "apply"])
def test_graph_share(monkeypatch, per):
    """Graph replays over all phase runs of the operations in the
    window; counters outside them (operation None) are not read."""
    read = harness.load_reader("layers", f"graph_share.{per}")
    counts = {("matvec.graph", 0): 5, ("matvec.eager", 0): 5,
              ("matvec.graph", 2): 10, ("matvec.graph_captures", 0): 5,
              ("matvec.eager", None): 40}
    assert read(run_of(monkeypatch, per, counts)) == pytest.approx(0.75)
    graphs_only = {("matvec.graph", 0): 5, ("matvec.graph", 2): 5}
    assert read(run_of(monkeypatch, per, graphs_only)) == 1.0
    eager_only = {("matvec.eager", 0): 5}
    assert read(run_of(monkeypatch, per, eager_only)) == 0.0


@pytest.mark.parametrize("per", ["solve", "apply"])
def test_graph_share_without_the_counters(monkeypatch, per):
    """A program that counts neither (an older one) reads None, as does
    a run without a trace."""
    read = harness.load_reader("layers", f"graph_share.{per}")
    older = {("host_syncs", 0): 8, ("m2p.kernel", 2): 1}
    assert read(run_of(monkeypatch, per, older)) is None
    assert read(types.SimpleNamespace(trace=None)) is None
