"""The share of the matvec's far-field phases a solve (its right-hand
side included) replayed from CUDA graphs: the program's ``matvec.graph``
counter over ``matvec.graph`` plus ``matvec.eager`` (each phase run
counts one of the two, ``executor/graphs.py``).  None where the program
counts neither (a program older than the counters)."""

from bench_h100 import spans

PER = "solve"


def read(run):
    graph = spans.count(run, "matvec.graph", PER)
    eager = spans.count(run, "matvec.eager", PER)
    if graph is None or eager is None or graph + eager == 0:
        return None
    return graph / (graph + eager)
