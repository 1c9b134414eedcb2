"""The program's ``gmres.stall_raises`` counter per solve (its
right-hand side included): each raise of the floor tier by GMRES's
stall guard, or each block it ends as stalled.  None where the program
does not register the counter (a program older than it)."""

from bench_h100 import spans

NAME = "gmres.stall_raises"


def read(run):
    a = spans.of_run(run)
    if a is None or not any(nm == NAME for nm, _ in a.counts):
        return None
    return spans.count(run, NAME, "solve")
