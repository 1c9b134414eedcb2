"""On-the-fly near products per solve (its right-hand side included):
the program's ``near.otf`` spans in the traced segment, one for each
product, so one for each matvec of a plan whose near field is
recomputed at every matvec.  It guards that the cell still runs that
route.  None where the program opens no such span (a program older
than the span, or a plan with a cached near store)."""

from bench_h100 import spans

NAME = "near.otf"


def read(run):
    a, n = spans.of_run(run), spans.per_op(run, "solve")
    if a is None or n is None or NAME not in a.names():
        return None
    return sum(a.spans[i][0] == NAME for i in a.kept) / n
