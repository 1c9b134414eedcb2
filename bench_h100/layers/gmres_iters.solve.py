"""GMRES iterations per solve, the mean over the window's solves
(``SolveInfo.iterations``)."""


def read(run):
    its = [r["iters"] for r in run.records if "iters" in r]
    return sum(its) / len(its) if its else None
