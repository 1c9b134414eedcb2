"""The mean multipole order over every GMRES iteration of the window
(``SolveInfo.history[:, 2]``): how far the relaxation lowers p."""


def read(run):
    ps = [p for r in run.records for p in r.get("p", ())]
    return sum(ps) / len(ps) if ps else None
