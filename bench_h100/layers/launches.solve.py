"""Device kernel launches per solve (its right-hand side included), from
the trace of the traced solves."""


def read(run):
    if run.trace is None or not run.trace.span_count("solve"):
        return None
    n = run.trace.kernel_launches()
    return n / run.trace.span_count("solve") if n else None
