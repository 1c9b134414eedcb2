"""Device kernel launches per apply, from the trace of the traced
applies."""


def read(run):
    if run.trace is None or not run.trace.span_count("apply"):
        return None
    n = run.trace.kernel_launches()
    return n / run.trace.span_count("apply") if n else None
