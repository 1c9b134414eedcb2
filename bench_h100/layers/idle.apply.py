"""The share of the traced applies' window in which nothing ran on the
card, from the union of the trace's device intervals (%)."""


def read(run):
    if run.trace is None or not run.trace.span_count("apply"):
        return None
    w, b = run.trace.window_ns(), run.trace.busy_ns()
    return 100.0 * (1.0 - b / w) if w and b else None
