"""Milliseconds per slot-space matvec at p=5, the solver's operator,
timed after the window: CUDA events around a chain of calls."""

P = 5


def read(run):
    chain = getattr(run.op, "chain_ms", None)
    if chain is None or run.op.device.type != "cuda":
        return None
    return chain(P)
