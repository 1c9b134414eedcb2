"""``otf_tile.cu``'s share of its roofline (%): the least time of the
traced calls over their device time.  A call is one ``otf_tile_kernel``
launch; its least time is ``otf_work.bound_s`` of the work its BC
variant needs (``otf_work.needed_work``: counted from the plan's pair
list, leaf masks, BC flags and quadrature order).  Each traced
right-hand side (a benchmark ``rhs`` span) makes one call of the
flipped variant, every other call is of the plan's own flags: the
reading is the sum of the calls' bounds over the sum of their times,
the mean bound over the mean time."""

from bench_h100 import otf_work


def read(run):
    if run.trace is None or run.peaks is None or run.op.plan is None:
        return None
    times = run.trace.kernel_times("otf_tile_kernel")
    if not times:
        return None
    plan = run.op.plan
    n_flip = min(run.trace.span_count("rhs"), len(times))
    bound = (n_flip * otf_work.bound_s(otf_work.needed_work(plan, True),
                                       run.peaks, plan.config.dtype)
             + (len(times) - n_flip) * otf_work.bound_s(
                 otf_work.needed_work(plan), run.peaks, plan.config.dtype))
    return 100.0 * bound / sum(times)
