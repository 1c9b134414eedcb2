"""``p2p_tile.cu``'s share of its roofline (%): the needed evaluations,
counted from the plan's pair list and leaf counts, at 18 flops each
over the f32 peak, against the mean device time of a launch in the
trace."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    times = run.trace.kernel_times("p2p_tile_kernel")
    if not times:
        return None
    return 100.0 * run.op.p2p_bound_s(run.peaks) / (sum(times) / len(times))
