"""``near_panel.cu``'s share of its roofline (%): the least time of one
call on the cached store (``yardstick.near_panel_bound_s``: needed
bytes in 32-byte sectors at the memory rate) over the mean device time
of a call in the trace.  A call is one ``near_tiles_kernel`` launch and
its ``near_fixup_kernel`` launch."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    tiles = run.trace.kernel_times("near_tiles_kernel")
    if not tiles:
        return None
    fix = run.trace.kernel_times("near_fixup_kernel")
    bound = run.op.near_panel_bound_s(run.peaks)
    if bound is None:
        return None
    return 100.0 * bound / ((sum(tiles) + sum(fix)) / len(tiles))
