"""The 90th percentile of the seconds of every solve of the window."""

from bench_h100.yardstick import percentile


def read(run):
    return percentile([r["t"] for r in run.records], 90)
