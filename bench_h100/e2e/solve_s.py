"""Seconds per solve: the window over the solves it completed."""


def read(run):
    return run.window_s / len(run.records)
