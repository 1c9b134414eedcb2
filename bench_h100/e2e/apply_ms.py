"""Milliseconds per apply: the window over the applies it completed,
each synchronised on the device."""


def read(run):
    return 1e3 * run.window_s / len(run.records)
