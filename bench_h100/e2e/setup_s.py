"""Seconds from the start of the process to the first timed operation:
imports, plan build, inputs, kernel builds and the warm-up."""


def read(run):
    return run.setup_s
