"""Device milliseconds per solve (its right-hand side included) under
the program's ``near.corr`` spans (the on-the-fly near field's product
with the cached correction deltas: gathers, window sums, the add into
the kernel's result): the union of the intervals of the device
operations that went to them (``bench_h100/spans.py``).  None where the
program opens no such span."""

from bench_h100 import spans


def read(run):
    return spans.busy_ms(run, "near.corr", "solve")
