"""Device milliseconds per solve (its right-hand side included) under
the program's ``near.otf`` spans (the on-the-fly near product's
``otf_tile.cu`` launch and the pad of its charges): the union of the
intervals of the device operations that went to them
(``bench_h100/spans.py``).  None where the program opens no such span
(a program older than it, or a plan with a cached near store)."""

from bench_h100 import spans


def read(run):
    return spans.busy_ms(run, "near.otf", "solve")
