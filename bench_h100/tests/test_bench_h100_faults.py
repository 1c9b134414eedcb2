"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a run (``harness.run``) at the rehearsal
sizes on the CPU, skipping only the look for a card, with one fault
planted in the program where it produces its answer:

- the state returned unchanged (a solve that returns its start, zeros;
  an apply that returns zeros);
- half of the batch left out (an apply whose result drops the second
  half of the points);
- the answers altered where they are produced (each solution, each
  apply's potential and field, scaled by 1 + 1e-2).

Every cell runs on one card, so there is no exchange between cards to
leave out.  The sound run of each cell comes out correct.
"""

import argparse
import time

import pytest

from bench_h100 import harness
from bench_h100.faults import FAULTS, planted

SOLVE_CELLS = ["laplace_sphere_131k.relaxed_pc",
               "laplace_sphere_131k.second_kind_pc"]
APPLY_CELL = "points_cube_1m.apply"


def _run(cell, seconds=0.6):
    args = argparse.Namespace(workload=cell, seed=2**31 + 99,
                              seconds=seconds, trace=0, rehearse=True)
    result, _ = harness.run(args, time.perf_counter())
    return result


@pytest.mark.parametrize("cell", SOLVE_CELLS)
def test_sound_solve_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("cell", SOLVE_CELLS)
@pytest.mark.parametrize("fault", FAULTS["solve"])
def test_broken_solve_run_is_not_correct(cell, fault):
    with planted(fault, "solve"):
        r = _run(cell)
    assert not r["correct"], r["checks"]


def test_sound_apply_run_is_correct():
    r = _run(APPLY_CELL, seconds=1.5)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS["apply"])
def test_broken_apply_run_is_not_correct(fault):
    with planted(fault, "apply"):
        r = _run(APPLY_CELL, seconds=1.5)
    assert not r["correct"], r["checks"]
