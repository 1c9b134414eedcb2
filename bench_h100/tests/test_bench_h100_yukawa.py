"""The Yukawa sphere cell, ``yukawa_sphere_131k.relaxed_pc_p8``, on the
CPU at its rehearsal size (512 panels):

- a whole run (``harness.run``) comes out correct, and a traced one
  reads the cell's program counters, ``stall_raises.solve`` among them;
- each solve fault of ``faults.py`` turns it false;
- the roofline bound of ``near_panel`` reads the Yukawa store with
  ``yardstick.near_panel_bound_s`` as it is;
- its reference imports nothing of the program and nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import time

import pytest

from bench_h100 import harness, yardstick
from bench_h100.faults import FAULTS, planted

CELL = "yukawa_sphere_131k.relaxed_pc_p8"


def _run(trace=0, seconds=0.6):
    args = argparse.Namespace(workload=CELL, seed=2**31 + 123,
                              seconds=seconds, trace=trace, rehearse=True)
    result, _ = harness.run(args, time.perf_counter())
    return result


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert {"solve_s", "setup_s"} <= set(r["metrics"])


def test_traced_run_reads_the_counters():
    r = _run(trace=1)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in ("gmres_iters.solve", "p_mean.solve", "plan_build_s",
                 "host_syncs.solve", "operand_builds.solve",
                 "stall_raises.solve"):
        assert name in m, name
    assert m["stall_raises.solve"]["value"] >= 0


@pytest.mark.parametrize("fault", FAULTS["solve"])
def test_broken_run_is_not_correct(fault):
    with planted(fault, "solve"):
        r = _run()
    assert not r["correct"], r["checks"]


def test_near_panel_bound_reads_the_yukawa_store():
    _, _, config, traffic, _ = harness.resolve_cell(CELL, rehearse=True)
    op = harness.load_operation("solve")(config, traffic, 5, "cpu")
    op.warm_up()
    bound = op.near_panel_bound_s(yardstick.CHIP_PEAKS[
        "NVIDIA H100 80GB HBM3"])
    assert bound is not None and 0 < bound < 1e-3


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench_h100.reference.yukawa_bem; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out.strip().replace("'", '"')))
    assert "fmm_bem_tpu_torch" not in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)
