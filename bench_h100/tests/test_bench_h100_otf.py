"""The cell ``laplace_sphere_524k_otf.relaxed_pc`` on the CPU at its
rehearsal size (512 panels):

- ``run.py --rehearse --trace 1`` prints a correct line that carries
  ``otf_calls.solve`` (the ``near.otf`` spans, one a near product: the
  matvecs of the traced solves and their right-hand sides) and leaves
  out the three device metrics, which only a card gives;
- ``otf_tile_roofline`` reads the bound of each traced call's BC
  variant (``otf_work``) against a trace made up here.
"""

import json
import os
import subprocess
import sys
import types

import pytest

from bench_h100 import harness, otf_work, spans, yardstick

CELL = "laplace_sphere_524k_otf.relaxed_pc"
DEVICE_ONLY = ("otf_tile_roofline", "otf_ms.solve", "near_corr_ms.solve")


def test_rehearsal_line_carries_the_otf_metrics():
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", CELL, "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "1", "--rehearse"],
        cwd=harness.ROOT, check=True, capture_output=True, text=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    m = line["metrics"]
    # one near product a matvec; a traced solve runs its iterations,
    # its true residuals and its right-hand side's matvec
    calls = m["otf_calls.solve"]["value"]
    assert calls >= m["gmres_iters.solve"]["value"] + 2
    assert calls == m["host_syncs.solve"]["value"] - 1
    for name in DEVICE_ONLY:
        assert name not in m, name


@pytest.fixture(scope="module")
def rehearsal_op():
    _, _, config, traffic, _ = harness.resolve_cell(CELL, rehearse=True)
    return harness.load_operation("solve")(config, traffic, 11, "cpu")


def test_roofline_reads_each_variants_bound(rehearsal_op):
    """Three ``otf_tile_kernel`` launches under one ``rhs`` span: one
    call of the flipped variant (the double layer), two of the plan's
    own (the single layer)."""
    plan = rehearsal_op.plan
    peaks = yardstick.CHIP_PEAKS["NVIDIA H100 80GB HBM3"]
    ms = 1_000_000
    ops = [(f"void otf_tile_kernel<float, 3, false>", k * ms,
            k * ms + t, True) for k, t in enumerate((400_000, 300_000,
                                                      300_000))]
    trace = yardstick.Trace(ops, [("rhs", 0, ms), ("solve", ms, 3 * ms)])
    run = types.SimpleNamespace(op=rehearsal_op, trace=trace, peaks=peaks)
    read = harness.load_reader("layers", "otf_tile_roofline")
    b_flip = otf_work.bound_s(otf_work.needed_work(plan, True), peaks)
    b_own = otf_work.bound_s(otf_work.needed_work(plan), peaks)
    assert b_flip > b_own > 0  # the double layer's 18 flops bind it
    want = 100.0 * (b_flip + 2 * b_own) / 1.0e-3
    assert read(run) == pytest.approx(want, rel=1e-12)
    run.trace = yardstick.Trace([], trace.spans)
    assert read(run) is None
    run.trace, run.peaks = trace, None
    assert read(run) is None


def test_device_readers_read_none_without_spans(rehearsal_op):
    """Without the program's spans (an older program, or a trace with
    none of them) the span readers give None, not an error."""
    run = types.SimpleNamespace(op=rehearsal_op, peaks=None,
                                trace=yardstick.Trace([], []))
    for name in ("otf_ms.solve", "near_corr_ms.solve", "otf_calls.solve"):
        assert harness.load_reader("layers", name)(run) is None
    assert spans.of_run(run) is None
