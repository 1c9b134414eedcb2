"""No module that a run or its reference loads is ``jax``, ``jaxlib``,
``flax`` or the JAX package (top-level names compared whole), and the
reference loads nothing of ``fmm_bem_tpu_torch``."""

import ast
import json
import os
import subprocess
import sys

from bench_h100 import harness

FORBIDDEN = set(harness.FORBIDDEN_MODULES)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(harness.BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "fmm_bem_tpu_torch" not in set(_imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench_h100.reference.laplace_bem, "
            "bench_h100.reference.laplace_points; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out.strip().replace("'", '"')))
    assert "fmm_bem_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_a_run_loads_no_forbidden_module():
    """A rehearsal of a cell in its own process: the harness itself
    exits non-zero if a forbidden module is loaded once the window has
    closed, and prints no result."""
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", "points_cube_1m.apply", "--seed", "5",
         "--seconds", "0.5", "--trace", "0", "--rehearse"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["device"]["platform"] == "cpu"


def test_without_a_card_a_run_prints_no_result(tmp_path):
    """Without --rehearse a run on a machine without a card (or in a
    directory that holds only the benchmark) exits non-zero, silent on
    standard output."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", "points_cube_1m.apply", "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
