"""The point programs of the PyTorch port
(``fmm_bem_tpu_torch/examples/{serialrun,scaling}.py``) against the JAX
package's (``examples/*.py``): both run in-process on the CPU with the
same flags.

- ``serialrun`` for all seven kernels and with ``-treecode``, at f64:
  the printed errors against direct summation to 1e-9 relative (the
  unit kernel's, exact, both below 1e-13).
- ``scaling``: the printed force error, an f32 program in both
  packages, to 2e-2 relative (the two round differently); the
  ``-ncrit_search`` sweep prints one row per ncrit 50..400 and returns
  each ncrit's force error (not printed, as the reference prints times
  only) and plan."""

import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fmm_bem_tpu_torch.examples import scaling as t_scaling
from fmm_bem_tpu_torch.examples import serialrun as t_serialrun

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_jax_program(name, argv, monkeypatch):
    """``examples/<name>.py``'s ``main`` in this process: it reads
    ``sys.argv``."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()


SERIALRUN_ERRORS = {
    "potential": r"potential rel\. L2 error: (\S+)",
    "force": r"force\s+rel\. L2 error: (\S+)",
    "all": r"^rel\. L2 error: (\S+)",
}


def serialrun_errors(text):
    return {
        key: float(m.group(1))
        for key, pat in SERIALRUN_ERRORS.items()
        if (m := re.search(pat, text, re.M))
    }


SERIALRUN_CASES = {
    **{k: ["-kernel", k] for k in t_serialrun.KERNELS},
    "laplace_treecode": ["-kernel", "laplace", "-treecode"],
}


@pytest.mark.parametrize("case", sorted(SERIALRUN_CASES))
def test_serialrun_twin(case, capsys, monkeypatch):
    argv = ["-N", "1000", "-p", "6", "-ncrit", "32", "-nsamples", "200",
            "-cpu", *SERIALRUN_CASES[case]]
    run_jax_program("serialrun", argv, monkeypatch)
    want = serialrun_errors(capsys.readouterr().out)
    res = t_serialrun.main(argv)
    got = serialrun_errors(capsys.readouterr().out)
    assert sorted(got) == sorted(want) and got, (got, want)
    for key in want:
        if case == "unit":
            assert got[key] < 1e-13 and want[key] < 1e-13
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-9), (
                key, got, want)
    assert res["plan"].device.type == "cpu"
    assert res["plan"].config.evaluator.value == (
        "treecode" if "treecode" in case else "fmm")


def test_scaling_twin(capsys, monkeypatch):
    argv = ["-N", "2000", "-cpu"]
    run_jax_program("scaling", argv, monkeypatch)
    want = capsys.readouterr().out
    res = t_scaling.main(argv)
    got = capsys.readouterr().out
    pat = r"force error : (\S+)"
    fw, fg = (float(re.search(pat, t).group(1)) for t in (want, got))
    assert fg == pytest.approx(fw, rel=2e-2)
    assert res["force_err"] == pytest.approx(fg, rel=1e-3)
    assert res["fmm_s"] > 0 and res["direct_s"] > 0


def test_scaling_ncrit_search(capsys):
    res = t_scaling.main(["-N", "1500", "-p", "4", "-cpu", "-ncrit_search"])
    rows = re.findall(r"^\s*(\d+)\s+(\S+)\s+(\S+)$",
                      capsys.readouterr().out, re.M)
    assert [int(r[0]) for r in rows] == list(range(50, 401, 50))
    assert [n for n, _ in res["sweep"]] == list(range(50, 401, 50))
    assert all(dt > 0 for _, dt in res["sweep"])
    assert [plan.config.ncrit for plan in res["plans"]] == [
        n for n, _ in res["sweep"]]
    # each ncrit's force error, against the scaling run's own check
    one = t_scaling.main(["-N", "1500", "-p", "4", "-cpu", "-ncrit", "100"])
    assert res["force_errs"][1] == pytest.approx(one["force_err"], rel=1e-6)
    assert all(0 < e < 1e-2 for e in res["force_errs"])
