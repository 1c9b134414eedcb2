"""The example programs of the PyTorch port
(``fmm_bem_tpu_torch/examples/``) against the JAX package's
(``examples/*.py``): both run in-process on the CPU with the same flags.

- The three BEM programs at f64: the errors each prints are compared to
  1e-9 relative (the same host GMRES loop on the same operators; sums in
  another order).  The Stokes programs are compared with the
  reference's traction sign put into the port (ROADMAP.md C); its
  -fmgmres path is held to the JAX package in tests/test_torch_fmgmres.py.
- The point programs ``serialrun`` and ``scaling``: in
  tests/test_torch_point_programs.py.
- ``kernels/skeleton.py``: the same members as the JAX skeleton."""

import importlib.util
import inspect
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.examples import laplace_bem as t_laplace
from fmm_bem_tpu_torch.examples import stokes_bem as t_stokes
from fmm_bem_tpu_torch.examples import yukawa_bem as t_yukawa
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the numbers each program prints, by the text before them
PRINTED = {
    "laplace_bem": {"relative error": r"relative error: (\S+)",
                    "external": r"external phi: .*error: (\S+)"},
    "stokes_bem": {"rhs": r"rhs error: (\S+)",
                   "drag": r"error on a sphere: (\S+)"},
    "yukawa_bem": {"mean": r"solution mean dphi/dn: (\S+)",
                   "analytic": r"rel\. error: (\S+)"},
}


def run_jax_program(name, argv, monkeypatch):
    """``examples/<name>.py``'s ``main`` in this process: it reads
    ``sys.argv``."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()


def printed(name, text):
    out = {}
    for key, pat in PRINTED[name].items():
        m = re.search(pat, text)
        assert m, (name, key, text[-2000:])
        out[key] = float(m.group(1).rstrip(","))
    return out


CASES = {
    "laplace_bem": (t_laplace, ["-recursions", "3", "-cpu"]),
    "laplace_bem_fgmres_second_kind": (
        t_laplace, ["-recursions", "3", "-cpu", "-fgmres", "-second_kind",
                    "-pc", "identity"]),
    "stokes_bem": (t_stokes, ["-recursions", "3", "-cpu"]),
    "yukawa_bem": (t_yukawa, ["-recursions", "3", "-cpu"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_prints_the_jax_programs_errors(case, capsys, monkeypatch):
    mod, argv = CASES[case]
    name = mod.__name__.rsplit(".", 1)[1]
    if name == "stokes_bem":
        monkeypatch.setattr(StokesBEMKernel, "traction_far_scale", 0.5)
    run_jax_program(name, argv, monkeypatch)
    want_text = capsys.readouterr().out
    res = mod.main(argv)
    got_text = capsys.readouterr().out
    want, got = printed(name, want_text), printed(name, got_text)
    for key in want:
        assert np.isfinite(got[key]), key
        assert got[key] == pytest.approx(want[key], rel=1e-9), (key, got,
                                                                want)
    assert "[host]" in want_text and "[host]" in got_text
    # the same steps at the same orders; the residuals to 1e-12 (of
    # ||b||: the last ones lie at the rounding floor)
    steps = re.compile(r"it:\s+(\d+)\s+res: (\S+)\s+fmm_req_p: (\d+)")
    sw, sg = steps.findall(want_text), steps.findall(got_text)
    assert [(i, p) for i, _, p in sg] == [(i, p) for i, _, p in sw]
    assert all(abs(float(a) - float(b)) <= 1e-12 + 1e-3 * abs(float(b))
               for (_, a, _), (_, b, _) in zip(sg, sw))
    assert res["iterations"] == len(sg) > 0


def test_skeleton_members_are_the_jax_skeletons():
    from fmm_bem_tpu.kernels.skeleton import SkeletonKernel as JSkel
    from fmm_bem_tpu_torch.kernels.skeleton import SkeletonKernel as TSkel

    def members(cls):
        return {k: v for k, v in vars(cls).items() if not k.startswith("__")}

    jm, tm = members(JSkel), members(TSkel)
    assert sorted(jm) == sorted(tm)
    for k, v in jm.items():
        if callable(v):
            assert inspect.signature(v) == inspect.signature(tm[k]), k
        else:
            assert tm[k] == v, k
    # the template satisfies the protocol and runs as a (zero) operator
    pts = np.random.default_rng(0).uniform(0, 1, (300, 3))
    plan = T.FmmPlan(TSkel(), {"xyz": pts},
                     T.FMMConfig(ncrit=16, dtype="float64", max_p=3),
                     device="cpu")
    assert float(plan.apply(np.ones(300), p=3).abs().max()) == 0.0
