"""Building the CUDA kernels (``ops/_build.py``) without a GPU: the
builds a plan starts as it is constructed (``start``) are the ones its
matvec loads (``executor/plan.py::cuda_kernels``), a started build is
waited for by ``build`` and finished at exit, and nothing starts without
a CUDA toolkit.  A stand-in ``nvcc`` writes the library file, in a
temporary build directory."""

import os

import numpy as np
import pytest

import fmm_bem_tpu_torch as T
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere
from fmm_bem_tpu_torch.executor.plan import cuda_kernels
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu_torch.kernels.stokes import StokesKernel
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel
from fmm_bem_tpu_torch.ops import _build

KERNELS = {
    "laplace_bem": LaplaceBEMKernel,
    "yukawa_bem": YukawaBEMKernel,
    "stokes_bem": StokesBEMKernel,
    "laplace_points": LaplaceKernel,
    "stokes_points": StokesKernel,
}


@pytest.mark.parametrize("kernel, config, dual, want", [
    ("laplace_bem", {}, False, ["m2p_tile", "near_panel"]),
    ("laplace_bem", {"near_mode": "otf"}, False, ["m2p_tile", "otf_tile"]),
    ("laplace_bem", {"near_panel": False}, False, ["m2p_tile"]),
    ("laplace_bem", {"local_evaluation": True}, False, ["near_panel"]),
    ("laplace_bem", {"block_diagonal": True}, False, ["near_panel"]),
    ("laplace_bem", {}, True, ["m2p_tile", "near_panel"]),
    ("yukawa_bem", {}, False, ["m2p_cart_tile", "l2p_cart_tile",
                               "near_panel"]),
    ("yukawa_bem", {"near_mode": "otf"}, False,
     ["m2p_cart_tile", "l2p_cart_tile", "near_panel"]),
    ("stokes_bem", {}, False, ["panel_contract"]),
    ("laplace_points", {}, False, ["p2p_tile"]),
    ("laplace_points", {}, True, []),
    ("stokes_points", {}, False, []),
])
def test_cuda_kernels_of_a_plan(kernel, config, dual, want):
    """The kernels a plan's matvec loads, as its kernel and
    configuration choose them."""
    assert cuda_kernels(KERNELS[kernel](), T.FMMConfig(**config),
                        dual) == want
    assert all(os.path.exists(_build.source_path(n)) for n in want)


@pytest.mark.parametrize("near_mode", ["cached", "otf"])
def test_cuda_kernels_agree_with_the_plan(near_mode):
    """On a Laplace BEM plan with level-skewed pairs the chosen near
    kernel is the plan's own near route, and M2P runs the kernel."""
    small = unit_sphere(3) * 0.02 + np.array([1.3, 0.0, 0.0])
    cfg = T.FMMConfig(ncrit=8, dtype="float64", max_p=4,
                      near_mode=near_mode)
    plan = T.FmmPlan(LaplaceBEMKernel(K=3),
                     make_panels(np.concatenate([unit_sphere(2), small]),
                                 K=3),
                     cfg, device="cpu")
    names = cuda_kernels(plan.kernel, cfg, plan.dual)
    assert ("m2p_tile" in names) == (plan._m2p_rows is not None)
    assert ("otf_tile" in names) == plan._otf_near
    assert ("near_panel" in names) == (plan._use_panels
                                       and not plan._otf_near)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A temporary build directory and a stand-in ``nvcc`` that writes
    the name of its source into the ``-o`` file."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ \"$1\" != \"-o\" ]; do shift; done\n"
        "echo \"$3\" > \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_PENDING", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return tmp_path / "build"


def test_started_builds_are_waited_for(build_dir):
    """``start`` runs one process a missing library and returns; a
    second ``start`` starts nothing more; ``build`` waits for the one it
    asks for; ``_finish`` completes the rest, leaving no temporary
    file."""
    _build.start(["m2p_tile", "p2p_tile"])
    assert set(_build._PENDING) == {"m2p_tile", "p2p_tile"}
    procs = dict(_build._PENDING)
    _build.start(["m2p_tile"])
    assert _build._PENDING == procs
    paths = _build.build(["m2p_tile"])
    with open(paths["m2p_tile"]) as f:
        assert f.read().strip() == _build.source_path("m2p_tile")
    assert set(_build._PENDING) == {"p2p_tile"}
    _build._finish()
    assert not _build._PENDING
    assert sorted(os.listdir(build_dir)) == sorted(
        os.path.basename(_build.library_path(n))
        for n in ("m2p_tile", "p2p_tile"))
    _build.start(["m2p_tile", "p2p_tile"])  # built: nothing starts
    assert not _build._PENDING


def test_nothing_starts_without_a_toolkit(build_dir, monkeypatch):
    """Without ``nvcc`` a plan's ``start`` is silent and ``build``
    raises."""
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", missing)
    _build.start(["near_panel"])
    assert not _build._PENDING
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["near_panel"])
