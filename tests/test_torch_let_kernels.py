"""The port's LET-distributed matvec (``parallel/let.py``) where the far
field reads the fields of a BC variant, against the JAX package's
``LetPlan`` and the port's own single plan, on the CPU at f64, at 4
ranks: the Yukawa BEM kernel (no L2P table: the kernel's own ``l2p`` on
each rank's fields), the Stokes BEM kernel (3-vector charges: the
two-stage near route; no L2P table) and the Laplace BEM kernel on a
tree with level-skewed M2P pairs, each in both BC variants.  Tolerance
1e-12 of the largest result.  The flipped variants are held to the JAX
plan: the JAX LET is off it there (ROADMAP.md C)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JBem
from fmm_bem_tpu.kernels.stokes_bem import StokesBEMKernel as JStokes
from fmm_bem_tpu.kernels.yukawa_bem import YukawaBEMKernel as JYukawa
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TBem
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel as TStokes
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel as TYukawa

from _let_pairs import Pair, hold_apply

MU = 1e-3


@pytest.fixture(scope="module")
def pairs():
    return {
        "yukawa": Pair(JYukawa(K=3, kappa=0.5), TYukawa(K=3, kappa=0.5),
                       make_panels(unit_sphere(4), K=3), 8, 3),
        # the far-field Stokes problem of tests/test_torch_stokes.py
        "stokes": Pair(JStokes(K=4, mu=MU), TStokes(K=4, mu=MU),
                       make_panels(unit_sphere(4), K=4), 5, 41, cdim=3,
                       max_p=6),
        # small leaves: 264 level-skewed pairs take the M2P path
        "laplace_m2p": Pair(JBem(K=3), TBem(K=3),
                            make_panels(unit_sphere(5), K=3), 6, 3,
                            ncrit=8, max_p=6),
    }


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("name", ["yukawa", "stokes", "laplace_m2p"])
def test_apply_matches_the_jax_let_and_the_plan(pairs, name, flipped,
                                                monkeypatch):
    pair = pairs[name]
    if name == "stokes":
        # the reference's sign of the far field at traction targets
        # (ROADMAP.md C), put in to hold the port to it
        monkeypatch.setattr(pair.tp.kernel, "traction_far_scale", 0.5)
        assert len(pair.tp.lists.m2l_pairs) > 0
    if name == "laplace_m2p":
        assert len(pair.tp.m2p_src) > 0
    else:
        assert not callable(getattr(pair.tp.kernel, "l2p_table", None))
    hold_apply(pair, 4, flipped, jax_let_off=flipped)
