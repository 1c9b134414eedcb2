"""The port's LET-distributed matvec (``parallel/let.py``) on point
kernels, against the JAX package's ``LetPlan`` and the port's own single
plan, on the CPU at f64: point Laplace at 2 and 8 ranks and on the
two-level layout (2, 4) (the point cases of ``tests/test_parallel.py``:
the near field through the kernel's ``p2p_block`` over chunks of
pairs), and the Laplace treecode at 4 ranks (M2P pairs).  Tolerance
1e-12 of the largest result."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fmm_bem_tpu.config import Evaluator as JEvaluator
from fmm_bem_tpu.kernels.laplace import LaplaceKernel as JLaplace
from fmm_bem_tpu_torch.config import Evaluator
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace

from _let_pairs import Pair, hold_apply


@pytest.fixture(scope="module")
def pairs():
    pts = np.random.default_rng(0).uniform(0, 1, (1536, 3))
    tree_pts = np.random.default_rng(4).uniform(0, 1, (1536, 3))
    return {
        "points": Pair(JLaplace(), TLaplace(), {"xyz": pts}, 6, 0),
        "treecode": Pair(JLaplace(), TLaplace(), {"xyz": tree_pts}, 6, 5,
                         evaluator={"jax": JEvaluator.TREECODE,
                                    "port": Evaluator.TREECODE}),
    }


CASES = [
    ("points", 2), ("points", 8), ("points", (2, 4)), ("treecode", 4),
]


@pytest.mark.parametrize("name,layout", CASES, ids=str)
def test_apply_matches_the_jax_let_and_the_plan(pairs, name, layout):
    pair = pairs[name]
    if name == "treecode":
        assert len(pair.tp.m2p_src) > 0
    hold_apply(pair, layout, False)
