"""The port's LET-distributed matvec (``parallel/let.py``) against the JAX
package's ``LetPlan`` and against the port's own single plan, on the CPU
at f64: the BEM cases of ``tests/test_parallel.py`` (the sphere at 2 and
8 ranks, its flipped variant, both two-level layouts, the two-level
flipped case; the point cases and the other kernels are in
``tests/test_torch_let_kernels.py``), the second-kind solve
through ``solver_ops`` and ``gmres_device`` at 8 ranks, and the bytes
the collectives move.  Every rank lives on the CPU.  Each JAX
``LetPlan`` is compiled once per (plan, layout, variant) and its result
shared by the cases that read it.  Tolerance 1e-12 of the largest
result: the same arithmetic, sums in another order."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JBem
from fmm_bem_tpu.parallel.let import LetPlan as JLet
from fmm_bem_tpu.solver.gmres import gmres_device as j_gmres_device
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TBem
from fmm_bem_tpu_torch.parallel.let import LetPlan
from fmm_bem_tpu_torch.solver.gmres import gmres_device

from _let_pairs import Pair, hold_apply

@pytest.fixture(scope="module")
def pairs():
    return {
        "bem_r4": Pair(JBem(K=3), TBem(K=3),
                       make_panels(unit_sphere(4), K=3), 8, 1),
        "bem_r3": Pair(JBem(K=3), TBem(K=3),
                       make_panels(unit_sphere(3), K=3), 8, 2),
    }


CASES = [
    ("bem_r4", 1, False), ("bem_r4", 2, False), ("bem_r4", 8, False),
    ("bem_r3", 8, True),
    ("bem_r4", (2, 4), False), ("bem_r4", (4, 2), False),
    ("bem_r3", (2, 4), True),
]


@pytest.mark.parametrize("name,layout,flipped", CASES, ids=str)
def test_apply_matches_the_jax_let_and_the_plan(pairs, name, layout,
                                                flipped):
    hold_apply(pairs[name], layout, flipped)


def test_second_kind_solve_matches_the_plan_and_the_jax_let(pairs):
    """The distributed second-kind BEM solve at 8 ranks: the port's
    single-plan solve's iterations and solution to 1e-9, and the JAX
    LET solve within the bars of ``tests/test_parallel.py``."""
    pair = pairs["bem_r4"]
    n = pair.n
    b = np.asarray(pair.jp.apply(np.ones(n), p=5)[:, 0])
    kw = dict(residual=1e-6, max_p=5, max_iters=40, restart=40)

    jl = JLet(pair.jp, 8, flipped=True)
    jmv, jop = jl.solver_ops()
    jx, jinfo = j_gmres_device(jmv, jl.to_padded(b), operand_for_p=jop,
                               config=J.SolverConfig(**kw), p_fixed=5)
    x_jax = jl.from_padded(np.asarray(jx)[:, None])[:, 0]

    mv, op4p = pair.tp.solver_ops(flipped=True)
    x_ref, info_ref = gmres_device(
        mv, torch.tensor(b), operand_for_p=op4p,
        config=T.SolverConfig(**kw), p_fixed=5)

    lp = LetPlan(pair.tp, 8, flipped=True)
    lmv, lop = lp.solver_ops()
    x_pad, info = gmres_device(lmv, lp.to_padded(b), operand_for_p=lop,
                               config=T.SolverConfig(**kw), p_fixed=5)
    x_let = lp.from_padded(x_pad).numpy()
    assert info.converged and info_ref.converged and jinfo.converged
    assert info.iterations == info_ref.iterations
    assert np.abs(x_let - x_ref.numpy()).max() <= 1e-9
    assert abs(info.iterations - jinfo.iterations) <= 1
    assert np.abs(x_let - x_jax).max() < 1e-5


@pytest.mark.parametrize("layout", [8, (2, 4)], ids=str)
def test_collectives_stay_below_the_rank_store(pairs, layout):
    """The counterpart of the compiled-HLO bounds of
    ``tests/test_parallel.py``: no collective of a matvec, on either
    axis, brings a rank as many bytes as its near store holds; each
    collective is logged once per matvec."""
    pair = pairs["bem_r4"]
    lp = LetPlan(pair.tp, layout)
    lp.apply(np.ones(pair.n), p=5)
    coll, desc = lp.comm.max_received()
    assert coll > 0, "expected collectives in the LET matvec"
    assert coll < lp.stats()["near_panel_bytes_per_dev"], (coll, desc)
    ops = [(op, axis) for op, axis, _ in lp.comm.log]
    if lp.ndcn > 1:
        both = ("dp", "sp")
        assert ops == [("all_gather", "sp"), ("all_gather", both),
                       ("psum", both), ("all_gather", "sp"),
                       ("all_gather", both), ("psum", both)]
        assert lp.m_exp_inter.shape[1] <= lp.m_export_rows.shape[1]
        assert lp.q_exp_inter.shape[1] <= lp.q_export_rows.shape[1]
    else:
        assert ops == [("all_gather", "sp"), ("psum", "sp"),
                       ("all_gather", "sp"), ("psum", "sp")]
