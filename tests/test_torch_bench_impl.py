"""The port's bench record (``fmm_bem_tpu_torch/utils/bench_impl.py``)
on the CPU: its keys against the JAX record's, its solves against the JAX
package's device solver at f64 (iterations and order schedules), and no
fall-back to the CPU when a card is asked for.  Times are not held: a CPU
run gives none of the card's."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JBem
from fmm_bem_tpu.solver.gmres import gmres_device as j_gmres_device
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TBem
from fmm_bem_tpu_torch.utils import bench_impl

#: the keys of the JAX record (``fmm_bem_tpu/utils/bench_impl.py:160-179``)
JAX_KEYS = {
    "backend", "n_panels", "p", "matvec_s", "matvec_dispatched_s", "build_s",
    "compile_s", "solve_s", "solve_iters", "solve_converged", "solution_err",
    "near_equiv_err", "solve_first_kind_relaxed", "stage_s", "phases",
    "phases_p10", "value",
}
#: the bench plan's configuration (``fmm_bem_tpu/utils/bench_impl.py:75``)
CONFIG = dict(ncrit=64, max_p=10, leaf_pad=64)


def test_cpu_record_has_the_jax_keys():
    rec = bench_impl.run("cpu", recursions=3)
    assert set(rec) == JAX_KEYS | {"device"}
    assert rec["backend"] == "cpu" and rec["device"] == "cpu"
    assert rec["near_equiv_err"] is None
    assert rec["n_panels"] == 128 and rec["p"] == 5
    assert rec["solve_converged"] and rec["solve_first_kind_relaxed"][
        "converged"]
    assert rec["value"] == pytest.approx(128.0**2 / rec["matvec_s"])
    for key in ("phases", "phases_p10"):
        assert rec[key]["total"]["device"] == "cpu"
        assert "near" in rec[key]
    assert set(rec["solve_first_kind_relaxed"]) == {
        "solve_s", "iters", "converged", "residual", "err", "p_schedule"}


def test_solves_match_the_jax_device_solver():
    """At f64 the record's second-kind iterations, and its first-kind
    iterations and order schedule, are those of the JAX ``gmres_device``
    with the same ``SolverConfig`` on the JAX f64 plan (the JAX f32 plan
    computes in f64 on the CPU, so f64 is the comparable precision)."""
    fields = make_panels(unit_sphere(3), K=3)
    n = len(fields["xyz"])
    tp = T.FmmPlan(TBem(K=3), fields, T.FMMConfig(dtype="float64", **CONFIG),
                   device="cpu")
    rec = bench_impl.measure(tp, 0.0)

    jp = J.FmmPlan(JBem(K=3), fields, J.FMMConfig(dtype="float64", **CONFIG))
    ones = np.ones(n)
    mvf, op4pf, to_sf = jp.solver_ops_slots(flipped=True)[:3]
    b = np.asarray(jp.apply(ones, p=5)[:, 0])
    _, info = j_gmres_device(
        mvf, to_sf(b), operand_for_p=op4pf, p_fixed=5,
        config=J.SolverConfig(residual=1e-5, max_p=5, max_iters=60,
                              restart=60))
    mv, op4p, to_s = jp.solver_ops_slots()[:3]
    bfk = np.asarray(jp.apply_flipped_bc(ones, p=10)[:, 0])
    _, infof = j_gmres_device(
        mv, to_s(bfk), operand_for_p=op4p,
        config=J.SolverConfig(residual=1e-5, max_iters=100, restart=100,
                              max_p=10, p_min=1, p_tiers=(3, 5, 10)))

    assert rec["solve_converged"] and info.converged
    assert rec["solve_iters"] == info.iterations
    fk = rec["solve_first_kind_relaxed"]
    assert fk["converged"] and infof.converged
    assert fk["iters"] == infof.iterations
    assert fk["p_schedule"] == [int(h[2]) for h in infof.history]


def test_a_card_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_impl.run("cuda", recursions=2)
