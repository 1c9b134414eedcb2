"""The on-the-fly near mode (``FMMConfig.near_mode="otf"``) against the
benchmark's plain float64 reference, on the CPU at 512 panels
(``bench_h100/inputs.py::unit_sphere(4)``), f64 unless said:

- the OTF plan's matvec at p=10, in both BC variants, against the rows
  of ``bench_h100/reference/laplace_bem.py::SurfaceRows``, to the error
  the cached plan makes on the same rows (the p=10 truncation);
- the cell ``laplace_sphere_524k_otf.relaxed_pc`` at its rehearsal size:
  its checks inside the cell's limits, and the cached plan's iterations
  and orders;
- ``bench_h100/otf_work.py``'s count of the work of one ``otf_tile``
  call against the evaluations the kernel's count tables walk.

The file imports no JAX.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu_torch as T
from bench_h100 import harness, inputs, otf_work
from bench_h100.operations import SolveOperation
from bench_h100.reference.laplace_bem import SurfaceRows
from fmm_bem_tpu_torch.bem.panels import make_panels
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel

CELL = "laplace_sphere_524k_otf.relaxed_pc"


def cell_files(near_mode):
    """(configuration at f64 with ``near_mode``, traffic, limits) of the
    cell at its rehearsal size."""
    _, _, config, traffic, limits = harness.resolve_cell(CELL, rehearse=True)
    config = harness.deep_merge(
        config, {"fmm": {"dtype": "float64", "near_mode": near_mode}})
    return config, traffic, limits


@pytest.fixture(scope="module")
def sphere512():
    """The cell's surface at 512 panels and its plans, cached and on the
    fly, at the cell's ``FMMConfig`` in f64; the reference's rows of
    every panel."""
    config, traffic, _ = cell_files("otf")
    assert config["geometry"]["recursions"] == 4
    tris = inputs.unit_sphere(4)
    fields = make_panels(tris, K=config["kernel"]["args"]["K"])
    plans = {}
    for mode in ("cached", "otf"):
        cfg = T.FMMConfig(**{**config["fmm"], "near_mode": mode})
        plans[mode] = T.FmmPlan(LaplaceBEMKernel(**config["kernel"]["args"]),
                                fields, cfg, device="cpu")
    assert plans["otf"]._otf_near and not plans["cached"]._otf_near
    rows = SurfaceRows(tris, np.arange(len(tris)), "cpu",
                       **config["kernel"]["args"])
    return tris, plans, rows


def rel(got, want):
    want = torch.as_tensor(want)
    got = torch.as_tensor(np.asarray(got)).reshape(want.shape)
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("flipped", [False, True], ids=["G", "dG"])
def test_otf_matvec_matches_the_reference_rows(sphere512, flipped):
    """``apply`` (every flag 0: the single layer ``G``) and
    ``apply_flipped_bc`` (the double layer ``dG``) at p=10 on seeded
    random charges.  The reference sums every far panel directly, the
    plans by expansions of order 10: both plans carry that truncation,
    measured here on the cached plan.  The OTF plan recomputes the
    same regular quadrature the cached store holds, so it must come as
    close as the cached plan, to rounding (1e-12 between the two), and
    the truncation itself must stay small (1e-4)."""
    tris, plans, rows = sphere512
    q = np.random.default_rng(20).standard_normal(len(tris))
    want = rows.apply("dG" if flipped else "G", q)
    out = {}
    for mode, plan in plans.items():
        apply = plan.apply_flipped_bc if flipped else plan.apply
        out[mode] = apply(q, p=10)[:, 0]
    trunc = rel(out["cached"], want)
    assert 0 < trunc < 1e-4
    assert rel(out["otf"], out["cached"].numpy()) <= 1e-12
    assert rel(out["otf"], want) <= trunc + 1e-12


def test_cell_relaxed_solve_within_its_limits(sphere512):
    """The cell's traffic (the rehearsal's pool of point charges, tiers
    (3, 5, 10), right-hand side at p=10) through ``SolveOperation`` on
    the OTF plan: every solve converges, the checks against the
    reference lie inside the cell's limits, and each solve takes the
    iterations and the orders of the same solve on the cached plan."""
    _, plans, _ = sphere512
    config, traffic, limits = cell_files("otf")
    records, checks = {}, None
    for mode, plan in plans.items():
        op = SolveOperation(config, traffic, 2**31 + 77, "cpu", plan=plan)
        op.warm_up()
        records[mode] = [op.run_one(i) for i in range(len(op.pool))]
        if mode == "otf":
            checks = op.check(records[mode], torch.device("cpu"),
                              traffic["check"])
    correct, judged = harness.judge(checks, limits)
    assert correct, judged
    assert checks["unconverged"] == 0
    for a, b in zip(records["otf"], records["cached"]):
        assert a["iters"] == b["iters"] and a["p"] == b["p"]
    assert any(len(set(r["p"])) > 1 for r in records["otf"])  # relaxed


def walked_from_count_tables(plan, flipped):
    """(evaluations, those of G targets) that the count tables
    ``otf_tile`` reads walk: per near leaf pair the real target slots
    times the real source slots times KQ, the targets split by the BC
    row of the variant's target table."""
    fields = plan._flipped_pair()[1] if flipped else plan.tgt.fields
    ot = plan._otf_tiles(fields)
    counts = (ot["row_ptr"][1:] - ot["row_ptr"][:-1]).long()
    nl_t = counts.shape[0]
    tslot = torch.repeat_interleave(torch.arange(nl_t), counts)
    sslot = ot["sslot"].long()
    KQ = plan._otf_KQ
    src = ot["src_cnt"][sslot].long()
    walked = KQ * int((ot["tgt_cnt"][tslot].long() * src).sum())
    K = ot["sb_tgt"].shape[2]
    real = torch.arange(K)[None, :] < ot["tgt_cnt"][:nl_t, None]
    n_g = (real & (ot["sb_tgt"][:nl_t, 3] == 0)).sum(dim=1)
    walked_g = KQ * int((n_g[tslot].long() * src).sum())
    return walked, walked_g


@pytest.mark.parametrize("flipped", [False, True], ids=["own", "flipped"])
@pytest.mark.parametrize("bc", ["potential", "mixed"])
def test_otf_work_is_what_the_count_tables_walk(sphere512, bc, flipped):
    """``otf_work.needed_work`` counts from the plan's pair list, leaf
    masks and BC flags; the kernel walks the count tables.  The two
    agree on the evaluations, and on the G / dG split by the target
    table's BC row, for the plan's flags and for every flag flipped,
    on the cell's plan (every flag 0) and on one of mixed flags."""
    tris, plans, _ = sphere512
    plan = plans["otf"]
    if bc == "mixed":
        fields = make_panels(tris, K=3)
        fields["bc"] = (np.random.default_rng(5).random(len(tris))
                        < 0.3).astype(np.float64)
        plan = T.FmmPlan(LaplaceBEMKernel(K=3), fields, plan.config,
                         device="cpu")
    work = otf_work.needed_work(plan, flipped)
    walked, walked_g = walked_from_count_tables(plan, flipped)
    KQ = plan._otf_KQ
    assert work["evaluations"] == walked > 0
    assert KQ * work["pairs_g"] == walked_g
    assert KQ * work["pairs_dg"] == walked - walked_g
    flags = np.asarray(plan.tgt.fields["bc"])
    if bc == "potential":
        # the single layer on its own flags, the double layer flipped
        assert (work["pairs_g"] if flipped else work["pairs_dg"]) == 0
    else:
        assert 0 < flags.mean() < 1
        assert work["pairs_g"] > 0 and work["pairs_dg"] > 0
    f_g, f_dg = otf_work.OTF_FLOPS
    assert work["flops"] == (KQ * (f_g * work["pairs_g"]
                                   + f_dg * work["pairs_dg"])
                             + 2 * (work["pairs_g"] + work["pairs_dg"]))
    assert work["sfu"] == work["evaluations"]


def test_otf_work_refuses_a_screened_kernel():
    """``otf_work`` counts the Laplace evaluations only: a plan whose
    kernel screens (kappa > 0) is refused, not counted at Laplace's
    flops."""
    import types

    plan = types.SimpleNamespace(kernel=types.SimpleNamespace(kappa=0.125))
    with pytest.raises(ValueError, match="Laplace"):
        otf_work.needed_work(plan)
