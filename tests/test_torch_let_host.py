"""The host side of the port's LET distribution (``parallel/let.py``)
against the JAX package's, on the CPU at f64: every host table array for
array at 2 and 8 ranks and on the two-level layouts (2, 4) and (4, 2),
the per-rank near stores against the JAX package's stacked ones, what
the port refuses, its communicator, and the ``scaling_multichip``
program's table.  The JAX ``LetPlan`` runs on the suite's 8 host devices
(``tests/conftest.py``).  Inputs are made with numpy from a seed and
handed to both packages."""

import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels.laplace import LaplaceKernel as JLaplace
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JBem
from fmm_bem_tpu.parallel.let import LetPlan as JLet
from fmm_bem_tpu_torch.examples import scaling_multichip as t_scaling
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TBem
from fmm_bem_tpu_torch.parallel.let import LetPlan, LocalComm

from _let_pairs import jax_layout

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUTS = [2, 8, (2, 4), (4, 2)]


def plan_pair(kind):
    cfg = dict(ncrit=32, dtype="float64", max_p=8)
    if kind == "bem":
        fields = make_panels(unit_sphere(4), K=3)
        return (J.FmmPlan(JBem(K=3), fields, J.FMMConfig(**cfg)),
                T.FmmPlan(TBem(K=3), fields, T.FMMConfig(**cfg),
                          device="cpu"))
    pts = np.random.default_rng(0).uniform(0, 1, (1536, 3))
    return (J.FmmPlan(JLaplace(), {"xyz": pts}, J.FMMConfig(**cfg)),
            T.FmmPlan(TLaplace(), {"xyz": pts}, T.FMMConfig(**cfg),
                      device="cpu"))


@pytest.fixture(scope="module")
def plans():
    return {kind: plan_pair(kind) for kind in ("bem", "points")}


#: host arrays and counts of both packages' LetPlan, compared as they are
HOST_ARRAYS = (
    "dev_lo", "dev_hi", "box_owner", "shared_boxes", "assign_dev", "g2l",
    "m_export_rows", "m_import_pos", "m2l_src", "m2l_tgt", "m2l_cls",
    "src_l2c", "q_export_rows", "q_import_pos", "pair_dev", "_leaf_g2l",
    "leaf_body_idx", "leaf_body_mask", "leaf_rows", "body_flat_slot",
    "body_leaf_row",
)
HOST_COUNTS = (
    "ndev", "ndcn", "nsp", "n_sh", "n_own_max", "n_imp_max", "ZERO", "SINK",
    "R", "R_red", "ZERO_L", "SINK_L", "R_L", "n_bexp_max", "num_levels",
    "has_m2l", "m2l_ntile", "has_m2p", "nl_max", "cdim", "rdim", "K",
    "n_limp_max", "n_ctab", "n_lexp_max", "use_panels", "use_p2p", "nb_max",
)
TWO_LEVEL_ARRAYS = ("m_exp_intra", "m_exp_inter", "m_import_pos2",
                    "q_exp_intra", "q_exp_inter", "q_import_pos2")


def same_levels(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        for ea, eb in zip(la, lb):
            assert (ea is None) == (eb is None)
            if ea is not None:
                np.testing.assert_array_equal(ea[0], eb[0])
                np.testing.assert_array_equal(ea[1], eb[1])
                assert ea[2] == eb[2]


@pytest.mark.parametrize("kind", ["bem", "points"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_host_tables_are_the_jax_ones(plans, kind, layout):
    jp, tp = plans[kind]
    jl, tl = JLet(jp, jax_layout(layout)), LetPlan(tp, layout)
    names = HOST_ARRAYS + (TWO_LEVEL_ARRAYS if tl.ndcn > 1 else ())
    if tl.has_m2p:
        names += ("m2p_rows", "m2p_tslot", "m2p_isig", "m2p_srcbox")
    for name in names:
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name),
                                      err_msg=name)
    for name in HOST_COUNTS:
        assert getattr(tl, name) == getattr(jl, name), name
    for name in ("own_boxes", "import_boxes", "imp_leaves",
                 "dev_leaf_slots"):
        for a, b in zip(getattr(tl, name), getattr(jl, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    same_levels(tl.levels_local, jl.levels_local)
    same_levels(tl.levels_shared, jl.levels_shared)
    assert tl.m2l_bsum.nin == jl.m2l_bsum.nin
    np.testing.assert_array_equal(tl.m2l_bsum.inv_order,
                                  jl.m2l_bsum.inv_order)
    assert len(tl.m2l_bsum.idx) == len(jl.m2l_bsum.idx)
    for a, b in zip(tl.m2l_bsum.idx, jl.m2l_bsum.idx):
        np.testing.assert_array_equal(a, b)
    if tl.ndcn > 1:
        # the split never makes the cross-group payload larger
        assert tl.m_exp_inter.shape[1] <= tl.m_export_rows.shape[1]
        assert tl.q_exp_inter.shape[1] <= tl.q_export_rows.shape[1]
    assert tl.stats() == jl.stats()


@pytest.mark.parametrize("layout", [2, (2, 4)], ids=str)
def test_rank_stores_are_the_jax_stacks(plans, layout):
    """Rank r's near store is slice [r] of the JAX package's stacked
    store, less the rows the stack pads it with (dummy chunks: zero
    panels, the zero charge column, the dropped target segment)."""
    jp, tp = plans["bem"]
    jl, tl = JLet(jp, jax_layout(layout)), LetPlan(tp, layout)
    want, jmeta = jl._near_panels_local(jp.src.fields)
    stores = tl._near_panels_local(tp.src.fields)
    assert len(stores) == tl.ndev
    for r, (dev, meta) in enumerate(stores):
        C = dev["A"].shape[0]
        for key, fill in (("A", 0.0), ("pidx", tl.n_ctab - 1),
                          ("chunk_tgt", tl.nl_max)):
            got, stack = dev[key].numpy(), np.asarray(want[key][r])
            if key == "A":
                np.testing.assert_allclose(
                    got, stack[:C], rtol=0, atol=1e-12 * np.abs(stack).max())
            else:
                np.testing.assert_array_equal(got, stack[:C], err_msg=key)
            assert (stack[C:] == fill).all(), key
        assert (meta.m0, meta.KT, meta.KS, meta.nl_t) == (
            jmeta.m0, jmeta.KT, jmeta.KS, jmeta.nl_t)
        np.testing.assert_array_equal(
            dev["row_ptr"].numpy(),
            np.searchsorted(dev["chunk_tgt"].numpy(),
                            np.arange(tl.nl_max + 1)))


# ----------------------------------------------------------------------
# what the port refuses
# ----------------------------------------------------------------------
def refused_plan(case):
    fields = make_panels(unit_sphere(3), K=3)
    cfg = dict(ncrit=32, dtype="float64", max_p=5)
    if case == "dual":
        tgt = {"xyz": np.random.default_rng(2).uniform(-2, 2, (64, 3))}
        return T.FmmPlan(TLaplace(), {"xyz": fields["xyz"]},
                         T.FMMConfig(**cfg), target_fields=tgt,
                         device="cpu")
    extra = {"coo": dict(near_panel=False), "otf": dict(near_mode="otf"),
             "block_diagonal": dict(block_diagonal=True),
             "local_evaluation": dict(local_evaluation=True)}[case]
    return T.FmmPlan(TBem(K=3), fields, T.FMMConfig(**cfg, **extra),
                     device="cpu")


@pytest.mark.parametrize("case,error,words", [
    ("dual", ValueError, "single-tree"),
    ("coo", NotImplementedError, "COO replay"),
    ("otf", NotImplementedError, "cached panel stores and point P2P"),
    ("block_diagonal", NotImplementedError, "near-field-only"),
    ("local_evaluation", NotImplementedError, "near-field-only"),
])
def test_refused_plans(case, error, words):
    plan = refused_plan(case)
    with pytest.raises(error, match=words):
        LetPlan(plan, 2)


def test_devices_of_the_wrong_length_are_refused(plans):
    _, tp = plans["points"]
    with pytest.raises(ValueError, match="3 devices for 4 ranks"):
        LetPlan(tp, (2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="bad rank layout"):
        LetPlan(tp, (0, 2))


def test_cuda_ranks_are_not_moved_to_the_cpu(plans, monkeypatch):
    """Asking for a card where there is none raises: no rank falls
    back to the CPU."""
    _, tp = plans["points"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        LetPlan(tp, 2, devices=["cpu", "cuda"])


def test_the_jax_let_is_off_its_own_otf_plan():
    """Why the port refuses an OTF plan: the JAX ``LetPlan`` distributes
    the OTF plan's near-singular correction store as if it were the
    whole near field and drops the regular quadrature, so its matvec is
    not the plan's (fmm_bem_tpu/executor/plan.py:1105-1107,
    fmm_bem_tpu/parallel/let.py:704-713)."""
    fields = make_panels(unit_sphere(4), K=3)
    jp = J.FmmPlan(JBem(K=3), fields,
                   J.FMMConfig(ncrit=32, dtype="float64", max_p=8,
                               near_mode="otf"))
    q = np.random.default_rng(5).standard_normal(len(fields["xyz"]))
    want = np.asarray(jp.apply(q, p=8))
    got = JLet(jp, 2).apply(q, p=8)
    assert np.abs(got - want).max() > 1e-1
    tp = T.FmmPlan(TBem(K=3), fields,
                   T.FMMConfig(ncrit=32, dtype="float64", max_p=8,
                               near_mode="otf"), device="cpu")
    with pytest.raises(NotImplementedError, match="near_mode='otf'"):
        LetPlan(tp, 2)


def test_the_jax_let_is_off_its_own_near_only_plan():
    """Why the port refuses a near-field-only plan: the JAX ``LetPlan``'s
    local matvec has no near-only branch (``_local_matvec``,
    fmm_bem_tpu/parallel/let.py:1118), unlike the plan's own
    (fmm_bem_tpu/executor/plan.py:2003), so on a ``local_evaluation``
    plan it returns the full operator, not the near-only one."""
    fields = make_panels(unit_sphere(4), K=3)
    cfg = dict(ncrit=32, dtype="float64", max_p=5)
    near = J.FmmPlan(JBem(K=3), fields,
                     J.FMMConfig(local_evaluation=True, **cfg))
    full = J.FmmPlan(JBem(K=3), fields, J.FMMConfig(**cfg))
    q = np.random.default_rng(5).standard_normal(len(fields["xyz"]))
    want = np.asarray(near.apply(q, p=5))
    got = JLet(near, 2).apply(q, p=5)
    assert np.abs(got - want).max() > 0.1 * np.abs(want).max()
    np.testing.assert_allclose(got, np.asarray(full.apply(q, p=5)),
                               rtol=0, atol=1e-12 * np.abs(got).max())
    tp = T.FmmPlan(TBem(K=3), fields,
                   T.FMMConfig(local_evaluation=True, **cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="near-field-only"):
        LetPlan(tp, 2)


# ----------------------------------------------------------------------
# the communicator
# ----------------------------------------------------------------------
def test_psum_adds_in_rank_order_and_every_rank_gets_the_same_bits():
    rng = np.random.default_rng(9)
    xs = [torch.tensor(rng.standard_normal(64) * 10.0 ** k)
          for k in range(-8, 8, 4)]
    comm = LocalComm(["cpu"] * 4, (1, 4))
    out = comm.psum(xs, "sp")
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    for r in range(4):
        assert torch.equal(out[r], want)
    assert comm.log == [("psum", "sp", 3 * 64 * 8)]
    # on the two-level layout the inner axis sums one group
    comm = LocalComm(["cpu"] * 4, (2, 2))
    inner = comm.psum(xs, "sp")
    assert torch.equal(inner[0], xs[0] + xs[1])
    assert torch.equal(inner[1], xs[0] + xs[1])
    assert torch.equal(inner[3], xs[2] + xs[3])
    both = comm.psum(xs, ("dp", "sp"))
    assert all(torch.equal(b, want) for b in both)


def test_all_gather_stacks_each_group_in_rank_order():
    xs = [torch.full((3, 2), float(r)) for r in range(4)]
    comm = LocalComm(["cpu"] * 4, (2, 2))
    inner = comm.all_gather(xs, "sp")
    assert torch.equal(inner[1], torch.stack(xs[:2]))
    assert torch.equal(inner[2], torch.stack(xs[2:]))
    both = comm.all_gather(xs, ("dp", "sp"))
    assert torch.equal(both[3], torch.stack(xs))
    # float32 payloads of 24 bytes: one from the other member of the
    # group, three from the other ranks
    assert comm.log == [("all_gather", "sp", 24),
                        ("all_gather", ("dp", "sp"), 72)]
    assert comm.max_received() == (72, "all_gather dp,sp")
    with pytest.raises(ValueError, match="layout"):
        LocalComm(["cpu"] * 3, (2, 2))


# ----------------------------------------------------------------------
# the program
# ----------------------------------------------------------------------
def run_jax_program(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "_jax_example_scaling_multichip",
        ROOT / "examples" / "scaling_multichip.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["scaling_multichip.py", *argv])
    mod.main()


def table(text):
    """The rows of the ``-mode mem`` table: every column but the last
    two (the largest collective, from the compiled HLO in the JAX
    program and from the communicator's log in the port)."""
    rows = [ln.split() for ln in text.splitlines()
            if re.match(r"^\s*\d+\s+\d", ln)]
    return [r[:5] for r in rows], [float(r[5]) for r in rows]


def test_scaling_program_mem_table_is_the_jax_programs(capsys, monkeypatch):
    argv = ["-mode", "mem", "-recursions", "4", "-cpu", "-devs", "1,2,4,8"]
    run_jax_program(argv, monkeypatch)
    want, want_coll = table(capsys.readouterr().out)
    res = t_scaling.main(argv)
    got, got_coll = table(capsys.readouterr().out)
    assert len(want) == 4 and got == want
    assert [row["ndev"] for row in res["rows"]] == [1, 2, 4, 8]
    for row, coll in zip(res["rows"], got_coll):
        assert row["max_collective_bytes"] / 1e3 == pytest.approx(coll,
                                                                  abs=0.05)
        assert row["max_collective_bytes"] < \
            row["stats"]["near_panel_bytes_per_dev"]
    # one rank receives nothing; more ranks receive their halos
    assert got_coll[0] == 0.0 and min(got_coll[1:]) > 0.0
    assert min(want_coll[1:]) > 0.0
