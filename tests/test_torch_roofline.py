"""The port's per-phase instrument (``fmm_bem_tpu_torch/utils/roofline.py``)
against the JAX package's (``fmm_bem_tpu/utils/roofline.py``) on the CPU:
the isotonic fit, the FLOP/byte model key by key, and the phase list,
whose composition in order must be the matvec the plan runs, at f64 to
1e-12 relative, on every branch of ``FmmPlan._matvec_slots`` (and of the
body-order ``_matvec``).  The JAX list leaves out M2P; a test shows it
on the JAX plan and leaves the JAX module as it is.  Times are not held
here: a CPU run gives none of the card's."""

import jax
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
from fmm_bem_tpu.utils import roofline as jr
from fmm_bem_tpu_torch.kernels.laplace import LaplaceKernel as TLaplace
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TBem
from fmm_bem_tpu_torch.kernels.stokes_bem import StokesBEMKernel as TStokes
from fmm_bem_tpu_torch.utils import roofline as tr

TOL = 1e-12


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def two_spheres():
    """A unit sphere beside a sphere fifty times smaller: the adaptive
    tree gets level-skewed pairs (M2P) and family M2L."""
    small = unit_sphere(4) * 0.02 + np.array([1.3, 0.0, 0.0])
    return np.concatenate([unit_sphere(3), small])


SKEWED = dict(ncrit=8, dtype="float64", max_p=6)


@pytest.fixture(scope="module")
def skewed():
    fields = make_panels(two_spheres(), K=3)
    return (fields,
            J.FmmPlan(JBem(K=3), fields, J.FMMConfig(**SKEWED)),
            T.FmmPlan(TBem(K=3), fields, T.FMMConfig(**SKEWED),
                      device="cpu"))


# ----------------------------------------------------------------------
# the isotonic fit
# ----------------------------------------------------------------------
def seeded_walk():
    rng = np.random.default_rng(0)
    return list(rng.standard_normal(50).cumsum() + rng.standard_normal(50))


@pytest.mark.parametrize("y", [
    [1.0, 2.0, 3.0], [1.0, 2.0, 1.5, 3.0], [3.0, 2.0, 1.0], seeded_walk(),
], ids=["sorted", "one_violation", "decreasing", "seeded_walk"])
def test_pava_is_the_jax_one(y):
    got = tr._pava_nondecreasing(y)
    assert got == jr._pava_nondecreasing(y)
    assert len(got) == len(y)
    assert all(b >= a - 1e-12 for a, b in zip(got, got[1:]))


# ----------------------------------------------------------------------
# the phase list
# ----------------------------------------------------------------------
def points():
    return {"xyz": np.random.default_rng(4).uniform(0, 1, (1500, 3))}


def phase_case(case, skewed_fields):
    """(port plan, flipped) of one parametrised case."""
    f64 = dict(dtype="float64", max_p=6)
    if case == "skewed":
        return T.FmmPlan(TBem(K=3), skewed_fields, T.FMMConfig(**SKEWED),
                         device="cpu"), False
    if case == "points":
        return T.FmmPlan(TLaplace(), points(), T.FMMConfig(ncrit=32, **f64),
                         device="cpu"), False
    if case == "stokes":
        return T.FmmPlan(TStokes(K=4, mu=1e-3),
                         make_panels(unit_sphere(2), K=4),
                         T.FMMConfig(ncrit=16, **f64), device="cpu"), False
    extra = {"otf": dict(near_mode="otf"),
             "local_evaluation": dict(local_evaluation=True),
             "coo": dict(near_panel=False)}.get(case, {})
    plan = T.FmmPlan(TBem(K=3), make_panels(unit_sphere(3), K=3),
                     T.FMMConfig(ncrit=16, **f64, **extra), device="cpu")
    return plan, case == "bem_flipped"


#: the phases each case must list, in order
PHASES = {
    "skewed": ["p2m", "m2m", "m2l", "l2l", "l2p", "m2p", "near"],
    "otf": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "stokes": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "points": ["p2m", "m2m", "m2l", "l2l", "l2p", "p2p"],
    "local_evaluation": ["near"],
    "bem": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "bem_flipped": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
    "coo": ["p2m", "m2m", "m2l", "l2l", "l2p", "near"],
}


@pytest.mark.parametrize("case", list(PHASES))
def test_phase_composition_is_the_matvec(case, skewed):
    """The phases of ``_phase_fns``, run in order by ``run_phases``,
    give the plan's own matvec: ``_matvec_slots`` on every plan with a
    slot route (the OTF tiles, the Stokes two-stage store, the point
    P2P, the near-only operator, both BC variants), ``_matvec`` on the
    COO replay, which has none."""
    plan, flipped = phase_case(case, skewed[0])
    n = plan.src.tree.num_bodies
    cdim = getattr(plan.kernel, "charge_dim", 1)
    q = np.random.default_rng(8).standard_normal(n * cdim)
    p = 5
    if case == "coo":
        assert not plan.has_slot_route
        operand = (plan.device_data(p), plan.variant_aux(p),
                   plan.device_fields(), plan.device_fields())
        x = torch.tensor(q)
        want = plan._matvec(*operand, x, p)
        slot_ops = None
    else:
        fh = plan._flipped_fields() if flipped else None
        slot_ops = plan._slot_ops(fh)
        operand = slot_ops[1](p)
        x = slot_ops[2](q)
        want = plan._matvec_slots(*operand, x, p)
    fns = tr._phase_fns(plan, p, operand[1], slot_ops)
    assert [nm for nm, _ in fns] == PHASES[case]
    got = tr.run_phases(plan, fns, operand, x, slot_ops is not None)["res"]
    assert rel(got, want) <= TOL
    if case == "skewed":
        assert len(plan.m2p_src) > 0 and plan.m2l_fam is not None


def test_jax_phase_list_leaves_out_m2p(skewed):
    """``fmm_bem_tpu/utils/roofline.py:181-194`` lists P2M ... L2P and
    the near field, but the JAX slot matvec also adds ``_m2p_pass``
    (``fmm_bem_tpu/executor/plan.py:2016-2019``).  On a plan with
    level-skewed pairs the JAX phases, composed as its ``step_body``
    composes them, miss exactly that term.  The JAX module is left as
    it is; the port's list has M2P."""
    _, jp, _ = skewed
    p = 5
    assert len(jp.m2p_src) > 0
    slot_ops = jp.solver_ops_slots()
    d, aux, sf, _ = slot_ops[1](p)
    q = slot_ops[2](
        np.random.default_rng(8).standard_normal(jp.src.tree.num_bodies))
    fns = jr._phase_fns(jp, p, set(aux.keys()), slot_ops)
    assert [nm for nm, _, _ in fns] == ["p2m", "m2m", "m2l", "l2l", "l2p",
                                       "near"]
    nl_t, K_t = len(jp.tgt.leaf_ids), jp.tgt.leaf_pad

    @jax.jit  # eager JAX takes 20 s on this plan, the jit 3 s
    def terms(d, aux, sf, q):
        state = out = None
        for _, f, tag in fns:  # the composition of jr.phase_breakdown
            if tag == "q":
                r = f(d, aux, sf, q)
                if state is None:
                    state = out = r
                else:
                    out = out + r if out.shape == r.shape else r
            else:
                state = out = f(d, aux, sf, state)
        M = jp._phase_m2m(d, jp._p2m_slots(d, aux, q, p))
        m2p = jp._m2p_pass(d, sf, M, p, nl_t, K_t,
                           jax.numpy.dtype(jp.config.dtype), slots=True)
        return out, m2p, jp._matvec_slots(d, aux, sf, sf, q, p)

    out, m2p, want = map(np.asarray, terms(d, aux, sf, q))
    assert rel(out, want) > 1e-6
    assert rel(out + m2p, want) <= TOL


# ----------------------------------------------------------------------
# the FLOP/byte model and the peaks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["skewed", "points"])
def test_flop_byte_model_is_the_jax_one(case, skewed):
    if case == "skewed":
        _, jp, tp = skewed
    else:
        cfg = dict(ncrit=32, dtype="float64", max_p=6)
        jp = J.FmmPlan(JLaplace(), points(), J.FMMConfig(**cfg))
        tp = T.FmmPlan(TLaplace(), points(), T.FMMConfig(**cfg), device="cpu")
    for p in (3, 5):
        want = jr._flop_byte_model(jp, p)
        got = tr._flop_byte_model(tp, p)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-15), k
    assert ("near" in got) == (case == "skewed")


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (67e12, 34e12, 3.35e12)),
    ("cpu", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_chip_peaks(name, peaks):
    assert tr.chip_peaks(name) == peaks


# ----------------------------------------------------------------------
# the instrument on the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["skewed", "coo"])
def test_phase_breakdown_structure(case, skewed):
    """Ported from the JAX package's ``test_phase_breakdown_structure``,
    on a plan with M2P pairs (slot route) and on the COO replay (body
    order): the phases telescope to the pipeline total, the
    credibility flag is there, and no share of a peak is given, since
    the CPU has none."""
    if case == "skewed":
        tp = T.FmmPlan(TBem(K=3), skewed[0],
                       T.FMMConfig(ncrit=8, dtype="float32", max_p=6),
                       device="cpu")
    else:
        tp = T.FmmPlan(TBem(K=3), make_panels(unit_sphere(3), K=3),
                       T.FMMConfig(ncrit=16, dtype="float32", max_p=6,
                                   near_panel=False), device="cpu")
        assert not tp.has_slot_route
    out = tr.phase_breakdown(tp, 5, chain=4, iters=1, repeats=2, solo=True)
    phases = PHASES[case]
    assert list(out) == phases + ["total"]
    for ph in phases:
        r = out[ph]
        assert r["ms"] >= 0.0 and r["spread_ms"] >= 0.0
        assert r["ms_solo"] > 0.0
        assert "pct_mxu" not in r and "pct_hbm" not in r
        assert "unreliable" not in r
    t = out["total"]
    assert t["device"] == "cpu"
    assert t["ms"] > 0.0 and t["matvec_ms"] > 0.0
    assert abs(sum(out[ph]["ms"] for ph in phases) - t["ms"]) < 1e-9
    assert "suspect" in t
    if t["sum_ratio"] is not None:
        assert t["sum_ratio"] > 0.0
    assert t["suspect"] == (
        t["sum_ratio"] is None or not 0.85 <= t["sum_ratio"] <= 1.15)
    # an external matvec time is taken as the reference
    ref = tr.phase_breakdown(tp, 5, chain=2, repeats=1, mv_ms_ref=1e3)
    assert ref["total"]["matvec_ms"] == 1e3
    assert ref["total"]["sum_ratio"] == pytest.approx(ref["total"]["ms"] / 1e3)
