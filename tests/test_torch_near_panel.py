"""Near-field modules of the PyTorch port against the JAX package, on the
CPU at f64: harmonics, the Laplace BEM device operators, the panel store
assembled on the device (one-shot and chunked), the plain version of the
near-field product, and the bucketed gather-sum.  Inputs are made with
numpy from a seed and handed to both packages.  Tolerance 1e-13: the two
sides do the same arithmetic, sums may associate differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.kernels import laplace as jlap
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel as JKernel
from fmm_bem_tpu.ops import bucket_sum as jbs
from fmm_bem_tpu.ops import near_panel as jnp_mod
from fmm_bem_tpu_torch.kernels import laplace as tlap
from fmm_bem_tpu_torch.kernels.laplace_bem import LaplaceBEMKernel as TKernel
from fmm_bem_tpu_torch.ops import bucket_sum as tbs
from fmm_bem_tpu_torch.ops import near_panel as tnp_mod

TOL = 1e-13


def close(t, j, tol=TOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    assert float(np.abs(t - j).max(initial=0.0)) <= tol * scale


@pytest.fixture(scope="module")
def plans():
    fields = make_panels(unit_sphere(4), K=3)
    jp = J.FmmPlan(
        JKernel(K=3), fields,
        J.FMMConfig(ncrit=32, dtype="float64", max_p=6),
    )
    tp = T.FmmPlan(
        TKernel(K=3), fields,
        T.FMMConfig(ncrit=32, dtype="float64", max_p=6), device="cpu",
    )
    return jp, tp


@pytest.mark.parametrize("p", [1, 4, 9])
@pytest.mark.parametrize("which", ["eval_regular", "eval_singular"])
def test_solid_harmonics(which, p):
    d = np.random.default_rng(p).standard_normal((7, 5, 3))
    jr, ji = getattr(jlap, which)(jnp.asarray(d), p)
    tr, ti = getattr(tlap, which)(torch.as_tensor(d), p)
    close(tr, jr), close(ti, ji)
    close(
        tlap.to_interleaved_ri(tr, ti),
        jlap.to_interleaved_ri(jr, ji),
    )


def _dev_fields(plan, lib):
    return {
        k: lib(np.asarray(v, np.float64))
        for k, v in plan.src.fields.items() if k != "vertices"
    }


def test_p2m_and_l2p_table(plans):
    jp, tp = plans
    n = tp.src.tree.num_bodies
    q = np.random.default_rng(1).standard_normal(n)
    dn, isig = tp.src.body_dnorm, tp.src.body_inv_sigma
    for p in (3, 6):
        close(
            tp.kernel.p2m(_dev_fields(tp, torch.as_tensor),
                          torch.as_tensor(q), torch.as_tensor(dn),
                          torch.as_tensor(isig), p),
            jp.kernel.p2m(_dev_fields(jp, jnp.asarray), jnp.asarray(q),
                          jnp.asarray(dn), jnp.asarray(isig), p),
        )
        close(
            tp.kernel.l2p_table(_dev_fields(tp, torch.as_tensor),
                                torch.as_tensor(dn),
                                torch.as_tensor(isig), p),
            jp.kernel.l2p_table(_dev_fields(jp, jnp.asarray),
                                jnp.asarray(dn), jnp.asarray(isig), p),
        )


def test_l2p_and_m2p(plans):
    jp, tp = plans
    n = tp.src.tree.num_bodies
    rng = np.random.default_rng(2)
    p = 5
    E = rng.standard_normal((n, 2, tp.kernel.width(p)))
    dn = tp.src.body_dnorm + 2.5  # away from the expansion centre
    isig = tp.src.body_inv_sigma
    for op in ("l2p", "m2p"):
        close(
            getattr(tp.kernel, op)(
                _dev_fields(tp, torch.as_tensor), torch.as_tensor(E),
                torch.as_tensor(dn), torch.as_tensor(isig), p),
            getattr(jp.kernel, op)(
                _dev_fields(jp, jnp.asarray), jnp.asarray(E),
                jnp.asarray(dn), jnp.asarray(isig), p),
        )


def test_near_block_device(plans):
    jp, tp = plans
    ss = tp.p2p_src_slot[:40].astype(np.int64)
    ts = tp.p2p_tgt_slot[:40].astype(np.int64)
    idx, msk = tp.src.leaf_body_idx, tp.src.leaf_body_mask
    tf, jf = _dev_fields(tp, torch.as_tensor), _dev_fields(jp, jnp.asarray)
    tblk = tp.kernel.near_block_device(
        {k: v[torch.as_tensor(idx[ts])] for k, v in tf.items()},
        {k: v[torch.as_tensor(idx[ss])] for k, v in tf.items()},
        torch.as_tensor(msk[ts]), torch.as_tensor(msk[ss]),
    )
    jblk = jax.vmap(jp.kernel.near_block_device)(
        {k: v[idx[ts]] for k, v in jf.items()},
        {k: v[idx[ss]] for k, v in jf.items()},
        jnp.asarray(msk[ts]), jnp.asarray(msk[ss]),
    )
    assert tblk.shape == (40, tp.leaf_pad, tp.leaf_pad)
    close(tblk, jblk)


def _stores(jp, tp, flipped, m0=None):
    """The panel store of both packages through their device assembly functions."""
    jtf = jp._flipped_fields()[1] if flipped else jp.tgt.fields
    ttf = tp._flipped_fields() if flipped else tp.tgt.fields
    bc = np.asarray(ttf["bc"])
    vsel = tp.kernel.near_select(tp.near_vals, bc[tp.near_rows])
    corr = (tp.near_rows, tp.near_cols, vsel)
    nl = len(tp.leaf_ids)
    jdev, jmeta = jnp_mod.build_near_panels_on_device(
        jp.p2p_src_slot, jp.p2p_tgt_slot, jp.src, jp.tgt, nl,
        jp._near_blocks_fn(jtf), corr=corr, m0=m0, dtype="float64",
    )
    tdev, tmeta = tnp_mod.build_near_panels_on_device(
        tp.p2p_src_slot, tp.p2p_tgt_slot, tp.src, tp.tgt, nl,
        tp._near_blocks_fn(ttf), corr=corr, m0=m0, dtype=torch.float64,
        device="cpu",
    )
    return jdev, jmeta, tdev, tmeta


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_panel_store_built_on_device(plans, monkeypatch, chunked, flipped):
    jp, tp = plans
    if chunked:
        # force the row-chunked assembly on this small mesh, in several
        # chunks: narrow rows (m0 = 2) make the store two blocks long
        monkeypatch.setattr(tnp_mod, "ONE_SHOT_LIMIT", 1 << 14)
        monkeypatch.setattr(jnp_mod, "ONE_SHOT_LIMIT", 1 << 14)
        monkeypatch.setattr(tnp_mod, "CHUNK_BUDGET", 1 << 14)
    jdev, jmeta, tdev, tmeta = _stores(
        jp, tp, flipped, m0=2 if chunked else None
    )
    if chunked:
        assert tdev["A"].shape[0] >= 2 * tmeta.block_rows
    for name in ("nl_t", "m0", "block_rows", "npairs", "rdim", "cdim",
                 "KT", "KS"):
        assert getattr(jmeta, name) == getattr(tmeta, name)
    assert tdev["A"].shape[2] % 128 == 0
    assert tdev["A"].shape[0] % tmeta.block_rows == 0
    np.testing.assert_array_equal(tdev["pidx"].numpy(), np.asarray(jdev["pidx"]))
    np.testing.assert_array_equal(
        tdev["chunk_tgt"].numpy(), np.asarray(jdev["chunk_tgt"])
    )
    close(tdev["A"], jdev["A"])
    # the row pointer the CUDA kernel walks covers every real chunk once
    rp = tdev["row_ptr"].numpy()
    ct = tdev["chunk_tgt"].numpy()
    assert rp[0] == 0 and rp[-1] == int((ct < tmeta.nl_t).sum())
    for leaf in (0, tmeta.nl_t // 2, tmeta.nl_t - 1):
        assert (ct[rp[leaf]: rp[leaf + 1]] == leaf).all()


def test_host_built_panels_match(plans):
    """``build_near_panels`` (COO entries packed on the host) is a copy."""
    jp, tp = plans
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(len(tp.near_rows))
    args = (tp.near_rows, tp.near_cols, vals)
    tm = tnp_mod.build_near_panels(
        tp.p2p_src_slot, tp.p2p_tgt_slot, *args, tp.src, tp.tgt,
        len(tp.leaf_ids), dtype=np.float64,
    )
    jm = jnp_mod.build_near_panels(
        jp.p2p_src_slot, jp.p2p_tgt_slot, *args, jp.src, jp.tgt,
        len(jp.leaf_ids), dtype=np.float64,
    )
    np.testing.assert_array_equal(tm.A, jm.A)
    np.testing.assert_array_equal(tm.pidx, jm.pidx)
    np.testing.assert_array_equal(tm.chunk_tgt, jm.chunk_tgt)


@pytest.mark.parametrize("flipped", [False, True])
def test_panel_matvec_plain_version(plans, flipped):
    jp, tp = plans
    jdev, jmeta = jp.near_panels(jp._flipped_fields()[1] if flipped else None)
    tdev, tmeta = tp.near_panels(tp._flipped_fields() if flipped else None)
    pidx, ct = tdev["pidx"].numpy(), tdev["chunk_tgt"].numpy()
    nl = len(tp.leaf_ids)
    # dummy chunks and dummy charge tiles are present in this store
    assert (ct == tmeta.nl_t).any() and (pidx == nl).any()
    ql = np.random.default_rng(4).standard_normal((nl, tp.leaf_pad))
    want = jnp_mod.panel_matvec(jdev, jmeta, jnp.asarray(ql), use_pallas=False)
    before = tnp_mod.panel_matvec_fused.launches
    got = tnp_mod.panel_matvec(tdev, tmeta, torch.as_tensor(ql))
    assert tnp_mod.panel_matvec_fused.launches == before  # no kernel on the CPU
    close(got, want)
    close(tnp_mod.panel_matvec_reference(tdev, tmeta, torch.as_tensor(ql)), want)


def test_panel_matvec_rejects_other_devices(plans):
    _, tp = plans
    tdev, tmeta = tp.near_panels()
    ql = torch.zeros((len(tp.leaf_ids), tp.leaf_pad), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tnp_mod.panel_matvec(tdev, tmeta, ql)


def test_choose_m0_and_chunk_row_ptr():
    rng = np.random.default_rng(5)
    for KSc in (13, 64, 192):
        m_per = rng.integers(0, 40, 200)
        assert tnp_mod.choose_m0(m_per, KSc) == jnp_mod.choose_m0(m_per, KSc)
    ct = np.array([0, 0, 2, 2, 2, 3, 5, 5], np.int32)  # 5 = dummy, nl_t = 5
    np.testing.assert_array_equal(
        tnp_mod.chunk_row_ptr(ct, 5), [0, 2, 2, 5, 6, 6]
    )
    with pytest.raises(ValueError, match="sorted"):
        tnp_mod.chunk_row_ptr(ct[::-1], 5)


@pytest.mark.parametrize("trailing", [(), (6,), (2, 3)])
def test_bucket_sum(trailing):
    rng = np.random.default_rng(6)
    nin, nrows = 500, 37
    targets = rng.integers(0, nrows + 3, nin)  # ids >= nrows are dropped
    x = rng.standard_normal((nin,) + trailing)
    jb = jbs.build_bucket_sum(targets, nin, nrows)
    tb = tbs.build_bucket_sum(targets, nin, nrows)
    np.testing.assert_array_equal(jb.inv_order, tb.inv_order)
    got = tbs.bucket_sum_apply(tb.device("cpu", torch.float64), torch.as_tensor(x))
    close(got, jbs.bucket_sum_apply(jb.device(), jnp.asarray(x)))
    want = np.zeros((nrows + 3,) + trailing)
    np.add.at(want, targets, x)
    close(got, want[:nrows])
