"""What the LET test files share: one problem planned by both packages,
with the JAX ``LetPlan``'s result computed once per (layout, variant),
and the port's LET ``apply`` held against it and the port's plan."""

import jax
import numpy as np
import torch
from jax.sharding import Mesh

import fmm_bem_tpu as J
import fmm_bem_tpu_torch as T
from fmm_bem_tpu.parallel.let import LetPlan as JLet
from fmm_bem_tpu_torch.parallel.let import LetPlan

TOL = 1e-12


def relmax(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_layout(layout):
    """The JAX LetPlan's mesh argument for a rank layout: the count, or
    a ``("dp", "sp")`` mesh of the suite's host devices."""
    if isinstance(layout, int):
        return layout
    devs = np.array(jax.devices()[: layout[0] * layout[1]]).reshape(layout)
    return Mesh(devs, ("dp", "sp"))


class Pair:
    """One problem planned by both packages, with the JAX LET results
    computed once per (layout, variant)."""

    def __init__(self, jkern, tkern, fields, p, seed, cdim=1, **config):
        """``config`` overrides FMMConfig fields of both plans; a value
        given as ``{"jax": a, "port": b}`` differs by package (an
        enum of each)."""
        cfg = {"ncrit": 32, "dtype": "float64", "max_p": 8, **config}

        def side(name):
            return {k: v[name] if isinstance(v, dict) else v
                    for k, v in cfg.items()}

        self.jp = J.FmmPlan(jkern, fields, J.FMMConfig(**side("jax")))
        self.tp = T.FmmPlan(tkern, fields, T.FMMConfig(**side("port")),
                            device="cpu")
        self.n = len(fields["xyz"])
        self.p = p
        rng = np.random.default_rng(seed)
        self.q = rng.standard_normal(
            (self.n,) if cdim == 1 else (self.n, cdim))
        self._jax = {}

    def jax_let(self, layout, flipped):
        key = (str(layout), flipped)
        if key not in self._jax:
            self._jax[key] = JLet(self.jp, jax_layout(layout),
                                  flipped=flipped).apply(self.q, p=self.p)
        return self._jax[key]

    def plan(self, flipped):
        run = self.tp.apply_flipped_bc if flipped else self.tp.apply
        return run(self.q, p=self.p)

    def jax_plan(self, flipped):
        run = self.jp.apply_flipped_bc if flipped else self.jp.apply
        return np.asarray(run(self.q, p=self.p))


def hold_apply(pair, layout, flipped, jax_let_off=False):
    """The port's LET ``apply`` against the JAX LET's and the port
    plan's, and the padded layout's zero rows.  ``jax_let_off``: the
    JAX LET is off its own plan here (its table-less L2P and its M2P
    read the plan's own BC flags where the variant flips them,
    ROADMAP.md C), so
    the port is held to the JAX plan instead, and the JAX LET's
    distance from it is shown."""
    lp = LetPlan(pair.tp, layout, flipped=flipped)
    got = lp.apply(pair.q, p=pair.p)
    assert got.shape == (pair.n, pair.tp.kernel.result_dim)
    assert relmax(got, pair.plan(flipped)) <= TOL
    if jax_let_off:
        want = pair.jax_plan(flipped)
        assert relmax(got, want) <= TOL
        assert relmax(pair.jax_let(layout, flipped), want) > 1e-3
    else:
        assert relmax(got, pair.jax_let(layout, flipped)) <= TOL
    # the padded layout: padded rows of the result are exactly zero
    fn, ops = lp.matvec_fn(pair.p)
    out = fn(ops, lp.to_padded(pair.q))
    assert out.shape == (lp.ndev * lp.nb_max, pair.tp.kernel.result_dim)
    lens = lp.dev_hi - lp.dev_lo
    for r in range(lp.ndev):
        assert not out[r * lp.nb_max + lens[r] : (r + 1) * lp.nb_max].any()
    assert torch.equal(lp.from_padded(out), got)
