"""The operations a traffic mix drives, on the system under test.

A traffic file (``traffic/<mix>.json``) names its ``operation``:

- ``"solve"``: boundary data on the host -> the right-hand side by the
  plan's own flipped-BC matvec -> ``solve_plan`` (GMRES on the device)
  -> the solution on the host, one client in a closed loop;
- ``"apply"``: a charge vector on the device -> ``FmmPlan.apply``
  (potential and field), synchronised, one client in a closed loop.

Each class builds the plan from the configuration (``configs/*.json``),
makes its pool of inputs from the seed before the window, runs one
operation per ``run_one`` call, and after the window hands what the
operations produced to its configuration's plain reference.  The
program is imported here and nowhere under ``reference/``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os
import statistics
import time

import torch

from bench_h100 import inputs, yardstick


def _span(tracing, name):
    if not tracing:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function("bench." + name)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_reference(config):
    """The configuration's plain reference (``config["reference"]``, a
    file of this folder)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), config["reference"])
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        f"bench_h100.reference.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_kernel(config):
    spec = config["kernel"]
    cls = getattr(importlib.import_module(spec["module"]), spec["class"])
    return cls(**spec.get("args", {}))


def build_plan(config, fields, device):
    """The program's ``FmmPlan`` and the seconds its constructor took."""
    import fmm_bem_tpu_torch as fbt

    kern = make_kernel(config)
    cfg = fbt.FMMConfig(**config["fmm"])
    t0 = time.perf_counter()
    plan = fbt.FmmPlan(kern, fields, cfg, device=device)
    return plan, time.perf_counter() - t0


class Operation:
    """What every operation gives the harness and the readers."""

    #: the least operations a window holds, whatever its length
    min_ops = 1

    def __init__(self, config, traffic, seed, device):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.tracing = False
        self.plan = None
        self.plan_build_s = None

    def build_log(self):
        """``utils/metrics.py::log``'s split of the plan build."""
        from fmm_bem_tpu_torch.utils.metrics import log

        return {k: v["total_s"] for k, v in log.report().items()
                if k.startswith("build.")}

    def finish(self, records):
        """Cut what the window kept to what the check reads."""

    def free(self):
        """Drop the program's state before the reference runs: the plan
        and whatever holds its tables (the solver's context)."""
        self.plan = None
        self.context = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class SolveOperation(Operation):
    """A BEM solve of a point charge's boundary data (``traffic``:
    ``kind``, ``boundary_data``, ``rhs_p``, ``solver``, ``p_fixed``)."""

    def __init__(self, config, traffic, seed, device, plan=None):
        super().__init__(config, traffic, seed, device)
        from fmm_bem_tpu_torch.bem.panels import make_panels, switch_bc

        self.kind = traffic["kind"]
        self.tris = inputs.unit_sphere(config["geometry"]["recursions"])
        if plan is None:
            fields = make_panels(self.tris,
                                 K=config["kernel"]["args"]["K"])
            if self.kind == "second_kind":
                fields = switch_bc(fields)
            plan, self.plan_build_s = build_plan(config, fields,
                                                 self.device)
        # the surface does not depend on the seed: a plan built for
        # another seed of the same cell serves (control.py)
        self.plan = plan
        self.n = len(self.tris)
        bd = traffic["boundary_data"]
        self.pool, _ = inputs.point_charge_pool(
            self.tris, seed, bd["pool"], tuple(bd["distance"]), bd["value"])

    def warm_up(self):
        """Build the operand of every order the solver can use, then
        solve twice, so that the window builds nothing."""
        import fmm_bem_tpu_torch as fbt
        from fmm_bem_tpu_torch.solver.gmres import DeviceGmresContext

        s = dict(self.traffic["solver"])
        if s.get("p_tiers") is not None:
            s["p_tiers"] = tuple(s["p_tiers"])
        self.solver_config = fbt.SolverConfig(**s)
        self.context = DeviceGmresContext()
        orders = set(s.get("p_tiers") or ())
        orders.add(self.traffic["rhs_p"])
        orders.add(self.traffic.get("p_fixed") or s["max_p"])
        op4p = self.plan.solver_ops_slots()[1]
        for p in sorted(orders):
            op4p(p)
        self.plan.solver_ops_slots(flipped=True)[1](self.traffic["rhs_p"])
        for i in range(2):
            self.run_one(i)
        _sync(self.device)

    def run_one(self, i):
        from fmm_bem_tpu_torch.solver.api import solve_plan

        k = i % len(self.pool)
        data = self.pool[k]
        with _span(self.tracing, "rhs"):
            b = self.plan.apply_flipped_bc(data, p=self.traffic["rhs_p"])
            b = b[:, 0].cpu().numpy()
        with _span(self.tracing, "solve"):
            x, info, _ = solve_plan(self.plan, b, self.solver_config,
                                    p_fixed=self.traffic.get("p_fixed"),
                                    context=self.context)
        return {"pool": k, "b": b, "x": x, "iters": int(info.iterations),
                "p": [int(h[2]) for h in info.history],
                "failed": not bool(info.converged)}

    def chain_ms(self, p, calls=20, chains=5):
        """Milliseconds per slot-space matvec at order ``p`` (the
        solver's operator): the median over ``chains`` chains of
        ``calls`` calls, each chain on another vector of the pool."""
        mv, op4p, to_s = self.plan.solver_ops_slots()[:3]
        operand = op4p(p)
        xs = [to_s(self.pool[k % len(self.pool)]) for k in range(chains)]
        mv(operand, xs[0], p)
        _sync(self.device)
        return 1e3 * statistics.median(
            yardstick.per_call_s(lambda x=x: mv(operand, x, p), calls,
                                 self.device) for x in xs)

    def near_panel_bound_s(self, peaks):
        """The least time of one ``near_panel`` call on the system's
        cached store (None where the plan keeps none)."""
        aux = self.plan.variant_aux(self.solver_config.max_p)
        panels, meta = aux.get("panels", {}), aux.get("near_meta")
        if "A" not in panels or meta is None:
            return None
        nl_s = len(self.plan.src.leaf_ids)
        return yardstick.near_panel_bound_s(
            panels["A"], panels["row_ptr"], meta.m0, meta.KS, meta.cdim,
            meta.nl_t, nl_s * meta.KS * meta.cdim, peaks)

    def check(self, records, device, check_cfg):
        """The numbers of ``correct``: the largest relative error of the
        right-hand sides the program formed and the largest relative
        residual of its solutions, against the reference's rows."""
        R = load_reference(self.config)
        rows = inputs.sample_rows(self.n, check_cfg["rows"], self.seed)
        ref = R.surface_rows(self.config, self.tris, rows, device)
        rhs_op = R.OPERATORS[self.kind][1]
        rhs_err, resid = [], []
        for rec in records:
            data = self.pool[rec["pool"]]
            want = ref.apply(rhs_op, data)
            got = torch.as_tensor(rec["b"][rows], dtype=want.dtype,
                                  device=want.device)
            rhs_err.append(float((got - want).norm() / want.norm()))
            resid.append(ref.residual(self.kind, rec["x"], data))
        return {
            "rhs_err_max": max(rhs_err),
            "residual_max": max(resid),
            "unconverged": sum(r["failed"] for r in records),
        }


class ApplyOperation(Operation):
    """A point FMM evaluation of potential and field (``traffic``:
    ``p``, ``charges``, ``keep_every``)."""

    def __init__(self, config, traffic, seed, device, plan=None):
        super().__init__(config, traffic, seed, device)
        # the points come from the seed: every seed builds its own plan
        self.points = inputs.uniform_cube(config["geometry"]["n"], seed)
        self.n = len(self.points)
        self.plan, self.plan_build_s = build_plan(
            config, {"xyz": self.points}, self.device)
        c = traffic["charges"]
        self.ranges = c["ranges"]
        # one apply of each class of charges at least, for the check
        self.min_ops = len(self.ranges)
        self.pool = inputs.charge_pool(self.n, c["pool"], self.ranges, seed,
                                       self.device, self.plan.dtype)
        # the outputs kept for the check: the sampled rows of every
        # keep_every-th apply, from a seeded offset (keep_every odd and
        # prime to the pool, so that the kept applies walk every vector
        # of the pool); only the rows are kept, so that the window's
        # memory does not grow with the applies it completes
        self.rows = inputs.sample_rows(self.n, traffic["check"]["rows"],
                                       seed)
        self.rows_t = torch.as_tensor(self.rows, device=self.device)
        self.keep_every = traffic["keep_every"]
        self.keep_at = int(inputs.rng(seed, 5).integers(self.keep_every))

    def warm_up(self):
        for i in range(2):
            self.run_one(i)
        _sync(self.device)

    def run_one(self, i):
        k = i % len(self.pool)
        with _span(self.tracing, "apply"):
            out = self.plan.apply(self.pool[k], p=self.traffic["p"])
            _sync(self.device)
        got = (out.index_select(0, self.rows_t)
               if i % self.keep_every == self.keep_at else None)
        return {"pool": k, "got": got, "failed": False}

    def p2p_bound_s(self, peaks):
        """The least time of one ``p2p_tile`` call: the needed
        evaluations at ``P2P_FLOPS`` each over the f32/f64 peak."""
        plan = self.plan
        evals = yardstick.p2p_needed_evaluations(
            plan.tgt.leaf_body_mask, plan.src.leaf_body_mask,
            plan.p2p_tgt_slot, plan.p2p_src_slot)
        peak = peaks[0] if plan.dtype == torch.float32 else peaks[1]
        return evals * yardstick.P2P_FLOPS / peak

    def check(self, records, device, check_cfg):
        """The numbers of ``correct``: for each class of charges
        (``ranges``), the largest relative L2 errors of potential and
        field of the kept outputs on the sampled rows, against direct
        summation; and the count of kept outputs that are not finite."""
        R = load_reference(self.config)
        kept = [r for r in records if r["got"] is not None]
        pools = sorted({r["pool"] for r in kept})
        want = (R.direct_rows(self.points, self.rows,
                              self.pool[pools].cpu(), device)
                if pools else None)
        nan = float("nan")
        out = {}
        for c, rng_ in enumerate(self.ranges):
            mine = [r for r in kept
                    if r["pool"] % len(self.ranges) == c]
            errs = [R.errors(r["got"].to(device),
                             want[pools.index(r["pool"])]) for r in mine]
            out[f"potential_err.{rng_['name']}"] = max(
                (e[0] for e in errs), default=nan)
            out[f"field_err.{rng_['name']}"] = max(
                (e[1] for e in errs), default=nan)
        out["nonfinite"] = sum(not bool(torch.isfinite(r["got"]).all())
                               for r in kept)
        return out

    def finish(self, records):
        """Move the kept rows to the host, in float64."""
        for r in records:
            if r["got"] is not None:
                r["got"] = r["got"].double().cpu()


OPERATIONS = {"solve": SolveOperation, "apply": ApplyOperation}
