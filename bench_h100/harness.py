"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is
found by name:

- ``BENCHMARK.json`` -> the cell (``workloads``), its configuration's
  file and its metrics;
- ``traffic/<mix>.json`` -> the operation and its parameters;
- ``limits/<cell>.json`` -> the limit of each number ``correct``
  compares;
- ``e2e/<metric>.py`` and ``layers/<metric>.py`` -> ``read(run)``, the
  reader of one end-to-end or per-layer metric, which returns a number
  or None where it finds nothing to read.

A run: set-up (plan build, inputs from the seed, warm-up), the window
of ``--seconds``, then with ``--trace 1`` a segment of
``trace_ops`` operations under ``torch.profiler``; the program's state
is dropped and the plain reference checks what the window produced.
The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import math
import os
import sys
import time
import types

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

#: top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fmm_bem_tpu")


class RunError(Exception):
    """A run that cannot print a result: its message goes to stderr."""


def note(msg):
    print(f"[bench_h100] {msg}", file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def deep_merge(base, over):
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_reader(kind, name):
    """``read`` of ``<kind>/<name>.py`` (``kind``: ``e2e`` or
    ``layers``)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_h100.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench, cell):
    """The cell's end-to-end and per-layer metric entries: those whose
    ``workloads`` list it, or that have no such list."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def resolve_cell(name, rehearse=False):
    """(bench, workload entry, configuration, traffic, limits) of the
    cell ``name``; a rehearsal merges each file's ``rehearsal``
    overrides in."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError(f"no BENCHMARK.json at {ROOT}")
    bench = load_json(path)
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     wl["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
    if rehearse:
        config = deep_merge(config, config.get("rehearsal", {}))
        traffic = deep_merge(traffic, traffic.get("rehearsal", {}))
        limits = deep_merge(limits, limits.get("rehearsal", {}))
    return bench, wl, config, traffic, limits


def load_operation(name):
    """The operation class a traffic file names: ``solve`` and ``apply``
    live in ``operations.py``; another ``<name>`` in
    ``operations_<name>.py`` as its ``OPERATION``."""
    from bench_h100.operations import OPERATIONS

    if name in OPERATIONS:
        return OPERATIONS[name]
    path = os.path.join(BENCH_DIR, f"operations_{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_h100.operations_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.OPERATION


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def run_window(op, seconds):
    """Operations back to back until ``seconds`` have passed and at
    least ``op.min_ops`` have run; the last one started is waited for.
    Returns (records, window seconds)."""
    records = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline and len(records) >= op.min_ops:
            break
        rec = op.run_one(i)
        t_end = time.perf_counter()
        rec["t"] = t_end - t0
        records.append(rec)
        i += 1
    return records, t_end - t_start


def traced_segment(op, count, start):
    """``count`` operations under ``torch.profiler`` (CPU and CUDA
    activity), each call into the program inside a benchmark span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_h100.yardstick import Trace

    acts = [ProfilerActivity.CPU]
    if op.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(op.device)
    op.tracing = True
    records = []
    try:
        with profile(activities=acts) as prof:
            for i in range(count):
                records.append(op.run_one(start + i))
            if op.device.type == "cuda":
                torch.cuda.synchronize(op.device)
    finally:
        op.tracing = False
    return records, Trace.from_profile(prof)


def judge(checks, limits):
    """``correct`` and the compared numbers beside their limits.  A
    number that is not a number (NaN) fails."""
    out, ok = {}, True
    for name, value in checks.items():
        if name not in limits:
            raise RunError(f"no limit for the check {name!r}")
        lim = limits[name]["limit"]
        good = value <= lim  # False for NaN
        ok = ok and good
        out[name] = {"value": value, "limit": lim}
    return ok, out


def main(argv, t_process_start):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the files' rehearsal sizes "
                    "(a check of the harness, not a measurement)")
    args = ap.parse_args(argv)
    try:
        result, checks = run(args, t_process_start)
    except RunError as e:
        note(f"error: {e}")
        return 2
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run(args, t_process_start):
    bench, wl, config, traffic, limits = resolve_cell(args.workload,
                                                      args.rehearse)
    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < wl["chips"]:
            raise RunError(f"the cell asks for {wl['chips']} cards, "
                           f"{torch.cuda.device_count()} are visible")
        device = torch.device("cuda", 0)

    from bench_h100 import yardstick

    e2e, per_layer = metrics_of(bench, wl["name"])
    op = load_operation(traffic["operation"])(config, traffic, args.seed,
                                              device)
    note(json.dumps({"plan_build_s": op.plan_build_s,
                     "build": op.build_log()}))
    op.warm_up()
    setup_s = time.perf_counter() - t_process_start
    note(f"set-up {setup_s:.3f} s")

    records, window_s = run_window(op, args.seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    note(f"window {window_s:.3f} s, {len(records)} operations")

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    trace = traced = None
    if args.trace:
        traced, trace = traced_segment(op, traffic["trace_ops"],
                                       len(records))
        note(f"traced {len(traced)} operations, {len(trace.ops)} device "
             "operations")
    run_ns = types.SimpleNamespace(
        op=op, records=records, window_s=window_s, setup_s=setup_s,
        peak_bytes=peak, trace=trace, traced=traced,
        peaks=yardstick.chip_peaks(kind), device_kind=kind)
    metrics = {}
    for m in (per_layer if args.trace else e2e):
        value = load_reader("layers" if args.trace else "e2e",
                            m["name"])(run_ns)
        if value is not None:
            if not math.isfinite(value):
                raise RunError(f"metric {m['name']} read {value}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    all_records = records + (traced or [])
    op.finish(all_records)
    op.free()
    t0 = time.perf_counter()
    checked = op.check(all_records, device, traffic["check"])
    note(f"reference check {time.perf_counter() - t0:.3f} s")
    correct, checks = judge(checked, limits)

    bad = forbidden_loaded()
    if bad:
        raise RunError("modules loaded that the benchmark may not load: "
                       + ", ".join(bad))
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": wl["chips"], "memory_peak_bytes": peak}
    result = {
        "correct": bool(correct),
        "attempted": len(all_records),
        "failed": sum(bool(r["failed"]) for r in all_records),
        "metrics": metrics,
        "device": dev,
    }
    if trace is not None:
        dev["busy_s"] = trace.busy_ns() / 1e9
        dev["window_s"] = trace.window_ns() / 1e9
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    return result, checks
