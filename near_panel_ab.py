#!/usr/bin/env python3
"""The near_panel wrapper of another checkout beside this one's, on one GPU.

Run as ``python3 near_panel_ab.py --other DIR`` from the root of a
checkout, where DIR holds another checkout of the repository (for
example the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists).  Both versions of
``ops/near_panel.py::panel_matvec_fused`` run in this one process on the
same stores: this checkout's as it is, the other's loaded from DIR with
its own ``csrc/near_panel.cu`` built by its own ``ops/_build.py`` into
DIR's ``build/``.  On each store of ``STORES`` both are held against the
plain version ``panel_matvec_reference`` (1e-5 relative, the same bits
twice), then timed in turns (other, this, this, other, with
``torch.bmm`` on charges gathered beforehand and one PyTorch reduction
over the bytes of A this checkout's kernel reads), replayed from CUDA
graphs (the card's time alone), and for the host's time a call (calls
enqueued without waiting).  Two host costs of the tiled design are
timed alone: the tiling lookup, and a separate allocation of the carry
slots (which the wrapper now makes part of the result's allocation).
The card's name and power limit come first, then one JSON line a store
on standard output.
"""

import argparse
import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("near_panel_ab.py: no GPU (torch.cuda.is_available() "
                     "is False); this script times the card\n")
    sys.exit(1)

import chip_smoke as cs  # noqa: E402  (needs the card at import)
import fmm_bem_tpu_torch as fbt  # noqa: E402
from fmm_bem_tpu_torch.bem.panels import make_panels  # noqa: E402
from fmm_bem_tpu_torch.bem.triangulation import unit_sphere  # noqa: E402
from fmm_bem_tpu_torch.kernels.yukawa_bem import YukawaBEMKernel  # noqa: E402
from fmm_bem_tpu_torch.ops import _build  # noqa: E402
from fmm_bem_tpu_torch.ops import near_panel as npl  # noqa: E402

DEV = cs.DEV
#: the stores timed, in order: the Yukawa program's (2,048 panels, KS
#: 50: 100 of 128 columns needed), the block-diagonal store of the
#: 131,072-panel sphere, the dual store of unequal leaf pads (K_s 136,
#: m0 6: 816 of 896 columns needed), the main cached store
STORES = ("yukawa_program", "block_diagonal", "dual_unequal_pads", "cached")


def load_other(root):
    """The other checkout's ``_build`` and ``near_panel`` modules, each
    under a name of its own.  That ``near_panel`` imports ``_build`` from
    the package ``fmm_bem_tpu_torch.ops`` inside ``_kernel_fn``, at each
    call; so this checkout's kernel handles are fetched first (they are
    cached) and the package's ``_build`` name then points at the other's,
    which builds from DIR's source into DIR's ``build/``."""
    mods = {}
    for name in ("_build", "near_panel"):
        path = os.path.join(root, "fmm_bem_tpu_torch", "ops", name + ".py")
        spec = importlib.util.spec_from_file_location(f"other_{name}", path)
        mods[name] = sys.modules[spec.name] = \
            importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    for dtype in (torch.float32, torch.float64):
        npl._kernel_fn(dtype)
    if npl._kernel_fn.cache_info().currsize < 2:
        raise RuntimeError("this checkout's kernel handles are not cached")
    sys.modules["fmm_bem_tpu_torch.ops"]._build = mods["_build"]
    return mods["near_panel"]


def store_of(name):
    """(store, meta, source leaves) of one store of ``STORES``, on the
    card in f32, built as ``chip_smoke.py`` builds it."""
    if name == "yukawa_program":  # examples/yukawa_bem.py -recursions 5
        fields = make_panels(unit_sphere(5), K=3)
        plan = fbt.FmmPlan(YukawaBEMKernel(K=3, kappa=0.125), fields,
                           fbt.FMMConfig(theta=0.5, ncrit=64, max_p=8,
                                         dtype="float32"), device=DEV)
        src = plan
    elif name in ("block_diagonal", "cached"):
        plan, _ = cs.build_plan(8, "float32",
                                **({"block_diagonal": True}
                                   if name == "block_diagonal" else {}))
        src = plan
    else:  # the dual exterior plan of unequal leaf pads
        fields = make_panels(unit_sphere(8), K=3)
        rng = np.random.default_rng(51)
        dirs = rng.standard_normal((200_000, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts = dirs * rng.uniform(1.05, 3.0, (200_000, 1))
        plan, _ = cs.dual_bem_plan(
            fields, cs.pseudo_panel_targets(pts, fields), leaf_pad=None,
            max_level=cs.DUAL_UNEQUAL_MAX_LEVEL)
        src = plan.src
    panels, meta = plan.near_panels()
    return panels, meta, len(src.leaf_ids)


def compare(name, other):
    panels, meta, nl_src = store_of(name)
    A = panels["A"]
    C, KTr, Lb = A.shape
    gen = torch.Generator(device=DEV).manual_seed(11)
    ql = torch.randn((nl_src, meta.KS * meta.cdim), generator=gen,
                     dtype=A.dtype, device=DEV)
    fns = {"other": lambda: other.panel_matvec_fused(panels, meta, ql),
           "this": lambda: npl.panel_matvec_fused(panels, meta, ql)}
    want = npl.panel_matvec_reference(panels, meta, ql)
    scale = float(want.abs().max())
    rec = {"store": name, "A_shape": [C, KTr, Lb], "m0": meta.m0,
           "nl_t": meta.nl_t, **cs.near_panel_bound(panels, meta, ql)}
    for who, fn in fns.items():
        got, again = fn(), fn()
        rel = float((got - want).abs().max()) / scale
        rec[f"{who}_rel_err"] = rel
        rec[f"{who}_bit_equal_twice"] = bool(torch.equal(got, again))
        if not (rel <= 1e-5 and torch.equal(got, again)):
            cs.emit(rec)
            cs.fail(f"near_panel_ab[{name}]: the {who} wrapper is off the "
                    f"plain version by {rel:.3e} or not bit-equal twice")
    xb = npl.chunk_charge_rows(panels, ql)[:, :, None].contiguous()
    real = A[:rec["real_chunks"], :, :-(-rec["needed_columns"] // 4) * 4]
    timed = {**fns, "torch.bmm": lambda: torch.bmm(A, xb),
             "read_of_A": lambda: real.sum()}
    order = ["other", "this", "torch.bmm", "read_of_A"]
    rounds = {k: [] for k in timed}
    for o in (order, order[::-1], order, order[::-1]):
        for k in o:
            rounds[k].append(cs.gpu_ms(timed[k], 20))
    rec["ms"] = {k: statistics.mean(v) for k, v in rounds.items()}
    rec["rounds_ms"] = rounds
    graphs = {k: [] for k in ("other", "this", "torch.bmm")}
    for k in ("other", "this", "torch.bmm", "this", "other"):
        graphs[k].append(cs.graph_ms(timed[k]))
    rec["graph_ms"] = {k: statistics.mean(v) for k, v in graphs.items()}
    host = {k: [] for k in ("other", "this", "torch.bmm")}
    for k in ("other", "this", "torch.bmm", "torch.bmm", "this", "other"):
        host[k].append(cs.host_us(timed[k], 50))
    rec["host_us_per_call"] = {k: statistics.mean(v) for k, v in host.items()}
    rec["host_us_rounds"] = host
    sms = npl.sm_count(DEV)
    tiling = npl.near_tiling(C, KTr, Lb, A.element_size(), sms)
    rec["S"], rec["grid"] = tiling.S, list(tiling.grid)
    rec["this_host_us_parts"] = {
        "near_tiling": cs.host_us(lambda: npl.near_tiling(
            C, KTr, Lb, A.element_size(), npl.sm_count(ql.device)), 50),
        "carry_empty": cs.host_us(lambda: torch.empty(
            tiling.carry_shape(KTr), dtype=A.dtype, device=DEV), 50),
    }
    rec["bound_share"] = {k: rec["bound_ms"] / rec["ms"][k]
                          for k in ("other", "this", "torch.bmm")}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--stores", default=",".join(STORES),
                    help="comma-separated names of STORES")
    args = ap.parse_args()
    t0 = time.time()
    _build.build(["near_panel"])
    other = load_other(os.path.abspath(args.other))
    other._kernel_fn(torch.float32)  # builds the other's kernel
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"build_s": time.time() - t0})
    for name in args.stores.split(","):
        cs.emit(compare(name, other))
        torch.cuda.empty_cache()
    cs.emit({"script_s": time.time() - t0})


if __name__ == "__main__":
    main()
