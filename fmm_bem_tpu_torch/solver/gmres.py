"""Restarted GMRES / FGMRES with inexact-Krylov p-relaxation.

Re-design of examples/BEM/GMRES.hpp (:142-252 GMRES, :276-380 FGMRES)
for PyTorch: the Arnoldi basis and every vector of length n live on the
operator's device.  Before every inner matvec the truncation order is
chosen from the current residual (SolverOptions::predict_p, ref
GMRES.hpp:195-196), so each iteration brings its Gram-Schmidt
coefficients to the host once.  Both solvers project a new Krylov
vector the same way (``_project``).

Two solvers:

- ``gmres`` / ``fgmres``, the host loop: the small Hessenberg/Givens
  state (``H``, ``cs``, ``sn``, ``s``) is numpy f64 whatever the
  working dtype, the order comes from ``SolverConfig.schedule_p`` with
  a sticky stall boost, and ``matvec(x, p)`` takes the vector alone;
- ``gmres_device`` / ``fgmres_device``: the small state is numpy in the
  working dtype, ``matvec(operand, x, p)`` takes per-order device
  tables, and the schedule is one of the two below.

Two schedules of the device solver, both from the residual:

- ``p_tiers`` set: the order is picked per iteration among the tiers
  (the predicted order rounded up to a tier, never below a sticky floor
  that a stall raises);
- ``p_tiers`` unset: an order is kept while the schedule still asks for
  at least that order, and left on a stall, which also raises a sticky
  boost of the predicted order.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from fmm_bem_tpu_torch.config import RelaxType, SolverConfig
from fmm_bem_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

#: stall guard: a window of this many iterations must improve the
#: residual by more than 1 / STALL_FACTOR
STALL_WIN, STALL_FACTOR = 4, 0.5


@dataclasses.dataclass
class SolveInfo:
    iterations: int
    residual: float
    converged: bool
    #: (iteration, residual, p) per inner step — mirrors the reference's
    #: "it, res, fmm_req_p" print (GMRES.hpp:225)
    history: list


# ----------------------------------------------------------------------
# Krylov-state checkpointing.  The whole Arnoldi state is pure arrays,
# so a checkpoint is one npz and a resumed solve replays the remaining
# iterations bit-identically: every update depends only on the saved
# (V, Z, H, cs, sn, s, i, x), and the Gram-Schmidt products read the
# live rows of the basis only.
# ----------------------------------------------------------------------


def _save_krylov_ckpt(path, kind, **arrays):
    save_checkpoint(path, kind=np.bytes_(kind), **arrays)


def _load_krylov_ckpt(path, kind, n):
    """Load a Krylov checkpoint; None if absent/mismatched."""
    if path is None:
        return None
    d = load_checkpoint(path)
    if d is None:
        return None
    if bytes(d["kind"]) != kind.encode() or int(d["n"]) != n:
        return None
    return d


def _embed(a, shape):
    """Place ``a`` into the leading corner of zeros(shape).

    Buffer sizes are derived from ``min(restart, max_iters, n)``, so a
    checkpoint written by a run with different limits carries smaller
    (or larger) arrays than the resuming run allocates; the Arnoldi
    trajectory itself is identical — only padding differs."""
    a = np.asarray(a)
    out = np.zeros(shape, a.dtype)
    sl = tuple(slice(0, min(sa, st)) for sa, st in zip(a.shape, shape))
    out[sl] = a[sl]
    return out


def _project(Vm, w):
    """Block classical Gram-Schmidt of ``w`` against the rows of ``Vm``,
    with one re-orthogonalisation pass for f32 robustness: two [i, n]
    matvec pairs instead of the reference's per-column dot loop
    (GMRES.hpp:203-208).  Returns ``(w, coefficients, norm of w)``, all
    tensors on ``w``'s device."""
    c1 = Vm @ w
    w = w - c1 @ Vm
    c2 = Vm @ w
    w = w - c2 @ Vm
    return w, c1 + c2, torch.linalg.vector_norm(w)


def _apply_plane_rotations(h, cs, sn, i):
    """Apply accumulated Givens rotations to column h (ref GMRES.hpp:82-116)."""
    for k in range(i):
        t = cs[k] * h[k] + sn[k] * h[k + 1]
        h[k + 1] = -sn[k] * h[k] + cs[k] * h[k + 1]
        h[k] = t
    return h


def _gen_rotation(dx, dy):
    if dy == 0.0:
        return 1.0, 0.0
    if abs(dy) > abs(dx):
        t = dx / dy
        sn = 1.0 / np.sqrt(1.0 + t * t)
        return t * sn, sn
    t = dy / dx
    cs = 1.0 / np.sqrt(1.0 + t * t)
    return cs, t * cs


def gmres(
    matvec: Callable,
    b,
    x0=None,
    config: Optional[SolverConfig] = None,
    M: Optional[Callable] = None,
    p_fixed: Optional[int] = None,
    flexible: bool = False,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
):
    """Solve A x = b with right-preconditioned restarted GMRES (the host
    loop).

    Parameters
    ----------
    matvec : callable ``(x, p) -> A@x`` evaluated at truncation order p
        (an FmmPlan-backed operator; a dense operator may ignore p).
    b : right-hand side; a tensor's device and dtype are the solve's
        (numpy becomes a CPU tensor).  The basis lives there; ``H``,
        ``cs``, ``sn`` and ``s`` are numpy f64.
    M : right preconditioner callable ``(r) -> z`` (default identity).
    flexible : FGMRES — store Z = M(V) columns so a varying/nonlinear
        preconditioner is applied consistently (ref GMRES.hpp:276-380).
    p_fixed : disable relaxation and use this order for every matvec
        (the reference's ``-fixed_p`` flag, LaplaceBEM.cpp:120).
    checkpoint_path : if set, the full Krylov state is saved there every
        ``checkpoint_every`` inner iterations; a matching checkpoint at
        this path is resumed from (and the remaining iterations replay
        bit-identically).  Removed on convergence.
    Returns ``(x, SolveInfo)`` with ``x`` a tensor on ``b``'s device.
    """
    cfg = config or SolverConfig()
    b = torch.as_tensor(b)
    n = b.shape[0]
    dt, dev = b.dtype, b.device

    def vec(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    x = torch.zeros_like(b) if x0 is None else vec(x0)
    if M is None:
        M = lambda r: r

    normb = float(torch.linalg.vector_norm(b))
    if normb == 0.0:
        normb = 1.0

    history = []
    total_it = 0
    resid = 1.0

    restart = int(min(cfg.restart, cfg.max_iters, n))

    # relaxation stall guard: when the last STALL_WIN iterations
    # improved the residual by less than 1 / STALL_FACTOR, raise the
    # scheduled order.  The boost is sticky within the solve.
    relaxed = p_fixed is None and cfg.variable_p
    p_boost = 0
    r_hist = []

    resume = _load_krylov_ckpt(checkpoint_path, "host", n)
    if resume is not None:
        x = vec(resume["x"])
        total_it = int(resume["total_it"])

    def _ckpt_done():
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)

    while total_it < cfg.max_iters:
        if resume is not None:
            # mid-cycle resume: restore the Arnoldi state (re-padded to
            # this run's buffer shapes — see _embed)
            Vbuf = vec(resume["V"])
            Z = [vec(zr) for zr in resume["Z"]] if flexible else []
            H = _embed(resume["H"], (restart + 1, restart))
            cs = _embed(resume["cs"], (restart + 1,))
            sn = _embed(resume["sn"], (restart + 1,))
            s = _embed(resume["s"], (restart + 1,))
            i_start = int(resume["i_next"])
            resid = float(resume["resid"])
            resume = None
        else:
            # full-accuracy residual at (re)start (ref GMRES.hpp:175-182)
            r = b - vec(matvec(x, cfg.max_p))
            beta = float(torch.linalg.vector_norm(r))
            resid = beta / normb
            if resid < cfg.residual:
                _ckpt_done()
                return x, SolveInfo(total_it, resid, True, history)

            # the basis grows by doubling: the default restart of 500
            # would otherwise pin a [501, n] basis for a 5-iteration solve
            cap = min(restart + 1, 33)
            Vbuf = torch.zeros((cap, n), dtype=dt, device=dev)
            Vbuf[0] = r / beta
            Z = []
            H = np.zeros((restart + 1, restart))
            cs = np.zeros(restart + 1)
            sn = np.zeros(restart + 1)
            s = np.zeros(restart + 1)
            s[0] = beta
            i_start = 0

        # columns of H computed in this cycle.  The reference
        # back-substitutes i + 1 columns, one too many when max_iters
        # stops the cycle before its end (a zero pivot: nan, or an
        # IndexError in the flexible update); the port counts them
        m = i_start
        for i in range(i_start, restart):
            if total_it >= cfg.max_iters:
                break
            if i + 1 >= Vbuf.shape[0]:  # grow the basis by doubling
                grow = min(Vbuf.shape[0], restart + 1 - Vbuf.shape[0])
                Vbuf = torch.cat(
                    [Vbuf, torch.zeros((grow, n), dtype=dt, device=dev)]
                )
            # relaxation: the order from the current residual; the stall
            # boost goes through schedule_p so it lands on a tier
            p = cfg.schedule_p(resid, p_fixed, boost=p_boost)
            z = M(Vbuf[i])
            if flexible:
                Z.append(z)
            w, coeffs, bnorm = _project(Vbuf[: i + 1], vec(matvec(z, p)))
            # the iteration's one device->host transfer
            host = torch.cat([coeffs, bnorm[None]]).cpu().numpy()
            H[: i + 1, i] = host[:-1]
            H[i + 1, i] = float(host[-1])
            if H[i + 1, i] > 1e-300:
                Vbuf[i + 1] = w / H[i + 1, i]
            else:
                Vbuf[i + 1] = w

            # Givens update (ref GMRES.hpp:218-220)
            h = _apply_plane_rotations(H[: i + 2, i].copy(), cs, sn, i)
            cs[i], sn[i] = _gen_rotation(h[i], h[i + 1])
            h[i], h[i + 1] = cs[i] * h[i] + sn[i] * h[i + 1], 0.0
            H[: i + 2, i] = h
            s[i + 1] = -sn[i] * s[i]
            s[i] = cs[i] * s[i]
            resid = abs(s[i + 1]) / normb
            total_it += 1
            m = i + 1
            history.append((total_it, resid, p))
            if relaxed and resid >= cfg.residual:
                r_hist.append(resid)
                if (
                    len(r_hist) > STALL_WIN
                    and resid > STALL_FACTOR * r_hist[-1 - STALL_WIN]
                    and p < cfg.max_p
                ):
                    p_boost += 2
                    r_hist.clear()
            if verbose:
                print(f"it: {total_it:4d}  res: {resid:.3e}  fmm_req_p: {p}")
            if checkpoint_path is not None and (
                total_it % checkpoint_every == 0
            ):
                V_host = Vbuf.cpu().numpy()
                _save_krylov_ckpt(
                    checkpoint_path,
                    "host",
                    n=n,
                    x=x.cpu().numpy(),
                    V=V_host,
                    Z=torch.stack(Z).cpu().numpy()
                    if Z
                    else np.zeros((0, n), V_host.dtype),
                    H=H,
                    cs=cs,
                    sn=sn,
                    s=s,
                    i_next=i + 1,
                    total_it=total_it,
                    resid=resid,
                )
            if resid < cfg.residual:
                break

        # back-substitution and update (ref GMRES.hpp:230-243)
        if m > 0:
            y = np.zeros(m)
            for k in range(m - 1, -1, -1):
                y[k] = (s[k] - H[k, k + 1 : m] @ y[k + 1 : m]) / H[k, k]
            if flexible:
                for k in range(m):
                    x = x + float(y[k]) * Z[k]
            else:
                x = x + M(vec(y) @ Vbuf[:m])
        if resid < cfg.residual:
            _ckpt_done()
            return x, SolveInfo(total_it, resid, True, history)

    return x, SolveInfo(total_it, resid, False, history)


def fgmres(matvec, b, **kw):
    """Flexible GMRES, the host loop (ref GMRES.hpp:276-380)."""
    return gmres(matvec, b, flexible=True, **kw)


class DeviceGmresContext:
    """State reusable across solves (the analogue of the reference's
    GMRESContext, GMRES.hpp:36-63): the per-order operands, looked up
    once per (operator, order) instead of once per iteration."""

    def __init__(self):
        #: operand per (operand_for_p, order), filled on first use
        self.operands = {}


def _device_predict_p(resid, cfg, boost=0):
    """SolverConfig.schedule_p (SolverOptions.hpp:25-38) evaluated in
    the dtype of ``resid`` (a numpy scalar of the solve's working
    dtype), including the calibrated eps(p) = c * gamma**p model.

    Order of operations mirrors the host schedule exactly — floor at
    p_min, add the stall boost, clamp, THEN quantise to p_tiers.  The
    rounding ``ceil(-log2(nu))`` happens in the working dtype, so an
    f32 solve picks the order an f32 residual gives at a boundary."""
    ft = type(resid)
    eps = min(resid, ft(1.0))
    with np.errstate(divide="ignore", over="ignore"):
        if cfg.relax_type is RelaxType.BOURAS:
            nu = min(ft(cfg.residual) / eps, ft(1.0)) if eps > 0 else ft(1.0)
        else:
            nu = eps
        nu = max(nu, ft(1e-300))
        if cfg.eps_c is not None and cfg.eps_gamma is not None:
            raw = np.ceil(
                np.log(nu / ft(cfg.eps_c)) / ft(math.log(cfg.eps_gamma))
            )
            # never extrapolate the calibrated fit below its probed range
            lo = float(cfg.eps_p_lo or 1)
            p = max(1.0 if nu >= cfg.eps_c else float(raw), lo)
        else:
            raw = np.ceil(-np.log2(nu))
            p = 1.0 if nu >= 1.0 else float(raw)
    # floor at p_min to mirror SolverConfig.schedule_p (the reference's
    # Stokes relaxation floor, GMRES_Stokes.hpp:229)
    p = int(min(max(p, max(1, cfg.p_min)), cfg.max_p))
    p = min(p + int(boost), cfg.max_p)
    return cfg.quantize_p(p)


def gmres_device(
    matvec: Callable,
    b,
    operand_for_p: Optional[Callable] = None,
    x0=None,
    config: Optional[SolverConfig] = None,
    M: Optional[Callable] = None,
    p_fixed: Optional[int] = None,
    flexible: bool = False,
    verbose: bool = False,
    context: Optional[DeviceGmresContext] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 16,
):
    """Device-resident restarted GMRES/FGMRES with p-relaxation.

    Parameters
    ----------
    matvec : ``(operand, x, p) -> A@x`` on tensors of ``b``'s device.
    b : right-hand side tensor; its device and dtype are the solve's.
    operand_for_p : host callable ``p -> operand`` (plan device tables
        are sliced per order); default returns ``None``.
    M : right preconditioner ``z = M(r)`` on device tensors (default
        identity).
    checkpoint_path : if set, the Krylov state is pulled to the host
        and saved there at block exits; a block runs at most
        ``checkpoint_every`` iterations so a checkpoint lands at least
        every that many.  A matching checkpoint is resumed from
        (bit-identical replay).  Removed on convergence.
    Returns ``(x, SolveInfo)`` with ``x`` a tensor on ``b``'s device.
    """
    cfg = config or SolverConfig()
    ctx = context if context is not None else DeviceGmresContext()
    b = torch.as_tensor(b)
    n = b.shape[0]
    dt, dev = b.dtype, b.device
    ft = np.float32 if dt == torch.float32 else np.float64
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(
        x0, dtype=dt, device=dev
    )
    if M is None:
        M = lambda r: r
    if operand_for_p is None:
        operand_for_p = lambda p: None

    def operand(p):
        key = (operand_for_p, p)
        if key not in ctx.operands:
            ctx.operands[key] = operand_for_p(p)
        return ctx.operands[key]

    restart = int(min(cfg.restart, cfg.max_iters, n))
    relaxed = p_fixed is None and cfg.variable_p
    p_boost = 0     # continuous schedule: sticky stall boost
    min_idx = 0     # tiered schedule: sticky floor tier
    tiny = ft(np.finfo(ft).tiny * 1e3)
    stop_tol = ft(cfg.residual)
    tiers = tuple(sorted({min(t, cfg.max_p) for t in (cfg.p_tiers or ())}))
    use_tiers = relaxed and len(tiers) >= 1
    raw_cfg = dataclasses.replace(cfg, p_tiers=None)

    def arnoldi(w, st):
        """One Arnoldi iteration given the new Krylov vector w: the
        projection against the live rows of the basis on the device
        (``_project``), then the Givens update of column i on the
        host."""
        i = st["i"]
        w, coeffs, hn_t = _project(st["V"][: i + 1], w)
        # the iteration's one device->host transfer
        host = torch.cat([coeffs, hn_t[None]]).cpu().numpy()
        hn = host[-1]
        st["V"][i + 1] = w / max(hn, tiny)
        col = np.zeros(restart + 1, ft)
        col[: i + 1] = host[:-1]
        col[i + 1] = hn
        cs, sn, s = st["cs"], st["sn"], st["s"]
        _apply_plane_rotations(col, cs, sn, i)
        dx_, dy_ = col[i], col[i + 1]
        r_ = np.sqrt(dx_ * dx_ + dy_ * dy_)
        ci = dx_ / max(r_, tiny) if r_ > 0 else ft(1.0)
        si = dy_ / max(r_, tiny) if r_ > 0 else ft(0.0)
        col[i], col[i + 1] = r_, 0.0
        cs[i], sn[i] = ci, si
        st["H"][:, i] = col
        s_i = s[i]
        s[i + 1] = -si * s_i
        s[i] = ci * s_i
        st["i"] = i + 1
        st["resid"] = ft(abs(s[i + 1]) / st["normb"])

    def step(st, p):
        """Krylov vector i through the preconditioner and the order-p
        operator, then one Arnoldi update."""
        z = M(st["V"][st["i"]])
        if flexible:
            st["Z"][st["i"]] = z
        arnoldi(matvec(operand(p), z, p), st)

    def run_tiered(st, cap, it_left):
        """A block of the tiered schedule: the order is chosen per
        iteration; a stalled window raises the floor tier (sticky) and
        starts a new window.  Returns the orders used."""
        nonlocal min_idx
        r_buf = [math.inf] * STALL_WIN
        k = 0
        used = []
        while st["i"] < cap - 1 and it_left > 0 and st["resid"] >= stop_tol:
            p_raw = _device_predict_p(st["resid"], raw_cfg, 0)
            idx = min(int(np.searchsorted(tiers, p_raw, side="left")),
                      len(tiers) - 1)
            idx = max(idx, min_idx)
            step(st, tiers[idx])
            used.append(tiers[idx])
            it_left -= 1
            resid = st["resid"]
            old = r_buf[k % STALL_WIN]
            if (k >= STALL_WIN and resid > ft(STALL_FACTOR) * old
                    and resid >= stop_tol):
                min_idx = min(min_idx + 1, len(tiers) - 1)
                r_buf = [math.inf] * STALL_WIN
                k = 0
            else:
                r_buf[k % STALL_WIN] = resid
                k += 1
        return used

    def run_tier(st, p, cap, it_left):
        """A block at one order: it ends when the schedule (plus any
        stall boost) asks for a smaller order, or on a stall.  Returns
        (steps, stalled)."""
        r_buf = [math.inf] * STALL_WIN
        k = 0
        stalled = False
        steps = 0
        while st["i"] < cap - 1 and it_left > 0 and st["resid"] >= stop_tol:
            if relaxed and (
                stalled or _device_predict_p(st["resid"], cfg, p_boost) < p
            ):
                break
            step(st, p)
            steps += 1
            it_left -= 1
            if relaxed:
                resid = st["resid"]
                old = r_buf[k % STALL_WIN]
                stalled = bool(
                    k >= STALL_WIN and resid > ft(STALL_FACTOR) * old
                    and resid >= stop_tol
                )
                r_buf[k % STALL_WIN] = resid
                k += 1
        return steps, stalled

    def finish(st, x):
        """Back-substitution of the m = i live columns and the update
        of x."""
        m = st["i"]
        if m == 0:
            return x
        y = np.linalg.solve(
            np.triu(st["H"][:m, :m]).astype(np.float64),
            st["s"][:m].astype(np.float64),
        ).astype(ft)
        y_t = torch.as_tensor(y, device=dev)
        if flexible:
            return x + y_t @ st["Z"][:m]
        return x + M(y_t @ st["V"][:m])

    def true_resid(x):
        r = b - matvec(operand(cfg.max_p), x, cfg.max_p)
        return r, float(torch.linalg.vector_norm(r))

    normb = float(torch.linalg.vector_norm(b))
    if normb == 0.0:
        normb = 1.0

    history = []
    total_it = 0
    resid = 1.0

    resume = _load_krylov_ckpt(checkpoint_path, "device", n)
    if resume is not None:
        x = torch.as_tensor(resume["x"], dtype=dt, device=dev)
        total_it = int(resume["total_it"])

    def _ckpt_done():
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)

    def to_dev(a, shape):
        return torch.as_tensor(_embed(a, shape), dtype=dt, device=dev)

    while total_it < cfg.max_iters:
        if resume is not None:
            # resume at the checkpoint's basis capacity (>= i+2: the
            # state was saved after writing row i+1), but never past a
            # full cycle: a state saved at i == restart goes straight
            # to the back-substitution
            cap = min(
                max(int(np.asarray(resume["V"]).shape[0]),
                    int(resume["i"]) + 2),
                restart + 1,
            )
            st = {
                "V": to_dev(resume["V"], (cap, n)),
                "Z": to_dev(resume["Z"], (cap if flexible else 1, n)),
                "H": _embed(resume["H"], (restart + 1, restart)).astype(ft),
                "cs": _embed(resume["cs"], (restart + 1,)).astype(ft),
                "sn": _embed(resume["sn"], (restart + 1,)).astype(ft),
                "s": _embed(resume["s"], (restart + 1,)).astype(ft),
                "i": int(resume["i"]),
                "resid": ft(resume["resid"]),
                "normb": ft(normb),
            }
            resid = float(st["resid"])
            resume = None
        else:
            r, beta = true_resid(x)
            resid = beta / normb
            if resid < cfg.residual:
                _ckpt_done()
                return x, SolveInfo(total_it, resid, True, history)

            # the basis grows by doubling: the default restart of 500
            # would otherwise pin a [501, n] basis for a 5-iteration solve
            cap = min(restart + 1, 33)
            st = {
                "V": torch.zeros((cap, n), dtype=dt, device=dev),
                "Z": torch.zeros(
                    (cap if flexible else 1, n), dtype=dt, device=dev
                ),
                "H": np.zeros((restart + 1, restart), ft),
                "cs": np.zeros(restart + 1, ft),
                "sn": np.zeros(restart + 1, ft),
                "s": np.zeros(restart + 1, ft),
                "i": 0,
                "resid": ft(resid),
                "normb": ft(normb),
            }
            st["V"][0] = r / beta
            st["s"][0] = beta

        while True:
            block = cfg.max_iters - total_it
            if checkpoint_path is not None:
                block = min(block, checkpoint_every)
            i_old = st["i"]
            resid_prev = resid
            stalled = False
            if use_tiers:
                p_of = run_tiered(st, cap, block)
                steps = len(p_of)
                p = p_of[-1] if steps else None
            else:
                p = cfg.schedule_p(resid, p_fixed, boost=p_boost)
                steps, stalled = run_tier(st, p, cap, block)
                p_of = [p] * steps
            resid = float(st["resid"])
            # per-iteration history from the rotation sines:
            # |s_{k+1}| = |sn_k| * |s_k|, seeded by the residual
            # numerator at block entry (mirrors the reference's
            # per-iteration print, GMRES.hpp:225)
            run = resid_prev * normb
            for k, snk in enumerate(st["sn"][i_old: st["i"]]):
                run *= abs(float(snk))
                history.append((total_it + k + 1, run / normb, p_of[k]))
            total_it += steps
            if (
                not use_tiers
                and relaxed
                and stalled
                and resid >= cfg.residual
                and p < cfg.max_p
            ):
                p_boost += 2
            if verbose and steps:
                print(
                    f"it: {total_it:4d}  res: {resid:.3e}  fmm_req_p: {p}"
                )
            if checkpoint_path is not None and steps:
                _save_krylov_ckpt(
                    checkpoint_path,
                    "device",
                    n=n,
                    x=x.cpu().numpy(),
                    V=st["V"].cpu().numpy(),
                    Z=st["Z"].cpu().numpy(),
                    H=st["H"],
                    cs=st["cs"],
                    sn=st["sn"],
                    s=st["s"],
                    i=st["i"],
                    total_it=total_it,
                    resid=resid,
                )
            if resid < cfg.residual or total_it >= cfg.max_iters:
                break
            if st["i"] >= cap - 1:
                if cap >= restart + 1:
                    break
                # grow the basis by doubling and continue the SAME
                # Krylov cycle
                new_cap = min(2 * cap, restart + 1)
                grow = torch.zeros((new_cap - cap, n), dtype=dt, device=dev)
                st["V"] = torch.cat([st["V"], grow])
                if flexible:
                    st["Z"] = torch.cat([st["Z"], grow])
                cap = new_cap
                continue
            if steps == 0:
                break

        x = finish(st, x)
        if resid < cfg.residual:
            # trust-but-verify: the true residual at full p confirms
            # convergence before returning
            r, beta = true_resid(x)
            resid = beta / normb
            if resid < cfg.residual:
                _ckpt_done()
                return x, SolveInfo(total_it, resid, True, history)
            # the Givens estimate passed but the true residual did not:
            # direct evidence the inexact-matvec schedule was too
            # optimistic for this system — raise the order for the
            # restarted cycle (sticky, like the stall boost)
            if relaxed and p_boost < cfg.max_p:
                p_boost += 2
            if use_tiers:
                min_idx = min(min_idx + 1, len(tiers) - 1)

    return x, SolveInfo(total_it, resid, False, history)


def fgmres_device(matvec, b, **kw):
    """Flexible device-resident GMRES."""
    return gmres_device(matvec, b, flexible=True, **kw)
