"""Faults planted in the program where it produces its answers, to
read how the numbers of ``correct`` see them (``control.py``) and to
test that a run sees them (``tests/test_bench_h100_faults.py``).

- ``unchanged``: the state comes back as it started: a solve returns
  its initial guess (zeros), an apply returns zeros;
- ``half``: an apply leaves out the second half of the points (their
  rows read 0);
- ``altered``: every answer is changed where it is produced: each
  solution, or each apply's potential and field, scaled by 1 + 1e-2.

Every cell runs on one card: there is no exchange between cards to
leave out.
"""

import contextlib

import torch

ALTERATION = 1e-2

FAULTS = {"solve": ("unchanged", "altered"),
          "apply": ("unchanged", "half", "altered")}


@contextlib.contextmanager
def planted(fault, operation):
    """Plant ``fault`` for the operation ``operation`` (``solve`` or
    ``apply``) while the context is open."""
    if fault not in FAULTS[operation]:
        raise ValueError(f"no fault {fault!r} for {operation!r}")
    if operation == "solve":
        from fmm_bem_tpu_torch.solver import api as owner

        name = "solve_plan"
        real = owner.solve_plan

        def broken(*a, **k):
            x, info, mode = real(*a, **k)
            if fault == "unchanged":
                x = x * 0.0
            else:
                x = x * (1.0 + ALTERATION)
            return x, info, mode
    else:
        from fmm_bem_tpu_torch.executor.plan import FmmPlan as owner

        name = "apply"
        real = owner.apply

        def broken(self, *a, **k):
            out = real(self, *a, **k)
            if fault == "unchanged":
                return torch.zeros_like(out)
            if fault == "half":
                out = out.clone()
                out[out.shape[0] // 2:] = 0.0
                return out
            return out * (1.0 + ALTERATION)

    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, real)
