"""The reference's example programs on the PyTorch port: the Laplace,
Stokes and Yukawa BEM programs and the point programs ``serialrun``
and ``scaling``, with the flags and printed checks of
``examples/*.py``.  Each runs as ``python -m
fmm_bem_tpu_torch.examples.<name> ...`` (on the GPU by default; ``-cpu``
runs it on the host) and takes ``main(argv=None)``, which returns what
it printed as a dict: errors and times, with the iterations, the order
schedule and the plan for the BEM programs, the plan for
``serialrun``."""
