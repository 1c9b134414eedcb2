"""The reference's BEM example programs on the PyTorch port: Laplace,
Stokes and Yukawa BEM programs with the flags and printed checks of
``examples/*.py``.  Each runs as ``python -m
fmm_bem_tpu_torch.examples.<name> ...`` (on the GPU by default; ``-cpu``
runs it on the host) and takes ``main(argv=None)``, which returns the
printed errors, the iterations, the order schedule and the plan it
built."""
