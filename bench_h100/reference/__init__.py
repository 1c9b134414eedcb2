"""Plain references that decide ``correct``.

Plain PyTorch and NumPy.  Nothing here imports ``fmm_bem_tpu_torch``,
``jax`` or the JAX package, and nothing takes a table the program made:
each reference starts from the inputs the benchmark generated
(triangles, points, charges, boundary data) and works out the rest.
"""
