"""The benchmark of ``fmm_bem_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json``; ``README.md`` says how
to run it and how to add a configuration, a traffic mix or a metric.
Nothing here imports ``jax`` or the JAX package, and nothing under
``reference/`` imports ``fmm_bem_tpu_torch``.
"""
