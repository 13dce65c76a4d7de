"""The benchmark of ``aec_tpu_torch`` on NVIDIA H100 cards: the cells that
``BENCHMARK.json`` names, their traffic, the plain references that decide
``correct``, and the counts and readers of the per-layer metrics. It imports
the program only to drive it, and neither JAX nor the JAX package."""
