"""The benchmark of forces_resilient_planner_tpu_torch on an NVIDIA H100:
BENCHMARK.json at the repository's root names its cells, and run.py runs
one cell once.  Imports nothing of JAX or of the JAX package."""
