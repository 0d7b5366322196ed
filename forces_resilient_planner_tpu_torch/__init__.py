"""PyTorch + CUDA port of forces_resilient_planner_tpu.

Mirrors the JAX package's subpackage and module names and its lane-major
layouts.  Imports torch, never jax.  The route of every kernel is decided
by the tensor's device: a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises.
"""
