"""Configuration tree: a re-export of forces_resilient_planner_tpu.config.

That module imports only numpy and the standard library (and the JAX
package's __init__ is empty), so importing it here pulls in no jax.  The
port and the reference therefore read the very same dataclasses.
"""
from forces_resilient_planner_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG,
    CorridorConfig,
    FSMConfig,
    MapConfig,
    ModelConfig,
    PlannerConfig,
    SearchConfig,
    SolverConfig,
    TubeConfig,
    WeightConfig,
)
