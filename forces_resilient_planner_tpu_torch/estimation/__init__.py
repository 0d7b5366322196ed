from forces_resilient_planner_tpu_torch.estimation.force_estimator import (  # noqa: F401
    EstimatorState,
    MomentumForceEstimator,
    estimator_init,
    estimator_update,
)
