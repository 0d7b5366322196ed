"""The port's copies of the JAX package's numpy-only modules equal their
originals after the import rewrite, and behave alike on the same inputs;
the port's force estimator against the JAX package's at f64.

Stated tolerances: the copied sources identical after rewriting
`forces_resilient_planner_tpu.` to `forces_resilient_planner_tpu_torch.`;
the commander's 100 Hz interpolation and QuadSim.step bit-equal; the
estimator's force estimate within 1e-12 of JAX's on every step of a force
step, and its batched core within 1e-12."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import commander as jcmd
from forces_resilient_planner_tpu.engine import simulator as jsim
from forces_resilient_planner_tpu.estimation import force_estimator as jest
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as TC
from forces_resilient_planner_tpu_torch.engine import commander as tcmd
from forces_resilient_planner_tpu_torch.engine import simulator as tsim
from forces_resilient_planner_tpu_torch.estimation import (
    force_estimator as tfe,
)
from _torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
COPIES = ("engine/commander.py", "utils/timing.py", "engine/simulator.py",
          "corridor/geometry.py", "corridor/msgs.py", "utils/scene.py",
          "engine/depth_camera.py")


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_original_after_the_import_rewrite(module):
    orig = (REPO / "forces_resilient_planner_tpu" / module).read_text()
    copy = (REPO / "forces_resilient_planner_tpu_torch" / module).read_text()
    want = orig.replace("forces_resilient_planner_tpu.",
                        "forces_resilient_planner_tpu_torch.")
    assert copy == want
    assert "forces_resilient_planner_tpu." not in copy


def test_commander_interpolation_equal():
    rng = np.random.default_rng(2)
    out = rng.normal(0, 0.5, (C.model.N + 1, 17))
    out[:, 3] += 7.3
    for t in np.concatenate([rng.uniform(-0.1, 1.1, 200), [0.0, 0.05]]):
        a = jcmd.interpolate_command(out, t, C.model)
        b = tcmd.interpolate_command(out, t, TC.model)
        assert (a is None) == (b is None)
        if a is not None:
            for f in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(b, f.name),
                                              getattr(a, f.name))
    assert tcmd.init_yaw_rate(0.1, 3.0, 1.2) == jcmd.init_yaw_rate(0.1, 3.0, 1.2)


def test_quadsim_step_equal():
    rng = np.random.default_rng(3)
    x0 = np.zeros(9)
    x0[2] = 1.2
    f = np.array([0.4, -0.2, 0.1])
    a = jsim.QuadSim(C.model, x0.copy(), f.copy(), rate_tau=0.02)
    b = tsim.QuadSim(TC.model, x0.copy(), f.copy(), rate_tau=0.02)
    for k in range(200):
        q = rng.normal(0, 0.3, 17)
        q[3] = 7.3 + rng.normal(0, 0.5)
        cmd_a = jcmd.Command(pos=q[8:11], vel=q[11:14], acc=np.zeros(3),
                             body_rates=q[0:3], yaw=q[16], rpy=q[14:17],
                             thrust=q[3] if k % 50 else 0.0)
        cmd_b = tcmd.Command(**dataclasses.asdict(cmd_a))
        a.step(cmd_a, 0.01)
        b.step(cmd_b, 0.01)
        np.testing.assert_array_equal(b.state, a.state)


def _hover():
    return np.array([0.0, 0.0, 0.0, C.model.mass * C.model.g])


def test_estimator_tracks_a_force_step_like_jax():
    """tests/test_estimation.py's force step, both estimators fed the same
    samples: within 1e-12 of each other on every step, converged to the
    step."""
    ja = jest.MomentumForceEstimator(C.model, bandwidth=10.0)
    tb = tfe.MomentumForceEstimator(TC.model, bandwidth=10.0, device="cpu")
    x = np.zeros(9)
    x[2] = 1.2
    u, dt, f_true = _hover(), 0.01, np.zeros(3)
    worst = 0.0
    for k in range(600):
        if k == 300:
            f_true = np.array([2.0, 0.0, 0.0])
        fa = ja.update(x, u, dt)
        fb = tb.update(x, u, dt)
        worst = max(worst, np.abs(fa - fb).max())
        x = x + dt * jsim._dynamics(x, u, f_true, C.model)
    assert worst <= 1e-12, worst
    assert np.linalg.norm(tb.f_hat - f_true) < 0.1
    tb.sync(x)
    ja.sync(x)
    np.testing.assert_allclose(tb.f_hat, ja.f_hat, rtol=0, atol=1e-12)


def test_estimator_batched_core_matches_jax():
    B = 8
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.3, (B, 9))
    x2 = x + rng.normal(0, 0.01, (B, 9))
    u = np.tile(_hover(), (B, 1)) + rng.normal(0, 0.1, (B, 4))
    st = jest.estimator_init(jnp.asarray(x[:, 3:6]))
    st = jax.jit(lambda s, a, b: jest.estimator_update(s, a, b, 0.01, C.model,
                                                        10.0))(
        st, jnp.asarray(x2), jnp.asarray(u))
    tt = tfe.estimator_init(torch.as_tensor(x[:, 3:6]))
    tt = tfe.estimator_update(tt, torch.as_tensor(x2), torch.as_tensor(u),
                                0.01, TC.model, 10.0)
    for a, b in zip(tt, st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
