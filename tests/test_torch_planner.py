"""Port parity: the single-robot planner of the torch port (engine/
planner.py::ResilientPlanner, with engine/simulator.py::run_closed_loop and
engine/depth_camera.py) on the CPU at f64, in tests/test_closed_loop.py's
configuration.

The non-slow tests of tests/test_closed_loop.py on the port: no odometry
means no motion, the panic stop, the goal relocation in the reference's
loop order and the batched trajectory recheck.  Then 0.5 s of
run_closed_loop (hover to goal) against the JAX planner, and the synthetic
depth camera.

Stated tolerances: the FSM transitions identical; the 100 Hz commands
within 1e-5 (their positions, velocities, accelerations, body rates,
yaw and thrust), and the plant positions within 1e-5; the depth images
bit-equal; three depth frames mapped into bit-equal log-odds buffers."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.engine import depth_camera as jcam
from forces_resilient_planner_tpu.engine import planner as jplan
from forces_resilient_planner_tpu.engine import simulator as jsim
from forces_resilient_planner_tpu_torch.engine import depth_camera as tcam
from forces_resilient_planner_tpu_torch.engine import planner as tplan
from forces_resilient_planner_tpu_torch.engine import simulator as tsim
from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.mapping import occ_grid as tog
from test_closed_loop import CFG as JCFG
from _torch_threads import one_torch_thread  # noqa: F401

CFG = workloads.closed_loop_cfg()     # held equal to JCFG by test_torch_config
F64 = torch.float64


def make_stack(start=(0.0, 0.0, 1.2), f_true=(0.0, 0.0, 0.0)):
    planner = tplan.ResilientPlanner(CFG, max_cloud=2048, dtype=F64,
                                     device="cpu")
    x0 = np.zeros(9)
    x0[0:3] = start
    sim = tsim.QuadSim(CFG.model, x0.copy(), np.asarray(f_true, float))
    planner.on_odometry(x0)
    return planner, sim


def test_fsm_no_odom_no_motion():
    planner = tplan.ResilientPlanner(CFG, max_cloud=512, dtype=F64,
                                     device="cpu")
    planner.set_goal([1.0, 0.0])
    planner.tick_fsm(0.0)
    assert planner.state == tplan.FSMState.INIT
    assert planner.get_command(0.0) is None


def test_panic_stop_on_huge_force():
    planner, _ = make_stack()
    planner.consider_force = True
    planner.have_target = True
    planner.on_external_force(np.array([12.0, 0.0, 0.0]))
    assert planner.state == tplan.FSMState.WAIT_TARGET
    assert not planner.have_target


def test_goal_relocation_batched_scan_matches_loop_order():
    """The batched relocation scan picks exactly the candidate the
    reference's nested loop (radius, angle, z; nmpc_manage.cpp:285-327)
    picks with the single-point surround check."""
    planner, _ = make_stack()
    goal = np.array([2.0, 0.5])
    gx, gy, gz = goal[0], goal[1], 1.2
    xs = np.arange(gx - 0.5, gx + 0.5, 0.1)
    ys = np.arange(gy - 0.5, gy + 0.5, 0.1)
    zs = np.arange(0.2, 2.2, 0.1)
    xx, yy, zz = np.meshgrid(xs, ys, zs)
    planner.set_occupied(np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1))
    planner.set_goal(goal)

    def free(p, inflate):
        return bool(tog.check_pos_surround(
            planner.grid, torch.as_tensor(p, dtype=F64), inflate,
            CFG.tube.ego_r, CFG.tube.ego_h, CFG.map))

    assert not free([gx, gy, gz], CFG.fsm.goal_inflate)
    expected = None
    for r in np.arange(0.2, 1.2001, 0.2):
        for th in np.deg2rad(np.arange(-90, 271, 30)):
            for nz in np.arange(1.0, 1.6001, 0.2):
                cand = np.array(
                    [gx + r * math.cos(th), gy + r * math.sin(th), nz])
                if free(cand, CFG.fsm.goal_relocate_inflate):
                    expected = cand
                    break
            if expected is not None:
                break
        if expected is not None:
            break
    assert expected is not None

    planner.tick_safety(0.0)
    assert np.allclose(planner.end_pt, expected), (planner.end_pt, expected)
    assert planner.have_target
    rep = planner.diag.timing_report()
    assert rep["safety"]["n"] >= 1 and rep["safety"]["p99_ms"] > 0.0


def test_traj_recheck_batched():
    planner, _ = make_stack()
    planner.have_traj = True
    planner.state = tplan.FSMState.EXEC_TRAJ
    K = 40
    t = np.linspace(0, 2.0, K)
    planner.kino_path[:K] = np.stack(
        [1.5 * t, np.zeros(K), np.full(K, 1.2)], -1)
    planner.kino_size = K
    planner.tick_safety(0.0)
    assert planner.state == tplan.FSMState.EXEC_TRAJ

    ys = np.arange(-1.0, 1.0, 0.1)
    zs = np.arange(0.4, 2.2, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    planner.set_occupied(
        np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1))
    planner.tick_safety(0.1)
    assert planner.state == tplan.FSMState.REPLAN_TRAJ
    assert ("EXEC_TRAJ", "REPLAN_TRAJ", "safety-traj") in [
        tuple(x) for x in planner.diag.fsm_transitions]


def _fly(planner, sim, run, duration):
    cmds = []
    step = sim.step

    def logged(cmd, dt):
        cmds.append(cmd)
        step(cmd, dt)

    sim.step = logged
    trace = run(planner, sim, [2.0, 0.5], duration=duration)
    return trace, cmds


@pytest.fixture(scope="module")
def loops():
    x0 = np.zeros(9)
    x0[2] = 1.2
    jp = jplan.ResilientPlanner(JCFG, max_cloud=2048, dtype=jnp.float64)
    jp.on_odometry(x0)
    js = jsim.QuadSim(JCFG.model, x0.copy(), np.zeros(3))
    tp, ts = make_stack()
    want = _fly(jp, js, jsim.run_closed_loop, 0.5)
    got = _fly(tp, ts, tsim.run_closed_loop, 0.5)
    return want, got, jp, tp


def test_closed_loop_fsm_sequence_identical(loops):
    (jt, _), (tt, _), jp, tp = loops
    assert tt["state"] == jt["state"]
    assert tp.diag.fsm_transitions == jp.diag.fsm_transitions
    assert "EXEC_TRAJ" in tt["state"]
    assert tp.diag.solves == jp.diag.solves >= 5
    assert tp.diag.solve_failures == jp.diag.solve_failures
    assert tp.diag.replans == jp.diag.replans
    assert tp.kino_size == jp.kino_size > 0


def test_closed_loop_commands_within_1e5(loops):
    (jt, jc), (tt, tc), _, _ = loops
    assert len(tc) == len(jc)
    flying = 0
    for a, b in zip(tc, jc):
        assert (a is None) == (b is None)
        if a is None:
            continue
        flying += a.thrust > 0
        for f in dataclasses.fields(a):
            np.testing.assert_allclose(getattr(a, f.name), getattr(b, f.name),
                                       rtol=0, atol=1e-5, err_msg=f.name)
    assert flying > 20
    np.testing.assert_allclose(tt["pos"], jt["pos"], rtol=0, atol=1e-5)


def test_box_scene_camera_depth_equal():
    boxes = np.array([[[1.5, -8.0, 0.0], [1.7, 0.8, 2.6]],
                      [[1.5, 2.2, 0.0], [1.7, 8.0, 2.6]]])
    a = jcam.BoxSceneCamera(boxes, rows=48, cols=64, fov_x_deg=130.0)
    b = tcam.BoxSceneCamera(boxes, rows=48, cols=64, fov_x_deg=130.0)
    odom = np.array([0.2, 0.9, 1.1, 0.3, 0.0, 0.0, 0.05, -0.02, 0.1])
    R_ic = np.asarray(CFG.map.cam_R_ic, float)
    t_ic = np.asarray(CFG.map.cam_t_ic, float)
    da, Ra, ta = a.render_from_odom(odom, R_ic, t_ic)
    db, Rb, tb = b.render_from_odom(odom, R_ic, t_ic)
    np.testing.assert_array_equal(db, da)
    np.testing.assert_array_equal(Rb, Ra)
    np.testing.assert_array_equal(tb, ta)
    assert (db > 0).sum() > 100


def test_depth_frames_map_like_jax():
    """Three synthetic depth frames through on_depth_image, paired with
    odometry, the later two through the shift filter: the log-odds buffers
    bit-equal to the JAX planner's, the local obstacle clouds' masks
    identical and their points within 1e-12 (jitted XLA fuses a voxel
    center's (i + 0.5) res + origin into one multiply-add)."""
    boxes = np.array([[[1.5, -8.0, 0.0], [1.7, 0.8, 2.6]],
                      [[1.5, 2.2, 0.0], [1.7, 8.0, 2.6]]])
    cam = tcam.BoxSceneCamera(boxes, rows=48, cols=64, fov_x_deg=130.0)
    R_ic = np.asarray(CFG.map.cam_R_ic, float)
    t_ic = np.asarray(CFG.map.cam_t_ic, float)
    jp = jplan.ResilientPlanner(JCFG, max_cloud=2048, dtype=jnp.float64)
    tp = tplan.ResilientPlanner(CFG, max_cloud=2048, dtype=F64, device="cpu")
    for k, x in enumerate((0.0, 0.13, 0.26)):
        odom = np.array([x, 0.03, 1.2, 0.5, 0.0, 0.0, 0.0, 0.0, 0.02 * k])
        depth, _, _ = cam.render_from_odom(odom, R_ic, t_ic)
        for p in (jp, tp):
            p.on_odometry(odom, t_now=0.1 * k)
            p.on_depth_image(depth, 0.1 * k, *cam.intrinsics)
    assert tp._last_depth is not None
    np.testing.assert_array_equal(tp.grid.buffer.numpy(),
                                  np.asarray(jp.grid.buffer))
    np.testing.assert_array_equal(tp.obstacle_mask, jp.obstacle_mask)
    np.testing.assert_allclose(tp.obstacles, jp.obstacles, rtol=0, atol=1e-12)
    assert tp.obstacle_mask.sum() >= 20


def test_profile_trace_writes_a_trace(tmp_path):
    planner, _ = make_stack()
    planner.set_goal([2.0, 0.5])
    with planner.profile_trace(str(tmp_path)) as prof:
        planner.tick_safety(0.0)
    assert list(tmp_path.glob("*.json"))
    assert any("aten::" in e.key for e in prof.key_averages())
