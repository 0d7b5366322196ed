"""Port parity: solver/forces_api.py of the torch port against the JAX
package's FORCES surface at f64 on the CPU.

The same flat structs (packed by both modules, compared exactly) go through
both solvers: JAX solves with its per-lane ipm.solve, the port with B = 1
of its lane-major solver, so the bars are those of tests/test_ipm_lanes.py
(different sum order only): unpack_params within 1e-12; exitflag and
info.it identical; Z within 1e-8 (1 + |ref|); res_eq, res_ineq, rdgap and
pobj within 1e-8 relative (to 1 + |ref|).  Also the four checks of
tests/test_forces_api.py on the port alone, and a predictor-corrector
configuration against JAX's."""
import dataclasses

import numpy as np
import pytest
import torch

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.solver import forces_api as jf
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as TC
from forces_resilient_planner_tpu_torch.solver import forces_api as tf
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu_torch.solver.problems import (
    box_corridor,
    hover_to_goal_params,
    hover_warm_start,
)
from forces_resilient_planner_tpu_torch.tube import lyapunov

F64 = torch.float64
X0 = np.array([0, 0, 1.2, 0, 0, 0, 0, 0, 0], float)


def _packed_problem(api, goal, f_ext, tube_E=None, final_weights=False):
    """The JAX test's packing, through `api` (either module)."""
    W = TC.weights
    params = api.ForcesParams()
    params.xinit[:] = X0
    if final_weights:
        api.set_stage_weights(params, W.w_final_stage_wp,
                              W.w_final_stage_input, W.w_input_rate,
                              W.w_final_terminal_wp,
                              W.w_final_terminal_input)
    else:
        api.set_stage_weights(params, W.w_stage_wp, W.w_stage_input,
                              W.w_input_rate, W.w_terminal_wp,
                              W.w_terminal_input)
    A, b = box_corridor(0.5 * (X0[:3] + goal), np.array([5.0, 5.0, 2.0]),
                        TC.model.N, device="cpu")
    yaw = np.arctan2(goal[1] - X0[1], goal[0] - X0[0])
    api.pack_stage_params(
        params, np.tile(goal[None], (api.N, 1)), np.full(api.N, yaw),
        np.asarray(f_ext, float), A.numpy(), b.numpy(), tube_E=tube_E,
    )
    Z0 = hover_warm_start(torch.as_tensor(X0, dtype=F64), TC.model)
    api.pack_warm_start(params, Z0.numpy())
    return params


def _migration_E():
    """The migration example's tube: E of the hover warm start's tubes."""
    Z = hover_warm_start(torch.as_tensor(X0, dtype=F64), TC.model)
    K = torch.as_tensor(TC.tube.K, dtype=F64)
    return lyapunov.propagate_tubes(Z, TC.model, TC.tube, K).E.numpy()


PROBLEMS = {
    # the migration example's problem: tube-tightened box, wind estimate
    "migration": (np.array([2.0, 1.0, 1.2]), [0.5, 0.0, 0.0], True),
    # hover to goal with a constant external force
    "hover_force": (np.array([1.5, 0.8, 1.2]), [0.4, -0.2, 0.0], False),
}


def _problem(api, name):
    goal, f, tube = PROBLEMS[name]
    return _packed_problem(api, goal, f, _migration_E() if tube else None)


@pytest.fixture(scope="module")
def solves():
    """(problem, profile) -> (JAX (out, flag, info), port (out, flag, info))."""
    out = {}
    for name in PROBLEMS:
        for profile in ("normal", "final"):
            ref = jf.ForcesSolver(profile).solve(_problem(jf, name))
            got = tf.ForcesSolver(profile, device="cpu").solve(
                _problem(tf, name))
            out[name, profile] = ref, got
    return out


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def test_packing_identical_to_jax():
    for name in PROBLEMS:
        a, b = _problem(tf, name), _problem(jf, name)
        for f in ("xinit", "x0", "all_parameters"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert tf.EXIT_NAMES == jf.EXIT_NAMES
    for k in ("N", "NVAR", "NX", "NH", "NUM_PRE_PARAMS", "NPAR_STAGE",
              "NPAR_TOTAL", "X0_TOTAL", "OPTIMAL", "MAXITREACHED",
              "BADFUNCEVAL", "NOPROGRESS"):
        assert getattr(tf, k) == getattr(jf, k), k
    assert ([f.name for f in dataclasses.fields(tf.ForcesInfo)]
            == [f.name for f in dataclasses.fields(jf.ForcesInfo)])


@pytest.mark.parametrize("final", [False, True])
def test_unpack_params_matches_jax(final):
    params = _problem(tf, "migration")
    Z0r, pr = jf.unpack_params(params, C, final=final)
    Z0, p = tf.unpack_params(params, TC, final=final, device="cpu")
    assert Z0.dtype == F64 and Z0.shape == (20, 17)
    np.testing.assert_allclose(Z0.numpy(), np.asarray(Z0r), rtol=0,
                               atol=1e-12)
    for f in nlp.NLPParams._fields[:-1]:
        np.testing.assert_allclose(getattr(p, f).numpy(),
                                   np.asarray(getattr(pr, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    for f in nlp.StageWeights._fields:
        np.testing.assert_allclose(getattr(p.weights, f).numpy(),
                                   np.asarray(getattr(pr.weights, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("profile", ["normal", "final"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_solve_matches_jax(solves, name, profile):
    (out_r, flag_r, info_r), (out, flag, info) = solves[name, profile]
    assert flag == flag_r == 1
    assert info.it == info_r.it
    Z = np.stack([out[f"x{i + 1:02d}"] for i in range(20)])
    Zr = np.stack([out_r[f"x{i + 1:02d}"] for i in range(20)])
    assert Z.shape == (20, 17) and out["x01"].dtype == np.float64
    assert np.max(np.abs(Z - Zr) / (1.0 + np.abs(Zr))) <= 1e-8
    for f in ("res_eq", "res_ineq", "rdgap", "pobj"):
        assert _rel(getattr(info, f), getattr(info_r, f)) <= 1e-8, f
    assert info.fevalstime == 0.0 and info.solvetime > 0.0


# ---- tests/test_forces_api.py, on the port --------------------------------

def test_roundtrip_matches_native_params():
    goal = np.array([1.5, 0.8, 1.2])
    params = _packed_problem(tf, goal, [0.4, -0.2, 0.0])
    Z0u, p = tf.unpack_params(params, TC, final=False, device="cpu")
    ref = hover_to_goal_params(X0, goal, TC.model, TC.weights,
                               f_ext=(0.4, -0.2, 0.0), device="cpu")
    Z0 = hover_warm_start(torch.as_tensor(X0, dtype=F64), TC.model)
    np.testing.assert_allclose(Z0u.numpy(), Z0.numpy())
    for name in nlp.NLPParams._fields[:-1]:
        np.testing.assert_allclose(getattr(p, name).numpy(),
                                   getattr(ref, name).numpy(), atol=1e-12,
                                   err_msg=name)
    for name in nlp.StageWeights._fields:
        np.testing.assert_allclose(getattr(p.weights, name).numpy(),
                                   getattr(ref.weights, name).numpy(),
                                   err_msg=name)


def test_shim_solve_matches_direct_solve():
    goal = np.array([2.0, -1.0, 1.4])
    params = _packed_problem(tf, goal, [0.0, 0.0, 0.0])
    out, flag, info = tf.ForcesSolver("normal", device="cpu").solve(params)
    assert flag == 1
    assert info.it > 0 and info.res_eq < 1e-4

    p = hover_to_goal_params(X0, goal, TC.model, TC.weights, device="cpu")
    Z0 = hover_warm_start(torch.as_tensor(X0, dtype=F64), TC.model)
    ref = ipm_lanes.solve_batch_lanes(
        Z0[None], ipm_lanes._map_params(lambda a: a[None], p), TC.model,
        TC.solver)
    Z_shim = np.stack([out[f"x{i + 1:02d}"] for i in range(tf.N)])
    np.testing.assert_allclose(Z_shim, ref.Z[0].numpy(), atol=1e-12)


def test_pack_tightening_matches_reference_rule():
    """b_tilde = b - ||E a^T|| on active rows, zeroed padding rows
    (forces_normal.cpp:111-136)."""
    rng = np.random.default_rng(3)
    E = rng.standard_normal((tf.N, 3, 3)) * 0.1
    goal = np.array([1.0, 0.0, 1.2])
    params = _packed_problem(tf, goal, [0, 0, 0], tube_E=E)
    ap = params.all_parameters.reshape(tf.N, tf.NPAR_STAGE)
    A = ap[:, 10:100].reshape(tf.N, 30, 3)
    b = ap[:, 100:130]
    padding = np.linalg.norm(A, axis=-1) == 0
    assert (b[padding] == 0.0).all()
    Araw, braw = box_corridor(0.5 * (X0[:3] + goal),
                              np.array([5.0, 5.0, 2.0]), TC.model.N,
                              device="cpu")
    Araw, braw = Araw.numpy(), braw.numpy()
    active = np.linalg.norm(Araw, axis=-1) > 0
    shrink = np.linalg.norm(np.einsum("nij,nkj->nki", E, Araw), axis=-1)
    np.testing.assert_allclose(b[active], (braw - shrink)[active],
                               atol=1e-12)


def test_final_profile_brakes_terminal_velocity():
    goal = np.array([4.0, 0.0, 1.2])
    params = _packed_problem(tf, goal, [0, 0, 0], final_weights=True)
    out_n, flag_n, _ = tf.ForcesSolver("normal", device="cpu").solve(params)
    out_f, flag_f, _ = tf.ForcesSolver("final", device="cpu").solve(params)
    assert flag_n == 1 and flag_f == 1
    v_n = np.linalg.norm(out_n["x20"][11:14])
    v_f = np.linalg.norm(out_f["x20"][11:14])
    assert v_f < 0.5 * v_n, (v_f, v_n)


# ---- the port's own surface -----------------------------------------------

def test_predictor_corrector_config_matches_jax():
    """A predictor-corrector configuration (K4's path on a card) against
    JAX's per-lane predictor-corrector solve, with the bars above."""
    def pc(cfg):
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, predictor_corrector=True))

    out_r, flag_r, info_r = jf.ForcesSolver(cfg=pc(C)).solve(
        _problem(jf, "migration"))
    out, flag, info = tf.ForcesSolver(cfg=pc(TC), device="cpu").solve(
        _problem(tf, "migration"))
    assert flag == flag_r == 1 and info.it == info_r.it > 0
    for k in out:
        assert np.max(np.abs(out[k] - out_r[k])
                      / (1.0 + np.abs(out_r[k]))) <= 1e-8, k
    for f in ("res_eq", "res_ineq", "rdgap", "pobj"):
        assert _rel(getattr(info, f), getattr(info_r, f)) <= 1e-8, f


def test_set_params_is_applied_once_at_solve():
    params = _problem(tf, "hover_force")
    solver = tf.ForcesSolver(device="cpu")
    solver.set_params(1.0, 2.0, 3.0, 4.0, 5.0)
    solver.solve(params)
    ap = params.all_parameters.reshape(tf.N, tf.NPAR_STAGE)
    assert ap[0, 6:9].tolist() == [1.0, 2.0, 3.0]
    assert ap[-1, 6:9].tolist() == [4.0, 5.0, 3.0]
    assert solver._pending_weights is None
    with pytest.raises(ValueError, match="unknown profile"):
        tf.ForcesSolver("fast", device="cpu")


def test_default_device_is_the_card_without_a_cpu_fallback():
    solver = tf.ForcesSolver()
    assert solver.device == torch.device("cuda")
    if torch.cuda.is_available():
        return
    with pytest.raises((AssertionError, RuntimeError)):
        solver.solve(_problem(tf, "hover_force"))


def test_f32_solve_on_the_cpu_within_the_control_bar(solves):
    out, flag, _ = tf.ForcesSolver(dtype=torch.float32, device="cpu").solve(
        _problem(tf, "hover_force"))
    out64 = solves["hover_force", "normal"][1][0]
    assert flag == 1
    u = np.stack([out[f"x{i + 1:02d}"][:4] for i in range(20)])
    u64 = np.stack([out64[f"x{i + 1:02d}"][:4] for i in range(20)])
    assert np.max(np.abs(u - u64)) <= 1e-3


def test_migration_example_packs_and_solves_the_migration_problem(solves):
    """The ported examples/forces_api_migration.py: its packed problem is
    the one held against JAX above, and its run on the CPU returns that
    solve."""
    from forces_resilient_planner_tpu_torch.examples import (
        forces_api_migration as ex,
    )

    a, b = ex.migration_params(device="cpu"), _problem(tf, "migration")
    for f in ("xinit", "x0", "all_parameters"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    out, flag, info = ex.main(["--device", "cpu"])
    out_m, flag_m, info_m = solves["migration", "normal"][1]
    assert flag == flag_m == 1 and info.it == info_m.it
    for k in out:
        np.testing.assert_array_equal(out[k], out_m[k])
