"""Port parity: engine/batch.py of the torch port against the JAX engine on
a 32-lane grid of the bench workload (bench.py seeds, the bench tier
schedule): at f64 identical exit codes and iterations and Z within 1e-8;
f32 port controls within 1e-3 of the f64 JAX solve (the control-parity
bar); scenario construction exact; the LQR-rollout warm start within
1e-12; sweep statistics."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from forces_resilient_planner_tpu.engine import batch as jb
from forces_resilient_planner_tpu_torch.engine import batch as tb
from forces_resilient_planner_tpu_torch.solver import nlp as tn
from forces_resilient_planner_tpu_torch.solver import problems as tps

CFG = bench.bench_config()


def _seeds(seed=7):
    return bench.bench_seeds(seed, n_goals=2, n_forces=16)


@pytest.fixture(scope="module")
def jax_ref():
    g, f = _seeds()
    return jb.solve_scenario_grid(CFG, g, f, bench.HALVES, dtype=jnp.float64)


@pytest.fixture(scope="module")
def port64():
    g, f = _seeds()
    return tb.solve_scenario_grid(CFG, g, f, bench.HALVES,
                                  dtype=torch.float64, device="cpu")


def test_grid_solve_matches_jax_at_f64(jax_ref, port64):
    assert port64.exit_code.shape == (32,)
    assert (np.asarray(jax_ref.exit_code) == 1).all()
    np.testing.assert_array_equal(port64.exit_code.numpy(),
                                  np.asarray(jax_ref.exit_code))
    np.testing.assert_array_equal(port64.iters.numpy(),
                                  np.asarray(jax_ref.iters))
    np.testing.assert_allclose(port64.Z.numpy(), np.asarray(jax_ref.Z),
                               rtol=1e-8, atol=1e-8)


def test_grid_solve_f32_controls_within_parity_bar(jax_ref):
    g, f = _seeds()
    got = tb.solve_scenario_grid(CFG, g, f, bench.HALVES,
                                 dtype=torch.float32, device="cpu")
    assert (got.exit_code == 1).all()
    d = np.abs(got.Z[:, :, 0:4].double().numpy()
               - np.asarray(jax_ref.Z[:, :, 0:4]))
    assert d.max() <= 1e-3, d.max()


def test_make_scenarios_matches_jax_and_device_expansion():
    g, f = _seeds(3)
    halves = np.array([[5.0, 5.0, 2.0], [2.0, 3.0, 1.2]])
    ref = jb.make_scenarios(CFG, g, f, halves, dtype=jnp.float64)
    got = tb.make_scenarios(CFG, g, f, halves, dtype=torch.float64,
                            device="cpu")
    np.testing.assert_array_equal(got.Z0.numpy(), np.asarray(ref.Z0))
    ref_p, _ = tn.nlp_params_from_numpy(ref.params, ref.Z0,
                                        dtype=torch.float64, device="cpu")
    for a, b in zip(got.params[:-1], ref_p[:-1]):
        assert torch.equal(a, b)
    for a, b in zip(got.params.weights, ref_p.weights):
        assert torch.equal(a, b)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    x0 = np.zeros(9)
    x0[2] = 1.2
    weights = tn.make_stage_weights(CFG.weights, CFG.model.N,
                                    dtype=torch.float64, device="cpu")
    dev = tb._expand_scenarios_device(CFG, t(x0), t(g), t(f), t(halves),
                                      weights)
    assert torch.equal(dev.Z0, got.Z0)
    for a, b in zip(dev.params[:-1], got.params[:-1]):
        assert torch.equal(a, b)
    for a, b in zip(dev.params.weights, got.params.weights):
        assert torch.equal(a, b)


def test_lqr_warm_start_matches_jax():
    from forces_resilient_planner_tpu.solver import problems as jp

    rng = np.random.default_rng(4)
    B, N = 12, CFG.model.N
    x0 = rng.normal(0.0, 0.5, (B, 9)) + np.array([0, 0, 1.2, 0, 0, 0, 0, 0, 0])
    ref_pos = rng.uniform(-2.0, 2.0, (B, N, 3))
    ref_yaw = rng.uniform(-np.pi, np.pi, (B, N))
    f = rng.uniform(-1.0, 1.0, (B, 3))
    K = CFG.K_matrix()
    want = jp.lqr_warm_start_batch(*map(jnp.asarray, (x0, ref_pos, ref_yaw,
                                                      f)), CFG.model,
                                   jnp.asarray(K))
    got = tps.lqr_warm_start_batch(
        *(torch.as_tensor(a, dtype=torch.float64)
          for a in (x0, ref_pos, ref_yaw, f)),
        CFG.model, torch.as_tensor(K, dtype=torch.float64))
    assert got.shape == (B, N, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_lqr_warm_start_grid_matches_jax():
    """warm_start="lqr": the expanded grid's Z0 is the JAX grid's."""
    import dataclasses

    cfg = dataclasses.replace(
        CFG, solver=dataclasses.replace(CFG.solver, warm_start="lqr"))
    g, f = _seeds(3)
    ref = jb.make_scenarios(cfg, g, f, bench.HALVES, dtype=jnp.float64)
    got = tb.make_scenarios(cfg, g, f, bench.HALVES, dtype=torch.float64,
                            device="cpu")
    hover = tb.make_scenarios(CFG, g, f, bench.HALVES, dtype=torch.float64,
                              device="cpu")
    assert not torch.equal(got.Z0, hover.Z0)
    np.testing.assert_allclose(got.Z0.numpy(), np.asarray(ref.Z0),
                               rtol=1e-12, atol=1e-12)


def test_sweep_stats_match_jax(jax_ref, port64):
    ref = jb.sweep_stats(jax_ref)
    got = tb.sweep_stats(port64)
    assert got.n.item() == float(ref.n) == 32.0
    assert got.n_solved.item() == float(ref.n_solved)
    assert got.mean_iters.item() == pytest.approx(float(ref.mean_iters),
                                                  rel=1e-6)
    assert got.max_kkt_solved.item() == pytest.approx(
        float(ref.max_kkt_solved), rel=1e-4)
    assert got.mean_cost.item() == pytest.approx(float(ref.mean_cost),
                                                 rel=1e-8)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_sweep_stats_leaves_live_on_the_result_device(port64, device):
    """Every SweepStats leaf is on the result's device (an all-reduce of
    the stats across ranks needs no copy); the meta device stands in for a
    card here."""
    from forces_resilient_planner_tpu_torch.solver.ipm import SolveResult

    res = SolveResult(*(a.to(device) for a in port64))
    stats = tb.sweep_stats(res)
    for name, leaf in zip(stats._fields, stats):
        assert leaf.device.type == device, name
        assert leaf.shape == (), name


def test_scenario_stream_equals_grid_solves(port64):
    sets = [_seeds(), _seeds(8)]
    res = tb.solve_scenario_stream(CFG, sets, bench.HALVES,
                                   dtype=torch.float64, device="cpu")
    assert len(res) == 2
    assert torch.equal(res[0].Z, port64.Z)
    one = tb.solve_scenario_grid(CFG, *sets[1], bench.HALVES,
                                 dtype=torch.float64, device="cpu")
    assert torch.equal(res[1].Z, one.Z)
    assert torch.equal(res[1].exit_code, one.exit_code)
    assert tb.solve_scenario_stream(CFG, [], bench.HALVES,
                                    device="cpu") == []


def test_solve_scenarios_tiers_match_single_phase():
    """The bench tier schedule is bit-identical to the single-phase solve
    (tiers whose tails cover every unconverged lane)."""
    import dataclasses

    g, f = _seeds(5)
    scen = tb.make_scenarios(CFG, g, f, bench.HALVES, dtype=torch.float64,
                             device="cpu")
    tiered = tb.solve_scenarios(scen, CFG)
    single = tb.solve_scenarios(
        scen, dataclasses.replace(
            CFG, solver=dataclasses.replace(CFG.solver, tiers=())))
    assert torch.equal(tiered.Z, single.Z)
    assert torch.equal(tiered.iters, single.iters)
