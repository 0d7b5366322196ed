"""Headline benchmark of the port: NMPC solves/s per card at N = 20
(BASELINE config 4), the repo's bench.py program on the card.

    python3 -m forces_resilient_planner_tpu_torch.bench

Runs bench.py's sections with its seeds, repeat counts and workloads, in
its order, through the port's entry points, every one on the card:

  the streamed 4096-scenario grid (the headline), per call and streamed;
  the roofline share of the headline's IPM iterations;
  the B = 1 untiered solve against the reference's 50 ms tick, beside
  the card's round-trip floor;
  the B = 1 full nmpc_step at the entry configuration (entry.py);
  the B = 4096 batched and streamed full step at DEFAULT_CONFIG;
  config 3's closed loop (the fence and the wind, one robot);
  the B = 128 fleet through the fence's gap;
  the folds of the card's artifacts (MC_SWEEP_H100.json, PARITY_H100.json)
  and a second capture of the grid, the headline the better median.

Progress lines go to stderr ("[bench] ..."); the last line of stdout is
one JSON line, {"metric", "value", "unit", "vs_baseline", "extras"}, with
bench.py's metric name and extras keys (EXTRAS_KEYS).  vs_baseline is the
headline over the reference's 20 solves/s (one solve per 50 ms tick,
nmpc_manage.cpp:46).  A section that raises ends the run: nothing is
printed to stdout and the exit code is not 0.

main(device=None) runs on the card ("cuda"); a caller may pass "cpu" (the
tests, at sizes they patch into the module constants).  There is no
fallback to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from forces_resilient_planner_tpu_torch import entry
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.engine import batch as bm
from forces_resilient_planner_tpu_torch.engine import (
    fleet,
    pipeline_batch,
    workloads,
)
from forces_resilient_planner_tpu_torch.engine.planner import ResilientPlanner
from forces_resilient_planner_tpu_torch.engine.simulator import (
    QuadSim,
    run_closed_loop,
)
from forces_resilient_planner_tpu_torch.utils.measure import (
    PEAK_FLOPS,
    card_line,
    k1_flops,
)

ROOT = Path(__file__).resolve().parents[1]
METRIC = "nmpc_solves_per_s_per_chip_N20_batch4096"
BASELINE_RATE = 20.0      # the reference: one solve per 50 ms tick

# sizes and repeat counts (bench.py's)
HALVES = workloads.HALVES
N_GOALS, N_FORCES = workloads.N_GOALS, workloads.N_FORCES
THROUGHPUT_REPS = 8       # timed grid calls, and sets per streamed repeat
STREAM_REPEATS = 5
SINGLE_REPS = 50
FLOOR_REPS = 40
STEP_REPS = 30
PIPELINE_B, PIPELINE_SETS = 4096, 8
CLOSED_LOOP_S = 7.0
CLOSED_LOOP_GOAL = [3.5, 0.0]
FLEET_B, FLEET_S = workloads.FLEET_B, workloads.FLEET_DURATION

# every key of the line's extras (bench.py's), "card" on the card only
EXTRAS_KEYS = frozenset({
    "percall_solves_per_s", "streamed_range", "streamed_repeats",
    "mfu_pct", "achieved_tflops",
    "single_solve_p50_ms", "single_solve_p99_ms", "p99_relay_floor_ms",
    "relay_floor_p50_ms", "single_solve_compute_p50_ms",
    "pipeline_step_p50_ms", "pipeline_step_p99_ms",
    "pipeline_batched_steps_per_s", "pipeline_streamed_steps_per_s",
    "pipeline_batch",
    "closed_loop_goal_reached", "closed_loop_no_collision",
    "closed_loop_solve_p99_ms",
    "fleet_reached_frac", "fleet_collided_frac", "fleet_solved_frac",
    "fleet_realtime_factor", "fleet_outcomes", "fleet_tick_codes",
    "mc_sweep_100k", "streamed_range_2nd",
    "parity_max_u_diff", "parity_lanes", "parity_strict_lanes",
    "parity_fence_lanes",
    "pipeline_audit_pass", "pipeline_resolve_f64_max_u_diff",
    "pipeline_corridor_max_penetration_m",
    "pipeline_traj_corridor_violation", "pipeline_parity_lanes",
    "card",
})


def say(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _seeds(seed):
    """bench.py's bench_seeds at this module's grid size."""
    return workloads.bench_seeds(seed, N_GOALS, N_FORCES)


def _throughput(C, device):
    """The grid's throughput, the headline (bench.py:72-133): per-call
    solves of fresh seed sets, each timed to its exit codes' arrival on the
    host, then STREAM_REPEATS streamed repeats of fresh sets through
    solve_scenario_stream; the headline is the streamed median."""
    B = N_GOALS * N_FORCES * len(HALVES)
    g0, f0 = _seeds(1)
    r = bm.solve_scenario_grid(C, g0, f0, HALVES, device=device)
    r.Z.cpu()

    reps = THROUGHPUT_REPS
    sets = [_seeds(1000 + s) for s in range(reps)]
    lat, solved, iters = [], 0, []
    for g, f in sets:
        t0 = time.perf_counter()
        r = bm.solve_scenario_grid(C, g, f, HALVES, device=device)
        ec = r.exit_code.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        solved += int((ec == 1).sum())
        iters.append(float(r.iters.cpu().numpy().mean()))
    lat = np.asarray(lat)

    stream_rates, stream_solved, stream_n = [], 0, 0
    for rep in range(STREAM_REPEATS):
        stream_sets = [_seeds(3000 + 100 * rep + s) for s in range(reps)]
        t0 = time.perf_counter()
        results = bm.solve_scenario_stream(C, stream_sets, HALVES,
                                           device=device)
        stream_solved += sum(int((r.exit_code == 1).sum()) for r in results)
        stream_wall = time.perf_counter() - t0
        stream_rates.append(B * reps / stream_wall)
        stream_n += B * reps
    stream_rates = np.asarray(stream_rates)
    return dict(
        B=B,
        solves_per_s=float(np.median(stream_rates)),
        stream_min=float(stream_rates.min()),
        stream_max=float(stream_rates.max()),
        stream_repeats=STREAM_REPEATS,
        percall_solves_per_s=B / lat.mean(),
        stream_solved_frac=stream_solved / stream_n,
        mean_ms=lat.mean() * 1e3,
        min_ms=lat.min() * 1e3,
        p99_batch_ms=float(np.percentile(lat, 99)) * 1e3,
        solved_frac=solved / (B * reps),
        iters_mean=float(np.mean(iters)),
    )


def _single_solve(C, device):
    """B = 1 untiered solve latency against the reference's 50 ms budget
    (bench.py:136-185), beside the card's round-trip floor: an 8-element
    x + 1.0 on the card read back to the host, the least that any call of
    this process that waits for the card pays (bench.py's relay floor
    measured the same round trip through its remote relay).  The floor's
    keys keep bench.py's names (relay_floor_p50_ms, p99_relay_floor_ms)."""
    C1 = dataclasses.replace(
        C, solver=dataclasses.replace(C.solver, tiers=())
    )
    g0, f0 = workloads.bench_seeds(1, 1, 1)
    r = bm.solve_scenario_grid(C1, g0, f0, HALVES, device=device)
    r.Z.cpu()

    lat, solved = [], 0
    for s in range(SINGLE_REPS):
        g, f = workloads.bench_seeds(2000 + s, 1, 1)
        t0 = time.perf_counter()
        r = bm.solve_scenario_grid(C1, g, f, HALVES, device=device)
        ec = r.exit_code.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        solved += int((ec == 1).sum())
    lat = np.asarray(lat) * 1e3

    (torch.zeros(8, dtype=torch.float32, device=device) + 1.0).cpu()
    nlat = []
    for s in range(FLOOR_REPS):
        x = torch.as_tensor(np.random.default_rng(s).normal(0, 1, 8),
                            dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        (x + 1.0).cpu()
        nlat.append(time.perf_counter() - t0)
    nlat = np.asarray(nlat) * 1e3
    return dict(
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        solved_frac=solved / SINGLE_REPS,
        relay_floor_p50_ms=float(np.percentile(nlat, 50)),
        relay_floor_p99_ms=float(np.percentile(nlat, 99)),
        compute_p50_ms=float(
            np.percentile(lat, 50) - np.percentile(nlat, 50)
        ),
    )


def perturbed_step_args(args, s):
    """The s-th input of the B = 1 step: the entry's state and force
    perturbed by N(0, 1e-3) from default_rng(s) (bench.py:206-209)."""
    a = list(args)
    rng = np.random.default_rng(s)
    for i, n in ((4, 9), (5, 3)):
        a[i] = args[i] + torch.as_tensor(rng.normal(0, 1e-3, n),
                                         dtype=args[i].dtype,
                                         device=args[i].device)
    return a


def _pipeline_step(device):
    """Full nmpc_step (references -> tubes -> corridors -> tighten ->
    solve) B = 1 latency at the entry configuration (entry.py::entry,
    workloads.small_cfg), each call timed to its exit code's arrival on the
    host (bench.py:188-218)."""
    fn, args = entry.entry(device=device)
    out = fn(*args)
    out[1].cpu()

    lat = []
    for s in range(STEP_REPS):
        a = perturbed_step_args(args, s)
        t0 = time.perf_counter()
        out = fn(*a)
        out[1].cpu()
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    return dict(
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
    )


def batched_inputs(device) -> dict:
    """The batched step's base inputs: entry.py's example inputs at
    small_cfg with DEFAULT_CONFIG's corridor caps, f32, tiled PIPELINE_B
    times (bench.py:290-296)."""
    lean = dataclasses.replace(workloads.small_cfg(),
                               corridor=DEFAULT_CONFIG.corridor)
    return entry.example_inputs(lean, torch.float32, batch=PIPELINE_B,
                                device=device)


def perturbed_batch(args0, s) -> dict:
    """The s-th input set: f_ext + N(0, 1e-3), mpc_output + N(0, 1e-4)
    from default_rng(500 + s), added in f32 (bench.py:298-305)."""
    a = dict(args0)
    r = np.random.default_rng(500 + s)
    for k, sd in (("f_ext", 1e-3), ("mpc_output", 1e-4)):
        a[k] = a[k] + torch.as_tensor(r.normal(0, sd, tuple(a[k].shape)),
                                      dtype=a[k].dtype, device=a[k].device)
    return a


def step_outputs(a):
    """bench.py's make_pipeline_fn program (:245-274): one batched step at
    DEFAULT_CONFIG, reduced to the checksum, the solved fraction, the mean
    iterations, the stage controls u (B, N, 4) and the exit codes (B,)."""
    r = pipeline_batch.nmpc_step_batched(
        *[a[k] for k in pipeline_batch.PIPELINE_ARG_KEYS],
        cfg=DEFAULT_CONFIG)
    iters = r.iters.to(torch.float32)
    return (
        r.mpc_output.to(torch.float32).sum() + iters.sum(),
        (r.exit_code == 1).to(torch.float32).mean(),
        iters.mean(),
        r.mpc_output[:, 1:, 0:4],
        r.exit_code,
    )


def _pipeline_batched(device):
    """Batched full-step throughput at DEFAULT_CONFIG's caps (bench.py:
    277-345): PIPELINE_SETS perturbed input sets of PIPELINE_B scenarios
    staged on the card first, each call timed to its checksum's arrival on
    the host, then the same sets through nmpc_step_stream."""
    B = PIPELINE_B
    args0 = batched_inputs(device)
    float(step_outputs(perturbed_batch(args0, 0))[0])
    sets = [perturbed_batch(args0, s) for s in range(1, PIPELINE_SETS + 1)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    lat, solved = [], []
    for a in sets:
        t0 = time.perf_counter()
        out = step_outputs(a)
        float(out[0])
        lat.append(time.perf_counter() - t0)
        solved.append(float(out[1]))
    lat = np.asarray(lat)

    t0 = time.perf_counter()
    outs = pipeline_batch.nmpc_step_stream(step_outputs, sets)
    for o in outs:
        float(o[0])
    stream_wall = time.perf_counter() - t0
    return dict(
        batch=B,
        batched_steps_per_s=float(B / np.median(lat)),
        streamed_steps_per_s=float(B * len(sets) / stream_wall),
        solved_frac=float(np.mean(solved)),
    )


def _closed_loop_smoke(device):
    """Config 3's closed loop on the card (bench.py:348-417): the fence
    and the wind 0.8 sin(0.5 t) flown by the complete stack (map, search,
    corridors, tubes, solver, FSM, 100 Hz commands) at f32 for
    CLOSED_LOOP_S to the goal (3.5, 0).  Reports: goal reached (within
    0.5 m), no point of the trace inside the fence, and the per-tick solve
    p99 over the solves after the first three."""
    C = workloads.closed_loop_cfg()
    planner = ResilientPlanner(C, max_cloud=2048, dtype=torch.float32,
                               device=device)
    x0 = np.zeros(9)
    x0[2] = 1.2
    sim = QuadSim(C.model, x0.copy(), np.zeros(3))
    planner.on_odometry(x0)
    planner.set_occupied(workloads.fence_points())
    trace = run_closed_loop(planner, sim, CLOSED_LOOP_GOAL,
                            duration=CLOSED_LOOP_S,
                            force_schedule=workloads.wind)
    final = trace["pos"][-1]
    reached = bool(np.linalg.norm(final - np.array([*CLOSED_LOOP_GOAL, 1.2]))
                   < 0.5)
    no_collision = not any(1.35 < p[0] < 1.65 and not (-0.2 < p[1] < 1.7)
                           for p in trace["pos"])
    samples = np.asarray(planner.diag.timers._phases["solve"].samples[3:])
    p99 = (float(np.percentile(samples, 99) * 1e3) if len(samples)
           else float("nan"))
    return dict(
        reached=reached,
        no_collision=no_collision,
        p99_solve_ms=p99,
        solves=planner.diag.solves,
        final=[round(float(v), 3) for v in final],
    )


def _fleet_bench(device):
    """The fleet's closed loop on the card (bench.py:420-462): FLEET_B
    robots through the fence's gap for FLEET_S (workloads.fleet_cfg /
    fleet_scene / fleet_lanes(FLEET_B, seed=5)), a synchronized replan
    every 10 ticks, f32."""
    B, duration = FLEET_B, FLEET_S
    cfg = workloads.fleet_cfg()
    grid, obs, mask = workloads.fleet_scene(cfg, torch.float32, device=device)
    starts, goals, f_true = workloads.fleet_lanes(B, seed=5)
    res = fleet.run_fleet(cfg, grid, obs, mask, starts, goals, f_true,
                          duration,
                          replan_every=workloads.FLEET_REPLAN_EVERY)
    return dict(
        batch=B,
        reached_frac=res.reached_frac,
        collided_frac=res.collided_frac,
        solved_frac=res.solved_frac,
        realtime_factor=B * duration / res.wall_s,
        searches=res.searches,
        outcomes=res.outcome_counts,
        tick_codes={k: round(v, 4) for k, v in res.tick_code_fracs.items()},
        mean_time_to_goal=float(np.nanmean(res.time_to_goal))
        if np.isfinite(res.time_to_goal).any() else None,
    )


def _mfu(C, tp):
    """Roofline share of the headline: the grid's operations per second
    over the card's f32 peak outside the tensor cores (PEAK_FLOPS, the
    rate of K1's bound).  The operations are the streamed rate x the mean
    iterations x K1's count per lane-iteration (utils/measure.py::
    k1_flops, the count behind K1's bound in PERF.md section 6), in place
    of bench.py's analytic per-stage estimate."""
    flops_lane_iter = k1_flops(C.model.N)
    iters = tp["iters_mean"]
    achieved = tp["solves_per_s"] * iters * flops_lane_iter
    peak = PEAK_FLOPS[torch.float32]
    return dict(
        flops_per_call=flops_lane_iter * iters * tp["B"],
        achieved_tflops=achieved / 1e12,
        mfu_pct=100.0 * achieved / peak,
    )


def _fold_sweep(extras, path):
    mc = json.loads(path.read_text())
    extras["mc_sweep_100k"] = {
        k: mc.get(k) for k in (
            "n_scenarios", "resilience_rate", "solves_per_s",
            "steady_state_solves_per_s", "resumed_chunks", "exit_code_fracs")
    }
    say(f"Monte-Carlo sweep artifact ({path.name}, examples/"
        f"config5_monte_carlo.py on {mc.get('card')}): "
        f"{mc.get('n_scenarios')} scenarios, resilience "
        f"{mc.get('resilience_rate')}, {mc.get('solves_per_s')} solves/s "
        f"aggregate, {mc.get('steady_state_solves_per_s')} steady, "
        f"resumed_chunks={mc.get('resumed_chunks')}")


def _fold_parity(extras, path):
    """The card's certificate (tools/parity_certificate.py): its pipeline
    block holds the f64 audit's fields itself."""
    p = json.loads(path.read_text())
    extras["parity_max_u_diff"] = p.get("max_u_diff")
    extras["parity_lanes"] = p.get("n_lanes")
    extras["parity_strict_lanes"] = p.get("n_strict_lanes")
    extras["parity_fence_lanes"] = p.get("n_fence_lanes")
    say(f"on-card parity certificate ({path.name}, {p.get('card')}): max|u| "
        f"diff {p.get('max_u_diff')} over {p.get('n_lanes')} lanes "
        f"({p.get('n_seed_sets')} seed sets, {p.get('n_fence_lanes')} "
        f"corridor-rich, {p.get('n_strict_lanes')} strict)")
    pp = p.get("pipeline")
    if pp:
        extras["pipeline_audit_pass"] = pp.get("pass")
        extras["pipeline_resolve_f64_max_u_diff"] = pp.get(
            "resolve_f64_max_u_diff")
        extras["pipeline_corridor_max_penetration_m"] = pp.get(
            "corridor_max_obstacle_penetration_m")
        extras["pipeline_traj_corridor_violation"] = pp.get(
            "max_traj_corridor_violation")
        extras["pipeline_parity_lanes"] = pp.get("resolve_f64_n_both")
        say(f"full-step certificate (B = {pp.get('n_lanes')} on the card): "
            f"f64 re-solve of the card's NLP max|u| diff "
            f"{pp.get('resolve_f64_max_u_diff')} over "
            f"{pp.get('resolve_f64_n_both')} lanes; corridor audit max "
            f"obstacle penetration "
            f"{pp.get('corridor_max_obstacle_penetration_m')} m, max "
            f"accepted-trajectory violation "
            f"{pp.get('max_traj_corridor_violation')} (pass={pp.get('pass')})")


def main(device=None) -> dict:
    """Run every section on `device` (None: the card) and print the line;
    returns it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on an NVIDIA GPU and "
                           "torch.cuda.is_available() is False")
    C = workloads.bench_config()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))

    tp = _throughput(C, device)
    say(f"device={name} batch={tp['B']} mean={tp['mean_ms']:.1f}ms "
        f"min={tp['min_ms']:.1f}ms p99={tp['p99_batch_ms']:.1f}ms "
        f"solved={tp['solved_frac']:.4f} iters_mean={tp['iters_mean']:.1f} "
        f"per-solve-equiv={tp['mean_ms'] * 1e3 / tp['B']:.1f}us")
    say(f"streamed ({tp['stream_repeats']} repeats): median "
        f"{tp['solves_per_s']:.0f} solves/s, range [{tp['stream_min']:.0f}, "
        f"{tp['stream_max']:.0f}] (per-call loop: "
        f"{tp['percall_solves_per_s']:.0f}) "
        f"solved={tp['stream_solved_frac']:.4f}")
    extras = {
        "percall_solves_per_s": round(tp["percall_solves_per_s"], 1),
        "streamed_range": [round(tp["stream_min"], 1),
                           round(tp["stream_max"], 1)],
        "streamed_repeats": tp["stream_repeats"],
    }

    mfu = _mfu(C, tp)
    extras["mfu_pct"] = round(mfu["mfu_pct"], 4)
    extras["achieved_tflops"] = round(mfu["achieved_tflops"], 3)
    say(f"roofline: {mfu['flops_per_call'] / 1e9:.2f} GFLOP/solve-call, "
        f"{mfu['achieved_tflops']:.3f} TFLOP/s achieved = "
        f"{mfu['mfu_pct']:.3f}% of the f32 peak outside the tensor cores")

    ss = _single_solve(C, device)
    extras["single_solve_p50_ms"] = round(ss["p50_ms"], 2)
    extras["single_solve_p99_ms"] = round(ss["p99_ms"], 2)
    extras["p99_relay_floor_ms"] = round(ss["relay_floor_p99_ms"], 2)
    extras["relay_floor_p50_ms"] = round(ss["relay_floor_p50_ms"], 2)
    extras["single_solve_compute_p50_ms"] = round(ss["compute_p50_ms"], 2)
    say(f"single-solve (B=1): p50={ss['p50_ms']:.1f}ms "
        f"p99={ss['p99_ms']:.1f}ms solved={ss['solved_frac']:.2f} (budget: "
        f"50ms, nmpc_manage.cpp:46); the card's round-trip floor "
        f"p50={ss['relay_floor_p50_ms']:.3f}ms "
        f"p99={ss['relay_floor_p99_ms']:.3f}ms -> above the floor "
        f"~{ss['compute_p50_ms']:.1f}ms")

    ps = _pipeline_step(device)
    extras["pipeline_step_p50_ms"] = round(ps["p50_ms"], 2)
    extras["pipeline_step_p99_ms"] = round(ps["p99_ms"], 2)
    say(f"full nmpc_step (B=1, entry config): p50={ps['p50_ms']:.1f}ms "
        f"p99={ps['p99_ms']:.1f}ms")

    pb = _pipeline_batched(device)
    extras["pipeline_batched_steps_per_s"] = round(
        pb["batched_steps_per_s"], 1)
    extras["pipeline_streamed_steps_per_s"] = round(
        pb["streamed_steps_per_s"], 1)
    extras["pipeline_batch"] = pb["batch"]
    say(f"full pipeline batched (B={pb['batch']}, DEFAULT_CONFIG caps, tube "
        f"+ corridor kernels): {pb['batched_steps_per_s']:.0f} steps/s "
        f"per-call, {pb['streamed_steps_per_s']:.0f} streamed "
        f"solved={pb['solved_frac']:.4f}")

    cl = _closed_loop_smoke(device)
    extras["closed_loop_goal_reached"] = cl["reached"]
    extras["closed_loop_no_collision"] = cl["no_collision"]
    extras["closed_loop_solve_p99_ms"] = round(cl["p99_solve_ms"], 2)
    say(f"closed loop on the card (config 3, wind): reached={cl['reached']} "
        f"no_collision={cl['no_collision']} solves={cl['solves']} "
        f"solve_p99={cl['p99_solve_ms']:.1f}ms final={cl['final']} "
        f"(budget: 50ms)")

    fl = _fleet_bench(device)
    extras["fleet_reached_frac"] = round(fl["reached_frac"], 4)
    extras["fleet_collided_frac"] = round(fl["collided_frac"], 4)
    extras["fleet_solved_frac"] = round(fl["solved_frac"], 4)
    extras["fleet_realtime_factor"] = round(fl["realtime_factor"], 1)
    extras["fleet_outcomes"] = fl["outcomes"]
    extras["fleet_tick_codes"] = fl["tick_codes"]
    say(f"fleet closed loop (B={fl['batch']}, full stack incl. batched "
        f"search): reached={fl['reached_frac']:.2f} "
        f"collided={fl['collided_frac']:.3f} solved={fl['solved_frac']:.3f} "
        f"aggregate realtime x{fl['realtime_factor']:.1f} "
        f"outcomes={fl['outcomes']} tick_codes={fl['tick_codes']} "
        f"mean_t_goal={fl['mean_time_to_goal']}")

    sweep = ROOT / "MC_SWEEP_H100.json"
    if sweep.exists():
        _fold_sweep(extras, sweep)

    # a second capture at the end of the run: the headline is the better
    # of the two medians (bench.py:660-684), both ranges recorded
    tp2 = _throughput(C, device)
    extras["streamed_range_2nd"] = [round(tp2["stream_min"], 1),
                                    round(tp2["stream_max"], 1)]
    say(f"streamed (2nd capture): median {tp2['solves_per_s']:.0f} "
        f"solves/s, range [{tp2['stream_min']:.0f}, "
        f"{tp2['stream_max']:.0f}]; 1st capture median "
        f"{tp['solves_per_s']:.0f}")
    headline = tp["solves_per_s"]
    if tp2["solves_per_s"] > headline:
        headline = tp2["solves_per_s"]
        extras["percall_solves_per_s"] = round(tp2["percall_solves_per_s"], 1)

    parity = ROOT / "PARITY_H100.json"
    if parity.exists():
        _fold_parity(extras, parity)
    if device.type == "cuda":
        extras["card"] = card_line(device)

    line = {
        "metric": METRIC,
        "value": round(float(headline), 1),
        "unit": "solves/s",
        "vs_baseline": round(float(headline / BASELINE_RATE), 1),
        "extras": extras,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
