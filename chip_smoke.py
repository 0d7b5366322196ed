"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width and holds every hand-written
CUDA kernel against its plain PyTorch version on the card:

  slice 1, the bench headline: a 256 goals x 16 forces x 1 box = 4096-
  scenario grid at N = 20 solved by engine/batch.py::solve_scenario_grid
  with the bench tier schedule, every monotone IPM iteration launched as
  ops/csrc/ipm_iteration.cu (K1);
  slice 2, the batched full NMPC step: engine/pipeline_batch.py::
  nmpc_step_batched at DEFAULT_CONFIG on 4096 robots (N = 20, K = 64 path
  samples, M = 256 obstacles, each robot its own cloud, force, time offset
  and profile), with stage 1's references kernel ops/csrc/reference.cu,
  the tube kernel ops/csrc/tube_stage.cu (K2), the tube chain ops/csrc/
  tube_chain.cu after it, the corridor kernel ops/csrc/corridor.cu (K3)
  and K1;
  slice 3, the Mehrotra predictor-corrector (SolverConfig.
  predictor_corrector=True) on the grid and the step, every iteration one
  Riccati factor K4a and two backsolves K4b of ops/csrc/lqr.cu, and the
  batched LQR solve solver/riccati.py::solve_lqr_batched through K5a and
  K5b of the same source;
  slice 4, the closed loop: the JAX bench's fleet (engine/fleet.py::
  run_fleet, B = 128 robots through the fence's 1.8 m gap for 8 s, the
  batched kinodynamic search on every replan, nmpc_step_batched and the
  plant every tick) and one robot's planner (engine/planner.py::
  ResilientPlanner with engine/simulator.py::run_closed_loop), both
  through K1, K2, the tube chain and K3;
  slice 5, the surfaces and scale-out: the FORCES API (solver/
  forces_api.py, B = 1 of the lane-major solver through K1, and K4 under a
  predictor-corrector configuration; its graph route bit for bit equal to
  its eager route, one replay of the info struct's graph a solve), the
  sharded solve of parallel/
  mesh.py in a world of one NCCL rank, BASELINE config 5's 102,400-
  scenario sweep through the ported example, interrupted after 8
  checkpointed chunks and resumed in a fresh process, and entry.py's
  entry() and dryrun_multichip(1) (K1, K2, the chain, K3);
  slice 6, the last surfaces: the adversarial stress batch (engine/
  workloads.py::stress_params) at f32 and f64 through K1, a reduced
  parity certificate against the independent SLSQP oracle (tools/
  parity_certificate.py, the oracle in a pool of CPU processes), the
  shipped solver (utils/aot.py) loaded in a process without nvcc, and the
  BASELINE examples 1-4 and 6 (K1, K2, the chain, K3);
  slice 7, the corridor decomposition on every cloud and option: K3's
  gathered route (ops/csrc/corridor.cu: clouds past a CTA's shared memory,
  past 65,535 obstacles, and CorridorConfig.max_active_obstacles below the
  cloud size) against its plain version, and the f64 single-robot planner
  at max_cloud = 8192 on BASELINE config 3's fence loop (K1, K2, the
  chain, K3);
  the headline bench: forces_resilient_planner_tpu_torch/bench.py, the
  repo's bench.py program on the card (the grid, the B = 1 solve and step,
  the batched step, config 3's closed loop, the fleet), run as a user runs
  it, in a process of its own (K1, K2, the chain, K3).

Phases, one line each (any failure exits non-zero and nothing after it is
printed):

  0. device: needs torch.cuda; prints the card's name and power limit
  1. build: compiles the kernel sources with nvcc, all at once;
     prints build seconds and the ptxas register / spill report of each
     entry function, K1's lanes and shared memory per CTA, K2's stage lanes,
     threads and shared memory per CTA (a team of 9 threads per lane), the
     tube chain's robots, threads and shared memory per CTA at N = 20 (a
     team of 9 threads per robot, fixed in its source), the references'
     robots per CTA (a thread per robot, fixed in its source) and K3's
     route, lanes per stage,
     threads, shared memory per CTA and
     scratch at M = 256, 1024, 2048, 8192, 16,384 and 70,000 and at M = 2048
     with k = 64, K4a's, K4b's, K5a's and K5b's lanes, threads and shared
     memory per CTA (a warp per lane)
  2. K1 vs its plain PyTorch version on the card at B = 4096, one
     iteration from the initial state and one after 8 plain iterations:
     f64 |d| <= 1e-9 (1 + |ref|) with identical it/done; f32 from the
     initial state |d| <= 1e-3 (1 + |ref|) on the lanes whose done flag
     agrees; f32 in mid-solve the kernel's error against the f64 step from
     the same state within 1.25x the plain f32 step's (+1e-3); f32 done
     flags agreeing on >= 99.9% of lanes; K1 on a permutation of the
     lanes and on the 256 lanes a tier would take, launched alone, bit for
     bit equal to the same lanes of the full launch
  3. slice 1 main path at f32: solved fraction >= 0.999; K1 launches equal
     to the host-loop iterations stepped (> 0), no K4; the first 64 lanes
     re-solved by the plain path at f64 on the CPU within 1e-3 in u (at
     most one of the card's solved lanes missing); the grid solved through
     the plain versions on the card: solved fraction within 0.005, exit
     codes agreeing on >= 99.5% of lanes
  4. K1 times: ms per iteration (CUDA events) at B = 4096, 1024, 256 and
     1, each beside its bound from bytes and operations and the share of
     it; the plain version at 4096; grid-solve ms per call and solves/s
     over 5 fresh seed sets, mean iterations
  5. K2 vs its plain version at L = B N = 81,920 stage lanes, on random
     tube-regime lanes and on the main path's own stage lanes: f64
     |d| <= 1e-10 (1 + |ref|); f32 max |d| Phi <= 2e-5, Mp <= 2e-6,
     Qd <= 1e-6, Q1 <= 1e-6; and with a gain other than the config's
     (1.3 K plus a seeded perturbation) on the main path's stage lanes at
     f64, the same 1e-10 bar; the tube chain vs its plain version on K2's
     outputs of the main path's stage lanes (B = 4096 robots and the first
     alone, N = 20) at f64 and f32, and at f32 with one stage's Qd made
     NaN: E and Q2 NaN exactly where the plain chain has it, elsewhere f64
     |d| <= 1e-10 (1 + |ref|), f32 max |d| <= 1e-6; the share of entries
     bit-equal to the plain chain's printed
  6. stage 1's references kernel vs its plain version on the card, on the
     main path's own inputs (B = 4096 and the first robot alone, f64 and
     f32): ref_pos, ref_yaw and stage0_jump bit-equal, one launch a call;
     K3 vs its plain version: f64, A and b within 1e-9 on every row, on
     generic random inputs at B = 256, M = 256 and at B = 64, M = 2048, and
     on the main path's own segments and clouds (B = 4096, M = 256); f32
     at the main path's inputs, the share of (robot, stage) whose rows
     match within 1e-4 (printed, not barred: argmin ties flip planes at f32)
  7. slice 2 main path at f32, on the easy workload and on one where every
     4th robot has drifted from its plan: the references, K2, the tube
     chain and K3 launched once each, K1 once per host-loop step; every
     output finite on the accepted robots; the f64 certificate on the CPU
     (no obstacle inside any tightened polytope, accepted trajectories within 1e-4 of
     their corridors, the card's NLP of robots 0-63 re-solved by the plain solver at f64 within
     1e-3 in u); the step through the plain versions on the card, its
     exit-code agreement printed and its solved fraction within 0.005
  8. slice 2 times: K2, the tube chain and K3 ms per call against their
     plain versions, each beside its bound and the share of it (K3's
     bound from the work this run's data needs: ops/corridor_kernel.py::
     decompose_stages_work); the references' ms per call on the card alone
     (utils/measure.py::device_ms) at B = 4096 and B = 1, and with the
     host's launch cost, against the plain version's, beside its bound;
     K3 at M = CorridorConfig.max_obstacles (2048), its geometry there;
     nmpc_step_batched ms per call and steps/s over 5 pre-staged fresh
     input sets of each workload; engine/pipeline.py::nmpc_step at B = 1,
     p50 / p99 over 30 calls, in the engine/workloads.py::small_cfg
     configuration (reduced caps) and in DEFAULT_CONFIG
  9. K4 vs its plain version on the predictor-corrector grid's own calls
     (B = 4096, nh = 30), from the initial IPM state and after 8 plain
     iterations: f64 |d| <= 1e-9 (1 + |ref|) on every factor and backsolve
     output; f32 held against the plain version at f64, the kernel's error
     within 1.25x the plain f32 one's (+1e-3); K4 at f64 with nh = 18 on
     256 lanes; K4a and K4b after 8 plain PC iterations, f32 and f64, on
     a permutation of the lanes and on 256 lanes launched alone, bit for
     bit equal to the same lanes of the full launch; K5 on random
     well-conditioned blocks at B = 4096, N = 20 and on the PC grid's own
     blocks (its initial-state K4 calls, the stage QP and the augmented
     dynamics assembled by the plain _assemble_qp_blocks / _aug_dynamics):
     f64 within 1e-9 (1 + |ref|), f32 within 1e-4 (1 + |ref|), the f64
     kernel solution's KKT residuals within 1e-8; K5 on the PC grid's
     blocks, f32 and f64, on a permutation of the lanes and on 256 lanes
     alone, bit for bit equal to the full launch; solve_lqr_batched
     launching K5a and K5b once each
  10. slice 3 main path at f32: the predictor-corrector grid with phase
     3's checks, except that K4a launches = host-loop steps, K4b = twice
     that, no K1, and the solved fraction is printed, not barred; then
     nmpc_step_batched with the
     predictor-corrector on phase 7's two workloads with phase 7's checks
     and the same launch and agreement bars
  11. slice 3 times: K4a, K4b, K5a and K5b ms per call against their plain
     versions at B = 4096; each at B = 4096, 1024, 256 and 1 (K4: the PC
     grid's initial-state calls, K5: the random blocks, their first lanes),
     beside its bound and the share of it; the predictor-corrector grid's
     ms per call, solves/s and mean iterations beside phase 4's monotone
     ones; the
     predictor-corrector step's ms per call and steps/s; nmpc_step at B = 1
     in DEFAULT_CONFIG with the predictor-corrector, p50 / p99 over 30 calls
  12. slice 4, the fleet at f32 (engine/workloads.py: fleet_cfg,
     fleet_scene, fleet_lanes): first the fleet's first batched search at
     f64 on the card and, for lanes 0-31, on the CPU, with identical
     status, n_edges, edge_inputs and iterations; then B = 128 for 8 s:
     collided 0, every lane exactly one outcome, reached >= 0.95, states
     and controls finite on the lanes not frozen, the references, K2, the
     tube chain and K3 launched once a tick and K1 once a host-loop step;
     the references, K1, K2, chain and K3 calls of ticks
     20 (a replan) and 25, their arguments recorded during the run (B = 128,
     the 2048-point cloud, shrink_iters 8, max_obs_planes 12), each held
     against its plain version at f64 on the same values with the bars of
     phases 2, 5 and 6 (the references: bit-equal, also at the run's f32;
     K1: identical it/done, 1e-9 (1 + |ref|); K2 and
     the chain: 1e-10 (1 + |ref|), the chain's NaN alike; K3: 1e-9 on every
     row); printed: the outcomes, the
     tick exit-code fractions, the searches, wall seconds and the realtime
     factor B x 8 s / wall (the per-tick trace on); then a 2 s pass with a
     sync around each search, step and plant call (ms per tick of each)
  13. slice 4, one robot at f32: ResilientPlanner + QuadSim +
     run_closed_loop in tests/test_closed_loop.py's configuration on its
     hover-to-goal (4 s), wind-step (5 s) and fence (7 s, obstacle scene)
     scenarios with that file's bars (final position within 0.4 m / 0.5 m,
     failures <= solves // 4; fence: final x > 2.8 and inside the gap band
     while at the fence line), the references, K2, the tube chain and K3
     once a solve, K1 once a host-loop step; in the fence scene the
     references, K1, K2, chain and K3 calls of every 4th solve
     (B = 1, M = 2048) held against their plain versions at f64 with phase
     12's bars, at least one of them with a non-empty cloud; then at
     DEFAULT_CONFIG (its 400 x 400 x 60 map) 3 s hover to goal: the MPC
     tick's p50 / p99 against the 50 ms tick, the search's ms and
     occupied_cloud's ms over the 9.6M voxels
  14. slice 5 at DEFAULT_CONFIG: (a) the FORCES API on the migration
     example's problem (tube-tightened box, E from propagate_tubes) and a
     hover-to-goal problem with f_ext = (0.4, -0.2, 0), each in the normal
     and the final profile: at f64 through K1's f64 build exitflag and
     info.it identical to the port's f64 CPU solve of the same packed
     params and Z within 1e-8 (1 + |ref|); at f32 exitflag 1 and u within
     1e-3 of the f64 CPU solve; K1 launched once per host-loop step (> 1)
     and nothing else; the final profile's terminal speed below half the
     normal one's; the f64 card solution of the hover problem within 1e-3
     in u of oracle/cpu_oracle.py's SLSQP solve (CPU, f64); a predictor-
     corrector solve with exitflag 1, K4a = host-loop steps, K4b = twice
     that, no K1; printed: ms per solve, p50 / p99 of 20, at f32 and f64.
     (b) the bench grid of seed 3 (4096 scenarios) through
     parallel/mesh.py::make_sharded_solver in a world-size-1 NCCL group
     (file rendezvous in a temporary directory, destroyed after): Z, exit
     codes, iterations and every result field bit-equal to
     batch.solve_scenarios on the same ScenarioSet; stats n = 4096 and
     n_solved = (ec == 1).sum(); K1 once per host-loop step; printed: ms
     per call of both, in turns. (c) BASELINE config 5: the ported
     example's streamed path, 25 chunks x 4096 = 102,400 scenarios, run
     as a process with --chunks 8 and then a fresh one with --chunks 25 on
     the same checkpoint directory: resumed_chunks = 8, n_scenarios =
     102,400, resilience >= 0.999, every chunk's exit codes and iterations
     bit-equal to one uninterrupted run of the 25 chunks (in this process,
     K1 once per host-loop step); printed: solves/s and steady state,
     mean / p99 / max iterations, exit-code fractions. (d) entry()'s step
     on the card: finite, its exit code equal to the same call on the CPU,
     the references, K2, the tube chain and K3 launched once and K1 once
     per host-loop step; then
     dryrun_multichip(1) (one spawned NCCL rank) passing its shape check
  15. slice 6 at DEFAULT_CONFIG: (a) the stress batch, B = 512 (seed 123,
     the bench tiers), at f64 and f32 through K1: K1 once per host-loop
     step, Z finite, no false optimal (exit 1 with a corridor violation
     beyond the slack) at either precision; the f64 card solve's exit codes
     and iterations identical to the plain f64 solve on the card, max |dZ|
     printed; the f32 exit families beside the f64 ones. (b) the reduced
     certificate: the bench grid of seed 1000 (B = 4096) and the fence
     scenes (B = 128, built at f64 on the CPU) at f32 through K1, 2 lanes
     of each picked hardest first and re-solved by the oracle's multi-start
     in a pool of 4 CPU processes (started first, collected last): max
     |u_card - u_oracle| <= 1e-3 on every lane. (c) the shipped solver:
     the bench configuration exported for B = 4096 f32 here, loaded and
     run in a fresh process that cannot reach nvcc (not on its PATH, no
     CUDA_HOME, the port's lookup made to raise) and whose build
     directory is empty: bit-equal to this process's solve, no build in
     the child,
     its K1 launches equal to this process's; its wall against phase 1's
     build seconds. (d) the examples at their defaults (config 1 also with
     --oracle, config 6 at FLEET_EXAMPLE_ARGS): each returns and prints its
     line; K1 once per host-loop step, the references and the tube chain
     as often as K2;
     config 1 exit 1 (oracle |du| <= 1e-3), config 2 exit 1 with K2 = K3 =
     1, config 3 K2 = K3 = solves, config 4 solved >= 0.999, config 6 no
     collision, K2 = K3 = ticks
  16. slice 7: K3's gathered route on phase 6's random segments at each of
     GATHERED_CASES (f32 B = 64, M = 16,384; f64 B = 64, M = 8,192; B = 8,
     M = 70,000; k = 64 at M = 256 and 2048 with B = 512), the route checked
     first: f64 rows within 1e-9 of the plain version on every row, f32
     rows' max |d| printed; the first dtype's ms beside the plain version's
     and the bound; the shared route at f64 on the fence's voxel cloud
     (tests/test_closed_loop.py's scene, segments from 0.1 m lattice
     points), within 1e-9 on every row; then BASELINE config 3's loop
     (examples/config3_obstacle_scene.py: the fence, its wind, 7 s) with
     the planner at f64 and max_cloud = 8192: final position within 0.5 m
     of the goal, no trace point in an occupied voxel, K3 once a solve by
     the gathered route, the references, K2 and the tube chain once a
     solve, K1 once a host-loop step; its MPC tick p50 / p99
  17. the headline bench: python3 -m forces_resilient_planner_tpu_torch.
     bench in a child process, which must exit 0 within BENCH_TIMEOUT
     seconds; its [bench] lines printed; its last stdout line one JSON
     line with a value > 0, every key of bench.EXTRAS_KEYS in its extras
     and no other, the card line equal to phase 0's, the closed loop's
     goal reached with no collision, the fleet reached >= 0.95 with 0
     collided, batched steps/s > 0; its headline printed beside phase 4's
     grid rate (information, not a bar)

Every line is prefixed with the script's elapsed seconds.  The
{"kernels"} line's bound_ms is the larger of the bytes the kernel must
move (inputs read once, outputs written once) over the H100's 3.35 TB/s
and its operations over 67 TFLOP/s (f32, no tensor cores), computed from
this run's inputs (K2: the doublings its lanes take; K3: the sets of the
rounds that run on its data; the tube chain: Qd, Q1 and Mp's rows 0-2
read, E and Q2 written; the references: ops/reference_kernel.py::
reference_bytes and reference_operations); library_ms is null for all
nine kernels (no single PyTorch call computes any of them).  The
references' ms is on the card alone (utils/measure.py::device_ms), at
B = 4096, and ms_b1 at B = 1.  K3 has two entries, one per route:
"corridor" (the shared route, phases 6-8) and "corridor_gathered" (phase
16: launches on the f64 planner's run, the rest at B = 64, M = 16,384,
f32).  max_abs_err is, for every kernel, the
f32 kernel against its plain version on the main path's inputs at the
main path's shape (K1: the grid's initial IPM state; K2: the step's stage
lanes; the tube chain: K2's outputs there; K3: the step's segments and
clouds; K4: the predictor-corrector grid's initial calls; K5: the random
blocks of phase 9; the references: 0, bit-equal by phase 6's bar).

K1's, K2's and K3's entries also carry launches_phase15, their launches
on phase 15's paths.

Then the script's total seconds, a {"kernels": [...]} JSON line, the card's
name and power limit, and last {"ok": true, "device": ...}.  Imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from forces_resilient_planner_tpu_torch import bench as port_bench
from forces_resilient_planner_tpu_torch import entry
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.engine import (
    batch,
    fleet,
    pipeline,
    pipeline_batch,
    planner,
    reference,
    simulator,
    workloads,
)
from forces_resilient_planner_tpu_torch.examples import (
    config1_hover_to_goal as config1,
    config2_constant_force as config2,
    config3_obstacle_scene as config3,
    config4_batched as config4,
    config5_monte_carlo as config5,
    config6_fleet as config6,
    forces_api_migration as migration,
)
from forces_resilient_planner_tpu_torch.mapping import occ_grid
from forces_resilient_planner_tpu_torch.ops import (
    _build,
    corridor_kernel,
    ipm_kernel,
    lqr_kernel,
    reference_kernel,
    tube_kernel,
)
from forces_resilient_planner_tpu_torch.oracle import cpu_oracle
from forces_resilient_planner_tpu_torch.oracle import pool as oracle_pool
from forces_resilient_planner_tpu_torch.parallel import mesh
from forces_resilient_planner_tpu_torch.search import kinodynamic
from forces_resilient_planner_tpu_torch.solver import (
    forces_api,
    ipm_lanes,
    nlp,
    riccati,
)
from forces_resilient_planner_tpu_torch.solver.problems import (
    box_corridor,
    hover_warm_start,
)
from forces_resilient_planner_tpu_torch.tools import (
    parity_certificate as parity,
    stress_oracle,
)
from forces_resilient_planner_tpu_torch.tube import lyapunov
from forces_resilient_planner_tpu_torch.utils import aot, checkpoint
from forces_resilient_planner_tpu_torch.utils.measure import (
    bound,
    card_line,
    cuda_ms,
    device_ms,
    k1_flops,
    riccati_factor_flops,
    riccati_solve_flops,
    tensor_bytes,
)

CSRC = "forces_resilient_planner_tpu_torch/ops/csrc/"
KERNEL_SOURCE = CSRC + "ipm_iteration.cu"
KERNEL_REPLACES = "forces_resilient_planner_tpu/ops/ipm_pallas.py:218"
LQR_PALLAS = "forces_resilient_planner_tpu/ops/lqr_pallas.py:"
# the Riccati kernels of ops/csrc/lqr.cu (ops/lqr_kernel.py's LAUNCHES
# keys): their label and the Pallas kernel body each replaces
LQR_KERNELS = {
    "lqr_factor_fused": ("K4a", LQR_PALLAS + "269"),
    "lqr_backsolve_fused": ("K4b", LQR_PALLAS + "316"),
    "lqr_factor": ("K5a", LQR_PALLAS + "100"),
    "lqr_backsolve": ("K5b", LQR_PALLAS + "132"),
}
MAX_ITERS = 60.0
KEYS = pipeline_batch.PIPELINE_ARG_KEYS
STEP_B, STEP_K, STEP_M = 4096, 64, 256
LQR_B, LQR_N = 4096, 20
SEARCH_CPU_LANES = 32    # phase 12: lanes of the f64 search re-run on the CPU
FLEET_SHORT_S = 2.0      # phase 12: the pass timed with a sync at each split
FLEET_HOLD_TICKS = (20, 25)  # phase 12: ticks whose kernel inputs are held
ROBOT_HOLD_SOLVES = range(0, 1000, 4)  # phase 13: the fence scene's solves
# phase 14(c): BASELINE config 5, 25 chunks of the 4096-scenario grid,
# interrupted after 8; MC_ARGS: extra arguments of the example's runs
MC_CHUNKS, MC_RESUME_AFTER = 25, 8
MC_BATCH = workloads.N_GOALS * workloads.N_FORCES
MC_ARGS: list = []
# phase 15: the stress batch, the reduced certificate's seed sets and lanes
# a family, config 6's fleet size and seconds
STRESS_B = 512
CERT_SEEDS, CERT_BOX_LANES, CERT_FENCE_LANES = (1000,), 2, 2
FLEET_EXAMPLE_ARGS = ["8", "2.0"]


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


T0 = time.perf_counter()


def say(msg: str):
    """One line, prefixed with the script's elapsed seconds."""
    print(f"[{time.perf_counter() - T0:6.1f} s] {msg}", flush=True)


def bench_lanes(cfg, seed, dtype, device):
    """The bench grid of `seed`, lane-major, with its initial IPM state."""
    goals, forces = workloads.bench_seeds(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    x0 = np.zeros(9)
    x0[2] = 1.2
    weights = nlp.make_stage_weights(
        cfg.weights, cfg.model.N, dtype=dtype, device=device
    )
    scen = batch._expand_scenarios_device(
        cfg, t(x0), t(goals), t(forces), t(workloads.HALVES), weights
    )
    params = ipm_lanes.lanes_params(scen.params)
    Z0 = scen.Z0.movedim(0, -1).contiguous()
    st = ipm_lanes._init_state(Z0, params, cfg.model, cfg.solver)
    Z, lam, s, mu_d, mu, it, done, err = st
    scal = torch.stack([mu, it.to(dtype), done.to(dtype), err])
    return [Z, lam, s, mu_d, scal], params


def iter_args(state, params, cfg):
    B = state[0].shape[-1]
    mi = torch.full((B,), MAX_ITERS, dtype=state[0].dtype,
                    device=state[0].device)
    return (*state, params.weights, params.ref_pos, params.ref_yaw,
            params.corridor_A, params.corridor_b, params.f_ext, params.xinit,
            mi, cfg.model, cfg.solver)


def bit_equal(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def max_rel(x, y, mask):
    """max |x - y| / (1 + |y|) over the lanes in mask."""
    return ((x - y).abs() / (1.0 + y.abs()))[..., mask].max().item()


def to_f64(state, params):
    def conv(a):
        return a.double()
    return ([conv(a) for a in state],
            ipm_lanes._map_params(conv, params))


def compare_step(state, params, cfg, rel_tol, done_frac, against_f64):
    """One kernel iteration against one plain iteration on the same inputs.

    against_f64=False: |kernel - plain| <= rel_tol (1 + |plain|) on every
    element of the lanes whose done flag agrees.  against_f64=True (f32 in
    mid-solve, where two plain f32 runs of the same code on two devices
    already differ by more than 1e-3): both are held against the f64 step
    from the same state, and the kernel's max relative error must be within
    1.25x the plain f32 step's, plus rel_tol.
    Returns (max rel kernel-vs-plain, max abs kernel-vs-plain, done share).
    """
    args = iter_args(state, params, cfg)
    ref = ipm_kernel.ipm_iteration_reference(*args)
    got = ipm_kernel.ipm_iteration_fused(*args)
    truth = None
    if against_f64:
        truth = ipm_kernel.ipm_iteration_reference(
            *iter_args(*to_f64(state, params), cfg))
    torch.cuda.synchronize()
    done_agree = (ref[4][2] == got[4][2])
    frac = done_agree.double().mean().item()
    if not torch.equal(ref[4][1], got[4][1]):
        fail("kernel and plain iteration counts differ")
    if frac < done_frac:
        fail(f"done flags agree on {frac:.6f} of lanes < {done_frac}")
    rel_all, abs_all = 0.0, 0.0
    for i, name in enumerate(("Z", "lam", "s", "mu_d")):
        r, g = ref[i], got[i]
        if not torch.isfinite(g).all():
            fail(f"{name}: non-finite kernel output")
        rel = max_rel(g, r, done_agree)
        rel_all = max(rel_all, rel)
        abs_all = max(abs_all, (g - r).abs()[..., done_agree].max().item())
        if truth is None:
            if rel > rel_tol:
                fail(f"{name}: max rel deviation {rel:.3e} > {rel_tol}")
            continue
        e_ker = max_rel(g.double(), truth[i], done_agree)
        e_plain = max_rel(r.double(), truth[i], done_agree)
        say(f"  {name}: max rel error vs the f64 step: kernel {e_ker:.3e}, "
            f"plain f32 {e_plain:.3e}; kernel vs plain {rel:.3e}")
        if e_ker > 1.25 * e_plain + rel_tol:
            fail(f"{name}: kernel error vs f64 {e_ker:.3e} > 1.25 x plain "
                 f"{e_plain:.3e} + {rel_tol}")
    return rel_all, abs_all, frac


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# (utils/measure.py: bound, k1_flops, riccati_*_flops)
# ---------------------------------------------------------------------------

def corridor_flops(args, ccfg):
    """K3 per call from this run's data: the bbox filter of every stage's
    cloud, then each executed shrink and peel round's set times the
    operations of one evaluation, plus each round's scalar chain
    (ops/corridor_kernel.py::decompose_stages_work).  Returns (operations,
    the counts)."""
    work = corridor_kernel.decompose_stages_work(*args, ccfg)
    return corridor_kernel.work_operations(work), work


# ---------------------------------------------------------------------------
# slice 2: the batched full NMPC step
# ---------------------------------------------------------------------------

def step_inputs(seed, B, dtype, device, K=STEP_K, M=STEP_M, cfg=DEFAULT_CONFIG,
                drift=False):
    """The bench's full-step workload (bench.py:277-296,
    __graft_entry__._example_inputs) with per-robot variety drawn from
    `seed`: each robot its own obstacle cloud from the same distribution,
    f_ext in [-1, 1]^3, t_offset in [0, 0.3], every 8th robot on the final
    profile, its deque perturbed by 1e-4.  drift=True: every 4th robot has
    drifted from its last plan, its whole deque shifted by N(0, 0.3) m in
    position and N(0, 1) m/s in velocity (more iterations; some robots end
    at max_iters, the NaN guard or no progress)."""
    rng = np.random.default_rng(seed)
    N = cfg.model.N
    x0 = np.zeros(9)
    x0[2] = 1.2
    Z = hover_warm_start(torch.as_tensor(x0), cfg.model).numpy()
    out = np.concatenate([Z, Z[-1:]], axis=0)
    t = np.arange(K) * cfg.model.dt
    path = np.stack([1.2 * t, 0.3 * t, np.full(K, 1.2)], -1)
    obs = rng.uniform([-1, -3, 0], [5, 3, 2.5], (B, M, 3))
    obs = np.where(np.abs(obs[..., 1:2]) < 0.8, obs + np.array([0, 2.0, 0]),
                   obs)
    out = out[None] + rng.normal(0, 1e-4, (B, N + 1, 17))
    if drift:
        moved = np.arange(B) % 4 == 1
        d = np.random.default_rng(seed + 77)
        out[moved, :, 8:11] += d.normal(0, 0.3, (moved.sum(), 1, 3))
        out[moved, :, 11:14] += d.normal(0, 1.0, (moved.sum(), 1, 3))
    args = dict(
        mpc_output=out,
        kino_path=np.broadcast_to(path, (B, K, 3)),
        kino_size=np.full(B, K),
        t_offset=rng.uniform(0.0, 0.3, B),
        state_mpc=np.broadcast_to(x0, (B, 9)),
        f_ext=rng.uniform(-1.0, 1.0, (B, 3)),
        end_pt=np.broadcast_to(path[-1], (B, 3)),
        obstacles=obs,
        obstacle_mask=np.ones((B, M), bool),
        use_final=np.arange(B) % 8 == 7,
    )
    return pipeline_batch.pipeline_inputs_from_numpy(args, dtype=dtype,
                                                     device=device)


def step(inputs, cfg=DEFAULT_CONFIG):
    return pipeline_batch.nmpc_step_batched(*[inputs[k] for k in KEYS],
                                            cfg=cfg)


@contextlib.contextmanager
def plain_routes():
    """Every kernel wrapper replaced by its plain PyTorch version."""
    with contextlib.ExitStack() as stack:
        for module, name, plain in (
            (tube_kernel, "tube_stage_lanes", tube_kernel.tube_stage_reference),
            (tube_kernel, "tube_chain_lanes", tube_kernel.tube_chain_reference),
            (corridor_kernel, "decompose_stages_lanes",
             corridor_kernel.decompose_stages_reference),
            (ipm_kernel, "ipm_iteration_fused",
             ipm_kernel.ipm_iteration_reference),
            (lqr_kernel, "lqr_factor_fused_lanes",
             lqr_kernel.lqr_factor_fused_reference),
            (lqr_kernel, "lqr_backsolve_fused_lanes",
             lqr_kernel.lqr_backsolve_fused_reference),
            (reference_kernel, "sample_references_lanes",
             reference.sample_references_plain),
        ):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def other_gain(seed=12):
    """A feedback gain other than the config's: 1.3 K plus a seeded
    perturbation, (4, 9) float64 (tests/test_torch_tube.py::_other_gain)."""
    rng = np.random.default_rng(seed)
    return 1.3 * np.asarray(DEFAULT_CONFIG.tube.K) + rng.normal(0, 0.05, (4, 9))


def tube_check(x, u, device, K=None,
               dtypes=(torch.float64, torch.float32)):
    """K2 vs plain on the stage lanes x (L, 9), u (L, 4) (numpy) with the
    gain K (None: the config's) at each dtype.  Returns the f32 max |d|
    over outputs and a report."""
    cfg = DEFAULT_CONFIG
    f32_bounds = {"Qd": 1e-6, "Mp": 2e-6, "Phi": 2e-5, "Q1": 1e-6}
    worst32, msg = 0.0, []
    for dtype in dtypes:
        xt = torch.as_tensor(x, dtype=dtype, device=device)
        ut = torch.as_tensor(u, dtype=dtype, device=device)
        ref = tube_kernel.tube_stage_reference(xt, ut, cfg.model, cfg.tube, K)
        got = tube_kernel.tube_stage_lanes(xt, ut, cfg.model, cfg.tube, K)
        torch.cuda.synchronize()
        for name, g, r in zip(f32_bounds, got, ref):
            if not torch.isfinite(g).all():
                fail(f"K2 {name} {dtype}: non-finite kernel output")
            d = (g - r).abs()
            if dtype == torch.float64:
                rel = (d / (1 + r.abs())).max().item()
                if rel > 1e-10:
                    fail(f"K2 {name} f64: max rel {rel:.3e} > 1e-10")
                msg.append(f"{name} f64 rel {rel:.2e}")
            else:
                err = d.max().item()
                if err > f32_bounds[name]:
                    fail(f"K2 {name} f32: max abs {err:.3e} > "
                         f"{f32_bounds[name]}")
                worst32 = max(worst32, err)
                msg.append(f"{name} f32 abs {err:.2e}")
    return worst32, "; ".join(msg)


def chain_check(Qd, Mp, Q1, tcfg, label):
    """The tube chain vs its plain version on K2's outputs Qd, Mp (B, N, 9,
    9), Q1 (B, N, 3, 3) at their dtype with the tube configuration tcfg:
    NaN in E and Q2 exactly where the
    plain chain has it, and elsewhere f64 |d| <= 1e-10 (1 + |ref|), f32
    max |d| <= 1e-6 (tests/test_torch_tube.py's bars for the source).
    Returns the max relative (f64) or absolute (f32) deviation, a report
    and the kernel's NaN entries."""
    f64 = Q1.dtype == torch.float64
    args = [t.contiguous() for t in (Qd, Mp, Q1)]
    ref = tube_kernel.tube_chain_reference(*args, tcfg)
    got = tube_kernel.tube_chain_lanes(*args, tcfg)
    torch.cuda.synchronize()
    worst, msg, nans = 0.0, [], 0
    for name, g, r in zip(("E", "Q2"), got, ref):
        if not torch.equal(g.isnan(), r.isnan()):
            fail(f"the chain {label}: {name} NaN at {int(g.isnan().sum())} "
                 f"entries, the plain chain at {int(r.isnan().sum())}")
        d = torch.where(g == r, torch.zeros_like(g), (g - r).abs())
        d = d.nan_to_num(nan=0.0)
        err = (d / (1 + r.abs().nan_to_num(nan=0.0))).max().item() if f64 \
            else d.max().item()
        if not err <= (1e-10 if f64 else 1e-6):
            fail(f"the chain {label}: {name} max {'rel' if f64 else 'abs'} "
                 f"{err:.3e} > {1e-10 if f64 else 1e-6}")
        worst = max(worst, err)
        nans += int(g.isnan().sum())
        same = ((g == r) | (g.isnan() & r.isnan())).double().mean().item()
        msg.append(f"{name} {'rel' if f64 else 'abs'} {err:.2e}, "
                   f"{int(g.isnan().sum())} NaN, bit-equal {same:.6f}")
    return worst, "; ".join(msg), nans


def chain_bound(Qd, Mp, Q1):
    """utils/measure.py::bound of the tube chain on Qd, Mp (B, N, 9, 9), Q1
    (B, N, 3, 3): Qd, Q1 and Mp's rows 0-2 read, E and Q2 written, over
    tube_kernel.tube_chain_operations."""
    B, N = Q1.shape[0], Q1.shape[1]
    nbytes = (tensor_bytes(Qd, Q1) + 2 * Q1.numel() * Q1.element_size()
              + Mp.element_size() * B * N * 27)
    return bound(nbytes, tube_kernel.tube_chain_operations(B, N))


def references_check(inputs, label):
    """Stage 1's references kernel against its plain version on the card,
    on the step's own inputs (mpc_output's row-1 views, as nmpc_step_batched
    passes them), for all robots and for the first alone: ref_pos, ref_yaw
    and stage0_jump bit-equal, one launch a call.  Returns a report."""
    cfg = DEFAULT_CONFIG
    N, dt, msg = cfg.model.N, cfg.model.dt, []
    for Bw in (inputs["kino_path"].shape[0], 1):
        prev = inputs["mpc_output"][:Bw]
        args = (inputs["kino_path"][:Bw], inputs["kino_size"][:Bw],
                inputs["t_offset"][:Bw], prev[:, 1, 16], prev[:, 1, 8:11])
        before = reference_kernel.LAUNCHES
        got = reference.sample_references(*args, N, dt)
        launched = reference_kernel.LAUNCHES - before
        want = reference.sample_references_plain(*args, N, dt)
        torch.cuda.synchronize()
        if launched != 1:
            fail(f"the references {label} B={Bw}: {launched} launches, want 1")
        for name, g, w in zip(reference.ReferenceResult._fields, got, want):
            if not (g.dtype == w.dtype and g.shape == w.shape
                    and torch.equal(g, w)):
                d = (g.double() - w.double()).abs().max().item()
                fail(f"the references {label} B={Bw}: {name} not bit-equal "
                     f"to the plain version (max |d| {d:.3e})")
        msg.append(f"B={Bw} bit-equal")
    return ", ".join(msg)


def reference_bound(kino_path, N):
    """utils/measure.py::bound of the references kernel on kino_path
    (B, K, 3): reference_kernel.reference_bytes over
    reference_kernel.reference_operations."""
    B, K = kino_path.shape[0], kino_path.shape[1]
    return bound(reference_kernel.reference_bytes(
        B, K, N, kino_path.element_size()),
        reference_kernel.reference_operations(B, N))


def random_segments(B, N, M, seed):
    """Generic random stage segments and clouds (the inputs of
    tools/kernel_parity_debug.py:86-93)."""
    rng = np.random.default_rng(seed)
    p1 = rng.uniform([-1, -1, 0.8], [1, 1, 1.6], (B, N, 3))
    yaw = rng.uniform(-np.pi, np.pi, (B, N))
    p2 = p1 + 0.1 * np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)],
                             -1)
    obs = rng.uniform([-3, -3, -0.5], [3, 3, 3], (B, M, 3))
    mask = rng.uniform(size=(B, M)) < 0.9
    return p1, p2, obs, mask


def corridor_rows(args, ccfg=DEFAULT_CONFIG.corridor,
                  nh=DEFAULT_CONFIG.model.nh):
    """K3 and its plain version on the same inputs: per-(robot, stage) max
    |dA|, |db| over the rows."""
    Ag, bg = corridor_kernel.decompose_stages_lanes(*args, ccfg, nh)
    Ar, br = corridor_kernel.decompose_stages_reference(*args, ccfg, nh)
    torch.cuda.synchronize()
    if not (torch.isfinite(Ag).all() and torch.isfinite(bg).all()):
        fail("K3: non-finite kernel output")
    return (Ag - Ar).abs().amax(dim=(-1, -2)), (bg - br).abs().amax(dim=-1)


def stage_segments(inputs, cfg):
    """The corridor kernel's inputs on the main path: every stage's
    reference point, its second seed point, and the robot's cloud."""
    ref = reference.sample_references(
        inputs["kino_path"], inputs["kino_size"], inputs["t_offset"],
        inputs["mpc_output"][:, 1, 16], inputs["mpc_output"][:, 1, 8:11],
        N=cfg.model.N, Ts=cfg.model.dt)
    return (ref.ref_pos.contiguous(),
            pipeline.corridor_seed2(ref, cfg).contiguous(),
            inputs["obstacles"], inputs["obstacle_mask"])


def corridor_f64(args, label, phase=6):
    """K3 vs plain at f64: A and b within 1e-9 on every row."""
    dA, db = corridor_rows(args)
    worst = max(dA.max().item(), db.max().item())
    if worst > 1e-9:
        fail(f"K3 f64 {label}: max row |d| {worst:.3e} > 1e-9 on "
             f"{int(((dA > 1e-9) | (db > 1e-9)).sum())} (robot, stage)")
    say(f"phase {phase} K3 vs plain f64, {label}: max |dA| {dA.max().item():.2e}, "
        f"max |db| {db.max().item():.2e} (bar 1e-9 on every row)")


def reset_counts():
    """Every kernel's launch count and the host-loop step count to 0."""
    torch.cuda.synchronize()
    tube_kernel.LAUNCHES = tube_kernel.CHAIN_LAUNCHES = ipm_kernel.LAUNCHES = 0
    reference_kernel.LAUNCHES = 0
    for name in corridor_kernel.LAUNCHES:
        corridor_kernel.LAUNCHES[name] = 0
    for name in lqr_kernel.LAUNCHES:
        lqr_kernel.LAUNCHES[name] = 0
    ipm_lanes.STEPS = 0


def launch_counts():
    """(K1, K2, K3, K4a, K4b, the tube chain, the references) launches
    (K3: both routes)."""
    return (ipm_kernel.LAUNCHES, tube_kernel.LAUNCHES,
            sum(corridor_kernel.LAUNCHES.values()),
            lqr_kernel.LAUNCHES["lqr_factor_fused"],
            lqr_kernel.LAUNCHES["lqr_backsolve_fused"],
            tube_kernel.CHAIN_LAUNCHES, reference_kernel.LAUNCHES)


def solver_launches_ok(counts, steps, scfg) -> bool:
    """Monotone with 30 corridor rows: one K1 per host-loop step and no K4;
    predictor-corrector: one K4a and two K4b per step and no K1."""
    l1, l4a, l4b = counts[0], counts[3], counts[4]
    if scfg.predictor_corrector:
        return l1 == 0 and l4a == steps > 0 and l4b == 2 * steps
    return l1 == steps > 0 and l4a == l4b == 0


def check_grid(dev, cfg, phase, solved_min=None):
    """Phase 3 (phase 10 with the predictor-corrector): the bench grid of
    seed 1 solved at f32 through the kernels, its launch counts (one K1 per
    host-loop step, or one K4a and two K4b), finite Z and finite accepted
    outputs, the solved fraction (>= solved_min when given, else printed),
    lanes 0-63 re-solved at f64 on the CPU (at most one of the card's
    solved lanes missing, u within 1e-3), and the same solve through the
    plain versions on the card: solved fraction within 0.005, exit codes
    agreeing on >= 99.5% of lanes.  Returns the launch counts
    (launch_counts())."""
    goals, forces = workloads.bench_seeds(1)
    reset_counts()
    res = batch.solve_scenario_grid(cfg, goals, forces, workloads.HALVES,
                                    dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    counts, steps = launch_counts(), ipm_lanes.STEPS
    if "jax" in sys.modules:
        fail("jax was imported")
    if not solver_launches_ok(counts, steps, cfg.solver):
        fail(f"grid launches K1 {counts[0]}, K4a {counts[3]}, K4b {counts[4]} "
             f"vs host-loop steps {steps}")
    ec = res.exit_code.cpu()
    acc = ec == 1
    B = ec.numel()
    if B != workloads.N_GOALS * workloads.N_FORCES * len(workloads.HALVES):
        fail(f"grid has {B} lanes")
    if not torch.isfinite(res.Z).all():
        fail("non-finite Z")
    for name in ("lam", "s", "mu_d", "kkt_error"):
        if not torch.isfinite(getattr(res, name)[acc.to(dev)]).all():
            fail(f"non-finite {name} on accepted lanes")
    solved = acc.double().mean().item()
    if solved_min is not None and solved < solved_min:
        fail(f"solved fraction {solved:.6f} < {solved_min}")

    ref64 = batch.solve_scenario_grid(cfg, goals[:4], forces, workloads.HALVES,
                                      dtype=torch.float64, device="cpu")
    both = (ref64.exit_code == 1) & acc[:64]
    du = (res.Z[:64, :, 0:4].double().cpu() - ref64.Z[:, :, 0:4]).abs()
    du_max = du[both].max().item() if both.any() else float("inf")
    if both.sum() < acc[:64].sum() - 1 or du_max > 1e-3:
        fail(f"f64 CPU re-solve: {int(both.sum())} lanes solved by both of "
             f"{int(acc[:64].sum())}, max |du| {du_max:.3e} (bar 1e-3)")

    with plain_routes():
        plain = batch.solve_scenario_grid(cfg, goals, forces, workloads.HALVES,
                                          dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    if launch_counts() != counts:
        fail("the plain grid solve launched a kernel")
    ec_p = plain.exit_code.cpu()
    solved_p = (ec_p == 1).double().mean().item()
    agree = (ec_p == ec).double().mean().item()
    codes = {int(c): int((ec == c).sum()) for c in ec.unique()}
    label = ("main path" if not cfg.solver.predictor_corrector else
             "predictor-corrector grid")
    say(f"phase {phase} {label} B={B} f32: solved {solved:.6f}"
        f"{' (not barred)' if solved_min is None else ''}, exit codes "
        f"{codes}, launches K1 {counts[0]} K4a {counts[3]} K4b {counts[4]}, "
        f"host-loop steps {steps}, mean iters "
        f"{res.iters.double().mean().item():.3f}, max iters "
        f"{int(res.iters.max())}; f64 CPU re-solve of lanes 0-63: max |du| "
        f"{du_max:.3e} over {int(both.sum())} lanes; plain versions on the "
        f"card: solved {solved_p:.6f}, exit codes agree on {agree:.6f}")
    if abs(solved - solved_p) > 0.005:
        fail(f"grid solved {solved:.6f} vs plain {solved_p:.6f}")
    if agree < 0.995:
        fail(f"grid exit codes agree on {agree:.6f} < 0.995 of lanes")
    return counts


def check_step(inputs, dev, label, cfg=DEFAULT_CONFIG, phase=7,
               agree_min=None):
    """Phase 7 (phase 10 with the predictor-corrector) on one input set: the
    step through the kernels with its launch counts, finiteness, the f64
    audit, and the same step through the plain versions on the card, its
    solved fraction within 0.005 and, when agree_min is given, its exit
    codes agreeing on at least that share of robots.  Returns the launch
    counts (launch_counts())."""
    B = inputs["mpc_output"].shape[0]
    reset_counts()
    res = step(inputs, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    l1, l2, l3, l4a, l4b, lc, lr = counts
    steps = ipm_lanes.STEPS
    if "jax" in sys.modules:
        fail("jax was imported")
    if not (lr == l2 == lc == l3 == 1 and solver_launches_ok(counts, steps,
                                                             cfg.solver)):
        fail(f"launches: the references {lr}, K2 {l2}, the chain {lc}, K3 "
             f"{l3} (want 1 each), K1 {l1}, K4a {l4a}, K4b {l4b} vs "
             f"host-loop steps {steps}")
    ec = res.exit_code.cpu()
    acc = ec == 1
    solved = acc.double().mean().item()
    if not torch.isfinite(res.mpc_output).all():
        fail("non-finite mpc_output")
    for name in ("corridor_A", "corridor_b", "corridor_b_tight", "tube_E",
                 "kkt_error"):
        if not torch.isfinite(getattr(res, name)[acc.to(dev)]).all():
            fail(f"non-finite {name} on accepted robots")
    if not all(torch.isfinite(t).all() for t in res.ref):
        fail("non-finite references")
    pen, n_pen, viol, n_both, du = parity.pipeline_audit(res, inputs,
                                                         cfg)
    solved64 = int(acc[:64].sum())
    codes = {int(c): int((ec == c).sum()) for c in ec.unique()}
    say(f"phase {phase} main path nmpc_step_batched B={B} f32{label}: solved "
        f"{solved:.6f}, exit codes {codes}, launches references {lr} K2 {l2} "
        f"chain {lc} K3 {l3} K1 {l1} K4a {l4a} K4b {l4b}, host-loop steps "
        f"{steps}, mean iters "
        f"{res.iters.double().mean().item():.3f}; f64 audit: max "
        f"obstacle penetration {pen} m ({n_pen} stages), max accepted "
        f"corridor violation {viol:.3e}, re-solve of robots 0-63 max |du| "
        f"{du:.3e} over {n_both} robots (card solved {solved64})")
    if pen != 0.0:
        fail(f"obstacle penetration {pen} m into a tightened corridor")
    if viol > 1e-4:
        fail(f"accepted trajectories violate their corridors by {viol:.3e}")
    if n_both < 0.95 * solved64 or du > 1e-3:
        fail(f"f64 re-solve: {n_both} robots solved by both of {solved64}, "
             f"max |du| {du:.3e} (bar 1e-3)")

    with plain_routes():
        plain = step(inputs, cfg)
    torch.cuda.synchronize()
    if launch_counts() != counts:
        fail("the plain step launched a kernel")
    ec_p = plain.exit_code.cpu()
    solved_p = (ec_p == 1).double().mean().item()
    agree = (ec_p == ec).double().mean().item()
    say(f"phase {phase} plain versions on the card{label}: solved "
        f"{solved_p:.6f} (kernel path {solved:.6f}), exit codes agree on "
        f"{agree:.6f} of robots")
    if abs(solved - solved_p) > 0.005:
        fail(f"solved fraction {solved:.6f} vs plain {solved_p:.6f}")
    if agree_min is not None and agree < agree_min:
        fail(f"exit codes agree on {agree:.6f} < {agree_min} of robots")
    return counts


def one_robot_latency(cfg, label, M, dev, card, calls=30, phase=8):
    """engine/pipeline.py::nmpc_step (B = 1) p50 / p99 over `calls` calls,
    each with a fresh 1e-3 perturbation of the state and force."""
    f32 = torch.float32
    one = step_inputs(7, 1, f32, dev, M=M, cfg=cfg)
    one = {k: v[0] for k, v in one.items()}
    rng = np.random.default_rng(0)

    def single(a):
        return pipeline.nmpc_step(*[a[k] for k in KEYS], cfg=cfg)

    single(one)
    torch.cuda.synchronize()
    lat, ec = [], []
    for _ in range(calls):
        a = dict(one)
        a["state_mpc"] = one["state_mpc"] + torch.as_tensor(
            rng.normal(0, 1e-3, 9), dtype=f32, device=dev)
        a["f_ext"] = one["f_ext"] + torch.as_tensor(
            rng.normal(0, 1e-3, 3), dtype=f32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = single(a)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        ec.append(int(r.exit_code))
    lat = 1e3 * np.asarray(lat)
    say(f"phase {phase} nmpc_step B=1 {label} M={M} f32 [{card}]: p50 "
        f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} "
        f"ms over {calls} calls, solved {np.mean(np.asarray(ec) == 1):.3f}")


def run_slice2(dev, card):
    """Phases 5-8; returns the {"kernels"} entries of K2, the tube chain,
    K3 and the references."""
    cfg = DEFAULT_CONFIG
    N, B = cfg.model.N, STEP_B
    f32 = torch.float32

    inputs = step_inputs(1, B, f32, dev)
    in64 = step_inputs(1, B, torch.float64, dev)

    # ---- phase 5: K2 vs plain at L = B N ----------------------------------
    rng = np.random.default_rng(9)
    x = rng.normal(0, 0.4, (B * N, 9))
    u = np.array([0, 0, 0, 7.3]) + rng.normal(0, 0.5, (B * N, 4))
    _, msg = tube_check(x, u, dev)
    say(f"phase 5 K2 vs plain L={B * N}, random tube-regime lanes: {msg}")
    Z = in64["mpc_output"][:, :N].reshape(B * N, 17).cpu().numpy()
    err2, msg = tube_check(Z[:, 8:17], Z[:, 0:4], dev)
    say(f"phase 5 K2 vs plain L={B * N}, the main path's stage lanes: {msg}")
    K = torch.as_tensor(other_gain())
    _, msg = tube_check(Z[:, 8:17], Z[:, 0:4], dev, K, (torch.float64,))
    phi_cfg = tube_kernel.tube_stage_lanes(
        torch.as_tensor(Z[:256, 8:17], device=dev),
        torch.as_tensor(Z[:256, 0:4], device=dev), cfg.model, cfg.tube)[2]
    phi_k = tube_kernel.tube_stage_lanes(
        torch.as_tensor(Z[:256, 8:17], device=dev),
        torch.as_tensor(Z[:256, 0:4], device=dev), cfg.model, cfg.tube, K)[2]
    moved = (phi_k - phi_cfg).abs().max().item()
    if not moved > 1e-3:
        fail(f"K2 with an explicit gain: Phi moved by {moved:.3e} only")
    say(f"phase 5 K2 vs plain L={B * N}, the main path's stage lanes, an "
        f"explicit gain 1.3 K + N(0, 0.05): {msg}; Phi moved {moved:.3e} "
        "from the config gain's")
    # the tube chain on K2's outputs there, B robots of N stages; at f32
    # also with one stage's Qd made NaN
    for dtype in (torch.float64, torch.float32):
        Qd, Mp, _, Q1 = tube_kernel.tube_stage_lanes(
            torch.as_tensor(Z[:, 8:17], dtype=dtype, device=dev),
            torch.as_tensor(Z[:, 0:4], dtype=dtype, device=dev),
            cfg.model, cfg.tube)
        chain_args = (Qd.reshape(B, N, 9, 9), Mp.reshape(B, N, 9, 9),
                      Q1.reshape(B, N, 3, 3))
        for Bc in (1, B):                  # errc: B robots' f32
            errc, msg, _ = chain_check(*(a[:Bc] for a in chain_args),
                                       cfg.tube, str(dtype)[6:])
            say(f"phase 5 the tube chain vs plain {str(dtype)[6:]} B={Bc} "
                f"N={N}, on K2's outputs of the main path's stage lanes: {msg} "
                f"(bar {'1e-10 (1+|ref|)' if dtype == torch.float64 else '1e-6'}"
                ", NaN alike)")
    Qd_nan = chain_args[0].clone()
    Qd_nan[5, 8, 0, 0] = float("nan")
    _, msg, nans = chain_check(Qd_nan, *chain_args[1:], cfg.tube,
                               "a NaN stage")
    if nans == 0:
        fail("the chain with a NaN stage: no NaN in its outputs")
    say(f"phase 5 the tube chain vs plain float32 B={B} N={N}, robot 5's "
        f"stage 8 Qd NaN: {msg}, NaN where the plain chain has it")
    del Qd, Mp, Q1, Qd_nan

    # ---- phase 6: the references and K3 vs plain ----------------------------
    for a, label in ((in64, "float64"), (inputs, "float32")):
        say(f"phase 6 the references vs plain {label} N={N}, the main path's "
            f"inputs: {references_check(a, label)} (bar bit-equal, one "
            "launch a call)")
    for Bc, M in ((256, 256), (64, 2048)):
        p1, p2, obs, mask = random_segments(Bc, N, M, 31)
        args = [torch.as_tensor(a, dtype=torch.float64, device=dev)
                for a in (p1, p2, obs)] + [torch.as_tensor(mask, device=dev)]
        corridor_f64(args, f"generic B={Bc} N={N} M={M}")
    corridor_f64(stage_segments(in64, cfg),
                 f"the main path's B={B} N={N} M={STEP_M}")
    args3 = stage_segments(inputs, cfg)
    dA, db = corridor_rows(args3)
    err3 = max(dA.max().item(), db.max().item())
    share = ((dA <= 1e-4) & (db <= 1e-4)).double().mean().item()
    say(f"phase 6 K3 vs plain f32 B={B} N={N} M={STEP_M}: rows within 1e-4 "
        f"on {share:.6f} of (robot, stage); max |dA| {dA.max().item():.2e}, "
        f"max |db| {db.max().item():.2e} (f32 argmin ties; not barred)")
    del in64

    # ---- phase 7: the slice-2 main path -----------------------------------
    _, l2, l3, _, _, lc, lr = check_step(inputs, dev, "")
    check_step(step_inputs(2, B, f32, dev, drift=True), dev,
               ", every 4th robot drifted")

    # ---- phase 8: times ---------------------------------------------------
    Z = inputs["mpc_output"][:, :N]
    x = Z[..., 8:17].reshape(B * N, 9).contiguous()
    u = Z[..., 0:4].reshape(B * N, 4).contiguous()
    targs = (x, u, cfg.model, cfg.tube)
    ms2 = cuda_ms(lambda: tube_kernel.tube_stage_lanes(*targs), 10)
    ms2p = cuda_ms(lambda: tube_kernel.tube_stage_reference(*targs), 3)
    msc = cuda_ms(lambda: tube_kernel.tube_chain_lanes(*chain_args,
                                                       cfg.tube), 10)
    mscp = cuda_ms(lambda: tube_kernel.tube_chain_reference(*chain_args,
                                                            cfg.tube), 3)
    bc = chain_bound(*chain_args)
    cargs = (*args3, cfg.corridor, cfg.model.nh)
    ms3 = cuda_ms(lambda: corridor_kernel.decompose_stages_lanes(*cargs), 5)
    ms3p = cuda_ms(lambda: corridor_kernel.decompose_stages_reference(*cargs),
                   2)
    Phi = tube_kernel.tube_stage_reference(*targs)[2]
    ops2 = tube_kernel.tube_stage_operations(Phi, cfg.model.dt,
                                             lyapunov.taylor_n_terms(f32))
    b2 = bound(tensor_bytes(x, u, tube_kernel.tube_stage_reference(*targs)),
               ops2)
    refs, msr, msr_host = {}, {}, {}
    for Bw in (B, 1):
        prev = inputs["mpc_output"][:Bw]
        refs[Bw] = (inputs["kino_path"][:Bw], inputs["kino_size"][:Bw],
                    inputs["t_offset"][:Bw], prev[:, 1, 16], prev[:, 1, 8:11],
                    N, cfg.model.dt)
        msr[Bw] = device_ms(lambda: reference.sample_references(*refs[Bw]),
                            20)
        msr_host[Bw] = cuda_ms(
            lambda: reference.sample_references(*refs[Bw]), 20)
    msrp = cuda_ms(lambda: reference.sample_references_plain(*refs[B]), 3)
    br = reference_bound(refs[B][0], N)
    ops3, work3 = corridor_flops(args3, cfg.corridor)
    b3 = bound(tensor_bytes(args3, corridor_kernel.decompose_stages_reference(
        *cargs)), ops3)
    say(f"phase 8 kernels f32 [{card}]: K2 {ms2:.3f} ms vs plain {ms2p:.3f} "
        f"ms at L={B * N}, bound {b2[0]:.4f} ms by {b2[1]} "
        f"({1e-9 * ops2:.3f} GFLOP), {100 * b2[0] / ms2:.2f}% of the bound; "
        f"the tube chain {msc:.4f} ms vs plain {mscp:.3f} ms at B={B} N={N}, "
        f"bound {bc[0]:.4f} ms by {bc[1]}, {100 * bc[0] / msc:.2f}% of the "
        "bound; "
        f"K3 {ms3:.3f} ms vs plain {ms3p:.3f} ms at B={B} N={N} M={STEP_M}, "
        f"bound {b3[0]:.4f} ms by {b3[1]} ({1e-9 * ops3:.4f} GFLOP of work "
        f"{work3}), {100 * b3[0] / ms3:.2f}% of the bound; the references "
        f"on the card alone {msr[B]:.4f} ms at B={B}, {msr[1]:.4f} ms at "
        f"B=1 (with the host's launch cost {msr_host[B]:.4f} / "
        f"{msr_host[1]:.4f} ms) vs plain {msrp:.3f} ms at B={B} N={N}, "
        f"bound {br[0]:.5f} ms by {br[1]}, {100 * br[0] / msr[B]:.2f}% of "
        "the bound")
    # K3 at the configuration's own obstacle buffer (CorridorConfig.
    # max_obstacles), where its groups widen
    Mx = cfg.corridor.max_obstacles
    big = stage_segments(step_inputs(1, B, f32, dev, M=Mx), cfg)
    lib3 = _build.load(corridor_kernel.SOURCE, corridor_kernel._bind)
    msx = cuda_ms(lambda: corridor_kernel.decompose_stages_lanes(
        *big, cfg.corridor, cfg.model.nh), 5)
    geo = corridor_kernel.launch_geometry(lib3, B, N, Mx, f32)
    say(f"phase 8 K3 f32 [{card}] at B={B} N={N} M={Mx}: {msx:.3f} ms "
        f"(route {geo.route}, {geo.lanes} lanes per stage, {geo.threads} "
        f"threads, {geo.smem} B of shared memory per CTA)")
    del big

    for drift, label in ((False, ""), (True, ", every 4th robot drifted")):
        step_times(cfg, dev, drift, label, card, 8)

    small = workloads.small_cfg()
    one_robot_latency(small, "small_cfg (reduced caps)",
                      small.corridor.max_obstacles, dev, card)
    one_robot_latency(cfg, "DEFAULT_CONFIG", STEP_M, dev, card)

    return [
        {"name": "tube_stage", "route": "cuda", "source": CSRC + "tube_stage.cu",
         "replaces": "forces_resilient_planner_tpu/ops/tube_pallas.py:65",
         "launches": l2, "max_abs_err": err2, "ms": ms2, "plain_ms": ms2p,
         "bound_ms": b2[0], "bound_by": b2[1], "library_ms": None},
        {"name": "tube_chain", "route": "cuda", "source": CSRC + "tube_chain.cu",
         "replaces": "forces_resilient_planner_tpu/tube/lyapunov.py:399-420 "
                     "(jnp, fused by XLA)",
         "launches": lc, "max_abs_err": errc, "ms": msc, "plain_ms": mscp,
         "bound_ms": bc[0], "bound_by": bc[1], "library_ms": None},
        {"name": "corridor", "route": "cuda", "source": CSRC + "corridor.cu",
         "replaces": "forces_resilient_planner_tpu/ops/corridor_pallas.py:98",
         "launches": l3, "max_abs_err": err3, "ms": ms3, "plain_ms": ms3p,
         "bound_ms": b3[0], "bound_by": b3[1], "library_ms": None},
        {"name": "references", "route": "cuda",
         "source": CSRC + "reference.cu",
         "replaces": "forces_resilient_planner_tpu/engine/reference.py:24-75 "
                     "(jnp, fused by XLA)",
         "launches": lr, "max_abs_err": 0.0, "ms": msr[B], "ms_b1": msr[1],
         "plain_ms": msrp, "bound_ms": br[0], "bound_by": br[1],
         "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# slice 3: the Mehrotra predictor-corrector and the Riccati kernels
# ---------------------------------------------------------------------------

def with_pc(cfg):
    """cfg with the Mehrotra predictor-corrector on."""
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, predictor_corrector=True))


def lane_state(state):
    """bench_lanes' packed state as lane_step's (Z, lam, s, mu_d, mu, it,
    done, err)."""
    Z, lam, s, mu_d, scal = state
    return (Z, lam, s, mu_d, scal[0], scal[1].to(torch.int32),
            scal[2] > 0.5, scal[3])


def record_k4(st, params, cfg):
    """One plain lane_step from st with the K4 wrappers' arguments recorded.
    Returns the factor's arguments and the list of each backsolve's
    arguments (against the plain factor)."""
    calls = []

    def recorded(plain):
        def wrapper(*args):
            calls.append(args)
            return plain(*args)
        return wrapper

    with mock.patch.object(
            lqr_kernel, "lqr_factor_fused_lanes",
            recorded(lqr_kernel.lqr_factor_fused_reference)), \
        mock.patch.object(
            lqr_kernel, "lqr_backsolve_fused_lanes",
            recorded(lqr_kernel.lqr_backsolve_fused_reference)):
        ipm_lanes.lane_step(st, params, cfg.model, cfg.solver, int(MAX_ITERS))
    return calls[0], calls[1:]


def map_tensors(fn, args):
    """args with fn applied to every tensor, also inside (named) tuples."""
    def conv(a):
        if torch.is_tensor(a):
            return fn(a)
        if isinstance(a, tuple):
            items = [conv(t) for t in a]
            return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
        return a
    return tuple(conv(a) for a in args)


def as_f64(args):
    """args with every floating tensor (also the fields of a factor or of
    the stage weights) in float64."""
    return map_tensors(
        lambda t: t.double() if t.is_floating_point() else t, args)


def rel_dev(x, y):
    """max |x - y| / (1 + |y|)"""
    return ((x - y).abs() / (1.0 + y.abs())).max().item()


def k4_jobs(fac_args, solve_args):
    """(label, kernel wrapper, plain version, args) of K4a and each K4b."""
    return [("K4a", lqr_kernel.lqr_factor_fused_lanes,
             lqr_kernel.lqr_factor_fused_reference, fac_args)] + [
        (f"K4b rhs {i + 1}", lqr_kernel.lqr_backsolve_fused_lanes,
         lqr_kernel.lqr_backsolve_fused_reference, args)
        for i, args in enumerate(solve_args)]


def hold_kernels(jobs, rel_tol, against_f64):
    """Each job's kernel against its plain version on the same arguments.

    against_f64=False: every output within rel_tol (1 + |plain|).
    against_f64=True (f32 inputs): both held against the plain version at
    f64 on the same values; per output the kernel's max relative error must
    be within 1.25x the plain f32 one's, plus rel_tol.
    Returns {label: max |kernel - plain|} and a report."""
    worst, report = {}, []
    for label, kernel, plain, args in jobs:
        got = kernel(*args)
        ref = plain(*args)
        truth = plain(*as_f64(args)) if against_f64 else None
        torch.cuda.synchronize()
        worst[label], rel_all, e_k_all, e_p_all = 0.0, 0.0, 0.0, 0.0
        for name, g, r in zip(got._fields, got, ref):
            if not torch.isfinite(g).all():
                fail(f"{label} {name}: non-finite kernel output")
            worst[label] = max(worst[label], (g - r).abs().max().item())
            rel = rel_dev(g, r)
            rel_all = max(rel_all, rel)
            if truth is None:
                if rel > rel_tol:
                    fail(f"{label} {name}: max rel {rel:.3e} > {rel_tol}")
                continue
            t = getattr(truth, name)
            e_k, e_p = rel_dev(g.double(), t), rel_dev(r.double(), t)
            e_k_all, e_p_all = max(e_k_all, e_k), max(e_p_all, e_p)
            if e_k > 1.25 * e_p + rel_tol:
                fail(f"{label} {name}: kernel error vs f64 {e_k:.3e} > 1.25 x "
                     f"plain {e_p:.3e} + {rel_tol}")
        report.append(
            f"{label} max rel {rel_all:.2e}" if truth is None else
            f"{label} vs f64: kernel {e_k_all:.2e}, plain {e_p_all:.2e}")
    return worst, "; ".join(report)


def lane_position(label, factor, backsolve, fa, sa, seed):
    """A factor kernel (wrapper `factor`, arguments fa) and a backsolve
    kernel (`backsolve`, sa) on a permutation of the lanes and on 256 lanes
    launched alone give the same lanes of the full launch bit for bit (a
    lane's result depends neither on its slot in the CTA nor on B)."""
    full_f = factor(*fa)
    full_s = backsolve(*sa)
    B = fa[0].shape[-1]
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(B, generator=gen).to(fa[0].device)
    part = torch.randperm(B, generator=gen)[:256].sort().values.to(
        fa[0].device)

    def cut(a, idx):
        if isinstance(a, riccati.LQRFactor):
            return riccati.LQRFactor(*(cut(t, idx) for t in a))
        return a[..., idx].contiguous() if torch.is_tensor(a) else a

    for what, idx in (("a permutation of the lanes", perm),
                      ("256 lanes alone", part)):
        got_f = factor(*(cut(a, idx) for a in fa))
        got_s = backsolve(*(cut(a, idx) for a in sa))
        torch.cuda.synchronize()
        for name, g, r in zip(got_f._fields + got_s._fields,
                              (*got_f, *got_s), (*full_f, *full_s)):
            if not bit_equal(g, r[..., idx]):
                fail(f"{label} on {what}: {name} differs from the full launch")
    return (f"bit-identical on a permutation of the {B} lanes and on "
            f"{part.numel()} lanes launched alone")


def pc_blocks(fa, sa0):
    """K5's arguments in solve_lqr_batched's order (Q, R, S, qx, qu, A, B,
    c, dx0) from the PC grid's own K4 calls: the stage QP blocks and the
    augmented dynamics of K4a's arguments fa assembled by the plain
    _assemble_qp_blocks / _aug_dynamics, and the right-hand side of the
    backsolve sa0."""
    w = nlp.StageWeights(*fa[:5])
    Q, R, S = lqr_kernel._assemble_qp_blocks(w, fa[6], fa[5], fa[9], fa[10])
    A, B = lqr_kernel._aug_dynamics(fa[7], fa[8])
    c, qx, qu, dx0 = (a.contiguous() for a in sa0[3:])
    return Q, R, S, qx, qu, A, B, c, dx0


def check_k4(dev, cfg_pc):
    """Phase 9, K4: the PC grid's own K4 calls (bench grid of seed 1, B =
    4096) from the initial IPM state and after 8 plain PC iterations, at f64
    and f32; then nh = 18 at f64 on 256 lanes.  Returns the f32 max
    |kernel - plain| of K4a and K4b from the initial state, the f32
    initial-state arguments (for the times) and, per dtype, K5's arguments
    from the initial-state calls (pc_blocks)."""
    errs, f32_args, blocks = {}, None, {}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        rel_tol = 1e-9 if f64 else 1e-3
        bar = (f"{rel_tol:g} (1+|ref|)" if f64 else
               f"1.25x the plain f32 error vs f64 + {rel_tol:g}")
        state, params = bench_lanes(cfg_pc, 1, dtype, dev)
        st = lane_state(state)
        B = st[0].shape[-1]
        fa, sa = record_k4(st, params, cfg_pc)
        blocks[dtype] = pc_blocks(fa, sa[0])
        w0, rep0 = hold_kernels(k4_jobs(fa, sa), rel_tol, not f64)
        for _ in range(8):
            st = ipm_lanes.lane_step(st, params, cfg_pc.model, cfg_pc.solver,
                                     int(MAX_ITERS), plain=True)
        fa8, sa8 = record_k4(st, params, cfg_pc)
        w8, rep8 = hold_kernels(k4_jobs(fa8, sa8), rel_tol, not f64)
        say(f"phase 9 K4 vs plain {str(dtype)[6:]} B={B} nh=30, the PC grid's "
            f"calls: initial state: {rep0}; after 8 plain PC iterations: "
            f"{rep8} (bar {bar})")
        say(f"phase 9 K4 lane position {str(dtype)[6:]}, after 8 plain PC "
            "iterations: " + lane_position(
                "K4", lqr_kernel.lqr_factor_fused_lanes,
                lqr_kernel.lqr_backsolve_fused_lanes, fa8, sa8[0], 9))
        if f64:
            nh, lanes = 18, 256

            def cut(a):
                return a[..., :lanes].contiguous()

            fa18 = (*(cut(a) for a in fa[:5]), cut(fa[5][:, :34 + nh]),
                    cut(fa[6][:, :nh]), cut(fa[7]), cut(fa[8]), *fa[9:])
            fac18 = lqr_kernel.lqr_factor_fused_reference(*fa18)
            sa18 = [(fac18, *(cut(a) for a in args[1:])) for args in sa]
            _, rep = hold_kernels(k4_jobs(fa18, sa18), rel_tol, False)
            say(f"phase 9 K4 vs plain float64 B={lanes} nh={nh}: {rep} (bar "
                f"{bar})")
        else:
            errs = {"lqr_factor_fused": w0["K4a"],
                    "lqr_backsolve_fused": max(v for k, v in w0.items()
                                               if k != "K4a")}
            f32_args = (fa, sa)
    return errs, f32_args, blocks


def random_lqr(rng, N, Bn):
    """Well-conditioned random LQR data, lane-major numpy (Q, R, S, qx, qu,
    A, B, c, dx0): tools/kernel_parity_debug.py::_random_lqr."""
    nxb, nu = lqr_kernel.NXB, lqr_kernel.NU

    def spd(n):
        M = rng.standard_normal((N, n, n, Bn))
        return (np.einsum("nikb,njkb->nijb", M, M) / n
                + np.eye(n)[None, :, :, None])

    Q = spd(nxb)
    R = spd(nu)
    S = 0.1 * rng.standard_normal((N, nu, nxb, Bn))
    qx = rng.standard_normal((N, nxb, Bn))
    qu = rng.standard_normal((N, nu, Bn))
    A = np.eye(nxb)[None, :, :, None] + 0.05 * rng.standard_normal(
        (N - 1, nxb, nxb, Bn))
    B = 0.1 * rng.standard_normal((N - 1, nxb, nu, Bn))
    c = 0.01 * rng.standard_normal((N - 1, nxb, Bn))
    dx0 = rng.standard_normal((9, Bn))
    return Q, R, S, qx, qu, A, B, c, dx0


def kkt_residuals(args, sol):
    """Max |residual| of each KKT condition of the LQR at the solution
    (tools/kernel_parity_debug.py::check_lqr_kkt); lane-major args and
    solution, numpy or CPU tensors."""
    Q, R, S, qx, qu, A, B, c, dx0 = (np.moveaxis(np.asarray(a), -1, 0)
                                     for a in args)
    dxb, du, nu = (np.moveaxis(np.asarray(a), -1, 0) for a in sol[:3])
    pred = (np.einsum("bnij,bnj->bni", A, dxb[:, :-1])
            + np.einsum("bnij,bnj->bni", B, du[:, :-1]) + c)
    r_u = (np.einsum("bnij,bnj->bni", R[:, :-1], du[:, :-1])
           + np.einsum("bnij,bnj->bni", S[:, :-1], dxb[:, :-1])
           + qu[:, :-1] + np.einsum("bnji,bnj->bni", B, nu[:, 1:]))
    r_uT = (np.einsum("bij,bj->bi", R[:, -1], du[:, -1])
            + np.einsum("bij,bj->bi", S[:, -1], dxb[:, -1]) + qu[:, -1])
    return {
        "init": np.abs(dxb[:, 0, :9] - dx0).max(),
        "dynamics": np.abs(pred - dxb[:, 1:]).max(),
        "stationarity": np.abs(r_u).max(),
        "terminal": np.abs(r_uT).max(),
        "dtheta costate": np.abs(nu[:, 0, 9:]).max(),
    }


def k5_jobs(args):
    """(label, kernel wrapper, plain version, args) of K5a and K5b on K5's
    arguments in solve_lqr_batched's order, K5b against the plain factor."""
    Q, R, S, qx, qu, A, B, c, dx0 = args
    fac = lqr_kernel.lqr_factor_reference(Q, R, S, A, B)
    return [("K5a", lqr_kernel.lqr_factor_lanes,
             lqr_kernel.lqr_factor_reference, (Q, R, S, A, B)),
            ("K5b", lqr_kernel.lqr_backsolve_lanes,
             lqr_kernel.lqr_backsolve_reference,
             (fac, A, B, c, qx, qu, dx0))]


def check_k5(dev, pc):
    """Phase 9, K5: random well-conditioned blocks at B = 4096, N = 20 and
    the PC grid's own blocks (pc: K5's arguments per dtype, pc_blocks),
    against the plain factor and backsolve (f64 within 1e-9 (1+|ref|), f32
    within 1e-4 (1+|ref|)); the f64 kernel solution's KKT residuals within
    1e-8; K5 on the PC grid's blocks bit-identical on a permutation of the
    lanes and on 256 lanes alone; then the path, riccati.solve_lqr_batched
    at f32, counted.  Returns the f32 max |kernel - plain| on the random
    blocks, the path's launches and the f32 random arguments (for the
    times)."""
    rnd = random_lqr(np.random.default_rng(0), LQR_N, LQR_B)
    for dtype, rel_tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in rnd]
        for label, args in (("random blocks", t),
                            ("the PC grid's blocks", pc[dtype])):
            w, rep = hold_kernels(k5_jobs(args), rel_tol, False)
            if label == "random blocks":
                worst = w
            msg = ""
            if dtype == torch.float64:
                res = kkt_residuals(
                    [a.cpu() for a in args],
                    [a.cpu() for a in riccati.solve_lqr_batched(*args)])
                if max(res.values()) > 1e-8:
                    fail(f"K5 f64 KKT residuals on {label}: {res} > 1e-8")
                msg = "; KKT residuals of the kernel solution: " + ", ".join(
                    f"{k} {v:.1e}" for k, v in res.items()) + " (bar 1e-8)"
            B = args[0].shape[-1]
            say(f"phase 9 K5 vs plain {str(dtype)[6:]} B={B} N={LQR_N} "
                f"{label}: {rep} (bar {rel_tol:g} (1+|ref|)){msg}")
        (_, fac5, _, fa5), (_, bs5, _, sa5) = k5_jobs(pc[dtype])
        say(f"phase 9 K5 lane position {str(dtype)[6:]}, the PC grid's "
            "blocks: " + lane_position("K5", fac5, bs5, fa5, sa5, 9))
    reset_counts()
    riccati.solve_lqr_batched(*t)
    torch.cuda.synchronize()
    launches = {k: lqr_kernel.LAUNCHES[k] for k in ("lqr_factor",
                                                     "lqr_backsolve")}
    if any(v != 1 for v in launches.values()):
        fail(f"riccati.solve_lqr_batched launched {launches} (want 1 each)")
    say(f"phase 9 the batched-LQR path riccati.solve_lqr_batched f32: "
        f"launches K5a {launches['lqr_factor']} K5b "
        f"{launches['lqr_backsolve']}")
    return ({"lqr_factor": worst["K5a"], "lqr_backsolve": worst["K5b"]},
            launches, t)


def grid_times(cfg, dev, n_sets=5):
    """solve_scenario_grid at f32 over `n_sets` fresh bench seed sets after
    a warm-up: (ms per call, mean iterations)."""
    batch.solve_scenario_grid(cfg, *workloads.bench_seeds(1000), workloads.HALVES,
                              device=dev)
    lat, iters = [], []
    for seed in range(1001, 1001 + n_sets):
        g, f = workloads.bench_seeds(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = batch.solve_scenario_grid(cfg, g, f, workloads.HALVES, device=dev)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        iters.append(r.iters.double().mean().item())
    return 1e3 * np.asarray(lat), float(np.mean(iters))


def step_times(cfg, dev, drift, label, card, phase, n_sets=5):
    """nmpc_step_batched at f32 over `n_sets` pre-staged fresh input sets."""
    B = STEP_B
    sets = [step_inputs(seed, B, torch.float32, dev, drift=drift)
            for seed in range(1001, 1001 + n_sets)]
    torch.cuda.synchronize()
    lat, solved_t, iters = [], [], []
    for a in sets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step(a, cfg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        solved_t.append((r.exit_code == 1).double().mean().item())
        iters.append(r.iters.double().mean().item())
    lat_ms = 1e3 * np.asarray(lat)
    say(f"phase {phase} nmpc_step_batched B={B} f32{label} [{card}]: "
        f"{lat_ms.mean():.2f} ms/call (min {lat_ms.min():.2f}, max "
        f"{lat_ms.max():.2f}), {B / lat_ms.mean() * 1e3:.1f} steps/s, "
        f"solved {np.mean(solved_t):.6f}, mean iters {np.mean(iters):.3f}")


def time_riccati(calls, flops, card):
    """Phase 11, K4a, K4b, K5a and K5b at B = 4096, 1024, 256 and 1: the
    first lanes of each one's calls, ms per call (CUDA events, twice)
    beside the bound of those lanes' bytes and operations."""
    def cut(a, Bw):
        if isinstance(a, riccati.LQRFactor):
            return riccati.LQRFactor(*(cut(t, Bw) for t in a))
        return a[..., :Bw].contiguous() if torch.is_tensor(a) else a

    for name in LQR_KERNELS:
        kernel = getattr(lqr_kernel, name + "_lanes")
        plain = getattr(lqr_kernel, name + "_reference")
        rows = []
        for Bw in (4096, 1024, 256, 1):
            a = [cut(t, Bw) for t in calls[name]]
            lanes = next(t for t in a if torch.is_tensor(t)).shape[-1]
            t1 = cuda_ms(lambda: kernel(*a), 20)
            t2 = cuda_ms(lambda: kernel(*a), 20)
            bms, by = bound(tensor_bytes(a, plain(*a)), lanes * flops[name])
            rows.append(f"B={lanes} {t1:.4f} ms (repeat {t2:.4f}), bound "
                        f"{bms:.4f} ms by {by}, {100 * bms / min(t1, t2):.2f}%"
                        " of the bound")
        say(f"phase 11 {LQR_KERNELS[name][0]} f32 N={LQR_N} [{card}]: "
            + "; ".join(rows))


def run_slice3(dev, card, mono_grid):
    """Phases 9-11; mono_grid = phase 4's (ms per call, mean iterations).
    Returns the {"kernels"} entries of K4a, K4b, K5a and K5b."""
    cfg_pc = with_pc(workloads.bench_config())
    f32 = torch.float32

    # ---- phase 9: K4 and K5 vs plain --------------------------------------
    errs, (fa, sa), blocks = check_k4(dev, cfg_pc)
    errs5, launches, k5 = check_k5(dev, blocks)
    del blocks
    errs.update(errs5)

    # ---- phase 10: the predictor-corrector main path ----------------------
    counts = check_grid(dev, cfg_pc, 10)
    launches.update(lqr_factor_fused=counts[3],
                    lqr_backsolve_fused=counts[4])
    step_pc = with_pc(DEFAULT_CONFIG)
    for drift, label in ((False, ""), (True, ", every 4th robot drifted")):
        check_step(step_inputs(1 + drift, STEP_B, f32, dev, drift=drift), dev,
                   f", predictor-corrector{label}", step_pc, 10, 0.995)

    # ---- phase 11: times --------------------------------------------------
    Q, R, S, qx, qu, A, B, c, dx0 = k5
    fac5 = lqr_kernel.lqr_factor_reference(Q, R, S, A, B)
    calls = {
        "lqr_factor_fused": fa,
        "lqr_backsolve_fused": sa[0],
        "lqr_factor": (Q, R, S, A, B),
        "lqr_backsolve": (fac5, A, B, c, qx, qu, dx0),
    }
    flops = {
        "lqr_factor_fused": riccati_factor_flops(LQR_N, fa[5].shape[1] - 34),
        "lqr_backsolve_fused": riccati_solve_flops(LQR_N),
        "lqr_factor": riccati_factor_flops(LQR_N),
        "lqr_backsolve": riccati_solve_flops(LQR_N),
    }
    ms, plain_ms, bounds = {}, {}, {}
    for name, args in calls.items():
        kernel = getattr(lqr_kernel, name + "_lanes")
        plain = getattr(lqr_kernel, name + "_reference")
        ms[name] = cuda_ms(lambda: kernel(*args), 20)
        plain_ms[name] = cuda_ms(lambda: plain(*args), 3)
        bounds[name] = bound(tensor_bytes(args, plain(*args)),
                             LQR_B * flops[name])
    say(f"phase 11 kernels f32 B={LQR_B} N={LQR_N} [{card}]: " + "; ".join(
        f"{LQR_KERNELS[n][0]} {ms[n]:.3f} ms vs plain {plain_ms[n]:.3f} ms, "
        f"bound {bounds[n][0]:.4f} ms by {bounds[n][1]}"
        for n in calls) + " (K4: the PC grid's initial-state calls, K5: the "
        "random blocks)")
    time_riccati(calls, flops, card)
    lat_ms, iters = grid_times(cfg_pc, dev)
    mono_ms, mono_iters = mono_grid
    Bg = workloads.N_GOALS * workloads.N_FORCES * len(workloads.HALVES)
    say(f"phase 11 PC grid solve B={Bg} f32 [{card}]: {lat_ms.mean():.2f} "
        f"ms/call (min {lat_ms.min():.2f}, max {lat_ms.max():.2f}), "
        f"{Bg / lat_ms.mean() * 1e3:.1f} solves/s, mean iters {iters:.3f}; "
        f"monotone (phase 4): {mono_ms:.2f} ms/call, "
        f"{Bg / mono_ms * 1e3:.1f} solves/s, mean iters {mono_iters:.3f}")
    for drift, label in ((False, ""), (True, ", every 4th robot drifted")):
        step_times(step_pc, dev, drift, f", predictor-corrector{label}", card,
                   11)
    one_robot_latency(step_pc, "DEFAULT_CONFIG predictor-corrector", STEP_M,
                      dev, card, phase=11)

    return [
        {"name": name, "route": "cuda", "source": CSRC + "lqr.cu",
         "replaces": LQR_KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name in LQR_KERNELS
    ]



# ---------------------------------------------------------------------------
# slice 4: the closed loop (the fleet, one robot's planner)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def capture_solves(solves):
    """Records, cloned, the arguments of the references, K1, K2, tube chain
    and K3 wrappers in the NMPC solves numbered `solves` (0-based, one
    references, one K2, one chain and one K3 call each, then that solve's
    K1 calls).  The wrappers run and count their launches as before.
    Yields {solve: {"K1": [args, ...], "refs": args, "K2": args, "chain":
    args, "K3": args}}."""
    got, seen = {}, {"refs": 0, "K2": 0, "chain": 0, "K3": 0}

    def recorded(name, real):
        def wrapper(*args):
            if name == "K1":
                s = seen["K3"] - 1
                if (seen["refs"] == seen["K2"] == seen["chain"] == seen["K3"]
                        and s in got):
                    got[s]["K1"].append(map_tensors(torch.clone, args))
            else:
                s = seen[name]
                seen[name] += 1
                if s in solves:
                    got.setdefault(s, {"K1": []})[name] = map_tensors(
                        torch.clone, args)
            return real(*args)
        return wrapper

    with contextlib.ExitStack() as stack:
        for name, module, attr in (
                ("refs", reference_kernel, "sample_references_lanes"),
                ("K1", ipm_kernel, "ipm_iteration_fused"),
                ("K2", tube_kernel, "tube_stage_lanes"),
                ("chain", tube_kernel, "tube_chain_lanes"),
                ("K3", corridor_kernel, "decompose_stages_lanes")):
            stack.enter_context(mock.patch.object(
                module, attr, recorded(name, getattr(module, attr))))
        yield got


def k1_f64(args):
    """K1 against its plain version at f64 on one call's arguments (cast
    from the run's f32): phase 2's bar, identical iteration counts, done
    flags and NaN pattern, and |d| <= 1e-9 (1 + |ref|) on Z, lam, s and
    mu_d.  Returns the max relative deviation."""
    a = as_f64(args)
    ref = ipm_kernel.ipm_iteration_reference(*a)
    got = ipm_kernel.ipm_iteration_fused(*a)
    torch.cuda.synchronize()
    if not (torch.equal(ref[4][1], got[4][1])
            and torch.equal(ref[4][2], got[4][2])):
        fail("K1 f64 on the closed loop's inputs: iteration counts or done "
             "flags differ from the plain version's")
    worst = 0.0
    for name, g, r in zip(("Z", "lam", "s", "mu_d"), got, ref):
        if not torch.equal(g.isnan(), r.isnan()):
            fail(f"K1 f64 on the closed loop's inputs: {name}'s NaNs differ")
        rel = rel_dev(g.nan_to_num(), r.nan_to_num())
        if not rel <= 1e-9:
            fail(f"K1 f64 on the closed loop's inputs: {name} max rel "
                 f"{rel:.3e} > 1e-9")
        worst = max(worst, rel)
    return worst


def hold_solves(captured, phase, label):
    """Each captured solve's references call held bit for bit against the
    plain version, at the run's dtype and cast to f64, and its K2, tube
    chain, K3 and K1 calls against their plain versions at f64 on the same
    values (cast from the run's f32), with the bars of phases 2, 5 and 6;
    any miss fails the phase.  Returns each solve's largest cloud (masked
    points of a lane)."""
    if not captured or any({"refs", "K1", "K2", "chain", "K3"} - set(c)
                           or not c["K1"] for c in captured.values()):
        fail(f"{label}: a captured solve lacks a references, K1, K2, chain "
             "or K3 call")
    k1_rel, k1_calls, k2_rel, dA, db = 0.0, 0, 0.0, 0.0, 0.0
    chain_rel = 0.0
    for c in captured.values():
        for args in (c["refs"], as_f64(c["refs"])):
            got = reference_kernel.sample_references_lanes(*args)
            want = reference.sample_references_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"the references {label} at {args[0].dtype}: not "
                     "bit-equal to the plain version")
        x, u, mcfg, tcfg, K = as_f64(c["K2"])
        ref = tube_kernel.tube_stage_reference(x, u, mcfg, tcfg, K)
        got = tube_kernel.tube_stage_lanes(x, u, mcfg, tcfg, K)
        torch.cuda.synchronize()
        for name, g, r in zip(("Qd", "Mp", "Phi", "Q1"), got, ref):
            rel = rel_dev(g, r) if torch.isfinite(g).all() else float("nan")
            if not rel <= 1e-10:
                fail(f"K2 f64 {label}: {name} max rel {rel:.3e} > 1e-10")
            k2_rel = max(k2_rel, rel)
        chain_rel = max(chain_rel, chain_check(
            *as_f64(c["chain"]), f"f64 {label}")[0])
        p1, p2, obs, mask, ccfg, nh = as_f64(c["K3"])
        rows = corridor_rows((p1, p2, obs, mask), ccfg, nh)
        dA, db = max(dA, rows[0].max().item()), max(db, rows[1].max().item())
        if not max(dA, db) <= 1e-9:
            fail(f"K3 f64 {label}: max row |d| {max(dA, db):.3e} > 1e-9")
        for args in c["K1"]:
            k1_rel = max(k1_rel, k1_f64(args))
            k1_calls += 1
    clouds = [int(c["K3"][3].sum(dim=-1).max()) for c in captured.values()]
    p1, obs, ccfg = c["K3"][0], c["K3"][2], c["K3"][4]
    say(f"phase {phase} {label}: the references bit-equal to plain at the "
        f"run's dtype and f64; K1, K2, the chain and K3 vs plain at f64 on "
        f"the inputs "
        f"of {len(captured)} solves (B={p1.shape[0]} N={p1.shape[1]} "
        f"M={obs.shape[1]}, up to {max(clouds)} cloud points a lane, "
        f"corridor shrink_iters {ccfg.shrink_iters} max_obs_planes "
        f"{ccfg.max_obs_planes}): K1 {k1_calls} calls, max rel {k1_rel:.2e} "
        f"(bar 1e-9 (1+|ref|), identical it/done); K2 max rel {k2_rel:.2e} "
        f"(bar 1e-10 (1+|ref|)); the chain max rel {chain_rel:.2e} (bar "
        f"1e-10 (1+|ref|), NaN alike); K3 max |dA| {dA:.2e}, max |db| "
        f"{db:.2e} (bar 1e-9 on every row)")
    return clouds


def fleet_setup(dtype, device):
    """The JAX bench's fleet (engine/workloads.py): its config, scene and
    B = 128 lanes, the scene's tensors in dtype on device."""
    cfg = workloads.fleet_cfg()
    grid, obs, mask = workloads.fleet_scene(cfg, dtype, device=device)
    return (cfg, grid, obs, mask, *workloads.fleet_lanes(workloads.FLEET_B))


def fly_fleet(setup, duration, trace=None):
    cfg, grid, obs, mask, starts, goals, f_true = setup
    return fleet.run_fleet(cfg, grid, obs, mask, starts, goals, f_true,
                           duration, workloads.FLEET_REPLAN_EVERY,
                           tick_trace=trace)


def first_search_f64(dev):
    """The fleet's first batched search at f64: all lanes on the card, and
    lanes 0..SEARCH_CPU_LANES-1 alone on the CPU (lanes are independent:
    tests/test_torch_search.py holds a batch to its lanes one by one).
    Identical status, n_edges and edge_inputs, or the phase fails."""
    out = []
    for d, n in ((dev, workloads.FLEET_B),
                 (torch.device("cpu"), SEARCH_CPU_LANES)):
        cfg, grid, _, _, starts, goals, f_true = fleet_setup(torch.float64, d)

        def t(a):
            return torch.as_tensor(a[:n], dtype=torch.float64, device=d)

        z3 = torch.zeros(n, 3, dtype=torch.float64, device=d)
        t0 = time.perf_counter()
        r = kinodynamic.search(grid, t(starts[:, 0:3]), t(starts[:, 3:6]), z3,
                               t(goals), z3, t(f_true), False, cfg.search,
                               cfg.tube, cfg.map)
        out.append((r, time.perf_counter() - t0))
    (card, s_card), (host, s_host) = out
    n = SEARCH_CPU_LANES
    same = {name: torch.equal(getattr(card, name)[:n].cpu(),
                              getattr(host, name))
            for name in ("status", "n_edges", "edge_inputs", "iterations")}
    codes = {int(c): int((card.status == c).sum()) for c in card.status.unique()}
    say(f"phase 12 first fleet search f64: card B={workloads.FLEET_B} "
        f"{s_card:.2f} s (statuses {codes}), CPU lanes 0-{n - 1} "
        f"{s_host:.2f} s; identical on those lanes: {same}")
    if not all(same.values()):
        fail(f"the card's f64 search differs from the CPU's: {same}")


def timed_fleet_pass(setup, duration):
    """One fleet run with a sync before and after each search, step and
    plant call: ms per tick of each (host clock), the rest host work."""
    acc = {"search": 0.0, "step": 0.0, "plant": 0.0}
    calls = dict.fromkeys(acc, 0)

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return run

    with contextlib.ExitStack() as stack:
        for name, attr in (("search", "search_fleet"), ("step", "mpc_step"),
                           ("plant", "plant_step")):
            stack.enter_context(mock.patch.object(
                fleet, attr, timed(name, getattr(fleet, attr))))
        res = fly_fleet(setup, duration)
    per_tick = {k: 1e3 * v / res.n_ticks for k, v in acc.items()}
    rest = 1e3 * res.wall_s / res.n_ticks - sum(per_tick.values())
    search_each = 1e3 * acc["search"] / max(calls["search"], 1)
    return per_tick, rest, search_each, calls, res


def check_fleet(dev, card):
    """Phase 12: the fleet on the card at f32."""
    f32 = torch.float32
    B, dur = workloads.FLEET_B, workloads.FLEET_DURATION
    first_search_f64(dev)
    setup = fleet_setup(f32, dev)
    cfg = setup[0]
    reset_counts()
    trace = []
    with capture_solves(FLEET_HOLD_TICKS) as captured:
        res = fly_fleet(setup, dur, trace)
    torch.cuda.synchronize()
    counts = launch_counts()
    l1, l2, l3, l4a, l4b, lc, lr = counts
    steps = ipm_lanes.STEPS
    if "jax" in sys.modules:
        fail("jax was imported")
    ticks = res.n_ticks
    reached = res.outcome == fleet.OUTCOME_REACHED
    to_goal = res.time_to_goal[reached].mean() if reached.any() else np.nan
    say(f"phase 12 fleet B={B} {dur} s ({ticks} ticks, replan every "
        f"{workloads.FLEET_REPLAN_EVERY}) f32 [{card}]: outcomes "
        f"{res.outcome_counts}, reached {res.reached_frac:.4f}, collided "
        f"{res.collided_frac:.4f}, solved {res.solved_frac:.4f}, tick exit "
        f"codes {res.tick_code_fracs}, searches {res.searches}, mean time to "
        f"goal {to_goal:.3f} s, wall "
        f"{res.wall_s:.2f} s "
        f"(per-tick trace on), realtime factor {B * dur / res.wall_s:.1f}; "
        f"launches references {lr} K2 {l2} chain {lc} K3 {l3} K1 {l1} K4a "
        f"{l4a} K4b {l4b}, host-loop steps {steps}")
    if not (lr == l2 == lc == l3 == ticks
            and solver_launches_ok(counts, steps, cfg.solver)):
        fail(f"fleet launches: the references {lr}, K2 {l2}, the chain {lc}, "
             f"K3 {l3} (want {ticks} each), K1 {l1} vs host-loop steps "
             f"{steps}, K4a {l4a}, K4b {l4b}")
    if res.collided_frac != 0.0:
        fail(f"fleet collided {res.collided_frac}")
    if sum(res.outcome_counts.values()) != B:
        fail(f"fleet outcomes {res.outcome_counts} do not cover {B} lanes")
    if res.reached_frac < 0.95:
        fail(f"fleet reached {res.reached_frac} < 0.95")
    # lanes freeze once reached or panicked (engine/fleet.py's ladder)
    panic_after = cfg.fsm.max_solve_fails + 4
    frozen = np.zeros(B, bool)
    for tick in trace:
        live = ~frozen
        if not (np.isfinite(tick["states"][live]).all()
                and np.isfinite(tick["u0"][live]).all()):
            fail(f"non-finite fleet state or control at t = {tick['t']:.2f}")
        arrived = res.time_to_goal <= tick["t"] + cfg.model.dt + 1e-9
        frozen |= arrived | (tick["fail"] >= panic_after)

    # tick 20 replans (replan every 10), tick 25 does not
    hold_solves(captured, 12, f"the fleet's ticks {FLEET_HOLD_TICKS}")

    per_tick, rest, search_each, calls, short = timed_fleet_pass(
        setup, FLEET_SHORT_S)
    say(f"phase 12 fleet ms per tick, a {FLEET_SHORT_S} s pass with a sync "
        f"at each split [{card}]: search {per_tick['search']:.2f} "
        f"({calls['search']} searches, {search_each:.1f} ms each), "
        f"step {per_tick['step']:.2f}, plant {per_tick['plant']:.2f}, "
        f"other host work {rest:.2f}; wall {short.wall_s:.2f} s for "
        f"{short.n_ticks} ticks")


def fly_robot(cfg, goal, duration, dev, schedule=None, occupied=None):
    """One robot: ResilientPlanner + QuadSim + run_closed_loop from hover
    at (0, 0, 1.2), f32 on the card, `occupied` points marked in its map
    first."""
    p = planner.ResilientPlanner(cfg, max_cloud=2048, dtype=torch.float32,
                                 device=dev)
    if occupied is not None:
        p.set_occupied(occupied)
    x0 = np.zeros(9)
    x0[2] = 1.2
    sim = simulator.QuadSim(cfg.model, x0.copy(), np.zeros(3))
    p.on_odometry(x0)
    trace = simulator.run_closed_loop(p, sim, goal, duration,
                                      force_schedule=schedule)
    return p, trace


def check_robot(dev, card):
    """Phase 13: one robot's closed loop on the card at f32."""
    cfg = workloads.closed_loop_cfg()

    def wind(t):
        return np.array([1.5, 0.0, 0.0]) if t > 1.0 else np.zeros(3)

    # tests/test_closed_loop.py's two scenarios and their own bars
    for label, goal, dur, sched, tol in (
            ("hover to goal", [2.0, 0.5], 4.0, None, 0.4),
            ("wind step", [2.0, 0.0], 5.0, wind, 0.5)):
        reset_counts()
        t0 = time.perf_counter()
        p, trace = fly_robot(cfg, goal, dur, dev, sched)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        l1, l2, l3, l4a, l4b, lc, lr = launch_counts()
        d = p.diag
        miss = float(np.linalg.norm(trace["pos"][-1]
                                    - np.array([goal[0], goal[1], 1.2])))
        solve = d.timers.report()["solve"]
        say(f"phase 13 robot {label} {dur} s f32 [{card}]: final distance "
            f"{miss:.3f} m (bar {tol}), solves {d.solves}, failures "
            f"{d.solve_failures}, replans {d.replans}, transitions "
            f"{len(d.fsm_transitions)}; solve p50 {solve['p50_ms']:.2f} ms, "
            f"p99 {solve['p99_ms']:.2f}; launches references {lr} K2 {l2} "
            f"chain {lc} K3 {l3} K1 {l1}, "
            f"host-loop steps {ipm_lanes.STEPS}; wall {wall:.2f} s")
        if miss >= tol:
            fail(f"robot {label}: final distance {miss:.3f} m >= {tol}")
        if label == "hover to goal" and not (
                d.solves > 10 and d.solve_failures <= d.solves // 4):
            fail(f"robot {label}: {d.solve_failures} failures of "
                 f"{d.solves} solves")
        if not (lr == l2 == lc == l3 == d.solves
                and l1 == ipm_lanes.STEPS > 0 and l4a == l4b == 0):
            fail(f"robot launches: the references {lr}, K2 {l2}, the chain "
                 f"{lc}, K3 {l3} vs {d.solves} solves, K1 {l1} vs "
                 f"{ipm_lanes.STEPS} steps")

    # the obstacle scene, its own bars; every 4th solve's kernel inputs held
    reset_counts()
    t0 = time.perf_counter()
    with capture_solves(ROBOT_HOLD_SOLVES) as captured:
        p, trace = fly_robot(cfg, [3.5, 0.0], 7.0, dev,
                             occupied=workloads.fence_points())
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    l1, l2, l3, l4a, l4b, lc, lr = launch_counts()
    steps, d, final = ipm_lanes.STEPS, p.diag, trace["pos"][-1]
    ys = [q[1] for q in trace["pos"] if 1.35 < q[0] < 1.65]
    say(f"phase 13 robot fence 7.0 s f32 [{card}]: final position "
        f"{np.round(final, 3).tolist()} (bar x > 2.8), {len(ys)} samples "
        f"at the fence line with y in [{min(ys, default=np.nan):.3f}, "
        f"{max(ys, default=np.nan):.3f}] (bar (-0.2, 1.7)), solves "
        f"{d.solves}, failures {d.solve_failures}, replans {d.replans}; "
        f"launches references {lr} K2 {l2} chain {lc} K3 {l3} K1 {l1}, "
        f"host-loop steps {steps}; wall {wall:.2f} s")
    if not final[0] > 2.8:
        fail(f"robot fence: final x {final[0]:.3f} <= 2.8")
    if not (ys and all(-0.2 < y < 1.7 for y in ys)):
        fail("robot fence: not inside the gap band at the fence line")
    if not (lr == l2 == lc == l3 == d.solves and l1 == steps > 0
            and l4a == l4b == 0):
        fail(f"robot fence launches: the references {lr}, K2 {l2}, the chain "
             f"{lc}, K3 {l3} vs {d.solves} solves, K1 {l1} vs {steps} steps")
    clouds = hold_solves(captured, 13, "the robot's fence solves")
    if max(clouds) == 0:
        fail("robot fence: every solve's corridor cloud was empty")

    # the deployment configuration: DEFAULT_CONFIG's 400 x 400 x 60 map
    p, _ = fly_robot(DEFAULT_CONFIG, [2.0, 0.5], 3.0, dev)
    solve = np.asarray(p.diag.timers._phases["solve"].samples[3:]) * 1e3
    search = np.asarray(p.diag.timers._phases["search"].samples) * 1e3
    n_vox = int(np.prod(DEFAULT_CONFIG.map.grid_shape))
    cloud_ms = cuda_ms(lambda: occ_grid.occupied_cloud(
        p.grid, DEFAULT_CONFIG.map, p.max_cloud), 10)
    say(f"phase 13 robot DEFAULT_CONFIG hover to goal 3.0 s f32 [{card}]: MPC "
        f"tick (solve) p50 {np.percentile(solve, 50):.2f} ms, p99 "
        f"{np.percentile(solve, 99):.2f} ms over {len(solve)} ticks after 3 "
        f"(the tick is 50 ms); search {search.mean():.2f} ms over "
        f"{len(search)} searches (max {search.max():.2f}); occupied_cloud over "
        f"{n_vox} voxels {cloud_ms:.3f} ms; final distance "
        f"{np.linalg.norm(p.odom[0:3] - np.array([2.0, 0.5, 1.2])):.3f} m")


# ---------------------------------------------------------------------------
# phase 14: slice 5, the surfaces and scale-out
# ---------------------------------------------------------------------------

def hover_force_params():
    """The FORCES API's hover-to-goal problem: (0, 0, 1.2) to (1.5, 0.8,
    1.2) under f_ext = (0.4, -0.2, 0), a 5 x 5 x 2 m box, stage weights."""
    x0, goal = migration.X0, np.array([1.5, 0.8, 1.2])
    params = forces_api.ForcesParams()
    params.xinit[:] = x0
    w = DEFAULT_CONFIG.weights
    forces_api.set_stage_weights(params, w.w_stage_wp, w.w_stage_input,
                                 w.w_input_rate, w.w_terminal_wp,
                                 w.w_terminal_input)
    A, b = box_corridor(0.5 * (x0[:3] + goal), np.array([5.0, 5.0, 2.0]),
                        forces_api.N, device="cpu")
    forces_api.pack_stage_params(
        params, np.tile(goal[None], (forces_api.N, 1)),
        np.full(forces_api.N, np.arctan2(goal[1], goal[0])),
        np.array([0.4, -0.2, 0.0]), A.numpy(), b.numpy())
    forces_api.pack_warm_start(params, hover_warm_start(
        torch.as_tensor(x0), DEFAULT_CONFIG.model).numpy())
    return params


def stack_out(out):
    return np.stack([out[f"x{i + 1:02d}"] for i in range(forces_api.N)])


FORCES_INFO_FIELDS = ("it", "fevalstime", "res_eq", "res_ineq", "rdgap",
                      "pobj")


def same_forces_answer(got, want) -> bool:
    """Outputs, exit flag and the six info fields besides solvetime, bit
    for bit."""
    (out_g, flag_g, info_g), (out_w, flag_w, info_w) = got, want
    return (flag_g == flag_w
            and all(out_g[k].tobytes() == out_w[k].tobytes() for k in out_w)
            and all(np.float64(getattr(info_g, f)).tobytes()
                    == np.float64(getattr(info_w, f)).tobytes()
                    for f in FORCES_INFO_FIELDS))


def forces_solve(params, profile, dtype, device, cfg=DEFAULT_CONFIG):
    """One ForcesSolver solve on a copy of params: (Z (N, 17), exitflag,
    info, launch_counts(), host-loop steps).  On the card the solve takes
    the graph route: it must replay the info struct's graph once and give
    the eager route's bits (solved again after the counts are read)."""
    params = dataclasses.replace(
        params, xinit=params.xinit.copy(), x0=params.x0.copy(),
        all_parameters=params.all_parameters.copy())
    solver = forces_api.ForcesSolver(profile, cfg, dtype, device=device)
    reset_counts()
    replays = forces_api.GRAPH_REPLAYS
    got = solver.solve(params)
    torch.cuda.synchronize()
    counts, steps = launch_counts(), ipm_lanes.STEPS
    if torch.device(device).type == "cuda":
        replays = forces_api.GRAPH_REPLAYS - replays
        if not (replays == 1
                and same_forces_answer(got, solver._solve_eager(params))):
            fail(f"FORCES API {profile} {dtype}: the graph route ({replays} "
                 f"replays) differs from the eager route")
    out, flag, info = got
    return stack_out(out), flag, info, counts, steps


def check_forces_api(dev, card):
    """Phase 14(a): the FORCES API on the card, DEFAULT_CONFIG."""
    cpu = torch.device("cpu")
    problems = {"migration": migration.migration_params(device=dev),
                "hover f_ext": hover_force_params()}
    for name, params in problems.items():
        speed = {}
        for profile in ("normal", "final"):
            Zc, fc, ic, _, _ = forces_solve(params, profile, torch.float64,
                                            cpu)
            Zg, fg, ig, cnt, steps = forces_solve(params, profile,
                                                  torch.float64, dev)
            rel = float(np.max(np.abs(Zg - Zc) / (1.0 + np.abs(Zc))))
            Z32, f32, i32, cnt32, steps32 = forces_solve(
                params, profile, torch.float32, dev)
            du32 = float(np.abs(Z32[:, :4] - Zc[:, :4]).max())
            speed[profile] = float(np.linalg.norm(Zg[-1, 11:14]))
            say(f"phase 14 FORCES API {name} {profile}: f64 card exitflag "
                f"{fg} it {ig.it} vs CPU {fc} / {ic.it}, Z max rel "
                f"{rel:.2e} (bar 1e-8 (1+|ref|)), K1 {cnt[0]} = host-loop "
                f"steps {steps}; f32 card exitflag {f32} it {i32.it}, max "
                f"|du| vs the f64 CPU solve {du32:.2e} (bar 1e-3), K1 "
                f"{cnt32[0]} = steps {steps32}; res_eq {ig.res_eq:.2e} "
                f"res_ineq {ig.res_ineq:.2e} rdgap {ig.rdgap:.2e} pobj "
                f"{ig.pobj:.6f}")
            if not (fg == fc and ig.it == ic.it and rel <= 1e-8):
                fail(f"FORCES API {name} {profile}: f64 card vs CPU")
            if not (f32 == 1 and du32 <= 1e-3):
                fail(f"FORCES API {name} {profile}: f32 exitflag {f32}, "
                     f"|du| {du32:.2e}")
            for c, n in ((cnt, steps), (cnt32, steps32)):
                if not (c[0] == n > 1 and c[1:] == (0,) * 6):
                    fail(f"FORCES API {name} {profile}: launches {c} vs "
                         f"{n} host-loop steps")
        say(f"phase 14 FORCES API {name}: terminal speed final "
            f"{speed['final']:.4f} vs normal {speed['normal']:.4f} m/s (bar "
            f"final < half)")
        if not speed["final"] < 0.5 * speed["normal"]:
            fail(f"FORCES API {name}: the final profile does not brake")

    # the independent oracle (CPU, f64) on the hover problem
    params = problems["hover f_ext"]
    Zg = forces_solve(params, "normal", torch.float64, dev)[0]
    _, p = forces_api.unpack_params(params, DEFAULT_CONFIG, final=False,
                                    device="cpu")
    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # 84-wide operations: threads only add cost
    try:
        Zo, r = cpu_oracle.solve_oracle(p, DEFAULT_CONFIG.model,
                                        DEFAULT_CONFIG.solver)
    finally:
        torch.set_num_threads(threads)
    du = float(np.abs(Zg[:, :4] - Zo[:, :4]).max())
    say(f"phase 14 FORCES API hover f_ext normal: f64 card vs the SLSQP "
        f"oracle max |du| {du:.2e} (bar 1e-3; oracle {r.nit} iterations, "
        f"status {r.status}, {time.perf_counter() - t0:.1f} s on the CPU)")
    if not du <= 1e-3:
        fail(f"FORCES API vs the oracle: |du| {du:.2e}")

    # a predictor-corrector configuration: K4a once and K4b twice a step
    pc = with_pc(DEFAULT_CONFIG)
    _, fpc, ipc, cnt, steps = forces_solve(problems["migration"], "normal",
                                           torch.float64, dev, pc)
    say(f"phase 14 FORCES API migration, predictor-corrector f64: exitflag "
        f"{fpc} it {ipc.it}; K4a {cnt[3]} K4b {cnt[4]} K1 {cnt[0]}, "
        f"host-loop steps {steps}")
    if not (fpc == 1 and solver_launches_ok(cnt, steps, pc.solver)):
        fail(f"FORCES API predictor-corrector: exitflag {fpc}, launches "
             f"{cnt} vs {steps} steps")

    # ms per solve, p50 of 20, the migration problem, on each route (on
    # the CPU both are the eager route)
    for route in ("solve", "_solve_eager"):
        times = {}
        for dtype in (torch.float32, torch.float64):
            solver = forces_api.ForcesSolver("normal", DEFAULT_CONFIG, dtype,
                                             device=dev)
            ms = []
            for _ in range(21):
                t0 = time.perf_counter()
                getattr(solver, route)(problems["migration"])
                ms.append(1e3 * (time.perf_counter() - t0))
            times[dtype] = (np.percentile(ms[1:], 50),
                            np.percentile(ms[1:], 99))
        say(f"phase 14 FORCES API migration solve, {route} [{card}]: f32 p50 "
            f"{times[torch.float32][0]:.3f} ms (p99 "
            f"{times[torch.float32][1]:.3f}), f64 p50 "
            f"{times[torch.float64][0]:.3f} ms (p99 "
            f"{times[torch.float64][1]:.3f}) over 20 solves")


def check_sharded(dev, card):
    """Phase 14(b): the sharded solve in a world-size-1 NCCL group."""
    cfg = workloads.bench_config()
    g, f = workloads.bench_seeds(3)
    with tempfile.TemporaryDirectory() as d:
        mesh.init_group("cuda", f"file://{d}/rendezvous", 1, 0)
        try:
            m = mesh.make_mesh(device_type="cuda")
            scen = batch.make_scenarios(cfg, g, f, workloads.HALVES,
                                        dtype=torch.float32, device=dev)
            local = mesh.shard_scenarios(scen, m)
            run = mesh.make_sharded_solver(cfg, m)
            reset_counts()
            res, stats = run(local)
            torch.cuda.synchronize()
            l1, steps = launch_counts()[0], ipm_lanes.STEPS
            ref = batch.solve_scenarios(scen, cfg)
            same = all(bit_equal(a, b) for a, b in zip(res, ref))
            n_solved = int((ref.exit_code == 1).sum())
            ms = {"sharded": [], "solve_scenarios": []}
            for _ in range(3):
                for label, fn in (("sharded", lambda: run(local)),
                                  ("solve_scenarios",
                                   lambda: batch.solve_scenarios(scen, cfg))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ms[label].append(1e3 * (time.perf_counter() - t0))
        finally:
            torch.distributed.destroy_process_group()
    say(f"phase 14 sharded solve, NCCL world of 1, mesh "
        f"{tuple(m.mesh.shape)}, B={scen.batch} f32: bit-equal to "
        f"solve_scenarios {same}; stats n {stats.n.item():.0f} n_solved "
        f"{stats.n_solved.item():.0f} (solve_scenarios {n_solved}), mean "
        f"iters {stats.mean_iters.item():.4f}, max kkt solved "
        f"{stats.max_kkt_solved.item():.3e}; K1 {l1} = host-loop steps "
        f"{steps}; [{card}] ms per call sharded {np.median(ms['sharded']):.2f}"
        f" vs solve_scenarios {np.median(ms['solve_scenarios']):.2f} (median "
        "of 3, in turns)")
    if not same:
        fail("sharded solve differs from solve_scenarios")
    if not (stats.n.item() == scen.batch == len(g) * len(f)
            and stats.n_solved.item() == n_solved):
        fail(f"sharded stats n {stats.n.item()}, n_solved "
             f"{stats.n_solved.item()} vs {n_solved}")
    if not l1 == steps > 0:
        fail(f"sharded solve: K1 {l1} vs {steps} host-loop steps")


def check_monte_carlo(dev, card):
    """Phase 14(c): BASELINE config 5, 25 x 4096 scenarios, interrupted
    after 8 checkpointed chunks and resumed in a fresh process, against one
    uninterrupted run of the same chunks."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m",
               "forces_resilient_planner_tpu_torch.examples."
               "config5_monte_carlo", "--ckpt-dir", f"{d}/resumed", *MC_ARGS]
        t0 = time.perf_counter()
        for extra in (["--chunks", str(MC_RESUME_AFTER), "--no-summary"],
                      ["--chunks", str(MC_CHUNKS), "--out",
                       f"{d}/summary.json"]):
            proc = subprocess.run(cmd + extra, cwd=root, capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"config 5 {' '.join(extra)}: exit {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
        wall = time.perf_counter() - t0
        with open(f"{d}/summary.json") as fh:
            s = json.load(fh)
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            whole = config5.main(["--ckpt-dir", f"{d}/whole", "--chunks",
                                  str(MC_CHUNKS), *MC_ARGS])
        torch.cuda.synchronize()
        l1, steps = launch_counts()[0], ipm_lanes.STEPS
        ck_r = checkpoint.SweepCheckpointer(f"{d}/resumed")
        ck_w = checkpoint.SweepCheckpointer(f"{d}/whole")
        differ = [c for c in range(MC_CHUNKS) if not all(
            bit_equal(a, b) for a, b in zip(ck_r.load_chunk(c, device="cpu"),
                                            ck_w.load_chunk(c, device="cpu")))]
    fr = ", ".join(f"{k} {v:.6f}" for k, v in s["exit_code_fracs"].items())
    say(f"phase 14 config 5 [{card}]: {s['n_scenarios']} scenarios, resumed "
        f"{s['resumed_chunks']} chunks in a fresh process; resilience "
        f"{s['resilience_rate']:.6f} (bar 0.999); exit codes {fr}; mean iters "
        f"{s['mean_iters']:.4f}, p99 {s['iters_p99']:.1f}, max "
        f"{s['max_iters']}; resumed run {s['solves_per_s']:.1f} solves/s "
        f"(steady state {s['steady_state_solves_per_s']:.1f}), uninterrupted "
        f"run {whole['solves_per_s']:.1f} (steady state "
        f"{whole['steady_state_solves_per_s']:.1f}); two processes' wall "
        f"{wall:.1f} s; uninterrupted K1 {l1} = host-loop steps {steps}; "
        f"chunks differing from the uninterrupted run: {differ}")
    if not (s["resumed_chunks"] == MC_RESUME_AFTER
            and s["n_scenarios"] == MC_CHUNKS * MC_BATCH):
        fail(f"config 5: resumed {s['resumed_chunks']}, n "
             f"{s['n_scenarios']}")
    if not s["resilience_rate"] >= 0.999:
        fail(f"config 5: resilience {s['resilience_rate']}")
    if differ:
        fail(f"config 5: chunks {differ} differ from the uninterrupted run")
    if not l1 == steps > 0:
        fail(f"config 5: K1 {l1} vs {steps} host-loop steps")


def check_entry(dev):
    """Phase 14(d): entry() and dryrun_multichip(1) on the card."""
    fn, args = entry.entry(device=dev)
    reset_counts()
    out, ec, kkt = fn(*args)
    torch.cuda.synchronize()
    (l1, l2, l3, l4a, l4b, lc, lr), steps = launch_counts(), ipm_lanes.STEPS
    fn_c, args_c = entry.entry(device="cpu")
    ec_c = int(fn_c(*args_c)[1])
    say(f"phase 14 entry(): mpc_output {tuple(out.shape)} finite "
        f"{bool(out.isfinite().all())}, exit code {int(ec)} (CPU {ec_c}), "
        f"kkt {float(kkt):.2e}; references {lr} K2 {l2} chain {lc} K3 {l3} K1 "
        f"{l1}, host-loop steps {steps}")
    if not (bool(out.isfinite().all()) and int(ec) == ec_c):
        fail(f"entry(): exit code {int(ec)} vs CPU {ec_c} or not finite")
    if not (lr == l2 == lc == l3 == 1 and l1 == steps > 0
            and l4a == l4b == 0):
        fail(f"entry() launches: K1 {l1} vs {steps}, the references {lr}, "
             f"K2 {l2}, the chain {lc}, K3 {l3}")
    t0 = time.perf_counter()
    rep = entry.dryrun_multichip(1, timeout=300)
    say(f"phase 14 dryrun_multichip(1): {rep} in "
        f"{time.perf_counter() - t0:.1f} s")
    if rep["shape"] != [2, DEFAULT_CONFIG.model.N + 1, 17]:
        fail(f"dryrun_multichip: {rep}")


def run_slice5(dev, card):
    """Phase 14: (a) the FORCES API, (b) the sharded solve, (c) BASELINE
    config 5 resumed, (d) entry() and dryrun_multichip(1)."""
    check_forces_api(dev, card)
    check_sharded(dev, card)
    check_monte_carlo(dev, card)
    check_entry(dev)


# ---------------------------------------------------------------------------
# slice 6: the stress batch, the certificate, the shipped solver, examples
# ---------------------------------------------------------------------------

def check_stress(dev):
    """Phase 15(a): the stress batch at f64 and f32 through K1, the f64
    solve against the plain versions on the card.  Returns K1's launches
    (f64, f32)."""
    cfg = workloads.bench_config()
    slack = cfg.solver.corridor_slack
    res, l1 = {}, {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        reset_counts()
        r, params = stress_oracle.solve_stress(STRESS_B, dtype, dev)
        torch.cuda.synchronize()
        counts, steps = launch_counts(), ipm_lanes.STEPS
        if not solver_launches_ok(counts, steps, cfg.solver):
            fail(f"stress {name}: K1 {counts[0]}, K4a {counts[3]} vs "
                 f"{steps} host-loop steps")
        if not torch.isfinite(r.Z).all():
            fail(f"stress {name}: non-finite Z")
        bad = stress_oracle.false_optimals(r, params, slack)
        ec = r.exit_code.cpu().numpy()
        say(f"phase 15 stress B={STRESS_B} {name}: solved "
            f"{(ec == 1).mean():.4f}, exit families "
            f"{stress_oracle.families(ec)}, false optimals {bad}, K1 "
            f"{counts[0]} = host-loop steps {steps}, Z finite")
        if bad:
            fail(f"stress {name}: false optimals on lanes {bad}")
        res[name], l1[name] = r, counts[0]
    with plain_routes():
        plain, _ = stress_oracle.solve_stress(STRESS_B, torch.float64, dev)
    torch.cuda.synchronize()
    g = res["f64"]
    same_ec = torch.equal(plain.exit_code, g.exit_code)
    same_it = torch.equal(plain.iters, g.iters)
    dZ = (plain.Z - g.Z).abs().max().item()
    ec64, ec32 = (r.exit_code.cpu().numpy() for r in (g, res["f32"]))
    conf = stress_oracle.confusion(ec64, ec32)
    say(f"phase 15 stress f64 card vs the plain f64 solve on the card: exit "
        f"codes identical {same_ec}, iterations identical {same_it}, max "
        f"|dZ| {dZ:.3e}; f32 families {stress_oracle.families(ec32)} "
        f"beside f64 {stress_oracle.families(ec64)}; f64 vs f32 {conf}")
    if not (same_ec and same_it):
        fail("stress f64: the card's exit codes or iterations differ from "
             "the plain solve's")
    return l1["f64"], l1["f32"]


def start_certificate(dev):
    """Phase 15(b), the card's half: CERT_SEEDS' bench grids and the fence
    scenes at f32 through K1, their picked lanes handed to the oracle pool.
    Returns what finish_certificate needs and K1's launches."""
    reset_counts()
    t0 = time.perf_counter()
    lanes, fracs = [], {}
    for seed in CERT_SEEDS:
        got, fracs[f"box{seed}"] = parity.box_lanes(seed, CERT_BOX_LANES, dev)
        lanes += got
    got, fracs["fence"] = parity.fence_lanes(CERT_FENCE_LANES, dev)
    lanes += got
    torch.cuda.synchronize()
    counts, steps = launch_counts(), ipm_lanes.STEPS
    if not solver_launches_ok(counts, steps, workloads.bench_config().solver):
        fail(f"certificate: K1 {counts[0]} vs {steps} host-loop steps")
    say(f"phase 15 certificate, card: solved {fracs}, lanes "
        f"{[(ln.family, ln.lane, ln.iters) for ln in lanes]} (family, lane, "
        f"iterations), K1 {counts[0]} = host-loop steps {steps}; "
        f"{time.perf_counter() - t0:.1f} s; {len(lanes)} oracle lanes "
        "started in the pool")
    pool = oracle_pool.make_pool(len(lanes))
    return (lanes, fracs, pool, parity.submit(pool, lanes),
            time.perf_counter()), counts[0]


def finish_certificate(started, card):
    """Phase 15(b), the oracle's half: |du| <= 1e-3 on every lane."""
    lanes, fracs, pool, futures, t0 = started
    try:
        records = parity.collect(lanes, futures)
    finally:
        pool.shutdown()
    s = parity.summary(records, fracs, time.perf_counter() - t0,
                       len(CERT_SEEDS))
    per = ", ".join(f"{r['family']} {r['lane']}: {r['du']:.2e} (status "
                    f"{r['status']}, {r['tries']} tries, {r['seconds']:.1f} s)"
                    for r in records)
    say(f"phase 15 certificate [{card}]: max |u_card - u_oracle| "
        f"{s.get('max_u_diff', float('nan')):.3e} over {s['n_lanes']} lanes "
        f"(bar {parity.TOL}), {s.get('n_strict_lanes')} strict; {per}; the "
        f"pool's wall {s.get('oracle_wall_s', 0.0):.1f} s after the card's "
        "solves")
    if not s["pass"] or s["n_lanes"] != len(lanes) or not lanes:
        fail(f"certificate: {s}")


AOT_CHILD = """
import json, os, sys, tempfile, time
from pathlib import Path
t0 = time.perf_counter()
import torch
from forces_resilient_planner_tpu_torch.ops import _build, ipm_kernel
builds = []
build = _build.build
def counted(*sources):
    builds.append(sources)
    return build(*sources)
def no_nvcc():
    raise RuntimeError("the shipped solver looked for nvcc")
_build.build = counted
_build.find_nvcc = no_nvcc
_build.NVCC_FALLBACK = os.devnull + "/nvcc"
# an empty build directory: no library the checkout built can be loaded
_build.BUILD_DIR = Path(tempfile.mkdtemp())
from forces_resilient_planner_tpu_torch.solver.nlp import (
    NLPParams, StageWeights)
from forces_resilient_planner_tpu_torch.utils import aot
path, scen, out, device = sys.argv[1:5]
solver = aot.load_solver(path, device=device)
t = torch.load(scen, map_location=device)
res = solver(t[0], NLPParams(*t[1:7], weights=StageWeights(*t[7:])))
torch.save(tuple(t.cpu() for t in res), out)
libs = sorted(str(p) for p in _build._prebuilt.values())
print(json.dumps({"builds": len(builds), "launches": ipm_kernel.LAUNCHES,
                  "seconds": time.perf_counter() - t0, "libraries": libs,
                  "build_dir_files": len(os.listdir(_build.BUILD_DIR))}))
"""


def check_aot(dev, build_s):
    """Phase 15(c): the bench solver exported here, loaded and run in a
    fresh process without nvcc (none on its PATH, no CUDA_HOME, the
    port's nvcc lookup made to raise) and with an empty build directory,
    on this process's inputs (the bench grid of seed 1, saved), bit-equal
    to this process's solve, having built nothing.  Returns the child's K1
    launches and this process's."""
    cfg = workloads.bench_config()
    g, f = workloads.bench_seeds(1)
    scen = batch.make_scenarios(cfg, g, f, workloads.HALVES,
                                dtype=torch.float32, device=dev)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = aot.export_batched_solver(cfg, scen.batch, torch.float32,
                                         f"{d}/solver")
        export_s = time.perf_counter() - t0
        reset_counts()
        ref = batch.solve_scenarios(scen, cfg)
        torch.cuda.synchronize()
        l1, steps = launch_counts()[0], ipm_lanes.STEPS
        torch.save((scen.Z0, *scen.params[:-1], *scen.params.weights),
                   f"{d}/scen.pt")
        env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
        env["PATH"] = os.pathsep.join(
            p for p in env.get("PATH", "").split(os.pathsep)
            if p and not os.path.exists(os.path.join(p, "nvcc")))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", AOT_CHILD, str(path), f"{d}/scen.pt",
             f"{d}/res.pt", str(dev)],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"AOT child: exit {proc.returncode}: {proc.stderr[-2000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(f"{d}/res.pt")
        same = all(bit_equal(a, b.cpu()) for a, b in zip(got, ref))
        mb = sum(os.path.getsize(os.path.join(path, n))
                 for n in os.listdir(path)) / 1e6
        n_libs = len(aot.read_manifest(path)["libraries"])
    say(f"phase 15 AOT: exported {n_libs} libraries + manifest ({mb:.1f} "
        f"MB) in {export_s:.2f} s; a fresh "
        f"process without nvcc (not on PATH, no CUDA_HOME, the lookup "
        f"raising) and an empty build directory loaded "
        f"{len(rep['libraries'])} prebuilt libraries, built "
        f"{rep['builds']} times ({rep['build_dir_files']} files in its "
        f"build directory), launched K1 {rep['launches']} times (this "
        f"process {l1} = host-loop steps {steps}), bit-equal {same}; its "
        f"wall {child_s:.1f} s (import to result {rep['seconds']:.1f} s) "
        f"against {build_s:.1f} s more for a process that builds (phase 1)")
    if not (same and rep["builds"] == 0 and rep["build_dir_files"] == 0
            and rep["launches"] == l1 > 0
            and len(rep["libraries"]) == len(_build.SOURCES)):
        fail(f"AOT round trip: bit-equal {same}, {rep}")
    return rep["launches"], l1


def run_example(module, argv):
    """One example's main in this process, its output captured: (its
    return value, its printed text, launch_counts(), host-loop steps,
    seconds)."""
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = module.main(argv)
    torch.cuda.synchronize()
    return (out, buf.getvalue(), launch_counts(), ipm_lanes.STEPS,
            time.perf_counter() - t0)


def check_examples(dev, card):
    """Phase 15(d): examples 1-4 and 6 at their defaults on the card (config
    1 also with --oracle, config 6 at FLEET_EXAMPLE_ARGS).  Returns the
    launches (K1, K2, K3) of the five runs, summed."""
    total = np.zeros(3, int)
    with tempfile.TemporaryDirectory() as d:
        runs = (("config1", config1, []), ("config1 --oracle", config1,
                                            ["--oracle"]),
                ("config2", config2, []), ("config3", config3,
                                           ["--out-dir", d]),
                ("config4", config4, []),
                ("config6", config6, FLEET_EXAMPLE_ARGS))
        for label, module, argv in runs:
            out, text, counts, steps, sec = run_example(module, argv)
            l1, l2, l3 = counts[:3]
            total += (l1, l2, l3)
            lines = [ln for ln in text.splitlines() if ln.strip()]
            say(f"phase 15 example {label} [{card}]: {sec:.1f} s, K1 {l1} = "
                f"host-loop steps {steps}, references {counts[6]}, K2 {l2}, "
                f"chain {counts[5]}, K3 {l3}; "
                + " | ".join(lines[-3:] if label.startswith("config1")
                             else lines[-2:]))
            ok = (l1 == steps > 0 and counts[3] == counts[4] == 0
                  and counts[5] == counts[6] == l2)
            if label.startswith("config1"):
                ok &= out["exit"] == 1 and out.get("oracle_err", 0) <= 1e-3
                ok &= l2 == l3 == 0
            elif label == "config2":
                ok &= out["exit"] == 1 and l2 == l3 == 1
            elif label == "config3":
                ok &= (out["solves"] > 0 and l2 == l3 == out["solves"]
                       and os.path.getsize(f"{d}/scene_config3.html") > 0)
            elif label == "config4":
                ok &= (out["exit_codes"] == 1).mean() >= 0.999
                ok &= l2 == l3 == 0
            else:
                ok &= (out.collided_frac == 0.0 and l2 == l3 == out.n_ticks
                       and "reached" in lines[-1])
            if not ok:
                fail(f"example {label}: launches {counts} vs {steps} steps, "
                     f"output {text[-800:]}")
    return tuple(int(x) for x in total)


def run_slice6(dev, card, build_s):
    """Phase 15: (b) the reduced certificate started first, its oracle
    lanes solved in the pool while (a) the stress batch, (c) the shipped
    solver and (d) the examples run; then (b)'s bar.  Returns each K1/K2/K3
    entry's launches on these paths."""
    t0 = time.perf_counter()
    started, l1_cert = start_certificate(dev)
    l1_f64, l1_f32 = check_stress(dev)
    l1_child, l1_aot = check_aot(dev, build_s)
    l1_ex, l2_ex, l3_ex = check_examples(dev, card)
    finish_certificate(started, card)
    say(f"phase 15 total {time.perf_counter() - t0:.1f} s")
    return {
        "ipm_iteration": {"stress f64": l1_f64, "stress f32": l1_f32,
                          "certificate": l1_cert, "aot in process": l1_aot,
                          "aot child": l1_child, "examples": l1_ex},
        "tube_stage": {"examples": l2_ex},
        "corridor": {"examples": l3_ex},
    }


# ---------------------------------------------------------------------------
# phase 16: slice 7, the corridor decomposition on every cloud and option
# ---------------------------------------------------------------------------

# K3's gathered route (cloud past shared memory, or compaction): (B, M, k,
# dtypes held against the plain version, the first also timed); the first
# case is the {"kernels"} entry's shape
GATHERED_CASES = (
    (64, 16_384, 0, ("f32",)),
    (64, 8_192, 0, ("f64",)),
    (8, 70_000, 0, ("f32", "f64")),
    (512, 256, 64, ("f32", "f64")),
    (512, 2048, 64, ("f32", "f64")),
)
DTYPES = {"f32": torch.float32, "f64": torch.float64}
PLANNER_CLOUD = 8192     # phase 16: the f64 planner's max_cloud


def fence_segments(B, N, seed):
    """Stage segments about the fence's gap: p1 on points of the 0.1 m
    lattice in front of, in and behind the fence, p2 0.1 m from it along
    +-x, +-y or +-z at the even stages and along a random yaw at the odd
    ones."""
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.integers(5, 26, (B, N)), rng.integers(-5, 17, (B, N)),
                   rng.integers(6, 18, (B, N))], -1) * 0.1
    axis = np.zeros((B, N, 3))
    np.put_along_axis(axis, rng.integers(0, 3, (B, N, 1)),
                      rng.choice([-0.1, 0.1], (B, N, 1)), -1)
    yaw = rng.uniform(-np.pi, np.pi, (B, N))
    generic = 0.1 * np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)],
                             -1)
    return p1, p1 + np.where((np.arange(N) % 2 == 0)[None, :, None], axis,
                             generic)


def gathered_case(B, M, k, dtypes, dev, card):
    """K3 on random stage segments (phase 6's generator) at B x N x M with
    the compaction to k (0: off): the gathered route (else the phase
    fails); f64 rows within 1e-9 of the plain version's on every row, f32
    rows' max |d| printed; then, at the first of dtypes, ms of K3 and of
    the plain version beside K3's bound.  Returns (f32 max |d|, ms, plain
    ms, bound)."""
    cfg = DEFAULT_CONFIG
    N = cfg.model.N
    ccfg = dataclasses.replace(cfg.corridor, max_active_obstacles=k)
    lib = _build.load(corridor_kernel.SOURCE, corridor_kernel._bind)
    raw = random_segments(B, N, M, 31 + M)
    msg, err32 = [], float("nan")
    for name in dtypes:
        dtype = DTYPES[name]
        args = [torch.as_tensor(a, dtype=dtype, device=dev)
                for a in raw[:3]] + [torch.as_tensor(raw[3], device=dev)]
        geo = corridor_kernel.launch_geometry(
            lib, B, N, M, dtype, corridor_kernel.compaction_k(ccfg, M))
        if geo.route != 2:
            fail(f"K3 B={B} M={M} k={k} {name}: route {geo.route}, not the "
                 "gathered one")
        dA, db = corridor_rows(args, ccfg, cfg.model.nh)
        worst = max(dA.max().item(), db.max().item())
        if name == "f64" and worst > 1e-9:
            fail(f"K3 gathered f64 B={B} M={M} k={k}: max row |d| "
                 f"{worst:.3e} > 1e-9 on "
                 f"{int(((dA > 1e-9) | (db > 1e-9)).sum())} (robot, stage)")
        if name == "f32":
            err32 = worst
            share = ((dA <= 1e-4) & (db <= 1e-4)).double().mean().item()
            msg.append(f"f32 max |d| {worst:.2e}, rows within 1e-4 on "
                       f"{share:.6f} of (robot, stage)")
        else:
            msg.append(f"f64 max |d| {worst:.2e} (bar 1e-9 on every row)")
    timed = DTYPES[dtypes[0]]
    args = [torch.as_tensor(a, dtype=timed, device=dev)
            for a in raw[:3]] + [torch.as_tensor(raw[3], device=dev)]
    cargs = (*args, ccfg, cfg.model.nh)
    ms = cuda_ms(lambda: corridor_kernel.decompose_stages_lanes(*cargs), 3)
    ms_plain = cuda_ms(
        lambda: corridor_kernel.decompose_stages_reference(*cargs), 1)
    ops, work = corridor_flops(args, ccfg)
    b = bound(tensor_bytes(args, corridor_kernel.decompose_stages_reference(
        *cargs)), ops, timed)
    geo = corridor_kernel.launch_geometry(
        lib, B, N, M, timed, corridor_kernel.compaction_k(ccfg, M))
    say(f"phase 16 K3 gathered B={B} N={N} M={M} k={k} [{card}]: "
        + "; ".join(msg) + f"; {dtypes[0]} {ms:.3f} ms vs plain "
        f"{ms_plain:.3f} ms, "
        f"bound {b[0]:.4f} ms by {b[1]} ({1e-9 * ops:.4f} GFLOP of work "
        f"{work}), {100 * b[0] / ms:.2f}% of the bound; {geo.lanes} lanes "
        f"per stage, {geo.threads} threads, scratch {geo.scratch} B")
    return err32, ms, ms_plain, b


def fence_voxels_f64(dev):
    """K3's shared route at f64 on the fence's voxel cloud (tests/
    test_closed_loop.py's scene, on the 0.1 m lattice) and segments from
    lattice points: rows within 1e-9 of the plain version's."""
    cfg = DEFAULT_CONFIG
    B, N = 64, cfg.model.N
    cloud = workloads.fence_points()
    p1, p2 = fence_segments(B, N, 5)
    f64 = torch.float64
    args = [torch.as_tensor(p1, dtype=f64, device=dev),
            torch.as_tensor(p2, dtype=f64, device=dev),
            torch.as_tensor(np.repeat(cloud[None], B, 0), dtype=f64,
                            device=dev),
            torch.ones(B, len(cloud), dtype=torch.bool, device=dev)]
    lib = _build.load(corridor_kernel.SOURCE, corridor_kernel._bind)
    geo = corridor_kernel.launch_geometry(lib, B, N, len(cloud), f64)
    if geo.route != 1:
        fail(f"K3 on the fence's cloud: route {geo.route}, not the shared one")
    corridor_f64(args, f"the fence's voxel cloud B={B} N={N} M={len(cloud)}, "
                 "lattice segments, shared route", phase=16)


def check_planner_f64(dev, card):
    """BASELINE config 3's loop (examples/config3_obstacle_scene.py: the
    fence, its sinusoidal wind, 7 s to the goal) with the planner at f64
    and max_cloud = PLANNER_CLOUD, past the shared route's 6,456 at f64:
    final position within 0.5 m of the goal, no trace point in an occupied
    voxel, K3 once a solve by the gathered route.  Returns its launches."""
    cfg = workloads.closed_loop_cfg()
    reset_counts()
    t0 = time.perf_counter()
    p = planner.ResilientPlanner(cfg, max_cloud=PLANNER_CLOUD,
                                 dtype=torch.float64, device=dev)
    x0 = np.zeros(9)
    x0[2] = 1.2
    sim = simulator.QuadSim(cfg.model, x0.copy(), np.zeros(3))
    p.on_odometry(x0)
    p.set_occupied(workloads.fence_points())
    trace = simulator.run_closed_loop(p, sim, config3.GOAL,
                                      duration=config3.DURATION,
                                      force_schedule=workloads.wind)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    l1, l2, _, l4a, l4b, lc, lr = launch_counts()
    routes = dict(corridor_kernel.LAUNCHES)
    steps, d = ipm_lanes.STEPS, p.diag
    pos = np.asarray(trace["pos"])
    occ = occ_grid.voxel_state(p.grid, torch.as_tensor(
        pos, dtype=p.grid.buffer.dtype, device=dev), cfg.map)
    hits = int((occ == 1).sum())
    goal = np.array([*config3.GOAL, 1.2])
    miss = float(np.linalg.norm(pos[-1] - goal))
    solve = np.asarray(d.timers._phases["solve"].samples[3:]) * 1e3
    say(f"phase 16 planner f64 max_cloud={PLANNER_CLOUD}, BASELINE config 3's "
        f"fence loop {config3.DURATION} s [{card}]: final distance to the goal "
        f"{miss:.3f} m (bar 0.5), {hits} trace points in occupied voxels "
        f"(bar 0), solves {d.solves}, failures {d.solve_failures}, replans "
        f"{d.replans}; MPC tick (solve) p50 {np.percentile(solve, 50):.2f} "
        f"ms, p99 {np.percentile(solve, 99):.2f} ms over {len(solve)} ticks "
        f"after 3; launches K3 {routes}, references {lr}, K2 {l2}, chain "
        f"{lc}, K1 {l1}, host-loop steps {steps}; wall {wall:.2f} s")
    if not miss < 0.5:
        fail(f"planner f64: final distance {miss:.3f} m to the goal >= 0.5")
    if hits:
        fail(f"planner f64: {hits} trace points in occupied voxels")
    if not (routes["corridor_gathered"] == lr == l2 == lc == d.solves > 0
            and routes["corridor"] == 0 and l1 == steps > 0
            and l4a == l4b == 0):
        fail(f"planner f64 launches: K3 {routes}, the references {lr}, K2 "
             f"{l2}, the chain {lc} vs {d.solves} solves, K1 {l1} vs {steps} "
             "steps")
    return routes["corridor_gathered"]


def run_slice7(dev, card):
    """Phase 16: K3's gathered route against the plain version at each of
    GATHERED_CASES, the shared route at f64 on the fence's voxel cloud, and
    the f64 planner past the shared route.  Returns the gathered route's
    {"kernels"} entry."""
    t0 = time.perf_counter()
    first = None
    for B, M, k, dtypes in GATHERED_CASES:
        got = gathered_case(B, M, k, dtypes, dev, card)
        first = first or got
    fence_voxels_f64(dev)
    launches = check_planner_f64(dev, card)
    say(f"phase 16 total {time.perf_counter() - t0:.1f} s")
    err, ms, ms_plain, b = first
    return {"name": "corridor_gathered", "route": "cuda",
            "source": CSRC + "corridor.cu",
            "replaces": "forces_resilient_planner_tpu/ops/corridor_pallas.py:98",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": ms_plain, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None}


BENCH_TIMEOUT = 600      # phase 17: the bench child's seconds


def check_bench(card, grid_rate):
    """Phase 17: the port's bench run as a user runs it, in a process of
    its own; its line checked against its sections' bars."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "forces_resilient_planner_tpu_torch.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT)
    for ln in proc.stderr.splitlines():
        if ln.startswith("[bench]"):
            say(f"phase 17 {ln}")
    if proc.returncode != 0:
        fail(f"the bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    if not lines:
        fail("the bench printed no line")
    line = json.loads(lines[-1])
    x = line["extras"]
    if set(x) != port_bench.EXTRAS_KEYS:
        fail(f"bench extras: missing "
             f"{sorted(port_bench.EXTRAS_KEYS - set(x))}, extra "
             f"{sorted(set(x) - port_bench.EXTRAS_KEYS)}")
    if line["metric"] != port_bench.METRIC or not line["value"] > 0:
        fail(f"bench line: {line['metric']} = {line['value']}")
    if x["card"] != card:
        fail(f"bench card {x['card']!r} != {card!r}")
    if not (x["closed_loop_goal_reached"] and x["closed_loop_no_collision"]):
        fail(f"bench closed loop: reached {x['closed_loop_goal_reached']}, "
             f"no collision {x['closed_loop_no_collision']}")
    if x["fleet_reached_frac"] < 0.95 or x["fleet_collided_frac"] != 0:
        fail(f"bench fleet: reached {x['fleet_reached_frac']}, collided "
             f"{x['fleet_collided_frac']}")
    if not x["pipeline_batched_steps_per_s"] > 0:
        fail(f"bench batched steps/s {x['pipeline_batched_steps_per_s']}")
    say(f"phase 17 bench [{card}]: headline {line['value']} solves/s "
        f"(phase 4's grid: {grid_rate:.1f} solves/s; information), "
        f"per call {x['percall_solves_per_s']}, streamed "
        f"{x['streamed_range']} / {x['streamed_range_2nd']}; the child in "
        f"{time.perf_counter() - t0:.1f} s")


def lane_position_check(state, params, cfg, seed):
    """K1 on a permutation of the lanes gives the permuted outputs bit for
    bit, and the 256 lanes that the tier schedule would compact (the
    unconverged first) launched alone equal the same lanes of the full
    launch (utils/lanes.py: the tiered solve's bit-exactness)."""
    B = state[0].shape[-1]
    full = ipm_kernel.ipm_iteration_fused(*iter_args(state, params, cfg))
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(B, generator=gen).to(state[0].device)
    tier = ipm_lanes._compact_order(state[4][2] > 0.5)[:256]
    for label, idx in (("a permutation of the lanes", perm),
                       ("the 256-lane tier alone", tier)):
        sub = [a[..., idx].contiguous() for a in state]
        sub_p = ipm_lanes._map_params(lambda a: a[..., idx].contiguous(),
                                      params)
        got = ipm_kernel.ipm_iteration_fused(*iter_args(sub, sub_p, cfg))
        torch.cuda.synchronize()
        for name, g, r in zip(("Z", "lam", "s", "mu_d", "scal"), got, full):
            if not bit_equal(g, r[..., idx]):
                fail(f"K1 on {label}: {name} differs from the full launch")
    return (f"bit-identical on a permutation of the {B} lanes and on "
            f"{tier.numel()} tier lanes launched alone")


def check_k1(cfg, dev):
    """Phase 2: K1 against its plain version at B = 4096 from the grid's
    initial state and after 8 plain iterations, f64 and f32, and the lane-
    position check; returns {dtype: max |kernel - plain| from the initial
    state}."""
    errs = {}
    for dtype, rel_tol, done_frac in ((torch.float64, 1e-9, 1.0),
                                      (torch.float32, 1e-3, 0.999)):
        state, params = bench_lanes(cfg, 1, dtype, dev)
        r0 = compare_step(state, params, cfg, rel_tol, done_frac, False)
        for _ in range(8):
            state = list(ipm_kernel.ipm_iteration_reference(
                *iter_args(state, params, cfg)))
        r8 = compare_step(state, params, cfg, rel_tol, done_frac,
                          dtype == torch.float32)
        errs[dtype] = r0[1]
        say(f"phase 2 kernel vs plain {str(dtype)[6:]} B={state[0].shape[-1]}:"
            f" init max rel {r0[0]:.3e} abs {r0[1]:.3e} done-agree {r0[2]:.6f};"
            f" after 8 plain iters max rel {r8[0]:.3e} abs {r8[1]:.3e}"
            f" done-agree {r8[2]:.6f} (bound {rel_tol:g} (1+|ref|))")
        say(f"phase 2 K1 lane position {str(dtype)[6:]}, after 8 plain "
            f"iters: {lane_position_check(state, params, cfg, 8)}")
    return errs


def time_k1(cfg, dev, card):
    """Phase 4, K1: ms per iteration at B = 4096, 1024, 256 and 1 (the
    first lanes of the grid of seed 2 at its initial state, every lane
    active) with CUDA events, each beside its bound; the plain version at
    4096.  Returns (ms, plain ms, bound ms, bound by) at B = 4096."""
    state, params = bench_lanes(cfg, 2, torch.float32, dev)
    args = iter_args(state, params, cfg)
    ms_plain = cuda_ms(lambda: ipm_kernel.ipm_iteration_reference(*args), 5)
    k1_times = {}
    for Bw in (4096, 1024, 256, 1):
        sub = [a[..., :Bw].contiguous() for a in state]
        sub_p = ipm_lanes._map_params(lambda a: a[..., :Bw].contiguous(),
                                      params)
        a = iter_args(sub, sub_p, cfg)
        ms = cuda_ms(lambda: ipm_kernel.ipm_iteration_fused(*a), 20)
        ms2 = cuda_ms(lambda: ipm_kernel.ipm_iteration_fused(*a), 20)
        bms, by = bound(tensor_bytes(a[:13]) + tensor_bytes(a[:5]),
                        Bw * k1_flops(cfg.model.N))
        k1_times[Bw] = (min(ms, ms2), bms, by)
        say(f"phase 4 K1 per iteration B={Bw} f32 [{card}]: {ms:.4f} ms "
            f"(repeat {ms2:.4f} ms); bound {bms:.4f} ms by {by} "
            f"({1e-6 * tensor_bytes(a[:13], a[:5]):.3f} MB, "
            f"{1e-9 * Bw * k1_flops(cfg.model.N):.4f} GFLOP), "
            f"{100 * bms / min(ms, ms2):.2f}% of the bound")
    ms_kernel, bound_ms, bound_by = k1_times[4096]
    say(f"phase 4 per iteration B=4096 f32 [{card}]: kernel {ms_kernel:.3f} "
        f"ms, plain PyTorch {ms_plain:.3f} ms")
    return ms_kernel, ms_plain, bound_ms, bound_by


def device_phase():
    """Phase 0: the card, or None without one."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return None
    if "jax" in sys.modules:
        fail("jax was imported")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line(dev)
    kind = torch.cuda.get_device_name(0)
    say(f"phase 0 device: {kind} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return dev, card, kind


def build_phase():
    """Phase 1: every kernel source built, one nvcc each, all at once."""
    t0 = time.perf_counter()
    for source, built in _build.build().items():
        ptxas = [ln.strip() for ln in built.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry function" in ln]
        say(f"phase 1 build {source}: {built.seconds:.1f} s -> "
            f"{built.path.name}; " + " | ".join(ptxas))
    build_s = time.perf_counter() - t0
    say(f"phase 1 build: all sources in {build_s:.1f} s")
    N = workloads.bench_config().model.N
    geo = []
    for dtype in (torch.float32, torch.float64):
        lanes, smem, stride = ipm_kernel.launch_geometry(dtype, N)
        geo.append(f"{str(dtype)[6:]} {lanes} lanes x {smem // lanes} B = "
                   f"{smem} B of shared memory per CTA, "
                   f"{ipm_kernel.TEAM * lanes} threads")
    say(f"phase 1 K1 ({KERNEL_SOURCE}) at N = {N}: " + "; ".join(geo)
        + " (registers and spills: the ipm_iteration.cu line above)")
    lib2 = _build.load(tube_kernel.SOURCE, tube_kernel._bind)
    geo = []
    for dtype in (torch.float32, torch.float64):
        lanes, threads, smem = tube_kernel.launch_geometry(lib2, dtype)
        geo.append(f"{str(dtype)[6:]} {lanes} stage lanes x 9 threads "
                   f"({threads} threads, {smem} B of shared memory) per CTA")
    say("phase 1 K2 (tube_stage.cu): " + "; ".join(geo)
        + " (registers and spills: the tube_stage.cu line above)")
    # tube_chain.cu's compile-time geometry: CHAIN_TEAMS = 3 robots of 9
    # threads in one warp, chain_robot_elements(N) = 18 N + 144 a robot
    say(f"phase 1 the tube chain (tube_chain.cu) at N = {N}: 3 robots x 9 "
        f"threads (32 threads) per CTA, {3 * (18 * N + 144) * 4} / "
        f"{3 * (18 * N + 144) * 8} B of shared memory at f32 / f64 "
        "(registers and spills: the tube_chain.cu line above)")
    # reference.cu's compile-time geometry: REF_THREADS = 32 robots, one
    # thread each, per CTA, no shared memory
    say(f"phase 1 the references (reference.cu): 32 robots, one thread "
        f"each, per CTA, {STEP_B // 32} CTAs at B={STEP_B}, no shared memory "
        "(registers and spills: the reference.cu line above)")
    lib3 = _build.load(corridor_kernel.SOURCE, corridor_kernel._bind)
    geo = []
    for dtype in (torch.float32, torch.float64):
        for M, k in ((STEP_M, 0), (1024, 0), (2048, 0), (8192, 0),
                     (16_384, 0), (70_000, 0), (2048, 64)):
            g = corridor_kernel.launch_geometry(lib3, STEP_B, N, M, dtype, k)
            geo.append(f"{str(dtype)[6:]} M={M} k={k}: route {g.route}, "
                       f"{g.lanes} lanes per stage, {g.threads} threads, "
                       f"{g.smem} B of shared memory, {g.scratch} B of scratch "
                       f"at B={STEP_B}")
    say(f"phase 1 K3 (corridor.cu) per CTA (one scenario, N = {N}; route 1 "
        "shared, 2 gathered): " + "; ".join(geo)
        + " (registers: the corridor.cu line above)")
    geo = []
    for name, (label, _) in LQR_KERNELS.items():
        for dtype in (torch.float32, torch.float64):
            g = lqr_kernel.launch_geometry(
                dtype, N, "backsolve" in name, blocks=not name.endswith(
                    "_fused"))
            geo.append(f"{label} {str(dtype)[6:]} {g.lanes} lanes x "
                       f"{g.smem // g.lanes} B = {g.smem} B of shared memory, "
                       f"{g.threads} threads")
    say(f"phase 1 K4 and K5 (lqr.cu, a warp per lane) per CTA at N = {N}: "
        + "; ".join(geo) + " (registers and spills: the lqr.cu line above)")
    return build_s


def main() -> int:
    # ---- phase 0: device ------------------------------------------------
    found = device_phase()
    if found is None:
        return 1
    dev, card, kind = found

    # ---- phase 1: build ---------------------------------------------------
    build_s = build_phase()

    cfg = workloads.bench_config()

    # ---- phase 2: kernel vs plain at B = 4096 -----------------------------
    errs = check_k1(cfg, dev)

    # ---- phase 3: main path ---------------------------------------------
    launches = check_grid(dev, cfg, 3, solved_min=0.999)[0]
    B = workloads.N_GOALS * workloads.N_FORCES * len(workloads.HALVES)

    # ---- phase 4: times ---------------------------------------------------
    ms_kernel, ms_plain, bound_ms, bound_by = time_k1(cfg, dev, card)
    lat_ms, iters = grid_times(cfg, dev)
    say(f"phase 4 grid solve B={B} f32 [{card}]: {lat_ms.mean():.2f} ms/call "
        f"(min {lat_ms.min():.2f}, max {lat_ms.max():.2f}), "
        f"{B / lat_ms.mean() * 1e3:.1f} solves/s, mean iters {iters:.3f}")

    slice2 = run_slice2(dev, card)
    slice3 = run_slice3(dev, card, (lat_ms.mean(), iters))

    # ---- phases 12-13: the closed loop -------------------------------------
    check_fleet(dev, card)
    check_robot(dev, card)

    # ---- phase 14: the surfaces and scale-out ------------------------------
    run_slice5(dev, card)

    # ---- phase 15: stress, certificate, shipped solver, examples ----------
    slice6 = run_slice6(dev, card, build_s)

    # ---- phase 16: the corridor decomposition on every cloud and option ---
    slice7 = run_slice7(dev, card)

    # ---- phase 17: the headline bench -------------------------------------
    check_bench(card, B / lat_ms.mean() * 1e3)

    say(f"chip_smoke total {time.perf_counter() - T0:.1f} s")
    # max_abs_err: f32 kernel vs plain from the initial state, the check
    # held elementwise (the mid-solve one is printed in phase 2)
    # launches: the slice-1 main path's (phase 3); launches_phase15: the
    # same kernel's on phase 15's paths
    kernels = [{
        "name": "ipm_iteration", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": errs[torch.float32], "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, *slice2, slice7, *slice3]
    for k in kernels:
        if k["name"] in slice6:
            k["launches_phase15"] = slice6[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
