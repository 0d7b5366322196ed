"""The port's host spans (forces_resilient_planner_tpu_torch/utils/trace.py):
each span opens where its work happens and is counted once a call; the
solver's read span counts every loop-condition read; the profiler sees no
span of the program unless trace.annotate() is active, and then each
span's range encloses the operators run inside it, on the profiler's own
timestamps; annotating changes no result.  Small CPU sizes at f64 (the
scenes of test_torch_pipeline.py, test_torch_forces_api.py and
test_torch_batch.py); no JAX."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.engine import batch, workloads
from forces_resilient_planner_tpu_torch.engine import pipeline_batch as pb
from forces_resilient_planner_tpu_torch.examples.forces_api_migration import (
    migration_params,
)
from forces_resilient_planner_tpu_torch.solver import forces_api, ipm_lanes
from forces_resilient_planner_tpu_torch.solver.problems import (
    hover_warm_start,
)
from forces_resilient_planner_tpu_torch.utils import trace

F64 = torch.float64
B = 4
STEP_SPANS = ("step", "step.references", "step.tubes", "step.corridors",
              "solver")
PROGRAM_SPANS = STEP_SPANS + ("solver.read", "solver.tail", "api",
                              "grid.expand")


def _step_inputs():
    """test_pipeline.py's obstacle scene (M = 512, 200 points drawn, the
    corridor along the path kept open) for B robots, each with its own
    force, time offset and perturbed deque; robot 1 on the final profile."""
    N = C.model.N
    x0 = np.zeros(9)
    x0[2] = 1.2
    Z = hover_warm_start(torch.as_tensor(x0, dtype=F64), C.model).numpy()
    K = 128
    t = np.arange(K) * C.model.dt
    path = np.stack([1.5 * t, np.zeros(K), np.full(K, 1.2)], -1)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-1, -2.5, 0], [6, 2.5, 2.5], (200, 3))
    pts = pts[np.abs(pts[:, 1]) > 0.6]
    obs, mask = np.zeros((512, 3)), np.zeros(512, bool)
    obs[:len(pts)], mask[:len(pts)] = pts, True
    rng = np.random.default_rng(3)
    a = {"mpc_output": np.concatenate([Z, Z[-1:]], axis=0),
         "kino_path": path, "kino_size": K, "t_offset": 0.0,
         "state_mpc": x0, "f_ext": np.zeros(3), "end_pt": path[-1],
         "obstacles": obs, "obstacle_mask": mask, "use_final": False}
    a = {k: np.stack([np.asarray(v)] * B) for k, v in a.items()}
    a["f_ext"] = rng.uniform(-1.0, 1.0, (B, 3))
    a["t_offset"] = rng.uniform(0.0, 0.3, (B,))
    a["use_final"] = np.array([False, True, False, False])
    a["mpc_output"] = a["mpc_output"] + rng.normal(0, 1e-3, (B, N + 1, 17))
    return pb.pipeline_inputs_from_numpy(a, dtype=F64, device="cpu")


def _step():
    a = _step_inputs()
    return pb.nmpc_step_batched(*(a[k] for k in pb.PIPELINE_ARG_KEYS), cfg=C)


def _api():
    solver = forces_api.ForcesSolver("normal", dtype=F64, device="cpu")
    return solver.solve(migration_params(device="cpu"))


def _grid():
    goals, forces = workloads.bench_seeds(7, n_goals=2, n_forces=16)
    return batch.solve_scenario_grid(workloads.bench_config(), goals, forces,
                                     workloads.HALVES, dtype=F64,
                                     device="cpu")


def _counted(fn):
    """(fn's result, {span: (count, ns) grown}, ipm_lanes.STEPS grown,
    _run_lanes entries) of one call of fn."""
    entries = []
    run_lanes = ipm_lanes._run_lanes

    def counting(*args, **kwargs):
        entries.append(1)
        return run_lanes(*args, **kwargs)

    before, steps = trace.totals(), ipm_lanes.STEPS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ipm_lanes, "_run_lanes", counting)
        out = fn()
    after = trace.totals()
    grown = {k: (c - before.get(k, (0, 0))[0], ns - before.get(k, (0, 0))[1])
             for k, (c, ns) in after.items()}
    return out, {k: v for k, v in grown.items() if v[0]}, \
        ipm_lanes.STEPS - steps, len(entries)


@pytest.fixture(scope="module")
def step():
    return _counted(_step)


@pytest.fixture(scope="module")
def api():
    return _counted(_api)


@pytest.fixture(scope="module")
def grid():
    return _counted(_grid)


def test_step_opens_each_step_span_once(step):
    res, spans, steps, entries = step
    assert (res.exit_code == 1).all()
    for name in STEP_SPANS:
        assert spans[name][0] == 1, name
    stages = sum(spans[n][1] for n in STEP_SPANS[1:])
    assert stages <= spans["step"][1]
    # nmpc-default runs untiered: one host loop, no tail
    assert entries == 1 and "solver.tail" not in spans
    assert spans["solver.read"][0] == steps + entries
    assert not {"api", "grid.expand"} & set(spans)


def test_api_solve_holds_its_solve(api):
    (out, flag, info), spans, steps, entries = api
    assert flag == 1 and info.it == steps
    assert spans["api"][0] == spans["solver"][0] == 1
    assert spans["api"][1] >= spans["solver"][1]
    assert spans["solver.read"][0] == steps + entries
    assert not {"step", "grid.expand", "solver.tail"} & set(spans)


def test_tiered_grid_counts_its_expansion_and_tail(grid):
    res, spans, steps, entries = grid
    assert res.exit_code.shape == (32,) and (res.exit_code == 1).all()
    for name in ("grid.expand", "solver", "solver.tail"):
        assert spans[name][0] == 1, name
    assert spans["solver.tail"][1] <= spans["solver"][1]
    # the full batch, two tiers and the safety net
    assert entries == 4
    assert spans["solver.read"][0] == steps + entries


def test_annotate_is_off_by_default_and_nests():
    assert not trace._annotating
    with trace.annotate():
        with trace.annotate():
            assert trace._annotating == 2
        assert trace._annotating == 1
    assert not trace._annotating


def test_report_gives_count_total_and_mean(step):
    rep = trace.report()
    row = rep["step"]
    assert set(row) == {"count", "total_ms", "mean_ms"}
    assert row["count"] >= 1
    assert row["mean_ms"] == pytest.approx(row["total_ms"] / row["count"])
    totals = [r["total_ms"] for r in rep.values()]
    assert totals == sorted(totals, reverse=True)


def _profiled(fn, annotated):
    with contextlib.ExitStack() as stack:
        if annotated:
            stack.enter_context(trace.annotate())
        prof = stack.enter_context(torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]))
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def _one_iteration():
    """An API solve and a tiered grid cut to one interior-point iteration:
    every span but the step's opens, at a small profiler trace."""
    def cut(cfg):
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, max_iters=1))

    forces_api.ForcesSolver("normal", cut(C), F64, device="cpu").solve(
        migration_params(device="cpu"))
    goals, forces = workloads.bench_seeds(7, n_goals=2, n_forces=16)
    batch.solve_scenario_grid(cut(workloads.bench_config()), goals, forces,
                              workloads.HALVES, dtype=F64, device="cpu")


def test_profiler_sees_no_program_span_unannotated():
    before = trace.totals()
    _, events = _profiled(_one_iteration, annotated=False)
    opened = {k for k, (c, _) in trace.totals().items()
              if c > before.get(k, (0, 0))[0]}
    assert opened >= set(PROGRAM_SPANS) - set(STEP_SPANS[:4])
    assert any(name.startswith("aten::") for name, _, _ in events)
    assert not {name for name, _, _ in events} & opened


def test_annotated_spans_enclose_their_operators(step):
    res, events = _profiled(_step, annotated=True)
    assert all(torch.equal(x, y)
               for x, y in zip(_tensors(step[0]), _tensors(res)))
    ops = sorted((s, e, name) for name, s, e in events
                 if name.startswith("aten::"))
    starts = np.array([o[0] for o in ops])
    ends = np.array([o[1] for o in ops])
    reach = np.maximum.accumulate(ends)     # latest end of ops begun so far
    ranges = {}
    for name, s, e in events:
        if name in PROGRAM_SPANS:
            ranges.setdefault(name, []).append((s, e))
    _, spans, _, _ = step
    assert {k: len(v) for k, v in ranges.items()} == \
        {k: spans[k][0] for k in PROGRAM_SPANS if k in spans}
    for name, intervals in ranges.items():
        for s, e in intervals:
            i0, i1 = np.searchsorted(starts, [s, e])
            assert i1 > i0, name          # operators ran inside it
            # and none was open at either edge: none straddles the span
            assert i0 == 0 or reach[i0 - 1] <= s, name
            assert reach[i1 - 1] <= e, name
    # each loop-condition read is one aten::any
    any_at = starts[[o[2] == "aten::any" for o in ops]]
    for s, e in ranges["solver.read"]:
        assert ((any_at >= s) & (any_at < e)).sum() == 1
    (s0, e0), = ranges["step"]
    for name in STEP_SPANS[1:]:
        (s, e), = ranges[name]
        assert s0 <= s and e <= e0, name
    firsts = [ranges[n][0][0] for n in STEP_SPANS[1:]]
    assert firsts == sorted(firsts)


def _tensors(res):
    for f in res:
        yield from (f if isinstance(f, tuple) else (f,))


def test_annotating_changes_no_result(step):
    with trace.annotate():
        annotated = _step()
    pairs = list(zip(_tensors(step[0]), _tensors(annotated)))
    assert len(pairs) == len(list(_tensors(annotated))) > 15
    for x, y in pairs:
        assert torch.equal(x, y)
