"""The port's bench (forces_resilient_planner_tpu_torch/bench.py), the
repo's bench.py program on the card, run here on the CPU at patched small
sizes (2 x 2 goals x forces, one or two repeats a section, a 0.5 s closed
loop, a B = 2 fleet for 0.5 s), f32 as on the card.

(a) its inputs are bench.py's: the batched step's input sets for s = 0-2
    and the B = 1 step's perturbed inputs equal bench.py's own lines (run
    on the JAX package's inputs, at f32) bit for bit; every grid call of
    a run solves bench.py's bench_seeds set of bench.py's seeds, in
    bench.py's order; the closed loop's fence and wind are bench.py's;
    the sizes and repeat counts are bench.py's;
(b) main(device="cpu") prints one JSON line last, with bench.py's metric
    name and extras keys (read from bench.py's main with ast; "card", the
    nvidia-smi line, is written on the card only and is absent here);
(c) a section that raises makes main raise, and nothing is printed to
    stdout;
(d) the roofline share is the hand computation from K1's operation count
    and the card's f32 peak;
(e) the helpers moved from chip_smoke.py into utils/measure.py give the
    numbers they gave there, and chip_smoke.py still exposes them."""
import ast
import dataclasses
import inspect
import io
import json
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import bench as jbench
from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as JCFG
from forces_resilient_planner_tpu_torch import bench, entry
from forces_resilient_planner_tpu_torch.engine import batch as bm
from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.utils import measure

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(N_GOALS=2, N_FORCES=2, THROUGHPUT_REPS=1, STREAM_REPEATS=2,
             SINGLE_REPS=2, FLOOR_REPS=2, STEP_REPS=1, PIPELINE_B=2,
             PIPELINE_SETS=1, CLOSED_LOOP_S=0.5, FLEET_B=2, FLEET_S=0.5)
SECTIONS = ("_throughput", "_single_solve", "_pipeline_step",
            "_pipeline_batched", "_closed_loop_smoke", "_fleet_bench", "_mfu")


def _source_lines(fn, first, last):
    """The lines of fn's source from the one starting with `first` up to
    (not including) the one starting with `last`, dedented."""
    src = inspect.getsource(fn)
    return textwrap.dedent(src[src.index(first):src.index(last)])


def _bench_py_extras_keys():
    """Every key bench.py's main writes into its extras."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "extras"):
                keys.add(t.slice.value)
            elif (isinstance(t, ast.Name) and t.id == "extras"
                  and isinstance(node.value, ast.Dict)):
                keys.update(k.value for k in node.value.keys)
    return keys


@pytest.fixture(scope="module")
def run():
    """main(device="cpu") at the small sizes: (stdout, its returned line,
    the (goals, forces) of every grid call in order)."""
    calls = []
    solve = bm.solve_scenario_grid

    def recorded(cfg, goals, forces, *a, **k):
        calls.append((goals, forces))
        return solve(cfg, goals, forces, *a, **k)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(bench, name, value)
        mp.setattr(bm, "solve_scenario_grid", recorded)
        with redirect_stdout(out):
            line = bench.main(device="cpu")
    return out.getvalue(), line, calls


# ---- (a) the inputs are bench.py's ----------------------------------------

@pytest.fixture(scope="module")
def jax_margs():
    """bench.py's margs(s) at B = 4, from its own lines of _pipeline_batched
    on the JAX package's example inputs."""
    scope = dict(ge=ge, dc=dataclasses, np=np, jnp=jnp, cfg=JCFG, B=4,
                 normalize_pipeline_args=jbench.normalize_pipeline_args)
    exec(_source_lines(jbench._pipeline_batched, "    lean = ge._small_cfg()",
                       "    out = ffull(margs(0))"), scope)
    return scope["margs"]


@pytest.mark.parametrize("s", [0, 1, 2])
def test_batched_step_input_sets_equal_bench_py_s(s, jax_margs, monkeypatch):
    ref = jax_margs(s)
    monkeypatch.setattr(bench, "PIPELINE_B", 4)
    got = bench.perturbed_batch(bench.batched_inputs("cpu"), s)
    assert list(got) == list(ref)
    for k, r in ref.items():
        r, g = np.asarray(r), got[k].numpy()
        assert g.shape == r.shape, k
        if k == "kino_size":
            assert (g == r).all(), k
        else:
            assert g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("s", [0, 7, 29])
def test_single_step_inputs_equal_bench_py_s(s):
    scope = dict(np=np, jnp=jnp, args=ge.entry()[1], s=s)
    exec(_source_lines(jbench._pipeline_step, "        a = list(args)",
                       "        t0 = time.perf_counter()"), scope)
    got = bench.perturbed_step_args(entry.entry(device="cpu")[1], s)
    assert len(got) == len(scope["a"]) == 10
    for g, r in zip(got, scope["a"]):
        r = np.asarray(r)
        if r.dtype.kind == "f":
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            assert (g.numpy() == r).all()


def test_every_grid_call_solves_bench_py_s_seed_set(run):
    """Warm-up 1, per-call 1000 + s, streamed 3000 + 100 rep + s; the B = 1
    solves 1 and 2000 + s at one goal and one force; the second capture as
    the first."""
    _, _, calls = run
    n, m = SMALL["N_GOALS"], SMALL["N_FORCES"]
    reps = SMALL["THROUGHPUT_REPS"]
    capture = ([(1, n, m)] + [(1000 + s, n, m) for s in range(reps)]
               + [(3000 + 100 * rep + s, n, m)
                  for rep in range(SMALL["STREAM_REPEATS"])
                  for s in range(reps)])
    expected = (capture + [(1, 1, 1)]
                + [(2000 + s, 1, 1) for s in range(SMALL["SINGLE_REPS"])]
                + capture)
    assert len(calls) == len(expected)
    for (goals, forces), (seed, n_goals, n_forces) in zip(calls, expected):
        g, f = jbench.bench_seeds(seed, n_goals=n_goals, n_forces=n_forces)
        np.testing.assert_array_equal(goals, g)
        np.testing.assert_array_equal(forces, f)


def test_closed_loop_fence_and_wind_equal_bench_py_s():
    src = inspect.getsource(jbench._closed_loop_smoke)
    scope = {"np": np}
    exec(_source_lines(jbench._closed_loop_smoke, "    ys = np.arange",
                       "    planner.set_occupied("), scope)
    call = next(n for n in ast.walk(ast.parse(textwrap.dedent(src)))
                if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "set_occupied")
    fence = eval(ast.unparse(call.args[0]), scope)
    np.testing.assert_array_equal(workloads.fence_points(), fence)
    exec(_source_lines(jbench._closed_loop_smoke, "    def wind(t):",
                       "    trace = run_closed_loop("), scope)
    for t in np.linspace(0.0, 7.0, 71):
        np.testing.assert_array_equal(workloads.wind(t), scope["wind"](t))
    assert "[3.5, 0.0], duration=7.0" in src
    assert bench.CLOSED_LOOP_GOAL == [3.5, 0.0] and bench.CLOSED_LOOP_S == 7.0


@pytest.mark.parametrize("fn, snippet, value", [
    (jbench._throughput, "reps = 8", bench.THROUGHPUT_REPS == 8),
    (jbench._throughput, "n_repeats = 5", bench.STREAM_REPEATS == 5),
    (jbench._single_solve, "reps = 50", bench.SINGLE_REPS == 50),
    (jbench._single_solve, "for s in range(40):", bench.FLOOR_REPS == 40),
    (jbench._pipeline_step, "for s in range(30):", bench.STEP_REPS == 30),
    (jbench._pipeline_batched, "def _pipeline_batched(B=4096):",
     bench.PIPELINE_B == 4096),
    (jbench._pipeline_batched, "for s in range(1, 9):",
     bench.PIPELINE_SETS == 8),
    (jbench._fleet_bench, "def _fleet_bench(B=128, duration=8.0):",
     (bench.FLEET_B, bench.FLEET_S) == (128, 8.0)),
])
def test_sizes_and_repeats_equal_bench_py_s(fn, snippet, value):
    assert snippet in inspect.getsource(fn)
    assert value
    assert (bench.N_GOALS, bench.N_FORCES) == (jbench.N_GOALS,
                                              jbench.N_FORCES)
    np.testing.assert_array_equal(bench.HALVES, jbench.HALVES)


# ---- (b) the line --------------------------------------------------------

def test_main_prints_one_json_line_last(run):
    out, line, _ = run
    last = out.strip().splitlines()[-1]
    assert json.loads(last) == line
    assert out.strip().splitlines() == [last]
    assert line["metric"] == "nmpc_solves_per_s_per_chip_N20_batch4096"
    assert inspect.getsource(jbench.main).count(f'"{line["metric"]}"') == 1
    assert line["unit"] == "solves/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 20.0, 1)


def test_extras_keys_equal_bench_py_s(run):
    """bench.py's keys, its folds read from the card's artifacts
    (PARITY_H100.json, MC_SWEEP_H100.json, both at the root); "card" is the
    nvidia-smi line, written on the card only, so it is absent on the CPU."""
    _, line, _ = run
    assert bench.EXTRAS_KEYS == _bench_py_extras_keys() | {"card"}
    assert (ROOT / "PARITY_H100.json").exists()
    assert (ROOT / "MC_SWEEP_H100.json").exists()
    assert set(line["extras"]) == bench.EXTRAS_KEYS - {"card"}


def test_folds_read_the_card_artifacts(run):
    _, line, _ = run
    x = line["extras"]
    p = json.loads((ROOT / "PARITY_H100.json").read_text())
    mc = json.loads((ROOT / "MC_SWEEP_H100.json").read_text())
    assert x["parity_max_u_diff"] == p["max_u_diff"]
    assert x["pipeline_resolve_f64_max_u_diff"] == (
        p["pipeline"]["resolve_f64_max_u_diff"])
    assert x["pipeline_audit_pass"] is p["pipeline"]["pass"] is True
    assert x["mc_sweep_100k"]["n_scenarios"] == mc["n_scenarios"] == 102_400
    assert "H100" in mc["card"]


def test_sections_report_their_checks(run):
    _, line, _ = run
    x = line["extras"]
    assert x["pipeline_batch"] == SMALL["PIPELINE_B"]
    assert x["closed_loop_no_collision"] is True
    assert x["fleet_collided_frac"] == 0.0
    assert x["fleet_solved_frac"] > 0.9
    assert sum(x["fleet_outcomes"].values()) == SMALL["FLEET_B"]
    assert x["streamed_repeats"] == SMALL["STREAM_REPEATS"]
    assert x["pipeline_batched_steps_per_s"] > 0
    assert x["single_solve_p50_ms"] > 0 and x["pipeline_step_p50_ms"] > 0


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run on it")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        bench.main()


# ---- (c) no section's failure is swallowed -------------------------------

CANNED = {
    "_throughput": dict(B=4, solves_per_s=10.0, stream_min=9.0,
                        stream_max=11.0, stream_repeats=2,
                        percall_solves_per_s=8.0, stream_solved_frac=1.0,
                        mean_ms=1.0, min_ms=1.0, p99_batch_ms=1.0,
                        solved_frac=1.0, iters_mean=14.0),
    "_single_solve": dict(p50_ms=1.0, p99_ms=1.0, solved_frac=1.0,
                          relay_floor_p50_ms=0.1, relay_floor_p99_ms=0.1,
                          compute_p50_ms=0.9),
    "_pipeline_step": dict(p50_ms=1.0, p99_ms=1.0),
    "_pipeline_batched": dict(batch=2, batched_steps_per_s=1.0,
                              streamed_steps_per_s=1.0, solved_frac=1.0),
    "_closed_loop_smoke": dict(reached=True, no_collision=True,
                               p99_solve_ms=1.0, solves=1, final=[0, 0, 0]),
    "_fleet_bench": dict(batch=2, reached_frac=1.0, collided_frac=0.0,
                         solved_frac=1.0, realtime_factor=1.0, searches=1,
                         outcomes={}, tick_codes={}, mean_time_to_goal=1.0),
    "_mfu": dict(flops_per_call=1.0, achieved_tflops=1.0, mfu_pct=1.0),
}


@pytest.mark.parametrize("failing", SECTIONS)
def test_a_section_that_raises_ends_the_run(failing, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError(f"{failing} failed")

    for name in SECTIONS:
        monkeypatch.setattr(bench, name,
                            (lambda *a, _r=CANNED[name], **k: dict(_r))
                            if name != failing else boom)
    with pytest.raises(RuntimeError, match=f"{failing} failed"):
        bench.main(device="cpu")
    assert capsys.readouterr().out == ""


def test_the_stubbed_sections_print_the_line(monkeypatch, capsys):
    """The stubs of the test above, none raising: the line is printed."""
    for name in SECTIONS:
        monkeypatch.setattr(bench, name,
                            lambda *a, _r=CANNED[name], **k: dict(_r))
    line = bench.main(device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line
    assert line["value"] == 10.0


# ---- (d) the roofline share ----------------------------------------------

def test_mfu_is_k1_s_count_over_the_f32_peak():
    tp = dict(B=4096, solves_per_s=150_000.0, iters_mean=14.5)
    got = bench._mfu(bench.workloads.bench_config(), tp)
    per_lane_iter = 396_080                   # k1_flops(20)
    achieved = 150_000.0 * 14.5 * per_lane_iter
    assert got["mfu_pct"] == pytest.approx(100 * achieved / 67e12, rel=1e-12)
    assert got["achieved_tflops"] == pytest.approx(achieved / 1e12,
                                                   rel=1e-12)
    assert got["flops_per_call"] == pytest.approx(
        per_lane_iter * 14.5 * 4096, rel=1e-12)


# ---- (e) the helpers moved out of chip_smoke.py ----------------------------

@pytest.mark.parametrize("call, expected", [
    (lambda: measure.k1_flops(20), 396_080),
    (lambda: measure.riccati_factor_flops(20), 253_916),
    (lambda: measure.riccati_factor_flops(20, 30), 264_176),
    (lambda: measure.riccati_solve_flops(20), 27_170),
    (lambda: measure.bound(1e6, 1e9), (1e9 / 67e12 * 1e3, "operations")),
    (lambda: measure.bound(1e8, 1e9), (1e8 / 3.35e12 * 1e3, "bytes")),
    (lambda: measure.bound(1e6, 1e9, torch.float64),
     (1e9 / 34e12 * 1e3, "operations")),
    (lambda: measure.tensor_bytes(
        torch.zeros(3, 4), (torch.zeros(2, dtype=torch.float64),
                            [torch.zeros(5, dtype=torch.int32)])), 84),
    (lambda: measure.card_line("cpu"), "cpu (no card)"),
])
def test_measure_helpers_give_chip_smoke_s_numbers(call, expected):
    assert call() == expected


def test_chip_smoke_uses_the_package_s_helpers():
    import chip_smoke

    for name in ("card_line", "cuda_ms", "bound", "tensor_bytes", "k1_flops",
                 "riccati_factor_flops", "riccati_solve_flops"):
        assert getattr(chip_smoke, name) is getattr(measure, name), name
    assert measure.PEAK_FLOPS[torch.float32] == 67e12
    assert measure.HBM_BYTES_PER_S == 3.35e12
