"""The FORCES API's card route (solver/forces_api.py::_solve_graphed)
against its eager route, bit for bit.

On the CPU: the staged buffer's views equal unpack_params' tensors, the
packed info struct of a staged solve equals the eager route's outputs,
exit flag and info fields, the info struct copies no constant from the
host (a capture could not), and a CPU solve takes the eager route (no
graph replay).  On a card (`cuda`): the graph route equals the eager route
on the migration and hover problems, f32 and f64, both profiles and
predictor-corrector, with one replay a solve, and A, B, A on one instance
gives A's answers twice.
JAX-free, so the card can run it."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.solver import forces_api as fa
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu_torch.solver.problems import (
    box_corridor,
    hover_warm_start,
)
from _torch_threads import one_torch_thread  # noqa: F401

X0 = np.array([0, 0, 1.2, 0, 0, 0, 0, 0, 0], float)
DTYPES = {"f32": torch.float32, "f64": torch.float64}
INFO_FIELDS = ("it", "fevalstime", "res_eq", "res_ineq", "rdgap", "pobj")


def hover_params(goal=(1.5, 0.8, 1.2), f_ext=(0.4, -0.2, 0.0)):
    """Hover at X0 to `goal` under `f_ext` in a 5 x 5 x 2 m box, the
    profile's stage weights packed as the reference's wrapper packs them."""
    goal = np.asarray(goal, float)
    w = C.weights
    params = fa.ForcesParams()
    params.xinit[:] = X0
    fa.set_stage_weights(params, w.w_stage_wp, w.w_stage_input,
                         w.w_input_rate, w.w_terminal_wp, w.w_terminal_input)
    A, b = box_corridor(0.5 * (X0[:3] + goal), np.array([5.0, 5.0, 2.0]),
                        fa.N, device="cpu")
    fa.pack_stage_params(
        params, np.tile(goal[None], (fa.N, 1)),
        np.full(fa.N, np.arctan2(goal[1] - X0[1], goal[0] - X0[0])),
        np.asarray(f_ext, float), A.numpy(), b.numpy())
    fa.pack_warm_start(params, hover_warm_start(
        torch.as_tensor(X0, dtype=torch.float64), C.model).numpy())
    return params


def bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def assert_same_answer(got, want):
    """Outputs, exit flag and every info field but solvetime, bit for bit."""
    (out_g, flag_g, info_g), (out_w, flag_w, info_w) = got, want
    assert sorted(out_g) == sorted(out_w)
    for k in out_w:
        assert out_g[k].dtype == out_w[k].dtype == np.float64
        assert bits(out_g[k]) == bits(out_w[k]), k
    assert flag_g == flag_w
    for f in INFO_FIELDS:
        g, w = getattr(info_g, f), getattr(info_w, f)
        assert type(g) is type(w), f
        assert bits(np.float64(g)) == bits(np.float64(w)), (f, g, w)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["normal", "final"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_staged_views_equal_unpack_params(dtype, profile):
    dt, final = DTYPES[dtype], profile == "final"
    params = hover_params()
    params.all_parameters[7::fa.NPAR_STAGE] = 1.0 / 3.0   # not exact in f32
    Z0, p = fa.unpack_params(params, C, final, dt, device="cpu")
    staged = fa._Staged(dt, torch.device("cpu"))
    staged.load(fa._param_arrays(params, C, final))
    got = [staged.Z0, *staged.p[:-1], *staged.p.weights]
    want = [Z0, *p[:-1], *p.weights]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dt and g.shape == w.shape
        assert g.is_contiguous()
        assert bits(g.numpy()) == bits(w.numpy())
    # every field starts where a fresh allocation would
    for g in got:
        assert g.data_ptr() % fa._FIELD_ALIGN == \
            staged.dev.data_ptr() % fa._FIELD_ALIGN


@pytest.fixture(scope="module")
def eager_answers():
    """The eager route's answers on the CPU, by (dtype, profile)."""
    params = hover_params()
    cases = {("f32", "normal"), ("f64", "final")}
    return params, {
        c: fa.ForcesSolver(c[1], C, DTYPES[c[0]], device="cpu").solve(params)
        for c in sorted(cases)}


@pytest.mark.parametrize("case", [("f32", "normal"), ("f64", "final")])
def test_packed_info_of_a_staged_solve_equals_eager(eager_answers, case):
    params, answers = eager_answers
    dt, final = DTYPES[case[0]], case[1] == "final"
    staged = fa._Staged(dt, torch.device("cpu"))
    staged.load(fa._param_arrays(params, C, final))
    res = ipm_lanes.solve_batch_lanes_tiered(
        staged.Z0[None], ipm_lanes._map_params(lambda a: a[None], staged.p),
        C.model, C.solver)
    lb, ub = nlp.variable_bounds(C.model, dt, device="cpu")
    h = fa.packed_info(res.Z[0], res.iters, res.exit_code, res.kkt_error,
                       staged.p, lb, ub, C.model, C.solver)
    assert h.dtype == dt and h.shape == (fa.X0_TOTAL + len(fa._PACKED),)
    assert_same_answer(fa._unpacked(h.numpy(), 0.0), answers[case])
    assert answers[case][1] == 1


def test_cpu_solve_takes_the_eager_route(eager_answers):
    params, answers = eager_answers
    before = fa.GRAPH_REPLAYS
    solver = fa.ForcesSolver("normal", C, torch.float32, device="cpu")
    got = solver.solve(params)
    assert fa.GRAPH_REPLAYS == before
    assert solver._staged is None and solver._info is None
    assert_same_answer(got, answers[("f32", "normal")])


class _Recorder(TorchFunctionMode):
    """Records every torch function called while active."""

    def __init__(self):
        super().__init__()
        self.called = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.called.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_packed_info_copies_no_host_constant(eager_answers, dtype):
    """What the capture needs: the info struct makes no tensor from host
    values (torch.tensor copies pageable host memory, which a CUDA graph
    capture refuses), here on CPU tensors."""
    params, _ = eager_answers
    dt = DTYPES[dtype]
    staged = fa._Staged(dt, torch.device("cpu"))
    staged.load(fa._param_arrays(params, C, False))
    Z = staged.Z0.clone()
    lb, ub = nlp.variable_bounds(C.model, dt, device="cpu")
    one = torch.ones(1, dtype=torch.int32)
    rec = _Recorder()
    with rec:
        h = fa.packed_info(Z, one, one, torch.zeros(1, dtype=dt), staged.p,
                           lb, ub, C.model, C.solver)
    assert h.shape == (fa.X0_TOTAL + len(fa._PACKED),)
    assert len(rec.called) > 50          # the mode saw the dynamics' ops
    assert torch.tensor not in rec.called
    assert torch.as_tensor not in rec.called


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")


@pytest.fixture(scope="module")
def card_problems():
    _need_cuda()
    from forces_resilient_planner_tpu_torch.examples.forces_api_migration \
        import migration_params

    return {"migration": migration_params(device="cuda"),
            "hover": hover_params()}


def _pc(cfg):
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, predictor_corrector=True))


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["normal", "final"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("problem", ["migration", "hover"])
def test_graph_route_equals_eager_on_cuda(card_problems, problem, dtype,
                                          profile):
    params = card_problems[problem]
    for cfg in (C, _pc(C)) if profile == "normal" else (C,):
        solver = fa.ForcesSolver(profile, cfg, DTYPES[dtype], device="cuda")
        before = fa.GRAPH_REPLAYS
        got = solver.solve(params)
        assert fa.GRAPH_REPLAYS == before + 1
        assert_same_answer(got, solver._solve_eager(params))
        assert fa.GRAPH_REPLAYS == before + 1


@pytest.mark.cuda
def test_graph_replays_count_card_solves_and_reuse(card_problems):
    a, b = card_problems["migration"], card_problems["hover"]
    solver = fa.ForcesSolver("normal", C, torch.float32, device="cuda")
    before = fa.GRAPH_REPLAYS
    first = solver.solve(a)
    graph = solver._info.graph
    got_b = solver.solve(b)
    again = solver.solve(a)
    assert fa.GRAPH_REPLAYS == before + 3
    assert solver._info.graph is graph          # one capture an instance
    assert_same_answer(again, first)
    assert_same_answer(got_b, solver._solve_eager(b))
    assert_same_answer(first, solver._solve_eager(a))
