"""The one route to every kernel (ops/_build.py::route, on_stream, check),
through each public wrapper of ops/: on meta tensors every check runs and
no kernel exists, so sound inputs read "no route for tensors on meta", and
each refusal (a shape, a dtype the kernels do not take, a tensor of
another dtype or device, one that is not contiguous, the corridor mask's
own bool dtype, each wrapper's own size rules) names its tensor.  A
refused call counts no launch.  JAX-free: runs on the card too, with
--noconftest."""
import pytest
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.ops import (
    _build,
    corridor_kernel,
    ipm_kernel,
    lqr_kernel,
    reference_kernel,
    tube_kernel,
)
from forces_resilient_planner_tpu_torch.solver import nlp
from forces_resilient_planner_tpu_torch.solver.riccati import LQRFactor

N, B, M, NH = 4, 8, 16, 30
FAC = dict(zip((f"fac.{f}" for f in LQRFactor._fields),
               lqr_kernel._factor_shapes(N, B)))
W = nlp.StageWeights._fields


def _fac(t):
    return LQRFactor(*(t[f"fac.{f}"] for f in LQRFactor._fields))


# entry: (wrapper's call on a dict of tensors by the name its messages
# use, {name: shape or (shape, dtype)} in the wrapper's argument order,
# the tensor the refusal cases spoil: never the one the wrapper routes by)
ENTRIES = {
    "ipm_iteration_fused": (
        lambda t: ipm_kernel.ipm_iteration_fused(
            t["Z"], t["lam"], t["s"], t["mu_d"], t["scal"],
            nlp.StageWeights(*(t[f] for f in W)), t["ref_pos"], t["ref_yaw"],
            t["A"], t["b"], t["f_ext"], t["xinit"], t["max_iters_lane"],
            C.model, C.solver),
        {"Z": (N, 17, B), "lam": (N, 13, B), "s": (N, 64, B),
         "mu_d": (N, 64, B), "scal": (4, B), **{f: (N, B) for f in W},
         "ref_pos": (N, 3, B), "ref_yaw": (N, B), "A": (N, NH, 3, B),
         "b": (N, NH, B), "f_ext": (3, B), "xinit": (9, B),
         "max_iters_lane": (B,)},
        "lam"),
    "tube_stage_lanes": (
        lambda t: tube_kernel.tube_stage_lanes(t["x"], t["u"], C.model,
                                               C.tube),
        {"x": (B, 9), "u": (B, 4)},
        "u"),
    "tube_chain_lanes": (
        lambda t: tube_kernel.tube_chain_lanes(t["Qd"], t["Mp"], t["Q1"],
                                               C.tube),
        {"Qd": (B, N, 9, 9), "Mp": (B, N, 9, 9), "Q1": (B, N, 3, 3)},
        "Mp"),
    "decompose_stages_lanes": (
        lambda t: corridor_kernel.decompose_stages_lanes(
            t["p1"], t["p2"], t["obs"], t["obs_mask"], C.corridor, NH),
        {"p1": (B, N, 3), "p2": (B, N, 3), "obs": (B, M, 3),
         "obs_mask": ((B, M), torch.bool)},
        "p2"),
    "lqr_factor_fused_lanes": (
        lambda t: lqr_kernel.lqr_factor_fused_lanes(
            *(t[f] for f in W), t["sigma"], t["Acor"], t["Ax"], t["Bx"],
            1e-8, 4.0),
        {**{f: (N, B) for f in W}, "sigma": (N, 34 + NH, B),
         "Acor": (N, NH, 3, B), "Ax": (N - 1, 9, 9, B),
         "Bx": (N - 1, 9, 4, B)},
        "Bx"),
    "lqr_backsolve_fused_lanes": (
        lambda t: lqr_kernel.lqr_backsolve_fused_lanes(
            _fac(t), t["dynamics[0]"], t["dynamics[1]"], t["c"], t["qx"],
            t["qu"], t["dx0"]),
        {**FAC, "dynamics[0]": (N - 1, 9, 9, B),
         "dynamics[1]": (N - 1, 9, 4, B), "c": (N - 1, 13, B),
         "qx": (N, 13, B), "qu": (N, 4, B), "dx0": (9, B)},
        "qu"),
    "lqr_factor_lanes": (
        lambda t: lqr_kernel.lqr_factor_lanes(t["Q"], t["R"], t["S"],
                                              t["A"], t["B"]),
        {"Q": (N, 13, 13, B), "R": (N, 4, 4, B), "S": (N, 4, 13, B),
         "A": (N - 1, 13, 13, B), "B": (N - 1, 13, 4, B)},
        "R"),
    "lqr_backsolve_lanes": (
        lambda t: lqr_kernel.lqr_backsolve_lanes(
            _fac(t), t["dynamics[0]"], t["dynamics[1]"], t["c"], t["qx"],
            t["qu"], t["dx0"]),
        {**FAC, "dynamics[0]": (N - 1, 13, 13, B),
         "dynamics[1]": (N - 1, 13, 4, B), "c": (N - 1, 13, B),
         "qx": (N, 13, B), "qu": (N, 4, B), "dx0": (9, B)},
        "c"),
    "sample_references_lanes": (
        lambda t: reference_kernel.sample_references_lanes(
            t["kino_path"], t["kino_size"], t["t_offset"], t["last_yaw"],
            t["pred_pos1"], N, C.model.dt),
        {"kino_path": (B, M, 3), "kino_size": ((B,), torch.int64),
         "t_offset": (B,), "last_yaw": (B,), "pred_pos1": (B, 3)},
        "pred_pos1"),
}


def _launches():
    return (ipm_kernel.LAUNCHES, tube_kernel.LAUNCHES,
            tube_kernel.CHAIN_LAUNCHES, dict(corridor_kernel.LAUNCHES),
            dict(lqr_kernel.LAUNCHES), reference_kernel.LAUNCHES)


def _tensors(entry, dtype=torch.float32, **spoil):
    """The entry's sound meta tensors at `dtype`, but for the named ones
    given in `spoil` as they are."""
    out = {}
    for name, spec in ENTRIES[entry][1].items():
        shape, own = spec if isinstance(spec[-1], torch.dtype) else (spec, None)
        out[name] = torch.empty(shape, dtype=own or dtype, device="meta")
    out.update(spoil)
    return out


def _refused(entry, t, match):
    before = _launches()
    with pytest.raises(ValueError, match=match):
        ENTRIES[entry][0](t)
    assert _launches() == before


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_sound_meta_inputs_pass_every_check_and_have_no_route(entry):
    _refused(entry, _tensors(entry), "no route for tensors on meta")
    _refused(entry, _tensors(entry, torch.float64),
             "no route for tensors on meta")


@pytest.mark.parametrize("case", ["shape", "dtype", "other_dtype",
                                  "other_device", "contiguous"])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_each_refusal_names_its_tensor(entry, case):
    victim = ENTRIES[entry][2]
    shape = tuple(ENTRIES[entry][1][victim])
    if case == "shape":
        bad = torch.empty(shape[:-1] + (shape[-1] + 1,), device="meta")
        match = f"^{victim}: shape "
    elif case == "dtype":
        t = _tensors(entry, torch.float16)
        _refused(entry, t, "float32 or float64, not torch.float16")
        return
    elif case == "other_dtype":
        bad = torch.empty(shape, dtype=torch.float64, device="meta")
        match = (f"^{victim}: torch.float64 on meta, expected torch.float32 "
                 "on meta")
    elif case == "other_device":
        bad = torch.empty(shape)
        match = f"^{victim}: torch.float32 on cpu, expected torch.float32 on meta"
    else:
        bad = torch.empty(shape[::-1], device="meta").permute(
            *range(len(shape) - 1, -1, -1))
        assert bad.shape == shape and not bad.is_contiguous()
        match = f"^{victim}: the kernels take contiguous tensors only"
    _refused(entry, _tensors(entry, **{victim: bad}),
             match.replace("[", r"\[").replace("]", r"\]"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_the_corridor_mask_is_bool_at_either_float_dtype(dtype):
    mask = torch.empty((B, M), dtype=dtype, device="meta")
    _refused("decompose_stages_lanes",
             _tensors("decompose_stages_lanes", torch.float64, obs_mask=mask),
             f"^obs_mask: {dtype} on meta, expected torch.bool on meta")


@pytest.mark.parametrize("entry,spoil,match", [
    ("tube_stage_lanes", {"x": (0, 9), "u": (0, 4)}, "L >= 1"),
    ("tube_chain_lanes", {"Qd": (0, N, 9, 9), "Mp": (0, N, 9, 9),
                          "Q1": (0, N, 3, 3)}, "B >= 1 robots"),
    ("decompose_stages_lanes", {"obs": (B, 0, 3)}, "B, N, M >= 1"),
    ("ipm_iteration_fused", {"Z": (1, 17, B)}, "N >= 2"),
    ("sample_references_lanes", {"kino_path": (B, 0, 3)}, "B, K, N >= 1"),
])
def test_each_wrappers_own_size_rules(entry, spoil, match):
    t = _tensors(entry, **{k: torch.empty(s, device="meta")
                           for k, s in spoil.items()})
    _refused(entry, t, match)


def test_the_corridor_wrapper_needs_room_for_the_walls():
    t = _tensors("decompose_stages_lanes")
    before = _launches()
    with pytest.raises(ValueError, match="max_obs_planes"):
        corridor_kernel.decompose_stages_lanes(
            t["p1"], t["p2"], t["obs"], t["obs_mask"], C.corridor,
            C.corridor.max_obs_planes + 5)
    assert _launches() == before


def test_check_turns_a_cuda_error_into_runtime_error():
    _build.check(0, "tube_stage")
    with pytest.raises(RuntimeError,
                       match="^tube_stage kernel launch failed: CUDA error 2$"):
        _build.check(2, "tube_stage")
    with pytest.raises(RuntimeError, match="CUDA error 700 .*'M': 70000"):
        _build.check(700, "corridor", route="corridor_gathered", M=70000)
