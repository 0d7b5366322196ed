"""Stage 1's kernel, ops/csrc/reference.cu, against its plain version
engine/reference.py::sample_references_plain, bit for bit, at float32 and
float64.

On the CPU the source is built with g++ against tests/cuda_emu and held
to the plain version on the step cells' distribution (a straight path of
64 samples, t_offset in [0, 0.3] s), offsets on the Ts grid (the fleet's
ticks), short and empty paths, yaw targets more than pi away, lookaheads
within 0.1 m (where the yaw holds) and random walks; a robot's result does
not depend on its slot or on B.  The source's CPU build calls glibc's
sqrt and atan2, and this CPU build of torch misrounds some inputs of both
by an ulp, so there the plain version runs with those two taken from
libm; on the card each side calls the CUDA math library's.  On a card
(`cuda`): the kernel equals the plain version on the card at B = 4096
and B = 1, and each call of `sample_references` counts one launch, a
batched step too.  JAX-free: the card runs it with --noconftest."""
import ctypes
import ctypes.util
import math

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import _cuda_emu
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.engine import reference
from forces_resilient_planner_tpu_torch.ops import reference_kernel
from forces_resilient_planner_tpu_torch.utils import rounding

N, TS, K = C.model.N, C.model.dt, 64
LOOKAHEAD = 5
X0 = (0.0, 0.0, 1.2)
DTYPES = {"f32": torch.float32, "f64": torch.float64}

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.atan2f.argtypes, _LIBM.atan2f.restype = [ctypes.c_float] * 2, ctypes.c_float


class _LibmMath(TorchFunctionMode):
    """torch.sqrt and torch.atan2 of CPU tensors as the source's CPU build
    computes them: the correctly rounded root and glibc's atan2f / atan2."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.sqrt:
            return rounding.sqrt(*args)
        if func is torch.atan2:
            y, x = args
            fn = _LIBM.atan2f if y.dtype == torch.float32 else math.atan2
            out = np.frompyfunc(fn, 2, 1)(y.numpy(), x.numpy())
            return torch.from_numpy(np.asarray(out, dtype=y.numpy().dtype))
        return func(*args, **kwargs)


# ---- inputs: (kino_path (B, K, 3), kino_size (B,), t_offset, last_yaw (B,),
# pred_pos1 (B, 3)), drawn at float64 from a seed ----------------------------

def _line(B, velocity, gen):
    """B robots on the step cells' straight path from X0 (K samples at
    `velocity`), t_offset in [0, 0.3] s, a plan's yaw and stage-1
    position plus N(0, 1e-4)."""
    t = torch.arange(K, dtype=torch.float64) * TS
    v = torch.as_tensor(velocity, dtype=torch.float64)
    path = (v * t[:, None] + torch.tensor(X0, dtype=torch.float64))
    path = path[None].expand(B, K, 3).contiguous()
    return (path, torch.full((B,), K, dtype=torch.int64),
            0.3 * torch.rand(B, generator=gen, dtype=torch.float64),
            1e-4 * torch.randn(B, generator=gen, dtype=torch.float64),
            path[:, 1] + 1e-4 * torch.randn(B, 3, generator=gen,
                                            dtype=torch.float64))


def _walk(B, gen, step=0.1):
    """Random walks of K samples from X0, steps N(0, step) a coordinate."""
    d = step * torch.randn(B, K, 3, generator=gen, dtype=torch.float64)
    return torch.tensor(X0, dtype=torch.float64) + torch.cumsum(d, dim=1)


def case_robots(gen):
    return _line(64, (1.2, 0.3, 0.0), gen)


def case_grid_offsets(gen):
    """t_offset = k Ts (k = 0..25), the fleet's ticks after a replan."""
    path, size, _, yaw, pred = _line(26, (1.2, 0.3, 0.0), gen)
    return path, size, torch.arange(26, dtype=torch.float64) * TS, yaw, pred


def case_short_paths(gen):
    """kino_size 0, 1, 2, 5, N - 1, N, N + 4 < N + lookahead, K - 1, K and
    past K, offsets up to 1.2 s (past the end of the shorter paths)."""
    sizes = torch.tensor([0, 1, 2, 5, N - 1, N, N + 4, K - 1, K, K + 3])
    B = len(sizes)
    return (_walk(B, gen), sizes,
            1.2 * torch.rand(B, generator=gen, dtype=torch.float64),
            math.pi * (2 * torch.rand(B, generator=gen,
                                      dtype=torch.float64) - 1),
            torch.randn(B, 3, generator=gen, dtype=torch.float64))


def case_yaw_wrap(gen):
    """Headings near +-pi against a yaw on the other side, and targets
    more than pi from the yaw elsewhere (the 2 pi wrap both ways)."""
    heading = torch.tensor([3.05, -3.05, 3.1, -3.1, 2.0, -2.0, 0.5, -0.5])
    yaw = torch.tensor([-3.05, 3.05, -2.9, 2.9, -2.0, 2.0, -3.0, 3.0],
                       dtype=torch.float64)
    paths = [_line(1, (math.cos(h), math.sin(h), 0.05), gen)[0]
             for h in heading.tolist()]
    B = len(paths)
    _, size, toff, _, pred = _line(B, (1.0, 0.0, 0.0), gen)
    return torch.cat(paths), size, toff, yaw, pred


def case_yaw_holds(gen):
    """Lookaheads within 0.1 m of the reference (5 samples at 0.05-0.39
    m/s; 0.4 m/s puts them at 0.1 m), where the yaw holds its last value."""
    speeds = [0.05, 0.2, 0.39, 0.4, 0.41, 0.0]
    paths = []
    for s in speeds:
        p, _, _, _, _ = _line(1, (s * 0.6, s * 0.8, 0.0), gen)
        paths.append(p)
    B = len(paths)
    _, size, toff, _, pred = _line(B, (1.0, 0.0, 0.0), gen)
    yaw = math.pi * (2 * torch.rand(B, generator=gen, dtype=torch.float64) - 1)
    return torch.cat(paths), size, toff, yaw, pred


def case_walks(gen):
    """Random walks (every heading), random sizes and offsets, yaws."""
    B = 64
    return (_walk(B, gen, 0.2), torch.randint(0, K + 1, (B,), generator=gen),
            1.5 * torch.rand(B, generator=gen, dtype=torch.float64),
            math.pi * (2 * torch.rand(B, generator=gen,
                                      dtype=torch.float64) - 1),
            torch.randn(B, 3, generator=gen, dtype=torch.float64))


CASES = {"robots": case_robots, "grid_offsets": case_grid_offsets,
         "short_paths": case_short_paths, "yaw_wrap": case_yaw_wrap,
         "yaw_holds": case_yaw_holds, "walks": case_walks}


def _inputs(case, dtype, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    path, size, toff, yaw, pred = CASES[case](gen)
    return tuple(t.to(device=device, dtype=dtype) if t.is_floating_point()
                 else t.to(device) for t in (path, size, toff, yaw, pred))


def _mixed(dtype, seed=0, device="cpu"):
    """Every case's robots in one batch."""
    parts = [_inputs(c, dtype, seed, device) for c in CASES]
    return tuple(torch.cat(ts) for ts in zip(*parts))


def _plain_cpu(args):
    with _LibmMath():
        return reference.sample_references_plain(*args, N, TS, LOOKAHEAD)


def _equal(got, want):
    for name, g, w in zip(reference.ReferenceResult._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, (g - w).abs().max())


# ---- the CPU routes ----------------------------------------------------------

def test_libm_math_is_what_the_plain_version_calls():
    """The interception takes every sqrt and atan2 of the plain version
    (norm3's and the target's) and nothing else changes: the plain version
    under it and without it agree but where torch's own rounds differently,
    within 1e-6 at float32."""
    args = _mixed(torch.float32)
    calls = []

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, a=(), kw=None):
            if func in (torch.sqrt, torch.atan2):
                calls.append(func)
            return func(*a, **(kw or {}))

    with Count():
        plain = reference.sample_references_plain(*args, N, TS, LOOKAHEAD)
    assert calls.count(torch.sqrt) == N + 1 and calls.count(torch.atan2) == N
    for g, w in zip(_plain_cpu(args), plain):
        assert (g - w).abs().max() <= 1e-6


def test_cpu_tensors_take_the_plain_version():
    """On the CPU `sample_references` is the plain version (the views of a
    plan made contiguous change no value) and launches nothing."""
    path, size, toff, _, _ = _inputs("robots", torch.float64)
    gen = torch.Generator().manual_seed(4)
    plan = torch.randn(path.shape[0], N + 1, 17, generator=gen,
                       dtype=torch.float64)
    launches = reference_kernel.LAUNCHES
    got = reference.sample_references(path, size, toff, plan[:, 1, 16],
                                      plan[:, 1, 8:11], N, TS)
    want = reference.sample_references_plain(path, size, toff,
                                             plan[:, 1, 16], plan[:, 1, 8:11],
                                             N, TS)
    _equal(got, want)
    assert reference_kernel.LAUNCHES == launches


# ---- the source on the CPU (g++ and tests/cuda_emu) --------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/reference.cu built with g++ against the host stand-in of the
    CUDA runtime."""
    return _cuda_emu.build(reference_kernel.SOURCE,
                           tmp_path_factory.mktemp("emu_reference"),
                           reference_kernel._bind)


def _emulated(lib, args):
    return reference.ReferenceResult(*reference_kernel.launch(
        lib, *args, N, TS, LOOKAHEAD, None))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_source_equals_plain_bit_for_bit(emulated, case, dtype):
    args = _inputs(case, DTYPES[dtype])
    want = _plain_cpu(args)
    assert torch.isfinite(want.ref_yaw).all()
    _equal(_emulated(emulated, args), want)


def test_the_cases_reach_every_branch():
    """The cases hold each branch on both sides: an index past the path
    (the hold), a lookahead past it, a lookahead within 0.1 m of the
    reference (the yaw held) and beyond, and the 2 pi wrap both ways."""
    args = _mixed(torch.float64)
    path, size, toff, yaw, _ = args
    ref = _plain_cpu(args)
    n = torch.arange(N, dtype=torch.float64)
    idx = torch.floor((n[None] * TS + toff[:, None]) / TS).to(torch.int64)
    inside = idx + 1 < size[:, None]
    ahead = idx + LOOKAHEAD < size[:, None]
    assert inside.any() and (~inside).any() and ahead.any() and (~ahead).any()
    last = torch.clamp(size - 1, min=0)[:, None]
    fwd_idx = torch.clamp(torch.where(ahead, idx + LOOKAHEAD, last), 0, K - 1)
    rows = torch.arange(path.shape[0])[:, None]
    d = path[rows, fwd_idx] - ref.ref_pos
    far = d.norm(dim=-1) > 0.1
    assert far.any() and (~far).any()
    prev = torch.cat([yaw[:, None], ref.ref_yaw[:, :-1]], dim=1)
    target = torch.where(far, torch.atan2(d[..., 1], d[..., 0]), prev)
    wrap = (target - prev).abs() > math.pi
    assert (wrap & (target > 0)).any() and (wrap & (target <= 0)).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_source_results_do_not_depend_on_slot_or_batch(emulated, dtype):
    """Every case's robots in one batch, the batch reversed, and each robot
    alone give each robot the same numbers."""
    args = _mixed(DTYPES[dtype], seed=2)
    B = args[0].shape[0]
    full = _emulated(emulated, args)
    _equal(full, _plain_cpu(args))
    rev = torch.arange(B - 1, -1, -1)
    _equal(_emulated(emulated, tuple(a[rev].contiguous() for a in args)),
           tuple(f[rev] for f in full))
    for b in range(0, B, 17):
        one = _emulated(emulated, tuple(a[b:b + 1].contiguous() for a in args))
        _equal(one, tuple(f[b:b + 1] for f in full))


def test_source_refuses_an_empty_launch(emulated):
    """B, K or N below 1 returns CUDA's invalid-value code, which `check`
    raises as a failed launch; nothing is written."""
    args = _inputs("robots", torch.float32)
    with pytest.raises(RuntimeError, match="reference kernel launch failed"):
        reference_kernel.launch(emulated, *args, 0, TS, LOOKAHEAD, None)


# ---- on the card ---------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _fleet(B, dtype, seed):
    """B robots: the step cells' distribution with every case's robots in
    front of it."""
    mixed = _mixed(dtype, seed)
    gen = torch.Generator().manual_seed(seed)
    line = tuple(t.to(dtype) if t.is_floating_point() else t
                 for t in _line(B - mixed[0].shape[0], (1.2, 0.3, 0.0), gen))
    return tuple(torch.cat(ts).cuda() for ts in zip(mixed, line))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_equals_plain_on_cuda_at_4096(dtype):
    _need_cuda()
    args = _fleet(4096, DTYPES[dtype], seed=11)
    launches = reference_kernel.LAUNCHES
    got = reference.sample_references(*args, N, TS)
    assert reference_kernel.LAUNCHES == launches + 1
    want = reference.sample_references_plain(*args, N, TS)
    torch.cuda.synchronize()
    _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_equals_plain_on_cuda_one_robot_a_call(dtype):
    _need_cuda()
    args = _mixed(DTYPES[dtype], seed=12, device="cuda")
    B = args[0].shape[0]
    for b in range(B):
        one = tuple(a[b:b + 1] for a in args)
        launches = reference_kernel.LAUNCHES
        got = reference.sample_references(*one, N, TS)
        assert reference_kernel.LAUNCHES == launches + 1
        _equal(got, reference.sample_references_plain(*one, N, TS))


@pytest.mark.cuda
def test_a_batched_step_launches_the_kernel_once():
    """nmpc_step_batched on the card: one launch a step, and its references
    are the plain version's."""
    _need_cuda()
    from forces_resilient_planner_tpu_torch.engine.pipeline_batch import (
        nmpc_step_batched,
    )
    from forces_resilient_planner_tpu_torch.solver.problems import (
        hover_warm_start,
    )

    B, M = 4, 64
    path, size, toff, _, _ = _inputs("robots", torch.float32, seed=3)
    gen = torch.Generator().manual_seed(3)
    x0 = torch.tensor([*X0, 0, 0, 0, 0, 0, 0])
    Z = hover_warm_start(x0, C.model)
    plan = torch.cat([Z, Z[-1:]])[None].expand(B, N + 1, 17).float()
    plan = plan + 1e-4 * torch.randn(B, N + 1, 17, generator=gen)
    args = dict(
        mpc_output=plan, kino_path=path[:B], kino_size=size[:B],
        t_offset=toff[:B], state_mpc=x0[None].expand(B, 9).float(),
        f_ext=torch.zeros(B, 3), end_pt=path[:B, -1],
        obstacles=torch.rand(B, M, 3, generator=gen) * 5 + 3,
        obstacle_mask=torch.ones(B, M, dtype=torch.bool),
        use_final=torch.zeros(B, dtype=torch.bool))
    args = {k: v.cuda() for k, v in args.items()}
    launches = reference_kernel.LAUNCHES
    for step in range(1, 3):
        r = nmpc_step_batched(**args, cfg=C)
        assert reference_kernel.LAUNCHES == launches + step
    want = reference.sample_references_plain(
        args["kino_path"], args["kino_size"], args["t_offset"],
        args["mpc_output"][:, 1, 16], args["mpc_output"][:, 1, 8:11], N, TS)
    _equal(r.ref, want)
