"""The CUDA source of the Riccati kernels, ops/csrc/lqr.cu, on the CPU:
compiled with g++ against tests/cuda_emu (a host stand-in of the CUDA
runtime that runs each thread of a block as a std::thread) and held against
the plain PyTorch versions of ops/lqr_kernel.py, which tests/test_torch_lqr.py
holds against the JAX package.

  K4a / K4b and K5a / K5b (a warp per lane, up to 8 lanes a CTA): bit for
  bit equal to their plain versions at f64 and f32 (K4 at 30 and at 18
  corridor rows), on 13 lanes (a ragged second CTA); a lane with an inf in
  Ax (K5: A) NaN exactly where the plain version is; a lane's bits
  independent of its slot, of B and of the lanes per CTA;
  the shared-memory layouts of the .cu equal ops/lqr_kernel.lane_elements,
  and launch_geometry fits a CTA.

Inputs are drawn from a seed at N = 6, a shape the plain versions and the
kernels treat like N = 20.  The plain versions run with a
correctly rounded torch.sqrt (numpy's), as the kernels' and the card's
square roots are: this CPU build's torch.sqrt misrounds about 0.7% of
float64 inputs by one ulp."""
import numpy as np
import pytest
import torch

import _cuda_emu
from chip_smoke import random_lqr
from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu_torch.ops import lqr_kernel
from forces_resilient_planner_tpu_torch.solver.riccati import LQRFactor

F64 = torch.float64
REG, RMAX2 = C.solver.reg, C.model.max_rate ** 2
N, B = 6, 13


@pytest.fixture(autouse=True)
def exact_sqrt(monkeypatch):
    """torch.sqrt correctly rounded on CPU tensors, for the plain versions'
    Cholesky factors."""
    def sqrt(x):
        return torch.from_numpy(np.sqrt(x.numpy()))
    monkeypatch.setattr(torch, "sqrt", sqrt)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/lqr.cu built with g++ against the host stand-in of the CUDA
    runtime."""
    return _cuda_emu.build(lqr_kernel.SOURCE, tmp_path_factory.mktemp("emu"),
                           lqr_kernel._bind)


def _fused_inputs(nh=30, seed=0, dtype=F64):
    """K4's inputs (the nine of lqr_factor_fused_lanes) and one right-hand
    side (c, qx, qu, dx0): barrier sigmas over six decades, corridor rows,
    RK2-like Jacobians near I and 0."""
    rng = np.random.default_rng(seed)
    w = [rng.uniform(0.5, 2.0, (N, B)) for _ in range(5)]
    sigma = 10.0 ** rng.uniform(-3, 3, (N, 34 + nh, B))
    Acor = rng.normal(0, 1, (N, nh, 3, B))
    Ax = np.eye(9)[None, :, :, None] + 0.1 * rng.normal(size=(N - 1, 9, 9, B))
    Bx = 0.1 * rng.normal(size=(N - 1, 9, 4, B))
    rhs = (0.01 * rng.normal(size=(N - 1, 13, B)), rng.normal(size=(N, 13, B)),
           rng.normal(size=(N, 4, B)), 0.01 * rng.normal(size=(9, B)))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

    return [t(a) for a in (*w, sigma, Acor, Ax, Bx)], [t(a) for a in rhs]


def _emulated(lib, ins, rhs, max_lanes=lqr_kernel.MAX_LANES):
    """K4a, then K4b against its factor, from the CPU build."""
    Nn, Bn = ins[0].shape
    fac = LQRFactor(*(ins[5].new_empty(s)
                      for s in lqr_kernel._factor_shapes(Nn, Bn)))
    lqr_kernel.launch(lib, "lqr_factor_fused", ins, fac, None,
                      (ins[6].shape[1], REG, RMAX2), max_lanes)
    c, qx, qu, dx0 = rhs
    sol = lqr_kernel._solution_like(qx)
    lqr_kernel.launch(lib, "lqr_backsolve_fused",
                      [*fac, ins[7], ins[8], c, qx, qu, dx0], sol, None, (),
                      max_lanes)
    return fac, sol


def _plain(ins, rhs):
    fac = lqr_kernel.lqr_factor_fused_reference(*ins, REG, RMAX2)
    return fac, lqr_kernel.lqr_backsolve_fused_reference(fac, ins[7], ins[8],
                                                         *rhs)


def _same_bits(got, want):
    """Equal values and equal NaN positions, field by field."""
    for g, r in zip(got, want):
        assert torch.equal(g.isnan(), r.isnan())
        assert torch.equal(g.nan_to_num(), r.nan_to_num())


def test_emulated_layouts_equal_lane_elements(lib):
    for n in (2, 6, 20, 40):
        for backsolve in (False, True):
            for blocks in (False, True):
                assert (lib.lqr_lane_elements(n, int(backsolve), int(blocks))
                        == lqr_kernel.lane_elements(n, backsolve, blocks))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("backsolve", [False, True])
def test_launch_geometry_fits_a_cta(dtype, backsolve):
    """K4's and K5's: eight lanes a CTA at N = 20, the stride 4 values past
    a multiple of 32 (bank-spread copies), and four f32 CTAs (32 lanes) an
    SM."""
    size = torch.empty((), dtype=dtype).element_size()
    for blocks in (False, True):
        geo = lqr_kernel.launch_geometry(dtype, 20, backsolve, blocks=blocks)
        assert geo.lanes == 8 and geo.threads == 256
        assert geo.stride >= lqr_kernel.lane_elements(20, backsolve, blocks)
        assert geo.stride % 32 == 4
        assert geo.smem == geo.lanes * geo.stride * size <= 232_448
        if dtype == torch.float32:
            assert 4 * (geo.smem + 1024) <= 228 * 1024
        small = lqr_kernel.launch_geometry(dtype, 20, backsolve, max_lanes=2,
                                           blocks=blocks)
        assert small.lanes == 2 and small.stride % 32 == 16
        with pytest.raises(ValueError):
            lqr_kernel.launch_geometry(dtype, 1, backsolve, blocks=blocks)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("nh", [30, 18])
def test_kernel_source_matches_plain_bit_for_bit(lib, nh, dtype):
    ins, rhs = _fused_inputs(nh, seed=nh, dtype=dtype)
    got = _emulated(lib, ins, rhs)
    want = _plain(ins, rhs)
    for g, r in zip(got, want):
        for a, b in zip(g, r):
            assert torch.isfinite(b).all()
        _same_bits(g, r)


def test_kernel_source_nan_lane_matches_plain(lib):
    """An inf in one lane's Ax: 0 * inf = NaN through the zero blocks, the
    same outputs NaN (and the other lanes untouched) as in the plain
    version."""
    ins, rhs = _fused_inputs(seed=3)
    ins[7][2, 4, 1, 5] = float("inf")
    got = _emulated(lib, ins, rhs)
    want = _plain(ins, rhs)
    assert want[0].P[:, :, :, 5].isnan().any()
    assert want[1].dxb[:, :, 5].isnan().any()
    assert not want[0].P[..., [4, 6]].isnan().any()
    for g, r in zip(got, want):
        _same_bits(g, r)


def test_kernel_source_lane_results_do_not_depend_on_their_slot(lib):
    """A permutation of the lanes permutes the outputs bit for bit; 5 lanes
    launched alone, and every lane with 2 lanes a CTA, equal the full
    launch."""
    ins, rhs = _fused_inputs(seed=5)
    full = _emulated(lib, ins, rhs)
    for idx in (torch.randperm(B, generator=torch.Generator().manual_seed(4)),
                torch.tensor([1, 7, 8, 11, 12])):
        got = _emulated(lib, [a[..., idx].contiguous() for a in ins],
                        [a[..., idx].contiguous() for a in rhs])
        for g, r in zip(got, full):
            _same_bits(g, [a[..., idx] for a in r])
    for g, r in zip(_emulated(lib, ins, rhs, max_lanes=2), full):
        _same_bits(g, r)


def _k5_inputs(seed, dtype=F64):
    """K5's inputs in solve_lqr_batched's order (Q, R, S, qx, qu, A, B, c,
    dx0): chip_smoke.py's well-conditioned random blocks."""
    return [torch.as_tensor(a, dtype=dtype)
            for a in random_lqr(np.random.default_rng(seed), N=N, Bn=B)]


def _k5(lib, args, max_lanes=lqr_kernel.MAX_LANES):
    """K5a, then K5b against its factor, from the CPU build."""
    Q, R, S, qx, qu, A, Bm, c, dx0 = args
    Nn, Bn = Q.shape[0], Q.shape[-1]
    fac = LQRFactor(*(Q.new_empty(s) for s in lqr_kernel._factor_shapes(Nn, Bn)))
    lqr_kernel.launch(lib, "lqr_factor", [Q, R, S, A, Bm], fac, None, (),
                      max_lanes)
    sol = lqr_kernel._solution_like(qx)
    lqr_kernel.launch(lib, "lqr_backsolve", [*fac, A, Bm, c, qx, qu, dx0], sol,
                      None, (), max_lanes)
    return fac, sol


def _k5_plain(args):
    Q, R, S, qx, qu, A, Bm, c, dx0 = args
    fac = lqr_kernel.lqr_factor_reference(Q, R, S, A, Bm)
    return fac, lqr_kernel.lqr_backsolve_reference(fac, A, Bm, c, qx, qu, dx0)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_block_kernel_source_matches_plain_bit_for_bit(lib, dtype):
    args = _k5_inputs(2, dtype)
    got = _k5(lib, args)
    want = _k5_plain(args)
    for g, r in zip(got, want):
        for b in r:
            assert torch.isfinite(b).all()
        _same_bits(g, r)


def test_block_kernel_source_nan_lane_matches_plain(lib):
    """An inf in one lane's A: the same outputs NaN (and the other lanes
    untouched) as in the plain version."""
    args = _k5_inputs(3)
    args[5][2, 4, 1, 5] = float("inf")
    got = _k5(lib, args)
    want = _k5_plain(args)
    assert want[0].P[:, :, :, 5].isnan().any()
    assert want[1].dxb[:, :, 5].isnan().any()
    assert not want[0].P[..., [4, 6]].isnan().any()
    for g, r in zip(got, want):
        _same_bits(g, r)


def test_block_kernel_source_lane_results_do_not_depend_on_their_slot(lib):
    """A permutation of the lanes permutes K5's outputs bit for bit; 5
    lanes launched alone, and every lane with 2 lanes a CTA, equal the full
    launch."""
    args = _k5_inputs(5)
    full = _k5(lib, args)
    for idx in (torch.randperm(B, generator=torch.Generator().manual_seed(4)),
                torch.tensor([1, 7, 8, 11, 12])):
        got = _k5(lib, [a[..., idx].contiguous() for a in args])
        for g, r in zip(got, full):
            _same_bits(g, [a[..., idx] for a in r])
    for g, r in zip(_k5(lib, args, max_lanes=2), full):
        _same_bits(g, r)
