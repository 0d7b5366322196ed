"""Kinodynamic front-end search, batched over lanes (torch).

Port of forces_resilient_planner_tpu/search/kinodynamic.py (the reference's
path_searching/src/kinodynamic_astar.cpp re-designed as a bounded-round
batched frontier expansion with fixed-size tables):

  - node pool: fixed-capacity struct-of-arrays per lane; a dense
    voxel->slot table replaces the hash map (exact dedup, O(1) gathers);
  - each round expands the top-K open nodes of every lane by f-score
    (K = SearchConfig.expand_width);
  - the disturbance bias: every input sample has external_acc added in the
    state transition (stateTransit, kinodynamic_astar.cpp:828-845);
  - the 125-input lattice, tau = max_tau, the init expansion with start_acc
    over 8 sub-durations, the per-axis velocity gate, the 15-substep
    collision sweep through occ_grid.check_state, same-voxel pruning, the
    Pontryagin quartic heuristic and the one-shot cubic connection.

`search` takes B lanes at once (leading axis) over one shared grid: the
fleet's B scenarios, or the planner's one robot at B = 1.  The JAX
package's per-lane jax.lax.while_loop, vmapped, becomes one loop of at
most max_rounds rounds with a per-lane `active` mask: an inactive lane's
tables, iteration count, done flag and terminal node stay untouched, so
every lane ends as it would alone.  No round reads the device; every
EXIT_CHECK rounds one read ends the loop early once no lane is active.

Order-sensitive steps keep JAX's order exactly: jax.lax.top_k (lower index
first among equal keys) is the first K of a stable ascending sort,
jnp.lexsort two stable sorts, jnp.argmin the first minimum, jnp.cbrt
XLA's signed power, and x**n the products jax.lax.integer_pow
forms.  The arithmetic is that of the search under jit (the fleet, the
planner): XLA turns a division by a constant into a multiplication by its
reciprocal, so every such division here is written as that product.

Returns the reference's status codes: REACH_HORIZON=1, REACH_END=2,
NO_PATH=3, REACH_END_BUT_SHOT_FAILS=4 (kinodynamic_astar.h:160).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import (
    MapConfig,
    SearchConfig,
    TubeConfig,
)
from forces_resilient_planner_tpu_torch.mapping import occ_grid as og
from forces_resilient_planner_tpu_torch.utils.lanes import norm3, sum_dim

REACH_HORIZON = 1
REACH_END = 2
NO_PATH = 3
REACH_END_BUT_SHOT_FAILS = 4

_INF = 1e30
MAX_EDGES = 64
EXIT_CHECK = 8       # rounds between the loop's device reads


def _sq(x):
    return x * x


def _cube(x):
    # jax.lax.integer_pow(x, 3) = x * (x * x)
    return x * (x * x)


def _div(x, c):
    """x / c as jitted JAX computes it: times 1 / c for a constant c."""
    return x * (1.0 / c) if isinstance(c, (int, float)) else x / c


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root as jnp.cbrt computes it on XLA: |x|^(1/3) with x's
    sign (a correctly rounded cube root differs from it by up to a dozen
    ulps at large or small |x|)."""
    return torch.copysign(torch.abs(x) ** (1.0 / 3.0), x)


def state_transit(state: torch.Tensor, um: torch.Tensor, ext_acc: torch.Tensor,
                  tau: torch.Tensor) -> torch.Tensor:
    """Double integrator with disturbance bias (kinodynamic_astar.cpp:828-845)."""
    a = um + ext_acc
    t = tau[..., None]
    p = state[..., :3] + state[..., 3:] * t + 0.5 * _sq(t) * a
    v = state[..., 3:] + t * a
    return torch.cat([p, v], dim=-1)


# ---------------------------------------------------------------------------
# Pontryagin heuristic: quartic root closed form (kinodynamic_astar.cpp:322-501)
# ---------------------------------------------------------------------------
def _cubic_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d (3 slots, nan = absent)."""
    a2 = _div(b, a)
    a1 = _div(c, a)
    a0 = _div(d, a)
    Q = _div(3 * a1 - a2 * a2, 9.0)
    R = _div(9 * a1 * a2 - 27 * a0 - 2 * _cube(a2), 54.0)
    D = _cube(Q) + R * R
    sqD = torch.sqrt(torch.abs(D))
    # D > 0: one real root
    S = cbrt(R + sqD)
    T = cbrt(R - sqD)
    r1_pos = _div(-a2, 3) + (S + T)
    # D < 0: three real roots
    theta = torch.arccos(torch.clamp(
        R / torch.sqrt(torch.clamp(-_cube(Q), min=1e-300)), -1, 1))
    sq = 2 * torch.sqrt(torch.clamp(-Q, min=0.0))
    r1_neg = sq * torch.cos(_div(theta, 3)) - _div(a2, 3)
    r2_neg = sq * torch.cos(_div(theta + 2 * math.pi, 3)) - _div(a2, 3)
    r3_neg = sq * torch.cos(_div(theta + 4 * math.pi, 3)) - _div(a2, 3)
    nan = torch.full_like(a2, math.nan)
    pos = D > 0
    return (
        torch.where(pos, r1_pos, r1_neg),
        torch.where(pos, nan, r2_neg),
        torch.where(pos, nan, r3_neg),
    )


def _quartic_roots(a, b, c, d, e):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e (4 slots, nan = absent);
    Ferrari via resolvent cubic, mirroring kinodynamic_astar.cpp:426-501.
    The leading coefficient a may be a constant (JAX's full_like)."""
    a3 = _div(b, a)
    a2 = _div(c, a)
    a1 = _div(d, a)
    a0 = _div(e, a)
    y1, _, _ = _cubic_roots(
        1.0, -a2, a1 * a3 - 4 * a0,
        4 * a2 * a0 - _sq(a1) - _sq(a3) * a0,
    )
    r = _sq(a3) / 4 - a2 + y1
    bad = r < 0
    R = torch.sqrt(torch.clamp(r, min=0.0))
    nz = R != 0
    termR = torch.where(
        nz,
        0.75 * _sq(a3) - _sq(R) - 2 * a2,
        0.75 * _sq(a3) - 2 * a2,
    )
    disc = torch.clamp(_sq(y1) - 4 * a0, min=0.0)
    inner = torch.where(
        nz,
        0.25 * (4 * a3 * a2 - 8 * a1 - _cube(a3))
        / torch.where(nz, R, torch.ones_like(R)),
        2 * torch.sqrt(disc) * torch.sign(disc),
    )
    D2 = termR + inner
    E2 = termR - inner
    nanv = torch.full_like(a3, math.nan)
    Dv = torch.where(D2 >= 0, torch.sqrt(torch.clamp(D2, min=0.0)), nanv)
    Ev = torch.where(E2 >= 0, torch.sqrt(torch.clamp(E2, min=0.0)), nanv)
    r1 = -a3 / 4 + R / 2 + Dv / 2
    r2 = -a3 / 4 + R / 2 - Dv / 2
    r3 = -a3 / 4 - R / 2 + Ev / 2
    r4 = -a3 / 4 - R / 2 - Ev / 2
    return tuple(torch.where(bad, nanv, r) for r in (r1, r2, r3, r4))


def estimate_heuristic(x1: torch.Tensor, x2: torch.Tensor, w_time: float,
                       max_vel: float, tie_breaker: float):
    """Minimum of int ||u||^2 + w_time over double-integrator connections
    (kinodynamic_astar.cpp:322-357).  Returns (heu, optimal_time)."""
    x1, x2 = torch.broadcast_tensors(x1, x2)
    dp = x2[..., :3] - x1[..., :3]
    v0 = x1[..., 3:6]
    v1 = x2[..., 3:6]
    c1 = -36.0 * sum_dim(dp * dp, -1)
    c2 = 24.0 * sum_dim((v0 + v1) * dp, -1)
    c3 = -4.0 * (sum_dim(v0 * v0, -1) + sum_dim(v0 * v1, -1)
                 + sum_dim(v1 * v1, -1))
    c4 = torch.zeros_like(c1)
    roots = _quartic_roots(float(w_time), c4, c3, c2, c1)
    t_bar = _div(torch.abs(dp).amax(dim=-1), max_vel)
    ts = torch.stack(list(roots) + [t_bar], dim=-1)

    ok = torch.isfinite(ts) & (ts >= t_bar[..., None]) & (ts > 1e-12)
    tt = torch.where(ok, ts, torch.ones_like(ts))
    c = (
        -c1[..., None] / (3 * _cube(tt))
        - c2[..., None] / (2 * _sq(tt))
        - c3[..., None] / tt
        + w_time * tt
    )
    costs = torch.where(ok, c, torch.full_like(c, _INF))
    # jnp.argmin: the first minimum (NaN counts as the minimum)
    key = torch.where(torch.isnan(costs), -math.inf, costs)
    k = torch.argmin(key, dim=-1, keepdim=True)
    cost = torch.gather(costs, -1, k)[..., 0]
    t_d = torch.gather(ts, -1, k)[..., 0]
    fin = torch.isfinite(cost) & (cost < _INF)
    cost = torch.where(fin, cost, torch.full_like(cost, _INF))
    t_d = torch.where(cost < _INF, t_d, t_bar)
    return (1.0 + tie_breaker) * cost, t_d


def _in_box(pos: torch.Tensor, mcfg: MapConfig) -> torch.Tensor:
    """The search's map box: |x|, |y| < size / 2 and 0.1 < z < size_z / 2."""
    hx, hy, hz = (s / 2 for s in mcfg.size)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    return ((x > -hx) & (x < hx) & (y > -hy) & (y < hy)
            & (z > 0.1) & (z < hz))


def _poly3(coef: torch.Tensor, t: torch.Tensor, deriv: bool = False):
    """coef (..., 3, 4) low->high at times t (..., S) -> (..., S, 3):
    position d + c t + b t^2 + a t^3, or with deriv its velocity."""
    c = coef[..., None, :, :]
    t = t[..., :, None]
    if deriv:
        return c[..., 1] + 2 * t * c[..., 2] + 3 * _sq(t) * c[..., 3]
    return c[..., 0] + t * c[..., 1] + _sq(t) * c[..., 2] + _cube(t) * c[..., 3]


# ---------------------------------------------------------------------------
# one-shot cubic connection (computeShotTraj, kinodynamic_astar.cpp:359-424)
# ---------------------------------------------------------------------------
def compute_shot(
    grid: og.OccGrid, state1: torch.Tensor, state2: torch.Tensor,
    t_d: torch.Tensor, scfg: SearchConfig, tcfg: TubeConfig, mcfg: MapConfig,
):
    """Cubic polynomial p(t) = d + c t + b t^2 + a t^3 hitting state2 at t_d,
    batched over leading axes.  Velocity/acceleration limit checks are
    disabled (matching the commented `return false` at
    kinodynamic_astar.cpp:403-407); bounds + collision checks are enabled.
    Returns (coef (..., 3, 4) low->high, ok (...))."""
    p0 = state1[..., :3]
    dp = state2[..., :3] - p0
    v0 = state1[..., 3:6]
    v1 = state2[..., 3:6]
    dv = v1 - v0
    td = torch.clamp(t_d, min=1e-4)[..., None]
    a = _div(-12.0 / _cube(td) * (dp - v0 * td) + 6.0 / _sq(td) * dv, 6.0)
    b = 0.5 * (6.0 / _sq(td) * (dp - v0 * td) - 2.0 / td * dv)
    coef = torch.stack([p0, v0, b, a], dim=-1)  # (..., 3, 4)

    steps = _div(torch.arange(1, 11, dtype=state1.dtype,
                              device=state1.device), 10.0)
    ts = steps * td                                 # (..., 10), t_delta = td/10
    pos = _poly3(coef, ts)
    vel = _poly3(coef, ts, deriv=True)
    in_bounds = _in_box(pos, mcfg).all(dim=-1)
    free = og.check_state(grid, pos, vel, scfg.clearance_inflate, tcfg.ego_r,
                          tcfg.ego_h, mcfg).all(dim=-1)
    return coef, in_bounds & free


# ---------------------------------------------------------------------------
# main search
# ---------------------------------------------------------------------------
class SearchResult(NamedTuple):
    status: torch.Tensor          # (B,) REACH_* codes
    # path as edges root->leaf: parent states + (input, duration) per edge
    edge_states: torch.Tensor     # (B, D, 6) parent state of each edge
    edge_inputs: torch.Tensor     # (B, D, 3)
    edge_durs: torch.Tensor       # (B, D)
    n_edges: torch.Tensor         # (B,)
    term_state: torch.Tensor      # (B, 6) terminate-node state
    shot_coef: torch.Tensor       # (B, 3, 4)
    shot_time: torch.Tensor       # (B,)
    shot_ok: torch.Tensor         # (B,)
    iterations: torch.Tensor      # (B,)


def input_lattice(scfg: SearchConfig, dtype, device) -> torch.Tensor:
    ax = np.arange(-scfg.max_acc, scfg.max_acc + 1e-3, scfg.max_acc * 0.5)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    return torch.as_tensor(g, dtype=dtype, device=device)  # (125, 3)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, C, ...) gathered at idx (B, M) along the node axis."""
    tail = t.shape[2:]
    i = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(t, 1, i)


def _put(t: torch.Tensor, idx: torch.Tensor, val) -> None:
    """t[b, idx[b, m]] = val[b, m] in place; idx may hold the sentinel
    slot t.shape[1] - 1 (JAX's dropped writes)."""
    tail = t.shape[2:]
    i = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    if not torch.is_tensor(val):
        val = torch.full(i.shape, val, dtype=t.dtype, device=t.device)
    t.scatter_(1, i, val.expand(i.shape).to(t.dtype))


class _Tables:
    """Per-lane node tables, each with a sentinel slot C (vox_tab: n_vox)
    that takes the writes JAX drops."""

    def __init__(self, B, C, n_vox, dtype, device):
        f = dict(dtype=dtype, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.states = torch.zeros((B, C + 1, 6), **f)
        self.g = torch.full((B, C + 1), _INF, **f)
        self.f = torch.full((B, C + 1), _INF, **f)
        self.parent = torch.full((B, C + 1), -1, **i32)
        self.inputs = torch.zeros((B, C + 1, 3), **f)
        self.durs = torch.zeros((B, C + 1), **f)
        self.status = torch.zeros((B, C + 1), **i32)
        self.vox_tab = torch.full((B, n_vox + 1), -1, **i32)
        self.n_used = torch.ones(B, **i32)


def search(
    grid: og.OccGrid,
    start_p: torch.Tensor, start_v: torch.Tensor, start_a: torch.Tensor,
    end_p: torch.Tensor, end_v: torch.Tensor,
    ext_acc: torch.Tensor,
    init_search: bool,
    scfg: SearchConfig, tcfg: TubeConfig, mcfg: MapConfig,
) -> SearchResult:
    """B searches over one grid; every start/end/ext tensor is (B, 3).
    The tables hold n_vox + 1 int32 voxel slots per lane (vox_tab),
    allocated once per call."""
    dtype, device = start_p.dtype, start_p.device
    B = start_p.shape[0]
    C = scfg.node_capacity
    K = scfg.expand_width
    shape = mcfg.grid_shape
    n_vox = shape[0] * shape[1] * shape[2]
    res = scfg.resolution
    origin = torch.tensor(mcfg.origin, dtype=dtype, device=device)
    tol = math.ceil(1.0 / scfg.resolution)
    lanes = torch.arange(B, device=device)

    def pos_to_vox(p):
        # search uses its own resolution grid (posToIndex, line 808-813)
        return torch.floor(_div(p - origin, res)).to(torch.int32)

    def vox_key(v):
        v = v.to(torch.int64)
        return v[..., 0] * (shape[1] * shape[2]) + v[..., 1] * shape[2] + v[..., 2]

    def near(v, w):
        return (torch.abs(v - w) <= tol).all(dim=-1)

    end_state = torch.cat([end_p, end_v], dim=-1)        # (B, 6)
    end_vox = pos_to_vox(end_p)

    tb = _Tables(B, C, n_vox, dtype, device)
    s0 = torch.cat([start_p, start_v], dim=-1)
    h0, _ = estimate_heuristic(s0, end_state, scfg.w_time, scfg.max_vel,
                               scfg.tie_breaker)
    tb.states[:, 0] = s0
    tb.g[:, 0] = 0.0
    tb.f[:, 0] = scfg.lambda_heu * h0
    tb.status[:, 0] = 1
    tb.vox_tab[lanes, vox_key(pos_to_vox(start_p))] = 0

    lattice = input_lattice(scfg, dtype, device)   # (125, 3)
    n_lat = lattice.shape[0]
    ext = ext_acc[:, None, :]

    def collision_free(par_states, um, tau):
        """15-substep collision sweep (kinodynamic_astar.cpp:190-201) of
        every candidate: (B, M, 6), (B, M, 3), (B, M) -> (B, M)."""
        n = scfg.check_num
        ks = _div(torch.arange(1, n + 1, dtype=dtype, device=device), n)
        xt = state_transit(par_states[..., None, :], um[..., None, :],
                           ext[..., None, :], tau[..., None] * ks)
        free = og.check_state(grid, xt[..., :3], xt[..., 3:],
                              scfg.clearance_inflate, tcfg.ego_r, tcfg.ego_h,
                              mcfg)
        return free.all(dim=-1)

    def expand(parent_ids, cand_states, cand_inputs, cand_durs,
               cand_parent_g, cand_ok):
        """Insert every lane's candidate batch (B, M, ...) into its tables."""
        pos = cand_states[..., :3]
        vel = cand_states[..., 3:]
        in_b = _in_box(pos, mcfg)
        vel_ok = (torch.abs(vel) <= scfg.max_vel).all(dim=-1)
        key = vox_key(pos_to_vox(pos))
        par_states = _rows(tb.states, parent_ids)
        not_same = (pos_to_vox(pos) != pos_to_vox(par_states[..., :3])).any(
            dim=-1)
        coll_free = collision_free(par_states, cand_inputs, cand_durs)

        gn = ((sum_dim(cand_inputs * cand_inputs, -1) + scfg.w_time)
              * cand_durs + cand_parent_g)
        heu, _ = estimate_heuristic(cand_states, end_state[:, None],
                                    scfg.w_time, scfg.max_vel,
                                    scfg.tie_breaker)
        fn = gn + scfg.lambda_heu * heu

        slot = torch.gather(tb.vox_tab, 1, torch.clamp(key, 0, n_vox - 1))
        closed = (slot >= 0) & (
            torch.gather(tb.status, 1, torch.clamp(slot, 0, C - 1).long()) == 2)
        valid = cand_ok & in_b & vel_ok & not_same & coll_free & ~closed

        # intra-batch dedup: min-f per voxel key (jnp.lexsort((fn, skey)))
        skey = torch.where(valid, key, n_vox)
        o1 = torch.sort(fn, dim=1, stable=True).indices
        o2 = torch.sort(torch.gather(skey, 1, o1), dim=1, stable=True).indices
        order = torch.gather(o1, 1, o2)
        ck = torch.gather(skey, 1, order)
        first = torch.ones_like(ck, dtype=torch.bool)
        first[:, 1:] = ck[:, 1:] != ck[:, :-1]
        keep = first & (ck < n_vox)
        cs = _rows(cand_states, order)
        ci = _rows(cand_inputs, order)
        cd = torch.gather(cand_durs, 1, order)
        cp = torch.gather(parent_ids, 1, order)
        cg = torch.gather(gn, 1, order)
        cf = torch.gather(fn, 1, order)
        cslot = torch.gather(tb.vox_tab, 1, torch.clamp(ck, 0, n_vox - 1))
        cs_c = torch.clamp(cslot, 0, C - 1).long()

        is_new = keep & (cslot < 0)
        improve = (keep & (cslot >= 0) & (cg < torch.gather(tb.g, 1, cs_c))
                   & (torch.gather(tb.status, 1, cs_c) == 1))

        new_rank = torch.cumsum(is_new.to(torch.int32), dim=1) - 1
        new_slot = tb.n_used[:, None] + new_rank
        is_new = is_new & (new_slot < C)
        write = torch.where(is_new, new_slot,
                            torch.where(improve, cslot, C)).long()

        _put(tb.states, write, cs)
        _put(tb.g, write, cg)
        _put(tb.f, write, cf)
        _put(tb.parent, write, cp)
        _put(tb.inputs, write, ci)
        _put(tb.durs, write, cd)
        _put(tb.status, write, 1)
        _put(tb.vox_tab, torch.where(is_new, ck, n_vox), new_slot)
        tb.n_used += is_new.sum(dim=1, dtype=torch.int32)

    # --- init expansion: start_acc over 8 sub-durations (lines 119-125) ----
    if init_search:
        n_init = scfg.init_sub_durations
        j = torch.arange(1, n_init + 1, dtype=dtype, device=device)
        taus = (j * (scfg.init_max_tau / n_init)).expand(B, n_init)
        acc = start_a[:, None, :].expand(B, n_init, 3)
        cs = state_transit(s0[:, None, :], acc, ext, taus)
        expand(
            torch.zeros((B, n_init), dtype=torch.int32, device=device), cs,
            acc, taus, torch.zeros((B, n_init), dtype=dtype, device=device),
            torch.ones((B, n_init), dtype=torch.bool, device=device),
        )
        tb.status[:, 0] = 2   # close the root

    # root termination pre-check (the reference checks on first pop; with the
    # init pre-expansion the root is already closed, so check explicitly)
    done = near(pos_to_vox(start_p), end_vox)
    it = torch.zeros(B, dtype=torch.int32, device=device)
    term = torch.zeros(B, dtype=torch.int64, device=device)

    # --- main loop: lanes stop one by one, each under its own cond ---------
    tau = torch.full((B, K * n_lat), scfg.max_tau, dtype=dtype, device=device)
    cinp = lattice.repeat(K, 1).expand(B, K * n_lat, 3)
    for r in range(scfg.max_rounds):
        status = tb.status[:, :C]
        active = ~done & (it < scfg.max_rounds) & (status == 1).any(dim=1)
        if r % EXIT_CHECK == 0 and r > 0 and not bool(active.any()):
            break
        f_open = torch.where(status == 1, tb.f[:, :C], _INF)
        top_f, top_idx = torch.sort(f_open, dim=1, stable=True)
        top_f, top_idx = top_f[:, :K], top_idx[:, :K]
        top_valid = (top_f < _INF) & active[:, None]

        best = top_idx[:, 0]
        best_p = tb.states[lanes, best, :3]
        terminate = near(pos_to_vox(best_p), end_vox) | (
            norm3(best_p - start_p) >= scfg.horizon)
        term = torch.where(active & terminate, best, term)
        done = torch.where(active, terminate, done)
        it = it + active.to(torch.int32)

        # close the expanded nodes
        _put(tb.status, torch.where(top_valid, top_idx, C), 2)

        # expansion: K x 125 candidates per lane, tau = max_tau
        pids = torch.where(top_valid, top_idx, 0).repeat_interleave(n_lat, 1)
        par = _rows(tb.states, pids)
        cs = state_transit(par, cinp, ext, tau)
        expand(pids.to(torch.int32), cs, cinp, tau, torch.gather(tb.g, 1, pids),
               top_valid.repeat_interleave(n_lat, 1))

    # --- retrieve path root->leaf (MAX_EDGES + 1 gathers) -------------------
    parent = tb.parent[:, :C].long()
    chain, idx = [], term
    for _ in range(MAX_EDGES + 1):
        chain.append(idx)
        idx = torch.where(idx >= 0,
                          parent[lanes, torch.clamp(idx, 0, C - 1)], -1)
    chain = torch.stack(chain, dim=1)          # leaf, parent, ..., root, -1...
    n_nodes = (chain >= 0).sum(dim=1)
    n_edges = torch.clamp(n_nodes - 1, min=0)
    # per-edge (parent state, input, duration) = the child node's fields
    child_pos = n_edges[:, None] - 1 - torch.arange(MAX_EDGES, device=device)
    child_idx = torch.where(
        (child_pos >= 0) & (child_pos < MAX_EDGES + 1),
        torch.gather(chain, 1, torch.clamp(child_pos, 0, MAX_EDGES)), -1)
    ci = torch.clamp(child_idx, 0, C - 1)
    edge_states = _rows(tb.states, torch.clamp(
        torch.gather(parent, 1, ci), 0, C - 1))
    edge_inputs = _rows(tb.inputs, ci)
    edge_durs = torch.where(child_idx >= 0, torch.gather(tb.durs, 1, ci), 0.0)

    term_c = torch.clamp(term, 0, C - 1)
    term_state = tb.states[lanes, term_c]

    # --- termination classification + one-shot ------------------------------
    near_end = near(pos_to_vox(term_state[:, :3]), end_vox) & done
    _, t_shot = estimate_heuristic(term_state, end_state, scfg.w_time,
                                   scfg.max_vel, scfg.tie_breaker)
    coef, shot_ok_raw = compute_shot(grid, term_state, end_state, t_shot,
                                     scfg, tcfg, mcfg)
    shot_ok = shot_ok_raw & near_end

    no_parent = parent[lanes, term_c] < 0
    stat = torch.where(
        near_end & shot_ok, REACH_END,
        torch.where(
            near_end & no_parent & ~shot_ok, NO_PATH,
            torch.where(near_end & ~shot_ok, REACH_END_BUT_SHOT_FAILS,
                        torch.where(done, REACH_HORIZON, NO_PATH))))

    return SearchResult(
        status=stat, edge_states=edge_states, edge_inputs=edge_inputs,
        edge_durs=edge_durs, n_edges=n_edges, term_state=term_state,
        shot_coef=coef, shot_time=t_shot, shot_ok=shot_ok, iterations=it,
    )


# ---------------------------------------------------------------------------
# trajectory sampling (getKinoTraj, kinodynamic_astar.cpp:648-695)
# ---------------------------------------------------------------------------
MAX_SAMPLES = 512
_EDGE_S = 11  # max samples per edge: max_tau/Ts + 1


def get_kino_traj(
    result: SearchResult, ext_acc: torch.Tensor, delta_t: float,
    max_samples: int = MAX_SAMPLES,
):
    """Resample every lane's found path at delta_t.  Returns (path (B, S, 3),
    size (B,)).

    Faithful to the reference's per-edge sampling t = tau, tau-dt, ..., >=0
    (then globally reversed), including the duplicate samples at interior
    nodes; plus the one-shot cubic tail sampled at t = dt..t_shot.
    """
    dtype, device = result.edge_states.dtype, result.edge_states.device
    B, D = result.edge_durs.shape

    # per-edge sample counts and ascending times
    nk = torch.floor(_div(result.edge_durs, delta_t) + 1e-5).to(torch.int64) + 1
    nk = torch.where(torch.arange(D, device=device) < result.n_edges[:, None],
                     nk, 0)
    j = torch.arange(_EDGE_S, device=device)
    t_asc = result.edge_durs[..., None] - (nk[..., None] - 1 - j).to(dtype) * delta_t
    valid_e = (j < nk[..., None]).reshape(B, -1)
    pts_e = state_transit(
        result.edge_states[:, :, None, :].expand(B, D, _EDGE_S, 6),
        result.edge_inputs[:, :, None, :].expand(B, D, _EDGE_S, 3),
        ext_acc[:, None, None, :],
        torch.clamp(t_asc, min=0.0),
    )[..., :3].reshape(B, -1, 3)

    # shot tail
    n_shot_f = torch.floor(_div(result.shot_time, delta_t) + 1e-9).to(
        torch.int64)
    n_shot = torch.where(result.shot_ok,
                         torch.clamp(n_shot_f, max=max_samples), 0)
    ts = torch.arange(1, max_samples + 1, dtype=dtype, device=device) * delta_t
    pts_s = _poly3(result.shot_coef, ts.expand(B, max_samples))
    valid_s = torch.arange(max_samples, device=device) < n_shot[:, None]

    all_pts = torch.cat([pts_e, pts_s], dim=1)
    all_valid = torch.cat([valid_e, valid_s], dim=1)

    # stable compaction into a fixed buffer
    order = torch.sort((~all_valid).to(torch.uint8), dim=1,
                       stable=True).indices[:, :max_samples]
    out = _rows(all_pts, order)
    size = torch.clamp(all_valid.sum(dim=1), max=max_samples)
    fill = torch.arange(max_samples, device=device)[None, :, None] < size[:, None, None]
    out = torch.where(fill, out, out[:, :1])
    return out, size


# ---------------------------------------------------------------------------
# auxiliary path queries (getCurPos / getSamples,
# kinodynamic_astar.cpp:593-806) — cold-path host utilities kept for API
# parity, on one lane's result (a SearchResult of B = 1, or lane b of it);
# the planner's hot path uses get_kino_traj.
# ---------------------------------------------------------------------------
def _lane(result: SearchResult, b: int):
    return {k: np.asarray(v[b].cpu(), dtype=float if v.is_floating_point()
                          else None) for k, v in result._asdict().items()}


def get_cur_pos(result: SearchResult, ext_acc, index_time: float,
                max_tau: float, end_pt, b: int = 0) -> np.ndarray:
    """Position at a time offset along lane b's path (getCurPos, 593-643).

    Mirrors the reference's assumption that every edge has duration max_tau
    (it indexes state_list with index_time / max_tau_).
    """
    r = _lane(result, b)
    ext = np.asarray(ext_acc, float)
    n_edges = int(r["n_edges"])
    if index_time < n_edges * max_tau:
        k = int(index_time / max_tau)
        tau = index_time % max_tau
        x0 = r["edge_states"][k]
        a = r["edge_inputs"][k] + ext
        return x0[:3] + x0[3:] * tau + 0.5 * tau * tau * a
    t_shot = float(r["shot_time"])
    if index_time < n_edges * max_tau + t_shot:
        if bool(r["shot_ok"]):
            tau = index_time - n_edges * max_tau
            tv = np.array([1.0, tau, tau**2, tau**3])
            return r["shot_coef"] @ tv
        return r["term_state"][:3]
    if bool(r["shot_ok"]):
        return np.asarray(end_pt, float)
    return r["term_state"][:3]


def get_samples(result: SearchResult, ext_acc, ts: float, b: int = 0):
    """Uniform resampling of lane b's path with boundary derivatives
    (getSamples, 699-806).

    Returns (point_set list root->goal, [start_vel, end_vel, start_acc,
    end_acc]).
    """
    r = _lane(result, b)
    ext = np.asarray(ext_acc, float)
    n_edges = int(r["n_edges"])
    durs = r["edge_durs"][:n_edges]
    states = r["edge_states"][:n_edges]
    inputs = r["edge_inputs"][:n_edges]
    shot_ok = bool(r["shot_ok"])
    t_shot = float(r["shot_time"]) if shot_ok else 0.0
    coef = r["shot_coef"]

    T_sum = float(durs.sum()) + t_shot
    if T_sum <= 0:
        return [], []
    K = int(T_sum / ts)
    ts_eff = T_sum / (K + 1)

    pts = []
    seg = n_edges  # n_edges = shot segment marker; edges are 0..n_edges-1
    t = t_shot if shot_ok else (durs[-1] if n_edges else 0.0)
    if not shot_ok:
        seg = n_edges - 1
    ti = T_sum
    while ti > -1e-5:
        if shot_ok and seg == n_edges:
            tv = np.array([1.0, t, t**2, t**3])
            pts.append(coef @ tv)
            t -= ts_eff
            if t < -1e-5:
                seg -= 1
                if seg >= 0:
                    t += durs[seg]
        else:
            x0 = states[seg]
            a = inputs[seg] + ext
            pts.append(x0[:3] + x0[3:] * t + 0.5 * t * t * a)
            t -= ts_eff
            if t < -1e-5 and seg > 0:
                seg -= 1
                t += durs[seg]
        ti -= ts_eff
    pts.reverse()

    start_vel = states[0, 3:] if n_edges else np.zeros(3)
    if shot_ok:
        end_vel = coef @ np.array([0.0, 1.0, 2 * t_shot, 3 * t_shot**2])
        end_acc = coef @ np.array([0.0, 0.0, 2.0, 6 * t_shot])
    else:
        last = states[-1] if n_edges else np.zeros(6)
        end_vel = last[3:] + durs[-1] * (inputs[-1] + ext) if n_edges else np.zeros(3)
        end_acc = inputs[-1] if n_edges else np.zeros(3)
    start_acc = inputs[0] if n_edges else np.zeros(3)
    return pts, [np.asarray(start_vel), np.asarray(end_vel),
                 np.asarray(start_acc), np.asarray(end_acc)]
