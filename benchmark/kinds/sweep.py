"""Sweep traffic: BASELINE config 5's sharded Monte-Carlo sweep over
`ranks` processes (forces_resilient_planner_tpu_torch/parallel/mesh.py),
one card each on "cuda" (NCCL), or CPU ranks over gloo.

Rank 0 is the harness's own process, on cuda:0.  Ranks 1.. are started
with the spawn context, take cuda:1.. and join the group through a file://
rendezvous in a temporary directory; they import no JAX.  On the cards
every rank keeps to its own block of the host's cores (_bind).  A call:
rank 0 sends every rank the call's seed, drawn from the run's seed, over a
pipe (a CPU channel, never the card); then every rank runs
pm.monte_carlo_sweep
(the whole set drawn and expanded, its shard solved, the statistics
all-reduced) and pm.gather_results, which brings every shard's exit codes
and iterations to rank 0.  Attempted: the call's scenarios; failed: exit
code != 1.

The sample: every rank keeps the same reservoir with the same picking
seed, so every rank knows which calls are sampled and which of the
sampled lanes, drawn over the whole set, are its own.  On a sampled call
the ranks all-gather those lanes' controls to rank 0, which also keeps
the call's all-reduced statistics and the gathered set.  The check solves
the sampled lanes again with the plain float64 reference and holds the
all-reduced statistics to the plain ones of the gathered set
(reference/sweep.py).

A rank that fails ends the run: it sends rank 0 its traceback and exits;
rank 0 then kills the other ranks and raises, within LIMIT_S seconds (the
group's timeout bounds every collective).  The ranks die with rank 0.

Traffic parameters: ranks, goals, forces (per call), halves (the program's
box), x0 (its start), warm_calls, check_calls (calls the reference
checks), check_lanes (lanes of each), trace_calls (calls of a traced
window).
"""
from __future__ import annotations

import ctypes
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from benchmark import spans
from benchmark.reference import grid as ref_grid
from benchmark.reference import solver as ref_solver
from benchmark.reference import sweep as ref_sweep
from benchmark.sample import Reservoir, worst
from benchmark.trace import span

LIMIT_S = 120.0          # rendezvous, a collective, a reply, the ranks' join
SOLVE = "sweep.solve"    # the span whose growth gives each rank's solve time
# the program's spans of a sweep, each rank's growth printed at the end
SPANS = ("sweep", "sweep.expand", SOLVE, "sweep.reduce", "sweep.gather")


def _call_seed(rng) -> int:
    return int(rng.integers(0, 2 ** 62))


def _require(pm) -> None:
    """Fail at once on a program without the sweep's scale-out API."""
    import inspect

    if not hasattr(pm, "gather_results") or \
            "timeout" not in inspect.signature(pm.init_group).parameters:
        raise RuntimeError(
            "the program's parallel/mesh.py has no gather_results or no "
            "init_group timeout: it cannot run the sharded sweep")


class _Rank:
    """What every rank does alike: the group, the mesh, the call, the
    sample."""

    def __init__(self, cfg, traffic, seed, rank, device_type, init_method):
        from forces_resilient_planner_tpu_torch.parallel import mesh as pm

        self.pm, self.cfg, self.t, self.rank = pm, cfg, traffic, rank
        self.world = traffic["ranks"]
        self.cpus = (_bind(rank, self.world) if device_type == "cuda"
                     else "unbound")
        pm.init_group(device_type, init_method, self.world, rank,
                      timeout=timedelta(seconds=LIMIT_S))
        self.mesh = pm.make_mesh((1, self.world), device_type=device_type)
        self.B = traffic["goals"] * traffic["forces"] * len(traffic["halves"])
        self.b = self.B // self.world
        self.pick = np.random.default_rng([seed, 1])
        self.samples = Reservoir(traffic["check_calls"], self.pick)
        self.mark()

    def sweep(self, seed_i):
        """(this rank's SolveResult, SweepStats, (exit codes, iterations)
        of the whole set on rank 0 or None)."""
        t = self.t
        res, stats = self.pm.monte_carlo_sweep(
            self.cfg, self.mesh, t["goals"], t["forces"], len(t["halves"]),
            seed_i, torch.float32)
        return res, stats, self.pm.gather_results(res)

    def lanes(self):
        return np.sort(self.pick.choice(self.B, self.t["check_lanes"],
                                        replace=False))

    def controls(self, res, lanes):
        """The controls (L, N, 4) of `lanes` (over the whole set) on rank 0,
        None elsewhere: each rank fills in its own and all take part."""
        lo = self.rank * self.b
        mine = np.flatnonzero((lanes >= lo) & (lanes < lo + self.b))
        dev = res.Z.device
        buf = torch.zeros((len(lanes), res.Z.shape[1], 4), dtype=res.Z.dtype,
                          device=dev)
        buf[torch.as_tensor(mine, device=dev)] = res.Z.index_select(
            0, torch.as_tensor(lanes[mine] - lo, device=dev))[:, :, 0:4]
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf)
        if self.rank:
            return None
        owner = torch.as_tensor(lanes // self.b, device=dev)
        return torch.stack(parts)[owner, torch.arange(len(lanes), device=dev)]

    def mark(self):
        self._mark = spans.counters(*SPANS)

    def growth(self) -> dict:
        """The spans' growth since mark(), and the card's peak."""
        now = spans.counters(*SPANS)
        out = {k: now[k] - self._mark[k] for k in now}
        if torch.cuda.is_available() and self.pm.mesh_device(
                self.mesh).type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["cpus"] = self.cpus
        return out


def _bind(rank: int, world: int) -> str:
    """A card's rank keeps to its own block of the host's cores, with
    torch's CPU pool sized to it, as torchrun's exclusive binding and one
    pool a rank do: the ranks' busy host loops share no core, and the
    scheduler does not move them from run to run.  Returns the block, for
    the run's log."""
    cpus = sorted(os.sched_getaffinity(0))
    per = len(cpus) // world
    if not per:
        return "unbound"
    block = cpus[rank * per:(rank + 1) * per]
    os.sched_setaffinity(0, block)
    torch.set_num_threads(per)
    return f"{block[0]}-{block[-1]}"


def _die_with_parent(parent: int) -> None:
    """This process is killed when the process that started it ends."""
    try:
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def rank_main(rank, cfg, traffic, seed, device_type, init_method, conn,
              parent):
    """Ranks 1..: serve rank 0's messages until "stop"."""
    _die_with_parent(parent)
    try:
        me = _Rank(cfg, traffic, seed, rank, device_type, init_method)
        conn.send(("ready",))
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            if msg[0] == "mark":
                me.mark()
                continue
            _, seed_i, window = msg
            res, _, _ = me.sweep(seed_i)
            if window:
                me.samples.offer(lambda: me.controls(res, me.lanes()))
        conn.send(("stopped", me.growth()))
        dist.destroy_process_group()
    except BaseException:
        try:
            conn.send(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        finally:
            os._exit(1)


class Loop:
    rank_main = staticmethod(rank_main)    # what ranks 1.. run

    def __init__(self, cfg, ref_cfg, traffic, seed, device):
        from forces_resilient_planner_tpu_torch.parallel import mesh as pm

        _require(pm)
        if np.any(np.asarray(traffic["halves"]) != ref_sweep.HALF):
            raise ValueError(f"the sweep's box is {ref_sweep.HALF}")
        self.cfg, self.ref_cfg, self.t = cfg, ref_cfg, traffic
        self.device = torch.device(device)
        self.world = traffic["ranks"]
        self.rng = np.random.default_rng([seed, 0])
        self.iters_sum = self.lanes = 0
        self.ends = []                     # each window call's end
        self.procs, self.conns, self.me = [], [], None
        self.failure, self.released = None, False
        self.rank_growth = None
        self.done = threading.Event()      # set before the ranks may end
        self.tmp = tempfile.mkdtemp(prefix="sweep-")
        try:
            if self.device.type == "cuda":
                if (self.device.index or 0) != 0:
                    raise ValueError("rank 0 of the sweep runs on cuda:0")
                if torch.cuda.device_count() < self.world:
                    raise RuntimeError(f"{self.world} ranks need {self.world} "
                                       "cards")
                # built once, before the ranks load it
                from forces_resilient_planner_tpu_torch.ops import _build

                _build.build("ipm_iteration.cu")
            init = f"file://{self.tmp}/rendezvous"
            ctx = mp.get_context("spawn")
            for r in range(1, self.world):
                here, there = ctx.Pipe()
                p = ctx.Process(
                    target=self.rank_main, name=f"sweep-rank{r}", daemon=True,
                    args=(r, cfg, traffic, seed, self.device.type, init,
                          there, os.getpid()))
                p.start()
                there.close()
                self.procs.append(p)
                self.conns.append(here)
            self.me = _Rank(cfg, traffic, seed, 0, self.device.type, init)
            self._expect("ready")
            threading.Thread(target=self._watch, daemon=True).start()
            warm = np.random.default_rng([seed, 2])
            for _ in range(traffic["warm_calls"]):
                self._call(_call_seed(warm), False)
            self._send(("mark",))
            self.me.mark()
        except BaseException as e:
            raise self._abandon(e) from e
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ---- the ranks ---------------------------------------------------------

    def _send(self, msg):
        for conn in self.conns:
            conn.send(msg)

    def _expect(self, kind):
        """Each rank's next message, which must be `kind`, within LIMIT_S."""
        deadline = time.monotonic() + LIMIT_S
        out = []
        for r, (p, conn) in enumerate(zip(self.procs, self.conns), 1):
            while not conn.poll(0.1):
                if not p.is_alive() and not conn.poll(0):
                    raise RuntimeError(f"rank {r} ended with exit code "
                                       f"{p.exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"rank {r} sent no {kind!r} in "
                                       f"{LIMIT_S:.0f} s")
            msg = conn.recv()
            if msg[0] != kind:
                raise RuntimeError(msg[1] if msg[0] == "error" else
                                   f"rank {r} sent {msg[0]!r}, not {kind!r}")
            out.append(msg)
        return out

    def _watch(self):
        """A rank that ends before the run lets it: the other ranks are
        killed and rank 0's group is aborted, so that a collective waiting
        for the lost rank returns and the next call raises."""
        alive = {p.sentinel: (r, p) for r, p in enumerate(self.procs, 1)}
        while alive and not self.done.is_set():
            for s in mp.connection.wait(list(alive), timeout=0.5):
                r, p = alive.pop(s)
                if self.done.is_set():
                    continue
                p.join()
                self.failure = f"rank {r} ended with exit code {p.exitcode}"
                self._kill()
                abort = getattr(dist.distributed_c10d, "_abort_process_group",
                                None)
                if self.device.type == "cuda" and abort is not None:
                    abort()
                return

    def _kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(LIMIT_S)

    def _errors(self) -> list[str]:
        out = []
        for conn in self.conns:
            try:
                while conn.poll(0.5):
                    msg = conn.recv()
                    if msg[0] == "error":
                        out.append(msg[1])
            except (EOFError, OSError):
                pass
        return out

    def _abandon(self, e) -> RuntimeError:
        """Rank 0's end after a failure: the ranks' tracebacks, every rank
        killed, the group left, the directory removed."""
        self.done.set()
        why = [*self._errors(), *([self.failure] if self.failure else []),
               *(f"{p.name} ended with exit code {p.exitcode}"
                 for p in self.procs if p.exitcode)]
        self._kill()
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:       # a group a lost rank left broken
                pass
        shutil.rmtree(self.tmp, ignore_errors=True)
        return RuntimeError("the sharded sweep failed: "
                            + ("\n".join(why) or repr(e)))

    # ---- calls -------------------------------------------------------------

    def _call(self, seed_i, window):
        if self.failure:
            raise RuntimeError(self.failure)
        self._send(("call", seed_i, window))
        with span("program"):
            res, stats, (ec, it) = self.me.sweep(seed_i)
        if self.failure:
            raise RuntimeError(self.failure)
        ec, it = ec.numpy(), it.numpy()
        if window:
            self.ends.append(time.perf_counter())
            self.iters_sum += int(it.sum())
            self.lanes += ec.size
            with span("sample"):
                self.me.samples.offer(
                    lambda: self._record(seed_i, res, stats, ec, it))
        return ec

    def call(self, i):
        with span("pick"):
            seed_i = _call_seed(self.rng)
        try:
            ec = self._call(seed_i, True)
        except BaseException as e:
            raise self._abandon(e) from e
        return ec.size, int((ec != 1).sum())

    def _record(self, seed_i, res, stats, ec, it):
        lanes = self.me.lanes()
        got = torch.stack([stats.n, stats.n_solved, stats.mean_iters]).to(
            torch.float64).cpu().tolist()
        return dict(seed=seed_i, lanes=lanes, u=self.me.controls(res, lanes),
                    ec=ec[lanes], ec_all=ec, it_all=it, got=got)

    def _stop(self):
        """Every rank's solve span growth over the window; the ranks end."""
        if self.rank_growth is not None:
            return
        self.done.set()
        self._send(("stop",))
        self.rank_growth = [self.me.growth()] + [
            m[1] for m in self._expect("stopped")]
        for r, g in enumerate(self.rank_growth):
            ms = ", ".join(f"{n} {g[n + '.ns'] * 1e-6 / g[n + '.count']:.3f}"
                           for n in SPANS if g.get(f"{n}.count"))
            print(f"sweep rank {r}: ms a call: {ms}; memory_peak_bytes "
                  f"{g.get('memory_peak_bytes')}; cpus {g['cpus']}",
                  file=sys.stderr)
        if self.ends:
            t, n = np.asarray(self.ends) - self.ends[0], len(self.ends)
            per = np.bincount((t // 5).astype(int)) / 5
            print(f"sweep calls a second, by 5 s of {n} calls: "
                  + " ".join(f"{v:.1f}" for v in per[:-1]), file=sys.stderr)

    def stats(self):
        try:
            self._stop()
        except BaseException as e:
            raise self._abandon(e) from e
        ns = [g.get(f"{SOLVE}.ns") for g in self.rank_growth]
        counts = [g.get(f"{SOLVE}.count") for g in self.rank_growth]
        m = self.cfg.model
        return dict(iters_sum=self.iters_sum, lanes=self.lanes, N=m.N,
                    nh=m.nh, itemsize=4,
                    solve_ns=ns if all(counts) else None)

    def release(self):
        """Ends the ranks: all leave the group together (an NCCL group's
        ranks finish their communicators together), then rank 0 joins the
        others, killing any not done within LIMIT_S."""
        if self.released:
            return
        self.released = True
        try:
            self._stop()
            dist.destroy_process_group()
            deadline = time.monotonic() + LIMIT_S
            for p in self.procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            left = [p.name for p in self.procs if p.is_alive()]
            if left:
                raise TimeoutError(f"{', '.join(left)} not done in "
                                   f"{LIMIT_S:.0f} s")
            shutil.rmtree(self.tmp, ignore_errors=True)
        except BaseException as e:
            raise self._abandon(e) from e

    # ---- the check ---------------------------------------------------------

    def _reference(self, dtype, samples):
        """The reference's solve, in `dtype`, of the samples' lanes."""
        t = self.t

        def tt(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        parts = []
        for s in samples:
            goals, forces, halves = ref_sweep.draws(
                s["seed"], t["goals"], t["forces"], len(t["halves"]))
            parts.append(ref_grid.problems(
                self.ref_cfg, tt(t["x0"]), tt(goals), tt(forces), tt(halves),
                torch.as_tensor(s["lanes"], device=self.device)))
        Z0 = torch.cat([p[0] for p in parts])
        prob = ref_solver.Problem(
            *(torch.cat([p[1][k] for p in parts]) for k in range(6)),
            weights=ref_solver.StageWeights(*(
                torch.cat([p[1].weights[k] for p in parts])
                for k in range(5))))
        return ref_solver.solve(Z0, prob, self.ref_cfg.model,
                                self.ref_cfg.solver)

    def check(self):
        """The sampled lanes of every shard solved again by the reference at
        float64: the share whose exit codes differ and the widest control
        gap over the lanes the reference solved; and each sampled call's
        all-reduced statistics against the plain ones of its gathered set
        (n and n_solved exactly, the mean iterations relative)."""
        samples = self.me.samples.kept
        ref = self._reference(torch.float64, samples)
        ec_ref = ref.exit_code.cpu().numpy()
        ec = np.concatenate([s["ec"] for s in samples])
        u = torch.cat([s["u"] for s in samples]).to(torch.float64)
        solved = torch.as_tensor(ec_ref == 1, device=u.device)
        gap = (u - ref.Z[:, :, 0:4]).abs().amax(dim=(1, 2))[solved]
        stats_gap = worst(
            ref_sweep.gap(s["got"], ref_sweep.stats(s["ec_all"], s["it_all"]))
            for s in samples if "got" in s)
        return {"exit_mismatch_share": float(np.mean(ec != ec_ref)),
                "du_max": worst(gap.cpu().numpy()),
                "stats_gap": stats_gap}

    def control(self, dtype):
        """check() of the reference in `dtype` put in the program's place,
        on calls drawn as a window draws them: their sampled lanes solved
        in one batch, and the first call's whole set solved and its
        statistics reduced as the ranks reduce them, in `dtype`."""
        recs = [dict(seed=_call_seed(self.rng), lanes=self.me.lanes())
                for _ in range(self.t["check_calls"])]
        sol = self._reference(dtype, recs)
        ec, it = sol.exit_code.cpu().numpy(), sol.iters.cpu().numpy()
        whole = self._reference(dtype, [dict(seed=recs[0]["seed"],
                                             lanes=np.arange(self.me.B))])
        ec0, it0 = whole.exit_code.cpu().numpy(), whole.iters.cpu().numpy()
        recs[0].update(ec_all=ec0, it_all=it0, got=ref_sweep.reduced_stats(
            ec0, it0, np.arange(self.me.B) // self.me.b, self.world, dtype))
        self.me.samples = Reservoir(len(recs), self.me.pick)
        at = 0
        for rec in recs:
            k = slice(at, at + len(rec["lanes"]))
            rec.update(u=sol.Z[k, :, 0:4], ec=ec[k])
            at = k.stop
            self.me.samples.offer(lambda: rec)
        return self.check()
