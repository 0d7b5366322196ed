"""The comparison that decides `correct` fails what it must: each cell's
controls (the plain reference in bfloat16 and in float16 in the
program's place) and the program broken underneath the timed path (a solve that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced, and for the step cells a step that returns the robots' plans
unchanged), on the CPU at a test size; the sound program passes there.
The same control at each cell's own size runs on the card by
benchmark/control.py."""
import math

import pytest
import torch

from benchmark import run, spec
from benchmark.reference.config import from_groups
from forces_resilient_planner_tpu_torch.solver import ipm_lanes

TINY = {"grid-4096": dict(goals=2, forces=2, check_calls=1, check_lanes=4,
                          warm_calls=0),
        # the cell's own check_robots (16) in each checked call
        "step-4096": dict(robots=16, pool=1, cloud=32, check_calls=1,
                          warm_calls=0, chunk=16),
        "step-1": dict(pool=2, cloud=32, check_calls=2, warm_calls=0),
        "api-1": dict(pool=2, check_calls=2, warm_calls=0)}
CELLS = list(TINY)


def tiny(name):
    c = spec.cell(name)
    c.traffic = dict(c.traffic, **TINY[name])
    return c


def correct(name, seed=2 ** 31 + 3):
    result, checks = run.run_cell(tiny(name), seed, 0.0, False, "cpu")
    return result["correct"], checks


def _broken(fault):
    solve = ipm_lanes.solve_batch_lanes_tiered

    def fake(Z0, params, mcfg, scfg):
        res = solve(Z0, params, mcfg, scfg)
        B = Z0.shape[0]
        if fault == "unchanged":
            return res._replace(Z=Z0.clone())
        if fault == "half":
            Z = res.Z.clone()
            Z[B // 2:] = Z0[B // 2:]
            return res._replace(Z=Z, exit_code=torch.ones_like(res.exit_code))
        Z = res.Z.clone()
        Z[0, :, 0:4] += 0.2       # twice the widest limit of a control gap
        return res._replace(Z=Z)
    return fake


def _state_kept(step):
    """The step returning the robots' previous plans unchanged, its exit
    codes as solved."""
    def fake(mpc_output, *args, **kw):
        res = step(mpc_output, *args, **kw)
        return res._replace(mpc_output=mpc_output.clone())
    return fake


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_passes(name):
    ok, checks = correct(name)
    assert ok, checks


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS for f in ("unchanged", "half", "altered")
    if not (f == "half" and TINY[n].get("robots", TINY[n].get("goals")) is None)
])
def test_broken_program_fails(name, fault, monkeypatch):
    monkeypatch.setattr(ipm_lanes, "solve_batch_lanes_tiered", _broken(fault))
    ok, checks = correct(name)
    assert not ok, checks


@pytest.mark.parametrize("name", ["step-4096", "step-1"])
def test_step_returning_its_state_fails(name, monkeypatch):
    from forces_resilient_planner_tpu_torch.engine import (
        pipeline,
        pipeline_batch,
    )

    monkeypatch.setattr(pipeline, "nmpc_step",
                        _state_kept(pipeline.nmpc_step))
    monkeypatch.setattr(pipeline_batch, "nmpc_step_batched",
                        _state_kept(pipeline_batch.nmpc_step_batched))
    ok, checks = correct(name)
    assert not ok, checks


@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in CELLS for d in (torch.bfloat16, torch.float16)])
def test_control_fails(name, dtype):
    c = tiny(name)
    d = spec.kind(c.traffic["kind"]).Loop(
        spec.program_config(c.config), from_groups(c.config["groups"]),
        c.traffic, 2 ** 31 + 4, "cpu")
    d.release()
    values = d.control(dtype)
    assert any(not math.isfinite(values[k]) or values[k] > lim
               for k, lim in c.limits.items()), values
