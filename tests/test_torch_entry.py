"""Port parity: entry.py, the analog of the repo's __graft_entry__.py.

Its example inputs equal __graft_entry__._example_inputs at f32 (single and
batched); its configurations equal the root file's caps; entry()'s step
runs on the CPU (finite, the root file's output shapes, exit code 1,
launch-free: a CPU tensor takes the plain versions); dryrun_multichip
spawns one CPU rank over gloo and passes its own shape check, and refuses
a card count it does not have, with no fallback to the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu_torch import entry
from forces_resilient_planner_tpu_torch.engine import pipeline_batch


def _plain(cfg):
    """asdict with numpy arrays as lists (== on arrays is elementwise)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        if isinstance(v, np.ndarray):
            return ("ndarray", v.dtype.str, v.tolist())
        return v
    return conv(dataclasses.asdict(cfg))


@pytest.mark.parametrize("batch", [None, 3])
def test_example_inputs_equal_the_root_file_s(batch):
    cfg = graft._small_cfg()
    ref = graft._example_inputs(cfg, jnp.float32, batch=batch)
    got = entry.example_inputs(entry.small_cfg(), torch.float32, batch=batch,
                               device="cpu")
    assert list(got) == list(ref) == list(pipeline_batch.PIPELINE_ARG_KEYS)
    for k, r in ref.items():
        r = np.asarray(r)
        g = got[k].numpy()
        assert g.shape == r.shape, k
        if k == "kino_size":
            assert g.dtype == np.int64 and (g == r).all()
        else:
            assert g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=k)


def test_dryrun_cfg_equals_the_root_file_s():
    base = graft._small_cfg()
    ref = dataclasses.replace(
        base,
        solver=dataclasses.replace(base.solver, max_iters=12),
        corridor=dataclasses.replace(base.corridor, max_obstacles=64,
                                     shrink_iters=4),
    )
    assert _plain(entry.dryrun_cfg()) == _plain(ref)


def test_entry_step_on_the_cpu():
    fn, args = entry.entry(device="cpu")
    assert len(args) == 10 and all(a.device.type == "cpu" for a in args)
    mpc_output, exit_code, kkt = fn(*args)
    assert mpc_output.shape == (21, 17) and mpc_output.dtype == torch.float32
    assert bool(mpc_output.isfinite().all())
    assert int(exit_code) == 1 and float(kkt) < 1e-3


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() would run on it")
    with pytest.raises((AssertionError, RuntimeError)):
        entry.entry()


def test_dryrun_multichip_one_cpu_rank():
    rep = entry.dryrun_multichip(1, device_type="cpu", timeout=120)
    assert rep == {"batch": 2, "shape": [2, 21, 17], "ranks": 1,
                   "mesh": {"host": 1, "chip": 1}, "device": "cpu"}


def test_dryrun_multichip_needs_its_cards():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"need {n} cards"):
        entry.dryrun_multichip(n)
