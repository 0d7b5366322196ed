"""The ported BASELINE config 5 example (examples/config5_monte_carlo.py of
the port) on the CPU at a small size: a sweep interrupted after 2
checkpointed chunks and resumed to 3 in a fresh call gives every chunk's
exit codes and iterations bit-equal to one uninterrupted run, with the
JAX example's per-chunk seeds and summary fields.  The full 25 x 4096
sweep and the --mesh path over 2 and 4 CPU ranks are marked slow; the
full sweep runs on the card in chip_smoke.py."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from forces_resilient_planner_tpu_torch.examples import config5_monte_carlo as ex
from forces_resilient_planner_tpu_torch.utils.checkpoint import (
    SweepCheckpointer,
)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--goals", "2", "--forces", "4"]


def _jax_example():
    """The JAX example module, loaded by path (it imports no JAX at module
    level: chunk_seeds is numpy)."""
    spec = importlib.util.spec_from_file_location(
        "jax_config5", ROOT / "examples" / "config5_monte_carlo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chunks(d, n):
    ck = SweepCheckpointer(d)
    return [tuple(a.numpy() for a in ck.load_chunk(c, device="cpu"))
            for c in range(n)]


def test_chunk_seeds_are_the_jax_example_s():
    jex = _jax_example()
    for c in (0, 7, 24):
        for a, b in zip(ex.chunk_seeds(c, 256, 16), jex.chunk_seeds(c, 256, 16)):
            np.testing.assert_array_equal(a, b)


def test_resume_after_interrupt_is_bit_equal(tmp_path):
    resumed, whole = tmp_path / "resumed", tmp_path / "whole"
    assert ex.main(SMALL + ["--chunks", "2", "--ckpt-dir", str(resumed),
                            "--no-summary"]) is None
    assert SweepCheckpointer(resumed).done_chunks() == {0, 1}
    out = tmp_path / "summary.json"
    s = ex.main(SMALL + ["--chunks", "3", "--ckpt-dir", str(resumed),
                         "--out", str(out)])
    assert json.loads(out.read_text()) == s
    assert s["resumed_chunks"] == 2 and s["n_scenarios"] == 24
    assert s["n_chunks"] == 3 and s["mode"] == "streamed"
    assert s["device"] == "cpu" and s["chunk_batch"] == 8
    assert set(s["exit_code_fracs"]) == {"OPTIMAL", "MAXITREACHED",
                                         "BADFUNCEVAL", "NOPROGRESS"}
    assert s["steady_state_solves_per_s"] is None   # one chunk this call
    u = ex.main(SMALL + ["--chunks", "3", "--ckpt-dir", str(whole)])
    assert u["resumed_chunks"] == 0 and u["steady_state_solves_per_s"] > 0
    for a, b in zip(_chunks(resumed, 3), _chunks(whole, 3)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for k in ("resilience_rate", "mean_iters", "max_iters", "iters_p99",
              "exit_code_fracs", "n_scenarios"):
        assert s[k] == u[k], k
    # a finished sweep resumes every chunk and solves none
    again = ex.main(SMALL + ["--chunks", "3", "--ckpt-dir", str(whole)])
    assert again["resumed_chunks"] == 3 and again["wall_s"] == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("ranks", [2, 4])
def test_mesh_path_over_cpu_ranks(tmp_path, ranks):
    s = ex.main(SMALL + ["--mesh", "--ranks", str(ranks), "--chunks", "2",
                         "--ckpt-dir", str(tmp_path)])
    assert s["mode"] == "mesh" and s["n_chunks"] == 2
    assert s["n_scenarios"] == 2 * (8 + (-8) % ranks)


@pytest.mark.slow
def test_full_sweep_resumed_after_8_chunks(tmp_path):
    """BASELINE config 5's r05 bar at full scale (run it on the card)."""
    ex.main(["--device", "cpu", "--chunks", "8", "--ckpt-dir", str(tmp_path),
             "--no-summary"])
    s = ex.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert s["resumed_chunks"] == 8 and s["n_scenarios"] == 102_400
    assert s["resilience_rate"] >= 0.999
