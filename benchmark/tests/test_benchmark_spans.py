"""The span metrics (benchmark/spans.py and the `*_ms.*` metric files):
growth of the program's span totals over the window in ms a call, nothing
from a program without the span module, and every cell's traced run
reporting the span metrics its BENCHMARK.json entries list."""
from types import SimpleNamespace

import pytest

from benchmark import spans, spec
from test_benchmark_run import tiny

MS = 1_000_000   # ns


def _run(calls, **grown):
    counters = {}
    for name, (count, ns) in grown.items():
        counters[f"{name}.count"], counters[f"{name}.ns"] = count, ns
    return SimpleNamespace(calls=calls, counters=counters)


def test_growth_in_ms_a_call_less_the_nested_spans():
    run = _run(4, step=(4, 40 * MS), api=(0, 0), solver=(4, 12 * MS))
    assert spans.ms_per_call(run, ("step",)) == 10.0
    assert spans.ms_per_call(run, ("step", "api"), ("solver",)) == 7.0


def test_nothing_to_read_is_none():
    run = _run(4, step=(0, 0), solver=(4, 12 * MS))
    assert spans.ms_per_call(run, ("step",)) is None       # never opened
    assert spans.ms_per_call(run, ("api",)) is None        # no counter


def test_a_program_without_spans_gives_no_counters(monkeypatch):
    def missing(name):
        raise ModuleNotFoundError(f"No module named {name!r}", name=name)

    monkeypatch.setattr(spans.importlib, "import_module", missing)
    assert spans.counters("step", "solver") == {}
    assert spec.metric("glue_ms.latency").counters() == {}


def test_another_missing_module_raises(monkeypatch):
    def broken(name):
        raise ModuleNotFoundError("No module named 'torch'", name="torch")

    monkeypatch.setattr(spans.importlib, "import_module", broken)
    with pytest.raises(ModuleNotFoundError):
        spans.counters("step")


def test_counters_hold_each_span_unopened_at_zero():
    out = spans.counters("never.opened.span")
    assert out == {"never.opened.span.count": 0, "never.opened.span.ns": 0}


@pytest.mark.parametrize("name", ["grid-4096", "api-1"])
def test_traced_run_reports_its_span_metrics(name):
    from benchmark import run

    c = tiny(name)
    result, _ = run.run_cell(c, 2 ** 31 + 13, 0.0, True, "cpu")
    listed = {m["name"] for m in c.per_layer if m["name"].split(".")[0]
              .endswith("_ms")}
    assert listed
    for m in listed:
        assert result["metrics"][m]["value"] > 0, m
