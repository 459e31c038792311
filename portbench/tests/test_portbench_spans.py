"""The per-layer metrics that read the program's own spans and counters
(``portbench/spans.py`` and its readers in ``portbench/metrics/``): on a
synthetic run with records before, inside and after the window, with no
records, on a program without the span store, and in a traced run of each
cell on the CPU at a small size."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from ccvm_tpu_torch import profiling
from portbench import spec, window

READERS = ("call_self_ms", "readout_ms", "readout_rows64", "stats_ms", "host_syncs",
           "parse_ms", "host_run_pct")


def _reader(name):
    path = os.path.join(spec.HERE, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module.read


def _span(name, start, end, parent=None, cpu_s=0.0, **counts):
    return profiling.Span(name, start, parent, 0, end=end, cpu_s=cpu_s, counts=counts)


def _records():
    """Two façade-like calls and a load inside the window [10, 20], a call
    before it and one after it."""
    out = []

    def add(name, start, end, parent=None, **kw):
        out.append(_span(name, start, end, parent, **kw))
        return out[-1]

    before = add("ccvm.call", 5.0, 6.0)
    add("ccvm.readout", 5.5, 5.9, before, host_syncs=50, rows64=1000)
    a = add("ccvm.call", 10.0, 10.5)
    add("ccvm.sync", 10.1, 10.3, a, host_syncs=1)
    add("ccvm.readout", 10.3, 10.4, a, host_syncs=2, rows64=100)
    add("ccvm.statistics", 10.4, 10.45, a, cpu_s=0.04)
    load = add("ccvm.load", 11.0, 11.02)
    add("ccvm.parse", 11.0, 11.01, load, cpu_s=0.005)
    add("ccvm.scale", 11.02, 11.03, host_syncs=1)
    b = add("ccvm.call", 12.0, 12.6)
    pp = add("ccvm.postprocess", 12.1, 12.2, b)
    add("ccvm.sync", 12.15, 12.2, pp, host_syncs=1)  # a grandchild: not subtracted
    add("ccvm.readout", 12.2, 12.3, b, host_syncs=2, rows64=80)
    add("ccvm.statistics", 12.3, 12.35, b, cpu_s=0.05)
    after = add("ccvm.call", 25.0, 26.0)
    add("ccvm.parse", 25.1, 25.2, after, cpu_s=0.1, rows64=7)
    return out


def _run():
    calls = [window.CallRecord(index=0, size=70, start=10.0, wall=0.5, instances=2),
             window.CallRecord(index=1, size=70, start=11.0, wall=1.6, instances=3),
             window.CallRecord(index=2, size=70, start=12.6, wall=1.0, failed=True)]
    return SimpleNamespace(window=window.Window(10.0, 20.0, calls))


# Self time (0.5 + 0.6 - 0.35 - 0.25 s) and the rest over 2 calls; rows and
# the parse over 5 instances; CPU over wall of the parse and statistics.
EXPECTED = {"call_self_ms": 250.0, "readout_ms": 100.0, "readout_rows64": 36.0,
            "stats_ms": 50.0, "host_syncs": 3.5, "parse_ms": 2.0,
            "host_run_pct": 100.0 * 0.095 / 0.11}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_keeps_the_windows_records(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", _records)
    assert _reader(name)(_run()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_without_records(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _reader(name)(_run()) is None
    outside = [s for s in _records() if not 10.0 <= s.start <= 20.0]
    monkeypatch.setattr(profiling, "spans", lambda: outside)
    assert _reader(name)(_run()) is None
    # A program without the span store, as an older checkout's.
    monkeypatch.delattr(profiling, "spans")
    assert _reader(name)(_run()) is None


def _run_module():
    s = importlib.util.spec_from_file_location("portbench_run_traced",
                                               os.path.join(spec.HERE, "run.py"))
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cell, shrink, syncs", [
    ("dl-main-n70-b65536", {"batch": 32, "iterations": 40, "call_pool": 3}, 3),
    ("mf-main-n70-b65536", {"batch": 32, "iterations": 40, "call_pool": 3}, 4),
    # 50 loads, each scaling's wait, and the sweep's solve and readout: 3.
    ("dl-study-b1000", {"batch": 8, "iterations": 40, "call_pool": 6}, 53)])
def test_a_traced_run_reports_every_per_layer_metric(cell, shrink, syncs):
    result, _ = _run_module().run_cell(cell, 2**31 + 77, 2.0, True, device="cpu",
                                       shrink=shrink)
    reported = set(result["metrics"])
    assert {m["name"] for m in spec.cell(cell)["metrics"]["per_layer"]
            if m["name"].split(".")[0] in READERS} <= reported
    host_syncs = next(k for k in reported if k.split(".")[0] == "host_syncs")
    assert result["metrics"][host_syncs]["value"] == syncs
