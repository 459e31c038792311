"""The port's profiling hooks (``ccvm_tpu_torch/profiling.py``) on the CPU:
``annotate`` spans in the Chrome-format trace that ``trace`` writes around
a plain solve; the program's own spans and counters (their tree, the host
syncs a path counts, the rows its readout evaluates in float64 on the
device), which record only while a profiler runs; and the records against
the trace."""

from __future__ import annotations

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ccvm_tpu_torch import (DLSolver, LangevinSolver, MFSolver, ProblemInstance,
                            PumpedLangevinSolver, profiling)
from ccvm_tpu_torch.parallel import sweep_solve
from ccvm_tpu_torch.problem_classes.boxqp import problem_instance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")
SIZE20 = sorted(glob.glob(os.path.join(REPO, "examples", "benchmarking_instances",
                                       "Size20", "*.in")))[:3]
BATCH = 100
PARAMS = {
    "dl": (DLSolver, {"pump": 2.0, "feedback_scale": 10, "dt": 0.01, "iterations": 6,
                      "noise_ratio": 10}),
    "mf": (MFSolver, {"pump": 0.0, "feedback_scale": 50, "j": 5.0, "S": 2.0, "dt": 0.01,
                      "iterations": 6}),
    "langevin": (LangevinSolver, {"dt": 0.002, "S": 0.5, "iterations": 6, "sigma": 0.5,
                                  "feedback_scale": 2.0}),
    "pumped": (PumpedLangevinSolver, {"pump": 2.0, "dt": 0.002, "S": 0.5, "iterations": 6,
                                      "sigma": 0.5, "feedback_scale": 2.0}),
}
CALL = ("ccvm.call", [("ccvm.sync", []), ("ccvm.readout", []), ("ccvm.statistics", [])])
REFINED = ("ccvm.call", [("ccvm.sync", []), ("ccvm.postprocess", []), ("ccvm.readout", []),
                         ("ccvm.statistics", [])])


def _solver(family):
    cls, params = PARAMS[family]
    solver = cls(device="cpu", batch_size=BATCH)
    solver.parameter_key = {20: dict(params)}
    return solver


def _instance(solver, path=TEST020):
    inst = ProblemInstance(device="cpu", file_path=path, instance_type="test")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    return inst


def _recorded(fn, tmp_path):
    """``fn()`` under ``profiling.trace``: its result, the spans it
    recorded, and the trace's events."""
    t0 = time.perf_counter()
    with profiling.trace(str(tmp_path / "trace")):
        out = fn()
    records = [s for s in profiling.spans() if s.start >= t0]
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, records, events


def _tree(span, records):
    return (span.name, [_tree(c, records) for c in records if c.parent is span])


def _syncs(records):
    return sum(s.counts.get("host_syncs", 0) for s in records)


def _run_path(path):
    """(the calls a path makes, its span trees, its host syncs)."""
    if path == "dl":
        solver = _solver("dl")
        inst = _instance(solver)
        return lambda: solver(inst, seed=3), [CALL], 2
    if path == "mf-grad-descent":
        solver = _solver("mf")
        inst = _instance(solver)
        # The refinement's own wait, besides the solve's and the readout's.
        return lambda: solver(inst, post_processor="grad-descent", seed=3), [REFINED], 3
    if path in ("langevin-grad-descent", "pumped-grad-descent"):
        solver = _solver(path.split("-")[0])
        inst = _instance(solver)
        return lambda: solver(inst, post_processor="grad-descent", seed=3), [REFINED], 3
    if path == "dl-sweep":
        solver = _solver("dl")
        insts = [ProblemInstance(device="cpu", file_path=p) for p in SIZE20]
        tree = ("ccvm.call", [("ccvm.scale", [])] * 3 + [("ccvm.sync", []), ("ccvm.readout", [])]
                + [("ccvm.statistics", [])] * 3)
        # One wait a scaling, the solve's, and the stacked readout's copy.
        return lambda: sweep_solve(solver, insts, seed=5, scale=True), [tree], 5
    assert path == "load-and-scale"
    solver = _solver("dl")
    return (lambda: _instance(solver, SIZE20[0]),
            [("ccvm.load", [("ccvm.parse", [])]), ("ccvm.scale", [])], 1)


def test_tracing_is_on_exactly_while_a_profile_runs(tmp_path):
    def state():
        return (torch.autograd.profiler._is_profiler_enabled,
                torch._C._autograd._profiler_enabled())

    assert state() == (False, False)
    with profiling.trace(str(tmp_path / "trace")):
        assert state() == (True, True)
    assert state() == (False, False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert state() == (True, True)
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                pass
            thread = threading.Thread(target=lambda: profiling.annotate("other")(
                lambda: None)())
            thread.start()
            thread.join(timeout=30)
        assert not thread.is_alive()
    assert state() == (False, False)
    outer, inner, other = [s for s in profiling.spans()
                           if s.name in ("outer", "inner", "other")][-3:]
    assert [outer.name, inner.name, other.name] == ["outer", "inner", "other"]
    assert inner.parent is outer and inner.call == outer.call
    # Spans nest on a per-thread stack: another thread's span is a root.
    assert other.parent is None and other.call != outer.call


@pytest.mark.parametrize("path", ["dl", "mf-grad-descent", "langevin-grad-descent",
                                  "pumped-grad-descent", "dl-sweep", "load-and-scale"])
def test_span_tree_and_host_syncs_of_each_path(path, tmp_path):
    fn, trees, syncs = _run_path(path)
    fn()  # warm: the native parser builds at its first use
    _, records, _ = _recorded(fn, tmp_path)
    roots = [s for s in records if s.parent is None]
    assert [_tree(r, records) for r in roots] == trees
    for root in roots:  # one call id a root, shared by everything under it
        under = [s for s in records if s.call == root.call]
        assert under[0] is root and all(s is root or s.parent in under for s in under)
    assert len({r.call for r in roots}) == len(roots)
    assert all(s.end is not None and s.start <= s.end for s in records)
    assert _syncs(records) == syncs
    for s in records:
        want = {"ccvm.sync": 1, "ccvm.readout": 1, "ccvm.scale": 1}.get(s.name, 0)
        if s.name == "ccvm.postprocess":
            want = 1  # the refinement's wait for its own result
        assert s.counts.get("host_syncs", 0) == want, (s.name, s.counts)


@pytest.mark.parametrize("path", ["dl", "dl-sweep", "mf-grad-descent", "langevin-grad-descent",
                                  "pumped-grad-descent"])
def test_rows64_is_the_readouts_own_count_of_ambiguous_rows(path, tmp_path, monkeypatch):
    """The readout has no ambiguous rows left to recompute on the host: it
    evaluates every row in float64 on the device holding them, and counts
    them as ``rows64_card``, instances x batch; ``rows64`` (the host's
    float64 rows) stays uncounted."""
    fn, _, _ = _run_path(path)
    host64 = problem_instance.ProblemInstance.compute_energy_host64
    called = []
    monkeypatch.setattr(problem_instance.ProblemInstance, "compute_energy_host64",
                        lambda self, confs: called.append(confs) or host64(self, confs))
    _, records, _ = _recorded(fn, tmp_path)
    (readout,) = [s for s in records if s.name == "ccvm.readout"]
    instances = len(SIZE20) if path == "dl-sweep" else 1
    assert readout.counts["rows64_card"] == instances * BATCH
    assert sum(s.counts.get("rows64_card", 0) for s in records) == instances * BATCH
    assert not called
    assert all("rows64" not in s.counts for s in records)


def test_nothing_recorded_and_no_region_opened_without_a_profiler(tmp_path, monkeypatch):
    opened = []
    region = torch.autograd.profiler.record_function

    def counted(name, *args):
        opened.append(name)
        return region(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    solver = _solver("mf")
    before = profiling.spans()
    inst = _instance(solver)
    solver(inst, post_processor="grad-descent", seed=1)
    sweep_solve(solver, [inst], seed=1, post_processor="grad-descent")
    assert opened == [] and profiling.spans() == before
    profiling.count("host_syncs")  # no span is open, and nothing is on
    _, records, _ = _recorded(lambda: solver(inst, seed=1), tmp_path)
    assert opened == [s.name for s in records] and opened[0] == "ccvm.call"


def test_the_chrome_trace_holds_every_span_with_its_nesting(tmp_path):
    solver = _solver("dl")
    insts = [_instance(solver, p) for p in SIZE20]

    def work():
        solver(insts[0], seed=2)
        sweep_solve(solver, insts, seed=2)
        with profiling.annotate("sleep"):
            time.sleep(0.02)

    _, records, events = _recorded(work, tmp_path)
    names = {s.name for s in records}
    marks = sorted((e for e in events if e.get("ph") == "X" and e.get("name") in names
                    and e.get("cat") == "user_annotation"),
                   key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in marks] == [s.name for s in records]
    event = {id(s): e for s, e in zip(records, marks)}
    for s in records:
        if s.parent is not None:
            outer, inner = event[id(s.parent)], event[id(s)]
            assert float(outer["ts"]) <= float(inner["ts"])
            assert float(inner["ts"]) + float(inner["dur"]) <= \
                float(outer["ts"]) + float(outer["dur"])
    (sleep,) = [s for s in records if s.name == "sleep"]
    assert 0.020 <= sleep.end - sleep.start <= 0.040
    assert 20_000 <= float(event[id(sleep)]["dur"]) <= 40_000
    assert sleep.cpu_s < 0.5 * (sleep.end - sleep.start)  # a sleep waits off the CPU


def test_annotated_spans_show_in_the_trace(tmp_path):
    solver = LangevinSolver(device="cpu", batch_size=8)
    solver.parameter_key = {20: {"dt": 0.002, "S": 0.5, "iterations": 4, "sigma": 0.5,
                                 "feedback_scale": 2.0}}
    inst = ProblemInstance(device="cpu", file_path=TEST020, instance_type="test")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, create_perfetto_link=True) as prof:
        with profiling.annotate("ccvm-solve"):
            sol = solver(inst, seed=0)
        with profiling.annotate("ccvm-readout"):
            sol.solution_performance
    assert np.isfinite(sol.objective_values).all()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ccvm-solve", "ccvm-readout"} <= names
    assert "ccvm-solve" in {e.key for e in prof.key_averages()}
