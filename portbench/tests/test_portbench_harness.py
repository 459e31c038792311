"""The benchmark's files, its contract, its arithmetic and its isolation."""

import ast
import json
import os
import re
import statistics

import numpy as np
import pytest
import torch

from portbench import generator, roofline, spec, spread, window
from portbench.reference import philox as ref_philox

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = spec.cell(name)
    config = cell["config"]
    assert cell["entry"]["config"] == config["name"]
    assert os.path.isfile(os.path.join(roofline.KERNELS, f"{config['kernel']}.json"))
    assert os.path.isfile(os.path.join(spec.HERE, "reference", f"{config['family']}.py"))
    files = spec.instance_files(config)
    assert spec.instance_digest(files) == config["instances"]["sha256"]
    assert all(len(files[s]) == config["instances"]["per_size"] for s in files)
    assert set(cell["workload"]["limits"]) <= {"state_gap", "pv_gap", "energy_gap",
                                                "stats_mismatch"}
    for kind in ("end_to_end", "per_layer"):
        for m in cell["metrics"][kind]:
            reader = m["name"].split(".")[0]
            assert os.path.isfile(os.path.join(spec.HERE, "metrics", f"{reader}.py"))


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1].startswith("portbench/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits: 2 + 14 cells runs, 2 x 90 s a cell, 1200 s spare.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[kind]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and cell in moves.get("workloads", CELLS)
    for cell in CELLS:
        reported = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(spec.HERE, sub)):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "ccvm_tpu", "bench"}
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & forbidden, (path, tops & forbidden)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "ccvm_tpu_torch" not in tops and not tops & {"jax", "ccvm_tpu"}, path


def test_top_level_names_are_compared_whole():
    import importlib.util

    run_spec = importlib.util.spec_from_file_location("pb_run", os.path.join(spec.HERE, "run.py"))
    run = importlib.util.module_from_spec(run_spec)
    run_spec.loader.exec_module(run)
    import sys

    assert "ccvm_tpu_torch" not in run.forbidden_modules()
    assert not any(name.split(".")[0] == "ccvm_tpu" for name in sys.modules) or \
        "ccvm_tpu" in run.forbidden_modules()


def test_roofline_at_the_main_shape():
    dl, by = roofline.least_seconds("dl_solve_kernel", instances=1, batch=65536, n=70,
                                    iterations=15000)
    assert by == "fp32 elementwise" and round(1e3 * dl, 1) == 41.1
    mf, by = roofline.least_seconds("mf_solve_kernel", instances=1, batch=65536, n=70,
                                    iterations=15000)
    assert by == "fp32 elementwise" and round(1e3 * mf, 1) == 45.3
    # The TF32 matvec floor: DL's two matvecs at one TF32 pass.
    assert 2 * 2 * 65536 * 70 * 70 * 15000 / roofline.TF32_PEAK == pytest.approx(0.03895, 1e-3)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_counts_every_call_and_every_second_with_a_stall():
    clock = FakeClock()
    walls = [0.5] * 4 + [3.0] + [0.5] * 4 + [3.0] + [0.5] * 100
    calls = [generator.Call(index=i, size=70, files=("f",), seed=i, batch=10,
                            entry="facade", load_in_call=False) for i in range(len(walls))]

    def execute(call):
        clock.t += walls[call.index]
        return {"work": 1000.0}

    win = window.run(calls, execute, 12.0, clock=clock)
    # Two stalls of 3 s among calls of 0.5 s; the last call starts at 11.5 s
    # and the window closes with it at 12 s: 14 calls.
    assert len(win.calls) == 14 and win.seconds == pytest.approx(12.0)
    assert window.rate(win) == pytest.approx(14 * 1000.0 / 12.0)
    p90 = window.percentile([c.wall for c in win.calls], 90)
    assert p90 == pytest.approx(0.5 + 0.7 * 2.5)  # the stalls lift the tail
    # The last call crosses the nominal end: the window runs to its end.
    clock.t = 0.0
    walls[:] = [0.7] * 50
    win = window.run(calls, execute, 2.0, clock=clock)
    assert len(win.calls) == 3 and win.seconds == pytest.approx(2.1)


def test_a_failed_call_counts_as_attempted_and_not_as_work():
    clock = FakeClock()
    calls = [generator.Call(i, 70, ("f",), i, 10, "facade", False) for i in range(20)]

    def execute(call):
        clock.t += 1.0
        if call.index == 1:
            raise RuntimeError("planted")
        return {"work": 10.0}

    win = window.run(calls, execute, 3.0, clock=clock)
    assert len(win.calls) == 3 and len(win.done) == 2
    assert window.rate(win) == pytest.approx(20.0 / 3.0)


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [1.0, 1.02, 0.99, 1.01, 1.03, 0.98]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert spread.spread(vals) == pytest.approx((q3 - q1) / statistics.median(vals))
    assert spread.spread(vals) == pytest.approx(0.035 / 1.005)
    # Without the run farthest from the median, one far-off run does no harm.
    assert spread.spread(vals + [2.0], drop_farthest=True) == pytest.approx(spread.spread(vals))


@pytest.mark.parametrize("traffic", ["main_loop", "study_loop"])
def test_every_seed_sends_the_same_work_in_another_order(traffic):
    mix = spec.load_json(os.path.join(spec.HERE, "traffic", f"{traffic}.json"))
    files = {s: [f"Size{s}/{i}.in" for i in range(50)] for s in mix["sizes"]}
    a = generator.plan(mix, files, 11, 600)
    b = generator.plan(mix, files, 2**31 + 5, 600)
    assert generator.plan(mix, files, 11, 600) == a
    per = len(mix["sizes"]) * (50 // mix["instances_per_call"])
    for plan in (a, b):
        for k in range(0, 600 - per + 1, per):  # whole passes hold the same work
            chunk = plan[k:k + per]
            assert sorted(f for c in chunk for f in c.files) == \
                sorted(f for s in mix["sizes"] for f in files[s])
    assert [c.files for c in a] != [c.files for c in b]
    assert a[3].seed == 11 + 1000 * 3


def test_philox_copy_draws_what_the_port_draws():
    from ccvm_tpu_torch.ops import philox as port

    rows = torch.tensor([0, 5, 1000, 65535])
    for seed in (0, 7, 2**31 + 11, 2**40 + 3):
        steps = torch.tensor([0, 1, 14999])
        w = ref_philox.words(torch.tensor([seed]), steps, rows[None], 70)
        for t, step in enumerate(steps.tolist()):
            z1, z2 = port.wiener_pair(seed, step, rows, 70, "popcount16")
            r1, r2 = ref_philox.popcount16_pair(w[t, 0])
            assert torch.equal(z1, r1) and torch.equal(z2, r2)
            one = port.wiener_one(seed, step, rows, 70, "popcount32")
            assert torch.equal(one, ref_philox.popcount32_one(w[t, 0]))


def test_configs_hold_the_tuned_parameters():
    tuned = json.load(open(os.path.join(spec.ROOT, "examples", "tuned_parameters.json")))
    for name, fam in (("dl-ccvm-boxqp", "dl"), ("mf-ccvm-boxqp-gd", "mf")):
        config = spec.load_json(os.path.join(spec.HERE, "configs", f"{name}.json"))
        assert config["iterations"] == 15000
        for size, params in config["parameters"].items():
            assert params == {k: tuned[fam][size][k] for k in params}


def test_trace_reduction_on_a_synthetic_trace():
    from portbench import tracing

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [ev("portbench.call", "user_annotation", 0, 100),
              ev("portbench.load", "user_annotation", 0, 20),
              ev("aten::to", "cpu_op", 5, 10),
              ev("portbench.solve", "user_annotation", 20, 80),
              ev("dl_solve_kernel<9>", "kernel", 25, 60),
              ev("Memcpy DtoH", "gpu_memcpy", 80, 10),  # overlaps the kernel
              ev("portbench.call", "user_annotation", 110, 50),
              ev("dl_solve_kernel<9>", "kernel", 120, 30),
              ev("before the window", "kernel", -50, 20)]
    t = tracing.reduce(events)
    assert t.window_s == pytest.approx(160e-6)
    assert t.busy_s == pytest.approx((90 - 25 + 30) * 1e-6)  # the union, clipped
    assert t.device_seconds("dl_solve_kernel") == pytest.approx(90e-6)
    assert t.device_seconds("no such kernel") is None
    gaps = dict(t.idle_gaps)
    assert gaps == pytest.approx({"portbench.load / aten::to": 25e-6,
                                  "(between calls)": 30e-6, "portbench.call": 10e-6})
    assert sum(gaps.values()) + t.busy_s == pytest.approx(t.window_s)
