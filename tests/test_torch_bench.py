"""``bench_torch.py``, the port's ``bench.py``, against ``bench.py`` (CPU).

Both are loaded by path, as ``tests/unit/test_bench_device_rate.py`` loads
``bench.py``.  The workload (sizes, batches, iterations, tuned parameters),
the baseline and the metric name are ``bench.py``'s; the TTS column reads
the committed sweep through the port's ``ccvmplotlib`` and equals
``bench.py``'s for every solver; ``_device_rate`` reaches into each port
façade's ``_make_params`` / ``_solve``, so a signature change fails here
and not on the card.  ``main`` runs end to end on the CPU at a toy size with
the device, the card's name and ``nvidia-smi`` stood in for, and raises
without a card otherwise.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ccvm_tpu
import ccvm_tpu_torch
from ccvm_tpu_torch import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench = _load("bench")
bench_torch = _load("bench_torch")

N = 8
PARAMS = {
    "dl": {"pump": 2.0, "feedback_scale": 10, "dt": 0.01, "noise_ratio": 10,
           "iterations": 20},
    "mf": {"pump": 0.0, "feedback_scale": 50, "j": 5.0, "S": 2.0, "dt": 0.01,
           "iterations": 20},
    "langevin": {"dt": 0.02, "S": 0.5, "sigma": 0.5, "feedback_scale": 1.0,
                 "iterations": 20},
    "pumped": {"pump": 2.0, "dt": 0.02, "S": 0.5, "sigma": 0.5,
               "feedback_scale": 1.0, "iterations": 20},
}
CLASSES = {"dl": "DLSolver", "mf": "MFSolver", "langevin": "LangevinSolver",
           "pumped": "PumpedLangevinSolver"}


def _instance(tmp_path):
    rng = np.random.RandomState(0)
    a = rng.randn(N, N)
    q = (a + a.T) / 2
    v = rng.randn(N)
    lines = [f"{N}\t10.0\t9.0\t90.0\t0.1\t0.1\t0\t0\n"]
    lines.append("\t".join(f"{x:.6f}" for x in v) + "\n")
    for row in q:
        lines.append("\t".join(f"{x:.6f}" for x in row) + "\n")
    path = tmp_path / "i.in"
    path.write_text("".join(lines))
    return ccvm_tpu_torch.ProblemInstance(instance_type="tuning", file_path=str(path),
                                          device="cpu")


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_device_rate_matches_facade_signatures(name, tmp_path):
    solver = getattr(ccvm_tpu_torch, CLASSES[name])(device="cpu", batch_size=16)
    solver.parameter_key = {N: dict(PARAMS[name])}
    inst = _instance(tmp_path)
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    rate = bench_torch._device_rate(name, solver, inst, dict(PARAMS[name]), reps=2)
    assert np.isfinite(rate) and rate > 0


def test_workload_baseline_and_metric_are_bench_py_s():
    for attr in ("ITERATIONS", "BATCH", "SIZES", "HEADLINE_N", "HEADLINE_BATCH",
                 "BASELINE_WALL_S", "BASELINE_RATE", "DEFAULTS", "MACHINES"):
        assert getattr(bench_torch, attr) == getattr(bench, attr), attr
    for solver in bench.DEFAULTS:
        for size in bench.SIZES + (100,):
            assert bench_torch._tuned_params(size, solver) == \
                bench._tuned_params(size, solver), (solver, size)
    assert bench_torch.metric_name() == (
        f"dl_ccvm_sde_throughput_n{bench.HEADLINE_N}_b{bench.HEADLINE_BATCH}"
        f"_i{bench.ITERATIONS}")
    for size in bench.SIZES:
        assert bench_torch._first_instance(size) == bench._first_instance(size)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_tts_at_optimal_equals_bench_py_s(name):
    j = getattr(ccvm_tpu, CLASSES[name])(device="cpu")
    t = getattr(ccvm_tpu_torch, CLASSES[name])(device="cpu")
    j.parameter_key = t.parameter_key = {70: bench._tuned_params(70, name)}
    expected = bench._tts_at_optimal(name, j, 70)
    assert expected is not None
    assert bench_torch._tts_at_optimal(name, t, 70) == expected
    assert bench_torch._tts_cell(name, t, 70) == (
        "inf" if expected == float("inf") else f"{expected:.4g}")
    assert bench_torch._tts_at_optimal(name, t, 75) is None


def test_tts_column_without_pandas(monkeypatch):
    """On a host without pandas the column reads "n/a (no pandas)";
    another missing module still raises."""
    for mod in list(sys.modules):
        if mod.startswith("ccvm_tpu_torch.ccvmplotlib"):
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "pandas", None)
    solver = ccvm_tpu_torch.DLSolver(device="cpu")
    assert bench_torch._tts_cell("dl", solver, 70) == "n/a (no pandas)"

    def no_scipy(*_):
        raise ModuleNotFoundError("No module named 'scipy'", name="scipy")

    monkeypatch.setattr(bench_torch, "_tts_at_optimal", no_scipy)
    with pytest.raises(ModuleNotFoundError):
        bench_torch._tts_cell("dl", solver, 70)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_torch.main()
    res = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")],
                         capture_output=True, text=True, timeout=120, cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout == "", res.stdout + res.stderr


def test_main_end_to_end_at_a_toy_size(monkeypatch, capsys):
    """main's control flow on the CPU: the device, the card's name and
    nvidia-smi stood in for, the workload cut to N=20, 20 iterations and
    batches of 8 and 16."""
    monkeypatch.setattr(runtime, "default_device", lambda: "cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "a stand-in card")
    monkeypatch.setattr(bench_torch.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, "a stand-in card, 1 W\n", ""))
    for attr, value in (("ITERATIONS", 20), ("BATCH", 8), ("SIZES", (20,)),
                        ("HEADLINE_N", 20), ("HEADLINE_BATCH", 16)):
        monkeypatch.setattr(bench_torch, attr, value)
    bench_torch.main()
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == "dl_ccvm_sde_throughput_n20_b16_i20"
    assert result["unit"] == "trajectory-iterations/s"
    assert result["value"] > 0 and result["device_amortised_rate"] > 0
    assert result["vs_baseline"] == round(result["value"] / bench.BASELINE_RATE, 2)
    err = err.splitlines()
    assert err[0] == "a stand-in card, 1 W"
    for name in CLASSES:
        row = [ln for ln in err if ln.startswith(f"# {name} ")]
        assert len(row) == 1 and "n/a" not in row[0], err
