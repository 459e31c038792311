"""``examples/torch_port/benchmarking_study.py`` against
``examples/benchmarking_study.py`` (CPU).

Both scripts are loaded by path, as ``tests/test_torch_bench.py`` loads
``bench_torch.py``, and run on a toy instance folder (sizes 6 and 8, two
random instances each, optima at the best box vertex), batch 16, 60 steps,
with a parameter file, on the ``--sweep`` path and on the serial one.  The
noise is off on both sides (the JAX draws patched to zeros, the port's
plain versions at ``noise_scale=0``), so both runs solve the same dynamics:
each solver's metadata JSON and the summary are equal apart from the times,
with objective values to float32 round-off (rtol 1e-4).  The JAX side runs
once per module: its compiles are what cost time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed
from test_torch_examples import port_noise_off
from test_torch_sweep import _write_instance

from ccvm_tpu import runtime as jruntime
from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu_torch.solvers import DLSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (6, 8)
SOLVERS = "dl,mf,langevin,pumped"
ITERS = 60
BATCH = 16
# Toy-size parameters that move in 60 steps (tests/test_torch_sweep.py's).
PARAMS = {
    "dl": {"pump": 2.0, "feedback_scale": 10, "dt": 0.01, "noise_ratio": 10},
    "mf": {"pump": 0.0, "feedback_scale": 50, "j": 5.0, "S": 2.0, "dt": 0.01},
    "langevin": {"dt": 0.02, "S": 0.5, "sigma": 0.5, "feedback_scale": 1.0},
    "pumped": {"pump": 2.0, "dt": 0.02, "S": 0.5, "sigma": 0.5, "feedback_scale": 1.0},
}
TIMES = ("solve_time", "pp_time")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_study = _load("jax_benchmarking_study", "examples/benchmarking_study.py")
study = _load("torch_benchmarking_study", "examples/torch_port/benchmarking_study.py")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(instance folder, parameter file) of the toy study."""
    root = tmp_path_factory.mktemp("study")
    rng = np.random.RandomState(0)
    for n in SIZES:
        (root / f"Size{n}").mkdir()
        for k in range(2):
            _write_instance(root / f"Size{n}" / f"toy{n:03d}-{k}.in", rng, n)
    params = root / "params.json"
    params.write_text(json.dumps({s: {str(n): p for n in SIZES} for s, p in PARAMS.items()}))
    return str(root), str(params)


def _args(toy, out, sweep, **extra):
    """The JAX script's namespace (its parser sits under its __main__)."""
    folder, params = toy
    return argparse.Namespace(
        instances_dir=folder, solvers=SOLVERS, sizes=",".join(map(str, SIZES)),
        batch_size=BATCH, iterations=ITERS, post_processor="grad-descent",
        output_dir=str(out), plots=False, mesh=0, sweep=sweep, seed=3,
        optima_override="", params=params, **extra)


def _argv(toy, out, sweep, *extra):
    folder, params = toy
    return (["--instances-dir", folder, "--solvers", SOLVERS, "--sizes",
             ",".join(map(str, SIZES)), "--batch-size", str(BATCH), "--iterations",
             str(ITERS), "--output-dir", str(out), "--seed", "3", "--params", params,
             "--device", "cpu"] + (["--sweep"] if sweep else []) + list(extra))


@pytest.fixture(scope="module")
def jax_runs(toy, tmp_path_factory):
    """The JAX script's summaries and output folders, sweep and serial, with
    the noise off; its compilation cache (under the home folder) left
    alone."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
        mp.setattr(jruntime, "enable_compilation_cache", lambda *a, **k: None)
        jax.clear_caches()
        for sweep in (True, False):
            folder = tmp_path_factory.mktemp(f"jax_{'sweep' if sweep else 'serial'}")
            out[sweep] = (jax_study.run_sweep(_args(toy, folder, sweep)), folder)
    jax.clear_caches()
    return out


@pytest.fixture
def noise_off(monkeypatch):
    """The port's plain versions at noise_scale 0."""
    port_noise_off(monkeypatch)


def _metadata(folder, name):
    with open(os.path.join(folder, f"{name}_benchmark.json")) as f:
        return json.load(f)


def _same_apart_from_times(ours, theirs):
    assert ours.keys() == theirs.keys() and ours["device"] == theirs["device"] == "cpu"
    assert len(ours["result_metadata"]) == len(theirs["result_metadata"]) == 2 * len(SIZES)
    for a, b in zip(ours["result_metadata"], theirs["result_metadata"], strict=True):
        assert a.keys() == b.keys()
        assert all(a[t] > 0 or t == "pp_time" for t in TIMES)
        for key in a.keys() - set(TIMES):
            if key in ("best_objective_value", "optimal_value", "best_value"):
                assert a[key] == pytest.approx(b[key], rel=1e-4), key
            else:
                assert a[key] == b[key], key


def _summaries_equal(ours, theirs):
    assert [row[:4] for row in ours] == [row[:4] for row in theirs]
    assert len(ours) == 4 * len(SIZES) and all(row[4] > 0 for row in ours)


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "serial"])
def test_study_equals_the_jax_script_without_noise(toy, jax_runs, tmp_path, noise_off,
                                                   sweep):
    failed = {}
    summary = study.run_sweep(study.parse_args(_argv(toy, tmp_path, sweep)), failed)
    theirs, folder = jax_runs[sweep]
    _summaries_equal(summary, theirs)
    for name in SOLVERS.split(","):
        _same_apart_from_times(_metadata(tmp_path, name), _metadata(folder, name))
    assert failed == {(s, n): {} for s in SOLVERS.split(",") for n in SIZES}
    # Some statistic is neither 0 nor 1 across the toy set, so the
    # comparison reads a real result.
    p = [row[3] for row in summary]
    assert 0 < np.mean(p) < 1


def test_sweep_and_serial_paths_agree(jax_runs):
    """The JAX script's two paths give one summary (noise off): the toy
    comparison above holds both to the same result."""
    _summaries_equal(jax_runs[True][0], jax_runs[False][0])


def test_flags_and_tables_are_the_jax_script_s():
    args = study.parse_args([])
    assert (args.solvers, args.sizes, args.batch_size, args.iterations,
            args.post_processor, args.output_dir, args.mesh, args.seed,
            args.sweep, args.plots, args.params, args.optima_override) == (
        "dl,mf,langevin,pumped", "20,30,40,50,60,70", 1000, 15000, "grad-descent",
        "./metadata", 0, 0, False, False, "", "")
    assert args.instances_dir == os.path.join(REPO, "examples", "benchmarking_instances")
    assert args.device is None
    assert study.DEFAULTS == jax_study.DEFAULTS
    assert study.MACHINES == jax_study.MACHINES
    assert study.ENERGY_MACHINES == jax_study.ENERGY_MACHINES
    assert list(study.SOLVER_CLASSES) == list(jax_study.SOLVER_CLASSES)
    for name in study.SOLVER_CLASSES:
        ours = study.build_solver(name, "cpu", 16, [20, 70], 100, tuned={name: {
            "70": {"dt": 0.5}}})
        theirs = jax_study.build_solver(name, "cpu", 16, [20, 70], 100, tuned={name: {
            "70": {"dt": 0.5}}})
        assert ours.parameter_key == theirs.parameter_key
        assert type(ours).__name__ == type(theirs).__name__


def test_mesh_of_one_rank_equals_the_jax_script_without_noise(toy, jax_runs, tmp_path,
                                                              noise_off, monkeypatch):
    """``--mesh 1`` outside torchrun: the study starts a one-rank world
    (gloo with ``--device cpu``), shards every solve over its mesh and ends
    the world; with the noise off it equals the JAX script's study, whose
    one-device mesh solves as no mesh does."""
    monkeypatch.delenv("RANK", raising=False)
    summary = study.run_sweep(study.parse_args(_argv(toy, tmp_path, True, "--mesh", "1")))
    assert not torch.distributed.is_initialized()
    theirs, folder = jax_runs[True]
    _summaries_equal(summary, theirs)
    for name in SOLVERS.split(","):
        _same_apart_from_times(_metadata(tmp_path, name), _metadata(folder, name))


def test_override_below_the_optimum_raises_the_jax_error(toy, tmp_path):
    folder, _ = toy
    name = sorted(os.listdir(os.path.join(folder, "Size6")))[0][:-3]
    override = tmp_path / "override.json"
    override.write_text(json.dumps({f"Size6/{name}": -1e6}))
    ours = study.parse_args(_argv(toy, tmp_path / "ours", True, "--optima-override",
                                  str(override)))
    theirs = _args(toy, tmp_path / "theirs", True)
    theirs.optima_override = str(override)
    errors = []
    for script, args in ((study, ours), (jax_study, theirs)):
        with pytest.raises(ValueError, match="is BELOW the file's own optimum") as e:
            script.run_sweep(args)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_a_solve_that_fails_once_is_retried(toy, tmp_path, monkeypatch, capsys):
    """The serial path re-queues a failed solve (run_resilient): the run
    reports no failure, and its metadata equals an undisturbed run's."""
    clean = tmp_path / "clean"
    study.run_sweep(study.parse_args(_argv(toy, clean, False, "--solvers", "dl")))
    call = DLSolver.__call__
    calls = []

    def fails_once(self, *args, **kwargs):
        calls.append(kwargs.get("seed"))
        if len(calls) == 2:
            raise RuntimeError("a transient failure")
        return call(self, *args, **kwargs)

    monkeypatch.setattr(DLSolver, "__call__", fails_once)
    failed = {}
    retried = tmp_path / "retried"
    summary = study.run_sweep(study.parse_args(_argv(toy, retried, False, "--solvers",
                                                     "dl")), failed)
    assert failed == {("dl", n): {} for n in SIZES}
    assert "FAILED" not in capsys.readouterr().out
    # The second solve (instance 1 of the first size, seed 3 + 1) ran again
    # after the size's other instances.
    assert calls[:3] == [3, 4, 4] and len(calls) == 2 * len(SIZES) + 1
    assert [row[2] for row in summary] == [2, 2]
    ours, clean_rows = _metadata(retried, "dl"), _metadata(clean, "dl")
    for a, b in zip(ours["result_metadata"], clean_rows["result_metadata"], strict=True):
        assert {k: v for k, v in a.items() if k not in TIMES} == \
            {k: v for k, v in b.items() if k not in TIMES}


def test_plots_are_written(tmp_path, capsys):
    """``--plots`` writes each solver's three PNGs, or says why one was
    skipped (the JAX script's ValueError), on two bundled instances of each
    of two sizes that the machine models know."""
    folder = tmp_path / "instances"
    for n in (20, 30):
        (folder / f"Size{n}").mkdir(parents=True)
        for k in range(2):
            name = f"tuningH0{n}-100-{k}.in"
            (folder / f"Size{n}" / name).write_bytes(open(os.path.join(
                REPO, "examples", "benchmarking_instances", f"Size{n}", name), "rb").read())
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"langevin": {str(n): PARAMS["langevin"]
                                               for n in (20, 30)}}))
    out = tmp_path / "out"
    study.run_sweep(study.parse_args(
        ["--instances-dir", str(folder), "--solvers", "langevin", "--sizes", "20,30",
         "--batch-size", str(BATCH), "--iterations", str(ITERS), "--output-dir",
         str(out), "--params", str(params), "--device", "cpu", "--sweep", "--plots"]))
    printed = capsys.readouterr().out
    written = 0
    for kind in ("TTS", "success_prob", "ETS"):
        path = out / f"langevin_{kind}.png"
        if path.exists():
            written += path.stat().st_size > 0
        else:
            assert f"[langevin] {kind.replace('_prob', '-prob')} plot skipped" in printed
    assert written >= 2, printed
