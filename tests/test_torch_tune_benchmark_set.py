"""``ccvm_tpu_torch/tools/tune_benchmark_set.py`` against
``tools/tune_benchmark_set.py`` (CPU).

Both tuners run at a toy size (the first two of three random instances at
each of N = 6 and 8, their optima at the best box vertex, batch 16, 60
steps) over their own grids with the noise off (the JAX draws patched to zeros, the port's plain
versions at ``noise_scale=0``): the same winners for every solver and size,
written as the JSON the study's ``--params`` reads.  A second run on a
subset of the sizes merges into the file instead of replacing it.
"""

from __future__ import annotations

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_examples import port_noise_off
from test_torch_sweep import _write_instance

from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu_torch.tools import tune_benchmark_set as tuner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (6, 8)
TOY = dict(per_size=2, iterations=60, tuning_batch_size=16, device="cpu")


def _load_jax_tuner():
    spec = importlib.util.spec_from_file_location(
        "jax_tune_benchmark_set", os.path.join(REPO, "tools", "tune_benchmark_set.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_tuner = _load_jax_tuner()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("tune")
    rng = np.random.RandomState(1)
    for n in SIZES:
        (root / f"Size{n}").mkdir()
        for k in range(3):
            _write_instance(root / f"Size{n}" / f"toy{n:03d}-{k}.in", rng, n)
    return str(root)


@pytest.fixture(scope="module")
def jax_table(folder, tmp_path_factory):
    """The JAX tuner's table at the toy size, noise off."""
    out = str(tmp_path_factory.mktemp("jax_tune") / "tuned.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
        jax.clear_caches()
        jax_tuner.main(instance_dir=folder, out_path=out, sizes=SIZES, **TOY)
    jax.clear_caches()
    with open(out) as f:
        return json.load(f)


@pytest.fixture
def noise_off(monkeypatch):
    """The port's plain versions at noise_scale 0."""
    port_noise_off(monkeypatch)


def test_tables_are_the_jax_tool_s():
    assert tuner.DEFAULTS == jax_tuner.DEFAULTS
    assert tuner.GRIDS == jax_tuner.GRIDS
    assert tuner.POST == jax_tuner.POST
    assert list(tuner.CLASSES) == list(jax_tuner.CLASSES)
    assert tuner.OUT_PATH == os.path.join(REPO, "build", "tuned_parameters_torch.json")
    assert tuner.INSTANCE_DIR == os.path.join(REPO, "examples", "benchmarking_instances")


def test_winners_equal_the_jax_tool_s_without_noise(folder, jax_table, tmp_path,
                                                     noise_off):
    out = tmp_path / "tuned.json"
    table = tuner.main(instance_dir=folder, out_path=str(out), sizes=SIZES, **TOY)
    with open(out) as f:
        assert json.load(f) == table
    assert table == jax_table
    assert sorted(table) == sorted(tuner.CLASSES)
    for name, by_size in table.items():
        assert sorted(by_size) == [str(n) for n in SIZES]
        for params in by_size.values():
            assert "iterations" not in params
            assert params.keys() == {**tuner.DEFAULTS[name], **tuner.GRIDS[name]}.keys()


def test_a_run_on_a_subset_of_sizes_merges(folder, tmp_path, noise_off):
    out = tmp_path / "tuned.json"
    kept = {"dl": {"99": {"pump": 1.0}}, "note": "kept"}
    out.write_text(json.dumps(kept))
    first = tuner.main(instance_dir=folder, out_path=str(out), sizes=(6,),
                       solvers=("langevin",), **TOY)
    assert first == {**kept, "langevin": {"6": first["langevin"]["6"]}}
    second = tuner.main(instance_dir=folder, out_path=str(out), sizes=(8,),
                        solvers=("langevin", "dl"), **TOY)
    assert second["note"] == "kept"
    assert sorted(second["langevin"]) == ["6", "8"]
    assert second["langevin"]["6"] == first["langevin"]["6"]
    assert sorted(second["dl"]) == ["8", "99"] and second["dl"]["99"] == {"pump": 1.0}
    with open(out) as f:
        assert json.load(f) == second
