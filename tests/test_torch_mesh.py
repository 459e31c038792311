"""The port's meshes and data parallelism over gloo (CPU).

One world of two ranks (``tests/torch_ranks.py``, spawned once for the
module) runs the checks; each test reads its part of the result.  Data
parallel: each rank runs the whole-solve kernel's plain version on its rows
(the Philox counter's row offset set to its first global row) and the state
is all-gathered, so the four façades, evolution sampling, a (batch, n) S,
the sweep and the study equal the single-process run bit for bit, noise on.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
from jax.experimental import multihost_utils
from test_torch_sweep import _write_instance
from torch_ranks import FACADE_KEYS, data_parallel, spawn, study_argv

from ccvm_tpu.parallel import make_mesh as jax_make_mesh
from ccvm_tpu_torch.parallel import make_batch_mesh, make_mesh, multihost

WORLD = 2


def _load_study():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "mesh_study", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "torch_port", "benchmarking_study.py"))
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    return study


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's results, the study's folder) of the two-rank world."""
    root = tmp_path_factory.mktemp("mesh")
    rng = np.random.RandomState(0)
    files = [_write_instance(root / f"i{k}.in", rng) for k in range(2)]
    for n in (6, 8):
        (root / "instances" / f"Size{n}").mkdir(parents=True)
        for k in range(2):
            _write_instance(root / "instances" / f"Size{n}" / f"toy{n:03d}-{k}.in", rng, n)
    return spawn(data_parallel, WORLD, root, files, str(root)), str(root)


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_batch_mesh()


def test_meshes_have_the_jax_package_s_axes(world):
    ranks, _ = world
    jmesh = jax_make_mesh(WORLD)
    for r in ranks:
        assert r["mesh"] == (tuple(jmesh.axis_names), tuple(jmesh.devices.shape), "cpu")
        assert r["global mesh"] == (("batch",), (WORLD,))


def test_make_mesh_rejects_a_tp_that_does_not_divide(world):
    ranks, _ = world
    with pytest.raises(ValueError) as jax_error:
        jax_make_mesh(WORLD, tp=3)
    for r in ranks:
        assert r["tp=3"] == str(jax_error.value) == f"tp=3 must divide the device count {WORLD}"


@pytest.mark.parametrize("cls_name", sorted(FACADE_KEYS))
def test_data_parallel_facade_equals_one_process(world, cls_name):
    ranks, _ = world
    assert all(r[f"dp {cls_name}"] for r in ranks)


def test_data_parallel_evolution_sampling_equals_one_process(world):
    ranks, _ = world
    for r in ranks:
        for a, b in zip(r["evolution dp"], r["evolution one"]):
            assert np.array_equal(a, b)


def test_data_parallel_per_element_s_equals_one_process(world):
    ranks, _ = world
    for r in ranks:
        assert np.array_equal(r["per-element S dp"], r["per-element S one"])


def test_sweep_over_a_mesh_equals_one_process(world):
    """Two instances, one a rank, each keeping seed + i by its global
    index; every rank holds every Solution."""
    ranks, _ = world
    for r in ranks:
        assert len(r["sweep dp"]) == len(r["sweep one"]) == 2
        for (x_dp, e_dp), (x_one, e_one) in zip(r["sweep dp"], r["sweep one"]):
            assert np.array_equal(x_dp, x_one) and np.array_equal(e_dp, e_one)


def test_tp_matvec_equals_the_dense_matvec_at_tp_2(world):
    ranks, _ = world
    for r in ranks:
        assert r["tp_matvec"] <= 1e-5 and r["tp step"] <= 1e-6


def test_tensor_parallel_facade_raises_for_a_per_variable_s(world):
    ranks, _ = world
    for r in ranks:
        assert "require a scalar S" in r["tp per-variable S"]


def test_process_allgather_and_shard_bounds(world):
    ranks, _ = world
    for rank, r in enumerate(ranks):
        assert r["allgather"].tolist() == [0, 10]
        assert r["allgather tiled"].tolist() == [[0] * 3] * 2 + [[1] * 3] * 2
        assert r["shard bounds"] == ((0, 3), (3, 5))[rank]


def test_process_allgather_of_one_process_is_jax_s():
    """Without a process group the gathers shape as the JAX helper's do on
    one process."""
    assert jax.process_count() == 1
    for x, tiled in ((2.5, False), (np.arange(6.0).reshape(2, 3), False),
                     (np.arange(6.0).reshape(2, 3), True)):
        ours = multihost.process_allgather(x, tiled=tiled)
        theirs = np.asarray(multihost_utils.process_allgather(x, tiled=tiled))
        assert ours.shape == theirs.shape and np.array_equal(ours, theirs)


def test_study_over_a_mesh_equals_one_process(world):
    """The study's --mesh 2, as two torchrun processes run it, against one
    process without a mesh: the summary and the coordinator's metadata are
    the same apart from the times, and the best objective values to
    float32 round-off: at the toy's N=6 the CPU's matmul sums a row of 8
    rows' product in another order than of 16 rows' (measured: 4.8e-7 on
    random data; from N=8 on, and at every size for 16 rows or more, the
    same bits), which the façade tests above at batch 64 do not meet.  The
    other rank writes no metadata, and the study ends its process group."""
    ranks, root = world
    study = _load_study()
    one = study.run_sweep(study.parse_args(study_argv(root, "one")))
    for r in ranks:
        assert [row[:4] for row in r["study"]] == [row[:4] for row in one]
        assert r["study group ended"]
    names = sorted(os.listdir(os.path.join(root, "mesh")))
    assert names == sorted(os.listdir(os.path.join(root, "one")))

    def untimed(path):
        with open(path) as f:
            meta = json.load(f)
        best = []
        for row in meta["result_metadata"]:
            for key in ("solve_time", "pp_time"):
                row.pop(key)
            best.append(row.pop("best_objective_value"))
        return meta, np.array(best)

    for name in names:
        (meta, best), (meta_one, best_one) = (untimed(os.path.join(root, d, name))
                                              for d in ("mesh", "one"))
        assert meta == meta_one
        np.testing.assert_allclose(best, best_one, rtol=1e-6)
