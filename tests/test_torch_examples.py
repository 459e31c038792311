"""The single-instance example twins (``examples/torch_port/``) against the
JAX examples (CPU).

The JAX scripts have no ``main``: their solver class, batch size,
``parameter_key`` and post-processor are read from each script's source
(``ast``), and the test rebuilds their solve from them.  Both sides solve the
bundled N=20 test instance at a reduced iteration count with the noise off
(the JAX draws patched to zeros, the port's plain versions at
``noise_scale=0``): the statistics are equal and the objective values agree
to float32 round-off (rtol 1e-4).  The plot twin writes both PNGs.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ccvm_tpu
from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCE = os.path.join(REPO, "examples", "benchmarking_instances", "single_test_instance",
                        "tuningH020-100-0.in")
ITERS = 150
EXAMPLES = ("ccvm_boxqp_dl", "ccvm_boxqp_mf", "langevin_boxqp", "pumped_langevin_boxqp")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_port_{name}", os.path.join(REPO, "examples", "torch_port", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_script(name):
    """(solver class name, batch size, parameter_key, post-processor) as the
    JAX example's source states them."""
    with open(os.path.join(REPO, "examples", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "batch_size":
            found["batch"] = ast.literal_eval(node.value)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute) \
                and node.targets[0].attr == "parameter_key":
            found["key"] = ast.literal_eval(node.value)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            kw = {k.arg: k.value for k in node.keywords}
            if node.func.id.endswith("Solver"):
                found["cls"] = node.func.id
            elif node.func.id == "solver" and "post_processor" in kw:
                found["pp"] = ast.literal_eval(kw["post_processor"])
    return found["cls"], found["batch"], found["key"], found["pp"]


def port_noise_off(monkeypatch):
    """The port's four kernel wrappers at noise_scale 0 (on the CPU, their
    plain versions)."""
    for module, name in ((dl_kernels, "dl_solve"), (mf_kernels, "mf_solve"),
                         (langevin_kernels, "langevin_solve"),
                         (langevin_kernels, "pumped_langevin_solve")):
        monkeypatch.setattr(module, name,
                            functools.partial(getattr(module, name), noise_scale=0.0))


@pytest.fixture
def noise_off(monkeypatch):
    """The JAX draws patched to zeros, the port's plain versions at
    noise_scale 0."""
    monkeypatch.setattr(jcommon, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    port_noise_off(monkeypatch)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", EXAMPLES)
def test_twin_keeps_the_jax_script_s_configuration(name):
    twin = _load(name)
    cls, batch, key, pp = _jax_script(name)
    assert (twin.BATCH_SIZE, twin.PARAMETER_KEY, twin.POST_PROCESSOR) == (batch, key, pp)
    assert [c for c in ("DLSolver", "MFSolver", "LangevinSolver", "PumpedLangevinSolver")
            if hasattr(twin, c)] == [cls]
    assert twin.TEST_INSTANCES_PATH == os.path.dirname(INSTANCE)
    assert key[20]["iterations"] == 1500


@pytest.mark.parametrize("name", EXAMPLES)
def test_twin_equals_the_jax_example_without_noise(monkeypatch, noise_off, name):
    twin = _load(name)
    cls, batch, key, pp = _jax_script(name)
    short = {20: dict(key[20], iterations=ITERS)}
    monkeypatch.setattr(twin, "PARAMETER_KEY", short)
    ours = twin.main(device="cpu", seed=0)
    assert len(ours) == 1
    solver = getattr(ccvm_tpu, cls)(device="cpu", batch_size=batch)
    solver.parameter_key = short
    inst = ccvm_tpu.ProblemInstance(instance_type="test", file_path=INSTANCE, device="cpu")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    theirs = solver(instance=inst, post_processor=pp, seed=0)
    a, b = ours[0], theirs
    assert (a.problem_size, a.batch_size, a.iterations, a.instance_name) == \
        (b.problem_size, b.batch_size, b.iterations, b.instance_name) == \
        (20, batch, ITERS, "tuningH020-100-0")
    np.testing.assert_allclose(np.asarray(a.objective_values), np.asarray(b.objective_values),
                               rtol=1e-4)
    assert a.solution_performance == b.solution_performance
    assert a.best_objective_value == pytest.approx(b.best_objective_value, rel=1e-4)
    assert np.all(np.isfinite(a.objective_values))


def test_plot_twin_writes_both_pngs(monkeypatch, tmp_path):
    twin = _load("ccvm_boxqp_plot")
    cls, batch, key, pp = _jax_script("ccvm_boxqp_plot")
    assert (cls, twin.BATCH_SIZE, twin.PARAMETER_KEY, pp) == ("DLSolver", batch, key, None)
    monkeypatch.setattr(twin, "PARAMETER_KEY", {20: dict(key[20], iterations=ITERS)})
    tts, ets = twin.main(device="cpu", out_dir=str(tmp_path), seed=0)
    assert (tts, ets) == (str(tmp_path / "plots" / "DL-CCVM_TTS_cuda_plot.png"),
                          str(tmp_path / "plots" / "DL-CCVM_ETS_cuda_plot.png"))
    for path in (tts, ets):
        assert os.path.getsize(path) > 0
    assert os.listdir(tmp_path / "metadata") == ["metadata.json"]
