"""The port stands alone: no JAX and no ccvm_tpu anywhere, pandas and
matplotlib only in its host-only plotting package; its kernels build only
with nvcc and never fall back (CPU)."""

from __future__ import annotations

import ast
import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.dynamics.langevin import LangevinParams
from ccvm_tpu_torch.dynamics.mf import MFParams
from ccvm_tpu_torch.dynamics.pumped_langevin import PumpedLangevinParams
from ccvm_tpu_torch.ops import (build, dl_kernels, dl_variant_kernels,
                                langevin_kernels, mf_kernels)
from ccvm_tpu_torch.tools import kernel_experiments

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ccvm_tpu_torch")


def test_import_leaves_jax_ccvm_tpu_pandas_matplotlib_out():
    code = (
        "import sys, ccvm_tpu_torch, ccvm_tpu_torch.interop;"
        "import ccvm_tpu_torch.ops.dl_kernels, ccvm_tpu_torch.ops.build;"
        "import ccvm_tpu_torch.ops.mf_kernels, ccvm_tpu_torch.solvers.mf;"
        "import ccvm_tpu_torch.ops.langevin_kernels, ccvm_tpu_torch.solvers.langevin;"
        "import ccvm_tpu_torch.solvers.pumped_langevin;"
        "import ccvm_tpu_torch.dynamics.langevin, ccvm_tpu_torch.dynamics.pumped_langevin;"
        "import ccvm_tpu_torch.post_processor;"
        "import ccvm_tpu_torch.ops.dl_variant_kernels, ccvm_tpu_torch.tools.kernel_experiments;"
        "import ccvm_tpu_torch.post_processor.adam, ccvm_tpu_torch.post_processor.asgd;"
        "import ccvm_tpu_torch.post_processor.bfgs, ccvm_tpu_torch.post_processor.lbfgs;"
        "import ccvm_tpu_torch.ops.lbfgs, ccvm_tpu_torch.metadata, ccvm_tpu_torch.tools.lbfgs_race;"
        "import ccvm_tpu_torch.ccvmplotlib.utils.sampleTTSmetric;"
        "import ccvm_tpu_torch.parallel, ccvm_tpu_torch.parallel.sweep, ccvm_tpu_torch.tuning;"
        "import ccvm_tpu_torch.checkpoint, ccvm_tpu_torch.profiling;"
        "import ccvm_tpu_torch.parallel.multihost, ccvm_tpu_torch.tools.tune_benchmark_set;"
        "import ccvm_tpu_torch.parallel.mesh, ccvm_tpu_torch.parallel.tp;"
        "import ccvm_tpu_torch.tools.multihost_smoke;"
        "import ccvm_tpu_torch.native, ccvm_tpu_torch.tools.validate;"
        "import ccvm_tpu_torch.tools.breakdown, ccvm_tpu_torch.tools.build_docs;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ccvm_tpu', 'pandas', 'matplotlib')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


PLOTTING = os.path.join(PKG, "ccvmplotlib")
BENCH = os.path.join(REPO, "bench_torch.py")
BUILD_DOCS = os.path.join(PKG, "tools", "build_docs.py")
SCRIPTS = os.path.join(REPO, "examples", "torch_port")
SCRIPT_NAMES = ("benchmarking_study", "ccvm_boxqp_dl", "ccvm_boxqp_mf", "langevin_boxqp",
                "pumped_langevin_boxqp", "ccvm_boxqp_plot", "tensor_parallel_boxqp")


def _port_python_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield BENCH


def _foreign(name, path, in_function):
    """jax and ccvm_tpu are foreign everywhere; pandas and matplotlib
    everywhere but in the plotting package, and matplotlib but inside a
    function of the documentation tool (its diagrams)."""
    head = name.split(".")[0]
    if head in ("pandas", "matplotlib"):
        if head == "matplotlib" and path == BUILD_DOCS and in_function:
            return False
        return not path.startswith(PLOTTING + os.sep)
    return head in ("jax", "jaxlib", "ccvm_tpu")


def _imports(tree):
    """(module name, line, inside a function) of every import statement and
    every module-like string constant (a name handed to importlib)."""
    found = []

    def visit(node, in_function):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if re.fullmatch(r"[A-Za-z_][\w.]*", node.value):
                names = [node.value]
        found.extend((n, node.lineno, in_function) for n in names)
        inner = in_function or isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(tree, False)
    return found


def test_sources_import_neither_jax_nor_ccvm_tpu():
    """No import statement, and no module name handed to importlib or
    __import__, names jax or ccvm_tpu (other than as ccvm_tpu_torch) in the
    port, chip_smoke.py or bench_torch.py, nor pandas or matplotlib outside
    the plotting package ccvm_tpu_torch/ccvmplotlib/ (matplotlib also inside
    a function of tools/build_docs.py, which draws the site's diagrams).
    Citations of the JAX package's files in comments are allowed: they say
    which TPU code each part replaces."""
    offenders = []
    scanned = {os.path.relpath(p, PKG) for p in _port_python_sources()}
    assert {os.path.join("parallel", "__init__.py"), os.path.join("parallel", "sweep.py"),
            os.path.join("parallel", "multihost.py"),
            os.path.join("parallel", "mesh.py"), os.path.join("parallel", "tp.py"),
            os.path.join("tools", "multihost_smoke.py"),
            os.path.join("tools", "tune_benchmark_set.py"),
            "tuning.py", "checkpoint.py", "profiling.py",
            os.path.join("native", "__init__.py"), os.path.join("tools", "validate.py"),
            os.path.join("tools", "breakdown.py"),
            os.path.join("tools", "build_docs.py")} <= scanned
    for path in _port_python_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        rel = os.path.relpath(path, REPO)
        offenders += [f"{rel}:{line}:{name}" for name, line, in_function in _imports(tree)
                      if _foreign(name, path, in_function)]
    assert not offenders, offenders


def test_native_library_is_the_ports_own_source_and_builds_at_first_use_only():
    """ccvm_tpu_torch/native/ccvm_io.cpp includes only system headers (no
    source of the JAX package), the loader builds it from under
    ccvm_tpu_torch/ into build/native, and importing the package and its
    tools builds nothing: with no compiler on PATH the imports pass and no
    library is loaded."""
    from ccvm_tpu_torch import native

    assert native.SOURCE == os.path.join(PKG, "native", "ccvm_io.cpp")
    assert native.BUILD_DIR == os.path.join(REPO, "build", "native")
    assert native.library_path().startswith(native.BUILD_DIR + os.sep)
    with open(native.SOURCE) as f:
        includes = re.findall(r'#include\s*([<"][^>"]+[>"])', f.read())
    assert includes and all(inc.startswith("<") for inc in includes), includes
    code = ("import sys, ccvm_tpu_torch, ccvm_tpu_torch.native as n;"
            "import ccvm_tpu_torch.problem_classes.boxqp.problem_instance;"
            "import ccvm_tpu_torch.solvers.base, ccvm_tpu_torch.tools.validate;"
            "import ccvm_tpu_torch.tools.breakdown, ccvm_tpu_torch.tools.build_docs;"
            "sys.exit(0 if n._LIB is None else 1)")
    env = dict(os.environ, PYTHONPATH=REPO, PATH="")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_point_scripts_import_neither_jax_nor_ccvm_tpu():
    """examples/torch_port/ (the JAX examples' twins) names no jax or
    ccvm_tpu module; they reach pandas and matplotlib, as the JAX scripts
    do, only inside a function."""
    assert sorted(f[:-3] for f in os.listdir(SCRIPTS) if f.endswith(".py")) == \
        sorted(SCRIPT_NAMES)
    offenders = []
    for name in SCRIPT_NAMES:
        path = os.path.join(SCRIPTS, f"{name}.py")
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for module, line, in_function in _imports(tree):
            head = module.split(".")[0]
            plotting = head in ("pandas", "matplotlib") or \
                module.startswith("ccvm_tpu_torch.ccvmplotlib")
            if head in ("jax", "jaxlib", "ccvm_tpu") or (plotting and not in_function):
                offenders.append(f"{name}.py:{line}:{module}")
    assert not offenders, offenders


def _load_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"isolation_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Built(Exception):
    """Raised by a stand-in solver class with the device it was given."""


def _stand_in(device, **_):
    raise _Built(device)


def _entry_points():
    """Each script's entry point with its default arguments, and a function
    that puts the stand-in solver class where the script builds its
    solver."""
    from ccvm_tpu_torch.tools import tune_benchmark_set

    def study():
        mod = _load_script("benchmarking_study")
        return (lambda: mod.run_sweep(mod.parse_args([])),
                lambda mp: mp.setattr(mod, "SOLVER_CLASSES", dict.fromkeys(
                    mod.SOLVER_CLASSES, _stand_in)))

    def example(name, cls):
        mod = _load_script(name)
        return mod.main, lambda mp: mp.setattr(mod, cls, _stand_in)

    def tensor_parallel():
        # No world to join here: the process group and its mesh are left
        # out, so that the solver is the first thing built on the card.
        mod = _load_script("tensor_parallel_boxqp")

        def stand_in(mp):
            mp.setattr(mod, "LangevinSolver", _stand_in)
            mp.setattr(mod, "initialize", lambda *a, **k: None)
            mp.setattr(mod, "mesh_of_the_world", lambda: None)

        return functools.partial(mod.main, []), stand_in

    return {
        "benchmarking_study": study,
        "ccvm_boxqp_dl": lambda: example("ccvm_boxqp_dl", "DLSolver"),
        "ccvm_boxqp_mf": lambda: example("ccvm_boxqp_mf", "MFSolver"),
        "langevin_boxqp": lambda: example("langevin_boxqp", "LangevinSolver"),
        "pumped_langevin_boxqp": lambda: example("pumped_langevin_boxqp",
                                                 "PumpedLangevinSolver"),
        "ccvm_boxqp_plot": lambda: example("ccvm_boxqp_plot", "DLSolver"),
        "tensor_parallel_boxqp": tensor_parallel,
        "tune_benchmark_set": lambda: (
            functools.partial(tune_benchmark_set.main, out_path="tuned.json"),
            lambda mp: mp.setattr(tune_benchmark_set, "CLASSES", dict.fromkeys(
                tune_benchmark_set.CLASSES, _stand_in))),
    }


@pytest.mark.parametrize("name", SCRIPT_NAMES + ("tune_benchmark_set",))
def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path,
                                                                name):
    """With no device given each entry point builds its solver on "cuda";
    without a card it raises before it solves anything."""
    monkeypatch.chdir(tmp_path)
    run, stand_in = _entry_points()[name]()
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        stand_in(mp)
        with pytest.raises(_Built) as built:
            run()
        assert built.value.args == ("cuda",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run()


@pytest.mark.parametrize("command", [["examples/torch_port/benchmarking_study.py"],
                                     ["-m", "ccvm_tpu_torch.tools.tune_benchmark_set"]],
                         ids=["study", "tuner"])
def test_entry_point_commands_fail_without_a_card(tmp_path, command):
    res = subprocess.run([sys.executable] + command[:-1] + [
        command[-1] if command[0] == "-m" else os.path.join(REPO, command[-1])],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO))
    assert res.returncode != 0 and "is_available" in res.stderr, res.stdout + res.stderr
    assert os.listdir(tmp_path) == []


def test_only_bench_torch_reaches_the_plotting_package_and_inside_a_function():
    """The plotting package (pandas, matplotlib) is imported by nothing else
    of the port, nor by chip_smoke.py; bench_torch.py imports it only inside
    a function (its TTS column), so it starts on a host without pandas.  The
    documentation tool may import matplotlib, and hand the plotting
    package's modules to importlib (its walk of the package), only inside a
    function, so that importing it leaves both out."""
    offenders, bench_imports, docs_imports = [], [], []
    for path in _port_python_sources():
        if path.startswith(PLOTTING + os.sep):
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name, line, in_function in _imports(tree):
            plotting = name.startswith("ccvm_tpu_torch.ccvmplotlib")
            if path == BUILD_DOCS and (plotting or name.split(".")[0] == "matplotlib"):
                (docs_imports if in_function else offenders).append(
                    f"{os.path.relpath(path, REPO)}:{line}:{name}")
            elif not plotting:
                continue
            elif path == BENCH and in_function:
                bench_imports.append(name)
            else:
                offenders.append(f"{os.path.relpath(path, REPO)}:{line}:{name}")
    assert not offenders, offenders
    assert bench_imports, "bench_torch.py's TTS column reads the plotting package"
    assert docs_imports, "build_docs.py draws its diagrams with matplotlib"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    spec = build.DLSpec(False, False, False, True, 1)
    monkeypatch.setattr(build, "library_path", lambda s: str(tmp_path / "x.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([spec])


def test_mf_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    spec = build.MFSpec(True, False, True, True, 0)
    assert spec.defines() == ["-DCCVM_ADAM=1", "-DCCVM_BETA2_ONE=0",
                              "-DCCVM_ADD_ASSIGN=1", "-DCCVM_NOISE=1", "-DCCVM_RNG=0",
                              "-DCCVM_NP=72"]
    monkeypatch.setattr(build, "library_path", lambda s: str(tmp_path / "x.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([spec])


def test_langevin_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    spec = build.LangevinSpec(True, True, False, True, True, 0, 72)
    assert spec.defines() == ["-DCCVM_PUMPED=1", "-DCCVM_ADAM=1",
                              "-DCCVM_BETA2_ONE=0", "-DCCVM_ADD_ASSIGN=1",
                              "-DCCVM_NOISE=1", "-DCCVM_RNG=0", "-DCCVM_NP=72"]
    monkeypatch.setattr(build, "library_path", lambda s: str(tmp_path / "x.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([spec])


def test_library_names_follow_the_source_and_every_header(monkeypatch, tmp_path):
    """An edit to a shared header renames every library, so a stale one is
    never loaded."""
    for f in os.listdir(build.CSRC):
        (tmp_path / f).write_bytes(open(os.path.join(build.CSRC, f), "rb").read())
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    dl = build.DLSpec(False, False, False, True, 1)
    mf = build.MFSpec(False, False, False, True, 0)
    lgv = build.LangevinSpec(False, False, False, False, True, 0, 72)
    before = {s: build.library_path(s) for s in (dl, mf, lgv)}
    assert os.path.basename(before[dl]).startswith("libdl_solve_")
    assert os.path.basename(before[mf]).startswith("libmf_solve_")
    assert os.path.basename(before[lgv]).startswith("liblangevin_solve_")
    with open(tmp_path / "ccvm_common.cuh", "a") as f:
        f.write("// edited\n")
    assert all(build.library_path(s) != before[s] for s in (dl, mf, lgv))


def test_loaded_library_is_found_without_touching_the_sources(monkeypatch):
    """A launch after a spec's first load reads no source from disk."""
    dl = build.DLSpec(False, False, False, True, 0)
    mf = build.MFSpec(False, False, False, True, 0)
    monkeypatch.setattr(build, "_LIBS", {(build.DLSpec, dl): "dl",
                                         (build.MFSpec, mf): "mf"})

    def no_disk(*_):
        raise AssertionError("the sources were read on a cache hit")

    monkeypatch.setattr(build, "library_path", no_disk)
    monkeypatch.setattr(build, "_source_hash", no_disk)
    assert (build.load(dl), build.load(mf)) == ("dl", "mf")


class _CudaLike:
    """Stands in for a float32 CUDA tensor on a host without a card."""

    def __init__(self, shape):
        self.shape, self.ndim, self.dtype = shape, len(shape), torch.float32
        self.device = torch.device("cuda")

    def __getitem__(self, _):
        return _CudaLike((1,) + self.shape)

    def contiguous(self):
        return self


def test_mf_solve_on_cuda_tensors_never_reaches_the_plain_version(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mf_kernels, "mf_solve_reference", plain)
    p = MFParams(0.0, 20.0, 0.0025, 5.0, 400.0, 0.01, 0.0, 1.0, 10.0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mf_kernels.mf_solve(1, _CudaLike((12, 12)), _CudaLike((12,)), p,
                            iterations=10, batch_size=8, pump_rate_flag=True)


def test_checkpointed_solve_on_cuda_tensors_never_reaches_the_plain_version(
        monkeypatch, tmp_path):
    """checkpointed_solve launches the segment build on CUDA tensors (here,
    without nvcc, its build raises) and writes no snapshot."""
    from ccvm_tpu_torch import checkpoint

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mf_kernels, "mf_solve_segment_reference", plain)
    p = MFParams(0.0, 20.0, 0.0025, 5.0, 400.0, 0.01, 0.0, 1.0, 10.0)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        checkpoint.checkpointed_solve(mf_kernels.mf_solve_segment, 1, _CudaLike((12, 12)),
                                      _CudaLike((12,)), p, None, 10, every=5, path=path,
                                      batch_size=8, pump_rate_flag=True)
    assert not os.path.exists(path)


_LANGEVIN_CASES = {
    "langevin": (langevin_kernels.langevin_solve, "langevin_solve_reference",
                 LangevinParams(0.5, 0.002, 0.5, 2.0, 0.0, 1.0), {}),
    "pumped": (langevin_kernels.pumped_langevin_solve,
               "pumped_langevin_solve_reference",
               PumpedLangevinParams(1.0, 0.5, 0.002, 0.25, 1.0, 0.0, 1.0, 40.0),
               {"pump_rate_flag": True}),
}


@pytest.mark.parametrize("family", sorted(_LANGEVIN_CASES))
def test_langevin_solves_on_cuda_tensors_never_reach_the_plain_version(
        monkeypatch, tmp_path, family):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    solve, reference, p, kw = _LANGEVIN_CASES[family]
    monkeypatch.setattr(langevin_kernels, reference, plain)
    monkeypatch.setattr(langevin_kernels, "_reference", plain)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        solve(1, _CudaLike((12, 12)), _CudaLike((12,)), p, iterations=10,
              batch_size=8, **kw)


def _launch_counts():
    return (langevin_kernels.langevin_solve.langevin_launches,
            langevin_kernels.langevin_solve.langevin_adam_launches,
            langevin_kernels.pumped_langevin_solve.pumped_launches,
            langevin_kernels.pumped_langevin_solve.pumped_adam_launches)


@pytest.mark.parametrize("family", sorted(_LANGEVIN_CASES))
def test_langevin_solves_on_cpu_tensors_are_the_reference(family):
    rng = np.random.RandomState(3)
    a = rng.randn(12, 12).astype(np.float32)
    q = torch.from_numpy((a + a.T) / 2)
    v = torch.from_numpy(rng.randn(12).astype(np.float32))
    solve, reference, p, kw = _LANGEVIN_CASES[family]
    kw = dict(kw, iterations=40, batch_size=8, rng="popcount32")
    before = _launch_counts()
    c = solve(3, q, v, p, **kw)
    assert torch.equal(c, getattr(langevin_kernels, reference)(3, q, v, p, **kw))
    # The plain version is not a launch of the kernel.
    assert before == _launch_counts()
    # One S a column (the façades' per-variable S) is taken, on the CPU by
    # the plain version; another length is refused.
    p_col = p._replace(S=tuple(np.linspace(0.3, 0.9, 12, dtype=np.float32).tolist()))
    assert torch.equal(solve(3, q, v, p_col, **kw),
                       getattr(langevin_kernels, reference)(3, q, v, p_col, **kw))
    assert before == _launch_counts()
    with pytest.raises(ValueError, match="scalar S"):
        solve(3, q, v, p._replace(S=np.ones(11)), **kw)


def test_langevin_launch_shape_is_mf_s():
    """The Langevin family's launch rule, MF's before the redesigns (one x
    array, a 4 x 4 tile), is now its own (build.langevin_launch_shape): 8
    column groups by 16 row groups, a thread owning N/8 columns of 8
    trajectory rows (Adam: 4), two x buffers: at N=70, 128 trajectories and
    128 threads in 98,560 bytes of shared memory (Adam: 64 in 78,080, with
    its second moments)."""
    assert langevin_kernels.launch_shape(70) == (128, 128, 98560)
    assert langevin_kernels.launch_shape(70, adam=True) == (64, 128, 78080)
    for n in range(2, 71):
        for adam in (False, True):
            shape = build.langevin_launch_shape(n, adam)
            assert langevin_kernels.launch_shape(n, adam) == shape[:3]
            assert shape.np == -(-n // 8) * 8 and shape.rows == (64 if adam else 128)
    with pytest.raises(ValueError, match="does not fit the Langevin kernel"):
        langevin_kernels.launch_shape(400)


def test_dl_solve_on_cpu_tensors_is_the_reference():
    rng = np.random.RandomState(3)
    a = rng.randn(12, 12).astype(np.float32)
    q = torch.from_numpy((a + a.T) / 2)
    v = torch.from_numpy(rng.randn(12).astype(np.float32))
    p = DLParams(8.0, 1.0, 0.001, 2.0, 100.0, 0.05, 0.0, 1.0, 40.0)
    kw = dict(iterations=40, batch_size=8, pump_rate_flag=True,
              pump_is_gt_one=True, rng="popcount16")
    before = (dl_kernels.dl_solve.dl_launches, dl_kernels.dl_solve.dl_adam_launches)
    c, s = dl_kernels.dl_solve(3, q, v, p, **kw)
    c_ref, s_ref = dl_kernels.dl_solve_reference(3, q, v, p, **kw)
    assert torch.equal(c, c_ref) and torch.equal(s, s_ref)
    # The plain version is not a launch of the kernel.
    assert before == (dl_kernels.dl_solve.dl_launches,
                      dl_kernels.dl_solve.dl_adam_launches)


def test_mf_solve_on_cpu_tensors_is_the_reference():
    rng = np.random.RandomState(3)
    a = rng.randn(12, 12).astype(np.float32)
    q = torch.from_numpy((a + a.T) / 2)
    v = torch.from_numpy(rng.randn(12).astype(np.float32))
    p = MFParams(0.5, 20.0, 0.0025, 5.0, 400.0, 0.01, 0.0, 1.0, 40.0)
    kw = dict(iterations=40, batch_size=8, pump_rate_flag=True, rng="popcount32")
    before = (mf_kernels.mf_solve.mf_launches, mf_kernels.mf_solve.mf_adam_launches)
    out = mf_kernels.mf_solve(3, q, v, p, **kw)
    ref = mf_kernels.mf_solve_reference(3, q, v, p, **kw)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    # The plain version is not a launch of the kernel.
    assert before == (mf_kernels.mf_solve.mf_launches,
                      mf_kernels.mf_solve.mf_adam_launches)
    # One S a column (the façades' per-variable S) is taken, on the CPU by
    # the plain version; another length is refused.
    p_col = p._replace(S=tuple(np.linspace(10.0, 30.0, 12, dtype=np.float32).tolist()))
    out = mf_kernels.mf_solve(3, q, v, p_col, **kw)
    ref = mf_kernels.mf_solve_reference(3, q, v, p_col, **kw)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    with pytest.raises(ValueError, match="scalar S"):
        mf_kernels.mf_solve(3, q, v, p._replace(S=np.ones(11)), **kw)


def test_mf_launch_shape_fits_the_bundled_sizes_and_rejects_huge_n():
    rows, threads, smem = mf_kernels.launch_shape(70)
    assert (rows, threads) == (64, 288) and smem <= build.SMEM_LIMIT
    for n in range(2, 71):
        rows, threads, smem = mf_kernels.launch_shape(n)
        assert rows % 4 == 0 and threads <= 288 and smem <= build.SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit the MF kernel"):
        mf_kernels.launch_shape(400)


def test_launch_shape_fits_the_bundled_sizes_and_rejects_huge_n():
    rows, threads, smem = dl_kernels.launch_shape(70)
    assert (rows, threads, smem) == (64, 256, 78624) and smem <= 232448
    assert dl_kernels.launch_shape(70, mma=False)[:2] == (56, 252)
    for n in (2, 4, 20, 30, 40, 50, 60):
        dl_kernels.launch_shape(n)
    with pytest.raises(ValueError, match="does not fit"):
        dl_kernels.launch_shape(400)


def test_dl_variant_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    spec = build.DLVariantSpec(True, False, 16, True, 1)
    assert spec.defines() == ["-DCCVM_V3=1", "-DCCVM_FUSE=0", "-DCCVM_UNROLL=16",
                              "-DCCVM_NOISE=1", "-DCCVM_RNG=1", "-DCCVM_NT=9"]
    monkeypatch.setattr(build, "library_path", lambda s: str(tmp_path / "x.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([spec])


def test_dl_variant_libraries_are_named_by_spec_source_and_headers(monkeypatch, tmp_path):
    for f in os.listdir(build.CSRC):
        (tmp_path / f).write_bytes(open(os.path.join(build.CSRC, f), "rb").read())
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    specs = [build.DLVariantSpec(False, False, 8, True, 0),
             build.DLVariantSpec(False, True, 8, True, 0),
             build.DLVariantSpec(True, False, 1, True, 1),
             build.DLVariantSpec(True, False, 16, False, 0)]
    before = [build.library_path(s) for s in specs]
    assert len(set(before)) == len(specs)
    assert all(os.path.basename(p).startswith("libdl_variants_") for p in before)
    with open(tmp_path / "ccvm_common.cuh", "a") as f:
        f.write("// edited\n")
    assert all(build.library_path(s) != p for s, p in zip(specs, before))


def test_dl_variant_tag_and_library_change_with_the_n_tiles():
    """The variants' tensor-core design is built per n-tile count, as the DL
    kernel's: N=20 (3 n-tiles) and N=70 (9) are separate libraries."""
    n20, n70 = (dl_variant_kernels._spec(False, True, 8, 1.0, "popcount1", n)
                for n in (20, 70))
    assert (n20.nt, n70.nt) == (3, 9) and n20._replace(nt=9) == n70
    assert n20.tag() == "v2f1u8n1r0t3" and n70.tag() == "v2f1u8n1r0t9"
    assert build.library_path(n20) != build.library_path(n70)
    assert "-DCCVM_NT=3" in n20.defines() and "-DCCVM_NT=9" in n70.defines()
    assert dl_variant_kernels._spec(True, False, 16, 0.0, "popcount2", 72).nt == 9
    assert dl_variant_kernels._spec(True, False, 16, 0.0, "popcount2", 73).nt == 10
    for fuse, threads in ((True, 256), (False, 128)):
        shape = build.variant_launch_shape(70, fuse)
        assert (shape.rows, shape.threads, shape.smem, shape.blocks_per_sm) == (
            64, threads, 78624, 2)
    with pytest.raises(ValueError, match="does not fit"):
        build.variant_launch_shape(129, True)


@pytest.mark.parametrize("name", ["dl_v2", "dl_v3"])
def test_dl_variants_on_cuda_tensors_never_reach_the_plain_version(
        monkeypatch, tmp_path, name):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for attr in ("dl_v2_reference", "dl_v3_reference", "_reference"):
        monkeypatch.setattr(dl_variant_kernels, attr, plain)
    kw = dict(iterations=16, batch_size=8, rng_name="popcount1", unroll=8)
    if name == "dl_v2":
        kw["fuse_matvec"] = True
    before = (dl_variant_kernels.dl_v2.launches, dl_variant_kernels.dl_v3.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(dl_variant_kernels, name)(
            1, _CudaLike((12, 12)), _CudaLike((12,)),
            kernel_experiments.harness_params(16), **kw)
    # A launch that never happened is not counted.
    assert before == (dl_variant_kernels.dl_v2.launches,
                      dl_variant_kernels.dl_v3.launches)


def test_race_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        kernel_experiments.race("cuda", batch=8, n=6, i1=8, i2=16, reps=1)
    with pytest.raises(RuntimeError, match="is_available"):
        kernel_experiments.main(["--n", "6", "--batch", "8"])


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card, and
    in a directory that holds nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert res.returncode != 0, res.stdout + res.stderr
        assert '"ok"' not in res.stdout


def test_chip_smoke_plain_workers_leave_no_process():
    """A worker whose solve fails raises in the caller, and ``close`` leaves
    no child process of chip_smoke.py's running."""
    code = (
        "import os, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
        "w = chip_smoke.PlainWorkers(2);"
        "f = [w.submit('ccvm_tpu_torch.ops.mf_kernels', 'no_such_solve', 0, None, None,"
        " None, {}) for _ in range(3)];"
        "errors = [str(x.exception()) for x in f]; w.close();"
        "kids = [p for p in os.listdir('/proc') if p.isdigit() and"
        " open(f'/proc/{p}/stat').read().rsplit(')', 1)[1].split()[1] == str(os.getpid())];"
        "print(errors, kids); sys.exit(0 if kids == [] and all("
        "'plain worker exited with 1' in e for e in errors) else 1)"
    )
    res = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
