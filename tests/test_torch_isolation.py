"""The port stands alone: no JAX, no ccvm_tpu, no pandas or matplotlib; its
kernels build only with nvcc and never fall back (CPU)."""

from __future__ import annotations

import ast
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
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ccvm_tpu', 'pandas', 'matplotlib')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _port_python_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _foreign(name):
    head = name.split(".")[0]
    return head in ("jax", "jaxlib", "ccvm_tpu", "pandas", "matplotlib")


def test_sources_import_neither_jax_nor_ccvm_tpu():
    """No import statement, and no module name handed to importlib or
    __import__, names jax or ccvm_tpu (other than as ccvm_tpu_torch).
    Citations of the JAX package's files in comments are allowed: they say
    which TPU code each part replaces."""
    offenders = []
    for path in _port_python_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                if re.fullmatch(r"[A-Za-z_][\w.]*", node.value):
                    names = [node.value]
            rel = os.path.relpath(path, REPO)
            offenders += [f"{rel}:{node.lineno}:{n}" for n in names if _foreign(n)]
    assert not offenders, offenders


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
    spec = build.MFSpec(True, False, True, True, True, 0)
    assert spec.defines() == ["-DCCVM_ADAM=1", "-DCCVM_BETA2_ONE=0",
                              "-DCCVM_ADD_ASSIGN=1", "-DCCVM_PUMP_RATE_FLAG=1",
                              "-DCCVM_NOISE=1", "-DCCVM_RNG=0"]
    monkeypatch.setattr(build, "library_path", lambda s: str(tmp_path / "x.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([spec])


def test_langevin_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    spec = build.LangevinSpec(True, True, False, True, True, True, 0)
    assert spec.defines() == ["-DCCVM_PUMPED=1", "-DCCVM_ADAM=1",
                              "-DCCVM_BETA2_ONE=0", "-DCCVM_ADD_ASSIGN=1",
                              "-DCCVM_PUMP_RATE_FLAG=1", "-DCCVM_NOISE=1",
                              "-DCCVM_RNG=0"]
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
    mf = build.MFSpec(False, False, False, True, True, 0)
    lgv = build.LangevinSpec(False, False, False, False, False, True, 0)
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
    mf = build.MFSpec(False, False, False, True, True, 0)
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
    with pytest.raises(ValueError, match="scalar S"):
        solve(3, q, v, p._replace(S=np.ones(12)), **kw)


def test_langevin_launch_shape_is_mf_s():
    """One x array per block, as MF: at N=70, 56 trajectories and 252
    threads in 37,760 bytes of shared memory."""
    assert langevin_kernels.launch_shape(70) == (56, 252, 37760)
    for n in range(2, 71):
        assert langevin_kernels.launch_shape(n) == mf_kernels.launch_shape(n)
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
    with pytest.raises(ValueError, match="scalar S"):
        mf_kernels.mf_solve(3, q, v, p._replace(S=np.ones(12)), **kw)


def test_mf_launch_shape_fits_the_bundled_sizes_and_rejects_huge_n():
    rows, threads, smem = mf_kernels.launch_shape(70)
    assert (rows, threads) == (56, 252) and smem <= build.SMEM_LIMIT
    for n in range(2, 71):
        rows, threads, smem = mf_kernels.launch_shape(n)
        assert rows % 4 == 0 and threads <= 256 and smem <= build.SMEM_LIMIT
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
                              "-DCCVM_NOISE=1", "-DCCVM_RNG=1"]
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
