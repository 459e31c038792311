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
from ccvm_tpu_torch.ops import build, dl_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ccvm_tpu_torch")


def test_import_leaves_jax_ccvm_tpu_pandas_matplotlib_out():
    code = (
        "import sys, ccvm_tpu_torch, ccvm_tpu_torch.interop;"
        "import ccvm_tpu_torch.ops.dl_kernels, ccvm_tpu_torch.ops.build;"
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
    spec = build.DLSpec(False, False, False, True, True, True, 1)
    monkeypatch.setattr(build, "library_path", lambda s: str(tmp_path / "x.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([spec])


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


def test_launch_shape_fits_the_bundled_sizes_and_rejects_huge_n():
    rows, threads, smem = dl_kernels.launch_shape(70)
    assert (rows, threads) == (56, 252) and smem <= 232448
    for n in (2, 4, 20, 30, 40, 50, 60):
        dl_kernels.launch_shape(n)
    with pytest.raises(ValueError, match="does not fit"):
        dl_kernels.launch_shape(400)
