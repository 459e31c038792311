"""The wheel carries every source the port builds at first use (CPU).

The port compiles its CUDA templates (``csrc/*.cu``, ``*.cuh``) and its host
I/O library (``native/ccvm_io.cpp``) from the installed package when they are
first used, so a wheel without one of them installs a port that cannot load
an instance or launch a kernel.  The wheel is built from a copy of the tree
under ``tmp_path``, offline (no index, no build isolation, no cache), and
nothing is written into the checkout.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_SUFFIXES = (".cpp", ".cu", ".cuh")


def _port_sources():
    found = []
    for root, dirs, files in os.walk(os.path.join(REPO, "ccvm_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        found += [os.path.relpath(os.path.join(root, f), REPO).replace(os.sep, "/")
                  for f in files if f.endswith(SOURCE_SUFFIXES)]
    return sorted(found)


def test_wheel_holds_every_native_and_cuda_source_of_the_port(tmp_path):
    src, out = tmp_path / "src", tmp_path / "wheels"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(REPO, name), src / name)
    for package in ("ccvm_tpu", "ccvm_tpu_torch"):
        shutil.copytree(os.path.join(REPO, package), src / package,
                        ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    env = dict(os.environ, PIP_NO_INDEX="1", PIP_DISABLE_PIP_VERSION_CHECK="1",
               PIP_NO_CACHE_DIR="1")
    res = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ".", "--no-deps", "--no-build-isolation",
         "--no-index", "--no-cache-dir", "--disable-pip-version-check", "-w", str(out)],
        cwd=src, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    wheels = list(out.glob("*.whl"))
    assert len(wheels) == 1, wheels
    with zipfile.ZipFile(wheels[0]) as whl:
        names = set(whl.namelist())
    sources = _port_sources()
    assert "ccvm_tpu_torch/native/ccvm_io.cpp" in sources
    assert "ccvm_tpu_torch/csrc/dl_solve.cu" in sources
    missing = [s for s in sources if s not in names]
    assert not missing, f"the wheel leaves out {missing}"
