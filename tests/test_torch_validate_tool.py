"""``ccvm_tpu_torch/tools/validate.py`` against ``tools/tpu_validate.py``, its
JAX twin, which is loaded by path and read, never run (CPU).

The instance, the four parameter sets, the two variants, the band formula
and the printed layout equal the JAX tool's; the tool raises without a card,
and ``--device cpu`` runs all eight cases through the plain versions.
"""

from __future__ import annotations

import ast
import importlib.util
import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ccvm_tpu.solvers.algorithms import AdamParameters as JAdamParameters
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels, philox
from ccvm_tpu_torch.tools import validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "tpu_validate.py")


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("tpu_validate_under_test", JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return module, main


def _assigned(main, name):
    """The expression assigned to ``name`` in the JAX tool's ``main``."""
    return next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name for t in n.targets))


def _evaluate(expr, **names):
    return eval(compile(ast.Expression(expr), JAX_TOOL, "eval"), {"np": np}, names)


def test_instance_and_parameter_sets_equal_the_jax_tools(jax_tool):
    module, _ = jax_tool
    assert validate.INSTANCE in module.INSTANCE_CANDIDATES
    assert os.path.isfile(validate.INSTANCE)
    assert list(validate.PARAMS) == list(module.PARAMS)
    for name, (cls, params) in validate.PARAMS.items():
        jcls, jparams = module.PARAMS[name]
        assert cls.__name__ == jcls.__name__
        assert params == jparams


def test_variants_equal_the_jax_tools(jax_tool):
    _, main = jax_tool
    jvariants = _evaluate(_assigned(main, "variants"), AdamParameters=JAdamParameters)
    assert [label for label, _ in validate.VARIANTS] == [label for label, _ in jvariants]
    for (_, ours), (_, theirs) in zip(validate.VARIANTS, jvariants):
        if theirs is None:
            assert ours is None
            continue
        for field in ("alpha", "beta1", "beta2", "add_assign"):
            assert getattr(ours, field) == getattr(theirs, field), field
    assert validate.CASES == ("dl", "dl+adam", "mf", "mf+adam", "langevin",
                              "langevin+adam", "pumped", "pumped+adam")


@pytest.mark.parametrize("batch", [64, 4096])
def test_band_formula_equals_the_jax_tools(jax_tool, batch):
    """The band, 5 sqrt(2 max(p(1-p)) / batch) + 0.01, evaluated from the
    JAX tool's own expressions for sig and tol, over a grid of pairs."""
    _, main = jax_tool

    class Args:
        pass

    args = Args()
    args.batch = batch
    for p_pal in np.linspace(0.0, 1.0, 21):
        for p_lax in np.linspace(0.0, 1.0, 21):
            sig = _evaluate(_assigned(main, "sig"), p_pal=p_pal, p_lax=p_lax, args=args)
            tol = _evaluate(_assigned(main, "tol"), sig=sig)
            assert validate.band(p_pal, p_lax, batch) == tol


def test_printed_layout_is_the_jax_tools(jax_tool):
    """One line per gap: the JAX tool's f-string with "kernel" and "plain"
    in place of "pallas" and "lax"; the failing gaps are returned."""
    _, main = jax_tool
    line = next(n.args[0] for n in ast.walk(main) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "print" and n.args
                and isinstance(n.args[0], ast.JoinedStr)
                and "pallas=" in ast.unparse(n.args[0]))
    perf_a = {"optimal": 0.25, "one_percent": 0.5, "ten_percent": 1.0}
    perf_b = {"optimal": 0.25, "one_percent": 0.75, "ten_percent": 1.0}
    printed = []
    failures = validate.compare(perf_a, perf_b, 4096, out=printed.append)
    want = []
    for gap in perf_a:
        tol = validate.band(perf_a[gap], perf_b[gap], 4096)
        mark = "ok " if abs(perf_a[gap] - perf_b[gap]) <= tol else "FAIL"
        text = _evaluate(line, mark=mark, gap=gap, p_pal=perf_a[gap], p_lax=perf_b[gap],
                         tol=tol)
        want.append(text.replace("pallas=", "kernel=").replace("lax=", "plain="))
    assert printed == want
    assert failures == [("one_percent", 0.5, 0.75)]


def test_the_tool_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        validate.main([])
    with pytest.raises(RuntimeError, match="is_available"):
        validate.case_performance("dl", plain=False)


def test_rng_takes_the_kernels_transforms():
    with pytest.raises(SystemExit):
        validate.main(["--device", "cpu", "--rng", "threefry"])
    with pytest.raises(ValueError, match="rng must be one of"):
        validate.validate(device="cpu", rng="threefry")
    assert set(philox.RNG_NAMES) >= {"popcount32", "popcount16", "popcount", "box_muller"}


def test_plain_versions_reroute_and_restore_the_wrappers():
    wrappers = (dl_kernels.dl_solve, mf_kernels.mf_solve, langevin_kernels.langevin_solve,
                langevin_kernels.pumped_langevin_solve)
    with validate.plain_versions():
        assert dl_kernels.dl_solve is dl_kernels.dl_solve_reference
        assert mf_kernels.mf_solve is mf_kernels.mf_solve_reference
        assert langevin_kernels.langevin_solve is langevin_kernels.langevin_solve_reference
        assert (langevin_kernels.pumped_langevin_solve
                is langevin_kernels.pumped_langevin_solve_reference)
    assert (dl_kernels.dl_solve, mf_kernels.mf_solve, langevin_kernels.langevin_solve,
            langevin_kernels.pumped_langevin_solve) == wrappers


def test_cpu_run_prints_all_eight_cases_in_the_jax_layout():
    """``--device cpu --iterations 50 --batch 64``: both sides through the
    plain versions, so every gap agrees; the header, one block a case and
    the closing line, which says that no kernel was checked."""
    out = io.StringIO()
    with redirect_stdout(out):
        validate.main(["--device", "cpu", "--iterations", "50", "--batch", "64"])
    text = out.getvalue()
    assert text.startswith(f"instance: {validate.INSTANCE}  batch=64 iterations=50\n")
    blocks = re.findall(r"\n(\S+):\n((?:  .*\n)+)", text)
    assert [case for case, _ in blocks] == list(validate.CASES)
    for _, lines in blocks:
        rows = lines.splitlines()
        assert len(rows) == 7 and all(r.startswith("  ok  ") for r in rows)
        assert all(re.fullmatch(r"  ok  \w+ +kernel=\d\.\d{4} plain=\d\.\d{4} tol=\d\.\d{4}",
                                r) for r in rows)
    # Both sides were plain: the closing line claims no kernel check.
    assert text.rstrip().endswith(validate.SELF_CHECK)
    assert "no kernel was checked" in validate.SELF_CHECK
    assert "kernel and plain versions statistically agree" not in text


def test_a_failed_gap_exits_one(monkeypatch, capsys):
    monkeypatch.setattr(validate, "validate",
                        lambda **kw: [("dl", "optimal", 0.5, 0.9)])
    with pytest.raises(SystemExit) as exit_:
        validate.main(["--device", "cpu"])
    assert exit_.value.code == 1
    assert "FAILURES" in capsys.readouterr().out

