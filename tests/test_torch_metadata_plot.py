"""The port's Metadata and ccvmplotlib against the JAX package's (CPU).

Both are copies of JAX-free modules, so their results are held equal, not
close: the plotting tables of the committed sweep
(``benchmark_results_reference/*_benchmark.json``) frame for frame with each
solver's machine-time and machine-energy models, the TTS statistics (the
same seeded ``numpy.random.RandomState`` bootstrap) value for value, the
plots' line data point for point, and a metadata file written from the
port's Solutions byte for byte.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

import ccvm_tpu  # noqa: E402
import ccvm_tpu_torch  # noqa: E402
from ccvm_tpu.ccvmplotlib import ccvmplotlib as jplot  # noqa: E402
from ccvm_tpu.ccvmplotlib.problem_metadata import BoxQPMetadata as JBoxQPMetadata  # noqa: E402
from ccvm_tpu.ccvmplotlib.problem_metadata import ProblemType as JProblemType  # noqa: E402
from ccvm_tpu.ccvmplotlib.utils import SampleTTSMetric as JSampleTTSMetric  # noqa: E402
from ccvm_tpu.metadata import Metadata as JMetadata  # noqa: E402
from ccvm_tpu_torch.ccvmplotlib import ccvmplotlib as tplot  # noqa: E402
from ccvm_tpu_torch.ccvmplotlib.problem_metadata import (  # noqa: E402
    BoxQPMetadata,
    ProblemMetadataFactory,
    ProblemType,
)
from ccvm_tpu_torch.ccvmplotlib.utils import SampleTTSMetric  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = os.path.join(REPO, "benchmark_results_reference")
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")
# The sweep's four files, each solver's façade, and the machine model its
# TTS reads (bench.py's MACHINES).
SOLVERS = {"dl": ("DLSolver", "dl-ccvm"), "mf": ("MFSolver", "mf-ccvm"),
           "langevin": ("LangevinSolver", "fpga"), "pumped": ("PumpedLangevinSolver", "cpu")}


def _metric_funcs(name):
    """(JAX, port) machine_time and machine_energy callables of a solver."""
    cls, machine = SOLVERS[name]
    j, t = getattr(ccvm_tpu, cls)(device="cpu"), getattr(ccvm_tpu_torch, cls)(device="cpu")
    # The optics energy models read the pump and the iterations per size.
    with open(os.path.join(REPO, "examples", "tuned_parameters.json")) as f:
        tuned = json.load(f)[name]
    j.parameter_key = t.parameter_key = {
        int(size): dict(p, iterations=15000) for size, p in tuned.items()}
    return {"time": (j.machine_time(machine), t.machine_time(machine)),
            "energy": (j.machine_energy(machine), t.machine_energy(machine))}


def _ingested(path):
    j = JBoxQPMetadata(JProblemType.BoxQP)
    j.ingest_metadata(path)
    t = BoxQPMetadata(ProblemType.BoxQP)
    t.ingest_metadata(path)
    return j, t


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_boxqp_metadata_frames_equal_the_jax_package(name):
    path = os.path.join(SWEEP, f"{name}_benchmark.json")
    j, t = _ingested(path)
    pd.testing.assert_frame_equal(t._df, j._df)
    pd.testing.assert_frame_equal(t.generate_success_prob_plot_data(),
                                  j.generate_success_prob_plot_data())
    for kind, (jf, tf) in _metric_funcs(name).items():
        tt, jt = t.generate_plot_data(tf), j.generate_plot_data(jf)
        pd.testing.assert_frame_equal(tt, jt, check_exact=True)
        assert np.isfinite(tt.to_numpy(dtype=float)).any(), kind


def _line_data(ax):
    lines = [(ln.get_label(), ln.get_xydata().tolist()) for ln in ax.get_lines()]
    bands = [[p.vertices.tolist() for p in c.get_paths()] for c in ax.collections]
    return lines, bands, ax.get_yscale(), ax.get_ylim(), list(ax.get_xticks())


@pytest.mark.parametrize("plot", ["plot_TTS", "plot_ETS", "plot_success_prob"])
@pytest.mark.parametrize("name", ["dl", "langevin"])
def test_plots_draw_the_same_lines(name, plot):
    path = os.path.join(SWEEP, f"{name}_benchmark.json")
    args = {"plot_TTS": "time", "plot_ETS": "energy"}.get(plot)
    drawn = []
    for k, lib in enumerate((jplot, tplot)):
        extra = () if args is None else (_metric_funcs(name)[args][k],)
        fig, ax = getattr(lib, plot)(path, "BoxQP", *extra)
        drawn.append(_line_data(ax))
        plt.close(fig)
    assert drawn[0] == drawn[1]
    assert len(drawn[1][0]) >= 7  # one line per gap level


def test_sample_tts_metric_equals_the_jax_package():
    rng = np.random.RandomState(4)
    results = [[{"best_energy": float(e), "time": float(t)}
                for e, t in zip(rng.uniform(-1, 1, 40), rng.uniform(1e-3, 2e-3, 40))]
               for _ in range(6)]
    best = [-0.9] * 6
    for kw in ({}, {"percentile": 25.0, "num_bootstraps": 37}):
        j = JSampleTTSMetric(tau_attribute="time", seed=11, **kw)
        t = SampleTTSMetric(tau_attribute="time", seed=11, **kw)
        assert t.calc(results, best) == j.calc(results, best)
        p = t.calc_success_probabilities(results, best)
        np.testing.assert_array_equal(p, j.calc_success_probabilities(results, best))
        np.testing.assert_array_equal(t.calc_R99_distribution(p, 40),
                                      j.calc_R99_distribution(p, 40))
        assert t.calc_R99_quartile_means(p, 40) == j.calc_R99_quartile_means(p, 40)
    assert t.calc_R99(0.3) == j.calc_R99(0.3) and t.calc_R99(0.0) == np.inf


def _port_solutions():
    """Two small CPU solves of the port, as a sweep records them."""
    solver = ccvm_tpu_torch.LangevinSolver(device="cpu", batch_size=16)
    solver.parameter_key = {20: {"dt": 0.002, "S": 0.5, "iterations": 300,
                                 "sigma": 0.5, "feedback_scale": 2.0}}
    inst = ccvm_tpu_torch.ProblemInstance(device="cpu", file_path=TEST020,
                                          instance_type="test")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    return [solver(inst, seed=s, post_processor="adam") for s in (1, 2)]


def test_metadata_written_by_the_port_is_read_by_the_jax_plotting(tmp_path):
    dicts = [s.get_metadata_dict() for s in _port_solutions()]
    paths = {}
    for label, cls in (("port", ccvm_tpu_torch.Metadata), ("jax", JMetadata)):
        md = cls(device="cpu")
        for d in dicts:
            md.add_to_result_metadata(d)
        paths[label] = md.save_metadata_to_file(str(tmp_path / label), "meta")
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    with open(paths["port"]) as f:
        assert json.load(f)["device"] == "cpu"
    j, t = _ingested(paths["port"])
    pd.testing.assert_frame_equal(t.generate_success_prob_plot_data(),
                                  j.generate_success_prob_plot_data())
    assert np.nanmax(t.generate_success_prob_plot_data().to_numpy(dtype=float)) > 0
    fig, ax = jplot.plot_success_prob(paths["port"], "BoxQP")
    assert ax.get_lines()
    plt.close(fig)


def test_metadata_and_factory_surface():
    assert ccvm_tpu_torch.Metadata is not JMetadata
    assert "Metadata" in ccvm_tpu_torch.__all__
    md = ccvm_tpu_torch.Metadata(device="cuda")
    md.add_to_result_metadata({"a": 1})
    assert md.metadata_dict == {"device": "cuda", "result_metadata": [{"a": 1}]}
    assert isinstance(ProblemMetadataFactory.create_problem_metadata("BoxQP"),
                      BoxQPMetadata)
    with pytest.raises(ValueError):
        ProblemMetadataFactory.create_problem_metadata("MaxCut")


def test_sample_tts_metric_imports_without_pandas_or_matplotlib():
    """The host-only plotting package's statistics import where pandas and
    matplotlib cannot (the card machine has neither); its tables and plots
    do not."""
    code = (
        "import sys; sys.modules['pandas'] = None; sys.modules['matplotlib'] = None;"
        "from ccvm_tpu_torch.ccvmplotlib.utils import SampleTTSMetric;"
        "SampleTTSMetric(tau_attribute='time', seed=1).calc_R99(0.5);"
        "import ccvm_tpu_torch.ccvmplotlib as p\n"
        "try:\n"
        "    from ccvm_tpu_torch.ccvmplotlib.problem_metadata import BoxQPMetadata\n"
        "except ModuleNotFoundError as e:\n"
        "    assert e.name == 'pandas', e; print('ok')"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
