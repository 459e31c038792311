"""``python -m ccvm_tpu_torch.tools.breakdown --family dl``, the twin of
``tools/profile_kernel.py`` (CPU; its timings need the card).

The family is accepted; its rows are the DL and DL-Adam probe builds with
noise, without noise and without the matvec (``CCVM_MATVEC=0``), then DL
with each Wiener transform; no solver's build sets ``CCVM_MATVEC``, so the
production DL libraries are named as before but for the source hash.
"""

from __future__ import annotations

import os
import re

import pytest
import torch

from ccvm_tpu_torch import AdamParameters
from ccvm_tpu_torch.ops import build, dl_kernels, philox
from ccvm_tpu_torch.tools import breakdown

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ccvm_tpu_torch", "csrc")


def test_family_dl_is_accepted_and_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        breakdown.main(["--family", "dl"])
    with pytest.raises(SystemExit) as exit_:
        breakdown.main(["--family", "tpu"])
    assert exit_.value.code == 2  # argparse refuses another family
    assert set(breakdown.ROWS) == {"dl", "mf", "langevin"}


def test_dl_rows_are_the_probe_builds():
    rows = breakdown.dl_rows("cpu")
    labels = [r[0] for r in rows]
    assert labels == ["DL", "DL, noise off", "DL, no matvec", "DL-Adam",
                      "DL-Adam, noise off", "DL-Adam, no matvec"] + [
        f"DL, kernel_rng {r}" for r in philox.RNG_NAMES]
    for label, problem, hp, noise_scale, spec, _ in rows:
        q, v, params = problem
        assert tuple(q.shape) == (1, 70, 70) and tuple(v.shape) == (1, 70)
        assert isinstance(spec, breakdown.DLProbeSpec) and spec.tag().startswith("probe")
        assert spec.mma and spec.nt == 9 and not (spec.cols or spec.seg or spec.elem)
        assert spec.matvec == ("no matvec" not in label)
        assert spec.noise == ("noise off" not in label) == (noise_scale == 1.0)
        assert spec.adam == label.startswith("DL-Adam") == (hp is not None)
        assert ("-DCCVM_MATVEC=0" in spec.defines()) == ("no matvec" in label)
        rng = label.split("kernel_rng ")[1] if "kernel_rng" in label else "popcount16"
        if spec.noise:
            assert spec.rng == philox.RNG_NAMES.index(rng)
        assert params(1000).iterations == 1000
    # The probe builds are libraries of their own.
    prod = dl_kernels._spec(70, None, 1.0, "popcount16", True)
    assert build.library_path(rows[0][4]) != build.library_path(prod)


def test_no_solver_build_sets_the_probe_define():
    """``CCVM_MATVEC`` is a probe only: no spec type of ops/build.py has the
    field, so no solver's build passes the define, and the source defaults
    it to 1 as the Langevin and MF templates do."""
    for spec_type in (build.DLSpec, build.MFSpec, build.LangevinSpec, build.DLVariantSpec):
        assert "matvec" not in spec_type._fields
    hp = AdamParameters(beta2=0.999).to_hyperparameters()
    for spec in (dl_kernels._spec(70, None, 1.0, "popcount16", True),
                 dl_kernels._spec(70, hp, 1.0, "popcount16", True),
                 dl_kernels._spec(20, None, 0.0, "popcount32", True, 2, True, True),
                 dl_kernels._spec(70, None, 1.0, "popcount16", False)):
        assert not any("MATVEC" in d for d in spec.defines())
    for source in ("dl_solve.cu", "mf_solve.cu", "langevin_solve.cu"):
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
        assert re.search(r"#ifndef CCVM_MATVEC\n#define CCVM_MATVEC 1\n#endif", text), source


def test_production_dl_libraries_change_name_only_through_the_source_hash():
    """The DL and DL-Adam main-path builds keep their tags (0001119 and
    1011119); only the hash of the sources names a new library."""
    hp = AdamParameters(beta2=0.999).to_hyperparameters()
    for spec, tag in ((dl_kernels._spec(70, None, 1.0, "popcount16", True), "0001119"),
                      (dl_kernels._spec(70, hp, 1.0, "popcount16", True), "1011119")):
        assert spec.tag() == tag
        assert build.library_path(spec) == os.path.join(
            build.BUILD_DIR, f"libdl_solve_{build._source_hash('dl_solve.cu')}_{tag}.so")


def test_dl_problem_is_the_main_paths():
    """The scaled Size70 instance and the tuned N=70 DL parameters (S 1, g
    0.05), T the steps run."""
    q, v, params = breakdown.dl_problem("cpu")
    assert tuple(q.shape) == (70, 70) and q.dtype == torch.float32
    p = params(15000)
    assert (float(p.pump), float(p.S), float(p.dt), float(p.g), float(p.iterations)) == \
        (12.0, 1.0, pytest.approx(0.001), pytest.approx(0.05), 15000.0)
