"""The DL race harness's variant kernels against the JAX harness (CPU).

``tools/kernel_experiments.py`` is loaded by path and left as it is.  Its
Pallas kernels ``_dl_kernel_v2`` and ``_dl_kernel_v3`` seed the TPU's
hardware generator, which plain ``interpret=True`` cannot run, so they run
here under ``pltpu.force_tpu_interpret_mode()`` with a zero transform
injected into the harness's RNG table.  Noise off, the port's plain versions
must match them to atol 1e-5 on c and s, on the harness's parameters at
n = 12, batch 16.  The noise itself cannot be compared (the TPU's stream is
not replayable): the port's transforms are tested on Philox words instead.
"""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ccvm_tpu.ops import pallas_kernels as pk
from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.ops import dl_kernels, philox
from ccvm_tpu_torch.ops import dl_variant_kernels as dv
from ccvm_tpu_torch.tools import kernel_experiments as tke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12
BATCH = 16
TOL = 1e-5


@pytest.fixture(scope="module")
def ke():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_experiments", os.path.join(REPO, "tools", "kernel_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def zero_rng(ke, monkeypatch):
    def zeros(shape):
        z = jnp.zeros(shape, jnp.float32)
        return z, z

    monkeypatch.setitem(ke.RNGS, "zero", zeros)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(N, N)).astype(np.float32)
    return 0.5 * (q + q.T), rng.normal(size=(N,)).astype(np.float32)


def _params(iterations):
    return tke.harness_params(iterations)


def _jax(ke, fn, problem, iterations, **kw):
    """(c, s) of a JAX harness kernel, unpacked to (batch, n)."""
    q, v = (jnp.asarray(x) for x in problem)
    with pltpu.force_tpu_interpret_mode():
        c, s = fn(jax.random.PRNGKey(0), q, v, _params(iterations).reshape(1, -1),
                  iterations=iterations, batch_size=BATCH, rng_name="zero", **kw)
    k = pk._pad_problem(q, v)[5]
    return tuple(np.asarray(pk._unstack(x, False, 1, x.shape[0], BATCH, N, k))
                 for x in (c, s))


def _torch(fn, problem, iterations, **kw):
    q, v = (torch.from_numpy(x) for x in problem)
    c, s = fn(0, q, v, _params(iterations), iterations=iterations,
              batch_size=BATCH, rng_name="popcount1", noise_scale=0.0, **kw)
    return c.numpy(), s.numpy()


@pytest.mark.parametrize("unroll", [1, 4, 8])
@pytest.mark.parametrize("fuse", [False, True])
def test_v2_noise_off_matches_the_jax_harness(ke, zero_rng, problem, fuse, unroll):
    iterations = 24
    want = _jax(ke, ke.dl_v2, problem, iterations, fuse_matvec=fuse, unroll=unroll)
    got = _torch(dv.dl_v2, problem, iterations, fuse_matvec=fuse, unroll=unroll)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.abs(g).max() > 0.01
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("unroll", [8, 16])
def test_v3_noise_off_matches_the_jax_harness_with_a_tail(ke, zero_rng, problem, unroll):
    """20 steps: 20 % 8 and 20 % 16 leave a tail of 4 steps."""
    want = _jax(ke, ke.dl_v3, problem, 20, unroll=unroll)
    got = _torch(dv.dl_v3, problem, 20, unroll=unroll)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.abs(g).max() > 0.01
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_v2_needs_whole_unrolled_bodies_in_both_packages(ke, zero_rng, problem):
    with pytest.raises(AssertionError):
        _jax(ke, ke.dl_v2, problem, 10, fuse_matvec=False, unroll=4)
    with pytest.raises(ValueError, match="multiple of unroll"):
        _torch(dv.dl_v2, problem, 10, fuse_matvec=False, unroll=4)


def test_harness_table_names_the_jax_harness_transforms(ke):
    assert set(philox.HARNESS_RNGS) == set(ke.RNGS)
    # popcount2 is the harness's alone: the façades' kernel_rng stays as
    # pallas_kernels._RNG_NAMES.
    assert philox.RNG_NAMES == pk._RNG_NAMES


def test_popcount1_draws_are_popcount32_draws_bit_for_bit():
    rows = torch.arange(40, dtype=torch.int64)
    got = philox.harness_pair(9, 3, rows, 30, "popcount1", torch.arange(2))
    want = philox.wiener_pair(9, 3, rows, 30, "popcount32", torch.arange(2))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = philox.harness_pair(9, 3, rows, 30, "popcount3(prod)")
    want = philox.wiener_pair(9, 3, rows, 30, "popcount")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_popcount2_moments_lattice_and_support():
    """10**6 normals (each from two Philox words): mean 0 and variance 1
    within 5 sigma, on the 0.25 lattice, within +-8."""
    rows = torch.arange(10**6 // 200, dtype=torch.int64)
    z1, z2 = philox.harness_pair(1234, 7, rows, 100, "popcount2")
    z = torch.cat([z1.flatten(), z2.flatten()]).double().numpy()
    assert z.size == 10**6
    assert abs(z.mean()) < 5 / np.sqrt(z.size)
    assert abs(z.var() - 1.0) < 5 * np.sqrt(2.0 / z.size)
    np.testing.assert_array_equal(z * 4, np.round(z * 4))
    assert np.abs(z).max() <= 8.0
    # z1 reads streams 0-1, z2 streams 2-3.
    w = [philox.words(1234, 7, rows[:5], 100, k) for k in range(4)]
    assert torch.equal(philox.popcount2_one(w[2], w[3]), z2[:5])


def test_harness_pair_rejects_unknown_names():
    with pytest.raises(ValueError, match="rng_name must be one of"):
        philox.harness_pair(0, 0, torch.arange(2), 4, "popcount16")
    with pytest.raises(ValueError, match="rng_name must be one of"):
        dv.dl_v3(0, torch.eye(4), torch.ones(4), _params(4), iterations=4,
                 batch_size=2, rng_name="popcount16", unroll=1)


def test_v2_noise_off_is_production_when_the_clip_never_binds(problem):
    """Noise off, with the pump ramp on and pump > 1, v2 computes the
    production step; only the order of two scalar products differs
    ((z*span)/S_d against z*(span/S_d)), so they agree to round-off."""
    q, v = (torch.from_numpy(x) for x in problem)
    pv = _params(40)
    c2, s2 = dv.dl_v2(0, q, v, pv, iterations=40, batch_size=BATCH,
                      rng_name="popcount1", fuse_matvec=True, unroll=8,
                      noise_scale=0.0)
    cp, sp = dl_kernels.dl_solve_reference(
        0, q, v, DLParams(*(float(x) for x in pv)), iterations=40,
        batch_size=BATCH, pump_rate_flag=True, pump_is_gt_one=True,
        noise_scale=0.0)
    assert sp.abs().max() < dl_kernels.DL_SAFETY_BOUND
    torch.testing.assert_close(c2, cp, rtol=0, atol=1e-6)
    torch.testing.assert_close(s2, sp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", ["v2", "v3"])
@pytest.mark.parametrize("rng_name", ["popcount1", "popcount2", "popcount3(prod)"])
def test_stacked_plain_solve_is_serial_solves_with_seed_plus_i(problem, variant, rng_name):
    q, v = (torch.from_numpy(x) for x in problem)
    q2, v2 = torch.stack([q, q.flip(0, 1)]), torch.stack([v, v.flip(0)])
    fn = dv.dl_v2 if variant == "v2" else dv.dl_v3
    kw = dict(iterations=8, batch_size=6, rng_name=rng_name, unroll=4)
    if variant == "v2":
        kw["fuse_matvec"] = False
    cs, ss = fn(5, q2, v2, _params(8), **kw)
    for i in range(2):
        ci, si = fn(5 + i, q2[i], v2[i], _params(8), **kw)
        assert torch.equal(cs[i], ci) and torch.equal(ss[i], si)
    assert cs.shape == (2, 6, N) and torch.isfinite(cs).all()
    assert cs.abs().max() <= float(np.float32(np.sqrt(7.0)))


def test_cpu_calls_are_the_plain_versions_and_launch_nothing(problem):
    q, v = (torch.from_numpy(x) for x in problem)
    before = (dv.dl_v2.launches, dv.dl_v3.launches)
    kw = dict(iterations=6, batch_size=4, rng_name="popcount2", unroll=2)
    got = dv.dl_v3(3, q, v, _params(6), **kw)
    want = dv.dl_v3_reference(3, q, v, _params(6), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = dv.dl_v2(3, q, v, _params(6), fuse_matvec=True, **kw)
    want = dv.dl_v2_reference(3, q, v, _params(6), fuse_matvec=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert before == (dv.dl_v2.launches, dv.dl_v3.launches)


@pytest.mark.parametrize("pump", [1.0, 0.5])
def test_pump_at_most_one_raises(problem, pump):
    q, v = (torch.from_numpy(x) for x in problem)
    pv = _params(4)
    pv[0] = pump
    with pytest.raises(ValueError, match="pump > 1"):
        dv.dl_v3(0, q, v, pv, iterations=4, batch_size=2, rng_name="popcount1",
                 unroll=1)


def test_race_on_the_cpu_has_the_harness_rows_and_production(ke):
    rows = tke.race("cpu", batch=8, n=6, i1=2, i2=4, reps=1)
    labels = [r["label"] for r in rows]
    jax_labels = ["v2 popcount1 fuse0 unroll8 (prev best)"] + [
        f"v3 {r} unroll{u}" for u in (8, 16) for r in ("popcount1", "popcount2")]
    assert labels == jax_labels + ["v2 popcount1 fuse1 unroll8",
                                   "dl_solve CUDA-core matvec popcount16 (clip)",
                                   "production dl_solve popcount16 (clip)"]
    for r in rows:
        assert set(r) == {"label", "us_per_step", "traj_iter_per_s", "finite",
                          "w1_s", "w2_s"}
        assert r["finite"] and r["w1_s"] > 0 and r["w2_s"] > 0
        assert "marginal" in tke.format_row(r)


def test_race_uses_the_harness_problem(ke):
    q, v = tke.harness_problem(20)
    rng = np.random.default_rng(0)
    qj = rng.normal(size=(20, 20)).astype(np.float32)
    np.testing.assert_array_equal(q, 0.5 * (qj + qj.T))
    np.testing.assert_array_equal(v, rng.normal(size=(20,)).astype(np.float32))
    np.testing.assert_array_equal(
        tke.harness_params(15000),
        np.array([8.0, np.sqrt(7.0), 0.001, 10.0, 100.0, 0.01, 0.0, 1.0, 15000.0],
                 np.float32))


def test_race_rounds_alternate_the_row_order_and_report_median_and_range(monkeypatch):
    order = []
    runner = tke.runner

    def recording(kind, kw, *args, **kwargs):
        run = runner(kind, kw, *args, **kwargs)
        label = next(lb for lb, k, w in tke.ROWS if k == kind and w == kw)
        order.append(label)
        return run

    monkeypatch.setattr(tke, "runner", recording)
    rows = tke.race_rounds("cpu", batch=8, n=6, i1=2, i2=4, rounds=3, reps=1)
    labels = list(tke.LABELS)
    assert order == labels + labels[::-1] + labels
    assert [r["label"] for r in rows] == labels
    for r in rows:
        assert len(r["us_rounds"]) == 3 and r["finite"]
        assert r["us_per_step"] == sorted(r["us_rounds"])[1]
        assert r["us_range"] == max(r["us_rounds"]) - min(r["us_rounds"])
        assert "over 3 rounds" in tke.format_row(r)
    with pytest.raises(ValueError, match="rounds"):
        tke.race_rounds("cpu", batch=8, n=6, i1=2, i2=4, rounds=0)


def _rounds_row(label, us):
    return {"label": label, "us_per_step": float(np.median(us)), "us_rounds": us}


def test_knob_effects_are_resolved_only_beyond_the_spread():
    base = {label: [60.0, 61.0, 62.0] for label in tke.LABELS}
    base[tke.KNOBS[0][2]] = [50.0, 52.0, 53.0]  # fused: every round faster
    base[tke.KNOBS[1][2]] = [59.0, 61.5, 63.0]  # prescaled: ranges overlap
    effects = tke.knob_effects([_rounds_row(k, v) for k, v in base.items()])
    assert [e["knob"] for e in effects] == [k for k, _, _ in tke.KNOBS]
    assert effects[0]["delta_us"] == pytest.approx(-9.0)
    assert effects[0]["delta_pct"] == pytest.approx(-900.0 / 61.0)
    assert effects[0]["resolved"]
    assert effects[1]["delta_us"] == pytest.approx(0.5)
    assert not effects[1]["resolved"]
    assert "within the spread" in tke.format_effect(effects[1])


def test_race_cli_on_the_cpu_prints_every_row(monkeypatch, capsys):
    monkeypatch.setattr(tke, "I1", 2)
    monkeypatch.setattr(tke, "I2", 4)
    tke.main(["--device", "cpu", "--batch", "4", "--n", "6"])
    lines = capsys.readouterr().out.splitlines()
    assert "i1=2 i2=4" in lines[0]
    assert len(lines) == 1 + len(tke.ROWS)
    for line, label in zip(lines[1:], tke.LABELS):
        assert line.startswith(label) and "marginal" in line
