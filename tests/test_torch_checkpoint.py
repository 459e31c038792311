"""The port's checkpoint / resume (``ccvm_tpu_torch/checkpoint.py``) on the
CPU: the JAX package's checkpoint tests (``tests/unit/test_aux_subsystems.py``
``TestCheckpoint``) for all four families, plain and Adam, on the plain
versions of the segment launches.  A checkpointed solve, and one
interrupted after its first snapshot and resumed by a second call, equal
the whole plain solve bit for bit (the noise on: the plain segments key
their draws by the absolute step, as the kernels do).  Snapshots cross
between the two packages, and a solve resumed from the other package's
snapshot ends, noise off, within 1e-5 of that package's checkpointed solve.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvm_tpu import checkpoint as jcheckpoint
from ccvm_tpu.dynamics import dl as jdl
from ccvm_tpu.dynamics import langevin as jlgv
from ccvm_tpu_torch import AdamParameters, checkpoint
from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.dynamics.langevin import LangevinParams
from ccvm_tpu_torch.dynamics.mf import MFParams
from ccvm_tpu_torch.dynamics.pumped_langevin import PumpedLangevinParams
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels

N = 8
BATCH = 4
ITERS = 40
EVERY = 7
HP = AdamParameters(alpha=0.05).to_hyperparameters()

# family: (segment function, whole solve, params, flags, whole result -> the
# final state's leaves it holds, checkpointed state -> the same leaves)
FAMILIES = {
    "dl": (dl_kernels.dl_solve_segment, dl_kernels.dl_solve,
           DLParams(2.0, 1.0, 0.01, 10.0, 10.0, 0.05, 0.0, 1.0, float(ITERS)),
           dict(pump_rate_flag=True, pump_is_gt_one=True),
           lambda out: out, lambda st: (torch.clamp(st[0], -1.0, 1.0), st[1])),
    "mf": (mf_kernels.mf_solve_segment, mf_kernels.mf_solve,
           MFParams(0.0, 2.0, 0.01, 5.0, 50.0, 0.01, 0.0, 1.0, float(ITERS)),
           dict(pump_rate_flag=True), lambda out: (out[0], out[2]), lambda st: st[:2]),
    "langevin": (langevin_kernels.langevin_solve_segment, langevin_kernels.langevin_solve,
                 LangevinParams(0.5, 0.02, 0.5, 1.0, 0.0, 1.0), {},
                 lambda out: (out,), lambda st: st[:1] if isinstance(st, tuple) else (st,)),
    "pumped": (langevin_kernels.pumped_langevin_solve_segment,
               langevin_kernels.pumped_langevin_solve,
               PumpedLangevinParams(2.0, 0.5, 0.02, 0.5, 1.0, 0.0, 1.0, float(ITERS)),
               dict(pump_rate_flag=True), lambda out: (out,),
               lambda st: st[:1] if isinstance(st, tuple) else (st,)),
}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    a = rng.randn(N, N).astype(np.float32)
    return (a + a.T) / 2, rng.randn(N).astype(np.float32)


def _whole(family, q, v, hp):
    _, whole, p, flags, final, _ = FAMILIES[family]
    return final(whole(3, q, v, p, iterations=ITERS, batch_size=BATCH, hp=hp, **flags))


def _checkpointed(family, q, v, hp, path, segment=None, resume=True):
    seg, _, p, flags, _, leaves = FAMILIES[family]
    state = checkpoint.checkpointed_solve(segment or seg, 3, q, v, p, None, ITERS,
                                          every=EVERY, path=path, resume=resume,
                                          batch_size=BATCH, hp=hp, **flags)
    return state, leaves(state)


def _torch(problem):
    return tuple(torch.from_numpy(x) for x in problem)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpointed_equals_uninterrupted(problem, tmp_path, family, adam):
    q, v = _torch(problem)
    hp = HP if adam else None
    path = str(tmp_path / "ck.npz")
    state, got = _checkpointed(family, q, v, hp, path)
    assert all(torch.equal(a, b) for a, b in zip(got, _whole(family, q, v, hp), strict=True))
    # The last snapshot holds the final state (Adam's moments too).
    loaded, it, meta = checkpoint.load_state(path, like=state)
    assert it == ITERS and meta["num_leaves"] == len(checkpoint._leaves(state))
    assert all(torch.equal(a, b) for a, b in zip(checkpoint._leaves(loaded),
                                                 checkpoint._leaves(state)))
    assert not os.path.exists(path + ".tmp")


class _Interrupted(Exception):
    pass


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resume_after_interruption(problem, tmp_path, family, adam):
    """A run that dies after its first snapshot, resumed by a second call,
    equals the whole solve (a shorter ``iterations`` would change the DL,
    MF and pumped step tables, so the interruption is a raise)."""
    q, v = _torch(problem)
    hp = HP if adam else None
    seg = FAMILIES[family][0]
    path = str(tmp_path / "ck.npz")
    calls = []

    def dies_after_the_first(*args, **kwargs):
        if calls:
            raise _Interrupted
        calls.append(args[5])
        return seg(*args, **kwargs)

    with pytest.raises(_Interrupted):
        _checkpointed(family, q, v, hp, path, segment=dies_after_the_first)
    _, it, _ = checkpoint.load_state(path)
    assert it == EVERY
    started = []

    def recording(*args, **kwargs):
        started.append(args[5])
        return seg(*args, **kwargs)

    _, got = _checkpointed(family, q, v, hp, path, segment=recording)
    assert started[0] == EVERY
    assert all(torch.equal(a, b) for a, b in zip(got, _whole(family, q, v, hp), strict=True))
    # resume=False starts over.
    started.clear()
    _checkpointed(family, q, v, hp, path, segment=recording, resume=False)
    assert started[0] == 0


def test_save_load_roundtrip_and_like(tmp_path):
    state = (torch.ones((3, 4)), torch.zeros((3, 4)))
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, state, iteration=17, meta={"tag": "x"})
    loaded, it, meta = checkpoint.load_state(path, like=state)
    assert it == 17 and meta["tag"] == "x"
    assert isinstance(loaded, tuple)
    assert torch.equal(loaded[0], state[0]) and torch.equal(loaded[1], state[1])
    checkpoint.save_state(path, torch.arange(3.0), iteration=2)
    one, _, _ = checkpoint.load_state(path)
    assert torch.equal(one, torch.arange(3.0))
    with pytest.raises(ValueError, match="holds 1 arrays"):
        checkpoint.load_state(path, like=state)
    assert not os.path.exists(path + ".tmp")


def _jax_params(family):
    """The JAX side's noise-off parameters and flags of a family."""
    if family == "langevin":
        return jlgv.LangevinParams(
            S=jnp.float32(0.5), dt=jnp.float32(0.02), sigma=jnp.float32(0.0),
            feedback_scale=jnp.float32(1.0), lower_limit=jnp.float32(0.0),
            upper_limit=jnp.float32(1.0)), {}
    return jdl.DLParams(
        pump=jnp.float32(2.0), S=jnp.float32(1.0), dt=jnp.float32(0.01),
        noise_ratio=jnp.float32(10.0), feedback_scale=jnp.float32(10.0),
        g=jnp.float32(0.0), lower_limit=jnp.float32(0.0), upper_limit=jnp.float32(1.0),
        iterations=jnp.float32(ITERS)), dict(pump_rate_flag=True, pump_is_gt_one=True)


CROSS = {"langevin": (jlgv.solve_segment, langevin_kernels.langevin_solve_segment,
                      LangevinParams(0.5, 0.02, 0.0, 1.0, 0.0, 1.0)),
         "dl": (jdl.solve_segment, dl_kernels.dl_solve_segment,
                DLParams(2.0, 1.0, 0.01, 10.0, 10.0, 0.0, 0.0, 1.0, float(ITERS)))}


def _jax_init(family):
    z = jnp.zeros((BATCH, N), jnp.float32)
    return z if family == "langevin" else (z, z)


@pytest.mark.parametrize("family", sorted(CROSS))
def test_snapshots_cross_between_the_packages(problem, tmp_path, family):
    """Noise off (Langevin sigma 0, DL g 0): a snapshot the JAX package wrote
    at step 14 resumes in the port, and one the port wrote there resumes in
    the JAX package; each ends within 1e-5 of the other package's
    uninterrupted checkpointed solve.  (The JAX solve stops at step 14 by
    its ``iterations`` argument: its step reads the total from the
    parameters.)"""
    jseg, tseg, tp = CROSS[family]
    jp, flags = _jax_params(family)
    jq, jv = (jnp.asarray(x) for x in problem)
    q, v = _torch(problem)
    key = jax.random.PRNGKey(0)
    init = _jax_init(family)

    def jax_run(path, iterations):
        out = jcheckpoint.checkpointed_solve(jseg, key, jq, jv, jp, init, iterations,
                                             every=EVERY, path=path, **flags)
        return [np.asarray(x) for x in (out if isinstance(out, tuple) else (out,))]

    def port_run(path, segment=tseg):
        out = checkpoint.checkpointed_solve(segment, 0, q, v, tp, None, ITERS,
                                            every=EVERY, path=path, batch_size=BATCH,
                                            **flags)
        return [x.numpy() for x in checkpoint._leaves(out)]

    full_jax = jax_run(str(tmp_path / "jax_full.npz"), ITERS)
    full_port = port_run(str(tmp_path / "port_full.npz"))
    for a, b in zip(full_port, full_jax, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-5)

    jax_path = str(tmp_path / "jax.npz")
    jax_run(jax_path, 2 * EVERY)
    state, it, _ = checkpoint.load_state(jax_path)
    assert it == 2 * EVERY and len(checkpoint._leaves(state)) == len(full_jax)
    for a, b in zip(port_run(jax_path), full_jax, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-5)

    def stops_at_14(seed, q_, v_, p_, state, start, num, **kw):
        if start >= 2 * EVERY:
            raise _Interrupted
        return tseg(seed, q_, v_, p_, state, start, num, **kw)

    port_path = str(tmp_path / "port.npz")
    with pytest.raises(_Interrupted):
        port_run(port_path, stops_at_14)
    loaded, it, _ = jcheckpoint.load_state(port_path, like=init)
    assert it == 2 * EVERY
    for a, b in zip(jax_run(port_path, ITERS), full_port, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-5)
