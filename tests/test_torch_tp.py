"""The port's tensor-parallel engine over gloo against the JAX package's
(CPU).

One world of four ranks as a 2 x 2 ("batch", "model") mesh
(``tests/torch_ranks.py``, spawned once for the module) runs the solves.
With the noise off (sigma 0, g 0) they are held against
``ccvm_tpu.parallel.tp`` on ``make_mesh(8, tp=2)`` over the eight virtual
devices of ``tests/conftest.py``, at ``tests/unit/test_sharding.py``'s rtol
1e-4, atol 1e-5.  With the noise on the port draws every element's noise at
its global (step, row, column), so its TP solve is held against its own
single-process solve on the same Philox words at 1e-4 over 100 steps (in
units of max(1, |x|): MF's unclamped mu reaches about 1.2e3, where one
float32 ulp is 1.2e-4, and a relative 1e-7 change of Q moves it by 2e-4);
MF also by its readout statistics, as the JAX test holds it.  The engine's one step,
the plain version of each template's one-step build, is held here against
the whole plain solve, bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import rand_problem, spawn, tensor_parallel

from ccvm_tpu.dynamics.common import AdamHyperparameters as JAdamHyperparameters
from ccvm_tpu.dynamics.dl import DLParams as JDLParams
from ccvm_tpu.dynamics.langevin import LangevinParams as JLangevinParams
from ccvm_tpu.dynamics.pumped_langevin import PumpedLangevinParams as JPumpedParams
from ccvm_tpu.parallel import dl_solve as jax_dl_solve
from ccvm_tpu.parallel import langevin_solve as jax_langevin_solve
from ccvm_tpu.parallel import make_mesh as jax_make_mesh
from ccvm_tpu.parallel import pumped_langevin_solve as jax_pumped_solve
from ccvm_tpu_torch.dynamics import dl as ddl
from ccvm_tpu_torch.dynamics import langevin as dlg
from ccvm_tpu_torch.dynamics import mf as dmf
from ccvm_tpu_torch.dynamics import pumped_langevin as dpl
from ccvm_tpu_torch.dynamics.common import AdamHyperparameters
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
from ccvm_tpu_torch.parallel import tp

PARITY_TOL = 1e-4  # ccvm_tpu_torch/tools/tc_model.py PARITY_TOL


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(tensor_parallel, 4, tmp_path_factory.mktemp("tp"))


def _jax_runs():
    """The JAX TP solves of tests/unit/test_sharding.py (noise off)."""
    mesh = jax_make_mesh(8, tp=2)
    f32 = np.float32
    lgv = JLangevinParams(S=f32(0.5), dt=f32(0.002), sigma=f32(0.0),
                          feedback_scale=f32(1.0), lower_limit=f32(0), upper_limit=f32(1))
    out = {}
    q, v = (jnp.asarray(a) for a in rand_problem(seed=0))
    out["langevin"] = (jax_langevin_solve(mesh, jax.random.PRNGKey(1), q, v, lgv,
                                          iterations=150, batch_size=32),)
    q, v = (jnp.asarray(a) for a in rand_problem(seed=1))
    pumped = JPumpedParams(pump=f32(2.0), S=f32(0.5), dt=f32(0.002), sigma=f32(0.0),
                           feedback_scale=f32(1.0), lower_limit=f32(0),
                           upper_limit=f32(1), iterations=f32(150))
    out["pumped"] = (jax_pumped_solve(mesh, jax.random.PRNGKey(2), q, v, pumped,
                                      iterations=150, batch_size=32),)
    q, v = (jnp.asarray(a) for a in rand_problem(seed=2))
    dl = JDLParams(pump=f32(8.0), S=jnp.sqrt(jnp.float32(7.0)), dt=f32(0.001),
                   noise_ratio=f32(10), feedback_scale=f32(100), g=f32(0.0),
                   lower_limit=f32(0), upper_limit=f32(1), iterations=f32(150))
    out["dl"] = jax_dl_solve(mesh, jax.random.PRNGKey(3), q, v, dl, iterations=150,
                             batch_size=32, pump_is_gt_one=True)
    q, v = (jnp.asarray(a) for a in rand_problem(seed=4))
    hp = JAdamHyperparameters(alpha=0.1, beta1=0.9, beta2=0.99, add_assign=False)
    out["langevin adam"] = (jax_langevin_solve(mesh, jax.random.PRNGKey(5), q, v, lgv,
                                               iterations=120, batch_size=32, hp=hp),)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return _jax_runs()


@pytest.mark.parametrize("family", ["langevin", "pumped", "dl", "langevin adam"])
def test_tp_noise_off_equals_the_jax_tp_solve(ranks, jax_runs, family):
    for r in ranks:
        ours = r[family] if isinstance(r[family], tuple) else (r[family],)
        assert ours[0].shape == (32, 16)
        for a, b in zip(ours, jax_runs[family]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["langevin", "langevin adam", "pumped", "pumped adam",
                                    "dl", "dl adam", "mf", "mf adam"])
def test_tp_noise_on_equals_one_process_on_the_same_words(ranks, family):
    for r in ranks:
        assert r["noise on"][family] <= PARITY_TOL, r["noise on"]


def test_mf_tp_statistics_match_one_process(ranks):
    """As tests/unit/test_sharding.py:205 holds the JAX MF engine."""
    for r in ranks:
        mt_tp, mt_one = r["mf readouts"]
        assert mt_tp.shape == mt_one.shape == (256, 16)
        assert np.isfinite(mt_tp).all()
        s_pool = np.std(mt_one, axis=0) / np.sqrt(256)
        assert np.all(np.abs(mt_tp.mean(0) - mt_one.mean(0)) < 6 * s_pool + 1e-3)


def test_dl_sharded_solve_objective_is_the_gathered_state_s(ranks):
    for r in ranks:
        objval, expect, best, c_shape, s_shape = r["sharded objective"]
        assert c_shape == s_shape == (32, 8)
        np.testing.assert_allclose(objval, expect, rtol=1e-5, atol=1e-4)
        assert best == pytest.approx(-objval.min())


def test_facade_routes_a_model_mesh_to_the_tp_engine(ranks):
    for r in ranks:
        calls, best_tp, best_one, finite = r["routed"]
        assert calls == 1 and finite
        # The same words: the TP solve is the single one up to round-off.
        assert abs(best_tp - best_one) <= max(0.05 * abs(best_one), 1.0)


def test_tp_matvec_equals_the_dense_matvec_at_tp_4(ranks):
    for r in ranks:
        assert r["mesh"] == (("batch", "model"), (2, 2))
        assert r["tp_matvec"] <= 1e-5


def test_tp_requires_a_scalar_s_and_divisible_shapes():
    q, v = (torch.from_numpy(a) for a in rand_problem())
    p = dlg.LangevinParams(tuple([0.5] * 16), 0.002, 0.5, 1.0, 0.0, 1.0)
    with pytest.raises(ValueError, match="require a scalar S"):
        tp.langevin_solve(None, 0, q, v, p, iterations=5, batch_size=8)

    class Mesh:
        mesh_dim_names = ("batch", "model")

        def size(self, dim):
            return (3, 5)[dim]

    with pytest.raises(ValueError, match="batch_size 8 must divide over the batch axis"):
        tp._check_divisibility(Mesh(), 8, 15)
    with pytest.raises(ValueError, match="problem size 16 must divide over the model"):
        tp._check_divisibility(Mesh(), 9, 16)


# The one-step builds' plain versions, stepped with the full matvec, are the
# whole plain solve: (step wrapper, whole solve, params, flags, state arrays
# (plain, Adam), matvec inputs).
_T, _B, _N = 30, 8, 12
_HP = AdamHyperparameters(0.1, 0.9, 0.99, False)
_STEPS = {
    "dl": (dl_kernels.dl_step, dl_kernels.dl_solve,
           ddl.DLParams(8.0, 1.0, 0.001, 10.0, 100.0, 0.05, 0.0, 1.0, float(_T)),
           dict(pump_rate_flag=True, pump_is_gt_one=True), (2, 6), 2),
    "mf": (mf_kernels.mf_step, mf_kernels.mf_solve,
           dmf.MFParams(0.0, 20.0, 0.0025, 5.0, 4000.0, 0.01, 0.0, 1.0, float(_T)),
           dict(pump_rate_flag=True), (3, 5), 1),
    "langevin": (langevin_kernels.langevin_step, langevin_kernels.langevin_solve,
                 dlg.LangevinParams(0.5, 0.002, 0.5, 1.0, 0.0, 1.0), {}, (1, 3), 1),
    "pumped": (langevin_kernels.pumped_langevin_step, langevin_kernels.pumped_langevin_solve,
               dpl.PumpedLangevinParams(2.0, 0.5, 0.002, 0.5, 1.0, 0.0, 1.0, float(_T)),
               dict(pump_rate_flag=True), (1, 3), 1),
}


@pytest.mark.parametrize("adam", [False, True], ids=["plain", "adam"])
@pytest.mark.parametrize("family", sorted(_STEPS))
def test_one_step_plain_versions_are_the_whole_plain_solve(family, adam):
    """Noise on, one rank holding every row and column: the steps give the
    whole solve's state bit for bit (the readout's clamp aside)."""
    step, solve, params, flags, arrays, x_arrays = _STEPS[family]
    hp = _HP if adam else None
    rng = np.random.default_rng(0)
    q = rng.normal(size=(_N, _N)).astype(np.float32)
    q = torch.from_numpy((q + q.T) / 2)
    v = torch.from_numpy(rng.normal(size=_N).astype(np.float32))
    state = torch.zeros(arrays[adam], _B, _N)
    if family == "mf":
        state[1] = 0.5
    x = torch.empty(x_arrays, _B, _N)
    step(5, None, v, params, state, x, None, iterations=_T, hp=hp, **flags)
    for i in range(_T):
        step(5, torch.matmul(x, q), v, params, state, x, i, iterations=_T, hp=hp, **flags)
    whole = solve(5, q, v, params, iterations=_T, batch_size=_B, hp=hp, **flags)
    if family == "dl":
        got = (state[0].clamp(-1.0, 1.0), state[1])
    elif family == "mf":
        got = (state[0], state[2].clamp(-20.0, 20.0), state[1])
    else:
        got = (state[0],)
    for a, b in zip(got, whole if isinstance(whole, tuple) else (whole,)):
        assert torch.equal(a, b)
