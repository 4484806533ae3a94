"""The port's SAC (ray_tpu_torch/rllib/sac.py) and its Pendulum-v1
(rllib/envs.py) against the JAX package and gymnasium on the CPU:
Pendulum's streams bit-equal to ``gym.make_vec("Pendulum-v1", 4)`` over
a seeded action stream across the 200-step truncation and the
autoreset; `sample_action` given JAX's normal draws; one whole update
(critic, actor, temperature, Polyak targets) from the same params on
the same batch with the noise of JAX's two keys, every loss, param,
target and the temperature within 1e-4 (params: of each leaf's largest,
plus an Adam per-element allowance); the SAC tree's interop round trip;
a short run whose losses are finite and whose replay holds no autoreset
step; a state round trip."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch import interop
from ray_tpu_torch.rllib import envs, sac
from tests.test_torch_rllib_learner import assert_params

TOL = 1e-4
HIDDEN = (32, 32)


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- env


@pytest.mark.parametrize("seed", [0, 7])
def test_pendulum_bit_equal_to_gymnasium(seed):
    want = gym.make_vec("Pendulum-v1", num_envs=4)
    got = envs.make_vec("Pendulum-v1", 4)
    assert got.single_action_space.shape == want.single_action_space.shape
    np.testing.assert_array_equal(got.single_action_space.low,
                                  want.single_action_space.low)
    np.testing.assert_array_equal(got.single_observation_space.high,
                                  want.single_observation_space.high)
    a, _ = want.reset(seed=seed)
    b, _ = got.reset(seed=seed)
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    truncations = resets = 0
    for t in range(420):
        act = rng.uniform(-2.5, 2.5, (4, 1)).astype(np.float32)
        for x, y in zip(want.step(act)[:4], got.step(act)[:4]):
            assert x.dtype == y.dtype, t
            np.testing.assert_array_equal(x, y, err_msg=str(t))
        truncations += int(x.all()) if t == 199 else 0
        resets += int(t == 200 and not y.any())
    assert truncations == 1 and resets == 1
    want.close()


# ---------------------------------------------------------------- pieces


def _params(key=0, obs_dim=3, act_dim=1):
    return jsac.init_sac_params(jax.random.PRNGKey(key), obs_dim, act_dim,
                                HIDDEN)


def test_sample_action_with_jax_noise_equals_jax():
    jp = _params()
    rng = np.random.RandomState(0)
    obs = rng.randn(16, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ja, jlogp = jsac.sample_action(jp, obs, key)
    eps = np.array(jax.random.normal(key, (16, 1)))
    a, logp = sac.sample_action(interop.rl_params_from_jax(jp)[0],
                                torch.from_numpy(obs),
                                eps=torch.from_numpy(eps))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=0,
                               atol=TOL * np.abs(np.asarray(jlogp)).max())


def test_sac_tree_interop_round_trip():
    jp = _params(3)
    back = interop.rl_params_to_jax(interop.rl_params_from_jax(jp)[0])
    for x, y in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(x), y)


# ---------------------------------------------------------------- update


def _config(mod, **kw):
    kw = {"seed": 1, **kw}
    cfg = mod.SACConfig().training(num_envs=2, hidden=HIDDEN,
                                   rollout_fragment_length=4, **kw)
    if mod is sac:
        cfg.training(device="cpu")
    return cfg


def _batch(n=32, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    return {"obs": rng.randn(n, 3).astype(np.float32),
            "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
            "rewards": -rng.rand(n).astype(np.float32) * 5,
            "next_obs": rng.randn(n, 3).astype(np.float32),
            "dones": (rng.rand(n) < 0.2).astype(np.float32)}


def test_update_equals_jax(two_threads):
    ref = _config(jsac).build()
    ours = _config(sac).build()
    # targets apart from the params, a temperature apart from 1
    ref.target_q = {k: v for k, v in _params(8).items() if k != "pi"}
    ref.log_alpha = jnp.asarray(-0.3, jnp.float32)
    ref.alpha_opt = ref.alpha_tx.init(ref.log_alpha)
    ours.params = interop.rl_params_from_jax(ref.params)[0]
    ours.target_q = interop.rl_params_from_jax(ref.target_q)[0]
    ours.log_alpha = torch.tensor(-0.3)
    ours.opt_state = ours.tx.init(ours.params)
    ours.alpha_opt = ours.alpha_tx.init(ours.log_alpha)
    batch = _batch()
    key = jax.random.PRNGKey(11)
    kc, ka = jax.random.split(key)
    n = len(batch["obs"])
    (jparams, _, jtarget, jlog_alpha, _, jc, ja) = ref._update(
        ref.params, ref.opt_state, ref.target_q, ref.log_alpha,
        ref.alpha_opt, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    c, a = ours._update(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        eps_critic=torch.from_numpy(
            np.array(jax.random.normal(kc, (n, 1)))),
        eps_actor=torch.from_numpy(
            np.array(jax.random.normal(ka, (n, 1)))))
    np.testing.assert_allclose(float(c), float(jc), rtol=TOL)
    np.testing.assert_allclose(float(a), float(ja), rtol=TOL)
    allowance = 1e-2 * ours.config.lr
    assert_params(interop.rl_params_to_jax(ours.params),
                  jax.tree.map(np.asarray, jparams), TOL, allowance, "sac")
    assert_params(interop.rl_params_to_jax(ours.target_q),
                  jax.tree.map(np.asarray, jtarget), TOL, allowance,
                  "target")
    np.testing.assert_allclose(float(ours.log_alpha), float(jlog_alpha),
                               rtol=0, atol=TOL)
    ref.stop()
    ours.stop()


def test_short_run_learns_from_clean_replay(two_threads):
    algo = _config(sac, updates_per_iteration=4,
                   num_steps_sampled_before_learning=64).build()
    try:
        rows = [algo.train() for _ in range(60)]
        learning = [r for r in rows
                    if np.isfinite(r["learner/critic_loss"])]
        assert learning and all(np.isfinite(r["learner/actor_loss"])
                                for r in learning)
        assert rows[-1]["alpha"] < 1.0
        assert np.isfinite(rows[-1]["episode_return_mean"])
        # 60 x 4 steps x 2 lanes, less the one autoreset step a lane
        assert len(algo.buffer) == 60 * 4 * 2 - 2
        assert all(t.device.type == "cpu" for t in
                   jax.tree.leaves(algo.params))
    finally:
        algo.stop()


def test_state_round_trip(tmp_path, two_threads):
    a = _config(sac, num_steps_sampled_before_learning=8).build()
    b = _config(sac, seed=3).build()
    a.train()
    a.save_to_path(str(tmp_path / "ck"))
    b.restore_from_path(str(tmp_path / "ck"))
    for x, y in zip(jax.tree.leaves(a.get_weights()),
                    jax.tree.leaves(b.get_weights())):
        np.testing.assert_array_equal(x, y)
    assert float(a.log_alpha) == float(b.log_alpha)
    b.train()  # the restored tensors take the next update
    a.stop()
    b.stop()


def test_evaluation_refused():
    with pytest.raises(ValueError, match="no separate evaluation"):
        _config(sac, evaluation_interval=1).build()
