"""The port's DQN and replay buffers (ray_tpu_torch/rllib/dqn.py,
replay.py) against the JAX package on the CPU: one DQN update (the
double-Q or plain Huber TD loss with PER importance weights, Adam)
from the same params and target on a fixed batch: the loss, the TD
errors and the updated params within 1e-4; `SumTree` and
`PrioritizedReplayBuffer` drawing the same indices and weights under
the same seed; the uniform ring buffer's wraparound; the runner's
1/epsilon-sharpened Q head; and a 12-iteration prioritized-replay run
whose losses are present and finite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import replay as jreplay
from ray_tpu_torch import interop
from ray_tpu_torch.rllib import dqn, replay
from tests.test_torch_rllib_learner import assert_params

TOL = 1e-4
ADAM_ELEMENT_ATOL = 1e-2 * 5e-4  # a hundredth of DQN's learning rate


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(mod, double_q=True, **kw):
    cfg = (mod.DQNConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                        rollout_fragment_length=8)
           .training(double_q=double_q, **kw))
    if mod is dqn:
        cfg.training(device="cpu")
    return cfg


def _batch(n: int = 32) -> dict:
    rng = np.random.RandomState(0)
    return {"obs": rng.randn(n, 4).astype(np.float32),
            "actions": rng.randint(0, 2, n),
            "rewards": rng.rand(n).astype(np.float32),
            "next_obs": rng.randn(n, 4).astype(np.float32),
            "dones": (rng.rand(n) < 0.2).astype(np.float32),
            "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)}


@pytest.mark.parametrize("double_q", [True, False])
def test_update_equals_jax(double_q, two_threads):
    ref = _config(jdqn, double_q).build()
    ours = _config(dqn, double_q).build()
    ref.target_params = jmodels.init_mlp_policy(jax.random.PRNGKey(9), 4, 2)
    ours.params, _ = interop.rl_params_from_jax(ref.params)
    ours.target_params, _ = interop.rl_params_from_jax(ref.target_params)
    ours.opt_state = ours.tx.init(ours.params)
    batch = _batch()
    loss, td = ours._update(batch)
    jparams, _, jloss, jtd = ref._update(
        ref.params, ref.opt_state, ref.target_params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss, float(jloss), rtol=TOL)
    np.testing.assert_allclose(td, np.asarray(jtd), rtol=0,
                               atol=TOL * np.abs(np.asarray(jtd)).max())
    assert_params(interop.rl_params_to_jax(ours.get_weights()),
                  jax.tree.map(np.asarray, jparams), TOL,
                  ADAM_ELEMENT_ATOL, "dqn")
    ref.stop()
    ours.stop()


def test_runner_gets_the_sharpened_q_head():
    algo = _config(dqn).build()
    algo._env_steps = 5000  # epsilon 0.525
    algo._sync_runner_weights()
    eps = algo._epsilon()
    runner = algo.env_runner_group.local.get_weights()
    want = algo.get_weights()
    np.testing.assert_allclose(runner["pi"][-1]["w"],
                               want["pi"][-1]["w"] / eps, rtol=1e-6)
    np.testing.assert_array_equal(runner["pi"][0]["w"], want["pi"][0]["w"])
    algo.stop()


def test_sum_tree_equals_jax():
    ours, ref = replay.SumTree(13), jreplay.SumTree(13)
    rng = np.random.RandomState(1)
    for _ in range(4):
        idx = rng.randint(0, 13, 5)
        val = rng.rand(5)
        ours.set(idx, val)
        ref.set(idx, val)
    np.testing.assert_array_equal(ours.tree, ref.tree)
    prefix = rng.rand(50) * ref.total()
    np.testing.assert_array_equal(ours.sample(prefix), ref.sample(prefix))


def test_prioritized_buffer_draws_equal_jax():
    kw = dict(capacity=40, alpha=0.6, beta=0.4, seed=3)
    ours, ref = replay.PrioritizedReplayBuffer(**kw), \
        jreplay.PrioritizedReplayBuffer(**kw)
    rng = np.random.RandomState(2)
    for _ in range(3):
        b = {"obs": rng.randn(17, 4).astype(np.float32),
             "actions": rng.randint(0, 2, 17)}
        ours.add_batch(b)
        ref.add_batch(b)
        got, want = ours.sample(8), ref.sample(8)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        td = rng.randn(8)
        ours.update_priorities(got["idxs"], td)
        ref.update_priorities(want["idxs"], td)
    assert len(ours) == len(ref) == 40


def test_ring_buffer_wraparound_equals_jax():
    ours, ref = dqn.ReplayBuffer(5, 2), jdqn.ReplayBuffer(5, 2)
    for n in (3, 4):
        obs = np.arange(2 * n, dtype=np.float32).reshape(n, 2) + 10 * n
        args = (obs, np.arange(n), np.ones(n, np.float32), obs + 1,
                np.zeros(n, bool))
        ours.add_batch(*args)
        ref.add_batch(*args)
    assert (ours.pos, ours.size, len(ours)) == (ref.pos, ref.size, 5) == \
        (2, 5, 5)
    np.testing.assert_array_equal(ours.obs, ref.obs)
    np.testing.assert_array_equal(ours.actions, ref.actions)
    s1 = ours.sample(6, np.random.RandomState(4))
    s2 = ref.sample(6, np.random.RandomState(4))
    for k in s2:
        np.testing.assert_array_equal(s1[k], s2[k])


def test_prioritized_dqn_twelve_iterations(two_threads):
    algo = (dqn.DQNConfig(prioritized_replay=True)
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=16)
            .training(num_steps_sampled_before_learning=64,
                      updates_per_iteration=8, target_update_freq=20,
                      device="cpu")).build()
    rows, syncs, target = [], 0, algo.target_params
    for _ in range(12):
        r = algo.train()
        rows.append(r)
        syncs += algo.target_params is not target
        target = algo.target_params
    losses = [r["learner/td_loss"] for r in rows]
    learned = [x for x in losses if x == x]
    assert len(learned) >= 10 and all(np.isfinite(learned))
    assert algo._updates == 8 * len(learned)
    assert syncs == algo._updates // 20
    sizes = [r["buffer_size"] for r in rows]
    assert sizes == sorted(sizes) and sizes[-1] > sizes[0]
    eps = [r["epsilon"] for r in rows]
    assert all(b < a for a, b in zip(eps, eps[1:]))
    algo.stop()
