"""The port's classic RL driver on the CPU (``device="cpu"``): PPO learns
CartPole inline with the JAX package's recipe (best episode return >=
195 within 40 iterations), `Algorithm.step` with periodic evaluation
for PPO and DQN, checkpoint round trips (``save_checkpoint`` /
``load_checkpoint`` and ``save_to_path`` / ``restore_from_path``:
params equal, the iteration clock carried over, the JAX package's file
format), ``pipeline_sampling``, the refusals (remote env runners, search
markers, the card's default without a card), and the env runner's
bookkeeping (``reset_mask``, the bootstrap value, episode returns)."""

import os
import pickle

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import (
    DQNConfig,
    EnvRunnerGroup,
    PPOConfig,
    SingleAgentEnvRunner,
)
from ray_tpu_torch.tune import grid_search, uniform


@pytest.fixture
def two_threads():
    """Train on two threads, leaving the other test workers their CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ppo(**training):
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=32)
            .training(num_sgd_iter=2, minibatch_size=64, device="cpu",
                      **training))


def _dqn(**training):
    return (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=16)
            .training(num_steps_sampled_before_learning=32,
                      updates_per_iteration=4, device="cpu", **training))


def _weights(algo):
    return [np.array(x) for x in _flat(algo.get_weights())]


def _flat(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _flat(v)]
    return [t]


def test_ppo_learns_cartpole_inline(two_threads):
    """The JAX package's test_ppo_learns_cartpole_inline recipe."""
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .training(num_sgd_iter=6, minibatch_size=256,
                      device="cpu")).build()
    best = 0.0
    for _ in range(40):
        r = algo.train()
        if r["episode_return_mean"] == r["episode_return_mean"]:
            best = max(best, r["episode_return_mean"])
        if best >= 195:
            break
    algo.stop()
    assert best >= 195, f"PPO failed to learn CartPole (best {best})"


@pytest.mark.parametrize("make", [_ppo, _dqn], ids=["ppo", "dqn"])
def test_step_with_periodic_evaluation(make, two_threads):
    algo = make().evaluation(evaluation_interval=2,
                             evaluation_duration=2).build()
    results = [algo.train() for _ in range(4)]
    assert ["evaluation" in r for r in results] == [False, True, False, True]
    ev = results[1]["evaluation"]
    assert ev["num_episodes"] >= 0 and "episode_return_mean" in ev
    assert [r["training_iteration"] for r in results] == [1, 2, 3, 4]
    assert algo._timesteps_total == 4 * algo.config.num_envs_per_env_runner \
        * algo.config.rollout_fragment_length
    # the evaluation runner took the algorithm's weights
    eval_w = [np.array(x) for x in
              _flat(algo._eval_group.local.get_weights())]
    if make is _ppo:
        for a, b in zip(eval_w, _weights(algo)):
            np.testing.assert_array_equal(a, b)
    algo.stop()


@pytest.mark.parametrize("make", [_ppo, _dqn], ids=["ppo", "dqn"])
@pytest.mark.parametrize("via", ["checkpoint", "path"])
def test_checkpoint_round_trip(make, via, tmp_path, two_threads):
    algo = make().build()
    for _ in range(3):
        algo.train()
    want = _weights(algo)
    clock = (algo._iteration, algo._timesteps_total)
    fresh = make(seed=1).build()
    assert any(np.abs(a - b).max() > 0
               for a, b in zip(_weights(fresh), want))
    if via == "checkpoint":
        state = algo.save_checkpoint()
        assert all(isinstance(x, np.ndarray)
                   for x in _flat(algo.get_weights()))
        fresh.load_checkpoint(pickle.loads(pickle.dumps(state)))
    else:
        path = algo.save_to_path(str(tmp_path / "ckpt"))
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            payload = pickle.load(f)
        assert payload["class"] == type(algo).__name__
        assert set(payload["state"]) >= set(algo.STATE_COMPONENTS)
        fresh.restore_from_path(path)
    for a, b in zip(_weights(fresh), want):
        np.testing.assert_array_equal(a, b)
    assert (fresh._iteration, fresh._timesteps_total) == clock
    r = fresh.train()  # trains on from the restored state
    assert r["training_iteration"] == clock[0] + 1
    algo.stop()
    fresh.stop()


def test_dqn_state_tensors_return_to_the_device():
    algo = _dqn().build()
    algo.train()
    algo.train()
    state = algo.get_state()
    assert isinstance(state["opt_state"].mu["pi"][0]["w"], np.ndarray)
    assert isinstance(state["_updates"], int)
    algo.set_state(state)
    assert isinstance(algo.params["pi"][0]["w"], torch.Tensor)
    assert algo.opt_state.mu["pi"][0]["w"].device.type == "cpu"
    assert algo.opt_state.count == state["opt_state"].count
    algo.train()  # the restored params and moments take a step
    algo.stop()


def test_pipeline_sampling_three_iterations(two_threads):
    algo = _ppo(pipeline_sampling=True).build()
    for i in range(3):
        r = algo.train()
        assert r["env_steps_per_sec"] > 0
        assert r["time_learn_s"] >= 0 and r["time_sample_s"] >= 0
        assert r["num_env_steps_sampled"] == 8 * 32
        assert np.isfinite(r["learner/total_loss"])
    assert algo._env_steps_total == 3 * 8 * 32
    algo.stop()
    assert algo._learn_executor is None


def test_remote_env_runners_refused():
    with pytest.raises(ValueError, match="no runtime"):
        EnvRunnerGroup(num_env_runners=2, device="cpu")
    with pytest.raises(ValueError, match="num_env_runners=2.*no runtime"):
        PPOConfig().training(device="cpu").build()  # the default: 2


@pytest.mark.parametrize("marker", [grid_search([1e-3, 3e-4]),
                                    uniform(1e-4, 1e-3)],
                         ids=["grid", "domain"])
def test_search_markers_refused(marker):
    cfg = _ppo(lr=marker)
    assert cfg.extract_param_space() == {"lr": marker}
    with pytest.raises(ValueError, match="search markers"):
        cfg.build()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert PPOConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOConfig().env_runners(num_env_runners=0).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleAgentEnvRunner()


def test_runner_bookkeeping():
    """reset_mask[t] is the previous step's done (carried across
    fragments); last_values is the module's value at the final
    observation; the completed episodes' returns add up to the rewards
    of their steps."""
    runner = SingleAgentEnvRunner("CartPole-v1", num_envs=4,
                                  rollout_fragment_length=40, seed=2,
                                  device="cpu")
    prev_last_done = np.zeros(4, bool)
    total_reward, completed = 0.0, []
    for _ in range(3):
        s = runner.sample()
        assert s["obs"].shape == (40, 4, 4)
        np.testing.assert_array_equal(s["reset_mask"][0], prev_last_done)
        np.testing.assert_array_equal(s["reset_mask"][1:], s["dones"][:-1])
        prev_last_done = s["dones"][-1]
        _, value = runner.module.forward_train(
            runner.params, {"obs": torch.from_numpy(runner.obs)}).values()
        np.testing.assert_allclose(s["last_values"], value.numpy(),
                                   rtol=1e-6, atol=1e-6)
        # an autoreset step's reward is 0: it is no step of an episode
        assert (s["rewards"][s["reset_mask"]] == 0).all()
        total_reward += float(s["rewards"].sum())
        completed = runner._completed_returns
    open_returns = float(runner._ep_returns.sum())
    assert len(completed) > 0
    assert sum(completed) + open_returns == pytest.approx(total_reward)
