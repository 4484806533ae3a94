"""The port's multi-agent PPO (ray_tpu_torch/rllib/multi_agent.py)
against the JAX package on the CPU: `CoordinationGame`'s streams
identical to JAX's under the same seeds and actions; given the same
trajectories and the same params (carried across by
``interop.rl_params_from_jax``), the per-policy batches equal (GAE per
agent, 1e-6) and one iteration's updates of independent policies equal
(the loss metrics within 1e-4 relative, the params within 1e-4 of each
leaf's largest plus an Adam per-element allowance); a shared-policy
iteration with its metric names; the default device refused without a
card."""

import copy

import jax
import numpy as np
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
from ray_tpu.rllib import multi_agent as jma
from ray_tpu_torch import interop
from ray_tpu_torch.rllib import multi_agent as ma
from tests.test_torch_rllib_learner import assert_params

TOL = 1e-4


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_coordination_game_streams_equal_jax():
    envs = [mod.CoordinationGame(episode_len=7) for mod in (ma, jma)]
    rng = np.random.default_rng(0)
    for ep in range(4):
        outs = [e.reset(seed=ep * 3 if ep % 2 else None)[0] for e in envs]
        assert all(np.array_equal(outs[0][a], outs[1][a])
                   for a in envs[0].agents)
        done = False
        while not done:
            act = {a: int(rng.integers(0, 2)) for a in envs[0].agents}
            got, want = (e.step(dict(act)) for e in envs)
            for a in envs[0].agents:
                np.testing.assert_array_equal(got[0][a], want[0][a])
            assert got[1:4] == want[1:4]
            done = got[2]["__all__"]


def _independent(mod, **kw):
    cfg = (mod.MultiAgentPPOConfig(rollout_episodes=3, minibatch_size=64,
                                   num_sgd_iter=2, **kw)
           .multi_agent(policies=["p0", "p1"],
                        policy_mapping_fn=lambda a: "p0" if a == "a0"
                        else "p1"))
    return cfg.build()


def test_batches_and_update_equal_jax(two_threads):
    ref = _independent(jma)
    ours = _independent(ma, device="cpu")
    for m in ("p0", "p1"):
        ours.module[m].set_weights(
            interop.rl_params_from_jax(ref.module[m].get_weights())[0])
    trajs, returns = ours._rollout()
    ours._iteration = 0
    seen = {}
    for m in ("p0", "p1"):
        learner = ref.module[m]
        plain = learner.update

        def spy(batch, m=m, plain=plain):
            seen[m] = copy.deepcopy(batch)
            return plain(batch)

        learner.update = spy
    ref._rollout = lambda: (copy.deepcopy(trajs), list(returns))
    ours._rollout = lambda: (copy.deepcopy(trajs), list(returns))
    want = ref.train()
    batches = ours.module_batches(copy.deepcopy(trajs))
    got = ours.train()
    assert sorted(batches) == sorted(seen) == ["p0", "p1"]
    for m in seen:
        assert sorted(batches[m]) == sorted(seen[m])
        for k in seen[m]:
            np.testing.assert_allclose(batches[m][k], seen[m][k], rtol=0,
                                       atol=1e-6, err_msg=f"{m} {k}")
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("learner/"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL,
                                       atol=1e-7, err_msg=k)
    assert got["episode_return_mean"] == want["episode_return_mean"]
    for m in ("p0", "p1"):
        assert_params(interop.rl_params_to_jax(ours.module[m].get_weights()),
                      jax.tree.map(np.asarray, ref.module[m].get_weights()),
                      TOL, 1e-2 * ours.config.lr, m)


def test_shared_policy_iteration(two_threads):
    algo = ma.MultiAgentPPOConfig(rollout_episodes=4, device="cpu").build()
    assert isinstance(algo.module, ma.MultiRLModule)
    assert set(algo.module.get_weights()) == {"shared"}
    r = algo.train()
    assert r["training_iteration"] == 1
    assert 0 <= r["episode_return_mean"] <= 25
    for k in ("total_loss", "policy_loss", "vf_loss", "entropy"):
        assert np.isfinite(r[f"learner/shared/{k}"]), k


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ma.MultiAgentPPOConfig().build()
