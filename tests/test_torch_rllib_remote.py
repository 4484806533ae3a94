"""RLlib's remote env runners on the port's cluster runtime, on the CPU
(``device="cpu"``): the JAX package's distributed scenarios of
tests/test_rllib.py with their own inputs and bars —
``test_ppo_distributed_env_runners`` (PPO through two runner actors
reaches an episode return of 195 within 300 s, in tier-1 as in JAX) and
``test_impala_distributed_async`` (slow as in JAX: IMPALA sampling its
runners asynchronously reaches 150 within 280 s) — and the runner
group's contract:

- ``PPOConfig().training(device="cpu").build()`` (the default of two
  runners) builds two runner actors in processes of their own;
- remote runner i's fragment equals, bit for bit, the fragment of a
  local `SingleAgentEnvRunner` seeded ``seed + 1000 * i`` with the same
  weights;
- after `sync_weights` every runner holds the learner's weights.

Sampled actions differ from the JAX package's (the port draws Gumbel
noise from torch's generator), so the bars are learning bars, not
streams. One module-scoped cluster: a head node of 8 CPUs (the JAX
fixture's), its worker processes at one intra-op thread each. Every get
carries a timeout.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.api import _global_runtime
from ray_tpu_torch.rllib import (
    EnvRunnerGroup,
    IMPALAConfig,
    PPOConfig,
    SingleAgentEnvRunner,
)
from ray_tpu_torch.util import tree


@pytest.fixture(scope="module")
def cluster():
    # runner processes inherit this: one intra-op thread each (a runner
    # claims one CPU), so their tiny forwards do not keep torch's spinning
    # thread pool busy on every core of the host
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def _actor_pids(handles) -> list:
    """The pid of each actor's worker process, from its nodelet."""
    rt = _global_runtime()
    st = rt.client.call(rt.nodelet_address, "node_stats", {}, timeout=10)
    by_actor = {w["actor_id"]: w["pid"] for w in st["workers"]
                if w["actor_id"]}
    return [by_actor[h._actor_id.hex()] for h in handles]


def _leaves(t) -> list:
    return [np.asarray(x) for x in tree.leaves(t)]


def test_default_ppo_builds_two_remote_runners(cluster):
    algo = PPOConfig().training(device="cpu").build()  # the default: 2
    try:
        group = algo.env_runner_group
        assert group.remote and len(group.runners) == 2
        assert not hasattr(group, "local")
        assert ray.get([r.ping.remote() for r in group.runners],
                       timeout=60) == ["pong", "pong"]
        pids = _actor_pids(group.runners)
        assert len(set(pids)) == 2 and os.getpid() not in pids
    finally:
        algo.stop()
    assert group.runners == []  # shutdown kills the actors


def test_remote_fragment_equals_local_runner(cluster):
    kw = dict(env="CartPole-v1", num_envs=4, rollout_fragment_length=24,
              seed=5, hidden=(32, 32))
    group = EnvRunnerGroup(num_env_runners=2, device="cpu", **kw)
    try:
        weights = SingleAgentEnvRunner(device="cpu", **{**kw, "seed": 77}
                                       ).get_weights()
        group.sync_weights(weights)
        remote = [group.sample(timeout=120), group.sample(timeout=120)]
        for i in range(2):
            local = SingleAgentEnvRunner(
                device="cpu", **{**kw, "seed": 5 + 1000 * i})
            local.set_weights(weights)
            for k in range(2):
                want = local.sample()
                got = remote[k][i]
                assert sorted(got) == sorted(want)
                for key, v in want.items():
                    if isinstance(v, np.ndarray):
                        assert got[key].dtype == v.dtype, key
                        np.testing.assert_array_equal(got[key], v,
                                                      err_msg=key)
                    else:
                        np.testing.assert_equal(got[key], v, err_msg=key)
    finally:
        group.shutdown()


def test_sync_weights_reach_every_runner(cluster):
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(num_sgd_iter=1, minibatch_size=64,
                      device="cpu")).build()
    try:
        group = algo.env_runner_group
        algo.train()  # the update moves the weights; the sync follows
        learner = _leaves(algo.learner.get_weights())
        for r in group.runners:
            got = _leaves(ray.get(r.get_weights.remote(), timeout=60))
            assert len(got) == len(learner)
            for a, b in zip(got, learner):
                np.testing.assert_array_equal(a, b)
    finally:
        algo.stop()


def test_ppo_distributed_env_runners(cluster):
    """PPO on CartPole THROUGH the runtime — env-runner actors sampling
    remotely, weight sync via the object store, reward >= 195 in < 5
    min (the JAX scenario's bar)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=128)
            .training(num_sgd_iter=6, minibatch_size=256,
                      device="cpu")).build()
    try:
        t0 = time.time()
        best = 0.0
        steps_per_sec = []
        while time.time() - t0 < 300:
            r = algo.train()
            steps_per_sec.append(r["env_steps_per_sec"])
            if r["episode_return_mean"] == r["episode_return_mean"]:
                best = max(best, r["episode_return_mean"])
            if best >= 195:
                break
    finally:
        algo.stop()
        torch.set_num_threads(n)
    assert best >= 195, f"PPO (distributed) failed to learn (best {best})"
    assert max(steps_per_sec) > 100  # sanity: sampling actually parallel


@pytest.mark.slow  # as in the JAX file: covered by faster siblings
def test_impala_distributed_async(cluster):
    """Remote env runners sampled asynchronously (no per-iteration
    barrier) — learning still happens end-to-end through the runtime."""
    algo = (IMPALAConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .training(device="cpu")).build()
    try:
        t0 = time.time()
        best = 0.0
        while time.time() - t0 < 280:
            r = algo.train()
            m = r["episode_return_mean"]
            if m == m:
                best = max(best, m)
            if best >= 150:
                break
    finally:
        algo.stop()
    assert best >= 150, f"IMPALA (distributed) no learning (best {best})"
