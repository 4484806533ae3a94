"""The port's off-policy estimators (ray_tpu_torch/rllib/ope.py) against
the JAX package on the CPU: `split_episodes`; IS, WIS and DR on the
same logged rows (sampled from a JAX policy, with truncated and
unfinished episodes) and the same target params (carried across by
``interop.rl_params_from_jax``, or given as host arrays) within 1e-5
relative; and the on-policy identity (every importance ratio 1: IS and
WIS are the behavior return, DR telescopes to it) within 1e-4. The
estimators run on the CPU because the tests name it; by default they
run on the card and raise without one."""

import jax
import numpy as np
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import ope as jope
from ray_tpu_torch import interop
from ray_tpu_torch.rllib import ope

TOL = 1e-5
GAMMA = 0.97
ESTIMATORS = ["ImportanceSampling", "WeightedImportanceSampling",
              "DoublyRobust"]


def _policy(seed):
    return jmodels.init_mlp_policy(jax.random.PRNGKey(seed), 4, 2, (16,))


def _rows(params, n_episodes=8, T=12, seed=0):
    """Episodes sampled from the JAX policy (the logged logp exact); the
    last episode is cut by truncation, a tail is left unfinished."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    sample = jax.jit(jmodels.sample_actions)
    rows = []
    for ep in range(n_episodes):
        for t in range(T - ep % 3):
            obs = rng.randn(4).astype(np.float32)
            key, k = jax.random.split(key)
            a, logp, _ = sample(params, obs[None], k)
            last = t == T - ep % 3 - 1
            rows.append({"obs": obs.tolist(), "action": int(a[0]),
                         "reward": float(rng.rand()),
                         "done": last and ep < n_episodes - 2,
                         "truncated": last and ep == n_episodes - 2,
                         "logp": float(logp[0])})
    return rows


@pytest.fixture(scope="module")
def behavior():
    return _policy(1)


@pytest.fixture(scope="module")
def rows(behavior):
    return _rows(behavior)


def test_split_episodes_equal_jax(rows):
    got, want = ope.split_episodes(rows), jope.split_episodes(rows)
    assert [len(e) for e in got] == [len(e) for e in want]
    assert len(got) == 8
    small = [{"done": False, "truncated": False},
             {"done": True, "truncated": False},
             {"done": False, "truncated": True},
             {"done": False, "truncated": False}]
    assert [len(e) for e in ope.split_episodes(small)] == [2, 1, 1]


@pytest.mark.parametrize("name", ESTIMATORS)
@pytest.mark.parametrize("target", [1, 99], ids=["on_policy", "other"])
@pytest.mark.parametrize("host", [False, True], ids=["tensors", "arrays"])
def test_estimates_equal_jax(rows, name, target, host):
    jp = _policy(target)
    params = interop.rl_params_from_jax(jp)[0]
    if host:
        params = interop.rl_params_to_jax(params)
    got = getattr(ope, name)(params, gamma=GAMMA,
                             device="cpu").estimate(rows)
    want = getattr(jope, name)(jp, gamma=GAMMA).estimate(rows)
    assert sorted(got) == sorted(want)
    assert got["num_episodes"] == want["num_episodes"] == 8
    for k in ("v_target", "v_behavior", "v_gain"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)


def test_on_policy_identity(rows, behavior):
    params = interop.rl_params_from_jax(behavior)[0]
    episodes = ope.split_episodes(rows)
    behavior_return = np.mean([
        sum(GAMMA ** t * r["reward"] for t, r in enumerate(ep))
        for ep in episodes])
    for name in ESTIMATORS:
        est = getattr(ope, name)(params, gamma=GAMMA,
                                 device="cpu").estimate(rows)
        np.testing.assert_allclose(est["v_target"], behavior_return,
                                   rtol=1e-4, err_msg=name)
        if name != "DoublyRobust":
            np.testing.assert_allclose(est["v_gain"], 1.0, rtol=1e-4)


def test_no_rows():
    est = ope.ImportanceSampling(interop.rl_params_from_jax(_policy(1))[0],
                                 device="cpu")
    assert np.isnan(est.estimate([])["v_target"])


@pytest.mark.parametrize("host", [False, True], ids=["tensors", "arrays"])
def test_default_device_is_the_card(host):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    params = interop.rl_params_from_jax(_policy(1))[0]
    if host:
        params = interop.rl_params_to_jax(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ope.DoublyRobust(params)
