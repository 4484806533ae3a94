"""The port's env layer (ray_tpu_torch/rllib/envs.py) against gymnasium:
``make_vec("CartPole-v1", N)`` against ``gymnasium.make_vec`` (whose
``CartPoleVectorEnv`` it copies) and ``make_vec("PixelCatch-v0", N)``
against gymnasium's sync vector env over the JAX package's registered
``PixelCatch``, from the same seed under the same seeded actions for
600 steps, through terminations, the 500-step truncation and the
next-step autoreset: observations, rewards, terminations and
truncations bit-equal, dtypes included. Also the spaces, `make`, and
the refusal of an unknown id."""

import numpy as np
import pytest

from ray_tpu_torch.rllib import envs

gym = pytest.importorskip("gymnasium")

STEPS = 600


def _gym_vec(env_id: str, n: int):
    if env_id == "PixelCatch-v0":
        import ray_tpu.rllib.envs as jax_envs  # registers PixelCatch-v0

        jax_envs.register_envs()
    return gym.make_vec(env_id, num_envs=n)


def _actions(env_id: str, obs, rng, episodes) -> np.ndarray:
    """Seeded actions; on CartPole a lane mostly balances the pole in
    every other episode (so it reaches the 500-step truncation) and
    acts at random in the others (so it terminates)."""
    n = len(episodes)
    rand = rng.randint(0, 3 if env_id == "PixelCatch-v0" else 2, n)
    if env_id != "CartPole-v1":
        return rand
    ctrl = (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)
    keep = ((np.arange(n) + episodes) % 2 == 0) & (rng.rand(n) > 0.05)
    return np.where(keep, ctrl, rand)


@pytest.mark.parametrize("env_id,n,seed", [
    ("CartPole-v1", 1, 0), ("CartPole-v1", 16, 3),
    ("PixelCatch-v0", 1, 0), ("PixelCatch-v0", 8, 5)])
def test_streams_bit_equal_to_gymnasium(env_id, n, seed):
    ref, port = _gym_vec(env_id, n), envs.make_vec(env_id, n)
    o_ref, _ = ref.reset(seed=seed)
    o_port, _ = port.reset(seed=seed)
    assert o_port.dtype == o_ref.dtype
    np.testing.assert_array_equal(o_port, o_ref)
    rng = np.random.RandomState(seed)
    ends = {"term": 0, "trunc": 0}
    episodes = np.zeros(n, np.int64)
    for _ in range(STEPS):
        a = _actions(env_id, o_ref, rng, episodes)
        want = ref.step(a)
        got = port.step(a)
        for x, y in zip(got[:4], want[:4]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        o_ref = want[0]
        ends["term"] += int(want[2].sum())
        ends["trunc"] += int(want[3].sum())
        episodes += want[2] | want[3]
    ref.close()
    port.close()
    assert ends["term"] > 0
    if env_id == "CartPole-v1":
        assert ends["trunc"] > 0  # the 500-step truncation was crossed


@pytest.mark.parametrize("env_id", ["CartPole-v1", "PixelCatch-v0"])
def test_spaces_match_gymnasium(env_id):
    if env_id == "PixelCatch-v0":
        import ray_tpu.rllib.envs  # noqa: F401  registers PixelCatch-v0
    ref = gym.make(env_id)
    one = envs.make(env_id)
    vec = envs.make_vec(env_id, 3)
    for space in (one.observation_space, vec.single_observation_space):
        assert space.shape == ref.observation_space.shape
        assert space.dtype == ref.observation_space.dtype
        np.testing.assert_array_equal(space.low, ref.observation_space.low)
        np.testing.assert_array_equal(space.high,
                                      ref.observation_space.high)
    assert one.action_space.n == vec.single_action_space.n \
        == ref.action_space.n


def test_make_gives_one_lane():
    env = envs.make("CartPole-v1")
    obs, _ = env.reset(seed=1)
    assert obs.shape == (4,) and obs.dtype == np.float32
    obs, r, term, trunc, _ = env.step(1)
    assert obs.shape == (4,) and r == 1.0
    assert isinstance(term, bool) and isinstance(trunc, bool)


def test_unknown_id_names_the_registered_ones():
    with pytest.raises(ValueError,
                       match="CartPole-v1.*Pendulum-v1.*PixelCatch-v0"):
        envs.make_vec("MountainCar-v0", 2)
    with pytest.raises(ValueError, match="unknown env"):
        envs.make("Breakout-v5")


def test_pixel_catch_lane_seeds_follow_gymnasium():
    """reset(seed=s) seeds lane i with s + i, as gymnasium's sync vector
    env does: lane i of a 4-lane env starts as a lone env seeded s + i."""
    vec = envs.make_vec("PixelCatch-v0", 4)
    obs, _ = vec.reset(seed=10)
    for i in range(4):
        lone, _ = envs.PixelCatch().reset(seed=10 + i)
        np.testing.assert_array_equal(obs[i], lone)
