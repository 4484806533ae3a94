"""The port's env layer: spaces, vector envs and a registry, in place
of gymnasium.

The JAX package's env runners build their envs with ``gym.make_vec``
and probe spaces with ``gym.make`` (``ray_tpu/rllib/env_runner.py``,
``ppo.py``, ``dqn.py``). The port carries its own copies of the envs
its algorithms run, so it needs no gymnasium:

- ``"CartPole-v1"``: `CartPoleVectorEnv`, a copy of gymnasium 1.2.2's
  ``CartPoleVectorEnv`` (``gymnasium/envs/classic_control/cartpole.py``),
  which is what ``gym.make_vec("CartPole-v1")`` builds: the same
  physics, the 500-step truncation, the next-step autoreset inside
  `step`, and the same seeding (one ``PCG64`` generator over a
  ``SeedSequence(seed)`` for every lane), so its streams are gymnasium's
  bit for bit.
- ``"PixelCatch-v0"``: the JAX package's `PixelCatch`
  (``ray_tpu/rllib/envs.py``) behind `SyncVectorEnv`, a copy of
  gymnasium's ``SyncVectorEnv`` in its next-step autoreset mode.
- ``"Pendulum-v1"``: `Pendulum`, a copy of gymnasium 1.2.2's
  ``PendulumEnv`` (``gymnasium/envs/classic_control/pendulum.py``,
  without rendering) with its registered 200-step ``TimeLimit``,
  behind `SyncVectorEnv`, which is what
  ``gym.make_vec("Pendulum-v1")`` builds: a continuous `Box` action.

Next-step autoreset: the step on which a lane ends returns that
episode's last observation with done set; the lane's next `step`
ignores its action and returns the new episode's first observation,
reward 0 and done unset.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


class Box:
    """A box of `shape` between `low` and `high` (gymnasium's
    ``spaces.Box``: scalar bounds are broadcast to the shape)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low)
        self.shape = tuple(int(d) for d in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype),
                                   self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype),
                                    self.shape).copy()

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Discrete:
    """The actions 0 .. n-1 (gymnasium's ``spaces.Discrete``)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


def _np_random(seed: int | None) -> np.random.Generator:
    """gymnasium's ``seeding.np_random``: one PCG64 over a SeedSequence
    (fresh entropy when `seed` is None)."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class CartPoleVectorEnv:
    """N CartPole lanes stepped as one numpy program (gymnasium 1.2.2's
    ``CartPoleVectorEnv``): reward 1 a step, an episode ends when the
    pole leans past 12 degrees or the cart leaves +-2.4 (terminated) or
    after `max_episode_steps` steps (truncated)."""

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 500):
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.low, self.high = -0.05, 0.05
        self.single_action_space = Discrete(2)
        self.single_observation_space = Box(-high, high, dtype=np.float32)
        self.state = None
        self.steps = np.zeros(num_envs, dtype=np.int32)
        self.prev_done = np.zeros(num_envs, dtype=np.bool_)
        self._np_random = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = _np_random(None)
        return self._np_random

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._np_random = _np_random(seed)
        self.state = self.np_random.uniform(low=self.low, high=self.high,
                                            size=(4, self.num_envs))
        self.steps = np.zeros(self.num_envs, dtype=np.int32)
        self.prev_done = np.zeros(self.num_envs, dtype=np.bool_)
        return self.state.T.astype(np.float32), {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset before step")
        action = np.asarray(action)
        x, x_dot, theta, theta_dot = self.state
        force = np.sign(action - 0.5) * self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        # explicit Euler, gymnasium's default integrator
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.stack((x, x_dot, theta, theta_dot))

        terminated = ((x < -self.x_threshold) | (x > self.x_threshold)
                      | (theta < -self.theta_threshold_radians)
                      | (theta > self.theta_threshold_radians))
        self.steps += 1
        truncated = self.steps >= self.max_episode_steps
        reward = np.ones_like(terminated, dtype=np.float32)

        # next-step autoreset of the lanes done on the previous step
        self.state[:, self.prev_done] = self.np_random.uniform(
            low=self.low, high=self.high, size=(4, self.prev_done.sum()))
        self.steps[self.prev_done] = 0
        reward[self.prev_done] = 0.0
        terminated[self.prev_done] = False
        truncated[self.prev_done] = False
        self.prev_done = np.logical_or(terminated, truncated)
        return (self.state.T.astype(np.float32), reward, terminated,
                truncated, {})

    def close(self):
        pass


class PixelCatch:
    """10x10x1 uint8 pixel grid; 3 actions (left/stay/right); +1 catch,
    -1 miss; an episode is `balls` balls. A copy of the JAX package's
    ``PixelCatch`` (``ray_tpu/rllib/envs.py``), the MinAtar-style
    stand-in for an Atari env: a ball falls down the grid and the agent
    moves a paddle along the bottom row to catch it."""

    def __init__(self, size: int = 10, balls: int = 5):
        self.size = size
        self.balls = balls
        self.observation_space = Box(0, 255, (size, size, 1), np.uint8)
        self.action_space = Discrete(3)
        self._rng = np.random.default_rng(0)

    def _obs(self) -> np.ndarray:
        frame = np.zeros((self.size, self.size, 1), np.uint8)
        frame[self.ball_y, self.ball_x, 0] = 255
        frame[self.size - 1, self.paddle_x, 0] = 128
        return frame

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._balls_left = self.balls
        self._new_ball()
        self.paddle_x = self.size // 2
        return self._obs(), {}

    def _new_ball(self):
        self.ball_x = int(self._rng.integers(0, self.size))
        self.ball_y = 0

    def step(self, action):
        self.paddle_x = int(np.clip(self.paddle_x + (int(action) - 1),
                                    0, self.size - 1))
        self.ball_y += 1
        reward = 0.0
        terminated = False
        if self.ball_y >= self.size - 1:
            reward = 1.0 if self.ball_x == self.paddle_x else -1.0
            self._balls_left -= 1
            if self._balls_left <= 0:
                terminated = True
            else:
                self._new_ball()
        return self._obs(), reward, terminated, False, {}

    def close(self):
        pass


def angle_normalize(x):
    """An angle in [-pi, pi) (gymnasium's ``angle_normalize``)."""
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class Pendulum:
    """The inverted pendulum swing-up (gymnasium 1.2.2's
    ``PendulumEnv`` under its ``TimeLimit`` of 200 steps): observation
    (cos theta, sin theta, theta dot), one torque in [-2, 2], reward
    -(theta^2 + 0.1 theta_dot^2 + 0.001 u^2); the start is a uniform
    angle in [-pi, pi] and speed in [-1, 1]."""

    def __init__(self, g: float = 10.0, max_episode_steps: int = 200):
        self.max_speed = 8
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0
        self.max_episode_steps = max_episode_steps
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(-self.max_torque, self.max_torque, (1,),
                                np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self._np_random = None
        self._elapsed_steps = 0

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = _np_random(None)
        return self._np_random

    def step(self, u):
        th, thdot = self.state  # th := theta
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                            + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= self.max_episode_steps
        return self._get_obs(), -costs, False, truncated, {}

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._np_random = _np_random(seed)
        high = np.array([np.pi, 1.0])
        if options is not None:
            high = np.array([float(options.get("x_init", np.pi)),
                             float(options.get("y_init", 1.0))])
        self.state = self.np_random.uniform(low=-high, high=high)
        self._elapsed_steps = 0
        return self._get_obs(), {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)

    def close(self):
        pass


class SyncVectorEnv:
    """N single envs stepped in turn (gymnasium's ``SyncVectorEnv`` in
    next-step autoreset mode): ``reset(seed=s)`` seeds lane i with
    ``s + i``; a lane done on the previous step is reset without a seed,
    with reward 0 and done unset. Rewards are float64, as gymnasium's."""

    def __init__(self, env_fns: list[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        space = self.single_observation_space
        self._obs = np.zeros((self.num_envs, *space.shape), space.dtype)
        self._rewards = np.zeros(self.num_envs, np.float64)
        self._terminations = np.zeros(self.num_envs, np.bool_)
        self._truncations = np.zeros(self.num_envs, np.bool_)
        self._autoreset_envs = np.zeros(self.num_envs, np.bool_)

    def reset(self, *, seed: int | None = None, options=None):
        seed = [None if seed is None else seed + i
                for i in range(self.num_envs)]
        self._terminations[:] = False
        self._truncations[:] = False
        self._autoreset_envs[:] = False
        for i, (env, s) in enumerate(zip(self.envs, seed)):
            self._obs[i], _ = env.reset(seed=s, options=options)
        return self._obs.copy(), {}

    def step(self, actions):
        for i, (env, action) in enumerate(zip(self.envs, actions)):
            if self._autoreset_envs[i]:
                self._obs[i], _ = env.reset()
                self._rewards[i] = 0.0
                self._terminations[i] = False
                self._truncations[i] = False
            else:
                (self._obs[i], self._rewards[i], self._terminations[i],
                 self._truncations[i], _) = env.step(action)
        self._autoreset_envs = np.logical_or(self._terminations,
                                             self._truncations)
        return (self._obs.copy(), self._rewards.copy(),
                self._terminations.copy(), self._truncations.copy(), {})

    def close(self):
        for env in self.envs:
            env.close()


class _OneLane:
    """A single env's face over a one-lane vector env (`make`): its
    spaces are the lane's, and a done episode restarts on the next
    `step`, as in the vector env."""

    def __init__(self, venv):
        self._venv = venv
        self.observation_space = venv.single_observation_space
        self.action_space = venv.single_action_space

    def reset(self, *, seed=None, options=None):
        obs, info = self._venv.reset(seed=seed, options=options)
        return obs[0], info

    def step(self, action):
        obs, r, term, trunc, info = self._venv.step(np.asarray([action]))
        return obs[0], r[0], bool(term[0]), bool(trunc[0]), info

    def close(self):
        self._venv.close()


def _pixel_catch_vec(num_envs: int) -> SyncVectorEnv:
    return SyncVectorEnv([PixelCatch] * num_envs)


def _pendulum_vec(num_envs: int) -> SyncVectorEnv:
    return SyncVectorEnv([Pendulum] * num_envs)


# id -> a builder of its vector env over `num_envs` lanes
REGISTRY: dict[str, Callable[[int], object]] = {
    "CartPole-v1": CartPoleVectorEnv,
    "PixelCatch-v0": _pixel_catch_vec,
    "Pendulum-v1": _pendulum_vec,
}


def _builder(env_id: str):
    if env_id not in REGISTRY:
        raise ValueError(f"unknown env {env_id!r}; the port registers "
                         f"{sorted(REGISTRY)}")
    return REGISTRY[env_id]


def make_vec(env_id: str, num_envs: int = 1):
    """The vector env of `env_id` over `num_envs` lanes (what
    ``gym.make_vec(env_id, num_envs=num_envs)`` builds)."""
    return _builder(env_id)(num_envs)


def make(env_id: str) -> _OneLane:
    """One env of `env_id`, for its ``observation_space`` and
    ``action_space`` (the algorithms' probe)."""
    return _OneLane(make_vec(env_id, 1))
