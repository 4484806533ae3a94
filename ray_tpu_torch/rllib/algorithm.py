"""Algorithm / AlgorithmConfig — the unified driver every family shares:
the port of ``ray_tpu/rllib/algorithm.py``.

Reference parity: rllib/algorithms/algorithm.py:241
(`Algorithm(Checkpointable, Trainable)`; `step()` :959 = one
training_step + periodic evaluation + metrics reduction) and
algorithm_config.py (fluent `.environment().env_runners().training()
.evaluation()` builder). The family subclasses implement `setup()` +
`training_step()`; the base owns:

- the Trainable contract (train/step/save_checkpoint/load_checkpoint);
- periodic evaluation on a dedicated local env runner;
- iteration/timestep bookkeeping and the shared MetricsLogger;
- Checkpointable state save/restore.

Config fields may hold search markers (`tune.grid_search([...])` or
Domain objects) for a Tuner to sweep; `build()` refuses them. The
config has one field the JAX config lacks, `device`: where the
algorithm's params, learner update and env runners' module run, the
card unless it names another (``device="cpu"`` runs the plain PyTorch
path on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ray_tpu_torch.rllib.checkpointable import Checkpointable
from ray_tpu_torch.rllib.metrics import MetricsLogger
from ray_tpu_torch.tune.trainable import Trainable
from ray_tpu_torch.util.device import resolve_device


def _is_search_marker(v) -> bool:
    from ray_tpu_torch.tune.search import Domain, _is_grid

    return isinstance(v, Domain) or _is_grid(v)


@dataclasses.dataclass
class AlgorithmConfig:
    """Fluent config base (reference: AlgorithmConfig — the same object
    carries env, env-runner, training, and evaluation settings and is
    the single source the algorithm builds from)."""

    env: str = "CartPole-v1"
    num_env_runners: int = 0
    num_envs_per_env_runner: int = 8
    rollout_fragment_length: int = 64
    gamma: float = 0.99
    lr: float = 3e-4
    hidden: tuple = (64, 64)
    framestack: int = 1
    model_config: dict | None = None
    seed: int = 0
    evaluation_interval: int = 0  # iterations between evals; 0 = never
    evaluation_duration: int = 3  # fragments sampled per eval
    device: str = "cuda"  # where params, updates and sampling run

    def environment(self, env: str):
        self.env = env
        return self

    def env_runners(self, **kw):
        return self._apply(kw)

    def training(self, **kw):
        return self._apply(kw)

    def evaluation(self, **kw):
        return self._apply(kw)

    def _apply(self, kw: dict):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown option {k!r}")
            setattr(self, k, v)
        return self

    def copy(self) -> "AlgorithmConfig":
        import copy as _copy

        return _copy.deepcopy(self)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def update_from_dict(self, d: dict):
        return self._apply(d)

    # -- tune integration -------------------------------------------------

    def extract_param_space(self) -> dict:
        """Fields holding search markers (grid_search dicts / Domain
        samplers) — the Tuner sweeps exactly these."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if _is_search_marker(getattr(self, f.name))}

    def validate(self):
        markers = self.extract_param_space()
        if markers:
            raise ValueError(
                f"config fields {sorted(markers)} still hold search "
                "markers — pass the config to Tuner, or set concrete "
                "values before build()")

    def build(self) -> "Algorithm":
        raise NotImplementedError


class Algorithm(Checkpointable, Trainable):
    """Shared driver skeleton. Subclasses implement `setup(config)` and
    `training_step()`; `train()` (inherited from Trainable) wraps one
    `step()` with iteration/time bookkeeping."""

    config_class: type = AlgorithmConfig
    STATE_COMPONENTS = ("_iteration", "_timesteps_total")

    def __init__(self, config=None):
        if config is None:
            config = self.config_class()
        elif isinstance(config, dict):
            config = self.config_class().update_from_dict(config)
        config.validate()
        # Trainable fields set inline (not via Trainable.__init__, which
        # would rebind self.config to a plain dict): the Trainable
        # contract here is only _iteration/_time_total + train()
        self.config = config
        self.device = resolve_device(config.device)
        self.metrics = MetricsLogger()
        self._iteration = 0
        self._time_total = 0.0
        self._timesteps_total = 0
        self._eval_group = None
        self.setup(config)

    def setup(self, config: "AlgorithmConfig"):
        raise NotImplementedError

    def training_step(self) -> dict:
        """One family-specific iteration: sample, learn, sync
        (reference: Algorithm.training_step — THE method families
        override)."""
        raise NotImplementedError

    def step(self) -> dict:
        """training_step + periodic evaluation (reference:
        Algorithm.step :959 — evaluate() interleaved by
        evaluation_interval)."""
        result = self.training_step() or {}
        sampled = result.get("num_env_steps_sampled")
        if sampled is not None:
            self._timesteps_total += int(sampled)
        else:
            # families reporting only the lifetime counter (DQN) still
            # advance the shared clock
            lifetime = result.get("num_env_steps_sampled_lifetime")
            if lifetime is not None:
                self._timesteps_total = int(lifetime)
        cfg = self.config
        if cfg.evaluation_interval and \
                (self._iteration + 1) % cfg.evaluation_interval == 0:
            result["evaluation"] = self.evaluate()
        return result

    # -- evaluation -------------------------------------------------------

    def evaluate(self) -> dict:
        """Sample evaluation episodes on a dedicated local runner with
        the current weights (reference: Algorithm.evaluate :1100 over the
        eval EnvRunnerGroup)."""
        from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup

        cfg = self.config
        if self._eval_group is None:
            self._eval_group = EnvRunnerGroup(
                num_env_runners=0, remote=False, env=cfg.env,
                num_envs=cfg.num_envs_per_env_runner,
                rollout_fragment_length=cfg.rollout_fragment_length,
                seed=cfg.seed + 100_000, hidden=cfg.hidden,
                framestack=cfg.framestack, model_config=cfg.model_config,
                device=self.device)
        self._eval_group.sync_weights(self.get_weights())
        returns, n_eps = [], 0
        for _ in range(max(1, cfg.evaluation_duration)):
            s = self._eval_group.sample()[0]
            if s["num_episodes"]:
                returns.append(s["episode_return_mean"])
                n_eps += s["num_episodes"]
        return {
            "episode_return_mean": float(np.mean(returns)) if returns
            else float("nan"),
            "num_episodes": n_eps,
        }

    # -- weights / checkpoint ---------------------------------------------

    def get_weights(self):
        raise NotImplementedError

    def save_checkpoint(self) -> dict:
        return self.get_state()

    def load_checkpoint(self, state: dict):
        self.set_state(state)

    # -- lifecycle --------------------------------------------------------

    def stop(self):
        if self._eval_group is not None:
            self._eval_group.shutdown()
            self._eval_group = None
        self.cleanup()
