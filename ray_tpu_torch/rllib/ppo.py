"""PPO: the port of ``ray_tpu/rllib/ppo.py``.

Reference parity: PPOConfig/PPO (rllib/algorithms/ppo/ppo.py:60,363,
training_step :389): synchronous sampling from the EnvRunnerGroup →
Learner update → weight sync back to the runners. `num_learners > 1`
runs the learner on a ``data`` mesh of that many `torch.distributed`
ranks. The port is multi-controller there, as its serving on a mesh
is: every rank builds the same algorithm from the same seed, samples
the same fragments and feeds the learner the same batch, of which it
keeps its own rows; DTensor all-reduces the gradients (the JAX
package runs one controller and lets GSPMD insert the psum).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.connectors import (
    GeneralAdvantageEstimation,
    default_env_to_module,
)
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import PPOLearner, PPOLearnerConfig


@dataclasses.dataclass
class PPOConfig(AlgorithmConfig):
    """Fluent builder (reference: PPOConfig over AlgorithmConfig —
    .environment().env_runners().training())."""

    num_env_runners: int = 2
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.0
    num_sgd_iter: int = 6
    minibatch_size: int = 128
    num_learners: int = 0  # >1: a learner mesh of that many ranks
    learner_mesh: Any = None  # or pass an explicit DeviceMesh
    # Overlap sampling with the update (reference: the async learner
    # thread, rllib/execution/multi_gpu_learner_thread.py:21,141 —
    # sampling continues while the learner consumes the previous
    # batch). Queue depth 1: each batch is exactly one update stale,
    # which PPO's clipped importance ratio absorbs. Pays off when the
    # learner runs on the card while envs step on the host.
    pipeline_sampling: bool = False

    def learners(self, num_learners: int = 0) -> "PPOConfig":
        """num_learners > 1 runs the update on a ``data`` mesh of that
        many ranks of the process group (the reference spawns N NCCL
        learner actors, learner_group.py:134). The mesh is built at
        build(), so the config stays plain picklable data."""
        self.num_learners = int(num_learners)
        self.learner_mesh = None  # (re)derived at build()
        return self

    def _resolve_learner_mesh(self):
        if self.learner_mesh is not None:
            return self.learner_mesh
        if self.num_learners <= 1:
            return None
        import torch.distributed as dist

        from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.num_learners:
            raise ValueError(
                f"num_learners={self.num_learners} needs a process group "
                f"of {self.num_learners} ranks; it has {world}")
        return build_mesh(MeshSpec(data=self.num_learners),
                          device=self.device)

    def build(self) -> "PPO":
        return PPO(self)


class PPO(Algorithm):
    """Algorithm driver (reference: Algorithm.step → PPO.training_step
    :389 — sample, learn, sync; the shared train/eval/checkpoint
    skeleton lives in the Algorithm base)."""

    config_class = PPOConfig
    STATE_COMPONENTS = ("_iteration", "_timesteps_total",
                        "_env_steps_total")

    def get_state(self) -> dict:
        state = super().get_state()
        state["learner"] = {"params": self.learner.get_weights()}
        return state

    def set_state(self, state: dict):
        super().set_state(state)
        if "learner" in state:
            self.learner.set_weights(state["learner"]["params"])
            self.env_runner_group.sync_weights(self.learner.get_weights())

    def setup(self, config: PPOConfig):
        mesh = config._resolve_learner_mesh()
        self.env_runner_group = EnvRunnerGroup(
            num_env_runners=config.num_env_runners,
            remote=config.num_env_runners > 0,
            env=config.env,
            num_envs=config.num_envs_per_env_runner,
            rollout_fragment_length=config.rollout_fragment_length,
            seed=config.seed,
            hidden=config.hidden,
            framestack=config.framestack,
            model_config=config.model_config,
            device=self.device,
        )
        # probe spaces locally (cheap, no env stepping)
        probe = _envs.make(config.env)
        raw_shape = tuple(probe.observation_space.shape)
        n_actions = int(probe.action_space.n)
        probe.close()
        proc_shape = default_env_to_module(
            raw_shape, config.framestack).output_shape(raw_shape)
        obs_spec = (proc_shape if len(proc_shape) == 3
                    else int(np.prod(proc_shape)))
        # learner connector pipeline (reference: GAE lives in the learner
        # connectors, general_advantage_estimation.py)
        self._learner_connector = GeneralAdvantageEstimation(
            config.gamma, config.lambda_)
        self.learner = PPOLearner(
            obs_spec, n_actions,
            PPOLearnerConfig(
                lr=config.lr, clip_param=config.clip_param,
                vf_loss_coeff=config.vf_loss_coeff,
                entropy_coeff=config.entropy_coeff,
                num_sgd_iter=config.num_sgd_iter,
                minibatch_size=config.minibatch_size,
                hidden=config.hidden),
            mesh=mesh, seed=config.seed,
            model_config=config.model_config, device=self.device)
        self.env_runner_group.sync_weights(self.learner.get_weights())
        self._env_steps_total = 0
        # pipeline_sampling state: the fragment prefetched during the
        # previous iteration's update, and a one-thread executor for the
        # in-flight update
        self._prefetched = None
        self._learn_executor = None

    def _build_batch(self, samples):
        """Fragments → one flat train batch: GAE per fragment (each has
        its own bootstrap values), flatten (T, N) -> (T*N,), drop
        autoreset steps (their action was ignored by the env — next-step
        autoreset — so they are not real experience)."""
        obs, acts, logp, adv, targets = [], [], [], [], []
        ep_returns, n_eps, env_steps = [], 0, 0
        for s in samples:
            s = self._learner_connector(s)
            a, tg = s["advantages"], s["value_targets"]
            valid = ~s["reset_mask"].reshape(-1)
            obs.append(s["obs"].reshape(-1, *s["obs"].shape[2:])[valid])
            acts.append(s["actions"].reshape(-1)[valid])
            logp.append(s["logp"].reshape(-1)[valid])
            adv.append(a.reshape(-1)[valid])
            targets.append(tg.reshape(-1)[valid])
            if s["num_episodes"]:
                ep_returns.append(s["episode_return_mean"])
                n_eps += s["num_episodes"]
            env_steps += s["env_steps"]
        train_batch = {
            "obs": np.concatenate(obs).astype(np.float32),
            "actions": np.concatenate(acts),
            "logp_old": np.concatenate(logp),
            "advantages": np.concatenate(adv),
            "value_targets": np.concatenate(targets),
        }
        return train_batch, ep_returns, n_eps, env_steps

    def _finish_iteration(self, t0, t_sample, t_learn, ep_returns, n_eps,
                          env_steps, learner_metrics) -> dict:
        self._env_steps_total += env_steps
        dt = time.perf_counter() - t0
        if ep_returns:
            self.metrics.log_value(("env_runners", "episode_return_mean"),
                                   float(np.mean(ep_returns)), window=20)
        self.metrics.log_value(("env_runners", "num_env_steps_sampled"),
                               env_steps, reduce="sum", window=None)
        self.metrics.log_dict(learner_metrics, key="learner", window=20)
        return {
            "episode_return_mean": float(np.mean(ep_returns))
            if ep_returns else float("nan"),
            "num_episodes": n_eps,
            "num_env_steps_sampled": env_steps,
            "num_env_steps_sampled_lifetime": self._env_steps_total,
            "env_steps_per_sec": env_steps / dt,
            "time_sample_s": t_sample,
            "time_learn_s": t_learn,
            **{f"learner/{k}": v for k, v in learner_metrics.items()},
        }

    def training_step(self) -> dict:
        """One training iteration (reference: PPO.training_step,
        ppo.py:389 — sample, learn, sync)."""
        if self.config.pipeline_sampling:
            return self._train_pipelined()
        t0 = time.perf_counter()
        samples = self.env_runner_group.sample()
        t_sample = time.perf_counter() - t0
        train_batch, ep_returns, n_eps, env_steps = \
            self._build_batch(samples)
        t1 = time.perf_counter()
        learner_metrics = self.learner.update(train_batch)
        t_learn = time.perf_counter() - t1
        self.env_runner_group.sync_weights(self.learner.get_weights())
        return self._finish_iteration(t0, t_sample, t_learn, ep_returns,
                                      n_eps, env_steps, learner_metrics)

    def _train_pipelined(self) -> dict:
        """Async-learner iteration (reference:
        multi_gpu_learner_thread.py:141 LoaderThread/step overlap): the
        update on fragment k runs while fragment k+1 is sampled. The
        runners hold the pre-update weights during the overlap (sync
        happens after both finish), so each batch is exactly one update
        stale — logp_old matches the sampling policy, and the clipped
        ratio absorbs the staleness."""
        import concurrent.futures as cf

        if self._learn_executor is None:
            self._learn_executor = cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ppo-learn")
        t0 = time.perf_counter()
        if self._prefetched is None:
            self._prefetched = self.env_runner_group.sample()
        train_batch, ep_returns, n_eps, env_steps = \
            self._build_batch(self._prefetched)
        t1 = time.perf_counter()
        fut = self._learn_executor.submit(self.learner.update, train_batch)
        # overlap: sample the NEXT fragment while the update executes
        self._prefetched = self.env_runner_group.sample()
        t_sample = time.perf_counter() - t1
        learner_metrics = fut.result()
        t_learn = time.perf_counter() - t1
        self.env_runner_group.sync_weights(self.learner.get_weights())
        return self._finish_iteration(t0, t_sample, t_learn, ep_returns,
                                      n_eps, env_steps, learner_metrics)

    def get_weights(self):
        return self.learner.get_weights()

    def cleanup(self):
        if self._learn_executor is not None:
            self._learn_executor.shutdown(wait=False)
            self._learn_executor = None
        self.env_runner_group.shutdown()
