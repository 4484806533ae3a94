"""IMPALA — asynchronous sampling with a background learner thread: the
port of ``ray_tpu/rllib/impala.py``.

Reference parity: rllib/algorithms/impala (training_step :592, async
learner wiring :1358-1370) and the MultiGPULearnerThread pipeline
(rllib/execution/multi_gpu_learner_thread.py:21, step :141):

- the env runner samples with slightly stale weights and the driver
  feeds each fragment, turned into a V-trace batch on the learner's
  device, to a bounded queue;
- a daemon learner thread takes batches off the queue and runs the
  actor-critic update on the device while the driver samples the next
  fragment; an exception in it is kept and re-raised by `train()`;
- off-policy correction: V-trace (clipped importance weights rho/c),
  computed on the host per batch like the GAE connector.

The update writes the params in place (the port's optimizer), where the
JAX learner swaps in a new immutable tree. So the optimizer step runs
under ``_params_lock``, and every reader on the driver's thread (the
target log-probs of a batch, the weight broadcast, `get_weights`) reads
under it too: no reader sees a half-written step. With
``num_env_runners > 0`` the runners are actors on the cluster runtime
and the driver samples them asynchronously: one sample in flight per
runner, each landed fragment fed to the queue (dropped when it is
full, as the reference drops it).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, copy_weights_
from ray_tpu_torch.train.optim import adam, chain, clip_by_global_norm
from ray_tpu_torch.util import tree


def vtrace(behavior_logp, target_logp, rewards, values, dones, last_values,
           gamma: float, rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets + pg advantages, (T, N) host arrays (Espeholt et
    al. 2018, eq. 1)."""
    T, N = rewards.shape
    rho = np.minimum(np.exp(target_logp - behavior_logp), rho_clip)
    c = np.minimum(np.exp(target_logp - behavior_logp), c_clip)
    nonterm = 1.0 - dones.astype(np.float32)
    next_values = np.concatenate([values[1:], last_values[None]], axis=0)
    # bootstrap breaks at episode ends
    delta = rho * (rewards + gamma * next_values * nonterm - values)
    vs_minus_v = np.zeros((T + 1, N), np.float32)
    for t in range(T - 1, -1, -1):
        vs_minus_v[t] = delta[t] + gamma * nonterm[t] * c[t] * vs_minus_v[t + 1]
    vs = vs_minus_v[:T] + values
    vs_next = np.concatenate([vs[1:], last_values[None]], axis=0)
    advantages = rho * (rewards + gamma * vs_next * nonterm - values)
    return vs, advantages


@dataclasses.dataclass
class IMPALAConfig(AlgorithmConfig):
    num_env_runners: int = 2
    lr: float = 5e-4
    entropy_coeff: float = 0.01
    vf_loss_coeff: float = 0.5
    grad_clip: float = 40.0
    queue_capacity: int = 8
    broadcast_interval: int = 1  # learner steps between weight syncs

    def build(self) -> "IMPALA":
        return IMPALA(self)


class _LearnerThread(threading.Thread):
    """Background SGD (reference: LearnerThread.step,
    execution/learner_thread.py / multi_gpu_learner_thread.py:141)."""

    def __init__(self, algo: "IMPALA"):
        super().__init__(daemon=True, name="impala-learner")
        self.algo = algo
        self.stopped = threading.Event()
        self.num_updates = 0
        self.last_loss = float("nan")
        self.error: BaseException | None = None

    def run(self):
        algo = self.algo
        while not self.stopped.is_set():
            try:
                batch = algo._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                loss = algo._update(batch)
                self.num_updates += 1
                self.last_loss = float(loss)
                if self.num_updates % algo.config.broadcast_interval == 0:
                    algo._weights_dirty.set()
            except BaseException as e:  # noqa: BLE001
                # surface instead of dying silently: train() re-raises
                self.error = e
                self.stopped.set()
                return


def logp_of(logits: torch.Tensor, actions: torch.Tensor):
    """(log_softmax(logits), the log-prob of each row's action)."""
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(1, actions[:, None])[:, 0]


def masked_mean(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum(m * x) / max(sum(m), 1): the mean over the rows the mask
    keeps (autoreset steps carry no loss)."""
    return torch.sum(m * x) / torch.clamp(torch.sum(m), min=1.0)


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)


def impala_loss(params, batch: dict, vf_loss_coeff: float,
                entropy_coeff: float) -> torch.Tensor:
    """pg + vf - entropy under the mask, against the V-trace targets."""
    logits, value = models.forward(params, batch["obs"])
    logp_all, logp = logp_of(logits, batch["actions"])
    m = batch["mask"]
    pg = -masked_mean(m, logp * batch["advantages"])
    vf = masked_mean(m, (value - batch["vs"]) ** 2)
    ent = masked_mean(m, entropy_of(logp_all))
    return pg + vf_loss_coeff * vf - entropy_coeff * ent


class IMPALA(Algorithm):
    config_class = IMPALAConfig
    STATE_COMPONENTS = ("_iteration", "_timesteps_total", "_env_steps")

    def get_state(self) -> dict:
        state = super().get_state()
        state["learner"] = {"params": self.get_weights()}
        return state

    def set_state(self, state: dict):
        super().set_state(state)
        if "learner" in state:
            with self._params_lock:
                copy_weights_(self.params, state["learner"]["params"])
            self.env_runner_group.sync_weights(state["learner"]["params"])

    def setup(self, config: IMPALAConfig):
        probe = _envs.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        n_actions = int(probe.action_space.n)
        probe.close()

        gen = torch.Generator(device=self.device)
        gen.manual_seed(config.seed)
        self.params = tree.tree_map(
            lambda t: t.requires_grad_(True),
            models.init_mlp_policy(gen, obs_dim, n_actions, config.hidden,
                                   device=self.device))
        self.tx = chain(clip_by_global_norm(config.grad_clip),
                        adam(config.lr))
        self.opt_state = self.tx.init(self.params)
        self._params_lock = threading.Lock()

        self.env_runner_group = EnvRunnerGroup(
            num_env_runners=config.num_env_runners,
            remote=config.num_env_runners > 0,
            env=config.env, num_envs=config.num_envs_per_env_runner,
            rollout_fragment_length=config.rollout_fragment_length,
            seed=config.seed, hidden=config.hidden, device=self.device)
        self._queue: queue.Queue = queue.Queue(maxsize=config.queue_capacity)
        self._weights_dirty = threading.Event()
        self.env_runner_group.sync_weights(self.get_weights())
        self.learner_thread = _LearnerThread(self)
        self.learner_thread.start()
        self._inflight: dict = {}
        self._env_steps = 0
        self._ep_returns: list[float] = []

    # -- the learner's step ---------------------------------------------

    def _loss(self, batch: dict) -> torch.Tensor:
        cfg = self.config
        return impala_loss(self.params, batch, cfg.vf_loss_coeff,
                           cfg.entropy_coeff)

    def _apply(self, loss: torch.Tensor) -> torch.Tensor:
        """Gradients of `loss` (outside the lock: the driver only reads
        the params), then the optimizer's in-place step under it."""
        leaves = tree.leaves(self.params)
        grads = torch.autograd.grad(loss, leaves)
        with self._params_lock:
            self.params, self.opt_state = self.tx.update(
                tree.unflatten(self.params, grads), self.opt_state,
                self.params)
        return loss.detach()

    def _update(self, batch: dict) -> torch.Tensor:
        """One step of the learner thread on a device batch: the loss,
        left on the device."""
        return self._apply(self._loss(batch))

    # -- async sampling plumbing ----------------------------------------

    def _to_batch(self, s: dict) -> dict:
        """Fragment -> V-trace learner batch (host-side, flattened), its
        tensors on the learner's device."""
        cfg = self.config
        T, N = s["rewards"].shape
        obs_flat = s["obs"].reshape(T * N, -1).astype(np.float32)
        obs = torch.from_numpy(obs_flat).to(self.device)
        actions = torch.from_numpy(s["actions"].reshape(-1)).to(self.device)
        with self._params_lock, torch.no_grad():
            logits, _ = models.forward(self.params, obs)
            target_logp = logp_of(logits, actions)[1].cpu().numpy()
        vs, adv = vtrace(s["logp"], target_logp.reshape(T, N), s["rewards"],
                         s["values"], s["dones"], s["last_values"], cfg.gamma)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        # loss MASK (not row-drop) for autoreset steps, as in the JAX
        # learner (whose jitted update keeps its shapes static)
        mask = (~s["reset_mask"].reshape(-1)).astype(np.float32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return {
            "obs": obs,
            "actions": actions,
            "vs": dev(vs.reshape(-1).astype(np.float32)),
            "advantages": dev(adv.reshape(-1).astype(np.float32)),
            # behavior logp: APPO's clipped surrogate needs it
            "logp_old": dev(s["logp"].reshape(-1)),
            "mask": dev(mask),
        }

    def training_step(self) -> dict:
        """One driver iteration: harvest landed samples, keep one
        in-flight per runner, feed the learner queue, broadcast fresh
        weights (reference: IMPALA.training_step's async path)."""
        import ray_tpu_torch

        if self.learner_thread.error is not None:
            raise RuntimeError(
                "IMPALA learner thread failed") from self.learner_thread.error
        t0 = time.perf_counter()
        group = self.env_runner_group
        env_steps = 0

        if not group.remote:
            # inline mode: synchronous but still through the queue+thread
            s = group.local.sample()
            env_steps += s["env_steps"]
            if s["num_episodes"]:
                self._ep_returns.append(s["episode_return_mean"])
            self._queue.put(self._to_batch(s), timeout=30)
        else:
            for r in group.runners:
                if r not in self._inflight:
                    self._inflight[r] = r.sample.remote()
            deadline = time.monotonic() + 5
            harvested = 0
            while harvested == 0 and time.monotonic() < deadline:
                ready, _ = ray_tpu_torch.wait(
                    list(self._inflight.values()),
                    num_returns=1, timeout=2.0)
                for ref in ready:
                    runner = next(r for r, v in self._inflight.items()
                                  if v == ref)
                    s = ray_tpu_torch.get(ref, timeout=60)
                    self._inflight[runner] = runner.sample.remote()
                    env_steps += s["env_steps"]
                    if s["num_episodes"]:
                        self._ep_returns.append(s["episode_return_mean"])
                    try:
                        self._queue.put_nowait(self._to_batch(s))
                    except queue.Full:
                        pass  # backpressure: drop (reference drops too)
                    harvested += 1

        if self._weights_dirty.is_set():
            self._weights_dirty.clear()
            # get_weights reads under _params_lock: never a half-written
            # step in the broadcast
            group.sync_weights(self.get_weights())

        self._env_steps += env_steps
        dt = time.perf_counter() - t0
        window = self._ep_returns[-100:]
        self._ep_returns = window
        return {
            "episode_return_mean": float(np.mean(window)) if window
            else float("nan"),
            "num_env_steps_sampled_lifetime": self._env_steps,
            "env_steps_per_sec": env_steps / dt,
            "learner_updates": self.learner_thread.num_updates,
            "learner/loss": self.learner_thread.last_loss,
            "learner_queue_size": self._queue.qsize(),
        }

    def get_weights(self):
        with self._params_lock:
            return params_to_numpy(self.params)

    def cleanup(self):
        self.learner_thread.stopped.set()
        self.learner_thread.join(timeout=10)
        self.env_runner_group.shutdown()
