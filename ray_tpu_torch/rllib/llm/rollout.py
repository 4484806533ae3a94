"""RolloutWorker: the serving engine as the RL rollout actor, the port of
``ray_tpu/rllib/llm/rollout.py``.

Samples N completions per prompt through a continuous-batching LLM
engine — either an in-process `LLMEngine` (tests, the CPU closed loop)
or a deployed `build_llm_app` behind a `DeploymentHandle` (the cluster
flywheel) — scores them with a pluggable reward fn, and emits
token-level `Trajectory` lists.

Rollouts are the workload the prefix cache was shaped for: the N
completions of one prompt (and every prompt sharing the task's system
prefix) longest-prefix-match each other's KV pages at admission, so
only the first rollout pays the prefill; `Trajectory.cached_tokens`
and the engine's `prefix_hit_pages` counters make the reuse
observable. Through a handle, `affinity_key` routes same-prefix
rollouts onto one replica's warm cache.

Streaming contract: `rollout_stream()` yields one object-store ref per
completed prompt group *as each group finishes* (the lists themselves
when no runtime is up), so the learner can take groups while later ones
are still decoding (and a weight hot-swap can land mid-rollout). Both
run inside an ``rl.rollout`` span.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from ray_tpu_torch.rllib.llm.trajectory import Trajectory
from ray_tpu_torch.serve.llm.config import SamplingParams
from ray_tpu_torch.util.metrics import Counter, Gauge


@dataclasses.dataclass
class RolloutConfig:
    group_size: int = 4  # completions per prompt (the GRPO group)
    max_tokens: int = 8
    temperature: float = 1.0  # must match LLMLearnerConfig.temperature
    eos_token_id: Any = None


class RolloutWorker:
    """Drives one engine (or one deployment) to produce trajectories."""

    def __init__(self, *, engine=None, handle=None,
                 reward_fn: Callable[[list, list], float],
                 config: RolloutConfig | None = None):
        if (engine is None) == (handle is None):
            raise ValueError("pass exactly one of engine= / handle=")
        self.engine = engine
        self.handle = handle
        self.reward_fn = reward_fn
        self.config = config or RolloutConfig()
        self._groups = 0
        self._build_metrics()

    def _build_metrics(self):
        self._m_tokens = Counter(
            "rl_rollout_tokens_total",
            "Tokens generated by RL rollouts through the serve.llm "
            "engine")
        self._m_reward = Gauge(
            "rl_reward_mean",
            "Mean reward of the most recent rollout batch")

    def _sampling(self) -> SamplingParams:
        c = self.config
        return SamplingParams(
            max_tokens=c.max_tokens, temperature=c.temperature,
            eos_token_id=c.eos_token_id, logprobs=True)

    # ------------------------------------------------------- engine path

    def _rollout_engine(self, prompts: Sequence[Sequence[int]],
                        *, drive: bool) -> Iterator[list[Trajectory]]:
        """Submit every group up front (shared prefixes ride the cache),
        step the engine, and yield each group the moment its last
        stream closes. With ``drive=False`` the engine is stepped
        elsewhere (a deployment's step loop or a test's own loop)."""
        sp = self._sampling()
        pending = []  # (group_id, prompt, [streams])
        for gid, prompt in enumerate(prompts, start=self._groups):
            streams = [self.engine.add_request(prompt, sp)
                       for _ in range(self.config.group_size)]
            pending.append((gid, list(prompt), streams))
        self._groups += len(pending)
        idle_budget = 600.0  # since the LAST observed progress
        deadline = time.monotonic() + idle_budget
        while pending:
            stepped = self.engine.step() if drive else False
            if stepped:
                deadline = time.monotonic() + idle_budget
            else:
                # idle (or someone else's step loop is producing the
                # tokens): yield instead of hot-polling finals
                time.sleep(0.001)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rollout made no progress in {idle_budget:.0f}s")
            # yield ANY fully-finished group the moment its last stream
            # closes (EOS can finish a late group before an early one)
            i = 0
            while i < len(pending):
                gid, prompt, streams = pending[i]
                if all(s.final() is not None for s in streams):
                    pending.pop(i)
                    deadline = time.monotonic() + idle_budget
                    yield self._score_group(
                        gid, prompt, [s.final() for s in streams])
                else:
                    i += 1

    # ------------------------------------------------------- handle path

    def _rollout_handle(self, prompts: Sequence[Sequence[int]]
                        ) -> Iterator[list[Trajectory]]:
        """Submit every group's streams at once through the handle, each
        routed by its prompt's affinity key (one replica's warm prefix
        cache serves a group), and yield the groups in order."""
        import ray_tpu_torch as ray
        from ray_tpu_torch.serve.llm.deployment import prompt_affinity_key

        c = self.config
        sp_payload = {"max_tokens": c.max_tokens,
                      "temperature": c.temperature,
                      "eos_token_id": c.eos_token_id,
                      "logprobs": True, "stream": False}
        gens = []
        for gid, prompt in enumerate(prompts, start=self._groups):
            key = prompt_affinity_key(prompt)
            h = self.handle.options(stream=True, affinity_key=key)
            gens.append((gid, list(prompt), [
                h.remote(dict(sp_payload, prompt=list(prompt)))
                for _ in range(c.group_size)]))
        self._groups += len(gens)
        for gid, prompt, group in gens:
            finals = []
            for g in group:
                last = None
                for ref in g:
                    last = ray.get(ref)
                finals.append(last)
            yield self._score_group(gid, prompt, finals)

    def _groups_of(self, prompts, drive: bool | None):
        if self.engine is not None:
            return self._rollout_engine(
                prompts, drive=True if drive is None else drive)
        return self._rollout_handle(prompts)

    # ---------------------------------------------------------- scoring

    def _score_group(self, gid: int, prompt: list[int],
                     finals: list[dict]) -> list[Trajectory]:
        trajs = []
        for final in finals:
            if final is None or not final.get("done"):
                raise RuntimeError(
                    f"rollout stream for group {gid} closed without a "
                    f"final event: {final!r}")
            r = self.reward_fn(prompt, list(final["token_ids"]))
            trajs.append(Trajectory.from_final(
                prompt, final, reward=r, group_id=gid,
                temperature=self.config.temperature))
        self._m_tokens.inc(sum(len(t) for t in trajs))
        return trajs

    # ------------------------------------------------------------ public

    def rollout(self, prompts: Sequence[Sequence[int]],
                *, drive: bool | None = None) -> list[Trajectory]:
        """Sample group_size completions per prompt; returns the flat
        trajectory list (grouped by group_id). `drive` defaults to True
        for an in-process engine: the caller's thread steps it."""
        from ray_tpu_torch.util import tracing

        out: list[Trajectory] = []
        with tracing.span("rl.rollout"):
            for group in self._groups_of(prompts, drive):
                out.extend(group)
        if out:
            self._m_reward.set(float(np.mean([t.reward for t in out])))
        return out

    def rollout_stream(self, prompts: Sequence[Sequence[int]],
                       *, drive: bool | None = None) -> Iterator[Any]:
        """Streaming rollout: yields ONE object-store ref per completed
        prompt group, as groups finish, when a runtime is up; the
        trajectory lists themselves otherwise, so the CPU closed loop
        runs without a cluster."""
        import ray_tpu_torch as ray
        from ray_tpu_torch.util import tracing

        put = ray.put if ray.is_initialized() else (lambda x: x)
        rewards: list[float] = []
        with tracing.span("rl.rollout"):
            for group in self._groups_of(prompts, drive):
                rewards.extend(t.reward for t in group)
                yield put(group)
        if rewards:
            self._m_reward.set(float(np.mean(rewards)))
