"""RLFlywheel: rollout → stream → learn → hot-swap, closed. The port of
``ray_tpu/rllib/llm/flywheel.py``.

One `iteration()` is one lap: the rollout worker samples completions
through the serving engine (prefix cache serving the shared task
prefix), trajectory groups stream into the GRPO learner as they finish,
the learner takes one clipped policy-gradient step, publishes the new
weight version, and the engine installs it with a drain-free hot-swap —
in-flight streams keep running, tagged by version, and the next lap's
rollouts sample from the updated policy.

The learner and the engine MUST start from the same params (pass
``learner.get_weights()`` into `LLMEngine(..., params=...)`); otherwise
the first lap's importance ratios are wrong in a way the staleness
guard cannot see. The JAX flywheel's tracing span (``rl.iteration``)
waits for the port of the tracing plane (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from ray_tpu_torch.rllib.llm.learner import LLMLearner
from ray_tpu_torch.rllib.llm.rollout import RolloutWorker
from ray_tpu_torch.rllib.llm.trajectory import Trajectory


@dataclasses.dataclass
class FlywheelConfig:
    # overlap: install the weights while the NEXT batch's first prompts
    # are decoding? (the hot-swap itself is drain-free; rollouts in
    # flight during a swap come back version-mixed and are dropped by
    # the staleness guard — this proves every lap that zero streams
    # drop)
    swap_during_rollout: bool = False
    # how many prompts of the NEXT batch to launch before swapping when
    # swap_during_rollout is set (keeps streams provably in flight)
    overlap_prompts: int = 2


class RLFlywheel:
    """Synchronous closed loop over (RolloutWorker, LLMLearner)."""

    def __init__(self, worker: RolloutWorker, learner: LLMLearner,
                 prompt_fn: Callable[[int], Sequence[Sequence[int]]],
                 config: FlywheelConfig | None = None):
        """`prompt_fn(iteration) -> list of token-id prompts` supplies
        each lap's prompt batch (tasks randomize digits per lap but
        share the system prefix, so the cache stays warm across
        laps)."""
        self.worker = worker
        self.learner = learner
        self.prompt_fn = prompt_fn
        self.config = config or FlywheelConfig()
        self.iteration_idx = 0
        self.history: list[dict] = []

    def iteration(self) -> dict:
        """One lap. Returns learner metrics + rollout/swap stats."""
        t0 = time.perf_counter()
        prompts = self.prompt_fn(self.iteration_idx)
        trajs: list[Trajectory] = []
        for group in self.worker.rollout_stream(prompts):
            trajs.extend(group)
        metrics = self.learner.update(trajs)
        version, weights = self.learner.publish_weights()
        swap = None
        if not metrics.get("skipped"):
            if self.config.swap_during_rollout:
                swap = self._swap_with_streams_in_flight(version, weights)
            else:
                swap = self.worker.engine.update_weights(version, weights)
        self.iteration_idx += 1
        all_rewards = [t.reward for t in trajs]
        out = dict(metrics)
        out.update({
            "iteration": self.iteration_idx,
            "rollout_reward_mean": (sum(all_rewards) / len(all_rewards))
            if all_rewards else float("nan"),
            "num_trajectories": len(trajs),
            "rollout_tokens": sum(len(t) for t in trajs),
            "swap": swap,
            "iteration_seconds": time.perf_counter() - t0,
        })
        self.history.append(out)
        return out

    def _swap_with_streams_in_flight(self, version: int,
                                     weights) -> dict:
        """Prove the drain-free contract every lap: launch a few probe
        streams from the next batch's prompts, hot-swap while they
        decode, then let them finish. Their finals are checked for
        drops and version mixing (reported in the swap stats) and then
        discarded — version-mixed trajectories are what the staleness
        guard drops anyway."""
        engine = self.worker.engine
        sp = self.worker._sampling()
        probes = []
        for prompt in list(self.prompt_fn(self.iteration_idx + 1))[
                :self.config.overlap_prompts]:
            probes.append(engine.add_request(list(prompt), sp))
        for _ in range(2):  # streams genuinely mid-generation
            engine.step()
        swap = engine.update_weights(version, weights)
        if swap["in_flight_streams"] < 1:
            # the probes finished before the swap landed — the lap
            # proved nothing; fail loud rather than report a vacuous
            # "zero drops" (raise the probes' max_tokens or
            # overlap_prompts so they outlive the priming steps)
            raise RuntimeError(
                "weight swap landed with zero streams in flight: the "
                "drain-free probe was vacuous")
        deadline = time.monotonic() + 120
        while any(s.final() is None for s in probes):
            if not engine.step():
                time.sleep(0.001)
            if time.monotonic() > deadline:
                raise TimeoutError("in-flight probe stream stalled")
        finals = [s.final() for s in probes]
        swap = dict(swap)
        swap["probe_streams"] = len(finals)
        swap["probe_dropped"] = sum(
            1 for f in finals if f is None or not f.get("done"))
        swap["probe_stale"] = sum(1 for f in finals if f.get("stale"))
        return swap
