"""Token-level trajectory schema for the RL-for-LLMs flywheel: the
port's own copy of ``ray_tpu/rllib/llm/trajectory.py`` (numpy only).

A `Trajectory` is one completion sampled through the serve.llm engine:
the prompt, the generated tokens, the per-token log-probs under the
distribution they were sampled from, the scalar reward, and the weight
version the engine tagged the stream with. It is deliberately a plain
dataclass of primitives, so it pickles cheaply and round-trips through
JSON for debugging.

Version/staleness contract (RL.md): a trajectory is *on-policy for
version v* iff ``weight_version == v and not stale``. `stale` is set by
the engine when the stream spanned a weight hot-swap (tokens or the KV
they were decoded against mix versions) — such trajectories have
logprobs that no single-version teacher-forced forward reproduces, so
the learner's staleness guard drops them rather than feeding corrupted
importance ratios into the update.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Trajectory:
    """One sampled completion, token-level."""

    prompt: list[int]
    tokens: list[int]  # generated token ids
    logprobs: list[float]  # one per generated token, at sampling time
    reward: float
    weight_version: int  # version the stream finished on
    weight_versions: list[int]  # every version that sampled a token
    stale: bool  # mixed versions (tokens or KV): see module docstring
    group_id: int  # GRPO group (all completions of one prompt)
    temperature: float  # sampling temperature (logprobs are τ-scaled)
    cached_tokens: int = 0  # prompt tokens served from the prefix cache

    @staticmethod
    def from_final(prompt: list[int], final: dict, *, reward: float,
                   group_id: int, temperature: float) -> "Trajectory":
        """Build from a serve.llm final stream event (requires the
        request to have run with ``SamplingParams(logprobs=True)``)."""
        if "logprobs" not in final:
            raise ValueError(
                "final event carries no logprobs — sample with "
                "SamplingParams(logprobs=True)")
        return Trajectory(
            prompt=[int(t) for t in prompt],
            tokens=[int(t) for t in final["token_ids"]],
            logprobs=[float(l) for l in final["logprobs"]],
            reward=float(reward),
            weight_version=int(final["weight_version"]),
            weight_versions=[int(v) for v in final["weight_versions"]],
            stale=bool(final["stale"]),
            group_id=int(group_id),
            temperature=float(temperature),
            cached_tokens=int(final.get("cached_tokens", 0)),
        )

    def __len__(self) -> int:
        return len(self.tokens)


def group_relative_advantages(trajs: list[Trajectory],
                              eps: float = 1e-6) -> np.ndarray:
    """GRPO advantages: within each group (the N completions of one
    prompt), advantage = (reward - group mean) / (group std + eps). A
    group where every completion scored the same contributes zero
    advantage — no gradient, which is exactly right (nothing to prefer).
    Returns one float per trajectory, in input order."""
    rewards = np.asarray([t.reward for t in trajs], np.float32)
    adv = np.zeros_like(rewards)
    groups: dict[int, list[int]] = {}
    for i, t in enumerate(trajs):
        groups.setdefault(t.group_id, []).append(i)
    for idx in groups.values():
        r = rewards[idx]
        adv[idx] = (r - r.mean()) / (r.std() + eps)
    return adv


def _next_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def to_train_batch(trajs: list[Trajectory], advantages: np.ndarray,
                   *, max_len: int, pad_token: int = 0) -> dict:
    """Pack trajectories into one padded next-token batch for the GRPO
    step.

    Layout: ``inputs[b, t]`` feeds the forward whose position-``t``
    logits predict ``targets[b, t]``; ``mask[b, t]`` is 1 exactly where
    that target is a *generated* token (prompt positions and padding
    contribute no loss); ``old_logprobs`` aligns with targets/mask.
    Sequence length pads to a power of two (capped at `max_len`) and
    batch to a power of two, as in the JAX package, so the step sees a
    bounded set of shapes the same way the serving runner buckets
    them."""
    if not trajs:
        raise ValueError("empty trajectory batch")
    seq_lens = [len(t.prompt) + len(t.tokens) for t in trajs]
    if max(seq_lens) > max_len:
        raise ValueError(
            f"trajectory of {max(seq_lens)} tokens exceeds max_len "
            f"{max_len}")
    T = min(_next_pow2(max(seq_lens), 16), max_len)
    B = _next_pow2(len(trajs), 1)
    inputs = np.full((B, T), pad_token, np.int32)
    targets = np.full((B, T), pad_token, np.int32)
    mask = np.zeros((B, T), np.float32)
    old_lp = np.zeros((B, T), np.float32)
    adv = np.zeros((B,), np.float32)
    for b, t in enumerate(trajs):
        seq = t.prompt + t.tokens
        np_seq = np.asarray(seq, np.int32)
        n = len(seq) - 1
        inputs[b, :n] = np_seq[:-1]
        targets[b, :n] = np_seq[1:]
        g0 = len(t.prompt) - 1  # first generated target position
        mask[b, g0:g0 + len(t.tokens)] = 1.0
        old_lp[b, g0:g0 + len(t.tokens)] = np.asarray(t.logprobs,
                                                      np.float32)
        adv[b] = advantages[b]
    return {"inputs": inputs, "targets": targets, "mask": mask,
            "old_logprobs": old_lp, "advantages": adv}
