"""Serve integration: LLM engine replicas behind a DeploymentHandle, the
port of ``ray_tpu/serve/llm/deployment.py``.

Each replica of the deployment owns one `LLMEngine` plus a daemon
step-loop thread; `__call__` is a generator, so callers stream tokens
through ``handle.options(stream=True).remote(payload)`` (one ObjectRef
per token event) or over the HTTP proxy's NDJSON path — the same
streaming generator protocol every other serve deployment uses.

Payload schema (JSON-friendly)::

    {"prompt": [1, 2, 3],          # token ids (no tokenizer in-repo)
     "max_tokens": 16,
     "temperature": 0.0,
     "eos_token_id": null | int | [int, ...],
     "echo": false,
     "stream": true}               # false: single final event only

Engine stats ride the replica's ``control`` concurrency group so probes
don't queue behind long-running token streams.

Deviation from the JAX module (ROADMAP.md, queue 3): the engine runs on
a device, the card unless the caller names another, so `LLMServer` and
`build_llm_app` take ``device=``. A card app's replicas claim a GPU
share (one whole GPU unless ``ray_actor_options`` gives a share), so the
nodelet hands each replica process the card; a replica that sees no
card raises instead of running on the CPU.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams

# prefix-affinity routing hashes only the prompt's HEAD: requests whose
# prompts agree on their first AFFINITY_PREFIX_LEN tokens (a shared
# system prompt, an RL rollout's common context) rendezvous onto the
# same replica, whose prefix cache then serves them without re-prefill.
# The window is deliberately short — it must cover the *shared* part of
# typical prompts while ignoring their unique tails, and a shared head
# of one page is already worth routing for
AFFINITY_PREFIX_LEN = 16


def prompt_affinity_key(prompt: Sequence[int],
                        prefix_len: int = AFFINITY_PREFIX_LEN) -> str:
    """Stable routing key for a token-id prompt: hash of its first
    `prefix_len` tokens (the whole prompt when shorter). Same chain
    hash the KV pool uses, so 'same key' == 'prefix the replica's cache
    can actually reuse'."""
    from ray_tpu_torch.serve.llm.cache import hash_page

    return format(hash_page(0, [int(t) for t in prompt[:prefix_len]]),
                  "016x")


class LLMServer:
    """Deployment class: one engine per replica (use via
    `build_llm_app`, or wrap with `serve.deployment` yourself). The
    engine runs on `device`: the card unless another is named."""

    def __init__(self, engine_config: dict | EngineConfig | None = None,
                 warmup: bool = True, device=None, **cfg_kwargs):
        from ray_tpu_torch.serve.llm.engine import LLMEngine

        if isinstance(engine_config, EngineConfig):
            cfg = engine_config
        else:
            merged = dict(engine_config or {})
            merged.update(cfg_kwargs)
            cfg = EngineConfig.from_dict(merged)
        self.engine = LLMEngine(cfg, device=device)
        if warmup:
            # replicas come up hot: every bucketed step shape runs once
            # before the controller's readiness barrier passes, so the
            # first real request pays no first-call cost
            self.engine.warmup()
        self._alive = True
        self._loop = threading.Thread(
            target=self._step_loop, daemon=True, name="llm-engine-loop")
        self._loop.start()

    def _step_loop(self):
        import time

        while self._alive:
            if not self.engine.step():
                time.sleep(0.002)  # idle: nothing queued or running

    def __call__(self, payload: dict | None):
        payload = payload or {}
        prompt = payload.get("prompt")
        if not prompt:
            raise ValueError("payload needs a non-empty 'prompt' "
                             "(list of token ids)")
        sampling = SamplingParams.from_payload(payload)
        stream = self.engine.add_request(prompt, sampling)
        try:
            if payload.get("stream", True):
                yield from stream
            else:
                for _ in stream:
                    pass
            yield stream.final()
        finally:
            # consumer gone mid-stream (GeneratorExit / replica
            # teardown): release the decode lane + KV pages instead of
            # generating to max_tokens for nobody
            if stream.final() is None:
                self.engine.abort_request(stream, "client_disconnected")

    def update_weights(self, version: int, weights) -> dict:
        """Install new engine params (weight hot-swap). `weights` is a
        param tree, an ObjectRef to one (the learner publishes params
        through the object store; the runtime resolves refs passed as
        actor-call args, and this also resolves one passed inside),
        or a list of refs whose values are tree chunks to merge.
        Drain-free: in-flight token streams keep running — see
        `LLMEngine.update_weights` for the version/staleness
        contract."""
        import ray_tpu_torch as ray
        from ray_tpu_torch.core.api import ObjectRef

        if isinstance(weights, ObjectRef):
            weights = ray.get(weights)
        elif (isinstance(weights, (list, tuple)) and weights
              and all(isinstance(w, ObjectRef) for w in weights)):
            parts = ray.get(list(weights))
            merged: dict = {}
            for p in parts:
                merged.update(p)
            weights = merged
        return self.engine.update_weights(version, weights)

    def engine_stats(self) -> dict:
        return self.engine.stats()

    def check_health(self) -> str:
        """Controller health probe hook (rides the replica's control
        concurrency group): a replica whose step loop died is alive as
        a process but can never finish a stream — report it unhealthy
        so the self-healing loop replaces it."""
        if self._alive and not self._loop.is_alive():
            raise RuntimeError("engine step loop died")
        return "ok"

    def ping(self) -> str:
        return "pong"

    def shutdown_engine(self) -> bool:
        self._alive = False
        return True


def _card_actor_options(opts: dict | None) -> dict:
    """A card app's replica options: one whole GPU when none are given;
    given options must claim a positive GPU share, so that the nodelet
    hands the replica process the card."""
    if opts is None:
        return {"num_gpus": 1}
    share = max(float(opts.get("num_gpus") or 0),
                float((opts.get("resources") or {}).get("GPU", 0)))
    if share <= 0:
        raise ValueError(
            f"build_llm_app(device='cuda') but ray_actor_options={opts} "
            f"claims no GPU: give the replicas a GPU share (num_gpus=0.5 "
            f"puts two on one card) or pass device='cpu'")
    return dict(opts)


def build_llm_app(
    *,
    model: str = "gpt2",
    preset: str = "tiny",
    num_replicas: int = 1,
    engine_config: dict | None = None,
    max_ongoing_requests: int = 32,
    ray_actor_options: dict | None = None,
    device: str = "cuda",
) -> Any:
    """Bind an LLM application: ``serve.run(build_llm_app(...))``.

    `engine_config` entries override the model/preset shorthand. The
    replicas' engines run on `device`; on the card (the default) each
    replica claims a GPU share (see `_card_actor_options`)."""
    from ray_tpu_torch import serve

    cfg = {"model": model, "preset": preset}
    cfg.update(engine_config or {})
    EngineConfig.from_dict(cfg)  # validate in the driver, not the replica
    if str(device).split(":")[0] == "cuda":
        ray_actor_options = _card_actor_options(ray_actor_options)
    dep = serve.deployment(
        LLMServer,
        name=f"llm-{cfg['model']}",
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options,
        # the proxy routes {"prompt": [ids]} payloads by prompt-prefix
        # hash so same-prefix requests land on one replica's warm cache
        payload_affinity=True,
    )
    return dep.bind(cfg, device=device)
