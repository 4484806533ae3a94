"""ray_tpu_torch.serve.llm — continuous-batching LLM inference on one
NVIDIA card or on a mesh of them, the port of ``ray_tpu.serve.llm``.

- a **block KV-cache pool** (`cache.py`) of fixed-size pages, page 0
  the null sink for padded lanes, sized off the card's memory, with
  content-addressed prefix caching;
- **prefill, chunked prefill, decode and speculative verify** steps
  (`runner.py`) for GPT-2 and Llama: monolithic prefill through the
  flash-attention forward kernel, decode and verify through the
  paged-attention kernel or (the JAX default) over a dense gathered
  context, with greedy / temperature / top-k / top-p sampling;
- a **continuous-batching scheduler** (`scheduler.py`): prefill-first
  admission with prefix matching, page-aligned prefill chunks
  interleaved with decode, recompute-style preemption when the pool runs
  dry, EOS / max-tokens completion;
- **speculative decoding** (`spec.py`): a host-side n-gram proposer
  whose drafts one verify step a lane scores;
- an **engine** (`engine.py`) gluing them together, streaming tokens
  per request and recording serving metrics; with ``mesh=`` the params
  and pages are laid out over a ``tensor`` axis and the kernels run on
  each rank's heads;
- a **serve deployment** (`deployment.py`): `LLMServer` replicas each
  own one engine plus its step-loop thread on the port's cluster
  runtime, `DeploymentHandle.options(stream=True)` streams tokens back,
  and `DeploymentHandle.update_weights` hot-swaps every replica's
  params through the object store.

The names below load their submodule on first use, so a process that
only needs a routing key or a config (Serve's proxy and controller)
never imports torch.
"""

import importlib

_EXPORTS = {
    "AFFINITY_PREFIX_LEN": "deployment",
    "BlockPool": "cache",
    "DraftProposer": "spec",
    "EngineConfig": "config",
    "LLMEngine": "engine",
    "LLMServer": "deployment",
    "ModelRunner": "runner",
    "NGramProposer": "spec",
    "RequestStream": "engine",
    "SamplingParams": "config",
    "Scheduler": "scheduler",
    "SeqState": "scheduler",
    "Sequence": "scheduler",
    "SpeculativeConfig": "spec",
    "build_llm_app": "deployment",
    "prompt_affinity_key": "deployment",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
