"""ray_tpu_torch.serve.llm — continuous-batching LLM inference on one
NVIDIA card, the port of ``ray_tpu.serve.llm``.

- a **block KV-cache pool** (`cache.py`) of fixed-size pages, page 0
  the null sink for padded lanes, sized off the card's memory;
- **prefill and paged decode** steps (`runner.py`) for GPT-2, through
  the flash-attention forward kernel and the paged-attention kernel,
  with greedy / temperature / top-k / top-p sampling;
- a **continuous-batching scheduler** (`scheduler.py`): prefill-first
  admission, batched decode, recompute-style preemption when the pool
  runs dry, EOS / max-tokens completion;
- an **engine** (`engine.py`) gluing them together, streaming tokens
  per request and recording serving metrics.

Chunked prefill, prefix caching, speculative decoding, Llama and the
serve deployment are later slices (ROADMAP.md).
"""

from ray_tpu_torch.serve.llm.cache import BlockPool
from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams
from ray_tpu_torch.serve.llm.engine import LLMEngine, RequestStream
from ray_tpu_torch.serve.llm.runner import ModelRunner
from ray_tpu_torch.serve.llm.scheduler import Scheduler, SeqState, Sequence

__all__ = [
    "BlockPool",
    "EngineConfig",
    "LLMEngine",
    "ModelRunner",
    "RequestStream",
    "SamplingParams",
    "Scheduler",
    "SeqState",
    "Sequence",
]
