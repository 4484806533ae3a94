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
  each rank's heads.

The serve deployment is a later slice (ROADMAP.md).
"""

from ray_tpu_torch.serve.llm.cache import BlockPool
from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams
from ray_tpu_torch.serve.llm.engine import LLMEngine, RequestStream
from ray_tpu_torch.serve.llm.runner import ModelRunner
from ray_tpu_torch.serve.llm.scheduler import Scheduler, SeqState, Sequence
from ray_tpu_torch.serve.llm.spec import (
    DraftProposer,
    NGramProposer,
    SpeculativeConfig,
)

__all__ = [
    "BlockPool",
    "DraftProposer",
    "EngineConfig",
    "LLMEngine",
    "ModelRunner",
    "NGramProposer",
    "RequestStream",
    "SamplingParams",
    "Scheduler",
    "SeqState",
    "Sequence",
    "SpeculativeConfig",
]
