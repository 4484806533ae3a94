"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays as it is and is the reference the
port is held against; this package imports neither it nor jax. Every
Pallas kernel of ray_tpu on a ported path becomes a hand-written CUDA
C++ kernel here (``csrc/``), built with nvcc for sm_90a at its first
use, never at import. Entry points run on the card unless the caller
passes ``device="cpu"``, where each kernel's wrapper runs its plain
PyTorch version instead.

Public core API, as ``ray_tpu``'s, in local mode (tasks and actors on
threads of this process; the cluster runtime is not ported, so
``init()`` without ``local_mode=True`` raises)::

    import ray_tpu_torch as ray
    ray.init(local_mode=True, num_gpus=1)
    @ray.remote(num_gpus=1)
    def f(x): return x + 1
    ray.get(f.remote(1))

Importing this package loads the core API only, not the serving, RL or
training packages.

Ported so far: GPT-2 and Llama serving (``ray_tpu_torch.serve.llm``) at
the JAX engine's defaults (chunked prefill, prefix caching, dense
decode) and with paged decode and speculative decoding, through the
flash-attention forward (``ops/flash_attention.py``) and the paged
attention kernel (``ops/paged_attention.py``), on one card or on a
``tensor`` mesh with the kernels on each rank's heads; GPT-2 and Llama
training (``ray_tpu_torch.train``) on one card or on a mesh of
``torch.distributed`` ranks with the ZeRO ladder
(``ray_tpu_torch.parallel``), through the flash-attention forward and
backward kernels on each rank's shard, with checkpoints of the train
state (``train/checkpointing.py``) and the train session; RL for LLMs
(``ray_tpu_torch.rllib.llm``); the rest of the parallel layer and model
zoo: ring and Ulysses attention, the in-program GPipe and interleaved
pipeline schedules with the 1F1B schedule math, the expert-parallel MoE
layer and the pipelined transformer; classic RL
(``ray_tpu_torch.rllib``): PPO, DQN, IMPALA/APPO, SAC, DreamerV3,
multi-agent PPO and OPE on the port's own envs; the core API in local
mode (``ray_tpu_torch.core``); Tune (``ray_tpu_torch.tune``): the
Tuner and its schedulers, running trials as actors of the local
runtime; and the data layer (``ray_tpu_torch.data``) on the local
runtime, with ``iter_torch_batches`` feeding a train step and offline
RL (BC, MARWIL, CQL, OPE) over recorded datasets. See ROADMAP.md.
"""

from ray_tpu_torch._version import __version__
from ray_tpu_torch.core.api import (
    ObjectRef,
    ObjectRefGenerator,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    timeline,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)

__all__ = [
    "__version__",
    "ObjectRef",
    "ObjectRefGenerator",
    "available_resources",
    "cancel",
    "cluster_resources",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "timeline",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
]
