"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays as it is and is the reference the
port is held against; this package imports neither it nor jax. Every
Pallas kernel of ray_tpu on a ported path becomes a hand-written CUDA
C++ kernel here (``csrc/``), built with nvcc for sm_90a at its first
use, never at import. Entry points run on the card unless the caller
passes ``device="cpu"``, where each kernel's wrapper runs its plain
PyTorch version instead.

Ported so far: GPT-2 and Llama serving (``ray_tpu_torch.serve.llm``) at
the JAX engine's defaults (chunked prefill, prefix caching, dense
decode) and with paged decode and speculative decoding, through the
flash-attention forward (``ops/flash_attention.py``) and the paged
attention kernel (``ops/paged_attention.py``), on one card or on a
``tensor`` mesh with the kernels on each rank's heads; GPT-2 and Llama
training (``ray_tpu_torch.train``) on one card or on a mesh of
``torch.distributed`` ranks with the ZeRO ladder
(``ray_tpu_torch.parallel``), through the flash-attention forward and
backward kernels on each rank's shard; RL for LLMs
(``ray_tpu_torch.rllib.llm``); and the rest of the parallel layer and
model zoo: ring and Ulysses attention, the in-program GPipe and
interleaved pipeline schedules with the 1F1B schedule math, the
expert-parallel MoE layer and the pipelined transformer; and classic
RL (``ray_tpu_torch.rllib``): PPO and DQN through the `Algorithm`
driver, on the port's own envs. See ROADMAP.md.
"""
