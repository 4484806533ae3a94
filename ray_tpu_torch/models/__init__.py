"""Model families of the port: GPT-2 and the Llama family
(RoPE/RMSNorm/SwiGLU/GQA), each with its partition rules for a mesh;
the expert-parallel MoE layer (`moe.py`) and the pipelined transformer
(`pipelined.py`)."""

from ray_tpu_torch.models.gpt2 import (
    GPT2Config,
    gpt2_forward,
    gpt2_partition_rules,
    init_gpt2,
)
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    init_llama,
    llama_forward,
    llama_loss,
    llama_partition_rules,
)

__all__ = ["GPT2Config", "LlamaConfig", "gpt2_forward",
           "gpt2_partition_rules", "init_gpt2", "init_llama",
           "llama_forward", "llama_loss", "llama_partition_rules"]
