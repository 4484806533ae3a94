"""ray_tpu_torch.rllib — reinforcement learning, the port of
``ray_tpu.rllib``.

Ported so far: RL for LLMs, the `ray_tpu_torch.rllib.llm` subpackage
(the GRPO flywheel: rollout through the port's serving engine, the
learner's update through its train step, a drain-free weight hot-swap).
It is imported lazily, as in the JAX package: ``import
ray_tpu_torch.rllib.llm`` pulls in the serving and training stacks. The
env-RL algorithms (PPO first) are a later slice (ROADMAP.md).
"""
