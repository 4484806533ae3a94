"""ray_tpu_torch.rllib — reinforcement learning, the port of
``ray_tpu.rllib``.

Ported so far:

- the classic stack's PPO and DQN (with prioritized replay) through the
  `Algorithm` driver (a tune `Trainable`, with periodic evaluation and
  checkpoints), the catalog's conv and MLP encoders, the connectors,
  the `RLModule`, local env runners on the port's own vector envs
  (`rllib/envs.py`: CartPole-v1 and PixelCatch-v0, no gymnasium), and
  the PPO learner on one device or on a ``data`` mesh of
  `torch.distributed` ranks. Params live on the card unless the config
  says ``device="cpu"``.
- RL for LLMs, the `ray_tpu_torch.rllib.llm` subpackage (the GRPO
  flywheel: rollout through the port's serving engine, the learner's
  update through its train step, a drain-free weight hot-swap). It is
  imported lazily, as in the JAX package: ``import
  ray_tpu_torch.rllib.llm`` pulls in the serving and training stacks.

Still to come (ROADMAP.md): APPO and IMPALA with `vtrace`; SAC and CQL
(Pendulum must join the env layer); DreamerV3, multi-agent, offline RL
(BC, MARWIL) and off-policy estimation; and the remote env runners,
which are actors and wait for the runtime (``num_env_runners > 0``
raises).
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.catalog import Catalog
from ray_tpu_torch.rllib.connectors import (
    ConnectorPipeline,
    ConnectorV2,
    FlattenObs,
    FrameStack,
    GeneralAdvantageEstimation,
    NormalizeImage,
)
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, ReplayBuffer
from ray_tpu_torch.rllib.env_runner import (
    EnvRunnerGroup,
    SingleAgentEnvRunner,
)
from ray_tpu_torch.rllib.learner import (
    PPOLearner,
    PPOLearnerConfig,
    compute_gae,
)
from ray_tpu_torch.rllib.metrics import MetricsLogger
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer, SumTree
from ray_tpu_torch.rllib.rl_module import (
    DefaultActorCriticModule,
    RLModule,
    RLModuleSpec,
)

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "Catalog",
    "ConnectorPipeline",
    "ConnectorV2",
    "DQN",
    "DQNConfig",
    "DefaultActorCriticModule",
    "EnvRunnerGroup",
    "FlattenObs",
    "FrameStack",
    "GeneralAdvantageEstimation",
    "MetricsLogger",
    "NormalizeImage",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "PPOLearnerConfig",
    "PrioritizedReplayBuffer",
    "RLModule",
    "RLModuleSpec",
    "ReplayBuffer",
    "SingleAgentEnvRunner",
    "SumTree",
    "compute_gae",
]
