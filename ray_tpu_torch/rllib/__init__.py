"""ray_tpu_torch.rllib — reinforcement learning, the port of
``ray_tpu.rllib``.

Ported so far:

- the classic stack's PPO and DQN (with prioritized replay) through the
  `Algorithm` driver (a tune `Trainable`, with periodic evaluation and
  checkpoints), the catalog's conv and MLP encoders, the connectors,
  the `RLModule`, local env runners on the port's own vector envs
  (`rllib/envs.py`: CartPole-v1, PixelCatch-v0 and Pendulum-v1, no
  gymnasium), and
  the PPO learner on one device or on a ``data`` mesh of
  `torch.distributed` ranks. Params live on the card unless the config
  says ``device="cpu"``.
- RL for LLMs, the `ray_tpu_torch.rllib.llm` subpackage (the GRPO
  flywheel: rollout through the port's serving engine, the learner's
  update through its train step, a drain-free weight hot-swap). It is
  imported lazily, as in the JAX package: ``import
  ray_tpu_torch.rllib.llm`` pulls in the serving and training stacks.
- the families that run without a runtime: IMPALA and APPO
  with `vtrace` (a background learner thread on the device), SAC on the
  port's Pendulum-v1, DreamerV3 (vector and pixel world models, the
  RSSM and imagination scans as loops), multi-agent PPO
  (`MultiRLModule`, `CoordinationGame`) and the off-policy estimators
  (IS, WIS, DR) over in-memory rows. The seeded conv learners run
  cuDNN's deterministic algorithms (`catalog.deterministic_convs`).

- offline RL over ``ray_tpu_torch.data`` on the local runtime:
  experience recording (`record_experiences`,
  `record_continuous_experiences`), `load_offline_dataset`, BC and
  MARWIL, and CQL on the SAC networks; OPE over a recorded dataset
  reads it back through the same layer.
- the remote env runners (``num_env_runners > 0``, the PPO and IMPALA
  defaults): actors on the cluster runtime that sample on the CPU and
  take the learner's weights through the object store; IMPALA and APPO
  sample them asynchronously.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.catalog import Catalog
from ray_tpu_torch.rllib.connectors import (
    ConnectorPipeline,
    ConnectorV2,
    FlattenObs,
    FrameStack,
    GeneralAdvantageEstimation,
    NormalizeImage,
)
from ray_tpu_torch.rllib.cql import (
    CQL,
    CQLConfig,
    record_continuous_experiences,
)
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, ReplayBuffer
from ray_tpu_torch.rllib.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.env_runner import (
    EnvRunnerGroup,
    SingleAgentEnvRunner,
)
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, vtrace
from ray_tpu_torch.rllib.learner import (
    PPOLearner,
    PPOLearnerConfig,
    compute_gae,
)
from ray_tpu_torch.rllib.metrics import MetricsLogger
from ray_tpu_torch.rllib.multi_agent import (
    CoordinationGame,
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiRLModule,
)
from ray_tpu_torch.rllib.offline import (
    BC,
    BCConfig,
    MARWILConfig,
    load_offline_dataset,
    record_experiences,
)
from ray_tpu_torch.rllib.ope import (
    DoublyRobust,
    ImportanceSampling,
    WeightedImportanceSampling,
    split_episodes,
)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer, SumTree
from ray_tpu_torch.rllib.rl_module import (
    DefaultActorCriticModule,
    RLModule,
    RLModuleSpec,
)
from ray_tpu_torch.rllib.sac import SAC, SACConfig

__all__ = [
    "APPO",
    "APPOConfig",
    "Algorithm",
    "AlgorithmConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "Catalog",
    "ConnectorPipeline",
    "ConnectorV2",
    "CoordinationGame",
    "DQN",
    "DQNConfig",
    "DefaultActorCriticModule",
    "DoublyRobust",
    "DreamerV3",
    "DreamerV3Config",
    "EnvRunnerGroup",
    "FlattenObs",
    "FrameStack",
    "GeneralAdvantageEstimation",
    "IMPALA",
    "IMPALAConfig",
    "ImportanceSampling",
    "MARWILConfig",
    "MetricsLogger",
    "MultiAgentEnv",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "MultiRLModule",
    "NormalizeImage",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "PPOLearnerConfig",
    "PrioritizedReplayBuffer",
    "RLModule",
    "RLModuleSpec",
    "ReplayBuffer",
    "SAC",
    "SACConfig",
    "SingleAgentEnvRunner",
    "SumTree",
    "WeightedImportanceSampling",
    "compute_gae",
    "load_offline_dataset",
    "record_continuous_experiences",
    "record_experiences",
    "split_episodes",
    "vtrace",
]
