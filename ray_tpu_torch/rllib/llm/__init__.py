"""ray_tpu_torch.rllib.llm — the RL-for-LLMs flywheel, the port of
``ray_tpu.rllib.llm`` (RL.md has the walkthrough):

- **rollout** (`rollout.py`): the port's continuous-batching engine is
  the rollout actor — N completions per prompt share the task's system
  prefix through the prefix cache, per-token logprobs and
  weight-version tags ride the stream, trajectory groups stream out as
  they finish;
- **learn** (`learner.py`): a GRPO-style clipped policy-gradient
  update, one step of the train/ SPMD machinery (`make_train_step`, on
  a mesh with the models' partition rules; flash attention's kernels
  K1-K3 on the card), with a staleness guard keyed on the
  weight-version tags;
- **swap** (`flywheel.py` + serve.llm): the learner publishes its
  params and the engine installs them at a step boundary — drain-free,
  no stream drops, in-flight sequences tagged stale when they span
  versions.
"""

from ray_tpu_torch.rllib.llm.flywheel import FlywheelConfig, RLFlywheel
from ray_tpu_torch.rllib.llm.learner import LLMLearner, LLMLearnerConfig
from ray_tpu_torch.rllib.llm.reward import (
    DigitSumTask,
    SortTask,
    get_reward,
    register_reward,
)
from ray_tpu_torch.rllib.llm.rollout import RolloutConfig, RolloutWorker
from ray_tpu_torch.rllib.llm.trajectory import (
    Trajectory,
    group_relative_advantages,
    to_train_batch,
)

__all__ = [
    "DigitSumTask",
    "FlywheelConfig",
    "LLMLearner",
    "LLMLearnerConfig",
    "RLFlywheel",
    "RolloutConfig",
    "RolloutWorker",
    "SortTask",
    "Trajectory",
    "get_reward",
    "group_relative_advantages",
    "register_reward",
    "to_train_batch",
]
