"""ray_tpu_torch.tune — hyperparameter sweeps over trial actors, the
port of ``ray_tpu.tune``.

Reference parity: ray.tune (python/ray/tune/) — Tuner.fit over actor
trials with search spaces, random/grid generation, ASHA early stopping,
Population Based Training (checkpoint exploit + hyperparam explore),
PB2, median stopping, resource-changing reallocation, and on-disk
experiment state with restore. The trials run as actors of the local
runtime (``ray_tpu_torch.init(local_mode=True)``), each trainable on its
own thread with its own session, so a GPU trainable of each trial runs
on the card beside the others. Checkpoints a trainable reports are
pickled with the standard pickle; `ray_tpu_torch.train.Checkpoint`
directories from ``train.checkpointing.save_train_state`` carry large
train states.
"""

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    ResourceChangingScheduler,
)
from ray_tpu_torch.tune.search import (
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.trainable import Trainable
from ray_tpu_torch.tune.tuner import (
    ResultGrid,
    TuneConfig,
    Tuner,
    TuneResult,
    get_checkpoint,
    report,
)

__all__ = [
    "ASHAScheduler",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "ResourceChangingScheduler",
    "ResultGrid",
    "Searcher",
    "TPESearcher",
    "Trainable",
    "TuneConfig",
    "TuneResult",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "uniform",
]
