"""Validation of @remote(...) / .options(...) arguments.

Reference: python/ray/_private/ray_option_utils.py. The port's copy of
``ray_tpu/core/options.py`` with the accelerator renamed: ``num_gpus``
and the ``"GPU"`` resource where the JAX package has ``num_tpus`` and
``"TPU"`` (which it maps ``num_gpus`` onto).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TaskOptions:
    num_cpus: float | None = None
    num_gpus: float | None = None
    resources: dict[str, float] = dataclasses.field(default_factory=dict)
    # int, or "streaming" for generator tasks (each yield becomes one
    # stream item delivered to the owner as produced — reference:
    # num_returns="streaming", python/ray/_raylet.pyx generator tasks)
    num_returns: int | str = 1
    # streaming only: cap on yielded-but-unconsumed items before the
    # producer blocks (reference: _generator_backpressure_num_objects)
    generator_backpressure_num_objects: int | None = None
    max_retries: int = 3
    retry_exceptions: bool | list = False
    name: str | None = None
    scheduling_strategy: Any = None
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    label_selector: dict[str, str] | None = None
    # {"env_vars": {...}, "working_dir": path} (reference:
    # _private/runtime_env/ — env materialized before the worker starts)
    runtime_env: dict | None = None

    def resource_request(self) -> dict[str, float]:
        req = dict(self.resources)
        req["CPU"] = self.num_cpus if self.num_cpus is not None else 1.0
        if self.num_gpus:
            req["GPU"] = self.num_gpus
        return {k: v for k, v in req.items() if v}


@dataclasses.dataclass
class ActorOptions:
    num_cpus: float | None = None
    num_gpus: float | None = None
    resources: dict[str, float] = dataclasses.field(default_factory=dict)
    name: str | None = None
    namespace: str | None = None
    lifetime: str | None = None  # None | "detached"
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    # named concurrency groups: {group: max_concurrency}
    # (reference: concurrency_group_manager.h:34)
    concurrency_groups: dict[str, int] | None = None
    scheduling_strategy: Any = None
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    get_if_exists: bool = False
    label_selector: dict[str, str] | None = None
    runtime_env: dict | None = None

    def resource_request(self) -> dict[str, float]:
        req = dict(self.resources)
        # Actors default to 1 CPU for placement but 0 for running
        # (reference semantics); we keep it simple: reserve what's asked,
        # default 1 CPU.
        req["CPU"] = self.num_cpus if self.num_cpus is not None else 1.0
        if self.num_gpus:
            req["GPU"] = self.num_gpus
        return {k: v for k, v in req.items() if v}


_TASK_KEYS = {f.name for f in dataclasses.fields(TaskOptions)}
_ACTOR_KEYS = {f.name for f in dataclasses.fields(ActorOptions)}
# accepted-but-ignored (compat shims, recorded for parity)
_SOFT_KEYS = {"memory", "accelerator_type", "_metadata",
              "enable_task_events"}


def _normalize(d: dict) -> dict:
    d = dict(d)
    strat = d.get("scheduling_strategy")
    if strat is not None and hasattr(strat, "placement_group"):
        d["placement_group"] = strat.placement_group
        d["placement_group_bundle_index"] = getattr(
            strat, "placement_group_bundle_index", -1)
    elif strat is not None and hasattr(strat, "to_label_selector"):
        # NodeAffinity / NodeLabel strategies lower to the label
        # scheduler (nodes auto-carry "ray.io/node-id"); explicit
        # selectors win on key conflicts
        sel = dict(strat.to_label_selector())
        sel.update(d.get("label_selector") or {})
        d["label_selector"] = sel
    return d


def task_options(d: dict) -> TaskOptions:
    _check(d, _TASK_KEYS, "task")
    d = _normalize(d)
    nr = d.get("num_returns", 1)
    if isinstance(nr, str) and nr not in ("streaming", "dynamic"):
        raise ValueError(
            f'num_returns must be an int or "streaming", got {nr!r}')
    return TaskOptions(**{k: v for k, v in d.items() if k in _TASK_KEYS})


def actor_options(d: dict) -> ActorOptions:
    _check(d, _ACTOR_KEYS, "actor")
    d = _normalize(d)
    return ActorOptions(**{k: v for k, v in d.items() if k in _ACTOR_KEYS})


def _check(d: dict, allowed: set, kind: str):
    bad = set(d) - allowed - _SOFT_KEYS
    if bad:
        raise ValueError(f"invalid {kind} option(s): {sorted(bad)}")
