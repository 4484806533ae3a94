"""Reference: python/ray/runtime_context.py; the port's copy of
``ray_tpu/core/runtime_context.py``."""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, TaskID, WorkerID


@dataclasses.dataclass(frozen=True)
class RuntimeContext:
    job_id: JobID
    node_id: NodeID
    worker_id: WorkerID
    actor_id: ActorID | None = None
    task_id: TaskID | None = None
    namespace: str = "default"
    placement_group_id: str | None = None

    def get_job_id(self) -> str:
        return self.job_id.hex()

    def get_node_id(self) -> str:
        return self.node_id.hex()

    def get_actor_id(self) -> str | None:
        return self.actor_id.hex() if self.actor_id else None

    def get_task_id(self) -> str | None:
        return self.task_id.hex() if self.task_id else None

    def get_worker_id(self) -> str:
        return self.worker_id.hex()
