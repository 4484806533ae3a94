"""User-facing errors (reference: python/ray/exceptions.py): the port's
copy of ``ray_tpu/core/exceptions.py``."""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised; re-raised at `get` on the caller, carrying the
    remote traceback (reference: RayTaskError)."""

    def __init__(self, cause: BaseException, remote_tb: str = "", task_desc: str = ""):
        self.cause = cause
        self.remote_tb = remote_tb
        self.task_desc = task_desc
        super().__init__(str(cause))

    @staticmethod
    def from_exception(e: BaseException, task_desc: str = "") -> "TaskError":
        if isinstance(e, TaskError):
            # an errored ObjectRef consumed as an argument re-raises the
            # ORIGINAL task's error — never re-wrapped per hop, so a
            # chain of N stages surfaces one TaskError with the root
            # cause (reference: RayTaskError args pass through as-is)
            return e
        return TaskError(e, traceback.format_exc(), task_desc)

    def __str__(self):
        base = f"{type(self.cause).__name__}: {self.cause}"
        if self.task_desc:
            base = f"task {self.task_desc} failed: {base}"
        if self.remote_tb:
            base += f"\n\nremote traceback:\n{self.remote_tb}"
        return base


class ActorDiedError(RayTpuError):
    pass


class ActorUnavailableError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    pass


class OwnerDiedError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """A worker was killed by the node's memory monitor (reference:
    ray.exceptions.OutOfMemoryError raised by the OOM killer)."""


class StaleLeaseError(RayTpuError):
    """A direct leased-task push carried a lease id the worker no longer
    holds (TTL expiry or re-grant); the owner must resubmit through the
    classic scheduling path."""
