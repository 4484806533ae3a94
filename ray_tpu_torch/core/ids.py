"""Binary IDs (reference: src/ray/common/id.h): the port's copy of
``ray_tpu/core/ids.py``."""

from __future__ import annotations

import os
import random as _random
import threading


class _IdRng(threading.local):
    """Per-thread PRNG for id minting, seeded once from the OS pool.

    ``os.urandom`` is a syscall per call and costs ~100us on small
    Firecracker guests (measured: 40% of the task-submit hot path went
    to entropy reads). Ids need uniqueness, not unpredictability: a
    128-bit draw from a per-thread Mersenne generator seeded with
    urandom + pid + thread id keeps the collision math identical while
    staying in user space. Thread-local so concurrent submitters never
    contend (and never share generator state unlocked); fork safety
    comes from the pid in the lazy seed."""

    def __init__(self):
        self.rng = _random.Random(
            os.urandom(16) + os.getpid().to_bytes(8, "little")
            + threading.get_ident().to_bytes(8, "little"))


_id_rng = _IdRng()


def _reseed_after_fork():
    # a forked child inherits the parent thread's generator STATE; a
    # fresh thread-local forces re-seeding (pid differs) on first use
    global _id_rng
    _id_rng = _IdRng()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed_after_fork)


class BaseID:
    """16-byte random id with hex repr."""

    __slots__ = ("_bytes",)
    SIZE = 16

    def __init__(self, b: bytes):
        if len(b) != self.SIZE:
            raise ValueError(f"{type(self).__name__} needs {self.SIZE} bytes")
        self._bytes = b

    @classmethod
    def random(cls):
        return cls(_id_rng.rng.randbytes(cls.SIZE))

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class JobID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass
