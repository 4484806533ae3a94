"""Channels + the Communicator seam (compiled-DAG data plane).

The port's copy of ``ray_tpu/experimental/channel.py``. Reference
parity: python/ray/experimental/channel/ — the Communicator ABC
(communicator.py:19, send/recv/allreduce) and shared-memory
mutable-object channels (shared_memory_channel.py over the C++
MutableObjectManager). Here:

- `Channel`: named shared-memory SPSC ring (native C++,
  ``csrc/channel.cc``, the JAX package's source, built with the host C++
  compiler into ``build/`` by `_build.build_host` on first use) for
  same-node cross-process byte streams — microsecond-latency, bypassing
  the RPC layer and the object store. There is no pure-Python ring: a
  machine with no C++ compiler has no channels;
- `ShmCommunicator`: point-to-point Communicator over a full mesh of
  channels for a named group of local processes;
- `CollectiveCommunicator`: Communicator whose allreduce rides the
  host collective module (ray_tpu_torch.util.collective).

Objects cross a channel through the port's pickler
(``core/serialization.dumps``/``loads``), not plain pickle: a torch
tensor crosses as its raw bytes (a CUDA tensor is copied to the host by
the writer and put back on the card by the reader, as through the
object store), and a value whose class travels by value (a compiled
graph's error marker holding a TaskError of a ``__main__`` exception)
reads back in a process that cannot import it. The ring's bytes are the
JAX package's: a ring either package wrote, the other reads.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any

from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.object_store import ShmSegment


class ChannelClosed(Exception):
    pass


def _chan_lib():
    from ray_tpu_torch import _build

    path = _build.build_host("channel")
    if path is None:
        raise RuntimeError("native channel library unavailable (no c++?)")
    lib = ctypes.CDLL(path)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.chan_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.chan_attached_ok.argtypes = [ctypes.c_void_p]
    lib.chan_close.argtypes = [ctypes.c_void_p]
    lib.chan_close.restype = None
    lib.chan_is_closed.argtypes = [ctypes.c_void_p]
    # c_void_p, not c_char_p: put() hands over the address of its
    # serialized bytearray, so a message is copied once, into the ring
    lib.chan_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_uint64]
    lib.chan_peek.argtypes = [ctypes.c_void_p, u64p, u64p]
    lib.chan_peek.restype = ctypes.c_int64
    lib.chan_pop.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.chan_pop.restype = None
    for f in ("chan_init", "chan_attached_ok", "chan_write",
              "chan_is_closed"):
        getattr(lib, f).restype = ctypes.c_int
    return lib


_lib = None


def _lib_once():
    global _lib
    if _lib is None:
        _lib = _chan_lib()
    return _lib


class Channel:
    """Named SPSC byte channel in shared memory."""

    def __init__(self, name: str | None = None, capacity: int = 1 << 20,
                 create: bool = True):
        self._lib = _lib_once()
        if create:
            self._seg = ShmSegment(name=name, create=True,
                                   size=capacity + 64)
            self._base = ctypes.addressof(
                ctypes.c_char.from_buffer(self._seg._mmap))
            if self._lib.chan_init(self._base, self._seg.size) != 0:
                raise ValueError("channel segment too small")
        else:
            self._seg = ShmSegment(name=name, create=False)
            self._base = ctypes.addressof(
                ctypes.c_char.from_buffer(self._seg._mmap))
            if self._lib.chan_attached_ok(self._base) != 0:
                raise ValueError(f"shm segment {name} is not a channel")
        self.name = self._seg.name
        self._owner = create

    # -- raw bytes -------------------------------------------------------

    def put_bytes(self, data: bytes | bytearray,
                  timeout: float | None = None):
        n = len(data)
        # the address stays valid while `data` (referenced here) lives
        if isinstance(data, bytes):
            ptr = data
        else:
            ptr = ctypes.addressof(ctypes.c_char.from_buffer(data)) \
                if n else None
        deadline = None if timeout is None else time.monotonic() + timeout
        sleep = 1e-6
        while True:
            rc = self._lib.chan_write(self._base, ptr, n)
            if rc == 0:
                return
            if rc == -2:
                raise ValueError(f"message of {n} bytes exceeds "
                                 f"channel capacity")
            if rc == -3:
                raise ChannelClosed(self.name)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"channel {self.name} full")
            time.sleep(sleep)
            sleep = min(sleep * 2, 0.001)

    def _take(self, timeout: float | None, copy) -> Any:
        """Wait for the next message and return `copy` of its bytes (a
        view into the ring, valid only until the pop that follows)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        off = ctypes.c_uint64()
        adv = ctypes.c_uint64()
        sleep = 1e-6
        while True:
            n = self._lib.chan_peek(self._base, ctypes.byref(off),
                                    ctypes.byref(adv))
            if n >= 0:
                data = copy(self._seg.buf[off.value:off.value + n])
                self._lib.chan_pop(self._base, adv.value)
                return data
            if n == -3:
                raise ChannelClosed(self.name)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"channel {self.name} empty")
            time.sleep(sleep)
            sleep = min(sleep * 2, 0.001)

    def get_bytes(self, timeout: float | None = None) -> bytes:
        return self._take(timeout, bytes)

    # -- objects ---------------------------------------------------------

    def put(self, value: Any, timeout: float | None = None):
        head, views, total = ser.serialize(value)
        buf = bytearray(total)
        ser.write_into(memoryview(buf), head, views)
        self.put_bytes(buf, timeout)

    def get(self, timeout: float | None = None) -> Any:
        # a bytearray: a CPU tensor read back aliases writable bytes
        # that it alone holds
        return ser.loads(self._take(timeout, bytearray))

    def close(self):
        try:
            self._lib.chan_close(self._base)
        except Exception:  # noqa: BLE001
            pass

    def destroy(self):
        self.close()
        self._base = None
        self._seg.close()
        if self._owner:
            self._seg.unlink()


class Communicator:
    """ABC (reference: experimental/channel/communicator.py:19)."""

    def send(self, value, peer_rank: int):
        raise NotImplementedError

    def recv(self, peer_rank: int):
        raise NotImplementedError

    def allreduce(self, value, op: str = "sum"):
        raise NotImplementedError

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def world_size(self) -> int:
        raise NotImplementedError


class ShmCommunicator(Communicator):
    """Full mesh of shm channels for N same-node processes. Channel
    (i -> j) is a distinct SPSC ring, so every directed pair is
    single-producer/single-consumer by construction."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 capacity: int = 1 << 20):
        self._rank = rank
        self._world = world_size
        self._chans: dict[tuple[int, int], Channel] = {}
        for i in range(world_size):
            for j in range(world_size):
                if i == j:
                    continue
                if i != rank and j != rank:
                    continue
                name = f"rtc_{group_name}_{i}_{j}"
                chan = self._open_or_create(name, capacity)
                self._chans[(i, j)] = chan

    @staticmethod
    def _open_or_create(name: str, capacity: int) -> Channel:
        try:
            return Channel(name=name, capacity=capacity, create=True)
        except FileExistsError:
            return Channel(name=name, create=False)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    def send(self, value, peer_rank: int, timeout: float | None = 30.0):
        self._chans[(self._rank, peer_rank)].put(value, timeout)

    def recv(self, peer_rank: int, timeout: float | None = 30.0):
        return self._chans[(peer_rank, self._rank)].get(timeout)

    def allreduce(self, value, op: str = "sum"):
        """Naive gather-to-0 + broadcast (metadata-scale)."""
        import numpy as np

        if self._rank == 0:
            acc = np.asarray(value)
            for peer in range(1, self._world):
                other = np.asarray(self.recv(peer))
                if op == "sum":
                    acc = acc + other
                elif op == "max":
                    acc = np.maximum(acc, other)
                elif op == "min":
                    acc = np.minimum(acc, other)
                else:
                    raise ValueError(f"unknown op {op!r}")
            for peer in range(1, self._world):
                self.send(acc, peer)
            return acc
        self.send(value, 0)
        return self.recv(0)

    def destroy(self):
        for ch in self._chans.values():
            try:
                ch.destroy()
            except Exception:  # noqa: BLE001
                pass


class CollectiveCommunicator(Communicator):
    """Communicator over the host collective rendezvous (works across
    nodes; reference cpu_communicator.py)."""

    def __init__(self, group_name: str, world_size: int, rank: int):
        from ray_tpu_torch.util import collective as col

        self._col = col
        self._group = group_name
        self._rank = rank
        self._world = world_size
        col.init_collective_group(world_size, rank, group_name=group_name)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    def send(self, value, peer_rank: int):
        self._col.send(value, peer_rank, group_name=self._group)

    def recv(self, peer_rank: int):
        return self._col.recv(peer_rank, group_name=self._group)

    def allreduce(self, value, op: str = "sum"):
        return self._col.allreduce(value, group_name=self._group, op=op)
