"""Node-local shared-memory object store (Python side).

The port's copy of ``ray_tpu/core/object_store.py``. Reference parity:
the plasma store + client (src/ray/object_manager/plasma/store.h:55,
client.h) and the two-tier store providers
(src/ray/core_worker/store_provider/). Design departure: no store server
process — every worker maps the same named shm segment and calls into
the native allocator library (``csrc/object_store.cc``, the JAX
package's source, built with the host C++ compiler into ``build/`` by
`_build.build_host` on first use) directly under a process-shared lock,
so create/get are library calls, not RPCs.

Two implementations with one interface (`kind()` says which one a
process gets):
- `SharedMemoryStore`: one big segment + native C++ allocator (preferred).
- `SegmentPerObjectStore`: pure-Python fallback, one shm segment per
  object (slower create, still zero-copy cross-process), for a machine
  with no C++ compiler.

A segment's pages live in ``/dev/shm``, which a container may size far
below the store: touching a page past its end kills the process with
SIGBUS. So a store refuses, at creation, a capacity larger than the free
space there, naming both sizes.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import secrets
import threading

from ray_tpu_torch.core import config as _cfg


def default_capacity() -> int:
    return _cfg.get("OBJECT_STORE_BYTES")


_creation_metrics = None


def _note_create(nbytes: int) -> None:
    """Per-process creation accounting (objects written into the shm
    store by THIS process — workers' numbers reach the cluster /metrics
    page via the nodelet's per-worker scrape). Lazy so importing the
    store never drags in the metrics module."""
    global _creation_metrics
    m = _creation_metrics
    if m is None:
        from ray_tpu_torch.util.metrics import Counter

        m = _creation_metrics = (
            Counter("object_store_created_objects_total",
                    "Objects created in the local shm store"),
            Counter("object_store_created_bytes_total",
                    "Bytes of objects created in the local shm store"))
    m[0].inc()
    m[1].inc(nbytes)
_TABLE_CAPACITY = 65536

_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else (
    os.environ.get("TMPDIR", "/tmp"))


def shm_free_bytes() -> int:
    """Free bytes of the filesystem that holds the store's segments."""
    st = os.statvfs(_SHM_DIR)
    return st.f_bavail * st.f_frsize


def check_capacity(capacity: int) -> None:
    """Refuse a segment larger than the room left in the shm directory
    (a page touched past it is a SIGBUS, not an exception)."""
    free = shm_free_bytes()
    if capacity > free:
        raise ObjectStoreFullError(
            f"object store capacity {capacity} bytes exceeds the "
            f"{free} bytes free in {_SHM_DIR}; set "
            f"RAY_TPU_OBJECT_STORE_BYTES below that or enlarge {_SHM_DIR}")


class ShmSegment:
    """Named shared-memory segment via raw shm file + mmap.

    Deliberately NOT multiprocessing.shared_memory: its resource_tracker
    unlinks 'leaked' segments when any attaching process dies without
    cleanup — a crashing worker would destroy the node's object store
    for everyone (exactly the crash-isolation plasma exists to provide).
    """

    def __init__(self, name: str | None = None, create: bool = False,
                 size: int = 0):
        if create:
            name = name or f"rts_{secrets.token_hex(6)}"
            path = os.path.join(_SHM_DIR, name)
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mmap = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        else:
            path = os.path.join(_SHM_DIR, name)
            fd = os.open(path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                self._mmap = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        self.name = name
        self.size = size
        self.buf = memoryview(self._mmap)

    def close(self):
        try:
            self.buf.release()
        except (BufferError, AttributeError):
            pass
        try:
            self._mmap.close()
        except (BufferError, ValueError):
            pass  # exported pointers still alive; mapping dies with process

    def unlink(self):
        try:
            os.unlink(os.path.join(_SHM_DIR, self.name))
        except FileNotFoundError:
            pass


class ObjectStoreFullError(MemoryError):
    pass


def _load_native():
    from ray_tpu_torch import _build

    path = _build.build_host("object_store")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rts_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.rts_attached_ok.argtypes = [ctypes.c_void_p]
    lib.rts_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, u64p]
    lib.rts_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p, u64p]
    lib.rts_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p, u64p]
    for f in ("rts_init", "rts_attached_ok", "rts_create", "rts_seal", "rts_get",
              "rts_contains", "rts_release", "rts_delete"):
        getattr(lib, f).restype = ctypes.c_int
    return lib


_native_lib = None
_native_lock = threading.Lock()


def native_lib():
    global _native_lib
    if _native_lib is None:
        with _native_lock:
            if _native_lib is None:
                _native_lib = _load_native() or False
    return _native_lib or None


class SharedMemoryStore:
    """One shm segment, native allocator. All sizes in bytes."""

    def __init__(self, name: str | None = None, capacity: int | None = None,
                 create: bool = True):
        capacity = capacity if capacity is not None else default_capacity()
        self._lib = native_lib()
        if self._lib is None:
            raise RuntimeError("native object store library unavailable")
        if create:
            check_capacity(capacity)
            self._shm = ShmSegment(name=name, create=True, size=capacity)
            self._base = ctypes.addressof(ctypes.c_char.from_buffer(self._shm._mmap))
            if self._lib.rts_init(self._base, self._shm.size, _TABLE_CAPACITY) != 0:
                raise RuntimeError("object store segment too small")
        else:
            self._shm = ShmSegment(name=name, create=False)
            self._base = ctypes.addressof(ctypes.c_char.from_buffer(self._shm._mmap))
            if self._lib.rts_attached_ok(self._base) != 0:
                raise RuntimeError(f"shm segment {name} is not an object store")
        self.name = self._shm.name
        self._owner = create

    # -- raw buffer protocol --------------------------------------------------

    def create(self, oid: bytes, size: int) -> memoryview:
        off = ctypes.c_uint64()
        rc = self._lib.rts_create(self._base, oid, size, ctypes.byref(off))
        if rc == -1:
            raise KeyError(f"object {oid.hex()} already exists")
        if rc == -2:
            raise ObjectStoreFullError(
                f"object of {size} bytes does not fit in store {self.name}")
        if rc != 0:
            raise RuntimeError(f"object table full (rc={rc})")
        _note_create(size)
        o = off.value
        return self._shm.buf[o:o + size]

    def seal(self, oid: bytes):
        if self._lib.rts_seal(self._base, oid) != 0:
            raise KeyError(f"seal: no unsealed object {oid.hex()}")

    def put(self, oid: bytes, data) -> None:
        data = memoryview(data).cast("B")
        buf = self.create(oid, data.nbytes)
        buf[:] = data
        self.seal(oid)
        self._lib.rts_release(self._base, oid)

    def get(self, oid: bytes) -> memoryview | None:
        """Returns a zero-copy view (holds a refcount; call release(oid))."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        if self._lib.rts_get(self._base, oid, ctypes.byref(off), ctypes.byref(size)) != 0:
            return None
        return self._shm.buf[off.value:off.value + size.value]

    def contains(self, oid: bytes) -> bool:
        return bool(self._lib.rts_contains(self._base, oid))

    def release(self, oid: bytes):
        if self._base is None:  # closed: a late hold has nothing to return
            return
        self._lib.rts_release(self._base, oid)

    def delete(self, oid: bytes):
        self._lib.rts_delete(self._base, oid)

    def stats(self) -> dict:
        a = ctypes.c_uint64(); n = ctypes.c_uint64()
        e = ctypes.c_uint64(); c = ctypes.c_uint64()
        self._lib.rts_stats(self._base, ctypes.byref(a), ctypes.byref(n),
                            ctypes.byref(e), ctypes.byref(c))
        return {"bytes_allocated": a.value, "num_objects": n.value,
                "evictions": e.value, "capacity": c.value}

    def close(self):
        self._base = None
        self._shm.close()

    def unlink(self):
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class SegmentPerObjectStore:
    """Fallback: one shm segment per object, discovered by name. No
    eviction, no allocator — used only when g++ is unavailable."""

    def __init__(self, name: str | None = None, capacity: int = 0, create: bool = True):
        self.name = name or f"rts_{secrets.token_hex(6)}"
        # RPC handler threads (fetch/pull/free) hit one store instance
        # concurrently; the native path is locked in C, this fallback
        # must lock its segment tables itself
        self._lock = threading.Lock()
        self._held: dict[bytes, ShmSegment] = {}  # guarded_by(_lock)
        self._unsealed: dict[bytes, ShmSegment] = {}  # guarded_by(_lock)
        self._owner = create

    def _seg_name(self, oid: bytes) -> str:
        return f"{self.name}_{oid.hex()[:24]}"

    # segment layout: [u8 sealed][7 pad][u64 size][payload]
    _HDR = 16

    def create(self, oid: bytes, size: int) -> memoryview:
        check_capacity(max(1, size) + self._HDR)
        seg = ShmSegment(self._seg_name(oid), create=True,
                         size=max(1, size) + self._HDR)
        seg.buf[0] = 0  # unsealed
        seg.buf[8:16] = size.to_bytes(8, "little")
        with self._lock:
            self._unsealed[oid] = seg
        _note_create(size)
        return seg.buf[self._HDR:self._HDR + size]

    def seal(self, oid: bytes):
        # one critical section: a pop/insert gap would let a racing
        # delete() miss the object (leaking its shm file) and a racing
        # get() attach a duplicate segment this assignment clobbers
        with self._lock:
            seg = self._unsealed.pop(oid, None)
            if seg is None:
                raise KeyError(f"seal: no unsealed object {oid.hex()}")
            seg.buf[0] = 1
            self._held[oid] = seg

    def put(self, oid: bytes, data) -> None:
        data = memoryview(data).cast("B")
        buf = self.create(oid, data.nbytes)
        buf[:] = data
        self.seal(oid)

    def get(self, oid: bytes) -> memoryview | None:
        with self._lock:
            if oid in self._unsealed:
                return None
            seg = self._held.get(oid)
        if seg is None:
            try:
                seg = ShmSegment(self._seg_name(oid), create=False)
            except FileNotFoundError:
                return None
            with self._lock:
                # a racing get may have attached too; keep the winner so
                # the loser's mapping dies with its local reference
                seg = self._held.setdefault(oid, seg)
        if seg.buf[0] != 1:  # not sealed yet
            return None
        size = int.from_bytes(bytes(seg.buf[8:16]), "little")
        return seg.buf[self._HDR:self._HDR + size]

    def contains(self, oid: bytes) -> bool:
        return self.get(oid) is not None

    def release(self, oid: bytes):
        pass

    def delete(self, oid: bytes):
        with self._lock:
            seg = self._held.pop(oid, None)
        if seg is not None:
            try:
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass

    def stats(self) -> dict:
        return {"bytes_allocated": 0, "num_objects": len(self._held),
                "evictions": 0, "capacity": 0}

    def close(self):
        for seg in list(self._held.values()) + list(self._unsealed.values()):
            try:
                seg.close()
            except Exception:
                pass

    def unlink(self):
        if self._owner:
            for oid in list(self._held):
                self.delete(oid)


def kind() -> str:
    """Which store `open_store` gives in this process: "native" (one
    segment, the C++ allocator) or "segment-per-object" (no compiler)."""
    return "native" if native_lib() is not None else "segment-per-object"


def open_store(name: str | None = None, capacity: int | None = None,
               create: bool = True):
    capacity = capacity if capacity is not None else default_capacity()
    if native_lib() is not None:
        return SharedMemoryStore(name=name, capacity=capacity, create=create)
    return SegmentPerObjectStore(name=name, capacity=capacity, create=create)
