"""Object serialization: a by-value pickler + out-of-band buffers.

The port's copy of ``ray_tpu/core/serialization.py`` without
cloudpickle (the card's machine has none). Reference parity:
python/ray/_private/serialization.py:122 (SerializationContext —
pickle5 with out-of-band buffers, zero-copy numpy). Pickle protocol 5
with a buffer_callback, so large array payloads (numpy arrays, and
torch tensors through a uint8 view of their storage) are written
separately from the pickle stream and can be mapped zero-copy out of
the shared-memory store on the read side.

Wire format (one contiguous blob), the JAX package's byte for byte, so
a blob of plain values and numpy arrays reads the same in both:
  [u32 magic][u32 nbuf][u64 pickle_len][u64 buf_len]*nbuf
  [pickle bytes][pad to 64][buf0][pad to 64][buf1]...

By value or by reference (cloudpickle's rule, which the JAX package's
callers rely on): a function or class goes BY VALUE when its module is
``__main__``, when its qualname holds ``<locals>`` or ``<lambda>``, or
when it is not found under its module and qualname (or that module is
not imported); everything else goes by reference. A function by value
carries its code (``marshal``: workers run the same interpreter), the
globals its code names (modules by reference), its closure cells,
defaults, kwdefaults, qualname, dict and, on Python 3.12, its type
params; it is rebuilt as a skeleton first and filled in afterwards, so
recursive functions and classes whose methods reach back to the class
(the zero-argument ``super()``'s ``__class__`` cell) close their cycles
through the pickle memo.

Tensors: a ``torch.Tensor`` goes out of band as its storage's bytes
(``view(torch.uint8)``: numpy has no bf16) with its dtype, shape and
device type. A CUDA tensor is copied to the host when it is written and
put back on the card when it is read; a reader that sees no card
raises, as torch's own unpickling of a CUDA tensor does. A CPU tensor
read out of the store is a zero-copy view of the store's bytes (as a
numpy array is): writing into it writes into the stored object.
"""

from __future__ import annotations

import builtins
import dataclasses
import dis
import io
import marshal
import pickle
import struct
import sys
import types
import warnings
import weakref
from typing import Any

_MAGIC = 0x52545053  # "RTPS"
_ALIGN = 64

# Per-process payload accounting (reference role: object-store metrics).
# pickle_bytes counts bytes that went THROUGH the pickle stream;
# buffer_bytes counts out-of-band payload that bypassed it. The data
# layer's zero-copy claim is auditable as: big numeric blocks move with
# buffer_bytes ≈ payload and pickle_bytes ≈ envelope-only.
STATS = {"pickle_bytes": 0, "buffer_bytes": 0,
         "serialize_calls": 0, "deserialize_calls": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


_FAST_LEAF = (int, float, bool, bytes, str, type(None), complex)


def _fast_picklable(obj, depth: int = 3) -> bool:
    """True when plain (C-accelerated) pickle provably behaves like the
    by-value pickler for this object: builtin scalars, numpy buffers, and
    shallow builtin containers of those. Anything that could reference
    user-defined modules (instances, functions, classes) or a tensor
    goes through `Pickler` so by-value semantics hold."""
    if isinstance(obj, _FAST_LEAF):
        return True
    t = type(obj)
    if t.__module__ == "numpy":
        # object-dtype arrays hold arbitrary python objects that need
        # the by-value semantics
        dt = getattr(obj, "dtype", None)
        return dt is None or dt.kind != "O"
    if depth <= 0:
        return False
    if t is dict:
        return all(isinstance(k, _FAST_LEAF) and _fast_picklable(v, depth - 1)
                   for k, v in obj.items())
    if t in (list, tuple, set, frozenset):
        return all(_fast_picklable(v, depth - 1) for v in obj)
    return False


# ------------------------------------------------------------- by value


def _lookup(module_name: str | None, qualname: str):
    """The object found under `module_name` and `qualname` in an
    imported module, or None."""
    if not module_name or module_name == "__main__":
        return None
    mod = sys.modules.get(module_name)
    if mod is None or getattr(mod, "__spec__", 0) is None:
        return None  # not imported here, or built dynamically
    obj = mod
    for part in qualname.split("."):
        if part in ("<locals>", "<lambda>"):
            return None
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def by_reference(obj) -> bool:
    """cloudpickle's rule: a function or class pickles by reference iff
    it is found under its module and qualname in an imported module
    other than ``__main__``."""
    module_name = getattr(obj, "__module__", None)
    if module_name is None:
        module_name = pickle.whichmodule(obj, obj.__qualname__)
    return _lookup(module_name, obj.__qualname__) is obj


_GLOBAL_OPS = frozenset(("LOAD_GLOBAL", "STORE_GLOBAL", "DELETE_GLOBAL"))
_code_globals: "weakref.WeakKeyDictionary[types.CodeType, tuple]" = \
    weakref.WeakKeyDictionary()


def _names_of(code: types.CodeType) -> tuple:
    """The global names `code` and the code nested in it load, store or
    delete (the only globals a rebuilt function can reach)."""
    names = _code_globals.get(code)
    if names is None:
        out = set()
        for ins in dis.get_instructions(code):
            if ins.opname in _GLOBAL_OPS:
                out.add(ins.argval)
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                out.update(_names_of(c))
        names = _code_globals[code] = tuple(sorted(out))
    return names


def _make_skel_func(code_bytes, base_globals, n_cells):
    code = marshal.loads(code_bytes)
    closure = tuple(types.CellType() for _ in range(n_cells)) or None
    if "__builtins__" not in base_globals:
        base_globals["__builtins__"] = builtins
    return types.FunctionType(code, base_globals, None, None, closure)


def _function_setstate(fn, state):
    f_globals, cells, attrs = state
    fn.__globals__.update(f_globals)
    for cell, value in zip(fn.__closure__ or (), cells):
        if value is not _EMPTY_CELL:
            cell.cell_contents = value
    for k, v in attrs.items():
        setattr(fn, k, v)


class _EmptyCell:
    def __reduce__(self):
        return (_empty_cell, ())


def _empty_cell():
    return _EMPTY_CELL


_EMPTY_CELL = _EmptyCell()


def _make_skel_class(metaclass, name, bases, type_kwargs):
    return types.new_class(name, bases, {"metaclass": metaclass},
                           lambda ns: ns.update(type_kwargs))


def _class_setstate(cls, attrs):
    for k, v in attrs.items():
        setattr(cls, k, v)


# class-dict entries the skeleton's construction recreates itself
_CLASS_SKIP = frozenset(("__dict__", "__weakref__", "__module__",
                         "__qualname__", "__slots__"))


def _mappingproxy(d: dict):
    return types.MappingProxyType(d)


def _import_module(name: str):
    __import__(name)
    return sys.modules[name]


def _dataclass_sentinel(name: str):
    return getattr(dataclasses, name)


_DATACLASS_SENTINELS = {
    id(getattr(dataclasses, n)): n
    for n in ("_FIELD", "_FIELD_CLASSVAR", "_FIELD_INITVAR", "MISSING",
              "KW_ONLY") if hasattr(dataclasses, n)}


# ------------------------------------------------------------- tensors


def _tensor_reduce(t):
    """Out-of-band reduction of a plain torch.Tensor: its bytes (on the
    host), dtype, shape and device type."""
    import torch

    if t.requires_grad and not t.is_leaf:
        raise pickle.PicklingError(
            "cannot send a non-leaf tensor that requires grad; detach() "
            "it first")
    dtype = str(t.dtype).removeprefix("torch.")
    dev = t.device.type
    flat = t.detach()
    if dev != "cpu":
        flat = flat.cpu()
    flat = flat.contiguous().reshape(-1)
    if flat.numel() == 0:
        buf = b""
    else:
        buf = pickle.PickleBuffer(flat.view(torch.uint8).numpy())
    return (_rebuild_tensor, (buf, dtype, tuple(t.shape), dev,
                              bool(t.requires_grad)))


def _rebuild_tensor(buf, dtype: str, shape, device: str, requires_grad):
    import torch

    dt = getattr(torch, dtype)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Attempting to deserialize object on a CUDA device but "
            "torch.cuda.is_available() is False")
    mv = memoryview(buf)
    if mv.nbytes == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        with warnings.catch_warnings():
            # read-only store views: torch has no read-only tensors
            warnings.simplefilter("ignore", UserWarning)
            t = torch.frombuffer(mv, dtype=torch.uint8)
        t = t.view(dt).view(shape)
    if device != "cpu":
        t = t.to(device)
    if requires_grad:
        t.requires_grad_(True)
    return t


# ------------------------------------------------------------- pickler


class Pickler(pickle.Pickler):
    """pickle.Pickler that sends functions and classes by value where
    cloudpickle would, modules by reference, and tensors out of band."""

    def __init__(self, file, protocol=5, buffer_callback=None):
        super().__init__(file, protocol=protocol,
                         buffer_callback=buffer_callback)
        # one rebuilt globals dict per original module dict: functions
        # of one module share it on the reading side, as they shared the
        # module's (kept referenced so ids are not reused mid-pickle)
        self._base_globals: dict[int, tuple[dict, dict]] = {}

    def reducer_override(self, obj):
        t = type(obj)
        if t is types.FunctionType:
            if by_reference(obj):
                return NotImplemented
            return self._function_reduce(obj)
        if isinstance(obj, type):
            if obj.__module__ == "builtins" or by_reference(obj):
                return NotImplemented
            return self._class_reduce(obj)
        if t is types.ModuleType:
            if obj.__name__ == "__main__" or \
                    sys.modules.get(obj.__name__) is not obj:
                raise pickle.PicklingError(
                    f"cannot send module {obj.__name__!r} by reference")
            return (_import_module, (obj.__name__,))
        if t is staticmethod or t is classmethod:
            return (t, (obj.__func__,))
        if t is property:
            return (property, (obj.fget, obj.fset, obj.fdel, obj.__doc__))
        if t is types.MappingProxyType:
            return (_mappingproxy, (dict(obj),))
        if t is types.CellType:
            try:
                value = obj.cell_contents
            except ValueError:
                value = _EMPTY_CELL
            return (_make_cell, (value,))
        if id(obj) in _DATACLASS_SENTINELS:
            return (_dataclass_sentinel, (_DATACLASS_SENTINELS[id(obj)],))
        if t.__module__ == "torch" and t.__name__ == "Tensor" and \
                "torch" in sys.modules and \
                t is sys.modules["torch"].Tensor:
            return _tensor_reduce(obj)
        return NotImplemented

    def _function_reduce(self, fn):
        code = fn.__code__
        g = fn.__globals__
        ent = self._base_globals.get(id(g))
        if ent is None:
            base = {k: g[k] for k in ("__name__", "__package__", "__file__")
                    if k in g and isinstance(g[k], str)}
            ent = self._base_globals[id(g)] = (base, g)
        f_globals = {k: g[k] for k in _names_of(code) if k in g}
        cells = []
        for c in fn.__closure__ or ():
            try:
                cells.append(c.cell_contents)
            except ValueError:
                cells.append(_EMPTY_CELL)
        attrs = {"__name__": fn.__name__, "__qualname__": fn.__qualname__,
                 "__module__": fn.__module__, "__doc__": fn.__doc__,
                 "__defaults__": fn.__defaults__,
                 "__kwdefaults__": fn.__kwdefaults__,
                 "__annotations__": fn.__annotations__}
        if fn.__dict__:
            attrs["__dict__"] = fn.__dict__
        type_params = getattr(fn, "__type_params__", ())
        if type_params:
            attrs["__type_params__"] = type_params
        return (_make_skel_func,
                (marshal.dumps(code), ent[0], len(cells)),
                (f_globals, cells, attrs), None, None, _function_setstate)

    def _class_reduce(self, cls):
        d = cls.__dict__
        type_kwargs = {"__module__": cls.__module__,
                       "__qualname__": cls.__qualname__}
        if "__slots__" in d:
            type_kwargs["__slots__"] = d["__slots__"]
        slots = d.get("__slots__", ())
        slots = (slots,) if isinstance(slots, str) else tuple(slots)
        attrs = {k: v for k, v in d.items()
                 if k not in _CLASS_SKIP and k not in slots
                 and k != "_abc_impl"}
        return (_make_skel_class,
                (type(cls), cls.__name__, cls.__bases__, type_kwargs),
                attrs, None, None, _class_setstate)


def _make_cell(value):
    cell = types.CellType()
    if value is not _EMPTY_CELL:
        cell.cell_contents = value
    return cell


def _dumps_by_value(obj, buffer_callback=None) -> bytes:
    f = io.BytesIO()
    Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def dumps_fn(obj) -> bytes:
    """One self-contained pickle of a function or class (by value where
    cloudpickle would send it by value): what the runtime exports to the
    head's KV for workers to load with `loads_fn`."""
    return _dumps_by_value(obj)


def loads_fn(blob: bytes):
    return pickle.loads(blob)


# ------------------------------------------------------------- blobs


def serialize(obj: Any) -> tuple[bytes, list[memoryview], int]:
    """Returns (header+pickle bytes, out-of-band buffers, total_size)."""
    buffers: list[pickle.PickleBuffer] = []
    if _fast_picklable(obj):
        payload = pickle.dumps(obj, protocol=5,
                               buffer_callback=buffers.append)
    else:
        payload = _dumps_by_value(obj, buffer_callback=buffers.append)
    views = [b.raw() for b in buffers]
    STATS["serialize_calls"] += 1
    STATS["pickle_bytes"] += len(payload)
    STATS["buffer_bytes"] += sum(v.nbytes for v in views)
    head = struct.pack("<II", _MAGIC, len(views))
    head += struct.pack("<Q", len(payload))
    for v in views:
        head += struct.pack("<Q", v.nbytes)
    total = _pad(len(head) + len(payload))
    for v in views:
        total = _pad(total + v.nbytes)
    return head + payload, views, total


def write_into(buf: memoryview, head_payload: bytes, views: list[memoryview]):
    off = len(head_payload)
    buf[:off] = head_payload
    off = _pad(off)
    for v in views:
        flat = v.cast("B") if v.ndim == 1 else memoryview(bytes(v))
        buf[off:off + flat.nbytes] = flat
        off = _pad(off + flat.nbytes)


def dumps(obj: Any) -> bytes:
    head_payload, views, total = serialize(obj)
    out = bytearray(total)
    write_into(memoryview(out), head_payload, views)
    return bytes(out)


class _HeldBuffer:
    """An out-of-band buffer that keeps `hold` alive while anything
    aliases it: an array or tensor rebuilt from it references this
    object, so the hold dies with the last value reading the bytes."""

    __slots__ = ("_view", "_hold")

    def __init__(self, view: memoryview, hold):
        self._view = view
        self._hold = hold

    def __buffer__(self, flags):
        return self._view.__buffer__(flags)

    def __release_buffer__(self, view):
        view.release()


def deserialize_info(buf: memoryview, hold=None) -> tuple[Any, int]:
    """Like deserialize, also returning the number of out-of-band
    buffers the object graph references (0 ⇒ nothing aliases `buf`).
    With `hold`, every such buffer keeps `hold` referenced until the
    last array or tensor aliasing it is collected."""
    return _deserialize(buf, hold)


def deserialize(buf: memoryview) -> Any:
    return _deserialize(buf)[0]


def _deserialize(buf: memoryview, hold=None) -> tuple[Any, int]:
    buf = buf.cast("B") if isinstance(buf, memoryview) else memoryview(buf)
    magic, nbuf = struct.unpack_from("<II", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not a ray_tpu serialized object")
    off = 8
    (plen,) = struct.unpack_from("<Q", buf, off)
    off += 8
    blens = []
    for _ in range(nbuf):
        (bl,) = struct.unpack_from("<Q", buf, off)
        off += 8
        blens.append(bl)
    pickle_bytes = bytes(buf[off:off + plen])
    off = _pad(off + plen)
    oob = []
    for bl in blens:
        # READ-ONLY views: zero-copy arrays alias the shared-memory
        # store — a consumer mutating one in place would silently
        # corrupt the stored object for every other reader (reference:
        # Ray marks zero-copy numpy arrays immutable for this reason).
        # numpy in-place writes raise; a torch CPU tensor cannot be
        # read-only, so it aliases the store writably.
        view = buf[off:off + bl].toreadonly()
        oob.append(view if hold is None else _HeldBuffer(view, hold))
        off = _pad(off + bl)
    STATS["deserialize_calls"] += 1
    STATS["pickle_bytes"] += plen
    STATS["buffer_bytes"] += sum(blens)
    return pickle.loads(pickle_bytes, buffers=oob), len(oob)


def loads(data: bytes | memoryview) -> Any:
    return deserialize(memoryview(data))


def dumps_msg(obj: Any) -> bytes:
    """Serialize a small control-plane message (no out-of-band path).
    Plain (C-accelerated) pickle when the payload is provably made of
    builtin/numpy values — several times faster than the by-value
    pickler on the hot path. Anything that might reference user modules
    (e.g. task args holding a driver-__main__ class, which plain pickle
    would serialize by an unresolvable reference) goes through
    `Pickler`. Sender-side try/except is NOT enough: pickling __main__
    classes by reference succeeds here and fails only at the receiver."""
    if _fast_picklable(obj, depth=8):
        return pickle.dumps(obj, protocol=5)
    return _dumps_by_value(obj)


def loads_msg(data: bytes) -> Any:
    return pickle.loads(data)
