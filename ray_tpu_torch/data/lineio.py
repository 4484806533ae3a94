"""Native-accelerated line reading for the Data sources: the port's copy
of ``ray_tpu/data/lineio.py``.

Reference parity: the datasource hot loops run in native code in the
reference (Arrow C++ readers behind ray.data.read_text/read_json);
here ``csrc/lineio.cc``'s memchr sweep builds the line-offset index
over the file bytes in one C pass. `_build.build_host` compiles it with
the host C++ compiler into ``build/`` at the first read, never at
import. The file itself is read through normal Python I/O so
open/permission errors surface exactly like the pure-Python fallback
and a concurrently-truncated file can never SIGBUS the worker (no mmap
is exposed to Python). Falls back to pure-Python splitting when no
toolchain exists; `native()` says which path reads the lines.
"""

from __future__ import annotations

import ctypes
import threading

_lib = None
_lock = threading.Lock()


def _lineio_lib():
    global _lib
    with _lock:
        if _lib is None:
            from ray_tpu_torch import _build

            path = _build.build_host("lineio")
            if path is None:
                _lib = False
            else:
                lib = ctypes.CDLL(path)
                u64 = ctypes.c_uint64
                u64p = ctypes.POINTER(u64)
                lib.lio_index.argtypes = [ctypes.c_char_p, u64, u64p, u64]
                lib.lio_index.restype = u64
                _lib = lib
    return _lib or None


def native() -> bool:
    """True when `read_lines` splits with the native scanner (built on
    first call), False when it takes the pure-Python path."""
    return _lineio_lib() is not None


def read_lines(path: str, strip_newline: bool = True) -> list[str]:
    """All lines of a file. LF and CRLF endings are handled; lone-CR
    (classic Mac) files are not split by the native path."""
    lib = _lineio_lib()
    if lib is None:
        with open(path) as f:
            if strip_newline:
                return [ln.rstrip("\n") for ln in f]
            return list(f)
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        return []
    n = lib.lio_index(data, len(data), None, 0)
    offs = (ctypes.c_uint64 * n)()
    lib.lio_index(data, len(data), offs, n)
    out = []
    size = len(data)
    for i in range(n):
        start = offs[i]
        if i + 1 < n:
            end = offs[i + 1] - 1  # the newline position
            had_newline = True
        else:
            end = size  # final line runs to EOF...
            had_newline = data.endswith(b"\n")
            if had_newline:
                end -= 1  # ...unless the file is newline-terminated
        raw = data[start:end]
        if raw.endswith(b"\r"):
            raw = raw[:-1]  # CRLF files: match text-mode translation
        # strict decode: bad encodings must RAISE at the read site like
        # the text-mode fallback, not flow downstream mangled
        line = raw.decode()
        if not strip_newline and had_newline:
            line += "\n"
        out.append(line)
    return out
