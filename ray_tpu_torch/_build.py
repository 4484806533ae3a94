"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/lib<name>-<digest>.so`` at the root of the checkout, where the
digest covers the source, the shared headers and the flags, so an edit
rebuilds and an unchanged tree reuses the library. The sources export
plain C entry points: pointers and the stream go in as ``c_void_p``,
and each entry point returns ``cudaGetLastError()`` after its launch.
Nothing is built when a module is imported; a wrapper builds and loads
its library at its first launch, and `build_all` starts every nvcc at
once (chip_smoke.py calls it first, so that the builds run in parallel).

The host libraries, ``csrc/<name>.cc`` (the data layer's line scanner,
``lineio.cc``), compile with the host C++ compiler through `build_host`
into the same directory under the same digest scheme.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
# the libraries the package launches; csrc/ also holds hopper_check.cu,
# the Hopper building blocks alone, which chip_smoke.py builds by name
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # guarded_by(_lock)


class LaunchCounter:
    """Launches of one kernel in this process. Its wrapper adds one
    where it launches the kernel, and nowhere else, so a run can show
    that its main path went through the kernel; `by_shape` tallies the
    same launches by the shape label the wrapper passes, if any. Adds
    from several threads (trials of a sweep training at once, autograd's
    backward thread) are counted under a lock."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0  # guarded_by(_lock)
        self.by_shape: dict[str, int] = {}  # guarded_by(_lock)

    def add(self, shape: str | None = None) -> None:
        with self._lock:
            self.count += 1
            if shape is not None:
                self.by_shape[shape] = self.by_shape.get(shape, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_shape = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lands for this source."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names=KERNELS) -> dict[str, dict]:
    """Compile every library in `names` that is not built yet, one nvcc
    per source, all started together. Returns, per name, the build
    seconds (0.0 when the library was already there) and what nvcc
    printed (ptxas lists registers, shared memory and spills). Raises
    if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: dict[str, dict] = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            out[name] = {"seconds": 0.0, "log": "", "path": target}
            continue
        # unique per process and thread: concurrent builds of one
        # source each write their own file and replace atomically
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log,
                     "path": target}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


HOST_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def host_cxx() -> str | None:
    """The host C++ compiler: $CXX, c++ or g++ on PATH; None if none."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = c and shutil.which(c)
        if path:
            return path
    return None


def host_library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cc`` lands for this source."""
    h = hashlib.sha1(" ".join(HOST_CXX_FLAGS).encode())
    with open(os.path.join(CSRC, f"{name}.cc"), "rb") as f:
        h.update(f"{name}.cc".encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_host(name: str) -> str | None:
    """Compile ``csrc/<name>.cc`` with the host C++ compiler unless it is
    built already; returns the library's path, or None where there is
    no compiler or the build fails (the caller then takes its
    pure-Python path)."""
    target = host_library_path(name)
    if os.path.exists(target):
        return target
    cxx = host_cxx()
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", tmp,
                        os.path.join(CSRC, f"{name}.cc")],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, target)
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all((name,))[name]["path"])
        with _lock:
            lib = _libs.setdefault(name, lib)
    return lib


def check(err: int, what: str, error_string) -> None:
    """Raise if a kernel entry point reported a CUDA error;
    `error_string` is the library's ``int -> const char*`` describer."""
    if err != 0:
        msg = error_string(err)
        raise RuntimeError(
            f"{what}: CUDA error {err} at launch"
            f" ({msg.decode() if msg else 'unknown'})")


def bind(fn, argtypes, restype=ctypes.c_int):
    """Declare a C entry point's signature once, and return it."""
    if fn.argtypes is None:
        fn.restype = restype
        fn.argtypes = argtypes
    return fn
