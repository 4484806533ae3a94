"""Runtime environments for tasks/actors — plugin architecture.

Reference parity: python/ray/_private/runtime_env/plugin.py:1 (the
RuntimeEnvPlugin ABC with validate/create/modify-context lifecycle and
priority ordering), working_dir.py (zipped dirs shipped via GCS,
content-addressed, extracted per node), py_modules.py:1 (extra
importable modules distributed the same way and prepended to the
worker's import path), and the env_vars plugin.

Redesign: one registry of `RuntimeEnvPlugin`s keyed by their
runtime_env field. The driver runs `validate` + `upload` (makes the
value shippable: blobs go to the head KV once, content-addressed); the
node runs `materialize`, which mutates a `RuntimeEnvContext` (process
env, import paths, cwd) the nodelet applies when spawning the worker.
pip/uv/conda keep their reference names but are gated with a clear
error — this image forbids installs — so the seam exists for them to
land in later (reference: uv.py, pip.py).

The port's copy of ``ray_tpu/core/runtime_env.py``. Its pip/uv venvs
live under their own cache base, ``$TMPDIR/ray_tpu_torch/env_cache``
(``RAY_TPU_ENV_CACHE`` overrides it), so a venv the JAX package built
for the same package set never serves the port's workers.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import zipfile
from dataclasses import dataclass, field

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
_MAX_WORKING_DIR_BYTES = 256 * 1024 * 1024


def _zip_dir(path: str, prefix: str = "") -> bytes:
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _SKIP_DIRS]
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.join(prefix, os.path.relpath(full, path))
                total += os.path.getsize(full)
                if total > _MAX_WORKING_DIR_BYTES:
                    raise ValueError(
                        f"directory {path} exceeds "
                        f"{_MAX_WORKING_DIR_BYTES} bytes")
                z.write(full, rel)
    return buf.getvalue()


def dir_fingerprint(path: str) -> str:
    """Cheap content identity for cache keys: (relpath, mtime_ns, size)
    of every file. Changes when the directory content changes without
    paying for a re-zip."""
    h = hashlib.sha1()
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
        for f in sorted(files):
            full = os.path.join(root, f)
            try:
                st = os.stat(full)
            except OSError:
                continue
            h.update(os.path.relpath(full, path).encode())
            h.update(f"{st.st_mtime_ns}:{st.st_size}".encode())
    return h.hexdigest()


def _upload_blob(blob: bytes, client, head_address: str) -> str:
    key = hashlib.sha1(blob).hexdigest()
    client.call(head_address, "kv_put",
                {"ns": "rtenv", "key": key, "overwrite": False},
                frames=[blob], timeout=60, retries=2)
    return key


def _fetch_extract(key: str, session_dir: str, client,
                   head_address: str) -> str:
    """Content-addressed, idempotent extraction of a KV blob; safe under
    concurrent materialization by multiple workers on one node."""
    dest = os.path.join(session_dir, "runtime_envs", key)
    done = os.path.join(dest, ".ready")
    if not os.path.exists(done):
        value, frames = client.call_frames(
            head_address, "kv_get", {"ns": "rtenv", "key": key},
            timeout=60, retries=2)
        if not value.get("found"):
            raise RuntimeError(f"runtime_env blob {key} not in head KV")
        tmp = dest + f".tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(frames[0])) as z:
            z.extractall(tmp)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        try:
            os.rename(tmp, dest)
        except OSError:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)  # concurrent winner
        with open(done, "w") as f:
            f.write("ok")
    return dest


# ---------------------------------------------------------------- context


@dataclass
class RuntimeEnvContext:
    """What materialized plugins contribute to the worker process
    (reference: runtime_env/context.py RuntimeEnvContext)."""

    env: dict[str, str] = field(default_factory=dict)
    py_paths: list[str] = field(default_factory=list)  # PYTHONPATH prepends
    cwd: str | None = None
    # interpreter override: set by the pip/uv plugins so the worker runs
    # INSIDE the materialized virtualenv (reference: the pip plugin's
    # modified python context, runtime_env/pip.py)
    py_exe: str | None = None


# ---------------------------------------------------------------- plugins


class RuntimeEnvPlugin:
    """One runtime_env field's lifecycle (reference: plugin.py:1).

    validate  — driver side; raise on malformed input, return the
                canonical value.
    upload    — driver side; replace local paths with content-addressed
                KV keys so the value is shippable.
    materialize — node side; fetch/extract and mutate the context.
    Lower `priority` materializes earlier (reference: plugin priority
    ordering), so later plugins can see earlier ones' contributions.
    """

    name: str = ""
    priority: int = 10

    def validate(self, value):
        return value

    def upload(self, value, client, head_address: str):
        return value

    def materialize(self, value, ctx: RuntimeEnvContext, session_dir: str,
                    client, head_address: str) -> None:
        pass


class EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"
    priority = 0

    def validate(self, value):
        if not isinstance(value, dict):
            raise ValueError("env_vars must be a dict of str -> str")
        return {str(k): str(v) for k, v in value.items()}

    def materialize(self, value, ctx, session_dir, client, head_address):
        ctx.env.update(value or {})


class WorkingDirPlugin(RuntimeEnvPlugin):
    name = "working_dir"
    priority = 5

    def validate(self, value):
        if not isinstance(value, str) or not os.path.isdir(value):
            raise ValueError(f"working_dir {value!r} is not a directory")
        return value

    def upload(self, value, client, head_address):
        return {"key": _upload_blob(_zip_dir(value), client, head_address)}

    def materialize(self, value, ctx, session_dir, client, head_address):
        dest = _fetch_extract(value["key"], session_dir, client,
                              head_address)
        ctx.cwd = dest
        ctx.py_paths.append(dest)


class PyModulesPlugin(RuntimeEnvPlugin):
    """Extra importable modules (reference: py_modules.py:1). Each entry
    is a local package directory; it is zipped UNDER its basename so the
    extraction root goes on the import path and `import <basename>`
    works on every worker."""

    name = "py_modules"
    priority = 7

    def validate(self, value):
        if isinstance(value, str):
            value = [value]
        if not isinstance(value, (list, tuple)):
            raise ValueError("py_modules must be a list of directories")
        for p in value:
            if not isinstance(p, str) or not os.path.isdir(p):
                raise ValueError(f"py_modules entry {p!r} is not a directory")
        return list(value)

    def upload(self, value, client, head_address):
        out = []
        for p in value:
            base = os.path.basename(os.path.normpath(p))
            blob = _zip_dir(p, prefix=base)
            out.append({"key": _upload_blob(blob, client, head_address),
                        "module": base})
        return out

    def materialize(self, value, ctx, session_dir, client, head_address):
        for ent in value:
            dest = _fetch_extract(ent["key"], session_dir, client,
                                  head_address)
            ctx.py_paths.append(dest)


class PipPlugin(RuntimeEnvPlugin):
    """Per-env virtualenvs with pip-installed packages (reference:
    runtime_env/pip.py — a venv per distinct package set, cached and
    shared across workers; _private/runtime_env/uv.py is the same
    lifecycle through uv).

    Offline-first: this deployment has zero egress, so installs resolve
    from a LOCAL wheel source — `{"packages": [...], "find_links": dir}`
    (the dir's wheels are shipped through the head KV, content-
    addressed, so remote nodes materialize without a shared FS). An
    `index_url` passthrough exists for deployments with a reachable
    index. Envs are content-addressed by (packages, python version) in
    a node-wide cache, built once under a file lock, reused by every
    worker/session; the worker process runs ON the venv interpreter
    (--system-site-packages keeps torch/ray_tpu_torch importable)."""

    name = "pip"
    priority = 8  # venv resolves after working_dir/py_modules: shipped
    # user code takes import precedence over installed packages

    #: subclasses flip this to use the uv resolver/installer
    use_uv = False

    def validate(self, value):
        if isinstance(value, str):
            value = [value]
        if isinstance(value, (list, tuple)):
            value = {"packages": list(value)}
        if not isinstance(value, dict) or not value.get("packages"):
            raise ValueError(
                f"{self.name} needs a package list or "
                f"{{'packages': [...], 'find_links': dir}}")
        pkgs = [str(p) for p in value["packages"]]
        out = {"packages": sorted(pkgs)}
        fl = value.get("find_links")
        if fl is not None:
            if not os.path.isdir(fl):
                raise ValueError(f"find_links {fl!r} is not a directory")
            out["find_links"] = os.path.abspath(fl)
        if value.get("index_url"):
            out["index_url"] = str(value["index_url"])
        if "find_links" not in out and "index_url" not in out:
            from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError

            raise RuntimeEnvSetupError(
                f"runtime_env[{self.name!r}]: this deployment has no "
                f"package index (zero egress); provide a local wheel "
                f"source via {{'packages': [...], 'find_links': dir}}")
        return out

    def upload(self, value, client, head_address):
        out = dict(value)
        fl = out.pop("find_links", None)
        if fl is not None:
            # ship the wheel dir once, content-addressed
            out["wheels_key"] = _upload_blob(_zip_dir(fl), client,
                                             head_address)
        return out

    def _env_dir(self, value) -> str:
        import sys

        h = hashlib.sha1(json.dumps(
            [value["packages"], sys.version_info[:2], self.use_uv],
            default=str).encode()).hexdigest()[:20]
        base = os.environ.get("RAY_TPU_ENV_CACHE") or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", "env_cache")
        return os.path.join(base, self.name, h)

    def materialize(self, value, ctx, session_dir, client, head_address):
        import fcntl
        import subprocess
        import sys

        from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError

        dest = self._env_dir(value)
        ready = os.path.join(dest, ".ready")
        py = os.path.join(dest, "bin", "python")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if not os.path.exists(ready):
                    wheels = None
                    if value.get("wheels_key"):
                        wheels = _fetch_extract(value["wheels_key"],
                                                session_dir, client,
                                                head_address)
                    self._build_env(dest, py, value, wheels)
                    with open(ready, "w") as f:
                        f.write("ok")
            except RuntimeEnvSetupError:
                raise
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeEnvSetupError(
                    f"{self.name} env build failed: {e}") from e
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        ctx.py_exe = py
        ctx.env["VIRTUAL_ENV"] = dest
        ctx.env["PATH"] = (os.path.join(dest, "bin") + os.pathsep +
                           os.environ.get("PATH", ""))
        # site-packages on PYTHONPATH too: nested task submissions from
        # this worker inherit visibility even without the interpreter
        sp = os.path.join(dest, "lib",
                          f"python{sys.version_info[0]}."
                          f"{sys.version_info[1]}", "site-packages")
        if os.path.isdir(sp):
            ctx.py_paths.append(sp)

    def _build_env(self, dest: str, py: str, value, wheels: str | None):
        import shutil
        import subprocess
        import sys

        from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError

        if os.path.isdir(dest):
            shutil.rmtree(dest, ignore_errors=True)  # partial build
        uv = shutil.which("uv") if self.use_uv else None
        if self.use_uv and uv is None:
            # uv lifecycle requested but binary absent: same semantics
            # through pip (documented fallback)
            pass
        if uv:
            run = [uv, "venv", "--system-site-packages", "--python",
                   sys.executable, dest]
        else:
            run = [sys.executable, "-m", "venv",
                   "--system-site-packages", dest]
        subprocess.run(run, check=True, capture_output=True, timeout=300)
        # Inherit THIS interpreter's site dirs, not just the base
        # python's: venv-from-a-venv sees only the base prefix under
        # --system-site-packages, which would hide every package of the
        # parent env (torch, numpy, the package's .pth). addsitedir also
        # re-processes the parent dirs' .pth files, and appends AFTER
        # the venv's own site-packages so installed packages keep
        # precedence.
        import site as _site

        sp = os.path.join(
            dest, "lib", f"python{sys.version_info[0]}."
            f"{sys.version_info[1]}", "site-packages")
        parents = [p for p in _site.getsitepackages() if os.path.isdir(p)]
        with open(os.path.join(sp, "_ray_tpu_parent_site.pth"), "w") as f:
            for p in parents:
                f.write(f"import site; site.addsitedir({p!r})\n")
        if uv:
            cmd = [uv, "pip", "install", "--python", py, "--offline"]
        else:
            cmd = [py, "-m", "pip", "install", "--no-input",
                   "--disable-pip-version-check"]
        if value.get("index_url"):
            cmd += ["--index-url", value["index_url"]]
            if uv:
                cmd.remove("--offline")
        else:
            if not uv:
                cmd += ["--no-index"]
        if wheels:
            cmd += ["--find-links", wheels]
        elif not value.get("index_url"):
            raise RuntimeEnvSetupError(
                f"runtime_env[{self.name!r}]: this deployment has no "
                f"package index (zero egress); provide a local wheel "
                f"source via {{'packages': [...], 'find_links': dir}}")
        cmd += value["packages"]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise RuntimeEnvSetupError(
                f"{self.name} install failed:\n{r.stdout}\n{r.stderr}")


class UvPlugin(PipPlugin):
    """uv-flavored env plugin (reference: _private/runtime_env/uv.py) —
    same venv lifecycle, resolved/installed by `uv` when present (falls
    back to pip with identical semantics if the binary is absent)."""

    name = "uv"
    priority = 8
    use_uv = True


class _GatedPlugin(RuntimeEnvPlugin):
    """Reference plugins whose materialization is impossible in this
    deployment (no container runtime); the field names are reserved so
    the error is actionable rather than 'unknown key' (reference:
    conda.py, container plugin)."""

    def __init__(self, name: str, why: str):
        self.name = name
        self.why = why

    def validate(self, value):
        from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError

        raise RuntimeEnvSetupError(
            f"runtime_env[{self.name!r}] is unavailable: {self.why}")


_REGISTRY: dict[str, RuntimeEnvPlugin] = {}
_env_plugins_loaded = False


def register_plugin(plugin: RuntimeEnvPlugin):
    """Add or replace a plugin IN THIS PROCESS. For a plugin that must
    materialize on every node, also set RAY_TPU_RUNTIME_ENV_PLUGINS to
    "module:Class[,module:Class...]" — worker/nodelet processes import
    and register those lazily (reference: the RAY_RUNTIME_ENV_PLUGINS
    env-var registration, runtime_env/plugin.py)."""
    if not plugin.name:
        raise ValueError("plugin needs a non-empty name")
    _REGISTRY[plugin.name] = plugin


def _load_env_plugins():
    """Register plugins named in RAY_TPU_RUNTIME_ENV_PLUGINS (once)."""
    global _env_plugins_loaded
    if _env_plugins_loaded:
        return
    _env_plugins_loaded = True
    spec = os.environ.get("RAY_TPU_RUNTIME_ENV_PLUGINS", "")
    for ent in spec.split(","):
        ent = ent.strip()
        if not ent or ":" not in ent:
            continue
        mod_name, cls_name = ent.rsplit(":", 1)
        try:
            import importlib

            cls = getattr(importlib.import_module(mod_name), cls_name)
            register_plugin(cls())
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"RAY_TPU_RUNTIME_ENV_PLUGINS entry {ent!r} failed to "
                f"load: {e!r}") from e


def _plugin(name: str) -> RuntimeEnvPlugin:
    _load_env_plugins()
    p = _REGISTRY.get(name)
    if p is None:
        raise ValueError(
            f"runtime_env plugin {name!r} is not registered in this "
            f"process; distribute custom plugins to nodes via "
            f"RAY_TPU_RUNTIME_ENV_PLUGINS='module:Class'")
    return p


def registered_plugins() -> dict[str, RuntimeEnvPlugin]:
    _load_env_plugins()
    return dict(_REGISTRY)


for _p in (EnvVarsPlugin(), WorkingDirPlugin(), PyModulesPlugin(),
           PipPlugin(), UvPlugin(),
           _GatedPlugin("conda", "conda is not installed on this image; "
                        "use pip/uv with a local wheel source"),
           _GatedPlugin("container", "no container runtime is available "
                        "on this image")):
    register_plugin(_p)


# ---------------------------------------------------------------- API
# (signatures kept stable: nodelet/cluster_runtime call these)


def normalize(runtime_env: dict | None, client, head_address: str
              ) -> dict | None:
    """Driver side: validate every field through its plugin and upload
    blobs once (content-addressed); returns the shippable dict."""
    if not runtime_env:
        return None
    _load_env_plugins()
    unknown = set(runtime_env) - set(_REGISTRY)
    if unknown:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unknown)}; supported: "
            f"{sorted(_REGISTRY)}")
    out: dict = {}
    for name, value in runtime_env.items():
        plugin = _plugin(name)
        value = plugin.validate(value)
        if value:
            out[name] = plugin.upload(value, client, head_address)
    return out or None


def env_hash(norm: dict | None) -> str:
    if not norm:
        return ""
    return hashlib.sha1(
        json.dumps(norm, sort_keys=True).encode()).hexdigest()[:16]


def materialize(norm: dict | None, session_dir: str, client,
                head_address: str) -> tuple[dict, str | None, str | None]:
    """Node side: run every plugin in priority order against a fresh
    context; returns (extra process env, cwd or None, python exe or
    None) for the worker spawn (reference: the per-node runtime-env
    agent materializes before WorkerPool starts the worker)."""
    if not norm:
        return {}, None, None
    ctx = RuntimeEnvContext()
    for name in sorted(norm, key=lambda n: _plugin(n).priority):
        _plugin(name).materialize(norm[name], ctx, session_dir, client,
                                  head_address)
    extra = dict(ctx.env)
    if ctx.py_paths:
        prev = extra.get("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
        joined = os.pathsep.join(ctx.py_paths)
        extra["PYTHONPATH"] = joined + (os.pathsep + prev if prev else "")
    return extra, ctx.cwd, ctx.py_exe
