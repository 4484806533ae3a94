"""Runtime environments on the port's cluster runtime
(ray_tpu_torch.core.runtime_env), through the JAX package's scenarios
with their own inputs and assertions: tests/test_runtime_env.py (11,
env_vars, working_dir, py_modules, the pip and uv venvs built offline
from a local wheel, the plugin registry), and the module's pure
functions held against the JAX package's on the same inputs.

One module-scoped cluster of one 4-CPU node, as the JAX fixture has.
Functions and actor classes are defined inside the tests, so they
travel by value. Every get carries a timeout.
"""

import os
import zipfile

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import runtime_env as rtenv


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()


def test_env_vars_applied(cluster):
    @ray.remote(num_cpus=0.1,
                runtime_env={"env_vars": {"MY_FLAG": "hello42"}})
    def read_env():
        return os.environ.get("MY_FLAG")

    assert ray.get(read_env.remote(), timeout=60) == "hello42"

    @ray.remote(num_cpus=0.1)
    def read_plain():
        return os.environ.get("MY_FLAG")

    # a worker WITHOUT the env must not see the variable (no pool mixing)
    assert ray.get(read_plain.remote(), timeout=60) is None


def test_working_dir_shipped(cluster, tmp_path):
    pkg = tmp_path / "mypkg"
    pkg.mkdir()
    (pkg / "mymodule.py").write_text("MAGIC = 'from-working-dir'\n")
    (pkg / "data.txt").write_text("payload")

    @ray.remote(num_cpus=0.1, runtime_env={"working_dir": str(pkg)})
    def use_module():
        import mymodule  # importable from the materialized working_dir

        with open("data.txt") as f:  # cwd is the working_dir
            return mymodule.MAGIC, f.read()

    magic, payload = ray.get(use_module.remote(), timeout=60)
    assert magic == "from-working-dir"
    assert payload == "payload"


def test_actor_runtime_env(cluster):
    @ray.remote(runtime_env={"env_vars": {"ACTOR_ENV": "yes"}})
    class EnvActor:
        def read(self):
            return os.environ.get("ACTOR_ENV")

    a = EnvActor.remote()
    assert ray.get(a.read.remote(), timeout=60) == "yes"


def _make_demo_wheel(directory, name: str, version: str, body: str) -> str:
    """Hand-craft a minimal pure-python wheel (a .whl is a zip with
    dist-info metadata) — no network, no build backend needed."""
    dist = f"{name}-{version}.dist-info"
    whl = os.path.join(str(directory), f"{name}-{version}-py3-none-any.whl")
    files = {
        f"{name}/__init__.py": body,
        f"{dist}/METADATA": (f"Metadata-Version: 2.1\nName: {name}\n"
                             f"Version: {version}\n"),
        f"{dist}/WHEEL": ("Wheel-Version: 1.0\nGenerator: test\n"
                          "Root-Is-Purelib: true\nTag: py3-none-any\n"),
    }
    record = "".join(f"{p},,\n" for p in files) + f"{dist}/RECORD,,\n"
    files[f"{dist}/RECORD"] = record
    with zipfile.ZipFile(whl, "w") as z:
        for p, content in files.items():
            z.writestr(p, content)
    return whl


def test_pip_env_e2e(cluster, tmp_path):
    """Real pip materialization (reference: runtime_env/pip.py): a task
    runs in a venv holding a package the driver process does NOT have,
    resolved offline from a local wheel source; a second worker (an
    actor) shares the cached env. The venv's interpreter imports torch
    and the port from the parent environment."""
    wheel_dir = tmp_path / "wheels"
    wheel_dir.mkdir()
    _make_demo_wheel(wheel_dir, "rtenv_demo_pkg", "0.1",
                     "VALUE = 42\n")
    with pytest.raises(ImportError):
        import rtenv_demo_pkg  # noqa: F401  (driver must not have it)

    env = {"pip": {"packages": ["rtenv_demo_pkg"],
                   "find_links": str(wheel_dir)}}

    @ray.remote(num_cpus=0.1, runtime_env=env)
    def use_pkg():
        import sys

        import rtenv_demo_pkg
        import torch

        return (rtenv_demo_pkg.VALUE, sys.prefix, os.getpid(),
                int(torch.ones(3).sum()))

    val, prefix, pid1, three = ray.get(use_pkg.remote(), timeout=120)
    assert val == 42
    assert "env_cache" in prefix  # interpreter IS the venv python
    assert os.path.join("ray_tpu_torch", "env_cache") in prefix
    assert three == 3

    @ray.remote(num_cpus=0.1, runtime_env=env)
    class PkgActor:
        def read(self):
            import rtenv_demo_pkg

            return rtenv_demo_pkg.VALUE, os.getpid()

    a = PkgActor.remote()
    val2, pid2 = ray.get(a.read.remote(), timeout=120)
    assert val2 == 42
    assert pid2 != pid1  # second worker process, same cached env
    ray.kill(a)


def test_uv_env_e2e(cluster, tmp_path):
    """The uv flavor of the env plugin (reference: runtime_env/uv.py)
    builds through the uv binary when present (through pip, with the
    same semantics, when it is absent)."""
    wheel_dir = tmp_path / "wheels"
    wheel_dir.mkdir()
    _make_demo_wheel(wheel_dir, "rtenv_uv_pkg", "0.2", "WHO = 'uv'\n")

    @ray.remote(num_cpus=0.1, runtime_env={
        "uv": {"packages": ["rtenv_uv_pkg"],
               "find_links": str(wheel_dir)}})
    def use_pkg():
        import rtenv_uv_pkg

        return rtenv_uv_pkg.WHO

    assert ray.get(use_pkg.remote(), timeout=120) == "uv"


def test_pip_without_wheel_source_actionable_error(cluster):
    """Zero-egress deployments need a local wheel source; the error
    says exactly that instead of a network failure."""
    with pytest.raises(Exception) as ei:
        @ray.remote(num_cpus=0.1, runtime_env={"pip": ["requests"]})
        def f():
            return 1

        ray.get(f.remote(), timeout=60)
    assert "find_links" in str(ei.value)


def test_unknown_keys_rejected(cluster):
    with pytest.raises(Exception) as ei:
        @ray.remote(num_cpus=0.1, runtime_env={"bogus_plugin": 1})
        def f():
            return 1

        ray.get(f.remote(), timeout=30)
    assert "unsupported" in str(ei.value)


# ---------------------------------------------------------------------------
# plugin layer: py_modules + custom plugin ordering
# ---------------------------------------------------------------------------

def test_py_modules_cross_worker_import(cluster, tmp_path):
    """A local package listed in py_modules is importable on every
    worker WITHOUT being the cwd (reference: py_modules.py:1)."""
    pkg = tmp_path / "shiplib"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("VERSION = 'shipped-1.2'\n")
    (pkg / "helper.py").write_text("def double(x):\n    return 2 * x\n")

    @ray.remote(num_cpus=0.1, runtime_env={"py_modules": [str(pkg)]})
    def use_pkg():
        import shiplib
        from shiplib.helper import double

        return shiplib.VERSION, double(21), os.getcwd()

    version, val, cwd = ray.get(use_pkg.remote(), timeout=60)
    assert version == "shipped-1.2"
    assert val == 42
    assert "shiplib" not in cwd  # import path, not working dir


def test_py_modules_with_working_dir(cluster, tmp_path):
    """py_modules and working_dir compose: cwd comes from working_dir,
    imports resolve from both."""
    lib = tmp_path / "extralib"
    lib.mkdir()
    (lib / "__init__.py").write_text("NAME = 'extra'\n")
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "local.py").write_text("WHERE = 'cwd'\n")

    @ray.remote(num_cpus=0.1,
                runtime_env={"working_dir": str(wd),
                             "py_modules": [str(lib)]})
    def both():
        import extralib
        import local

        return extralib.NAME, local.WHERE

    assert ray.get(both.remote(), timeout=60) == ("extra", "cwd")


def test_plugin_ordering_and_custom_plugin(tmp_path):
    """Plugins materialize in priority order against one shared context
    (reference: plugin.py priority ordering)."""
    calls = []

    class FirstPlugin(rtenv.RuntimeEnvPlugin):
        name = "test_first"
        priority = 1

        def validate(self, value):
            return value

        def materialize(self, value, ctx, session_dir, client, head):
            calls.append("first")
            ctx.env["ORDER"] = "first"

    class LastPlugin(rtenv.RuntimeEnvPlugin):
        name = "test_last"
        priority = 99

        def materialize(self, value, ctx, session_dir, client, head):
            calls.append("last")
            # later plugins see earlier contributions in the context
            ctx.env["ORDER"] = ctx.env["ORDER"] + "+last"

    rtenv.register_plugin(FirstPlugin())
    rtenv.register_plugin(LastPlugin())
    try:
        norm = rtenv.normalize({"test_last": True, "test_first": True},
                               client=None, head_address="")
        extra, cwd, _py = rtenv.materialize(norm, str(tmp_path), None, "")
        assert calls == ["first", "last"]
        assert extra["ORDER"] == "first+last"
        assert cwd is None
    finally:
        rtenv.registered_plugins()  # leave registry clean for other tests
        rtenv._REGISTRY.pop("test_first", None)
        rtenv._REGISTRY.pop("test_last", None)


def test_plugin_validate_rejects_bad_values():
    with pytest.raises(ValueError):
        rtenv.normalize({"py_modules": ["/definitely/missing/dir"]},
                        client=None, head_address="")
    with pytest.raises(ValueError):
        rtenv.normalize({"env_vars": "notadict"}, client=None,
                        head_address="")


# ------------------------------------------------- against the JAX package


def test_pure_functions_match_jax(tmp_path, monkeypatch):
    """The registry, the env hash, the directory fingerprint, the
    validated pip value and the materialized context of the same inputs
    equal the JAX package's; only the venv cache base differs."""
    from ray_tpu.core import runtime_env as jrtenv

    assert sorted(rtenv.registered_plugins()) == \
        sorted(jrtenv.registered_plugins())
    for name, p in rtenv.registered_plugins().items():
        assert p.priority == jrtenv.registered_plugins()[name].priority
    d = tmp_path / "wd"
    d.mkdir()
    (d / "a.py").write_text("A = 1\n")
    (d / "__pycache__").mkdir()
    (d / "__pycache__" / "a.pyc").write_bytes(b"\0")
    assert rtenv.dir_fingerprint(str(d)) == jrtenv.dir_fingerprint(str(d))
    assert rtenv._zip_dir(str(d)) != b""
    with zipfile.ZipFile(__import__("io").BytesIO(
            rtenv._zip_dir(str(d), prefix="wd"))) as z:
        assert z.namelist() == ["wd/a.py"]
    env = {"env_vars": {"A": 1, "B": "two"}}
    norm = rtenv.normalize(env, client=None, head_address="")
    assert norm == jrtenv.normalize(env, client=None, head_address="")
    assert rtenv.env_hash(norm) == jrtenv.env_hash(norm) != ""
    assert rtenv.env_hash(None) == jrtenv.env_hash(None) == ""
    assert rtenv.materialize(norm, str(tmp_path), None, "") == \
        jrtenv.materialize(norm, str(tmp_path), None, "")
    pip = {"packages": ["b", "a"], "find_links": str(d)}
    assert rtenv.registered_plugins()["pip"].validate(pip) == \
        jrtenv.registered_plugins()["pip"].validate(pip)
    monkeypatch.delenv("RAY_TPU_ENV_CACHE", raising=False)
    ours = rtenv.registered_plugins()["pip"]._env_dir({"packages": ["a"]})
    theirs = jrtenv.registered_plugins()["pip"]._env_dir({"packages": ["a"]})
    assert os.path.basename(ours) == os.path.basename(theirs)
    assert ours != theirs
    for gated in ("conda", "container"):
        with pytest.raises(Exception, match="unavailable"):
            rtenv.normalize({gated: {"x": 1}}, client=None, head_address="")
