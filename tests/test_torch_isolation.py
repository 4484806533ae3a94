"""The port stands alone: no file of ray_tpu_torch/ nor chip_smoke.py
imports jax or anything of the JAX package (ray_tpu), optax, flax,
gymnasium or cloudpickle (the card's machine has none of them), and
importing the port's core API, its serving package or its RL package
leaves jax, gymnasium and cloudpickle out of sys.modules, and importing
its data layer and offline RL leaves pyarrow out too (the card's
machine has no pyarrow). It keeps its
own copies of the JAX-free modules it needs, and its own envs."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ray_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu", "optax", "flax",
                   "gymnasium", "gym", "cloudpickle")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 10
    assert os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "csrc",
                                       "flash_attention.cu"))
    assert os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "csrc",
                                       "paged_attention.cu"))
    assert os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "csrc",
                                       "flash_attention_bwd.cu"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_ray_tpu_import(path):
    bad = [(line, m) for line, m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_core_api_import_leaves_jax_and_cloudpickle_unloaded():
    """`import ray_tpu_torch` loads the core API only: no jax, no
    cloudpickle, and none of the serving, RL or training packages."""
    code = ("import sys, ray_tpu_torch\n"
            "assert ray_tpu_torch.init and ray_tpu_torch.remote\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'cloudpickle') or m.startswith("
            "('ray_tpu_torch.serve', 'ray_tpu_torch.rllib', "
            "'ray_tpu_torch.train')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serving_import_leaves_jax_unloaded():
    code = ("import sys, ray_tpu_torch.serve.llm, ray_tpu_torch.interop, "
            "ray_tpu_torch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_rllib_import_leaves_jax_and_gymnasium_unloaded():
    code = ("import sys, ray_tpu_torch.rllib, ray_tpu_torch.tune\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'gymnasium', 'gym', 'optax', "
            "'cloudpickle'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_data_and_offline_rl_import_leaves_pyarrow_unloaded():
    code = ("import sys, ray_tpu_torch.data, ray_tpu_torch.rllib.offline, "
            "ray_tpu_torch.rllib.cql\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pyarrow', 'jax', 'jaxlib', 'ray_tpu', 'gymnasium', 'gym', "
            "'cloudpickle'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_import_builds_nothing():
    """Importing the port compiles no kernel: the build directory is
    touched only at a wrapper's first launch on a card."""
    code = ("import ray_tpu_torch._build as b, ray_tpu_torch.ops.attention,"
            " ray_tpu_torch.ops.paged_attention, ray_tpu_torch.train,"
            " ray_tpu_torch.data.lineio as lio\n"
            "assert not b._libs, b._libs\n"
            "assert lio._lib is None, lio._lib\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
