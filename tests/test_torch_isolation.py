"""The port stands alone: no file of ray_tpu_torch/ nor chip_smoke.py
imports jax or anything of the JAX package (ray_tpu), optax, flax,
gymnasium, cloudpickle or zmq (the card's machine has none of them),
importing the cluster runtime, the trainer and worker group, or the
Tuner leaves jax, zmq and cloudpickle out of sys.modules, importing
Serve and its LLM deployment leaves grpc out too, importing compiled
graphs, the host collectives and the channels leaves jax and
cloudpickle out, importing the observability planes leaves torch out
too (``torch.profiler`` loads only when a capture is armed), and
importing the port's core API, its serving package or its RL package
leaves jax, gymnasium and cloudpickle out of sys.modules, and importing
its data layer and offline RL leaves pyarrow out too (the card's
machine has no pyarrow), importing the cluster tools (client, workflows,
launcher, job submission, autoscalers) leaves PyYAML and torch out too,
and no string of the port starts a JAX package module in a subprocess.
The card scripts beside chip_smoke.py are scanned with the package. It
keeps its own copies of the JAX-free modules it needs, and its own
envs."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    # chip_smoke.py and the card scripts committed beside it
    out = [os.path.join(ROOT, f) for f in os.listdir(ROOT)
           if f.startswith("chip_") and f.endswith(".py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ray_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu", "optax", "flax",
                   "gymnasium", "gym", "cloudpickle", "zmq")


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
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert os.path.join(ROOT, "chip_job.py") in files
    assert os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "csrc",
                                       "flash_attention.cu"))
    assert os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "csrc",
                                       "paged_attention.cu"))
    assert os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "csrc",
                                       "flash_attention_bwd.cu"))
    assert os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "csrc",
                                       "channel.cc"))


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


def test_cluster_runtime_import_leaves_jax_zmq_and_cloudpickle_unloaded():
    """The cluster runtime and its worker entry point import neither jax
    nor zmq nor cloudpickle (the card's machine has none of them), and a
    worker starts without torch (it loads where a tensor is read)."""
    code = ("import sys, ray_tpu_torch.core.cluster_runtime, "
            "ray_tpu_torch.core.worker_main, ray_tpu_torch.cluster_utils\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'zmq', 'cloudpickle', 'torch'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_observability_planes_import_leaves_jax_and_torch_unloaded():
    """The observability planes (tracing, the metrics export, the log
    plane, the profiler, the Watchtower, critpath, the state API, the
    catalog, the dashboard and the CLI) import neither jax nor zmq nor
    cloudpickle, nor torch: `torch.profiler` loads only once
    `tracing.profiler_capture` arms a window on a CUDA device."""
    code = ("import sys\n"
            "import ray_tpu_torch.util.tracing as tr\n"
            "import ray_tpu_torch.util.metrics, ray_tpu_torch.utils.logging\n"
            "import ray_tpu_torch.util.profiler, ray_tpu_torch.util.watchtower\n"
            "import ray_tpu_torch.util.critpath, ray_tpu_torch.util.state\n"
            "import ray_tpu_torch.util.metrics_catalog\n"
            "import ray_tpu_torch.dashboard, ray_tpu_torch.scripts.cli\n"
            "with tr.profiler_capture('/nonexistent', device='cpu') as p:\n"
            "    assert p is None\n"
            "with tr.profiler_capture(None) as p:\n"
            "    assert p is None\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'zmq', 'cloudpickle', 'torch'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_trainer_and_tuner_import_leave_jax_zmq_and_cloudpickle_unloaded():
    """The trainer and worker group (which ship loops through the port's
    pickler) and the Tuner import neither jax nor zmq nor cloudpickle."""
    code = ("import sys, ray_tpu_torch.train.trainer, "
            "ray_tpu_torch.train.worker_group, ray_tpu_torch.tune.tuner\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'zmq', 'cloudpickle'))\n"
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


def test_serve_import_leaves_jax_zmq_cloudpickle_and_grpc_unloaded():
    """Serve's controller, handles and proxy, the LLM deployment, the
    chaos injector and the state API's serve part import neither jax
    nor the JAX package, cloudpickle or zmq (the card's machine has
    none), and grpc loads only where a proxy starts its gRPC ingress."""
    code = ("import sys, ray_tpu_torch.serve, "
            "ray_tpu_torch.serve.llm.deployment, ray_tpu_torch.util.chaos, "
            "ray_tpu_torch.util.state\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'cloudpickle', 'zmq', 'grpc'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serve_proxy_routing_key_loads_no_torch():
    """Serve's proxy derives an LLM payload's routing key without
    importing torch (a process's first torch import takes seconds)."""
    code = ("import sys\n"
            "from ray_tpu_torch.serve.api import payload_affinity_key\n"
            "from ray_tpu_torch.serve.llm import EngineConfig\n"
            "assert payload_affinity_key({'prompt': [1, 2, 3]})\n"
            "EngineConfig.from_dict({'model': 'gpt2', 'preset': 'small'})\n"
            "assert 'torch' not in sys.modules\n")
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


def test_dag_collective_channel_import_leaves_jax_and_cloudpickle_unloaded():
    """Compiled graphs, the host collectives and the shared-memory
    channels import neither jax nor the JAX package nor cloudpickle, and
    importing them builds no channel library."""
    code = ("import sys, ray_tpu_torch.dag, ray_tpu_torch.util.collective, "
            "ray_tpu_torch.experimental.channel as ch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'cloudpickle'))\n"
            "assert not bad, bad\n"
            "assert ch._lib is None, ch._lib\n")
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


def test_cluster_tools_import_leaves_jax_cloudpickle_yaml_and_torch_unloaded():
    """The cluster tools (the client, workflows, the launcher, job
    submission, the autoscalers) import neither jax nor the JAX package,
    cloudpickle or PyYAML (the card's machine may have none: the
    launcher reads YAML only in `load_cluster_config`), nor torch: a
    job's driver or a launched node starts without it."""
    code = ("import sys, ray_tpu_torch.client, ray_tpu_torch.workflow, "
            "ray_tpu_torch.launcher, ray_tpu_torch.job_submission, "
            "ray_tpu_torch.autoscaler, ray_tpu_torch.autoscaler_v2, "
            "ray_tpu_torch.autoscaler_gcp\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'cloudpickle', 'yaml', 'torch'))\n"
            "assert not bad, bad\n"
            "import ray_tpu_torch.air\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'cloudpickle', 'yaml'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_JAX_MODULE_IN_A_STRING = re.compile(
    r"-m\s+ray_tpu(?![\w])|\b(?:from|import)\s+ray_tpu(?![\w])")


def _jax_module_launches(source: str, path: str = "<source>"):
    """String constants of `source` that would start a JAX package
    module in a subprocess: ``"-m", "ray_tpu..."`` as arguments, or
    ``-m ray_tpu...`` / ``from ray_tpu... import`` inside a string (a
    shell command or a ``-c`` program)."""
    tree = ast.parse(source, path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _JAX_MODULE_IN_A_STRING.search(node.value):
            bad.append((node.lineno, node.value[:80]))
        elts = (node.elts if isinstance(node, (ast.List, ast.Tuple)) else
                node.args if isinstance(node, ast.Call) else [])
        for a, b in zip(elts, elts[1:]):
            if isinstance(a, ast.Constant) and a.value == "-m" and \
                    isinstance(b, ast.Constant) and isinstance(b.value, str) \
                    and re.match(r"ray_tpu(?![\w])", b.value):
                bad.append((b.lineno, b.value))
    return bad


@pytest.mark.parametrize("snippet,flagged", [
    ('subprocess.Popen([sys.executable, "-m", "ray_tpu.scripts.cli"])', 1),
    ('cmd = "python -m ray_tpu.scripts.cli start --head"', 1),
    ('args = ["-c", "from ray_tpu.client import _client_host_main"]', 1),
    ('args = ["-c", "import ray_tpu; ray_tpu.init()"]', 1),
    ('args = [sys.executable, "-m", "ray_tpu_torch.scripts.cli"]', 0),
    ('args = ["-c", "from ray_tpu_torch.client import main"]', 0),
    ('doc = "the port of ray_tpu/launcher.py"', 0),
])
def test_jax_module_launch_check_flags_what_it_should(snippet, flagged):
    assert len(_jax_module_launches(snippet)) == flagged


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_subprocess_runs_a_jax_package_module(path):
    """No string of the port starts a module of the JAX package in a
    subprocess (the launcher's nodes, the client's hosts and every
    other process the port starts run the port's own modules)."""
    bad = _jax_module_launches(open(path).read(), path)
    assert not bad, f"{os.path.relpath(path, ROOT)} starts {bad}"
