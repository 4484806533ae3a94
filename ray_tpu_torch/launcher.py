"""Cluster launcher — boot a cluster from a YAML config.

Reference parity: `ray up` / `ray down` / `ray attach` / `ray exec`
(python/ray/scripts/scripts.py:1383), the NodeUpdater that drives each
node through UNINITIALIZED → SETTING-UP → RUNNING
(autoscaler/_private/updater.py), and the command-runner seam that
abstracts "run a command on that node" (command_runner.py — SSH for real
clouds, subprocess for the local provider). The local provider boots
head + workers as detached `ray_tpu start` subprocesses on one box — the
same path a cloud provider drives over SSH — and the cluster state file
lets `down`, `exec`, and the v2 autoscaler find the nodes later.

YAML schema (reference: autoscaler/ray-schema.json, trimmed):

    cluster_name: demo
    max_workers: 4
    provider: {type: local}            # or gcp_tpu
    auth: {ssh_user: ubuntu}           # ssh provider path
    head_node_type: head
    available_node_types:
      head:   {resources: {CPU: 2}, min_workers: 0, max_workers: 0}
      worker: {resources: {CPU: 1}, min_workers: 2, max_workers: 4}
    initialization_commands: []        # once per node, before start
    setup_commands: []                 # env prep (pip installs, ...)

The port's copy of ``ray_tpu/launcher.py``. Its nodes are
``python -m ray_tpu_torch.scripts.cli start`` processes, run with the
checkout's root on PYTHONPATH; its cluster state lies under the port's
own root, ``$TMPDIR/ray_tpu_torch/clusters``. `load_cluster_config`
reads YAML (PyYAML, imported when it is called); `up` takes the same
config as a dict and needs no YAML.
"""

from __future__ import annotations

import json
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import time

_STATE_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "clusters")
# the checkout's root: the nodes import the package from there
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNINITIALIZED = "UNINITIALIZED"
SETTING_UP = "SETTING-UP"
RUNNING = "RUNNING"
UPDATE_FAILED = "UPDATE-FAILED"
TERMINATED = "TERMINATED"


def load_cluster_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg.setdefault("cluster_name", "default")
    cfg.setdefault("provider", {"type": "local"})
    cfg.setdefault("max_workers", 4)
    cfg.setdefault("available_node_types", {
        "head": {"resources": {"CPU": 1.0}, "min_workers": 0},
        "worker": {"resources": {"CPU": 1.0}, "min_workers": 0},
    })
    cfg.setdefault("head_node_type",
                   next(iter(cfg["available_node_types"])))
    cfg.setdefault("initialization_commands", [])
    cfg.setdefault("setup_commands", [])
    return cfg


# ------------------------------------------------------ command runners


class CommandRunner:
    """Run shell commands "on a node" (reference: command_runner.py
    CommandRunnerInterface)."""

    def run(self, cmd: str, timeout: float = 120.0) -> int:
        raise NotImplementedError

    def run_daemon(self, cmd: str, log_path: str) -> int:
        """Start a long-lived process; returns its pid."""
        raise NotImplementedError


class SubprocessCommandRunner(CommandRunner):
    """The local "SSH seam": commands execute on this box via
    subprocess — exactly what the SSH runner does remotely, minus the
    transport (reference: fake_multi_node + LocalNodeProvider)."""

    def __init__(self, env: dict | None = None):
        self.env = {**os.environ, **(env or {})}
        path = self.env.get("PYTHONPATH", "")
        if _ROOT not in path.split(os.pathsep):
            self.env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path
                                              else "")

    def run(self, cmd: str, timeout: float = 120.0) -> int:
        return subprocess.run(cmd, shell=True, env=self.env,
                              timeout=timeout).returncode

    def run_daemon(self, cmd: str, log_path: str) -> int:
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(
                cmd, shell=True, env=self.env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        return proc.pid


class SSHCommandRunner(CommandRunner):
    """Real-cloud path: shell out to ssh (reference:
    command_runner.py SSHCommandRunner). Untested in this zero-egress
    image; the subprocess runner exercises the identical updater flow."""

    def __init__(self, ip: str, ssh_user: str = "root",
                 ssh_private_key: str | None = None):
        self.ip = ip
        base = ["ssh", "-o", "StrictHostKeyChecking=no",
                "-o", "ConnectTimeout=10"]
        if ssh_private_key:
            base += ["-i", ssh_private_key]
        self._ssh = base + [f"{ssh_user}@{ip}"]

    def run(self, cmd: str, timeout: float = 120.0) -> int:
        return subprocess.run(self._ssh + [cmd], timeout=timeout).returncode

    def run_daemon(self, cmd: str, log_path: str) -> int:
        wrapped = f"nohup {cmd} > {shlex.quote(log_path)} 2>&1 & echo $!"
        out = subprocess.run(self._ssh + [wrapped], capture_output=True,
                             text=True, timeout=30)
        try:
            return int(out.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            return -1


# --------------------------------------------------------- node updater


class NodeUpdater:
    """Drive one node to RUNNING (reference: updater.py NodeUpdater.run
    — init commands, setup commands, then the start-ray command)."""

    def __init__(self, node_name: str, runner: CommandRunner,
                 init_commands: list[str], setup_commands: list[str]):
        self.node_name = node_name
        self.runner = runner
        self.init_commands = list(init_commands)
        self.setup_commands = list(setup_commands)
        self.status = UNINITIALIZED

    def update(self, start_cmd: str, log_path: str) -> int:
        """Returns the daemon pid, or raises on a failed phase."""
        self.status = SETTING_UP
        for cmd in self.init_commands + self.setup_commands:
            rc = self.runner.run(cmd)
            if rc != 0:
                self.status = UPDATE_FAILED
                raise RuntimeError(
                    f"node {self.node_name}: setup command failed "
                    f"(rc={rc}): {cmd}")
        pid = self.runner.run_daemon(start_cmd, log_path)
        self.status = RUNNING
        return pid


# ------------------------------------------------------------ up / down


def _state_path(cluster_name: str, state_dir: str | None = None) -> str:
    d = state_dir or _STATE_DIR
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{cluster_name}.json")


def _save_state(state: dict, state_dir: str | None = None):
    path = _state_path(state["cluster_name"], state_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, path)


def load_state(cluster_name: str, state_dir: str | None = None) -> dict:
    with open(_state_path(cluster_name, state_dir)) as f:
        return json.load(f)


def _wait_for_file(path: str, timeout: float = 60.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip()
        time.sleep(0.2)
    raise TimeoutError(f"timed out waiting for {path}")


def _start_cmd(node_type: str, spec: dict, *, head: bool,
               head_address: str | None, session_dir: str,
               address_file: str | None, info_file: str) -> str:
    res = dict(spec.get("resources", {}))
    cpus = res.pop("CPU", 1.0)
    parts = [shlex.quote(sys.executable), "-m", "ray_tpu_torch.scripts.cli",
             "start", "--num-cpus", str(cpus),
             "--session-dir", shlex.quote(session_dir),
             "--node-info-file", shlex.quote(info_file),
             "--labels", shlex.quote(json.dumps(
                 {"ray_tpu.node_type": node_type}))]
    if res:
        parts += ["--resources", shlex.quote(json.dumps(res))]
    if head:
        parts += ["--head", "--address-file", shlex.quote(address_file)]
    else:
        parts += ["--address", shlex.quote(head_address)]
    return " ".join(parts)


def up(config: dict, state_dir: str | None = None,
       runner_factory=None) -> dict:
    """Boot head + min_workers from a config dict (reference: ray up —
    scripts.py:1383 calling create_or_update_cluster). Returns the
    cluster state (head address, node pids)."""
    name = config["cluster_name"]
    provider_type = config.get("provider", {}).get("type", "local")
    if provider_type not in ("local", "gcp_tpu"):
        raise ValueError(f"unknown provider type {provider_type!r}")
    base = os.path.join(state_dir or _STATE_DIR, name)
    os.makedirs(base, exist_ok=True)
    runner_factory = runner_factory or (
        lambda node_name: SubprocessCommandRunner())

    head_type = config["head_node_type"]
    types = config["available_node_types"]
    state = {"cluster_name": name, "state_dir": state_dir,
             "head": None, "workers": [], "config": config}

    # -- head -------------------------------------------------------------
    addr_file = os.path.join(base, "head_address")
    info_file = os.path.join(base, "head_info.json")
    for stale in (addr_file, info_file):
        if os.path.exists(stale):
            os.remove(stale)
    updater = NodeUpdater("head", runner_factory("head"),
                          config["initialization_commands"],
                          config["setup_commands"])
    head_cmd = _start_cmd(head_type, types[head_type], head=True,
                          head_address=None,
                          session_dir=os.path.join(base, "head"),
                          address_file=addr_file, info_file=info_file)
    head_pid = updater.update(head_cmd, os.path.join(base, "head.log"))
    head_address = _wait_for_file(addr_file)
    head_info = json.loads(_wait_for_file(info_file))
    state["head"] = {"pid": head_pid, "address": head_address,
                     "node_type": head_type, "status": updater.status,
                     "node_id_hex": head_info["node_id_hex"]}
    _save_state(state, state_dir)

    # -- workers (min_workers per type) -----------------------------------
    idx = 0
    for node_type, spec in types.items():
        n = int(spec.get("min_workers", 0))
        if node_type == head_type:
            n = 0  # the head already carries its own nodelet
        for _ in range(n):
            idx += 1
            state["workers"].append(_launch_worker(
                config, state, node_type, idx, base, head_address,
                runner_factory))
            _save_state(state, state_dir)
    return state


def _launch_worker(config: dict, state: dict, node_type: str, idx: int,
                   base: str, head_address: str, runner_factory) -> dict:
    types = config["available_node_types"]
    info_file = os.path.join(base, f"worker{idx}_info.json")
    if os.path.exists(info_file):
        os.remove(info_file)
    updater = NodeUpdater(f"worker{idx}", runner_factory(f"worker{idx}"),
                          config["initialization_commands"],
                          config["setup_commands"])
    cmd = _start_cmd(node_type, types[node_type], head=False,
                     head_address=head_address,
                     session_dir=os.path.join(base, f"worker{idx}"),
                     address_file=None, info_file=info_file)
    pid = updater.update(cmd, os.path.join(base, f"worker{idx}.log"))
    info = json.loads(_wait_for_file(info_file))
    return {"pid": pid, "node_type": node_type, "index": idx,
            "status": updater.status, "node_id_hex": info["node_id_hex"],
            "address": info["address"]}


def pid_alive(pid: int) -> bool:
    """True while the process actually runs — reaps it when it is our
    zombie child (launchers are usually the daemons' parent)."""
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


def _kill(pid: int, timeout: float = 10.0):
    try:
        os.killpg(pid, signal.SIGINT)
    except (ProcessLookupError, PermissionError):
        try:
            os.kill(pid, signal.SIGINT)
        except OSError:
            return
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not pid_alive(pid):
            return
        time.sleep(0.1)
    try:
        os.killpg(pid, signal.SIGKILL)
    except OSError:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def down(cluster_name: str, state_dir: str | None = None) -> dict:
    """Terminate every node of the cluster (reference: ray down —
    teardown_cluster). Workers first, head last, state file removed."""
    state = load_state(cluster_name, state_dir)
    for w in state.get("workers", []):
        _kill(w["pid"])
        w["status"] = TERMINATED
    if state.get("head"):
        _kill(state["head"]["pid"])
        state["head"]["status"] = TERMINATED
    try:
        os.remove(_state_path(cluster_name, state_dir))
    except OSError:
        pass
    return state


def exec_on_cluster(cluster_name: str, cmd: str,
                    state_dir: str | None = None) -> int:
    """Run a command against the cluster with RAY_TPU_ADDRESS exported
    (reference: ray exec)."""
    state = load_state(cluster_name, state_dir)
    env = {**os.environ, "RAY_TPU_ADDRESS": state["head"]["address"]}
    return subprocess.run(cmd, shell=True, env=env).returncode


def attach(cluster_name: str, state_dir: str | None = None) -> int:
    """Interactive shell with the cluster address exported (reference:
    ray attach — ssh into the head; locally: a subshell)."""
    return exec_on_cluster(cluster_name,
                           os.environ.get("SHELL", "/bin/sh"), state_dir)


# --------------------------------------------- autoscaler provider view


class LaunchedNodeProvider:
    """NodeProvider over a launched cluster's worker processes, so the
    v2 Reconciler adopts and manages them (reference: the local node
    provider backing `ray up` clusters). create_node launches a fresh
    worker through the same updater path `up` used."""

    def __init__(self, cluster_name: str, node_type: str = "worker",
                 state_dir: str | None = None):
        self.cluster_name = cluster_name
        self.node_type = node_type
        self.state_dir = state_dir

    def _state(self) -> dict:
        return load_state(self.cluster_name, self.state_dir)

    def non_terminated_nodes(self) -> list:
        out = []
        for w in self._state().get("workers", []):
            if w.get("status") == TERMINATED:
                continue
            if not pid_alive(w["pid"]):
                continue
            out.append(w)
        return out

    def node_id(self, handle) -> bytes:
        return bytes.fromhex(handle["node_id_hex"])

    def create_node(self, node_type: str | None = None):
        state = self._state()
        cfg = state["config"]
        base = os.path.join(self.state_dir or _STATE_DIR,
                            self.cluster_name)
        idx = max([w["index"] for w in state["workers"]], default=0) + 1
        w = _launch_worker(cfg, state, node_type or self.node_type, idx,
                           base, state["head"]["address"],
                           lambda n: SubprocessCommandRunner())
        state["workers"].append(w)
        _save_state(state, self.state_dir)
        return w

    def terminate_node(self, handle):
        state = self._state()
        _kill(handle["pid"])
        for w in state["workers"]:
            if w["index"] == handle["index"]:
                w["status"] = TERMINATED
        _save_state(state, self.state_dir)
