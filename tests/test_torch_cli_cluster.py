"""The port's CLI cluster commands (``python -m ray_tpu_torch.scripts.cli``
`start`, `stop`, `submit`, `job`, `exec`, `attach`), which the JAX tests
reach only through `up` and `down` (tests/test_launcher.py): exit codes
and printed lines in the JAX CLI's formats. One module-scoped cluster of
two `start` processes: a head (`start --head --address-file`) and a node
joining it (`start --address --num-gpus 1`)."""

import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu_torch import launcher
from ray_tpu_torch.scripts import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def _start(session_dir, *args):
    """A `start` process, once it has printed its lines and recorded its
    pid (the last thing it does before it blocks)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
         "--session-dir", session_dir, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    lines = []
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line.rstrip("\n"))
        if line.startswith("nodelet started at "):
            launcher._wait_for_file(os.path.join(session_dir,
                                                 "cli_pids.json"))
            return proc, lines
    proc.kill()
    raise AssertionError(f"start never came up: {lines}")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    head_dir, node_dir = str(base / "head"), str(base / "node")
    addr_file, info_file = str(base / "head_address"), str(base / "info.json")
    head, head_lines = _start(head_dir, "--head", "--num-cpus", "3",
                              "--address-file", addr_file,
                              "--node-info-file", info_file)
    procs = [head]
    try:
        with open(addr_file) as f:
            address = f.read().strip()
        node, node_lines = _start(node_dir, "--address", address,
                                  "--num-cpus", "1", "--num-gpus", "1")
        procs.append(node)
        yield {"address": address, "head": head, "node": node,
               "head_lines": head_lines, "node_lines": node_lines,
               "head_dir": head_dir, "node_dir": node_dir,
               "info_file": info_file}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


def test_start_head_and_join(started):
    """`start --head` prints where the head is and how to connect, and
    writes the address file and the node's info; `start --address`
    joins it with `--num-gpus` as its GPU resource."""
    address = started["address"]
    assert started["head_lines"][0] == f"head started at {address}"
    assert started["head_lines"][1] == (
        f"connect with: ray_tpu_torch.init(address={address!r})")
    assert started["head_lines"][2].startswith("nodelet started at ")
    assert started["head_lines"][2].endswith("with {'CPU': 3.0}")
    assert started["node_lines"][0].endswith(
        "with {'CPU': 1.0, 'GPU': 1.0}")
    with open(started["info_file"]) as f:
        info = json.load(f)
    assert info["head_address"] == address
    assert info["pid"] == started["head"].pid
    assert len(bytes.fromhex(info["node_id_hex"])) > 0
    for d, role in ((started["head_dir"], "head+nodelet"),
                    (started["node_dir"], "nodelet")):
        with open(os.path.join(d, "cli_pids.json")) as f:
            assert [e["role"] for e in json.load(f)] == [role]
    r = _cli("status", "--address", address)
    assert r.returncode == 0, r.stderr
    assert "nodes: 2 alive, 0 dead" in r.stdout
    assert "  CPU: " in r.stdout and "/4 available" in r.stdout
    assert "  GPU: 1/1 available" in r.stdout


def test_start_needs_head_or_address():
    r = _cli("start", "--num-cpus", "1")
    assert r.returncode == 2
    assert "error: start needs --head or --address" in r.stderr


def test_submit_no_wait_then_job_commands(started):
    address = started["address"]
    r = _cli("submit", "--address", address, "--submission-id", "cli-job",
             "--no-wait", "--", "echo", "hello-from-cli")
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "submitted cli-job"
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        r = _cli("job", "status", "--address", address, "--id", "cli-job")
        if r.stdout.startswith("SUCCEEDED"):
            break
        time.sleep(0.5)
    assert r.returncode == 0
    assert r.stdout.strip() == "SUCCEEDED exit code 0"
    r = _cli("job", "logs", "--address", address, "--id", "cli-job")
    assert r.returncode == 0 and r.stdout == "hello-from-cli\n"
    r = _cli("job", "list", "--address", address)
    assert r.returncode == 0
    assert "cli-job\tSUCCEEDED\techo hello-from-cli" in r.stdout.splitlines()
    r = _cli("job", "status", "--address", address)
    assert r.returncode == 2 and "error: --id required" in r.stderr
    r = _cli("submit", "--address", address, "--no-wait")
    assert r.returncode == 2 and "error: no entrypoint given" in r.stderr


def test_submit_waits_and_job_stop(started):
    address = started["address"]
    r = _cli("submit", "--address", address, "--submission-id", "cli-wait",
             "--", "echo", "waited")
    assert r.returncode == 0, r.stderr
    out = r.stdout.splitlines()
    assert out[0] == "submitted cli-wait"
    assert out[1] == "job cli-wait: SUCCEEDED"
    assert out[2] == "waited"
    r = _cli("submit", "--address", address, "--submission-id", "cli-sleep",
             "--no-wait", "--", "sleep", "60")
    assert r.returncode == 0, r.stderr
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        r = _cli("job", "status", "--address", address, "--id", "cli-sleep")
        if r.stdout.startswith("RUNNING"):
            break
        time.sleep(0.3)
    r = _cli("job", "stop", "--address", address, "--id", "cli-sleep")
    assert r.returncode == 0 and r.stdout.strip() == "stopped"
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        r = _cli("job", "status", "--address", address, "--id", "cli-sleep")
        if r.stdout.startswith("STOPPED"):
            break
        time.sleep(0.3)
    assert r.stdout.startswith("STOPPED")
    r = _cli("job", "stop", "--address", address, "--id", "no-such-job")
    assert r.returncode == 0 and r.stdout.strip() == "not found"


def test_exec_and_attach_see_the_address(tmp_path, monkeypatch, capfd):
    state_dir = str(tmp_path / "clusters")
    cfg = {"cluster_name": "ex", "provider": {"type": "local"},
           "head_node_type": "head",
           "available_node_types": {
               "head": {"resources": {"CPU": 1.0}, "min_workers": 0}},
           "initialization_commands": [], "setup_commands": []}
    state = launcher.up(cfg, state_dir=state_dir)
    try:
        out = tmp_path / "seen"
        rc = cli.main(["exec", "--state-dir", state_dir, "ex", "--",
                       f"echo $RAY_TPU_ADDRESS > {out}"])
        assert rc == 0
        assert out.read_text().strip() == state["head"]["address"]
        assert cli.main(["exec", "--state-dir", state_dir, "ex", "--",
                         "exit 3"]) == 3
        monkeypatch.setenv("SHELL", f"echo attached $RAY_TPU_ADDRESS > {out}")
        assert cli.main(["attach", "ex", "--state-dir", state_dir]) == 0
        assert out.read_text().strip() == \
            f"attached {state['head']['address']}"
    finally:
        assert cli.main(["down", "ex", "--state-dir", state_dir]) == 0
    assert capfd.readouterr().out.splitlines()[-1] == \
        "cluster 'ex' down (1 nodes terminated)"


def test_stop_session_dir_ends_its_processes(started):
    """`stop --session-dir` signals the pids its session recorded and
    removes the record; the processes shut down (last: it stops the
    module's cluster)."""
    for key, proc in (("node_dir", started["node"]),
                      ("head_dir", started["head"])):
        r = _cli("stop", "--session-dir", started[key])
        assert r.returncode == 0
        assert r.stdout.strip() == "stopped 1 process(es)"
        assert proc.wait(timeout=30) is not None
        assert not os.path.exists(os.path.join(started[key],
                                               "cli_pids.json"))
    r = _cli("stop", "--session-dir", started["head_dir"])
    assert r.stdout.strip() == "stopped 0 process(es)"
