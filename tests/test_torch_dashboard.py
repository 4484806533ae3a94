"""Dashboard-lite endpoint tests: the scenarios of tests/test_dashboard.py
(6) on the port's dashboard and its Train and Data views, on one
module-scoped cluster of the port, and its jobs view listing a job
submitted through the port's job submission in the JAX dashboard's
fields. The Train view's run is a `TorchTrainer` (the port's trainer)
with one CPU worker."""

import json
import urllib.request

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import dashboard
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    port = dashboard.start_dashboard(c.address, port=0)
    yield c, port
    dashboard.stop_dashboard()
    ray_tpu.shutdown()
    c.shutdown()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read().decode()


def test_html_page(cluster):
    _, port = cluster
    body = _get(port, "/")
    assert "ray_tpu_torch cluster" in body


def test_api_endpoints(cluster):
    _, port = cluster
    s = json.loads(_get(port, "/api/state"))
    assert s["nodes_alive"] == 1
    nodes = json.loads(_get(port, "/api/nodes"))
    assert nodes[0]["alive"]

    @ray_tpu.remote
    class D:
        def p(self):
            return 1

    a = D.remote()
    assert ray_tpu.get(a.p.remote(), timeout=60) == 1
    actors = json.loads(_get(port, "/api/actors"))
    assert any(x["state"] == "ALIVE" for x in actors)
    assert "# TYPE" in _get(port, "/metrics") or _get(port, "/metrics") == "\n"


def test_objects_memory_history_endpoints(cluster):
    """/api/objects, /api/memory, /api/history."""
    import time

    import numpy as np

    _, port = cluster

    @ray_tpu.remote(num_cpus=0.1)
    def produce():
        return np.zeros(1 << 20, np.uint8)  # store-resident

    ref = produce.remote()
    assert ray_tpu.get(ref, timeout=60).nbytes == 1 << 20

    objs = json.loads(_get(port, "/api/objects"))
    mine = [o for o in objs if o["object_id"] == ref.id.hex()]
    assert mine, f"driver-owned object missing from {len(objs)} rows"
    assert mine[0]["size"] >= 1 << 20
    assert mine[0]["ready"] and not mine[0]["error"]

    mem = json.loads(_get(port, "/api/memory"))
    assert mem["objects_total"] >= 1
    assert mem["nodes"] and mem["nodes"][0]["store_capacity"] > 0
    assert mem["nodes"][0]["store_bytes_allocated"] >= 1 << 20
    assert mem["by_owner"], "per-owner aggregation empty"

    # the sampler ticks every 5s; wait for at least one sample
    deadline = time.monotonic() + 15
    hist = []
    while time.monotonic() < deadline:
        hist = json.loads(_get(port, "/api/history"))
        if hist:
            break
        time.sleep(0.5)
    assert hist, "history ring buffer never sampled"
    assert hist[-1]["nodes_alive"] == 1
    assert "time" in hist[-1]


def test_node_stats_agent_endpoint(cluster):
    """Tier-2 per-node agent: loadavg + per-worker RSS + store usage
    through the nodelet (reference: dashboard/agent.py)."""
    c, port = cluster
    node_hex = c.nodelets[0].node_id.hex()

    # make sure at least one worker process exists
    @ray_tpu.remote
    def touch():
        return 1

    assert ray_tpu.get(touch.remote(), timeout=60) == 1
    s = json.loads(_get(port, f"/api/node_stats?node={node_hex}"))
    assert s["node_id"] == node_hex
    assert len(s["loadavg"]) == 3
    assert s["store"]["capacity"] > 0
    assert s["num_workers"] >= 1
    assert any(w["rss_kb"] > 0 for w in s["workers"])


def test_train_view_shows_live_run(cluster, tmp_path):
    """A TorchTrainer run is visible under /api/train."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.trainer import (
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    def loop():
        for i in range(3):
            train.report({"loss": 1.0 / (i + 1), "step": i})

    trainer = TorchTrainer(
        train_loop_per_worker=loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="dash_run",
                             storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 2
    runs = json.loads(_get(port := cluster[1], "/api/train"))
    mine = [r for r in runs if r["name"] == "dash_run"]
    assert mine and mine[0]["status"] == "FINISHED"
    assert mine[0]["iteration"] == 3
    assert mine[0]["metrics"]["step"] == 2


def test_data_and_serve_views(cluster):
    c, port = cluster
    from ray_tpu_torch import data as rd

    ds = rd.from_items(list(range(100)), parallelism=4)
    assert ds.map(lambda x: x + 1).count() == 100
    execs = json.loads(_get(port, "/api/data"))
    assert execs and execs[0]["status"] == "FINISHED"
    assert execs[0]["yielded"] >= 4
    serve_view = json.loads(_get(port, "/api/serve"))
    assert isinstance(serve_view, dict)  # empty control plane is fine


def test_jobs_endpoint_lists_submitted_jobs(cluster, monkeypatch):
    """/api/jobs lists a submitted job with its status, in the JAX
    dashboard's fields (its `_jobs` run on a stub client's answer)."""
    import ray_tpu.dashboard as jax_dashboard
    import ray_tpu.job_submission as jax_js

    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    c, port = cluster
    client = JobSubmissionClient(c.address)
    job_id = client.submit_job(entrypoint="echo listed",
                               submission_id="dash-job")
    assert client.wait_until_finished(job_id, timeout=120) == \
        JobStatus.SUCCEEDED
    jobs = json.loads(_get(port, "/api/jobs"))
    mine = [j for j in jobs if j["submission_id"] == "dash-job"]
    assert mine == [{"submission_id": "dash-job", "status": "SUCCEEDED",
                     "entrypoint": "echo listed"}]

    class StubClient:
        def __init__(self, address):
            pass

        def list_jobs(self):
            return [jax_js.JobDetails("dash-job", "echo listed",
                                      jax_js.JobStatus.SUCCEEDED)]

    monkeypatch.setattr(jax_js, "JobSubmissionClient", StubClient)
    assert jax_dashboard._jobs(None) == mine
