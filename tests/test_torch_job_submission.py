"""The port's job submission (ray_tpu_torch/job_submission.py) through
the scenarios of tests/test_job_submission.py (3) on one module-scoped
cluster of the port (a 4-CPU head node, the JAX fixture's), and the
supervisor's worker holding the card back from the entrypoint as JAX's
holds the TPU back: the entrypoint sees ``CUDA_VISIBLE_DEVICES=""``."""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    ray.init(address=c.address)
    yield c
    ray.shutdown()
    c.shutdown()


def test_submit_and_succeed(cluster):
    client = JobSubmissionClient(cluster.address)
    job_id = client.submit_job(
        entrypoint="echo hello-from-job && python -c 'print(6*7)'")
    status = client.wait_until_finished(job_id, timeout=120)
    assert status == JobStatus.SUCCEEDED
    logs = client.get_job_logs(job_id)
    assert "hello-from-job" in logs
    assert "42" in logs


def test_failed_job_reports_exit_code(cluster):
    client = JobSubmissionClient(cluster.address)
    job_id = client.submit_job(entrypoint="python -c 'import sys; sys.exit(3)'")
    status = client.wait_until_finished(job_id, timeout=120)
    assert status == JobStatus.FAILED
    assert "exit code 3" in client.get_job_info(job_id).message


def test_list_and_stop(cluster):
    client = JobSubmissionClient(cluster.address)
    job_id = client.submit_job(entrypoint="sleep 60", submission_id="longjob")

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if client.get_job_status(job_id) == JobStatus.RUNNING:
            break
        time.sleep(0.2)
    assert client.stop_job(job_id)
    status = client.wait_until_finished(job_id, timeout=60)
    assert status == JobStatus.STOPPED
    jobs = client.list_jobs()
    assert any(j.submission_id == "longjob" for j in jobs)


def test_entrypoint_sees_no_card_and_the_job_id(cluster):
    """The supervisor claims no GPU, so its worker, and the entrypoint
    under it, see no card; the entrypoint gets its job id."""
    client = JobSubmissionClient(cluster.address)
    job_id = client.submit_job(
        entrypoint="echo \"cvd=[$CUDA_VISIBLE_DEVICES] id=$RAY_TPU_JOB_ID\"",
        submission_id="env-job")
    assert client.wait_until_finished(job_id, timeout=120) == \
        JobStatus.SUCCEEDED
    assert "cvd=[] id=env-job" in client.get_job_logs(job_id)
    info = client.get_job_info(job_id)
    assert info.entrypoint.startswith("echo")
    assert 0 < info.start_time <= info.end_time
