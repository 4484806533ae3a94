"""Job submission — run entrypoint commands on the cluster.

Reference parity: ray.job_submission.JobSubmissionClient backed by the
job manager (python/ray/dashboard/modules/job/job_manager.py) whose unit
of execution is a detached supervisor actor per job running the
entrypoint as a subprocess (job_supervisor.py). Job metadata/status live
in the head KV (reference: GCS job table); logs are captured by the
supervisor and fetched through it (or from KV after terminal states).

The port's copy of ``ray_tpu/job_submission.py``. The supervisor claims
no GPU, so its worker (and the entrypoint it runs) sees no card
(``CUDA_VISIBLE_DEVICES=""``), as JAX's sees no TPU: a job's device work
runs in tasks or actors that claim a GPU."""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import subprocess
import threading
import time
import uuid


class JobStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    def is_terminal(self) -> bool:
        return self in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                        JobStatus.STOPPED)


@dataclasses.dataclass
class JobDetails:
    submission_id: str
    entrypoint: str
    status: JobStatus
    message: str = ""
    start_time: float = 0.0
    end_time: float = 0.0


class _JobSupervisor:
    """Detached actor running one job's entrypoint (reference:
    job_supervisor.py — the subprocess runs in the actor's worker
    process, inheriting its runtime env)."""

    def __init__(self, submission_id: str, entrypoint: str, head: str):
        self.id = submission_id
        self.entrypoint = entrypoint
        self.head = head
        self._logs: list[str] = []
        self._proc = None
        self._status = JobStatus.PENDING
        self._message = ""
        self._start = time.time()
        self._end = 0.0
        self._state_lock = threading.Lock()
        threading.Thread(target=self._run, daemon=True,
                         name=f"job-{submission_id}").start()

    def _put_status(self):
        from ray_tpu_torch.core.rpc import RpcClient

        record = {
            "submission_id": self.id,
            "entrypoint": self.entrypoint,
            "status": self._status.value,
            "message": self._message,
            "start_time": self._start,
            "end_time": self._end,
        }
        try:
            RpcClient.shared().call(
                self.head, "kv_put",
                {"ns": "job", "key": self.id, "overwrite": True},
                frames=[json.dumps(record).encode()], timeout=30)
        except Exception:  # noqa: BLE001
            pass

    def _run(self):
        with self._state_lock:
            if self._status == JobStatus.STOPPED:
                # stop_job raced startup: honor it, never launch
                self._end = time.time()
                self._put_status()
                return
            self._status = JobStatus.RUNNING
        self._put_status()
        try:
            # new session: terminate via killpg reaches the whole tree,
            # not just the shell
            with self._state_lock:
                if self._status == JobStatus.STOPPED:
                    self._end = time.time()
                    self._put_status()
                    return
                self._proc = subprocess.Popen(
                    self.entrypoint, shell=True, text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    start_new_session=True,
                    env=dict(os.environ, RAY_TPU_JOB_ID=self.id))
            for line in self._proc.stdout:
                self._logs.append(line)
                if len(self._logs) > 10000:
                    del self._logs[:5000]
            rc = self._proc.wait()
            if self._status != JobStatus.STOPPED:
                self._status = (JobStatus.SUCCEEDED if rc == 0
                                else JobStatus.FAILED)
                self._message = f"exit code {rc}"
        except Exception as e:  # noqa: BLE001
            self._status = JobStatus.FAILED
            self._message = repr(e)
        self._end = time.time()
        self._put_status()
        # persist the log tail for post-mortem reads
        from ray_tpu_torch.core.rpc import RpcClient

        try:
            RpcClient.shared().call(
                self.head, "kv_put",
                {"ns": "job_logs", "key": self.id, "overwrite": True},
                frames=["".join(self._logs[-2000:]).encode()], timeout=30)
        except Exception:  # noqa: BLE001
            pass

    def status(self) -> dict:
        return {"status": self._status.value, "message": self._message}

    def logs(self) -> str:
        return "".join(self._logs)

    def stop(self) -> bool:
        import signal

        with self._state_lock:
            if self._status.is_terminal():
                return False  # already finished: nothing to stop
            self._status = JobStatus.STOPPED
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except Exception:  # noqa: BLE001
                try:
                    proc.terminate()
                except Exception:  # noqa: BLE001
                    pass
        return True


class JobSubmissionClient:
    """Reference: ray.job_submission.JobSubmissionClient (REST in the
    reference; direct head RPC here — same verbs)."""

    def __init__(self, address: str | None = None):
        import ray_tpu_torch as ray
        from ray_tpu_torch.core import api as _api

        if address is None:
            if _api._runtime is None:
                ray.init()
            address = _api._runtime.head_address
        self.address = address

    def submit_job(self, *, entrypoint: str,
                   submission_id: str | None = None,
                   runtime_env: dict | None = None) -> str:
        import ray_tpu_torch as ray

        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        sup_cls = ray.remote(num_cpus=0.1,
                                 runtime_env=runtime_env)(_JobSupervisor)
        # detached supervisor: the handle is deliberately dropped — its
        # lifetime is head-managed and it is recovered by name below
        # graftlint: disable=discarded-future
        sup_cls.options(name=f"__job_{job_id}",
                        lifetime="detached").remote(
            job_id, entrypoint, self.address)
        return job_id

    def _supervisor(self, job_id: str):
        import ray_tpu_torch as ray

        return ray.get_actor(f"__job_{job_id}")

    def get_job_status(self, job_id: str) -> JobStatus:
        return self.get_job_info(job_id).status

    def get_job_info(self, job_id: str) -> JobDetails:
        import ray_tpu_torch as ray

        try:
            sup = self._supervisor(job_id)
            s = ray.get(sup.status.remote(), timeout=30)
            rec = {"status": s["status"], "message": s["message"]}
        except Exception:  # noqa: BLE001
            rec = self._kv_record(job_id)
            if rec is None:
                raise ValueError(f"no job {job_id!r}") from None
        kv = self._kv_record(job_id) or {}
        return JobDetails(
            submission_id=job_id,
            entrypoint=kv.get("entrypoint", ""),
            status=JobStatus(rec["status"]),
            message=rec.get("message", ""),
            start_time=kv.get("start_time", 0.0),
            end_time=kv.get("end_time", 0.0),
        )

    def _kv_record(self, job_id: str) -> dict | None:
        from ray_tpu_torch.core.rpc import RpcClient

        value, frames = RpcClient.shared().call_frames(
            self.address, "kv_get", {"ns": "job", "key": job_id}, timeout=30)
        if not value.get("found"):
            return None
        return json.loads(frames[0])

    def get_job_logs(self, job_id: str) -> str:
        import ray_tpu_torch as ray

        try:
            sup = self._supervisor(job_id)
            return ray.get(sup.logs.remote(), timeout=30)
        except Exception:  # noqa: BLE001
            from ray_tpu_torch.core.rpc import RpcClient

            value, frames = RpcClient.shared().call_frames(
                self.address, "kv_get", {"ns": "job_logs", "key": job_id},
                timeout=30)
            if not value.get("found"):
                return ""
            return frames[0].decode(errors="replace")

    def list_jobs(self) -> list[JobDetails]:
        from ray_tpu_torch.core.rpc import RpcClient

        keys = RpcClient.shared().call(
            self.address, "kv_keys", {"ns": "job", "prefix": ""},
            timeout=30)["keys"]
        return [self.get_job_info(k) for k in keys]

    def stop_job(self, job_id: str) -> bool:
        import ray_tpu_torch as ray

        try:
            sup = self._supervisor(job_id)
            return ray.get(sup.stop.remote(), timeout=30)
        except Exception:  # noqa: BLE001
            return False

    def wait_until_finished(self, job_id: str, timeout: float = 300
                            ) -> JobStatus:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            s = self.get_job_status(job_id)
            if s.is_terminal():
                return s
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still {s} after {timeout}s")
