"""Job submission: run driver scripts as supervised subprocesses
(counterpart of ``ray_tpu/job_submission/__init__.py``).

Reference analog: python/ray/job_submission/ (JobSubmissionClient) +
python/ray/dashboard/modules/job/ (job_manager.py spawns a supervisor
per job, captures logs, tracks JobStatus). Single-host: a supervisor
thread per job; entrypoints are shell commands; runtime_env supports
env_vars and working_dir (the subset that matters without a cluster
package store). Logs go under ``$TMPDIR/ray_tpu_torch_jobs``. The
cluster-backed client, ``ClusterJobSubmissionClient``, is
``cluster_jobs.py``.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.jobs")


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    metadata: dict = field(default_factory=dict)
    log_path: str = ""


class JobSubmissionClient:
    """Local job manager (the reference's client talks HTTP to the
    dashboard job server; the manager semantics are what matters here)."""

    def __init__(self, address: Optional[str] = None, log_dir: Optional[str] = None):
        self._jobs: dict[str, JobInfo] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._log_dir = log_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch_jobs"
        )
        os.makedirs(self._log_dir, exist_ok=True)

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
    ) -> str:
        sid = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if sid in self._jobs:
                raise ValueError(f"job {sid!r} already exists")
            info = JobInfo(
                submission_id=sid,
                entrypoint=entrypoint,
                metadata=metadata or {},
                log_path=os.path.join(self._log_dir, f"{sid}.log"),
            )
            self._jobs[sid] = info

        env = dict(os.environ)
        renv = runtime_env or {}
        env.update({str(k): str(v) for k, v in renv.get("env_vars", {}).items()})
        env["RAY_TPU_JOB_ID"] = sid
        # jobs must always be able to import the framework, wherever their
        # entrypoint script lives (the reference relies on ray being
        # pip-installed; the equivalent here is PYTHONPATH injection)
        from ray_tpu_torch.utils.env import inject_framework_pythonpath

        inject_framework_pythonpath(env)
        cwd = renv.get("working_dir") or os.getcwd()

        def supervise():
            try:
                with open(info.log_path, "wb") as logf:
                    proc = subprocess.Popen(
                        entrypoint,
                        shell=True,
                        cwd=cwd,
                        env=env,
                        stdout=logf,
                        stderr=subprocess.STDOUT,
                    )
                    with self._lock:
                        self._procs[sid] = proc
                        # stop_job may have landed before Popen: honor it
                        stopped_early = info.status == JobStatus.STOPPED
                        if not stopped_early:
                            info.status = JobStatus.RUNNING
                    if stopped_early:
                        proc.terminate()
                    rc = proc.wait()
                with self._lock:
                    self._procs.pop(sid, None)
                    info.end_time = time.time()
                    if info.status == JobStatus.STOPPED:
                        pass  # stop_job already set it
                    elif rc == 0:
                        info.status = JobStatus.SUCCEEDED
                    else:
                        info.status = JobStatus.FAILED
                        info.message = f"exit code {rc}"
            except Exception as e:
                with self._lock:
                    info.status = JobStatus.FAILED
                    info.message = repr(e)
                    info.end_time = time.time()

        threading.Thread(target=supervise, name=f"job-{sid}", daemon=True).start()
        return sid

    def get_job_status(self, submission_id: str) -> str:
        return self._info(submission_id).status

    def get_job_info(self, submission_id: str) -> JobInfo:
        return self._info(submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        info = self._info(submission_id)
        if not os.path.exists(info.log_path):
            return ""
        with open(info.log_path, errors="replace") as f:
            return f.read()

    def list_jobs(self) -> list[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def stop_job(self, submission_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(submission_id)
            proc = self._procs.get(submission_id)
            if info is None:
                raise ValueError(f"unknown job {submission_id!r}")
            if info.status in JobStatus.TERMINAL:
                return False
            info.status = JobStatus.STOPPED
            info.message = "stopped by user"
        if proc is not None:
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    proc.kill()
            except Exception:
                pass
        return True

    def delete_job(self, submission_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(submission_id)
            if info is None or info.status not in JobStatus.TERMINAL:
                return False
            del self._jobs[submission_id]
        try:
            os.unlink(info.log_path)
        except OSError:
            pass
        return True

    def wait_until_finish(
        self, submission_id: str, timeout: float = 60.0, poll_s: float = 0.1
    ) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(submission_id)
            if st in JobStatus.TERMINAL:
                return st
            time.sleep(poll_s)
        raise TimeoutError(f"job {submission_id} still running after {timeout}s")

    def _info(self, sid: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(sid)
        if info is None:
            raise ValueError(f"unknown job {sid!r}")
        return info


def __getattr__(name):
    # cluster-backed client lives in its own module (imports the cluster
    # plane; the local manager must stay import-light)
    if name == "ClusterJobSubmissionClient":
        from ray_tpu_torch.job_submission.cluster_jobs import ClusterJobSubmissionClient

        return ClusterJobSubmissionClient
    raise AttributeError(name)


__all__ = [
    "ClusterJobSubmissionClient", "JobInfo", "JobStatus", "JobSubmissionClient",
]
