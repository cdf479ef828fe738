"""Cluster-backed job submission: drivers run ON the cluster (counterpart
of ``ray_tpu/job_submission/cluster_jobs.py``).

Reference analog: python/ray/dashboard/modules/job/job_manager.py — the
job server packages the submission's working_dir, schedules a
supervisor on some node, and tracks JobStatus/logs in the GCS so ANY
client can query them. Here:

  * the entrypoint runs as a cluster TASK (max_retries=0 — a driver
    must not silently re-run) whose runtime_env carries the packaged
    working_dir (content-addressed staging via the object plane,
    cluster/runtime_env.py) and env_vars;
  * the runner supervises the entrypoint subprocess from inside the
    worker, flushing status + log tail to the GCS KV (ns "jobs") every
    second, and polls a stop flag so stop_job() works cross-process;
  * the client is stateless beyond its GCS connection: status, logs and
    listing come from the KV, so a second client on another machine
    sees the same jobs (the reference's HTTP-client property).

The job task holds ``num_cpus=1`` and no card: its worker's
``CUDA_VISIBLE_DEVICES`` is empty, and the entrypoint inherits it, so a
driver sees no card. A driver that serves a model on the card does it
through a ``num_gpus=1`` task or actor, whose worker the node daemon pins
to its card grant.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import uuid
from typing import Optional

from ray_tpu_torch.job_submission import JobInfo, JobStatus
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.jobs.cluster")

_NS = "jobs"
_LOG_TAIL = 1 << 20  # KV carries the last 1MB of driver output


def _kv_key(sid: str, kind: str) -> bytes:
    return f"{kind}/{sid}".encode()


def _job_runner(sid: str, entrypoint: str, env_vars: dict) -> str:
    """Runs on a cluster worker: supervise the entrypoint subprocess,
    stream status/logs to the GCS KV, honor the stop flag."""
    import threading

    from ray_tpu_torch.cluster.client import _ambient_client

    client = _ambient_client()

    def put(kind: str, value: dict) -> None:
        client.kv_put(_kv_key(sid, kind), json.dumps(value).encode(), ns=_NS)

    import signal

    env = dict(os.environ)
    env.update({str(k): str(v) for k, v in env_vars.items()})
    env["RAY_TPU_JOB_ID"] = sid
    log_path = os.path.join(
        os.environ.get("TMPDIR", "/tmp"), f"ray_tpu_torch-job-{sid}.log"
    )
    start = time.time()
    # a stop raised while we were still QUEUED (client stop_job, or the
    # PENDING-staleness failover that already recorded FAILED): exit
    # without running — putting RUNNING here would flip a terminal status
    if client.kv_get(_kv_key(sid, "stop"), ns=_NS) is not None:
        raw = client.kv_get(_kv_key(sid, "status"), ns=_NS)
        doc = json.loads(bytes(raw).decode()) if raw is not None else {}
        if doc.get("status") not in JobStatus.TERMINAL:
            put("status", {"status": JobStatus.STOPPED,
                           "start_time": doc.get("start_time", start),
                           "end_time": time.time(),
                           "message": "stopped before start"})
        return JobStatus.STOPPED
    put("status", {"status": JobStatus.RUNNING, "start_time": start,
                   "node": os.environ.get("RAY_TPU_NODE_ID", "?")})
    with open(log_path, "wb") as logf:
        # own process GROUP: stop must reach the shell's descendants,
        # not just /bin/sh (a `a.py && b.py` entrypoint would orphan
        # the python driver otherwise)
        proc = subprocess.Popen(
            entrypoint, shell=True, cwd=os.getcwd(),  # working_dir cwd
            env=env, stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True,
        )

        def killpg(sig):
            try:
                os.killpg(os.getpgid(proc.pid), sig)
            except (ProcessLookupError, PermissionError, OSError):
                pass

        stop = threading.Event()

        def watch():
            pushed = -1
            while not stop.wait(2.0):
                try:
                    # liveness heartbeat: clients infer a dead driver
                    # (node loss) from staleness, independent of the
                    # submitting process surviving
                    client.kv_put(
                        _kv_key(sid, "hb"), str(time.time()).encode(), ns=_NS
                    )
                    size = os.path.getsize(log_path)
                    if size != pushed:  # skip identical re-pushes
                        with open(log_path, "rb") as f:
                            f.seek(max(0, size - _LOG_TAIL))
                            client.kv_put(
                                _kv_key(sid, "logs"), f.read(), ns=_NS
                            )
                        pushed = size
                    if client.kv_get(_kv_key(sid, "stop"), ns=_NS) is not None:
                        killpg(signal.SIGTERM)
                        time.sleep(3)
                        if proc.poll() is None:
                            killpg(signal.SIGKILL)
                        return
                except Exception:  # noqa: BLE001 — KV hiccup: keep going
                    pass

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        rc = proc.wait()
        stop.set()
        t.join(timeout=5)
    with open(log_path, "rb") as f:
        f.seek(max(0, os.path.getsize(log_path) - _LOG_TAIL))
        client.kv_put(_kv_key(sid, "logs"), f.read(), ns=_NS)
    stopped = client.kv_get(_kv_key(sid, "stop"), ns=_NS) is not None
    status = (
        JobStatus.STOPPED if stopped
        else JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED
    )
    put("status", {"status": status, "start_time": start,
                   "end_time": time.time(),
                   "message": "" if rc == 0 else f"exit code {rc}"})
    try:
        os.unlink(log_path)
    except OSError:
        pass
    return status


class ClusterJobSubmissionClient:
    """Submit driver scripts to a running cluster (``init(address=...)``
    form of the reference JobSubmissionClient)."""

    def __init__(self, address: str):
        from ray_tpu_torch.core import api

        ambient = api._cluster()
        if ambient is not None and ambient.address == address:
            self._backend = ambient
        else:
            # a dedicated backend: reusing an ambient attachment to a
            # DIFFERENT cluster would silently submit to the wrong one
            from ray_tpu_torch.core.cluster_backend import ClusterBackend

            self._backend = ClusterBackend(address)
        self._client = self._backend.client

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
        resources: Optional[dict] = None,
    ) -> str:
        import threading

        sid = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        # ATOMIC claim of the id (kv set-if-absent): two clients with the
        # same explicit submission_id must not both launch drivers
        claimed = self._client.gcs.call("kv_put", {
            "ns": _NS, "key": _kv_key(sid, "spec"), "nx": True,
            "value": json.dumps({
                "entrypoint": entrypoint,
                "metadata": metadata or {},
                "submit_time": time.time(),
            }).encode(),
        })
        if not claimed.get("ok"):
            raise ValueError(f"job {sid!r} already exists")
        renv = dict(runtime_env or {})
        env_vars = dict(renv.pop("env_vars", {}))
        self._client.kv_put(
            _kv_key(sid, "status"),
            json.dumps({"status": JobStatus.PENDING,
                        "start_time": time.time()}).encode(),
            ns=_NS,
        )
        # the driver task: max_retries=0 (drivers must not re-run), the
        # packaged working_dir travels through the runtime_env store
        ref = self._client.submit(
            _job_runner,
            (sid, entrypoint, env_vars),
            resources=resources or {"num_cpus": 1},
            max_retries=0,
            runtime_env=renv or None,
            desc=f"job:{sid}",
        )

        def reconcile():
            # the runner's own status puts cover the happy path; this
            # covers the task DYING (worker/node death, crash before the
            # first put) — otherwise the KV would read PENDING forever
            try:
                self._client.get(ref, timeout=30 * 24 * 3600)
            except Exception as e:  # noqa: BLE001 — task-level failure
                try:
                    doc = self._status_doc(sid)
                except Exception:  # noqa: BLE001
                    doc = {}
                if doc.get("status") not in JobStatus.TERMINAL:
                    self._client.kv_put(
                        _kv_key(sid, "status"),
                        json.dumps({
                            "status": JobStatus.FAILED,
                            "start_time": doc.get("start_time", time.time()),
                            "end_time": time.time(),
                            "message": f"driver task died: {e!r}"[:500],
                        }).encode(),
                        ns=_NS,
                    )

        threading.Thread(
            target=reconcile, name=f"job-reconcile-{sid}", daemon=True
        ).start()
        return sid

    # -- queries (KV-backed: any client sees the same state) ------------------

    HEARTBEAT_STALE_S = 30.0
    # generous: covers queueing + runtime_env staging + worker spawn on a
    # loaded cluster before the runner's first status/heartbeat put
    PENDING_STALE_S = 300.0

    def _status_doc(self, sid: str) -> dict:
        raw = self._client.kv_get(_kv_key(sid, "status"), ns=_NS)
        if raw is None:
            raise ValueError(f"unknown job {sid!r}")
        doc = json.loads(bytes(raw).decode())
        if doc.get("status") == JobStatus.RUNNING:
            # a RUNNING job whose runner heartbeat went stale died with
            # its worker/node — ANY client can detect and record it
            # (the submitter's task-ref watcher may itself be gone)
            hb = self._client.kv_get(_kv_key(sid, "hb"), ns=_NS)
            if hb is not None:
                age = time.time() - float(bytes(hb).decode())
                if age > self.HEARTBEAT_STALE_S:
                    doc = {**doc, "status": JobStatus.FAILED,
                           "end_time": time.time(),
                           "message": f"driver heartbeat stale ({age:.0f}s)"}
                    self._client.kv_put(
                        _kv_key(sid, "status"),
                        json.dumps(doc).encode(), ns=_NS,
                    )
        elif doc.get("status") == JobStatus.PENDING:
            # a PENDING job whose runner never heartbeat at all died
            # before its first put (submitter crashed pre-reconcile, or
            # the driver task was lost with its node): without this, the
            # KV reads PENDING forever for every other client
            hb = self._client.kv_get(_kv_key(sid, "hb"), ns=_NS)
            if hb is None:
                spec_raw = self._client.kv_get(_kv_key(sid, "spec"), ns=_NS)
                submitted = None
                if spec_raw is not None:
                    try:
                        submitted = json.loads(
                            bytes(spec_raw).decode()
                        ).get("submit_time")
                    except (ValueError, AttributeError):
                        submitted = None
                if submitted is None:
                    submitted = doc.get("start_time")
                age = time.time() - submitted if submitted else 0.0
                if age > self.PENDING_STALE_S:
                    doc = {**doc, "status": JobStatus.FAILED,
                           "end_time": time.time(),
                           "message": (
                               f"job pending with no driver heartbeat for "
                               f"{age:.0f}s (driver task lost before start)"
                           )}
                    # also raise the stop flag: if the driver task was
                    # merely QUEUED (not lost) and gets a slot later, the
                    # runner's stop check kills it immediately instead of
                    # re-running a job every client already saw FAILED
                    self._client.kv_put(_kv_key(sid, "stop"), b"1", ns=_NS)
                    self._client.kv_put(
                        _kv_key(sid, "status"),
                        json.dumps(doc).encode(), ns=_NS,
                    )
        return doc

    def get_job_status(self, submission_id: str) -> str:
        return self._status_doc(submission_id)["status"]

    def get_job_info(self, submission_id: str) -> JobInfo:
        doc = self._status_doc(submission_id)
        raw = self._client.kv_get(_kv_key(submission_id, "spec"), ns=_NS)
        spec = json.loads(bytes(raw).decode()) if raw else {}
        return JobInfo(
            submission_id=submission_id,
            entrypoint=spec.get("entrypoint", ""),
            status=doc["status"],
            message=doc.get("message", ""),
            start_time=doc.get("start_time", 0.0),
            end_time=doc.get("end_time"),
            metadata=spec.get("metadata", {}),
        )

    def get_job_logs(self, submission_id: str) -> str:
        raw = self._client.kv_get(_kv_key(submission_id, "logs"), ns=_NS)
        return "" if raw is None else bytes(raw).decode(errors="replace")

    def list_jobs(self) -> list[JobInfo]:
        sids = [
            bytes(k).decode().split("/", 1)[1]
            for k in self._client.gcs.call("kv_keys", {"ns": _NS}) or ()
            if bytes(k).decode().startswith("spec/")
        ]
        return [self.get_job_info(s) for s in sorted(sids)]

    def stop_job(self, submission_id: str) -> bool:
        if self.get_job_status(submission_id) in JobStatus.TERMINAL:
            return False
        self._client.kv_put(_kv_key(submission_id, "stop"), b"1", ns=_NS)
        return True

    def wait_until_finish(
        self, submission_id: str, timeout: float = 120.0, poll_s: float = 0.25
    ) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(submission_id)
            if st in JobStatus.TERMINAL:
                return st
            time.sleep(poll_s)
        raise TimeoutError(f"job {submission_id} still running after {timeout}s")
