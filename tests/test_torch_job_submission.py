"""The port's job submission (``ray_tpu_torch.job_submission``) held against
ray_tpu's.

- The six local scenarios of ``tests/test_job_submission.py`` (succeed,
  fail with an exit code, env vars and metadata, stop, list and delete, a
  duplicate id refused) run on both packages' ``JobSubmissionClient``:
  statuses, messages, logs (with the job id replaced) and metadata are
  equal (band: exact).
- The cluster scenario runs on each package's ``LocalCluster``: a driver
  with a packaged ``working_dir`` and env vars runs on the cluster, its
  status and logs come from the GCS KV, any client lists it, and a long
  job stops through the KV flag; statuses and logs equal on both.
- The port's job task holds no card: the driver's ``CUDA_VISIBLE_DEVICES``
  is empty on a node that offers ``GPU``.

Every wait has its own limit; each client logs under ``tmp_path``. The
module shuts down any in-process runtime an earlier file left up and both
clusters at the end.
"""

import sys
import time

import pytest
import torch

from ray_tpu import serve as jserve
from ray_tpu.cluster import LocalCluster as JLocalCluster
from ray_tpu.core import api as japi
from ray_tpu.core import runtime as jrt
from ray_tpu.job_submission import ClusterJobSubmissionClient as JClusterClient
from ray_tpu.job_submission import JobStatus as JJobStatus
from ray_tpu.job_submission import JobSubmissionClient as JClient
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.cluster import LocalCluster as TLocalCluster
from ray_tpu_torch.core import api as tapi
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.job_submission import ClusterJobSubmissionClient as TClusterClient
from ray_tpu_torch.job_submission import JobStatus as TJobStatus
from ray_tpu_torch.job_submission import JobSubmissionClient as TClient

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every job wait and poll fails past this

LOCAL = {"ref": (JClient, JJobStatus), "port": (TClient, TJobStatus)}
CLUSTER = {"ref": (japi, JLocalCluster, JClusterClient, JJobStatus),
           "port": (tapi, TLocalCluster, TClusterClient, TJobStatus)}


def _down_in_process():
    for serve, runtime in ((jserve, jrt), (tserve, trt)):
        serve.shutdown()
        if runtime.is_initialized():
            runtime.shutdown_runtime()


@pytest.fixture(scope="module", autouse=True)
def _module_runtimes():
    _down_in_process()
    yield
    _down_in_process()


def _wait_running(client, status, sid) -> None:
    deadline = time.time() + WAIT_S
    while client.get_job_status(sid) != status.RUNNING:
        assert time.time() < deadline, "job never reached RUNNING"
        time.sleep(0.05)


def _succeed(client, status) -> dict:
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'print(6*7)'")
    return {"status": client.wait_until_finish(sid, timeout=WAIT_S),
            "logs": client.get_job_logs(sid), "prefix": sid.split("-")[:2]}


def _failed(client, status) -> dict:
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    st = client.wait_until_finish(sid, timeout=WAIT_S)
    info = client.get_job_info(sid)
    return {"status": st, "message": info.message, "end_set": info.end_time is not None}


def _env_and_metadata(client, status) -> dict:
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import os; "
                   f"print(os.environ[\"MY_FLAG\"], os.environ[\"RAY_TPU_JOB_ID\"])'",
        runtime_env={"env_vars": {"MY_FLAG": "on"}},
        metadata={"team": "tpu"},
        submission_id="job-env-test",
    )
    return {"status": client.wait_until_finish(sid, timeout=WAIT_S),
            "logs": client.get_job_logs(sid), "metadata": client.get_job_info(sid).metadata}


def _stop(client, status) -> dict:
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
    _wait_running(client, status, sid)
    stopped = client.stop_job(sid)
    st = client.wait_until_finish(sid, timeout=WAIT_S)
    return {"stopped": stopped, "status": st, "again": client.stop_job(sid),
            "message": client.get_job_info(sid).message}


def _list_and_delete(client, status) -> dict:
    sid = client.submit_job(entrypoint="true")
    running = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
    client.wait_until_finish(sid, timeout=WAIT_S)
    listed = sorted(j.submission_id == sid for j in client.list_jobs())
    not_terminal = client.delete_job(running)
    deleted = client.delete_job(sid)
    left = [j.submission_id for j in client.list_jobs()]
    client.stop_job(running)
    client.wait_until_finish(running, timeout=WAIT_S)
    with pytest.raises(ValueError):
        client.get_job_status(sid)
    return {"listed": listed, "not_terminal": not_terminal, "deleted": deleted,
            "left": left == [running]}


def _duplicate(client, status) -> dict:
    sid = client.submit_job(entrypoint="true", submission_id="dup")
    with pytest.raises(ValueError) as dup:
        client.submit_job(entrypoint="true", submission_id="dup")
    return {"error": str(dup.value), "status": client.wait_until_finish(sid, timeout=WAIT_S)}


@pytest.mark.parametrize("scenario", [_succeed, _failed, _env_and_metadata, _stop,
                                      _list_and_delete, _duplicate],
                         ids=["succeed", "failed", "env_and_metadata", "stop",
                              "list_and_delete", "duplicate_id"])
def test_local_job_scenarios_equal_the_reference(scenario, tmp_path):
    got = {}
    for name, (client_cls, status) in LOCAL.items():
        got[name] = scenario(client_cls(log_dir=str(tmp_path / name)), status)
    assert got["port"] == got["ref"]


def test_local_job_details(tmp_path):
    """What the reference's scenarios assert, on the port."""
    c = TClient(log_dir=str(tmp_path))
    assert _succeed(c, TJobStatus)["logs"].strip() == "42"
    assert _failed(c, TJobStatus)["message"] == "exit code 3"
    env = _env_and_metadata(c, TJobStatus)
    assert "on job-env-test" in env["logs"] and env["metadata"] == {"team": "tpu"}
    assert _stop(c, TJobStatus)["status"] == TJobStatus.STOPPED
    assert TJobStatus.TERMINAL == JJobStatus.TERMINAL


@pytest.fixture(scope="module")
def clusters():
    """Each package's one-node cluster (``jobs0``: two CPUs; the port's node
    also offers one ``GPU``), attached; both shut down after the module."""
    up: dict = {}

    def get(name):
        if name not in up:
            api, cls, _, _ = CLUSTER[name]
            c = cls(node_death_timeout_s=5.0)
            up[name] = c
            c.start()
            res = {"num_cpus": 2, **({"GPU": 1} if name == "port" else {})}
            c.add_node(res, node_id="jobs0")
            c.wait_for_nodes(1)
            api.init(address=c.address, ignore_reinit_error=True)
        return up[name]

    yield get
    for name, c in up.items():
        try:
            CLUSTER[name][0].shutdown()
        finally:
            c.shutdown()
    if "port" in up:
        left = up["port"].leftovers()
        assert left == {"processes": [], "store_files": []}, left
    _down_in_process()


def test_cluster_job_submission_with_working_dir(clusters, tmp_path):
    """Drivers run ON the cluster: the working_dir is packaged through the
    object plane, status and logs live in the GCS KV, stop_job works across
    processes."""
    wd = tmp_path / "pkg"
    wd.mkdir()
    (wd / "main.py").write_text(
        "import os\n"
        "print('job sees file:', os.path.exists('data.txt'))\n"
        "print('jobid:', os.environ['RAY_TPU_JOB_ID'])\n"
        "print('marker:', os.environ['MARKER'])\n"
    )
    (wd / "data.txt").write_text("payload")
    got = {}
    for name in ("ref", "port"):
        cluster = clusters(name)
        _, _, client_cls, status = CLUSTER[name]
        jc = client_cls(cluster.address)
        sid = jc.submit_job(entrypoint=f"{sys.executable} main.py",
                            runtime_env={"working_dir": str(wd), "env_vars": {"MARKER": "42"}},
                            metadata={"k": "v"})
        st = jc.wait_until_finish(sid, timeout=WAIT_S)
        logs = jc.get_job_logs(sid)
        assert st == status.SUCCEEDED, (st, logs)
        info = jc.get_job_info(sid)
        listed = any(j.submission_id == sid for j in jc.list_jobs())
        with pytest.raises(ValueError):
            jc.submit_job(entrypoint="true", submission_id=sid)
        # stop: a long-running job terminates via the KV flag
        sid2 = jc.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
        _wait_running(jc, status, sid2)
        assert jc.stop_job(sid2)
        st2 = jc.wait_until_finish(sid2, timeout=WAIT_S)
        failed = jc.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
        st3 = jc.wait_until_finish(failed, timeout=WAIT_S)
        got[name] = {"status": st, "logs": logs.replace(sid, "<sid>"), "listed": listed,
                     "entrypoint": info.entrypoint, "metadata": info.metadata,
                     "stopped": st2, "failed": (st3, jc.get_job_info(failed).message)}
    assert got["port"] == got["ref"]
    assert "job sees file: True" in got["port"]["logs"]
    assert got["port"]["stopped"] == "STOPPED" and got["port"]["failed"] == ("FAILED",
                                                                             "exit code 3")


def test_cluster_driver_sees_no_card(clusters):
    """The job task holds one CPU and no card: on a node that offers a GPU,
    the driver's CUDA_VISIBLE_DEVICES is empty."""
    cluster = clusters("port")
    jc = TClusterClient(cluster.address)
    sid = jc.submit_job(entrypoint=f"{sys.executable} -c 'import os; "
                                   f"print(repr(os.environ.get(\"CUDA_VISIBLE_DEVICES\")))'")
    assert jc.wait_until_finish(sid, timeout=WAIT_S) == TJobStatus.SUCCEEDED
    assert jc.get_job_logs(sid).strip() == "''"
