"""Multi-process test/deployment cluster harness.

Reference analog: ray.cluster_utils.Cluster (python/ray/cluster_utils.py:135)
— but where round 1's cluster_utils registered capacity rows in an
in-process dict, this spawns a REAL GCS server process and one REAL node
daemon process per node; tasks execute inside worker processes on the
node that won the lease, and killing a node kills an OS process whose
death the GCS detects by heartbeat timeout.

A copy of ``ray_tpu/cluster/cluster.py`` that spawns ``python -m
ray_tpu_torch.cluster.{gcs_service,node_daemon}``. A node given ``"GPU"``
leases whole cards to its workers (``node_daemon.py``); the GCS and the
daemons never import torch. ``shutdown`` kills and reaps every process it
started and removes the daemons' store, spill and runtime-env files. A
standby GCS (``standby=True``, ``kill_gcs_primary``) waits for ROADMAP.md
Queue 1, item 6, part 3b.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from ray_tpu_torch.cluster.client import ClusterClient
from ray_tpu_torch.cluster.node_daemon import STORE_PREFIX
from ray_tpu_torch.cluster.rpc import PART_3B, format_gcs_addr
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.cluster.cluster")


def _kill_group(proc: subprocess.Popen, timeout: float = 10.0) -> None:
    """SIGKILL a child's whole process group (it leads one: it was started
    in a session of its own) and reap the child."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        logger.warning("process %d did not exit %.0f s after SIGKILL", proc.pid, timeout)


def _read_banner(proc: subprocess.Popen, tag: str, timeout: float = 30.0):
    """Read the '<TAG> host:port ...' line the child prints on startup."""
    result: list = []

    def read():
        assert proc.stdout is not None
        for line in proc.stdout:
            line = line.strip()
            if line.startswith(tag):
                result.append(line.split()[1:])
                break

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    if not result:
        _kill_group(proc)
        raise RuntimeError(f"child did not print {tag} within {timeout}s")
    # keep draining stdout so the child never blocks on a full pipe
    threading.Thread(
        target=lambda: [None for _ in proc.stdout], daemon=True  # type: ignore[union-attr]
    ).start()
    return result[0]


class NodeProc:
    def __init__(self, proc: subprocess.Popen, node_id: str, addr: tuple):
        self.proc = proc
        self.node_id = node_id
        self.addr = addr

    def kill(self) -> None:
        """SIGKILL the daemon AND its workers (the whole node dies), and
        reap the daemon.

        A killed daemon can't unlink its tmpfs object-store file or remove
        its spill and runtime-env directories (graceful stop() does);
        sweep them here or crash-kill tests leak /dev/shm at ~hundreds of
        MB per run."""
        _kill_group(self.proc)
        self._remove_files()

    def _remove_files(self) -> None:
        from ray_tpu_torch.utils.shm import shm_dir as _shm_dir

        tag = f"{self.node_id}-{self.proc.pid}"
        try:
            os.unlink(os.path.join(_shm_dir(), f"{STORE_PREFIX}{tag}"))
        except OSError:
            pass
        tmp = os.environ.get("TMPDIR", "/tmp")
        for kind in ("spill", "envs"):
            shutil.rmtree(os.path.join(tmp, f"ray_tpu_torch-{kind}-{tag}"), ignore_errors=True)


class LocalCluster:
    """Spawn a GCS + N node-daemon processes on this machine."""

    def __init__(self, node_death_timeout_s: float = 2.0,
                 gcs_persist_path: Optional[str] = None,
                 standby: bool = False):
        if standby:
            raise NotImplementedError(f"LocalCluster(standby=True) waits for {PART_3B}")
        self._death_timeout = node_death_timeout_s
        self._persist_path = gcs_persist_path
        self.gcs_proc: Optional[subprocess.Popen] = None
        self.gcs_addr: Optional[tuple] = None
        self.nodes: dict[str, NodeProc] = {}
        self._client: Optional[ClusterClient] = None
        self._head: Optional[NodeProc] = None
        # every process group started (each child leads one; a daemon's
        # workers join its group) and every daemon's (node_id, pid): what
        # leftovers() checks after shutdown
        self._groups: set[int] = set()
        self._daemons: list[tuple[str, int]] = []

    # -- lifecycle ------------------------------------------------------------

    def _spawn_gcs(self, port: int = 0) -> None:
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.cluster.gcs_service",
            "--death-timeout", str(self._death_timeout),
            "--port", str(port),
        ]
        if self._persist_path:
            cmd += ["--persist", self._persist_path]
        self.gcs_proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True, env=self._child_env(),
            start_new_session=True,
        )
        self._groups.add(self.gcs_proc.pid)
        host_port = _read_banner(self.gcs_proc, "GCS_ADDRESS")[0]
        host, port_s = host_port.rsplit(":", 1)
        self.gcs_addr = (host, int(port_s))

    def start(self) -> "LocalCluster":
        self._spawn_gcs()
        return self

    @property
    def gcs_endpoints(self) -> tuple:
        """Ordered endpoint list (one endpoint: the standby waits for part
        3b)."""
        assert self.gcs_addr is not None, "start() first"
        return (self.gcs_addr,)

    def kill_gcs(self) -> None:
        """SIGKILL the control plane (FT testing)."""
        if self.gcs_proc is not None:
            _kill_group(self.gcs_proc)
            self.gcs_proc = None

    def kill_gcs_primary(self) -> None:
        """SIGKILL the primary so a standby promotes: waits for part 3b."""
        raise NotImplementedError(f"kill_gcs_primary (a standby GCS) waits for {PART_3B}")

    def restart_gcs(self) -> None:
        """Restart the GCS at the SAME address; with a persist path it
        replays actors/PGs/KV and nodes re-register via heartbeat
        (reference: Redis-backed GCS restart, gcs_init_data.cc)."""
        assert self.gcs_addr is not None, "start() first"
        self.kill_gcs()
        self._spawn_gcs(port=self.gcs_addr[1])

    def _child_env(self, extra: Optional[dict] = None) -> dict:
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env.update(extra or {})
        return env

    def add_node(
        self,
        resources: Optional[dict] = None,
        node_id: Optional[str] = None,
        worker_env: Optional[dict] = None,
        object_capacity_bytes: Optional[int] = None,
        worker_rss_limit_mb: Optional[int] = None,
        memory_usage_threshold: Optional[float] = None,
        memory_monitor_interval_s: Optional[float] = None,
    ) -> NodeProc:
        assert self.gcs_addr is not None, "start() first"
        resources = resources or {"num_cpus": 1}
        res_s = ",".join(f"{k}={v}" for k, v in resources.items())
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.cluster.node_daemon",
            "--gcs", format_gcs_addr(self.gcs_endpoints),
            "--resources", res_s,
        ]
        if object_capacity_bytes is not None:
            cmd += ["--object-capacity", str(object_capacity_bytes)]
        if worker_rss_limit_mb is not None:
            cmd += ["--worker-rss-limit-mb", str(worker_rss_limit_mb)]
        # LocalCluster default: DISABLE the machine-wide pressure trigger
        # (dev/CI hosts are shared — an unrelated tenant pushing the box
        # past 95% must not make every test cluster kill its workers);
        # the production `ray start` CLI keeps the raylet-parity 0.95
        cmd += ["--memory-usage-threshold",
                str(1.0 if memory_usage_threshold is None
                    else memory_usage_threshold)]
        if memory_monitor_interval_s is not None:
            cmd += ["--memory-monitor-interval", str(memory_monitor_interval_s)]
        if node_id:
            cmd += ["--node-id", node_id]
        if worker_env:
            cmd += ["--worker-env", ",".join(f"{k}={v}" for k, v in worker_env.items())]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True, env=self._child_env(),
            start_new_session=True,
        )
        self._groups.add(proc.pid)
        parts = _read_banner(proc, "NODE_ADDRESS")
        host, port = parts[0].rsplit(":", 1)
        node = NodeProc(proc, parts[1], (host, int(port)))
        self._daemons.append((node.node_id, proc.pid))
        self.nodes[node.node_id] = node
        if self._head is None:
            self._head = node
        return node

    @property
    def address(self) -> str:
        """GCS address for ray_tpu_torch.init(address=...): "h:p"."""
        assert self.gcs_addr is not None, "start() first"
        return format_gcs_addr(self.gcs_endpoints)

    def client(self) -> ClusterClient:
        if self._client is None:
            assert self.gcs_addr is not None and self._head is not None
            self._client = ClusterClient(self.gcs_endpoints, self._head.addr)
        return self._client

    def kill_node(self, node_id: str) -> None:
        node = self.nodes.pop(node_id, None)
        if node is not None:
            node.kill()

    def wait_for_nodes(self, n: int, timeout: float = 30.0) -> None:
        c = self.client()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [x for x in c.nodes() if x["alive"]]
            if len(alive) >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster did not reach {n} nodes")

    def wait_node_dead(self, node_id: str, timeout: float = 30.0) -> None:
        c = self.client()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for x in c.nodes():
                if x["node_id"] == node_id and not x["alive"]:
                    return
            time.sleep(0.05)
        raise TimeoutError(f"node {node_id} still alive after {timeout}s")

    def pids(self) -> list:
        """The GCS's and the daemons' pids (the daemons' workers run in
        their daemon's process group)."""
        procs = [self.gcs_proc] + [n.proc for n in self.nodes.values()]
        return [p.pid for p in procs if p is not None]

    def leftovers(self, wait_s: float = 10.0) -> dict:
        """What of this cluster is still there: live processes (not
        zombies) of the process groups it started — the GCS, the daemons
        and their workers — and the daemons' store files. Polls up to
        ``wait_s`` for SIGKILLed processes to go. Empty lists after
        ``shutdown()`` mean it left nothing."""
        from ray_tpu_torch.utils.shm import shm_dir as _shm_dir

        deadline = time.monotonic() + wait_s
        while True:
            procs = []
            for name in os.listdir("/proc"):
                if not name.isdigit():
                    continue
                try:
                    with open(f"/proc/{name}/stat") as f:
                        fields = f.read().rsplit(")", 1)[1].split()
                    with open(f"/proc/{name}/cmdline", "rb") as f:
                        cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
                except OSError:
                    continue  # gone meanwhile
                state, pgrp = fields[0], int(fields[2])
                if pgrp in self._groups and state != "Z":
                    procs.append({"pid": int(name), "pgrp": pgrp, "cmd": cmd})
            files = [f"{STORE_PREFIX}{node}-{pid}" for node, pid in self._daemons
                     if os.path.exists(os.path.join(_shm_dir(), f"{STORE_PREFIX}{node}-{pid}"))]
            if (not procs and not files) or time.monotonic() >= deadline:
                return {"processes": procs, "store_files": files}
            time.sleep(0.1)

    def shutdown(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
        for node in list(self.nodes.values()):
            node.kill()
        self.nodes.clear()
        self.kill_gcs()

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
