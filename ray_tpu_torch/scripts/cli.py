"""Operator CLI: start/stop/status/submit for the cluster control plane
(counterpart of ``ray_tpu/scripts/cli.py``).

Reference analog: `ray start` / `ray stop` / `ray status`
(python/ray/scripts/scripts.py:654) — head mode boots the GCS plus a
node daemon, worker mode joins an existing GCS, stop kills what this
host started, status prints the GCS's cluster view.

    python -m ray_tpu_torch.scripts.cli start --head [--port 6380] \
        [--resources num_cpus=8,GPU=1] [--dashboard-port 0] \
        [--persist /var/lib/ray_tpu/gcs.snap]
    python -m ray_tpu_torch.scripts.cli start --address HOST:PORT --resources ...
    python -m ray_tpu_torch.scripts.cli status [--address HOST:PORT]
    python -m ray_tpu_torch.scripts.cli submit [--working-dir D] [--env K=V] -- CMD ...
    python -m ray_tpu_torch.scripts.cli stop
    python -m ray_tpu_torch.scripts.cli k8s [--gpu-workers N] > cluster.yaml

Where it differs from the reference: the state file lives under
``RAY_TPU_TORCH_STATE_DIR`` (default ``$TMPDIR/ray_tpu_torch-$USER``), so one
package's ``stop`` never kills the other's daemons on a shared host; the
GCS, the node daemon and the dashboard it starts import no torch, as the
reference's run with ``JAX_PLATFORMS=cpu`` so the control plane never takes
an accelerator; ``--dashboard-port 0`` starts the dashboard on an ephemeral
port (the banner names it), where the reference's 0 starts none (no flag
starts none here); ``stop`` lets each node daemon exit (at most
``NODE_STOP_WAIT_S``) before it signals the GCS, where the reference
signals every process at once.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional


def _state_dir() -> str:
    d = os.environ.get(
        "RAY_TPU_TORCH_STATE_DIR",
        os.path.join(
            os.environ.get("TMPDIR", "/tmp"),
            f"ray_tpu_torch-{os.environ.get('USER', 'user')}",
        ),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _state_path() -> str:
    return os.path.join(_state_dir(), "cluster.json")


def _load_state() -> dict:
    try:
        with open(_state_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {"procs": []}


def _save_state(state: dict) -> None:
    with open(_state_path(), "w") as f:
        json.dump(state, f, indent=2)


def _read_banner(proc: subprocess.Popen, tag: str, timeout: float = 30.0) -> list:
    deadline = time.monotonic() + timeout
    assert proc.stdout is not None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"child exited before printing {tag}")
        line = line.strip()
        if line.startswith(tag):
            return line.split()[1:]
    raise RuntimeError(f"child did not print {tag} within {timeout}s")


def _spawn(cmd, env, log_name: str) -> subprocess.Popen:
    """Daemonized child: banner on a pipe we read then drop, logs to a
    file (NOT our inherited stderr — a captured CLI must reach EOF when
    the CLI exits, not when the daemons do)."""
    log_dir = os.path.join(_state_dir(), "logs")
    os.makedirs(log_dir, exist_ok=True)
    log = open(os.path.join(log_dir, log_name), "ab")
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=log, text=True, env=env,
        start_new_session=True,
    )


def cmd_start(args) -> int:
    state = _load_state()
    env = dict(os.environ)
    if args.head:
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.cluster.gcs_service",
            "--host", args.host, "--port", str(args.port),
            "--death-timeout", str(args.death_timeout),
        ]
        if args.persist:
            cmd += ["--persist", args.persist]
        gcs = _spawn(cmd, env, "gcs.log")
        host_port = _read_banner(gcs, "GCS_ADDRESS")[0]
        gcs.stdout.close()
        state["gcs_address"] = host_port
        state["procs"].append({"role": "gcs", "pid": gcs.pid})
        print(f"GCS started at {host_port}")
        address = host_port
        if args.dashboard_port is not None:
            cmd = [
                sys.executable, "-m", "ray_tpu_torch.dashboard",
                "--gcs", address, "--host", args.host,
                "--port", str(args.dashboard_port),
            ]
            dash = _spawn(cmd, env, "dashboard.log")
            dash_addr = _read_banner(dash, "DASHBOARD_ADDRESS")[0]
            dash.stdout.close()
            state["procs"].append({"role": "dashboard", "pid": dash.pid})
            print(f"dashboard started at http://{dash_addr}")
    else:
        if not args.address:
            print("worker mode needs --address HOST:PORT", file=sys.stderr)
            return 2
        address = args.address
    if args.head or args.address:
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.cluster.node_daemon",
            "--gcs", address,
            "--resources", args.resources,
            "--host", args.host,
        ]
        if args.node_id:
            cmd += ["--node-id", args.node_id]
        if args.object_capacity:
            cmd += ["--object-capacity", str(args.object_capacity)]
        node = _spawn(cmd, env, "node.log")
        parts = _read_banner(node, "NODE_ADDRESS")
        node.stdout.close()
        state["procs"].append(
            {"role": "node", "pid": node.pid, "node_id": parts[1]}
        )
        print(f"node {parts[1]} started at {parts[0]}")
    _save_state(state)
    print(
        f"\nconnect with: ray_tpu_torch.init(address=\"{address}\")\n"
        f"state file:   {_state_path()}"
    )
    return 0


# how long `stop` waits for a node daemon's drain before it signals the GCS
NODE_STOP_WAIT_S = 10.0


def _alive(pid: int) -> bool:
    """The process exists and is not a zombie (a daemon whose parent, the
    `start` that spawned it, is gone is reaped by init, not by us)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def cmd_stop(args) -> int:
    state = _load_state()
    for rec in reversed(state.get("procs", [])):
        try:
            os.killpg(os.getpgid(rec["pid"]), signal.SIGTERM)
            print(f"stopped {rec['role']} (pid {rec['pid']})")
        except (ProcessLookupError, PermissionError, OSError):
            continue
        if rec["role"] == "node":
            # a draining daemon deregisters from the GCS on its way out:
            # signalled together with the GCS, it retries the dead GCS for
            # tens of seconds, so the GCS waits for it (bounded)
            deadline = time.monotonic() + NODE_STOP_WAIT_S
            while _alive(rec["pid"]) and time.monotonic() < deadline:
                time.sleep(0.05)
    try:
        os.unlink(_state_path())
    except OSError:
        pass
    return 0


def cmd_status(args) -> int:
    address = args.address or _load_state().get("gcs_address")
    if not address:
        print("no cluster state found; pass --address HOST:PORT", file=sys.stderr)
        return 2
    from ray_tpu_torch.cluster.rpc import RpcClient

    host, port = address.rsplit(":", 1)
    gcs = RpcClient(host, int(port), timeout=10.0).connect(retries=3)
    nodes = gcs.call("list_nodes", None)
    actors = gcs.call("list_actors", None)
    pgs = gcs.call("list_pgs", None)
    print(f"GCS: {address}")
    print(f"nodes ({len(nodes)}):")
    for n in nodes:
        mark = "ALIVE" if n["alive"] else "DEAD"
        avail = ", ".join(f"{k}={v:g}/{n['resources'].get(k, 0):g}"
                          for k, v in sorted(n["available"].items()))
        print(f"  {n['node_id']:<16} {mark:<6} {avail}")
    alive_actors = [a for a in actors if a["state"] != "DEAD"]
    print(f"actors: {len(alive_actors)} alive / {len(actors)} total")
    for a in alive_actors[:20]:
        name = a["name"] or a["actor_id"].hex()[:12]
        print(f"  {name:<24} {a['state']:<10} node={a['node_id']}")
    print(f"placement groups: {len(pgs)}")
    gcs.close()
    return 0


def cmd_submit(args) -> int:
    address = args.address or _load_state().get("gcs_address")
    if not address:
        print("no cluster state found; pass --address HOST:PORT", file=sys.stderr)
        return 2
    import shlex

    entry = list(args.entrypoint)
    if entry and entry[0] == "--":  # only the LEADING separator is ours
        entry = entry[1:]
    if not entry:
        print("submit needs an entrypoint command", file=sys.stderr)
        return 2
    from ray_tpu_torch.job_submission import ClusterJobSubmissionClient, JobStatus

    renv: dict = {}
    if args.working_dir:
        renv["working_dir"] = args.working_dir
    env_vars = {}
    for kv in args.env:
        if "=" not in kv:
            print(f"--env expects K=V, got {kv!r}", file=sys.stderr)
            return 2
        k, v = kv.split("=", 1)
        env_vars[k] = v
    if env_vars:
        renv["env_vars"] = env_vars
    jc = ClusterJobSubmissionClient(address)
    sid = jc.submit_job(entrypoint=shlex.join(entry), runtime_env=renv or None)
    print(f"submitted {sid}")
    if args.no_wait:
        return 0
    st = jc.wait_until_finish(sid, timeout=24 * 3600)
    print(jc.get_job_logs(sid), end="")
    print(f"job {sid}: {st}")
    return 0 if st == JobStatus.SUCCEEDED else 1


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("start", help="start head (GCS+node) or join a cluster")
    ps.add_argument("--head", action="store_true")
    ps.add_argument("--address", default=None, help="existing GCS to join")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=0, help="GCS port (head mode)")
    ps.add_argument("--resources", default="num_cpus=1")
    ps.add_argument("--node-id", default=None)
    ps.add_argument("--persist", default=None, help="GCS snapshot path (FT)")
    ps.add_argument("--dashboard-port", type=int, default=None,
                    help="also start the dashboard on this port, 0 for an ephemeral one "
                         "(head mode)")
    ps.add_argument("--object-capacity", type=int, default=None)
    ps.add_argument("--death-timeout", type=float, default=5.0)
    ps.set_defaults(fn=cmd_start)

    pt = sub.add_parser("stop", help="stop processes started on this host")
    pt.set_defaults(fn=cmd_stop)

    pu = sub.add_parser("status", help="print the cluster view")
    pu.add_argument("--address", default=None)
    pu.set_defaults(fn=cmd_status)

    pj = sub.add_parser(
        "submit", help="run a driver command ON the cluster (`ray job submit`)"
    )
    pj.add_argument("--address", default=None)
    pj.add_argument("--working-dir", default=None,
                    help="directory packaged to the cluster as the job cwd")
    pj.add_argument("--env", action="append", default=[],
                    metavar="K=V", help="environment for the driver")
    pj.add_argument("--no-wait", action="store_true",
                    help="return after submission instead of streaming status")
    pj.add_argument("entrypoint", nargs=argparse.REMAINDER,
                    help="command to run (prefix with -- to pass flags)")
    pj.set_defaults(fn=cmd_submit)

    from ray_tpu_torch.scripts.k8s import cmd_k8s

    pk = sub.add_parser(
        "k8s", help="emit Kubernetes manifests (the KubeRay-operator role)"
    )
    pk.add_argument("--name", default="ray-tpu")
    pk.add_argument("--image", default="ray-tpu:latest")
    pk.add_argument("--namespace", default="default")
    pk.add_argument("--gcs-port", type=int, default=6379)
    pk.add_argument("--workers", type=int, default=2)
    pk.add_argument("--worker-resources", default="num_cpus=4")
    pk.add_argument("--worker-cpu", default=None,
                    help="pod cpu request (default: num_cpus from --worker-resources)")
    pk.add_argument("--worker-memory", default="8Gi")
    pk.add_argument("--gpu-workers", type=int, default=0)
    pk.add_argument("--gpu-accelerator", default="nvidia-h100-80gb")
    pk.add_argument("--gpus-per-host", type=int, default=8)
    pk.set_defaults(fn=cmd_k8s)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
