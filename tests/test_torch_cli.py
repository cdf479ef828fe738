"""The port's operator CLI, Kubernetes manifests and status script
(``ray_tpu_torch.scripts``) held against ray_tpu's.

- ``tests/test_cli.py``'s two scenarios (start --head / status / an
  attached driver / stop; submit a driver with a working_dir, then a
  failing one) run on both packages' CLIs, each under its own state dir in
  ``tmp_path``: the lines each prints have the same shapes, with addresses,
  pids and ids masked (band: exact).
- The port's control plane (its GCS, node daemon and dashboard) loads no
  torch; ``--dashboard-port 0`` starts the dashboard on an ephemeral port.
- Pinned divergences: the state dir's variable (``RAY_TPU_TORCH_STATE_DIR``,
  the reference's ``RAY_TPU_STATE_DIR`` is ignored), ``stop`` letting a
  daemon deregister before the GCS goes (every process gone within
  ``NODE_STOP_WAIT_S``), and the manifests' GPU worker group against the
  reference's TPU group, field by field (``tests/test_k8s_manifests.py``'s
  two scenarios).
- ``ray_tpu_torch.scripts.status`` against the repo's
  ``scripts/ray_tpu_status.py``, each on its own package's GCS: the same
  sections and the same JSON keys.

Every CLI call and wait has its own limit; every test stops what it
started in a ``finally``.
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch
import yaml

from ray_tpu.scripts.k8s import generate_manifests as jgenerate
from ray_tpu_torch.scripts.cli import NODE_STOP_WAIT_S, _alive
from ray_tpu_torch.scripts.cli import main as tcli_main
from ray_tpu_torch.scripts.k8s import generate_manifests as tgenerate
from ray_tpu_torch.scripts.k8s import manifests_yaml as tmanifests_yaml

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_S = 120  # every CLI call fails past this
MODULES = {"ref": "ray_tpu.scripts.cli", "port": "ray_tpu_torch.scripts.cli"}
STATE_VAR = {"ref": "RAY_TPU_STATE_DIR", "port": "RAY_TPU_TORCH_STATE_DIR"}


def _env(name: str, state_dir) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("RAY_TPU_STATE_DIR", None)
    env.pop("RAY_TPU_TORCH_STATE_DIR", None)
    env[STATE_VAR[name]] = str(state_dir)
    return env


def _cli(name: str, env: dict, *argv, timeout: float = CLI_S):
    return subprocess.run([sys.executable, "-m", MODULES[name], *argv], env=env,
                          capture_output=True, text=True, timeout=timeout)


def _mask(text: str) -> list:
    """The lines' shapes: addresses, pids, job and node ids, paths and the
    package's name masked."""
    out = []
    for ln in text.splitlines():
        ln = re.sub(r"ray_tpu_torch|ray_tpu", "PKG", ln)
        ln = re.sub(r"\d+\.\d+\.\d+\.\d+:\d+", "ADDR", ln)
        ln = re.sub(r"raytpu-job-[0-9a-f]+", "JOB", ln)
        ln = re.sub(r"pid \d+", "pid N", ln)
        ln = re.sub(r"/\S+", "PATH", ln)
        out.append(ln.rstrip())
    return out


def _stop_all(name: str, env: dict) -> None:
    _cli(name, env, "stop", timeout=60)


def _start_status_attach(name: str, tmp_path) -> dict:
    state_dir = tmp_path / f"{name}-state"
    env = _env(name, state_dir)
    try:
        r = _cli(name, env, "start", "--head", "--resources", "num_cpus=2",
                 "--node-id", "cli-n0")
        assert r.returncode == 0, r.stderr
        assert "GCS started" in r.stdout and "cli-n0 started" in r.stdout
        start_lines = _mask(r.stdout)
        state = json.load(open(state_dir / "cluster.json"))
        addr = state["gcs_address"]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            r = _cli(name, env, "status")
            if "cli-n0" in r.stdout and "ALIVE" in r.stdout:
                break
            time.sleep(0.5)
        assert "cli-n0" in r.stdout and "ALIVE" in r.stdout, r.stdout
        status_lines = _mask(r.stdout)
        pkg = "ray_tpu" if name == "ref" else "ray_tpu_torch"
        code = (f"from {pkg}.core import api\n"
                f"api.init(address='{addr}')\n"
                "def f():\n"
                "    import os\n"
                "    return os.environ.get('RAY_TPU_NODE_ID')\n"
                "print('RAN_ON', api.get(api.remote(f).remote(), timeout=60))\n")
        r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                           text=True, timeout=CLI_S)
        assert "RAN_ON cli-n0" in r.stdout, (r.stdout, r.stderr)
        pids = [p["pid"] for p in state["procs"]]
        r = _cli(name, env, "stop")
        assert r.returncode == 0 and "stopped" in r.stdout
        assert not (state_dir / "cluster.json").exists()
        return {"start": start_lines, "status": status_lines, "stop": _mask(r.stdout),
                "roles": [p["role"] for p in state["procs"]], "pids": pids}
    finally:
        _stop_all(name, env)


def test_cli_start_status_stop(tmp_path):
    got = {name: _start_status_attach(name, tmp_path) for name in ("ref", "port")}
    for key in ("start", "status", "stop", "roles"):
        assert got["port"][key] == got["ref"][key], key
    # the port's stop waited for the daemon: every process is gone
    deadline = time.monotonic() + NODE_STOP_WAIT_S
    while any(_alive(p) for p in got["port"]["pids"]) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [p for p in got["port"]["pids"] if _alive(p)]


def _submit(name: str, tmp_path) -> dict:
    env = _env(name, tmp_path / f"{name}-state")
    wd = tmp_path / f"{name}-app"
    wd.mkdir()
    (wd / "main.py").write_text("import os\nprint('driver-ran-on-cluster', os.environ['X'])\n")
    r = _cli(name, env, "start", "--head", "--resources", "num_cpus=2")
    assert r.returncode == 0, r.stderr
    try:
        r = _cli(name, env, "submit", "--working-dir", str(wd), "--env", "X=1",
                 "--", sys.executable, "main.py")
        assert r.returncode == 0, (r.stdout, r.stderr)
        assert "driver-ran-on-cluster 1" in r.stdout and "SUCCEEDED" in r.stdout
        ok = _mask(r.stdout)
        # failing drivers propagate a nonzero exit
        r = _cli(name, env, "submit", "--", sys.executable, "-c", "raise SystemExit(3)")
        assert r.returncode == 1, (r.stdout, r.stderr)
        assert "FAILED" in r.stdout
        bad = _mask(r.stdout)
        r = _cli(name, env, "submit", "--env", "NOEQUALS", "--", "true")
        return {"ok": ok, "bad": bad, "bad_env": (r.returncode, r.stderr.strip())}
    finally:
        _stop_all(name, env)


def test_cli_submit_runs_driver_on_cluster(tmp_path):
    got = {name: _submit(name, tmp_path) for name in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert got["port"]["bad_env"][0] == 2


def _maps_have_torch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def test_port_control_plane_loads_no_torch_and_dashboard_port_zero(tmp_path):
    """The GCS, node daemon and dashboard that ``start --head
    --dashboard-port 0`` spawns load no torch; the dashboard answers on the
    ephemeral port its banner names (the reference's 0 starts none)."""
    import urllib.request

    env = _env("port", tmp_path / "state")
    try:
        r = _cli("port", env, "start", "--head", "--resources", "num_cpus=1,GPU=1",
                 "--dashboard-port", "0")
        assert r.returncode == 0, r.stderr
        url = re.search(r"dashboard started at (http://\S+)", r.stdout).group(1)
        assert not url.endswith(":0")
        state = json.load(open(tmp_path / "state" / "cluster.json"))
        assert [p["role"] for p in state["procs"]] == ["gcs", "dashboard", "node"]
        with urllib.request.urlopen(url + "/api/cluster/nodes", timeout=60) as resp:
            nodes = json.loads(resp.read())
        assert nodes[0]["resources"] == {"num_cpus": 1.0, "GPU": 1.0}
        assert not [p["pid"] for p in state["procs"] if _maps_have_torch(p["pid"])]
        r = _cli("ref", _env("ref", tmp_path / "ref-state"), "start", "--head",
                 "--resources", "num_cpus=1", "--dashboard-port", "0")
        try:
            assert r.returncode == 0 and "dashboard" not in r.stdout
        finally:
            _stop_all("ref", _env("ref", tmp_path / "ref-state"))
    finally:
        _stop_all("port", env)


def test_state_dir_variable_divergence(tmp_path):
    """Pinned: the port's state file follows ``RAY_TPU_TORCH_STATE_DIR``,
    else ``$TMPDIR/ray_tpu_torch-$USER``; the reference's
    ``RAY_TPU_STATE_DIR`` is not read, so one package's ``stop`` never
    finds the other's daemons."""
    ref_dir = tmp_path / "ref-state"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, TMPDIR=str(tmp_path),
               USER="cliuser", RAY_TPU_STATE_DIR=str(ref_dir))
    env.pop("RAY_TPU_TORCH_STATE_DIR", None)
    try:
        r = _cli("port", env, "start", "--head", "--resources", "num_cpus=1")
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "ray_tpu_torch-cliuser" / "cluster.json").exists()
        assert not (ref_dir / "cluster.json").exists()
        assert _cli("ref", env, "stop").stdout == ""  # the reference finds nothing to stop
        assert "stopped gcs" in _cli("port", env, "stop").stdout
    finally:
        _stop_all("port", env)


# ---------------------------------------------------------------------------
# status: ray_tpu_torch.scripts.status against scripts/ray_tpu_status.py
# ---------------------------------------------------------------------------


def _headers(text: str) -> list:
    return [ln.split("(")[0].strip() for ln in text.splitlines() if ln.startswith("==")]


def test_status_script_equals_the_references(tmp_path):
    got = {}
    for name, cmd in (("ref", [sys.executable, os.path.join(REPO, "scripts",
                                                              "ray_tpu_status.py")]),
                      ("port", [sys.executable, "-m", "ray_tpu_torch.scripts.status"])):
        env = _env(name, tmp_path / f"{name}-state")
        try:
            assert _cli(name, env, "start", "--head", "--resources", "num_cpus=1",
                        "--node-id", "st0").returncode == 0
            gcs = json.load(open(tmp_path / f"{name}-state" / "cluster.json"))["gcs_address"]
            deadline = time.monotonic() + 60
            while True:
                table = subprocess.run(cmd + ["--gcs", gcs], env=env, capture_output=True,
                                       text=True, timeout=CLI_S)
                if "st0" in table.stdout or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            raw = subprocess.run(cmd + ["--gcs", gcs, "--json", "--ttft", "0.5"], env=env,
                                 capture_output=True, text=True, timeout=CLI_S)
            down = subprocess.run(cmd + ["--gcs", "127.0.0.1:1"], env=env,
                                  capture_output=True, text=True, timeout=CLI_S)
            got[name] = {"rc": (table.returncode, raw.returncode, down.returncode),
                         "headers": _headers(table.stdout),
                         "node_line": "st0" in table.stdout,
                         "keys": sorted(json.loads(raw.stdout))}
        finally:
            _stop_all(name, env)
    assert got["port"] == got["ref"]
    assert got["port"]["rc"] == (0, 0, 1) and got["port"]["node_line"]


# ---------------------------------------------------------------------------
# k8s manifests (tests/test_k8s_manifests.py)
# ---------------------------------------------------------------------------

# the reference's TPU worker group -> the port's GPU worker group, field by
# field: whole strings (keys and values), then the daemon's resource string
# inside the GPU workers' command
TPU_TO_GPU = {"tpu-worker": "gpu-worker", "google.com/tpu": "nvidia.com/gpu",
              "cloud.google.com/gke-tpu-accelerator": "cloud.google.com/gke-accelerator",
              "v5e-8": "nvidia-h100-80gb", "ray_tpu.scripts.cli": "ray_tpu_torch.scripts.cli"}


def _as_port(obj, name: str = "ray-tpu"):
    """A reference manifest rewritten by ``TPU_TO_GPU``; the TPU group's
    Deployment ``<name>-tpu-worker`` becomes ``<name>-gpu-worker``."""
    if isinstance(obj, dict):
        return {_as_port(k, name): _as_port(v, name) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_as_port(v, name) for v in obj]
    if isinstance(obj, str):
        obj = {f"{name}-tpu-worker": f"{name}-gpu-worker", **TPU_TO_GPU}.get(obj, obj)
        obj = obj.replace(",TPU=", ",GPU=")
    return obj


def test_manifest_topology():
    docs = tgenerate(workers=3, gpu_workers=2, gpus_per_host=8)
    kinds = [(d["kind"], d["metadata"]["name"]) for d in docs]
    assert kinds == [("Service", "ray-tpu-head"), ("Deployment", "ray-tpu-head"),
                     ("Deployment", "ray-tpu-worker"), ("Deployment", "ray-tpu-gpu-worker")]
    by_name = {d["metadata"]["name"]: d for d in docs if d["kind"] == "Deployment"}
    assert by_name["ray-tpu-worker"]["spec"]["replicas"] == 3
    gpu = by_name["ray-tpu-gpu-worker"]
    assert gpu["spec"]["replicas"] == 2
    box = gpu["spec"]["template"]["spec"]["containers"][0]
    assert box["resources"]["requests"]["nvidia.com/gpu"] == "8"
    assert box["resources"]["limits"]["nvidia.com/gpu"] == "8"
    assert box["command"][-1] == "num_cpus=4,GPU=8"
    assert gpu["spec"]["template"]["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    wcmd = by_name["ray-tpu-worker"]["spec"]["template"]["spec"]["containers"][0]["command"]
    assert wcmd[:3] == ["python", "-m", "ray_tpu_torch.scripts.cli"]
    assert "--address" in wcmd and "ray-tpu-head.default.svc:6379" in wcmd
    # pinned: equal to the reference's manifests but for the module name and
    # the accelerator group, mapped field by field
    ref = jgenerate(workers=3, tpu_workers=2, tpu_chips_per_host=8,
                    tpu_accelerator="v5e-8")
    assert docs == _as_port(ref)
    assert tgenerate(worker_cpu="3500m", worker_memory="16Gi", namespace="ns", name="c",
                     gpu_workers=1, gpus_per_host=2) == \
        _as_port(jgenerate(worker_cpu="3500m", worker_memory="16Gi", namespace="ns", name="c",
                           tpu_workers=1, tpu_chips_per_host=2, tpu_accelerator="v5e-8"), "c")


def test_yaml_roundtrip_and_cli(capsys):
    text = tmanifests_yaml(workers=1)
    docs = list(yaml.safe_load_all(text))
    assert len(docs) == 3 and docs == tgenerate(workers=1)
    rc = tcli_main(["k8s", "--workers", "1", "--gpu-workers", "1"])
    assert rc == 0
    docs = list(yaml.safe_load_all(capsys.readouterr().out))
    assert len(docs) == 4 and docs == tgenerate(workers=1, gpu_workers=1)


def test_operator_surface_imports_without_aiohttp_requests_yaml_or_torch():
    """The new modules import with jax, the JAX package, aiohttp, requests,
    yaml, cloudpickle and triton blocked (the card's host has none of the
    web or YAML packages); the dashboard serves and the manifests render
    there; and the control plane's modules load no torch."""
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton", "aiohttp", "requests", "yaml",
             "cloudpickle"):
    sys.modules[name] = None
import urllib.request
import ray_tpu_torch.scripts.cli, ray_tpu_torch.scripts.k8s, ray_tpu_torch.scripts.status
import ray_tpu_torch.dashboard, ray_tpu_torch.dashboard.__main__
import ray_tpu_torch.job_submission, ray_tpu_torch.job_submission.cluster_jobs
import ray_tpu_torch.util.state, ray_tpu_torch.util.actor_pool, ray_tpu_torch.util.queue
import ray_tpu_torch.cluster_utils
import ray_tpu_torch.cluster.gcs_service, ray_tpu_torch.cluster.node_daemon
from ray_tpu_torch.dashboard import Dashboard
from ray_tpu_torch.scripts.k8s import manifests_yaml
d = Dashboard(port=0, gcs_address="127.0.0.1:1")
try:
    with urllib.request.urlopen(f"http://127.0.0.1:{d.port}/healthz", timeout=30) as r:
        assert r.read() == b"success"
finally:
    d.shutdown()
assert manifests_yaml(gpu_workers=1).count("---") == 3
assert "torch" not in sys.modules, "the operator surface loaded torch"
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=CLI_S)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
