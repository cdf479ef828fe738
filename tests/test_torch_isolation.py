"""The port stands alone: no module of ray_tpu_torch and no line of
chip_smoke.py imports JAX, optax or the JAX package, and the package
imports with JAX, the JAX package and triton made unimportable."""

import os
import re
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|optax|ray_tpu)(\.|\s|$)")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_pattern_separates_the_packages():
    assert FORBIDDEN.match("import jax")
    assert FORBIDDEN.match("from ray_tpu.llm import engine")
    assert FORBIDDEN.match("    import optax")
    assert not FORBIDDEN.match("from ray_tpu_torch.llm import engine")
    assert not FORBIDDEN.match("import jaxlib_free_name")


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if FORBIDDEN.match(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not bad, bad


def test_port_imports_without_jax_triton_or_gpu(tmp_path):
    """Every module of the port imports with jax, optax, ray_tpu, triton,
    aiohttp and cloudpickle blocked, and the plain path runs pipelined and
    speculative decoding, disaggregated serving (in-process and over the
    device fabric), a train step, a task on the in-process runtime, a
    completion over HTTP through ``build_openai_app`` on the CPU, and a
    process-mode task and a task on a port cluster (GCS, node daemon,
    cluster worker) whose function is a closure, with ``cloudpickle``
    blocked in the workers too (a shadow module on ``PYTHONPATH`` that
    raises on import: worker processes do not inherit ``sys.modules``)."""
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton", "aiohttp", "cloudpickle"):
    sys.modules[name] = None
import ray_tpu_torch
import ray_tpu_torch.llm, ray_tpu_torch.llm.decode_loop
import ray_tpu_torch.llm.graphs, ray_tpu_torch.llm.pipeline, ray_tpu_torch.llm.spec
import ray_tpu_torch.ops._build, ray_tpu_torch.ops.ragged
import ray_tpu_torch.ops.attention, ray_tpu_torch.ops.flash
import ray_tpu_torch.nn.layers, ray_tpu_torch.models.llama
import ray_tpu_torch.train, ray_tpu_torch.train.step
import ray_tpu_torch.models.registry, ray_tpu_torch.obs, ray_tpu_torch.util.metrics
import ray_tpu_torch.llm.admission, ray_tpu_torch.llm.openai_api, ray_tpu_torch.llm.batch
import ray_tpu_torch.llm.disagg, ray_tpu_torch.llm.disagg.orchestrator
import ray_tpu_torch.chaos, ray_tpu_torch.obs.slo, ray_tpu_torch.obs.telemetry
import ray_tpu_torch.fabric, ray_tpu_torch.cluster.rpc, ray_tpu_torch.util.backoff
import ray_tpu_torch.llm.kvfetch.plane
import ray_tpu_torch.train.weight_sync, ray_tpu_torch.autoscale, ray_tpu_torch.fleet
import ray_tpu_torch.autoscale.policy, ray_tpu_torch.autoscale.controller
import ray_tpu_torch.autoscale.actuators, ray_tpu_torch.autoscale.demand
import ray_tpu_torch.autoscale.config
import ray_tpu_torch.utils, ray_tpu_torch.core.api, ray_tpu_torch.core.events
import ray_tpu_torch.serve, ray_tpu_torch.serve.proxy
import ray_tpu_torch.native.shm, ray_tpu_torch.core.process_pool
import dataclasses, torch
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import LLAMA_TINY
from ray_tpu_torch.train import TrainState, adamw, make_train_step
assert EngineConfig(model="llama-tiny").model is LLAMA_TINY
eng = LLMEngine(EngineConfig(model=LLAMA_TINY, num_blocks=32, block_size=4,
                             max_num_seqs=2, max_prefill_len=32), device="cpu")
out = eng.generate([[5, 6, 7]], SamplingParams(max_tokens=3, temperature=0.0))
assert len(out[0]) == 3 and eng.stats()["pipeline"]["dispatches"] > 0
from ray_tpu_torch.util.metrics import prometheus_text
assert 'ray_tpu_llm_ttft_seconds_count{model="engine"}' in prometheus_text()
from ray_tpu_torch.llm.spec import SpecConfig
spec = LLMEngine(EngineConfig(model=LLAMA_TINY, num_blocks=32, block_size=4, max_num_seqs=2,
                              max_prefill_len=32, spec=SpecConfig(num_draft_tokens=2)),
                 device="cpu")
assert len(spec.generate([[5, 6, 5, 6, 5]], SamplingParams(max_tokens=4))[0]) == 4
from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator
orch = DisaggOrchestrator(DisaggConfig(engine=EngineConfig(
    model=LLAMA_TINY, num_blocks=32, block_size=4, max_num_seqs=2, max_prefill_len=32)),
    device="cpu")
assert len(orch.generate([[5, 6, 7]], SamplingParams(max_tokens=3, temperature=0.0))[0]) == 3
orch.shutdown()
from ray_tpu_torch.fabric import DeviceKVConnector, DeviceTransport
orch = DisaggOrchestrator(DisaggConfig(engine=EngineConfig(
    model=LLAMA_TINY, num_blocks=32, block_size=4, max_num_seqs=2, max_prefill_len=32),
    connector="device"), device="cpu")
assert len(orch.generate([[5, 6, 7]], SamplingParams(max_tokens=3, temperature=0.0))[0]) == 3
assert orch.stats()["fabric"]["backends"] == {"device": 1}
orch.shutdown()
cfg = dataclasses.replace(LLAMA_TINY, attention_impl="flash", remat=True)
state = TrainState.create(llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                          adamw())
step = make_train_step(lambda p, b: llama.loss_and_weight_fn(p, b, cfg))
toks = torch.randint(0, cfg.vocab_size, (2, 17))
state, m = step(state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
assert torch.isfinite(m["loss"]) and state.step == 1
import json, urllib.request
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMConfig, build_openai_app
ray_tpu_torch.init(num_cpus=4)
assert ray_tpu_torch.get(ray_tpu_torch.remote(lambda x: x + 1).remote(1), timeout=60) == 2
serve.start(host="127.0.0.1", port=0)
build_openai_app(LLMConfig(model_id="iso", engine=EngineConfig(
    model=LLAMA_TINY, num_blocks=32, block_size=4, max_num_seqs=2, max_prefill_len=32),
    device="cpu"))
base = f"http://127.0.0.1:{serve.api._proxy.port}"
req = urllib.request.Request(base + "/v1/completions", data=json.dumps(
    {"prompt": "hi", "max_tokens": 3, "temperature": 0.0}).encode())
assert json.loads(urllib.request.urlopen(req, timeout=60).read())["usage"]["completion_tokens"] == 3
serve.shutdown()
ray_tpu_torch.shutdown()

def make_probe(k):
    def probe(x):
        try:
            import cloudpickle  # noqa: F401
        except ImportError:
            return x + k, os.getpid()
        return "cloudpickle imported in a worker", os.getpid()
    return probe

import os
ray_tpu_torch.init(num_cpus=2, worker_mode="process")
got, pid = ray_tpu_torch.get(ray_tpu_torch.remote(make_probe(41)).remote(1), timeout=60)
assert got == 42 and pid != os.getpid(), got
ray_tpu_torch.shutdown()

import ray_tpu_torch.cluster.gcs_service, ray_tpu_torch.cluster.node_daemon
import ray_tpu_torch.cluster.worker_main, ray_tpu_torch.cluster.client
import ray_tpu_torch.cluster.lockstats, ray_tpu_torch.cluster.runtime_env
import ray_tpu_torch.cluster.serialization, ray_tpu_torch.core.cluster_backend
import ray_tpu_torch.native.framing, ray_tpu_torch.utils.env
from ray_tpu_torch.cluster import LocalCluster
c = LocalCluster(node_death_timeout_s=2.0).start()
try:
    c.add_node({"num_cpus": 1}, node_id="iso")
    c.wait_for_nodes(1)
    ray_tpu_torch.init(address=c.address)
    got, pid = ray_tpu_torch.get(ray_tpu_torch.remote(make_probe(1)).remote(2), timeout=60)
    assert got == 3 and pid != os.getpid(), got
    ray_tpu_torch.shutdown()
finally:
    c.shutdown()
assert c.leftovers() == {"processes": [], "store_files": []}
print("ok")
"""
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    (shadow / "cloudpickle.py").write_text("raise ImportError('cloudpickle is blocked here')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(shadow), REPO]),
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_ha_telemetry_and_chaos_runner_import_without_jax():
    """The GCS's standby, the telemetry plane and the chaos runner import
    with jax, optax, the JAX package and triton blocked, and neither they
    nor the GCS and its standby load torch; chip_smoke.py imports nothing
    of the JAX package."""
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton"):
    sys.modules[name] = None
import ray_tpu_torch.cluster.ha, ray_tpu_torch.chaos.runner, ray_tpu_torch.obs.telemetry
import ray_tpu_torch.cluster.gcs_service
from ray_tpu_torch import chaos
assert chaos.ChaosRunner is ray_tpu_torch.chaos.runner.ChaosRunner
from ray_tpu_torch.cluster.gcs_service import GcsServer
from ray_tpu_torch.cluster.ha import StandbyGcsServer
from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient
primary = GcsServer(port=0)
paddr = primary.start()
sb = StandbyGcsServer(paddr, lease_timeout_s=0.5, poll_wait_s=0.1)
saddr = sb.start()
rc = ReconnectingRpcClient(paddr, saddr, timeout=5.0).connect(retries=5)
rc.call("kv_put", {"ns": "iso", "key": "k", "value": b"v"})
import time
deadline = time.monotonic() + 10
# the write is on the standby (its snapshot or its tail) before the kill
while sb.service.rpc_kv_get({"ns": "iso", "key": "k"}, None) != b"v":
    assert time.monotonic() < deadline, "the standby never saw the write"
    time.sleep(0.02)
primary.stop()
assert sb.promoted.wait(timeout=10)
assert rc.call("kv_get", {"ns": "iso", "key": "k"}, timeout=5) == b"v"
rc.close()
sb.stop()
assert "torch" not in sys.modules, "the control plane loaded torch"
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not [ln for ln in f if FORBIDDEN.match(ln)]


def test_data_imports_and_runs_without_pandas_pyarrow_or_pil():
    """``ray_tpu_torch.data`` imports with pandas, pyarrow and PIL blocked
    (the card's host has none of them) as well as JAX, the JAX package and
    triton, and a dataset runs on the in-process runtime: a map, a sort, a
    groupby, an actor pool, CSV and JSON round trips and the device feed
    on the CPU."""
    code = """
import sys, tempfile
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton", "pandas", "pyarrow", "PIL"):
    sys.modules[name] = None
import numpy as np, torch
import ray_tpu_torch
from ray_tpu_torch import data
from ray_tpu_torch.data import datasources_ext
from ray_tpu_torch.llm import batch
ray_tpu_torch.init(num_cpus=4)
ds = data.range(40, parallelism=4).map(lambda x: x * 2)
assert ds.sort("item", descending=True).take(2) == [78, 76]
assert sorted(r["count()"] for r in data.from_items(
    [{"k": i % 2} for i in range(10)]).groupby("k").count().take_all()) == [5, 5]

class Add:
    def __call__(self, b):
        return {"item": b["item"] + 1}

assert data.range(8).map_batches(Add, concurrency=1).take_all() == list(range(1, 9))
d = tempfile.mkdtemp()
data.from_items([{"a": i} for i in range(5)]).write_csv(d + "/csv")
data.from_items([{"a": i} for i in range(5)]).write_json(d + "/json")
assert sorted(r["a"] for r in data.read_csv(d + "/csv").take_all()) == list(range(5))
assert sorted(r["a"] for r in data.read_json(d + "/json").take_all()) == list(range(5))
fed = list(data.from_numpy({"x": np.arange(6, dtype=np.int32)}).iter_device_batches(
    batch_size=4, device="cpu"))
assert [b["x"].tolist() for b in fed] == [[0, 1, 2, 3], [4, 5]]
ray_tpu_torch.shutdown()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_serve_disagg_and_the_gcs_prefix_index_import_without_jax():
    """Disaggregated Serve, the GCS prefix index and ``build_fabric`` import
    with jax, optax, the JAX package and triton blocked; a GCS that serves
    ``kvtier_*`` never loads torch; a ``GcsPrefixIndex`` over that GCS
    reads and drops its rows; and a disaggregated app answers a completion
    on the CPU in thread mode."""
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton"):
    sys.modules[name] = None
from ray_tpu_torch.cluster.gcs_service import GcsServer
from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient
server = GcsServer(port=0)
host, port = server.start()
rc = ReconnectingRpcClient(host, port, timeout=5).connect()
assert rc.call("kvtier_update", {"engine": "e0", "epoch": 1, "seq": 1,
                                 "rows": [[11, 0, 8], [12, 0, 16]]})["ok"]
assert rc.call("kvtier_lookup", {"hashes": [11, 12]})["engines"]["e0"]["n_tokens"] == 16
assert rc.call("kvtier_stats", None)["rows"] == 2
assert "torch" not in sys.modules, "the GCS's prefix index loaded torch"
import dataclasses, torch
import ray_tpu_torch
import ray_tpu_torch.serve.disagg, ray_tpu_torch.fabric.pool, ray_tpu_torch.llm.kvtier.index
from ray_tpu_torch import serve
from ray_tpu_torch.fabric import build_fabric  # noqa: F401
from ray_tpu_torch.llm import EngineConfig, LLMConfig
from ray_tpu_torch.llm.kvtier import GcsPrefixIndex
from ray_tpu_torch.models.llama import LLAMA_TINY

idx = GcsPrefixIndex(rc, timeout_s=5)
assert idx.lookup([11])["engines"]["e0"]["n_tokens"] == 8 and idx.drop_engine("e0")
ray_tpu_torch.init(num_cpus=8)
lc = LLMConfig(model_id="iso-disagg", engine=EngineConfig(
    model=LLAMA_TINY, num_blocks=32, block_size=4, max_num_seqs=2, max_prefill_len=32),
    device="cpu")
h = serve.build_disagg_openai_app(lc, name="iso-disagg", route_prefix=None)

class Req:
    path, method = "/v1/completions", "POST"

    def json(self):
        return {"prompt": "hi", "max_tokens": 3, "temperature": 0.0}

assert h.remote(Req()).result(timeout_s=60)["usage"]["completion_tokens"] == 3
serve.shutdown()
ray_tpu_torch.shutdown()
rc.close()
server.stop()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_grpc_is_imported_only_inside_the_grpc_ingress():
    """The one ``import grpc`` of the package is in ``GrpcIngress.__init__``;
    ``chip_smoke.py`` imports it only inside its gRPC leg, which runs where
    ``grpc`` is installed."""
    pat = re.compile(r"^\s*(import|from)\s+grpc(\.|\s|$)")
    found = []
    for path in _port_files():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.match(line):
                    found.append((os.path.relpath(path, REPO), line.startswith((" ", "\t"))))
    assert found == [("chip_smoke.py", True), ("ray_tpu_torch/serve/grpc_ingress.py", True)], \
        found


def test_dag_and_rpc_ingress_import_and_run_without_jax_or_grpc():
    """``ray_tpu_torch.dag`` and ``ray_tpu_torch.serve.rpc_ingress`` import
    with jax, optax, the JAX package, triton and grpc blocked; a compiled
    DAG runs over in-process actors and a deployment answers through the
    RPC ingress; only the gRPC ingress needs grpc."""
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton", "grpc"):
    sys.modules[name] = None
import ray_tpu_torch
import ray_tpu_torch.dag, ray_tpu_torch.dag.shm_channel, ray_tpu_torch.dag.socket_channel
import ray_tpu_torch.serve.rpc_ingress, ray_tpu_torch.serve.grpc_ingress
from ray_tpu_torch import serve
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.serve.rpc_ingress import rpc_ingress_call
ray_tpu_torch.init(num_cpus=4)

@ray_tpu_torch.remote
class Stage:
    def __init__(self, k):
        self.k = k

    def apply(self, x):
        return x * self.k

a, b = Stage.remote(2), Stage.remote(5)
with InputNode() as inp:
    dag = b.apply.bind(a.apply.bind(inp)).experimental_compile()
assert [dag.execute(i).get(timeout=60) for i in range(3)] == [0, 10, 20]
dag.teardown()

@serve.deployment
def double(x):
    return 2 * x

serve.run(double.bind(), name="d", route_prefix="/d", _start_proxy=False)
ing = serve.start_rpc_ingress()
assert rpc_ingress_call(ing.addr, 21, timeout=60) == 42
try:
    serve.start_grpc_ingress()
    raise AssertionError("the gRPC ingress started without grpc")
except ImportError:
    pass
serve.shutdown()
ray_tpu_torch.shutdown()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
