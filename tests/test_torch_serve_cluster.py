"""Serve over the port's cluster runtime: controller and replicas are cluster
actors in worker PROCESSES when the driver is attached, the same deployment
code that runs on in-process threads.

``tests/test_serve_cluster.py``'s scenario on ``ray_tpu_torch``, then a
disaggregated app on the cluster: a prefill and a decode replica in worker
processes handing KV over the ``"rpc"`` connector, and an ingress given a
``GcsPrefixIndex`` over the cluster's GCS. Its LLAMA_TINY fp32 text equals
the reference's colocated ``LLMServer`` on the same weights, its pools are
role-tagged, and a snapshot published into the GCS's index under the decode
replica's key routes the next request by prefix. Every wait has its own
limit, and the cluster is checked to leave no process and no store file.
"""

import asyncio
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.openai_api import LLMConfig as JLLMConfig
from ray_tpu.llm.openai_api import LLMServer as JLLMServer
from ray_tpu.models import llama as jllama
from ray_tpu_torch import serve
from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.core import api
from ray_tpu_torch.core.serialization import register_pickle_by_value
from ray_tpu_torch.llm import EngineConfig, LLMConfig
from ray_tpu_torch.llm.kvtier import GcsPrefixIndex, chain_hashes
from ray_tpu_torch.llm.openai_api import ByteTokenizer
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.disagg import DecodeServer, DisaggIngress, PrefillServer

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60

# test functions and classes must travel by value: the worker processes have
# no tests/ on their import path
register_pickle_by_value(sys.modules[__name__])

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_llm_disagg.py's engine_config
ENGINE_KW = dict(num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=64)
BODY = {"prompt": "serve disagg on a cluster", "max_tokens": 6, "temperature": 0.0}


class Req:
    def __init__(self, path, method, body=None):
        self.path, self.method, self._b = path, method, body

    def json(self):
        return self._b


@pytest.fixture(scope="module")
def attached_cluster():
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        c.add_node({"num_cpus": 4}, node_id="head")
        c.add_node({"num_cpus": 4}, node_id="n1")
        c.wait_for_nodes(2)
        api.init(address=c.address, ignore_reinit_error=True)
        yield c
    finally:
        serve.shutdown()
        api.shutdown()
        c.shutdown()
        left = c.leftovers()
        assert left == {"processes": [], "store_files": []}, left


def test_serve_replicas_are_worker_processes(attached_cluster):
    @serve.deployment(num_replicas=2)
    class Doubler:
        def __call__(self, x):
            import os as _os

            return {"y": 2 * x, "pid": _os.getpid(),
                    "node": _os.environ.get("RAY_TPU_NODE_ID")}

    h = serve.run(Doubler.bind(), name="capp", route_prefix=None)
    outs = [h.remote(i).result(timeout_s=WAIT_S) for i in range(10)]
    assert [o["y"] for o in outs] == [2 * i for i in range(10)]
    pids = {o["pid"] for o in outs}
    assert os.getpid() not in pids, "replica ran in the driver process"
    assert all(o["node"] in ("head", "n1") for o in outs)
    serve.delete("capp")


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


def test_disagg_app_over_rpc_with_a_gcs_prefix_index(attached_cluster, weights):
    srv = JLLMServer(JLLMConfig(model_id="t-ref", engine=JEngineConfig(model=J_FP32_TINY,
                                                                       **ENGINE_KW),
                                params=weights[0]))
    try:
        expected = asyncio.run(srv.completions(dict(BODY)))["choices"][0]["text"]
    finally:
        srv.shutdown()

    lc = LLMConfig(model_id="t-cl", engine=EngineConfig(model=FP32_TINY, **ENGINE_KW),
                   params=weights[1], device="cpu")
    name = "disagg-cluster"
    index = GcsPrefixIndex(attached_cluster.client().gcs, timeout_s=5)
    prefill = serve.deployment(PrefillServer, name="Prefill:t-cl", role="prefill")
    decode = serve.deployment(DecodeServer, name="Decode:t-cl", role="decode")
    ingress = serve.deployment(DisaggIngress, name="DisaggIngress:t-cl")
    app = ingress.bind(lc, prefill.bind(lc, "rpc", name), decode.bind(lc, "rpc", name), name,
                       index=index)
    handle = serve.run(app, name=name, route_prefix=None)
    resp = handle.remote(Req("/v1/completions", "POST", dict(BODY))).result(timeout_s=WAIT_S)
    assert resp["choices"][0]["text"] == expected
    assert resp["usage"]["completion_tokens"] == BODY["max_tokens"]
    roles = {n: d.get("role") for a in serve.status()["applications"].values()
             for n, d in a["deployments"].items()}
    assert roles["Prefill:t-cl"] == "prefill" and roles["Decode:t-cl"] == "decode"

    # the replicas are worker processes; the decode replica's connector
    # target is an RPC address
    dh = serve.get_deployment_handle("Decode:t-cl", name)
    (rid,) = dh._get_router().replica_ids()
    target = dh.options(pin_replica=rid).kv_target.remote().result(timeout_s=WAIT_S)
    assert isinstance(target, tuple) and len(target) == 3, target
    stats = dh.options(pin_replica=rid).stats.remote().result(timeout_s=WAIT_S)
    assert stats["connector"]["connector"] == "rpc" and stats["connector"]["num_received"] == 1

    # the ingress reads the GCS's index: a snapshot published there under
    # the decode replica's key routes the next request by prefix
    key = dh.options(pin_replica=rid).index_key.remote().result(timeout_s=WAIT_S)
    ids = ByteTokenizer(FP32_TINY.vocab_size).encode(BODY["prompt"])
    hashes = chain_hashes(ids, ENGINE_KW["block_size"])
    assert hashes
    rows = [[h, 0, (i + 1) * ENGINE_KW["block_size"]] for i, h in enumerate(hashes)]
    assert index.update({"engine": key, "epoch": 1, "seq": 1, "rows": rows})
    assert index.lookup(hashes)["engines"][key]["n_tokens"] == len(hashes) * 8
    before = handle.stats.remote().result(timeout_s=WAIT_S)["prefix_routed"]
    resp = handle.remote(Req("/v1/completions", "POST", dict(BODY))).result(timeout_s=WAIT_S)
    assert resp["choices"][0]["text"] == expected
    st = handle.stats.remote().result(timeout_s=WAIT_S)
    assert st["prefix_routed"] > before and st["reprefills"] == 0
    assert index.drop_engine(key) and index.num_dark == 0
    serve.delete(name)
