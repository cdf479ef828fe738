"""Compiled DAGs over cluster actors, the port against ray_tpu.

- The four scenarios of ``tests/test_dag_cluster.py`` run on each
  package's own cluster (a GCS and two node daemons, ``head`` and ``n1``,
  two CPUs each): a two-stage pipeline and two outputs, over the shm
  channels one host picks and over the TCP channels ``channel_mode=
  "socket"`` forces. The values, and the channel flavor each DAG picked,
  are equal on both packages (band: exact).
- The slice: ``LLAMA_TINY`` in fp32, an engine actor in a worker process
  of a port cluster, its weights the reference engine's (carried over by
  ``params_from_numpy`` through the store). Its greedy tokens through a
  compiled DAG equal that actor's own ``.remote`` pass and the reference
  ``LLMEngine``'s ``generate`` in this process, token for token; after
  ``teardown()`` the actor answers ``.remote`` calls again.

The module shuts down any in-process runtime an earlier file left up and
shuts both packages' clusters down at the end; no process or store file
of the port's cluster outlives it.
"""

import dataclasses
import os
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.cluster import LocalCluster as JLocalCluster
from ray_tpu.core import api as japi
from ray_tpu.core import runtime as jrt
from ray_tpu.dag import InputNode as JInputNode
from ray_tpu.dag import MultiOutputNode as JMultiOutputNode
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.cluster import LocalCluster as TLocalCluster
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.core.serialization import register_pickle_by_value
from ray_tpu_torch.dag import InputNode as TInputNode
from ray_tpu_torch.dag import MultiOutputNode as TMultiOutputNode

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

# the workers are spawned clean: this module's classes go by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])
register_pickle_by_value(sys.modules[__name__])

WAIT_S = 60  # every get of a DAG result or an actor call fails past this

PKGS = {"ref": (japi, JLocalCluster, JInputNode, JMultiOutputNode),
        "port": (ray_tpu_torch, TLocalCluster, TInputNode, TMultiOutputNode)}


def _down_in_process():
    for serve, runtime in ((jserve, jrt), (tserve, trt)):
        serve.shutdown()
        if runtime.is_initialized():
            runtime.shutdown_runtime()


@pytest.fixture(scope="module")
def clusters():
    """Each package's cluster, started on its first use and attached; both
    shut down after the module."""
    _down_in_process()
    up: dict = {}

    def get(name):
        if name not in up:
            api, cluster_cls, _, _ = PKGS[name]
            c = cluster_cls(node_death_timeout_s=2.0)
            up[name] = c
            c.start()
            c.add_node({"num_cpus": 2}, node_id="head")
            c.add_node({"num_cpus": 2}, node_id="n1")
            c.wait_for_nodes(2)
            api.init(address=c.address)
        return up[name]

    yield get
    for name, c in up.items():
        try:
            PKGS[name][0].shutdown()
        finally:
            c.shutdown()
    if "port" in up:
        left = up["port"].leftovers()
        assert left == {"processes": [], "store_files": []}, left
    _down_in_process()


class Stage:
    def __init__(self, add):
        self.add = add

    def apply(self, x):
        return x + self.add

    def pid(self):
        import os

        return os.getpid()


def _stages(api, *adds):
    cls = api.remote(Stage)
    return [cls.options(num_cpus=1).remote(a) for a in adds]


def _pipeline(api, inp_cls, multi, mode, n):
    a, b = _stages(api, 1, 10)
    pids = api.get([a.pid.remote(), b.pid.remote()], timeout=WAIT_S)
    with inp_cls() as inp:
        out = b.apply.bind(a.apply.bind(inp))
    dag = out.experimental_compile(**({"channel_mode": mode} if mode else {}))
    try:
        got = [dag.execute(i).get(timeout=WAIT_S) for i in range(n)]
        kind = type(dag._input_channel).__name__
    finally:
        dag.teardown()
        api.kill(a)
        api.kill(b)
    distinct = pids[0] != pids[1] and os.getpid() not in pids
    return got, kind, distinct


def _multi(api, inp_cls, multi, mode, adds, xs):
    a, b = _stages(api, *adds)
    with inp_cls() as inp:
        dag = multi([a.apply.bind(inp), b.apply.bind(inp)])
    compiled = dag.experimental_compile(**({"channel_mode": mode} if mode else {}))
    try:
        got = [compiled.execute(x).get(timeout=WAIT_S) for x in xs]
        kind = type(compiled._input_channel).__name__
    finally:
        compiled.teardown()
        api.kill(a)
        api.kill(b)
    compiled.teardown()  # idempotent, no loop left parked
    return got, kind


SCENARIOS = {
    "shm_channel_cross_process_pipeline": (
        lambda *p: _pipeline(*p, None, 5), ([i + 11 for i in range(5)], "ShmChannel", True)),
    "shm_channel_multi_output": (
        lambda *p: _multi(*p, None, (1, 2), (100,)), ([[101, 102]], "ShmChannel")),
    "socket_channel_cross_node_pipeline": (
        lambda *p: _pipeline(*p, "socket", 6), ([i + 11 for i in range(6)], "SocketChannel",
                                                True)),
    "socket_channel_multi_output_and_close": (
        lambda *p: _multi(*p, "socket", (5, 50), (100, 1)),
        ([[105, 150], [6, 51]], "SocketChannel")),
}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dag_cluster_scenarios_equal_on_both_packages(clusters, scenario, pkg):
    """Each package on its own cluster gives the reference scenario's
    values over the channel flavor the reference picks."""
    clusters(pkg)
    api, _, inp_cls, multi = PKGS[pkg]
    run, want = SCENARIOS[scenario]
    assert run(api, inp_cls, multi) == want


# -- the slice: LLAMA_TINY fp32 behind a compiled DAG in a port cluster worker --

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
ENGINE = dict(num_blocks=128, block_size=4, max_num_seqs=8, max_prefill_len=64)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in [5, 37, 9, 52, 14, 23]]


class TinyServer:
    """A port engine on the worker's CPU, built from a reference params
    tree (nested dicts of numpy arrays) that arrived through the store."""

    def __init__(self, tree):
        import dataclasses
        import os

        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMEngine
        from ray_tpu_torch.models import llama

        torch.set_num_threads(2)
        cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
        params = llama.params_from_numpy(tree, cfg, device="cpu")
        self.eng = LLMEngine(EngineConfig(model=cfg, **ENGINE), params=params, device="cpu")
        self.pid = os.getpid()

    def generate(self, prompts, max_tokens):
        from ray_tpu_torch.llm import SamplingParams

        return self.eng.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                                         ignore_eos=True))

    def info(self):
        return self.pid


def test_tiny_llama_actor_behind_a_compiled_dag_equals_remote_and_reference(clusters):
    ref = JLLMEngine(JEngineConfig(model=J_FP32_TINY, **ENGINE), seed=0)
    want = ref.generate(_prompts(), JSamplingParams(max_tokens=16, temperature=0.0,
                                                    ignore_eos=True))
    tree = jax.tree.map(np.asarray, ref.params)
    clusters("port")
    server = ray_tpu_torch.remote(TinyServer).remote(ray_tpu_torch.put(tree))
    try:
        remote = ray_tpu_torch.get(server.generate.remote(_prompts(), 16), timeout=WAIT_S)
        with TInputNode() as inp:
            dag = server.generate.bind(inp.prompts, inp.max_tokens)
        compiled = dag.experimental_compile()
        try:
            assert compiled.channel_kind == "shm"
            via_dag = [compiled.execute({"prompts": _prompts(), "max_tokens": 16})
                       .get(timeout=WAIT_S) for _ in range(2)]
        finally:
            compiled.teardown()
        # the exec loop returned: the actor serves .remote calls again
        pid = ray_tpu_torch.get(server.info.remote(), timeout=30)
    finally:
        ray_tpu_torch.kill(server)
    assert remote == want
    assert via_dag == [want, want]
    assert pid != os.getpid()
