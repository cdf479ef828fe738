"""The GCS-hosted KV prefix index of ray_tpu_torch (the GCS's ``kvtier_*``
RPCs and ``llm.kvtier.GcsPrefixIndex``) held against ray_tpu's on the CPU.

 * ``tests/test_llm_kvtier.py:408`` on both packages, each against its own
   GCS server: updates, lookups (equal once ``age_s`` is set aside), the
   store's stats, a STALL_GCS window answered dark within the bound
   (``num_dark == 2``), and an orderly drop after which the key registers
   again;
 * one seeded snapshot sequence (updates, a stale epoch, a replayed seq, a
   drop, an expiry) through both ``GcsService`` objects with equal answers;
 * ``tests/test_llm_kvfetch.py:395``: a tiered engine whose index is a dark
   GCS serves its local tiers only, in bounded time, with the reference
   engine's fp32 tokens.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu.cluster.gcs_service import GcsServer as JGcsServer
from ray_tpu.cluster.gcs_service import GcsService as JGcsService
from ray_tpu.cluster.rpc import ReconnectingRpcClient as JReconnectingRpcClient
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.kvfetch import LocalFetchClient as JLocalFetchClient
from ray_tpu.llm.kvfetch import LocalFetchRegistry as JLocalFetchRegistry
from ray_tpu.llm.kvtier import GcsPrefixIndex as JGcsPrefixIndex
from ray_tpu.llm.kvtier.index import best_prefix_replica as j_best_prefix_replica
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch import chaos
from ray_tpu_torch.cluster.gcs_service import GcsServer, GcsService
from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.kvfetch import LocalFetchClient, LocalFetchRegistry
from ray_tpu_torch.llm.kvtier import GcsPrefixIndex, best_prefix_replica, chain_hashes
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

BS = 16
SYS = [int(x) for x in np.random.RandomState(0).randint(3, 200, size=5 * BS)]  # 80 tokens
J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(num_blocks=16, block_size=BS, max_num_seqs=4, max_prefill_len=128)
PKG = {
    "ref": dict(server=JGcsServer, client=JReconnectingRpcClient, index=JGcsPrefixIndex,
                chaos=jchaos, best=j_best_prefix_replica),
    "port": dict(server=GcsServer, client=ReconnectingRpcClient, index=GcsPrefixIndex,
                 chaos=chaos, best=best_prefix_replica),
}


def _suffix(seed, n=BS):
    return [int(x) for x in np.random.RandomState(seed).randint(3, 200, size=n)]


def _no_age(lookup):
    if lookup is None:
        return None
    return {"engines": {k: {f: v for f, v in e.items() if f != "age_s"}
                        for k, e in lookup["engines"].items()}}


def _gcs_index_scenario(pkg) -> list:
    """tests/test_llm_kvtier.py:408 on one package; returns what it saw."""
    p = PKG[pkg]
    seen = []
    server = p["server"](port=0)
    host, port = server.start()
    try:
        client = p["client"](host, port, timeout=5).connect()
        idx = p["index"](client, timeout_s=5)
        rows = [[h, 1, (i + 1) * BS] for i, h in enumerate(chain_hashes(SYS, BS))]
        assert idx.update({"engine": "d0", "epoch": 1, "seq": 1, "rows": rows})
        got = idx.lookup(chain_hashes(SYS, BS))
        assert got["engines"]["d0"] == {"tier": "host", "n_tokens": len(SYS),
                                        "age_s": got["engines"]["d0"]["age_s"]}
        assert p["best"](got, {"d0": 0}) == "d0"
        seen += [_no_age(got), server.service.prefix_index.stats()]
        assert seen[-1]["rows"] == len(rows)
        p["chaos"].install(p["chaos"].FaultSchedule(11, [
            p["chaos"].FaultSpec(p["chaos"].STALL_GCS, site="gcs.call", max_fires=4),
        ]))
        try:
            # dark window: every call fails fast -> None, no hang
            t0 = time.monotonic()
            assert idx.lookup(chain_hashes(SYS, BS)) is None
            assert not idx.update({"engine": "d0", "epoch": 1, "seq": 2, "rows": rows})
            assert time.monotonic() - t0 < 5.0
            assert idx.num_dark == 2
            assert p["best"](idx.lookup(chain_hashes(SYS, BS)), {"d0": 0}) is None
        finally:
            p["chaos"].uninstall()
        seen.append(idx.num_dark)
        # the plane came back: the same index answers again
        got = idx.lookup(chain_hashes(SYS, BS))
        assert got["engines"]["d0"]["n_tokens"] == len(SYS)
        # an orderly drop removes the rows WITHOUT poisoning the key
        assert idx.drop_engine("d0")
        seen.append(_no_age(idx.lookup(chain_hashes(SYS, BS))))
        assert seen[-1]["engines"] == {}
        assert idx.update({"engine": "d0", "epoch": 1, "seq": 3, "rows": rows})
        seen += [_no_age(idx.lookup(chain_hashes(SYS, BS))),
                 server.service.prefix_index.stats()]
        client.close()
    finally:
        server.stop()
    return seen


def test_gcs_prefix_index_rpcs_and_stall_gcs_fallback():
    ref, port = _gcs_index_scenario("ref"), _gcs_index_scenario("port")
    assert port == ref
    assert port[2] == 3  # the two dark calls and the ladder's probe


def _snapshots():
    """A seeded sequence of kvtier RPCs over three engines: updates, a stale
    epoch, a replayed seq, lookups, a drop and an expiry."""
    rng = np.random.default_rng(17)
    hashes = [int(h) for h in rng.integers(1, 2**62, 12)]

    def rows(n, tier):
        return [[h, tier, (i + 1) * 8] for i, h in enumerate(hashes[:n])]

    return [
        ("update", {"engine": "e0", "epoch": 2, "seq": 1, "rows": rows(6, 0)}),
        ("update", {"engine": "e1", "epoch": 1, "seq": 1, "rows": rows(9, 1)}),
        ("lookup", {"hashes": hashes}),
        ("update", {"engine": "e0", "epoch": 1, "seq": 9, "rows": rows(12, 0)}),  # stale epoch
        ("update", {"engine": "e1", "epoch": 1, "seq": 1, "rows": rows(3, 2)}),   # replayed seq
        ("lookup", {"hashes": hashes[:4]}),
        ("update", {"engine": "e2", "epoch": 1, "seq": 1, "rows": rows(12, 2),
                    "fetch_addr": ["127.0.0.1", 7001]}),
        ("update", {"engine": "e1", "epoch": 1, "seq": 2, "rows": rows(2, 0)}),
        ("lookup", {"hashes": hashes}),
        ("stats", None),
        ("drop", {"engine": "e1"}),
        ("lookup", {"hashes": hashes}),
        ("expire", "e2"),
        ("stats", None),
        ("lookup", {"hashes": hashes}),
        ("lookup", {}),
    ]


def test_kvtier_rpcs_answer_as_the_reference_gcs():
    answers = {}
    for name, cls in (("ref", JGcsService), ("port", GcsService)):
        gcs = cls()
        out = []
        for op, payload in _snapshots():
            if op == "expire":
                # silent past the store's expire horizon
                gcs.prefix_index._engines[payload].ts -= 10 * gcs.prefix_index.expire_after_s
                continue
            got = getattr(gcs, f"rpc_kvtier_{op}")(payload, None)
            out.append(_no_age(got) if op == "lookup" else got)
        answers[name] = out
    assert answers["port"] == answers["ref"]
    assert answers["port"][3]["ok"] is False  # the stale epoch was dropped
    assert answers["port"][-1] == {"engines": {}}


def _gen(eng, prompt, sp, rid, prefetch_wait=False):
    eng.add_request(prompt, sp, request_id=rid)
    if prefetch_wait:
        assert eng.kvfetch.wait_idle(30)
    toks = cached = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished and o.request_id == rid:
                toks, cached = list(o.output_token_ids), o.num_cached_tokens
    assert toks is not None
    return toks, cached


def _dark_gcs_fetch(pkg, weights) -> tuple:
    """tests/test_llm_kvfetch.py:395 on one package: (tokens, cached)."""
    p = PKG[pkg]
    Sp = SamplingParams if pkg == "port" else JSamplingParams
    server = p["server"](port=0)
    host, port = server.start()
    client = eng = None
    try:
        client = p["client"](host, port, timeout=5).connect()
        idx = p["index"](client, timeout_s=2)
        if pkg == "port":
            reg = LocalFetchRegistry()
            eng = LLMEngine(EngineConfig(model=FP32_TINY, kvtier=True, **ENGINE_KW),
                            params=weights[1], device="cpu")
            fetch_client = LocalFetchClient(reg)
        else:
            reg = JLocalFetchRegistry()
            eng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, kvtier=True, **ENGINE_KW),
                             params=weights[0], seed=0)
            fetch_client = JLocalFetchClient(reg)
        eng.kvtier.attach_index(idx, engine_key="e0")
        reg.register("e0", eng.kvtier)
        eng.kvfetch.attach(fetch_client)
        warm = Sp(max_tokens=4, temperature=0.0)
        _gen(eng, SYS + _suffix(1), warm, "gcs-warm", prefetch_wait=True)
        for i in range(4):
            fill = [int(x) for x in np.random.RandomState(100 + i).randint(3, 200, size=112)]
            _gen(eng, fill, warm, f"gcs-fill-{i}", prefetch_wait=True)
        eng.kvtier.flush_spills()
        p["chaos"].install(p["chaos"].FaultSchedule(11, [
            p["chaos"].FaultSpec(p["chaos"].STALL_GCS, site="gcs.call", max_fires=8),
        ]))
        try:
            t0 = time.monotonic()
            toks, cached = _gen(eng, SYS + _suffix(2), Sp(max_tokens=8, temperature=0.0),
                                "the-req", prefetch_wait=True)
            assert time.monotonic() - t0 < 30.0  # bounded: no hang
        finally:
            p["chaos"].uninstall()
        # the local tiers still served the prefix (the index is a remote-
        # discovery surface, not a local-correctness dependency)
        assert cached >= len(SYS)
        return toks, cached
    finally:
        if eng is not None:
            eng.kvfetch.close()
            eng.kvtier.stop()
        if client is not None:
            client.close()
        server.stop()


def test_stall_gcs_fetch_degrades_to_local_tiers_only():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    weights = (jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY,
                                            device="cpu"))
    port = _dark_gcs_fetch("port", weights)
    assert port == _dark_gcs_fetch("ref", weights)
    plain = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=weights[1],
                      device="cpu")
    assert port[0] == _gen(plain, SYS + _suffix(2),
                           SamplingParams(max_tokens=8, temperature=0.0), "the-req")[0]
