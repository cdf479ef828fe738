#!/usr/bin/env python3
"""Where a Serve deployment of the torch engine spends a pass, on one GPU.

    python3 scripts/port_serve_diag.py [--turns 3]

Deploys chip_smoke.py's serve-phase app (LLAMA3_8B bf16, random weights
from torch seed 0, ENGINE_KW, ``build_openai_app`` on the in-process
runtime, the stdlib HTTP proxy on a free loopback port) and serves the api
traffic (12 completions, 2 chats, 2 streams) one direct pass first (the
replica's LLMServer from this thread's event loop, chip_smoke's
``_api_pass``), then ``--turns`` rounds of a handle pass (every request
through the app handle from its own client thread) and an HTTP pass
(chip_smoke's ``_serve_pass``), then a direct pass. Per pass, one JSON
line: wall and tok/s; the engine's steps and their host ms (``step``
wrapped on the instance) and those over 0.1 s with the rows running and
waiting; every CUDA graph capture (``CUDAGraph.capture_begin`` to
``capture_end``, and ``capture_end`` alone: the graph's instantiation);
each request's arrival on the engine and the time its last output was
delivered (the runner's ``_deliver`` wrapped on the instance), from the
pass's start. Needs CUDA (exits 1 without it). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _time_captures(caps: list) -> None:
    """Wrap CUDAGraph.capture_begin/capture_end on the class: each capture
    appends (wall time, begin -> end ms, end ms, thread name) to ``caps``."""
    import torch

    graph = torch.cuda.CUDAGraph
    begin, end = graph.capture_begin, graph.capture_end

    def timed_begin(self, *a, **k):
        self._diag_t0 = time.perf_counter()
        return begin(self, *a, **k)

    def timed_end(self, *a, **k):
        t0 = time.perf_counter()
        out = end(self, *a, **k)
        t1 = time.perf_counter()
        caps.append((time.time(), 1e3 * (t1 - getattr(self, "_diag_t0", t0)), 1e3 * (t1 - t0),
                     threading.current_thread().name))
        return out

    graph.capture_begin, graph.capture_end = timed_begin, timed_end


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_serve_diag: CUDA is not available", file=sys.stderr)
        return 1
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, build_openai_app
    from ray_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    params, _ = cs.params_8b(dev)
    caps: list = []
    _time_captures(caps)

    ray_tpu_torch.init()
    port = cs._free_port()
    serve.start(host="127.0.0.1", port=port)
    base = f"http://127.0.0.1:{port}"
    cfg = EngineConfig(model="llama3-8b", **cs.ENGINE_KW)
    handle = build_openai_app(LLMConfig(model_id="llama3-8b", engine=cfg, params=params,
                                        tokenizer=cs.IdTextTokenizer(cfg.model.vocab_size)),
                              route_prefix="/")
    server = cs._replica_server()
    eng = server.engine
    recorded = cs._record_requests(eng)
    bodies, chats, streams = cs._api_traffic()

    steps: list = []
    step = eng.step

    def timed_step():
        t0 = time.perf_counter()
        out = step()
        steps.append((time.time(), time.perf_counter() - t0, len(eng.running), len(eng.waiting)))
        return out

    eng.step = timed_step
    done: dict = {}
    deliver = server.runner._deliver

    def timed_deliver(out):
        deliver(out)
        if out.finished:
            done[out.request_id] = time.time()

    server.runner._deliver = timed_deliver

    def handle_pass():
        recorded.clear()
        server.runner.call(lambda: eng.allocator.drop_prefix_cache())

        def stream(p):
            return "".join(handle.options(method_name="generate_stream", stream=True).remote(
                p, max_tokens=32, temperature=0.0))

        torch.cuda.synchronize()
        with ThreadPoolExecutor(len(bodies) + len(chats) + len(streams)) as pool:
            t0 = time.perf_counter()
            futs = ([pool.submit(lambda b: handle.completions.remote(b).result(), b)
                     for b in bodies]
                    + [pool.submit(lambda b: handle.chat_completions.remote(b).result(), b)
                       for b in chats]
                    + [pool.submit(stream, p) for p in streams])
            for f in futs:
                f.result()
            wall = time.perf_counter() - t0
        tokens = sum(len(r.output_token_ids) for r in recorded.values())
        return {"wall_s": wall, "output_tok_per_s": tokens / wall}

    passes = {
        "direct": lambda: cs._api_pass(server, recorded, bodies, chats, streams),
        "handle": handle_pass,
        "http": lambda: cs._serve_pass(base, handle, server, recorded, bodies, chats, streams),
    }

    def run(kind: str) -> None:
        steps.clear()
        done.clear()
        del caps[:]
        t_wall = time.time()
        r = passes[kind]()
        print(json.dumps({
            "kind": kind, "wall_s": r["wall_s"], "tok_per_s": r["output_tok_per_s"],
            "steps": len(steps), "step_ms_sum": 1e3 * sum(d for _, d, _, _ in steps),
            "long_steps(t,ms,running,waiting)": [(t - t_wall, 1e3 * d, run_, wait)
                                                 for t, d, run_, wait in steps if d > 0.1],
            "captures(t,total_ms,end_ms,thread)": [(t - t_wall, total, end, th)
                                                   for t, total, end, th in caps],
            "arrivals_s": sorted(rq.arrival - t_wall for rq in recorded.values()),
            "engine_done_s": sorted(done[rid] - t_wall for rid in recorded if rid in done),
        }), flush=True)

    run("direct")
    for _ in range(args.turns):
        run("handle")
        run("http")
    run("direct")
    serve.shutdown()
    ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
