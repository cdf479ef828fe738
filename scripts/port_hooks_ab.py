#!/usr/bin/env python3
"""Host cost of the torch engine's observability hooks at LLAMA3_8B, on one GPU.

    python3 scripts/port_hooks_ab.py [--pairs 4]

Builds chip_smoke.py's engine (LLAMA3_8B bf16, random weights from torch
seed 0, ENGINE_KW) and serves its 12 requests: three passes to capture the
graphs, then ``--pairs`` pairs of passes in turns (off on on off ...) with
every observability hook made a no-op on the engine instance ("off") or
timed by wrappers on it ("on"; chip_smoke's ``_ab_pass``), then two
pairs in turns under a device-events-only profiler. Per pass: wall,
tok/s, the hooks' host ms (outermost calls, and by hook inclusive), the
interpreter's garbage-collection pauses, and for the profiled passes the
device's idle share. Then host-only micro-timings of
one span record and one request's SLO record. One JSON line per reading;
needs CUDA (exits 1 without it). Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _micro(n: int = 5000) -> dict:
    """Host µs of one span record and one finished request's SLO record."""
    from ray_tpu_torch import obs
    from ray_tpu_torch.obs import slo
    from ray_tpu_torch.obs.recorder import SpanRecorder

    rec = SpanRecorder()
    ctx = obs.new_context()
    t0 = time.perf_counter()
    for i in range(n):
        rec.record("engine.decode_chunk", 1.0, 2.0, ctx=ctx,
                   attrs={"n_steps": 8, "new_tokens": 8, "active_ms": 1.0})
    span_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for i in range(n):
        slo.record_request_slo("micro", ttft_s=0.1, tpot_s=0.01, queue_wait_s=0.01, e2e_s=1.0,
                               finish_reason="length", prefill_span_s=0.05)
    slo_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for i in range(n):
        os.urandom(8).hex()
    urandom_us = (time.perf_counter() - t0) / n * 1e6
    return {"span_record_us": span_us, "request_slo_record_us": slo_us,
            "span_id_urandom_us": urandom_us}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_hooks_ab: CUDA is not available", file=sys.stderr)
        return 1
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import LLAMA3_8B

    dev = torch.device("cuda", 0)
    cs.emit({"nvidia_smi": cs.nvidia_smi_line(), "torch": torch.__version__})
    params, _ = cs.params_8b(dev)
    eng = LLMEngine(EngineConfig(model=LLAMA3_8B, **cs.ENGINE_KW), params=params, device=dev)
    prompts, sps = cs._engine_traffic(LLAMA3_8B)
    first = None
    for k in range(3):  # graph captures
        finals, _, wall, _ = cs._serve(eng, prompts, sps, "r" if k == 0 else f"c{k}")
        if k == 0:
            first = finals
        cs.emit({"warmup_pass": k, "wall_s": wall})
    order = []
    for p in range(args.pairs):
        order += ["off", "on"] if p % 2 == 0 else ["on", "off"]
    passes = [cs._ab_pass(eng, prompts, sps, first, side, "a" if side == "off" else "b",
                          profiled=False)
              for side in order]
    for p in passes:
        cs.emit(p)
    # the profiled passes in turns too: a first pass after a switch may
    # pay what the second does not
    profiled = [cs._ab_pass(eng, prompts, sps, first, side, "p", profiled=True)
                for side in ("off", "on", "on", "off")]
    for p in profiled:
        cs.emit({"profiled": True, **p})

    def med(side, key):
        vals = sorted(p[key] for p in passes if p["side"] == side and not p["graphs_captured"])
        return vals[len(vals) // 2] if vals else None

    cs.emit({"summary": True, "order": "".join(s[1] for s in order),
             "tok_per_s_median": {s: med(s, "output_tok_per_s") for s in ("off", "on")},
             "wall_s_median": {s: med(s, "wall_s") for s in ("off", "on")},
             "hooks_ms_per_on_pass": [p["hooks"]["host_ms"] for p in passes if p["side"] == "on"],
             "profiled_idle_share": {s: [p["device_idle_share"] for p in profiled
                                         if p["side"] == s] for s in ("off", "on")},
             "micro": _micro()})
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
