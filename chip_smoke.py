#!/usr/bin/env python3
"""Smoke run of the ray_tpu_torch serving path on one NVIDIA H100.

    python3 chip_smoke.py          # one card, no arguments

Phases, each printing one JSON line:

  device   card name and power limit; TF32 off for matmuls and cuDNN, so
           fp32 means fp32 on the card
  build    compile the CUDA kernels from ops/csrc (one nvcc per source,
           started together)
  kernels  each kernel against its plain PyTorch version at the LLAMA3_8B
           engine shapes (H 32, KVH 8, D 128, block_size 16) and at D 64,
           in bf16 (band 2e-2) and fp32 (band 2e-5); times from CUDA
           events (median of 30 after warm-up) beside the bytes/operations
           bound and a PyTorch yardstick (scaled_dot_product_attention on
           K/V already gathered dense, gather excluded; the port never
           calls it)
  engine   LLMEngine at LLAMA3_8B width (bf16, 32 layers, random weights
           from a seeded generator on the card), mixed batching, 12
           requests; the kernels' launch counters are zeroed just before
           and read just after
  parity   a reduced fp32 model served by the same engine on the card
           (kernels) and on the CPU (plain versions): identical greedy
           tokens, mixed batching on and off

The engine phase then serves the same requests twice more: warm (its
numbers say what the first pass spent on first-call costs) and under
torch.profiler (device busy time and idle share, time by kernel).

Then the line {"kernels": [...]}, the nvidia-smi name/power line, and
last {"ok": true, "device": {...}}. Any failed check raises, so the
script exits non-zero and prints no result line. Without CUDA it exits 1
before printing anything. Imports nothing of JAX or of ray_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                                  # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}    # dense; fp32 without tensor cores
BANDS = {"bfloat16": 2e-2, "float32": 2e-5}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _paged_case(gen, dev, dtype, B, H, KVH, D, bs, ctx_lens, MB):
    """Random q and cache, distinct random pages per sequence; table
    columns past a sequence's context hold 0, as the engine pads them."""
    import torch

    num_blocks = B * MB
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(KVH, num_blocks * bs + bs, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(KVH, num_blocks * bs + bs, D, generator=gen, device=dev).to(dtype)
    bt = torch.randperm(num_blocks, generator=gen, device=dev).reshape(B, MB).int()
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device=dev)
    pages = (ctx + bs - 1) // bs
    bt = torch.where(torch.arange(MB, device=dev)[None, :] < pages[:, None], bt, 0).int()
    return q, k, v, bt.contiguous(), ctx


def _bound(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, got, ref, dtype_name, results):
    import torch

    err = float((got.float() - ref.float()).abs().max())
    band = BANDS[dtype_name]
    results.append({"check": name, "dtype": dtype_name, "max_abs_err": err, "band": band})
    if not (err <= band and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} [{dtype_name}]: max abs err {err} > {band}")
    return err


def kernels_phase(dev) -> dict:
    """Hold each kernel against its plain version and time both; returns
    the per-kernel numbers of the bf16 engine-shape cases."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda, paged_attention_torch
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda, ragged_attention_torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    bs, MB = 16, 128  # 8B engine: block_size 16, contexts up to 2048
    checks: list = []
    summary: dict = {}
    sdpa_gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)

    def dense_kv(k, v, bt, KVH):
        # [B, KVH, S, D]: the K/V pages gathered dense, for the yardstick
        offs = torch.arange(bt.shape[1] * bs, device=dev)
        slots = bt.long()[:, offs // bs] * bs + offs % bs
        kd = k[:, slots].permute(1, 0, 2, 3).contiguous()
        vd = v[:, slots].permute(1, 0, 2, 3).contiguous()
        return kd, vd

    def sdpa(qd, kd, vd, mask, H, KVH):
        if sdpa_gqa:
            return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, enable_gqa=True)
        ke, ve = kd.repeat_interleave(H // KVH, 1), vd.repeat_interleave(H // KVH, 1)
        return lambda: F.scaled_dot_product_attention(qd, ke, ve, attn_mask=mask)

    # ---- K3: paged decode, B 16, contexts over 1..2048, one pad row ------
    ctx_lens = [0, 1, 17, 100, 255, 256, 511, 700, 1000, 1023, 1300, 1500, 1777, 1999, 2047, 2048]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for H, KVH, D, B, cl in ((32, 8, 128, 16, ctx_lens), (32, 8, 64, 8, ctx_lens[::2])):
            q, k, v, bt, ctx = _paged_case(gen, dev, dtype, B, H, KVH, D, bs, cl, MB)
            got = paged_attention_cuda(q, k, v, bt, ctx, block_size=bs)
            ref = paged_attention_torch(q, k, v, bt, ctx, block_size=bs)
            torch.cuda.synchronize()
            err = _check(f"paged_attention D{D}", got, ref, dn, checks)
            # the decode-only ragged case is the paged kernel
            cu = torch.arange(B + 1, dtype=torch.int32, device=dev)
            got4 = ragged_attention_cuda(q, k, v, bt, cu, ctx, block_size=bs, max_q_len=1)
            torch.cuda.synchronize()
            _check(f"ragged_attention decode-only == paged D{D}", got4, got, dn, checks)
            if D != 128:
                continue
            elt = q.element_size()
            n_kv = int(ctx.sum())
            pages = int(((ctx + bs - 1) // bs).sum())
            bytes_moved = 2 * q.numel() * elt + 2 * n_kv * KVH * D * elt + 4 * (pages + B)
            bound, by = _bound(bytes_moved, 4 * H * D * n_kv, dn)
            qd = q[:, :, None, :]
            kd, vd = dense_kv(k, v, bt, KVH)
            mask = (torch.arange(MB * bs, device=dev)[None, :] < ctx[:, None])[:, None, None, :]
            summary.setdefault("paged_attention", {})[dn] = {
                "max_abs_err": err,
                "ms": time_ms(lambda: paged_attention_cuda(q, k, v, bt, ctx, block_size=bs)),
                "plain_ms": time_ms(lambda: paged_attention_torch(q, k, v, bt, ctx, block_size=bs)),
                "bound_ms": bound, "bound_by": by,
                "library_ms": time_ms(sdpa(qd, kd, vd, mask, H, KVH)),
                "shape": f"B{B} H{H} KVH{KVH} D{D} bs{bs} ctx 0..2048 (sum {n_kv})",
            }

    # ---- K4: 256-token prefill chunk, mid-prompt chunk, 12 decode rows, --
    # ---- two q_len = 0 pad sequences, trailing pad rows -------------------
    rng = np.random.default_rng(5)
    dec_ctx = sorted(int(x) for x in rng.integers(1, 2049, size=12))
    q_lens = [256, 128] + [1] * 12 + [0, 0]
    seq_ctx = [256, 1024] + dec_ctx + [0, 0]
    T = sum(q_lens)
    T_pad = 1 << (T - 1).bit_length()
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for H, KVH, D in ((32, 8, 128), (32, 8, 64)):
            B = len(q_lens)
            _, k, v, bt, ctx = _paged_case(gen, dev, dtype, B, H, KVH, D, bs, seq_ctx, MB)
            q = torch.randn(T_pad, H, D, generator=gen, device=dev).to(dtype)
            cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device=dev)
            run = lambda: ragged_attention_cuda(q, k, v, bt, cu, ctx, block_size=bs, max_q_len=256)  # noqa: E731
            got = run()
            ref = ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)
            torch.cuda.synchronize()
            err = _check(f"ragged_attention mixed D{D}", got, ref, dn, checks)
            if float(got[T:].float().abs().max()) != 0.0:
                raise AssertionError("ragged_attention wrote packed rows past cu_q_lens[B]")
            if D != 128:
                continue
            elt = q.element_size()
            visible = sum(c - ql + j + 1 for c, ql in zip(seq_ctx, q_lens) for j in range(ql))
            pages = sum(-(-c // bs) for c in seq_ctx)
            bytes_moved = (2 * T * H * D * elt + 2 * sum(seq_ctx) * KVH * D * elt
                           + 4 * (pages + 2 * B + 1))
            bound, by = _bound(bytes_moved, 4 * H * D * visible, dn)
            # yardstick: every sequence padded to 256 query rows, causal at
            # absolute positions, over its gathered dense K/V
            qd = torch.zeros(B, H, 256, D, dtype=dtype, device=dev)
            qpos = torch.full((B, 256), -1, dtype=torch.long, device=dev)
            for b, (c, ql) in enumerate(zip(seq_ctx, q_lens)):
                s0 = int(cu[b])
                qd[b, :, :ql] = q[s0 : s0 + ql].transpose(0, 1)
                qpos[b, :ql] = torch.arange(c - ql, c, device=dev)
            kd, vd = dense_kv(k, v, bt, KVH)
            kvpos = torch.arange(MB * bs, device=dev)
            mask = ((kvpos[None, None, :] <= qpos[:, :, None])
                    & (kvpos[None, None, :] < ctx[:, None, None].long()))[:, None]
            summary.setdefault("ragged_attention", {})[dn] = {
                "max_abs_err": err,
                "ms": time_ms(run),
                "plain_ms": time_ms(lambda: ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)),
                "bound_ms": bound, "bound_by": by,
                "library_ms": time_ms(sdpa(qd, kd, vd, mask, H, KVH)),
                "shape": f"T{T}(pad {T_pad}) q_lens 256+128+12x1+2x0 H{H} KVH{KVH} D{D} bs{bs}",
            }
    emit({"phase": "kernels", "checks": checks, "timings": summary,
          "library_note": "scaled_dot_product_attention on K/V gathered dense beforehand; "
                          "gather excluded"})
    return summary


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def engine_phase(dev) -> dict:
    """Serve 12 requests through LLMEngine at LLAMA3_8B width."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA3_8B
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    model = LLAMA3_8B
    cfg = EngineConfig(
        model=model, num_blocks=2048, block_size=16, max_num_seqs=16,
        max_prefill_len=2048, mixed_batch=True, mixed_prefill_chunk=256,
        decode_chunk=8, enable_prefix_caching=True,
    )
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1537, size=12)
    prompts = [rng.integers(3, model.vocab_size, size=int(n)).tolist() for n in lens]
    shared = rng.integers(3, model.vocab_size, size=512).tolist()
    prompts[0] = shared + prompts[0][: max(1, int(lens[0]) - 512)]
    prompts[11] = shared + prompts[11][: max(1, int(lens[11]) - 512)]
    greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    seeded = [SamplingParams(max_tokens=32, temperature=0.8, top_k=50, top_p=0.9,
                             seed=100 + i, ignore_eos=True) for i in range(2)]
    sps = [greedy] * 10 + seeded

    # the kernels' counters, zeroed just before the main path runs
    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    finals, reqs, wall, steps = _serve(eng, prompts, sps, "r")
    launches = {"paged_attention": paged_attention_cuda.launches,
                "ragged_attention": ragged_attention_cuda.launches}

    st = eng.stats()
    for rid, toks in finals.items():
        if len(toks) != 32 or not all(0 <= t < model.vocab_size for t in toks):
            raise AssertionError(f"{rid}: {len(toks)} tokens, not 32 in [0, vocab)")
    if len(finals) != 12:
        raise AssertionError(f"{len(finals)} of 12 requests finished")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if st.get("mixed", {}).get("dispatches", 0) <= 0:
        raise AssertionError("no mixed dispatch ran")
    if st["prefix_cache"]["hit_tokens"] <= 0:
        raise AssertionError("the prefix cache recorded no hit")
    if eng.allocator.num_free != cfg.num_blocks:
        raise AssertionError(f"KV not returned: {eng.allocator.num_free} of {cfg.num_blocks} free")
    ttft = [r.t_first_token - r.arrival for r in reqs.values()]
    res = {
        "phase": "engine", "model": "LLAMA3_8B", "layers": model.n_layers,
        "d_model": model.d_model, "dtype": "bfloat16", "requests": 12,
        "prompt_tokens": int(sum(len(p) for p in prompts)), "output_tokens": 12 * 32,
        "engine_steps": steps, "init_s": init_s, "wall_s": wall,
        "output_tok_per_s": 12 * 32 / wall, "mean_ttft_s": float(np.mean(ttft)),
        "kernel_launches": launches, "mixed": st["mixed"],
        "prefix_cache": st["prefix_cache"], "free_blocks": eng.allocator.num_free,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    # the same work again, warm (the first pass pays cuBLAS plan choice and
    # allocator growth for every new shape), then under torch.profiler:
    # where the device time goes, and its idle share. The prefix cache is
    # emptied first so each pass runs the same prefill.
    eng.allocator.drop_prefix_cache()
    finals_w, reqs_w, wall_w, _ = _serve(eng, prompts, sps, "w")
    res["warm"] = {"wall_s": wall_w, "output_tok_per_s": 12 * 32 / wall_w,
                   "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival
                                                 for r in reqs_w.values()])),
                   "greedy_tokens_equal_first_pass": all(
                       finals_w[f"w{i}"] == finals[f"r{i}"] for i in range(10))}
    emit(res)
    eng.allocator.drop_prefix_cache()
    emit(_profile_serving(eng, prompts, sps))
    del eng
    torch.cuda.empty_cache()
    return res


def _serve(eng, prompts, sps, tag):
    """Run the 12 requests to completion; request 11 (the second on the
    shared prefix) arrives once request 0's prompt is in the cache (sealed),
    so its admission can hit the prefix cache."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = {}
    for i in range(11):
        rid = eng.add_request(prompts[i], sps[i], request_id=f"{tag}{i}")
        reqs[rid] = eng.requests[rid]
    finals: dict = {}
    late = None
    steps = 0
    while eng.has_unfinished() or late is None:
        if late is None and reqs[f"{tag}0"].output_token_ids:
            late = eng.add_request(prompts[11], sps[11], request_id=f"{tag}11")
            reqs[late] = eng.requests[late]
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = out.output_token_ids
        steps += 1
        if steps > 10_000:
            raise AssertionError("the engine made no progress")
    torch.cuda.synchronize()
    return finals, reqs, time.perf_counter() - t0, steps


def _profile_serving(eng, prompts, sps) -> dict:
    """Serve under torch.profiler: device busy time (union of kernel
    intervals) against the host wall time, and device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = _serve(eng, prompts, sps, "p")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    # device-side entries only (an aten op's entry repeats its kernels' time)
    by_name = sorted(
        ((a.key, a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
         if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0),
        key=lambda x: -x[1],
    )
    device_ms = sum(ms for _, ms, _ in by_name)

    def share(*words):
        return sum(ms for k, ms, _ in by_name if any(w in k for w in words))

    return {
        "phase": "engine_profile", "wall_s_profiled": wall,
        "device_busy_ms": busy_us / 1e3 if spans else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if spans else None,
        "device_kernel_ms": device_ms,
        "paged_attention_ms": share("paged_attention_kernel"),
        "ragged_attention_ms": share("ragged_attention_kernel"),
        "gemm_ms": share("nvjet", "gemm", "Gemm", "cutlass", "xmma"),
        "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in by_name[:12]],
    }


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def parity_phase(dev) -> None:
    """The same fp32 weights and greedy prompts through the engine on the
    card (CUDA kernels) and on the CPU (plain versions)."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    model = LlamaConfig(vocab_size=2048, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2,
                        d_ff=1024, max_seq=512, dtype=torch.float32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    params_cpu = init_params(model, gen, "cpu")
    params_gpu = {k: (v.to(dev) if torch.is_tensor(v) else {kk: vv.to(dev) for kk, vv in v.items()})
                  for k, v in params_cpu.items()}
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, model.vocab_size, size=int(n)).tolist()
               for n in (5, 37, 90, 130, 200, 17)]
    sp = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    result = {"phase": "parity", "model": "fp32 d512 L2 H4 KVH2 D128 V2048"}
    for mixed in (True, False):
        outs = {}
        for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            cfg = EngineConfig(model=model, num_blocks=256, block_size=16, max_num_seqs=8,
                               max_prefill_len=256, mixed_batch=mixed,
                               mixed_prefill_chunk=64, decode_chunk=8)
            outs[where] = LLMEngine(cfg, params=params, device=where).generate(prompts, sp)
        same = outs["cuda"] == outs["cpu"]
        result[f"mixed_{mixed}"] = {"identical": same, "tokens": sum(map(len, outs["cuda"]))}
        if not same:
            emit(result)
            raise AssertionError(f"mixed_batch={mixed}: GPU tokens != CPU tokens")
    emit(result)


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    # fp32 means fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0], "tf32": False})

    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {k: round(v, 2) for k, v in built.items()}, "ptxas": ptxas})
    summary = kernels_phase(dev)
    engine = engine_phase(dev)
    parity_phase(dev)

    sources = {"paged_attention": ("ray_tpu_torch/ops/csrc/paged_attention.cu",
                                   "ray_tpu/ops/paged_attention.py:74"),
               "ragged_attention": ("ray_tpu_torch/ops/csrc/ragged_attention.cu",
                                    "ray_tpu/ops/ragged.py:97")}
    kernels = []
    for name, (src, replaces) in sources.items():
        bf = summary[name]["bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": engine["kernel_launches"][name],
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"], "dtype": "bfloat16", "shape": bf["shape"],
            "fp32": summary[name]["float32"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
