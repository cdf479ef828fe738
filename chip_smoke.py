#!/usr/bin/env python3
"""Smoke run of the ray_tpu_torch serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py                         # one card, no arguments: every phase
    python3 chip_smoke.py --phases build,flash_kernels   # a short first check of a kernel edit

Phases, each printing one JSON line:

  device   card name and power limit; TF32 off for matmuls and cuDNN, so
           fp32 means fp32 on the card
  build    compile the CUDA kernels from ops/csrc (one nvcc per source,
           started together)
  kernels  the paged and ragged kernels against their plain PyTorch
           versions at the LLAMA3_8B engine shapes (H 32, KVH 8, D 128,
           block_size 16) and at D 64, in bf16 (band 2e-2) and fp32 (band
           2e-5); times from CUDA events (median of 30 after warm-up)
           beside the bytes/operations bound and a PyTorch yardstick
           (scaled_dot_product_attention on K/V already gathered dense,
           gather excluded; the port never calls it)
  flash_kernels  the flash forward and backward kernels against their
           plain versions (gradients with a nonzero lse cotangent) at the
           train shape (B 8, S 1024, H 16, KVH 8, D 64), the 8B head shape
           (H 32, KVH 8, D 128, S 2048), a two-segment S 1000 case and a
           q_offset case, bf16 and fp32, with the reference's allclose
           bands; times at the train shape beside SDPA
  engine   LLMEngine at LLAMA3_8B width (bf16, 32 layers, random weights
           from a seeded generator on the card), mixed batching, 12
           requests; the kernels' launch counters are zeroed just before
           and read just after
  parity   a reduced fp32 model served by the same engine on the card
           (kernels) and on the CPU (plain versions): identical greedy
           tokens, mixed batching on and off
  train    LLAMA_400M at full width and depth (bf16 compute, fp32 params,
           remat "dots", flash attention, AdamW lr 3e-4 wd 1e-4), B 8,
           S 1024, one fixed batch (numpy seed 0), with bench.py's gates:
           initial loss near ln V, timed runs of 10 and 30 chained steps
           linear in the count, the loss decreasing, MFU in (0, 1]; the
           flash counters are zeroed just before the steps and read just
           after; then one step under torch.profiler
  train_parity  a small fp32 model trained 5 steps on the card and on
           the CPU from the same params and batch: losses, grad norms and
           params within the bands stated at PARITY_*

The engine phase also serves the same requests twice more: warm (its
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


# flash bands: the reference's (tests/test_flash.py:39,46,88), as allclose
# with equal atol and rtol: forward fp32 2e-5, gradients fp32 5e-4, bf16 2e-2
FLASH_BANDS = {("fwd", "float32"): 2e-5, ("bwd", "float32"): 5e-4,
               ("fwd", "bfloat16"): 2e-2, ("bwd", "bfloat16"): 2e-2}


def _close(name, got, ref, band, results) -> float:
    """|got - ref| <= band + band * |ref| elementwise (np.testing.assert_allclose
    with atol = rtol = band); returns the max abs error."""
    import torch

    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    worst = float((diff / (band + band * r.abs())).max()) if diff.numel() else 0.0
    results.append({"check": name, "max_abs_err": err, "band": band, "worst_ratio": worst})
    if not (worst <= 1.0 and bool(torch.isfinite(g).all())):
        raise AssertionError(f"{name}: max abs err {err}, {worst:.3f} x the allclose band {band}")
    return err


def flash_kernels_phase(dev) -> dict:
    """Hold the flash forward and backward kernels against their plain
    versions (gradients with a nonzero lse cotangent) and time both, with
    SDPA (forward alone; forward + backward) as the yardstick."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash import (
        _masks, flash_attention_bwd_torch, flash_attention_fwd_torch, flash_bwd_cuda,
        flash_fwd_cuda,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    checks: list = []
    summary: dict = {}
    rng = np.random.default_rng(7)
    # (label, B, Sq, Sk, H, KVH, D, causal, q_offset, segments)
    seg_bounds = [int(x) for x in rng.integers(200, 800, size=2)]
    cases = [
        ("train", 8, 1024, 1024, 16, 8, 64, True, 0, None),
        ("8b_heads", 1, 2048, 2048, 32, 8, 128, True, 0, None),
        ("segments_pad", 2, 1000, 1000, 16, 4, 64, True, 0, seg_bounds),
        ("q_offset", 2, 200, 1000, 16, 8, 128, True, 800, None),
    ]
    for label, B, Sq, Sk, H, KVH, D, causal, q_off, segs in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(B, S_, n, D, generator=gen, device=dev).to(dtype)
                       for S_, n in ((Sq, H), (Sk, KVH), (Sk, KVH)))
            q = (q.float() / D ** 0.5).to(dtype)  # scale folded in, as flash_attention does
            qseg = kseg = None
            if segs is not None:
                pos = torch.arange(Sq, device=dev)
                qseg = torch.stack([(pos >= s).int() for s in segs]).contiguous()
                kseg = qseg
            kw = dict(causal=causal, q_offset=q_off)
            # the kernel runs first, so its outputs cannot be blocks the plain
            # version just freed
            o, lse = flash_fwd_cuda(q, k, v, qseg, kseg, **kw)
            torch.cuda.synchronize()
            ref_o, ref_lse = flash_attention_fwd_torch(q, k, v, qseg, kseg, **kw)
            tag = f"{label} B{B} Sq{Sq} Sk{Sk} H{H} KVH{KVH} D{D}"
            band = FLASH_BANDS[("fwd", dn)]
            err_o = _close(f"flash_fwd o {tag} [{dn}]", o, ref_o, band, checks)
            _close(f"flash_fwd lse {tag} [{dn}]", lse, ref_lse, band, checks)
            do = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
            dlse = torch.randn(B, H, Sq, generator=gen, device=dev) * 0.1
            bargs = (q, k, v, ref_o, ref_lse, do, dlse, qseg, kseg)
            got_g = flash_bwd_cuda(*bargs, **kw)
            torch.cuda.synchronize()
            ref_g = flash_attention_bwd_torch(*bargs, **kw)
            band = FLASH_BANDS[("bwd", dn)]
            err_g = max(_close(f"flash_bwd d{n} {tag} [{dn}]", g, r, band, checks)
                        for n, g, r in zip("qkv", got_g, ref_g))
            # the backward's sums are plain fp32 FMA chains in the order
            # cuBLAS's SGEMM takes for the plain version's einsums, so the
            # two can agree bit for bit; show they are not trivially zero
            checks[-1]["grad_max_abs"] = [float(r.float().abs().max()) for r in ref_g]
            if label != "train":
                continue
            # timings at the train shape: the bound counts each input read
            # once and each output written once, and the visible pairs
            _, valid = _masks(B, Sq, Sk, causal, q_off, qseg, kseg, dev)
            pairs = int(valid.expand(B, 1, 1, Sq, Sk).sum()) * H
            elt = q.element_size()
            io = (q.numel() + 2 * k.numel()) * elt
            fwd_flops = 4 * D * pairs
            fwd_bound = _bound(io + q.numel() * elt + 4 * B * H * Sq, fwd_flops, dn)
            bwd_bytes = io + 2 * q.numel() * elt + 2 * 4 * B * H * Sq + io
            bwd_bound = _bound(bwd_bytes, 2.5 * fwd_flops, dn)
            qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                                      enable_gqa=True)

            qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=1.0,
                                                     enable_gqa=True)
                return torch.autograd.grad(out, (qg, kg, vg), dot)

            summary.setdefault("flash_fwd", {})[dn] = {
                "max_abs_err": err_o,
                "ms": time_ms(lambda: flash_fwd_cuda(q, k, v, **kw), iters=20),
                "plain_ms": time_ms(lambda: flash_attention_fwd_torch(q, k, v, **kw),
                                    iters=5, warmup=1),
                "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                "library_ms": time_ms(sdpa_fwd, iters=20), "shape": tag + " causal",
            }
            summary.setdefault("flash_bwd", {})[dn] = {
                "max_abs_err": err_g,
                "ms": time_ms(lambda: flash_bwd_cuda(*bargs, **kw), iters=20),
                "plain_ms": time_ms(lambda: flash_attention_bwd_torch(*bargs, **kw),
                                    iters=5, warmup=1),
                "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                "library_ms": time_ms(sdpa_fwd_bwd, iters=20),
                "shape": tag + " causal, dlse != 0",
                "library_note": "SDPA forward + backward",
            }
            del ref_g, got_g
        torch.cuda.empty_cache()
    emit({"phase": "flash_kernels", "checks": checks, "timings": summary,
          "library_note": "scaled_dot_product_attention(is_causal, enable_gqa) on [B, H, S, D] "
                          "copies; the port never calls it"})
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
    busy_ms, by_name = _device_time(prof)
    device_ms = sum(ms for _, ms, _ in by_name)

    def share(*words):
        return sum(ms for k, ms, _ in by_name if any(w in k for w in words))

    return {
        "phase": "engine_profile", "wall_s_profiled": wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / 1e3 / wall,
        "device_kernel_ms": device_ms,
        "paged_attention_ms": share("paged_attention_kernel"),
        "ragged_attention_ms": share("ragged_attention_kernel"),
        "gemm_ms": share(*GEMM_WORDS),
        "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in by_name[:12]],
    }


GEMM_WORDS = ("nvjet", "gemm", "Gemm", "cutlass", "xmma")


def _device_time(prof):
    """(device busy ms as the union of kernel intervals, or None without
    device events; [(kernel name, device ms, calls)] largest first)."""
    from torch.autograd import DeviceType

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
    return (busy_us / 1e3 if spans else None), by_name


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
# train
# ---------------------------------------------------------------------------


def _timed_steps(step, state, batch, iters: int):
    """Run ``iters`` chained steps and fence once, on the last loss (as
    bench.py's timed_steps): the fence cannot pass before every step ran."""
    losses = []
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    float(losses[-1])
    return state, [float(x) for x in losses], time.perf_counter() - t0


def train_phase(dev) -> dict:
    """LLAMA_400M at full width and depth (bf16 compute, fp32 params, remat
    "dots", flash attention) trained on one fixed batch, with bench.py's
    gates (bench.py:122-178)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import LLAMA_400M, init_params, loss_and_weight_fn, loss_fn
    from ray_tpu_torch.ops.flash import flash_bwd_cuda, flash_fwd_cuda
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    cfg = dataclasses.replace(LLAMA_400M, attention_impl="flash")
    B, S, iters = 8, 1024, 10
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, dev)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(B, S + 1), dtype=np.int32)
    ).to(dev)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    state = TrainState.create(params, adamw(3e-4, weight_decay=1e-4))
    step = make_train_step(lambda p, b: loss_and_weight_fn(p, b, cfg), None)

    with torch.no_grad():
        init_loss = float(loss_fn(state.params, batch, cfg))
    ln_v = math.log(cfg.vocab_size)
    if not 0.3 * ln_v <= init_loss <= 3.0 * ln_v:
        raise AssertionError(f"initial loss {init_loss} not near ln(vocab) {ln_v}")

    torch.cuda.reset_peak_memory_stats()
    # the kernels' counters, zeroed just before the main path runs
    flash_fwd_cuda.launches = 0
    flash_bwd_cuda.launches = 0
    for _ in range(2):  # warm-up: cuBLAS plans, allocator growth
        state, metrics = step(state, batch)
    warm_loss = float(metrics["loss"])
    for _attempt in range(2):  # one retry, as bench.py: a host hiccup is not a bug
        state, losses_a, dt_a = _timed_steps(step, state, batch, iters)
        state, losses_b, dt_b = _timed_steps(step, state, batch, 3 * iters)
        ratio = (dt_b / (3 * iters)) / (dt_a / iters)
        if 0.75 <= ratio <= 1.33:
            break
    else:
        raise AssertionError(f"step time not linear in the step count: ratio {ratio}")
    steps_run = state.step
    launches = {"flash_fwd": flash_fwd_cuda.launches, "flash_bwd": flash_bwd_cuda.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    losses = [warm_loss] + losses_a + losses_b
    if not (losses[-1] < losses[0] and losses[-1] < init_loss and all(map(math.isfinite, losses))):
        raise AssertionError(f"loss did not decrease: init {init_loss}, {losses[:3]} ... {losses[-1]}")
    step_s = (dt_a + dt_b) / (4 * iters)
    tok_per_s = B * S / step_s
    mfu = tok_per_s * 3.0 * cfg.flops_per_token() / PEAK_OPS_PER_S["bfloat16"]
    if not 0.0 < mfu <= 1.0:
        raise AssertionError(f"MFU {mfu} outside (0, 1]")
    res = {
        "phase": "train", "model": "LLAMA_400M", "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.num_params(), "batch": B, "seq": S, "attention_impl": cfg.attention_impl,
        "remat": cfg.remat_policy, "dtype": "bfloat16", "param_dtype": "float32",
        "optimizer": "AdamW(lr 3e-4, weight_decay 1e-4)",
        "init_loss": init_loss, "ln_vocab": ln_v, "losses_first_last": [losses[0], losses[-1]],
        "step_ms": step_s * 1e3, "step_ms_10": dt_a / iters * 1e3,
        "step_ms_30": dt_b / (3 * iters) * 1e3, "linearity_ratio": ratio,
        "tok_per_s": tok_per_s, "mfu": mfu, "mfu_peak": "989e12 bf16 dense",
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "steps": steps_run, "kernel_launches": launches,
        "launches_per_step": {k: n / steps_run for k, n in launches.items()},
    }
    emit(res)
    emit(_profile_train(step, state, batch))
    del state, params
    torch.cuda.empty_cache()
    return res


def _profile_train(step, state, batch) -> dict:
    """One train step under torch.profiler: device busy time and idle
    share, device time by kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    busy_ms, by_name = _device_time(prof)
    device_ms = sum(ms for _, ms, _ in by_name)

    def share(*words):
        return sum(ms for k, ms, _ in by_name if any(w in k for w in words))

    groups = {"gemm_ms": share(*GEMM_WORDS), "flash_fwd_ms": share("flash_fwd_kernel"),
              "flash_bwd_ms": share("flash_dkv_kernel", "flash_dq_kernel")}
    return {
        "phase": "train_profile", "wall_ms_profiled": wall * 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / 1e3 / wall,
        "device_kernel_ms": device_ms, **groups,
        "flash_dkv_ms": share("flash_dkv_kernel"), "flash_dq_ms": share("flash_dq_kernel"),
        "rest_ms": device_ms - sum(groups.values()),
        "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in by_name[:12]],
    }


# train_parity bands (stated in PERF.md): the loss and grad_norm of each of
# the 5 steps within 1e-4 relative; the params within 2 * lr * steps = 3e-3
# absolute (Adam's first steps move each element by about lr * sign(grad),
# so a near-zero gradient whose sign the card's sum order flips can move
# one element that far apart), and all but 0.1 % of them within 1e-5.
PARITY_LOSS_RTOL = 1e-4
PARITY_PARAM_ATOL = 2 * 3e-4 * 5


def train_parity_phase(dev) -> None:
    """A small fp32 model (flash attention) trained 5 steps on the card
    (kernels) and on the CPU (plain versions) from the same params and
    batch."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_and_weight_fn
    from ray_tpu_torch.ops.flash import flash_bwd_cuda, flash_fwd_cuda
    from ray_tpu_torch.train import TrainState, adamw, make_train_step
    from ray_tpu_torch.train.step import param_leaves

    cfg = LlamaConfig(vocab_size=2048, d_model=512, n_layers=2, n_heads=8, n_kv_heads=4,
                      d_ff=1024, max_seq=256, dtype=torch.float32, attention_impl="flash")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    base = init_params(cfg, gen, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 2048, size=(2, 257),
                                                               dtype=np.int32))
    runs = {}
    fwd0, bwd0 = flash_fwd_cuda.launches, flash_bwd_cuda.launches
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        params = {k: ({n: t.to(d, copy=True) for n, t in v.items()} if isinstance(v, dict)
                      else v.to(d, copy=True)) for k, v in base.items()}
        batch = {"tokens": toks[:, :-1].to(d), "targets": toks[:, 1:].to(d)}
        state = TrainState.create(params, adamw(3e-4, weight_decay=1e-4))
        step = make_train_step(lambda p, b: loss_and_weight_fn(p, b, cfg), None)
        hist = []
        for _ in range(5):
            state, m = step(state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        runs[where] = (hist, [p.detach().cpu() for p in param_leaves(state.params)])
    (h_gpu, p_gpu), (h_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for ga, gc in zip(h_gpu, h_cpu) for a, b in zip(ga, gc))
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(p_gpu, p_cpu)])
    res = {"phase": "train_parity", "model": "fp32 d512 L2 H8 KVH4 D64 V2048 B2 S256 flash",
           "steps": 5, "loss_grad_norm_cuda": h_gpu, "loss_grad_norm_cpu": h_cpu,
           "max_rel_loss_or_grad_norm": rel, "band_rel": PARITY_LOSS_RTOL,
           "param_max_abs_diff": float(diffs.max()), "param_band_abs": PARITY_PARAM_ATOL,
           "param_frac_over_1e-5": float((diffs > 1e-5).float().mean()),
           "flash_launches_on_card": [flash_fwd_cuda.launches - fwd0,
                                      flash_bwd_cuda.launches - bwd0]}
    emit(res)
    if rel > PARITY_LOSS_RTOL:
        raise AssertionError(f"train_parity: loss/grad_norm rel diff {rel} > {PARITY_LOSS_RTOL}")
    if res["param_max_abs_diff"] > PARITY_PARAM_ATOL or res["param_frac_over_1e-5"] > 1e-3:
        raise AssertionError(f"train_parity: params apart: {res}")
    if min(res["flash_launches_on_card"]) <= 0:
        raise AssertionError("train_parity: the card run launched no flash kernel")


# ---------------------------------------------------------------------------

PHASES = ("build", "kernels", "flash_kernels", "engine", "parity", "train", "train_parity")

SOURCES = {
    "paged_attention": ("ray_tpu_torch/ops/csrc/paged_attention.cu",
                        "ray_tpu/ops/paged_attention.py:74"),
    "ragged_attention": ("ray_tpu_torch/ops/csrc/ragged_attention.cu",
                         "ray_tpu/ops/ragged.py:97"),
    "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/flash.py:143"),
    "flash_bwd": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                  "ray_tpu/ops/flash.py:491, ray_tpu/ops/flash.py:251, ray_tpu/ops/flash.py:323"),
}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s (a partial run prints no "
                         "kernels or result line)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
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
    built = _build.build()  # every kernel, one nvcc per source, started together
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {k: round(v, 2) for k, v in built.items()}, "ptxas": ptxas})
    timings, launches = {}, {}
    if "kernels" in phases:
        timings.update(kernels_phase(dev))
    if "flash_kernels" in phases:
        timings.update(flash_kernels_phase(dev))
    if "engine" in phases:
        launches.update(engine_phase(dev)["kernel_launches"])
    if "parity" in phases:
        parity_phase(dev)
    if "train" in phases:
        launches.update(train_phase(dev)["kernel_launches"])
    if "train_parity" in phases:
        train_parity_phase(dev)
    if set(phases) != set(PHASES):
        print(f"partial run ({','.join(phases)}): no kernels or result line", flush=True)
        return 0

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        bf = timings[name]["bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"], "dtype": "bfloat16", "shape": bf["shape"],
            "fp32": timings[name]["float32"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
