#!/usr/bin/env python3
"""Smoke run of the ray_tpu_torch serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py                         # one card, no arguments: every phase
    python3 chip_smoke.py --phases build,flash_kernels   # a short first check of a kernel edit
    python3 chip_smoke.py --phases build,engine,api      # the serving front end alone
    python3 chip_smoke.py --phases build,engine,disagg   # disaggregated prefill/decode alone

Phases, each printing one JSON line:

  device   card name and power limit; TF32 off for matmuls and cuDNN, so
           fp32 means fp32 on the card
  build    compile the CUDA kernels from ops/csrc (one nvcc per source,
           started together); ptxas registers and spills per kernel
  kernels  the paged and ragged kernels against their plain PyTorch
           versions at the LLAMA3_8B engine shapes (H 32, KVH 8, D 128,
           block_size 16) and at D 64, in bf16 (band 2e-2) and fp32 (band
           2e-5); decode-only ragged must equal paged bit for bit, and two
           launches of each kernel must give the same bits. Times from
           CUDA events around 30 calls queued behind a spin kernel (no
           host launch cost, no idle gaps), kernel and yardstick in turns
           over 3 rounds, beside the bytes/operations bound, the
           kernel's GB/s and its share of the bound; the yardstick is
           scaled_dot_product_attention on K/V already gathered dense
           (gather excluded; the port never calls it)
  flash_kernels  the flash forward and backward kernels against their
           plain versions (gradients with a nonzero lse cotangent) at the
           train shape (B 8, S 1024, H 16, KVH 8, D 64), the 8B head shape
           (H 32, KVH 8, D 128, S 2048), a two-segment S 1000 case and a
           q_offset case, bf16 (tensor-core kernels) and fp32 (CUDA-core
           kernels), with the reference's allclose bands; the bf16
           backward launched twice must give the same bits. Times at the
           train shape beside the bound, SDPA (the forward alone for K1,
           the backward alone for K2) and the earlier CUDA-core kernels'
           bf16 time, with TFLOP/s, the
           bound's share, the dK/dV vs dQ split (torch.profiler) and the
           wrapper's delta ops
  engine   LLMEngine at LLAMA3_8B width (bf16, 32 layers, random weights
           from a seeded generator on the card), mixed batching, 12
           requests, served with the default pipelined decode (every
           decode chunk a replay of a CUDA graph captured per bucket, every
           mixed step a replay of a graph captured per packed-token bucket),
           then the same requests on the sync path (pipeline_decode=False)
           with the same weights; the kernels' launches (eager launches plus
           those of graph replays) are counted from just before the first
           pass to just after it. Fails unless every mixed step ran as a
           replay with the ragged kernel inside, and unless a replay of the
           largest mixed bucket gives the eager step's logits and K/V bits.
           Each pass reports the mixed graphs captured and their capture
           seconds per T_pad bucket, and its peak device memory
  lora     LoRA multiplexing at LLAMA3_8B (the engine phase's weights,
           configuration and 12 requests): max_loras 4, rank 8, targets wq
           and wv, 3 adapters of random weights (numpy seeds 1-3, A ~
           N(0, 1/d_model), B ~ N(0, 0.25^2): a delta about as large as q
           and v themselves, so every adapter changes the greedy stream),
           assigned round robin so a quarter of the rows are base; a first
           and a warm pass, 4 steady passes in turns with 4 of the requests
           all on the base model (medians of the passes that captured no
           graph), then one of each under
           torch.profiler: the all-base pass runs the engine phase's
           batches with the delta ops, so its busy time less the engine
           phase's is the delta's device time; then one decode step and one
           mixed step at the engine's shapes with and without the delta
           (device ms and kernels per step); the kernels' launches counted
           over the first pass as in the engine phase.
           Fails unless every adapter's stream differs from the engine
           phase's stream of its prompt, a graph replay ran with an adapter
           row, every mixed step ran as a replay with adapter tokens, both
           serving kernels launched, a mixed replay with adapters gives the
           eager step's bits, and remove_lora of an adapter a request holds
           raises
  api      LLAMA3_8B served through the OpenAI front end (LLMServer over
           the engine phase's configuration and weights, the model named
           "llama3-8b" and resolved by the registry; requests are objects
           with method, path and json()): the engine phase's 12 requests
           as text completions (printable ASCII of its token lengths, EOS
           live) with 2 chats and 2 generate_stream requests riding along,
           a first pass, four more (steady: the median of those that
           captured no graph) and one under torch.profiler:
           client tok/s, engine TTFT and the streams' first-delta TTFT,
           device busy and idle share, beside the engine phase's; the
           kernels' launches counted over the first pass. Fails unless
           every completion has its 32 tokens or a stop, /v1/models names
           llama3-8b at 8192, a greedy request's streamed deltas join to
           its completion's text, a preemption before a mixed step and a
           crash after a step with a decode chunk in flight each recover
           (2 recoveries; every position delivered once), a burst of 24 at
           max_queue_depth 3 sheds 429s with Retry-After while the admitted
           finish, and a drain turns a new request into a 503
  disagg   LLAMA3_8B disaggregated (the engine phase's weights, one copy
           shared, configuration and 12 requests): a DisaggOrchestrator
           with one prefill and one decode engine, each on its own loop
           thread, and the in-process connector; a first pass (both
           engines fresh, each capturing its graphs while the other works),
           three more (steady: the median of those that captured no graph),
           two gated passes (all 12 admitted in one step, the decode loop
           parked until the 12 handoffs are sent, so both decode one batch
           shape: their bf16 streams must be equal, and the first reads
           every import back from the live cache, bit for bit) and a gated
           pass with one handoff corrupted in flight; tok/s, TTFT, TPOT,
           per handoff the export (gather, d2h, seal) and import (verify,
           h2d, scatter) ms, bytes handed off, graphs and capture seconds
           per engine, K3/K4 launches per engine (eager and in replays),
           peak memory. Fails unless the first pass makes 12 transfers and
           no re-prefill, the decode engine runs no prefill or mixed step,
           every request has 32 tokens, every mixed step of the prefill
           engine is a replay with K4 inside and the decode chunks replays
           with K3 inside, a capture of one engine overlaps the other's
           steps, the per-thread launch tallies account for every wrapper
           launch, imports after capture leave the cache tensors in place
           and are read by replays of graphs captured before them, the
           corrupted handoff is re-prefilled once (its first token and the
           11 other streams equal the clean gated pass's), and two
           completions through LLMServer(disagg=) report "mode": "disagg"
  parity   a reduced fp32 model served by the same engine on the card
           (kernels; pipelined on graphs, and sync) and on the CPU (plain
           versions): identical greedy tokens, mixed batching on and off
           (on: every mixed step on the card a graph replay, and a replay
           bit for bit the eager step); then the same with a batch mixing
           two adapters (wq, wk, wv) and base rows; then LLMServer's greedy
           completions on the card = the CPU server's = LLMEngine.generate,
           and after recover(rebuild_kv=True) with graphs captured the
           streams equal the fault-free pass; and, mixed batching on and
           off, the disaggregated path on the card and on the CPU gives the
           colocated greedy tokens and the colocated streams of two seeded
           requests, and a handoff corrupted in flight on the card is
           re-prefilled once with the clean run's tokens
  spec     speculative decoding at LLAMA3_8B (bf16, mixed batching, so the
           verify pass runs the ragged kernel at q_len 1..5, every pass a
           replay of a graph per packed-token bucket, bit for bit the
           eager pass): prompt lookup
           with k = 4, then a LLAMA3_1B draft model at full width, random
           weights; acceptance, tok/s and ragged launches (> 0); then fp32
           greedy spec == non-spec tokens on the parity model (vocabulary
           cut to 256, prompts holding every id, so prompt lookup always
           drafts), both drafters, and prompt lookup under adapters
  train    LLAMA_400M at full width and depth (bf16 compute, fp32 params,
           remat "dots", flash attention, AdamW lr 3e-4 wd 1e-4), B 8,
           S 1024, one fixed batch (numpy seed 0), with bench.py's gates:
           initial loss near ln V, timed runs of 10 and 30 chained steps
           linear in the count, the loss decreasing, MFU in (0, 1]; the
           flash counters are zeroed just before the steps and read just
           after; then one step under torch.profiler (it fails if a flash
           kernel launched but its kernel-name group reads no time)
  train_parity  a small fp32 model trained 5 steps on the card and on
           the CPU from the same params and batch: losses, grad norms and
           params within the bands stated at PARITY_*

The engine phase also serves the same requests again on each path: warm
(its numbers say what the first pass spent on first-call costs and graph
captures; the pipelined path adds a third, steady pass, since a longer
chunk picked by the controller captures its graph on first use) and under
torch.profiler (device busy time and idle
share, of the whole pass and split between the mixed steps and the
decode-only rounds; time by kernel; the paged and ragged kernel families
by name prefix with their launches; it fails if a family launched but
its prefix reads no device time). The kernels phase also times the
ragged kernel at the speculative verify shape (q_len 1..5).

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


# cycles of torch.cuda._sleep that park the card while the host queues a
# timed run (tens of ms at any clock the card runs at)
PARK_CYCLES = 50_000_000


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls
    queued back to back behind a spin kernel: the host's launch cost stays
    out of the reading (it exceeds the serving kernels' own time), and the
    card runs the calls without idle gaps that would let its clock drop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(PARK_CYCLES)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def time_rounds(fns: dict, rounds: int = 3, iters: int = 30) -> dict:
    """Median device ms of each callable, timed in turns (a, b, a, b, ...)
    over ``rounds`` rounds in this call: a yardstick whose reading drifts
    between calls is read beside the kernel each time."""
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(time_ms(fn, iters=iters))
    return out


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


def _split_sweep(q, k, v, bt, ctx, bs) -> dict:
    """The paged kernel's time at other split counts than the host rule's,
    on these inputs and on every context at the table's full width (over
    distinct pages): the measurement behind ``num_splits``."""
    import torch

    from ray_tpu_torch.ops.paged_attention import _DTYPE_CODES, _paged_lib

    lib = _paged_lib()
    B, H, D = q.shape
    KVH, MB = k.shape[0], bt.shape[1]
    full = torch.full_like(ctx, MB * bs)
    bt_full = torch.randperm(B * MB, device=q.device).reshape(B, MB).int()
    out = torch.empty_like(q)
    sweep = {}
    for label, lens, table in (("these contexts", ctx, bt), ("all at the full width", full, bt_full)):
        for splits in (1, 2, 3, 4, 8):
            ws = torch.empty(B, H, splits, D + 2, device=q.device) if splits > 1 else None
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), lens.data_ptr(),
                    out.data_ptr(), B, H, KVH, D, k.shape[1], MB, bs, splits,
                    None if ws is None else ws.data_ptr(), _DTYPE_CODES[q.dtype],
                    torch.cuda.current_stream().cuda_stream)
            rc = lib.paged_attention_launch(*args)
            if rc:
                raise AssertionError(f"paged_attention at {splits} splits: cudaError {rc}")
            sweep.setdefault(label, {})[splits] = time_ms(lambda: lib.paged_attention_launch(*args))
    return sweep


def _bound(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rate(rounds: dict, bytes_moved: float, bound: float, by: str) -> dict:
    """A kernel's time (median of its rounds) beside the yardstick's, with
    its bytes per second and its share of the bound."""
    import numpy as np

    ms = float(np.median(rounds["ms"]))
    return {"ms": ms, "library_ms": float(np.median(rounds["library_ms"])),
            "rounds_ms": rounds["ms"], "rounds_library_ms": rounds["library_ms"],
            "bound_ms": bound, "bound_by": by, "gb_per_s": bytes_moved / ms / 1e6,
            "bound_share": bound / ms}


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

    from ray_tpu_torch.ops.paged_attention import (
        num_splits, paged_attention_cuda, paged_attention_torch, sm_count,
    )
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
            again = paged_attention_cuda(q, k, v, bt, ctx, block_size=bs)
            torch.cuda.synchronize()
            # one split-KV core in both libraries: the same bits, launch after launch
            same = {"ragged decode-only == paged": torch.equal(got4, got),
                    "paged twice": torch.equal(again, got)}
            checks.append({"check": f"bitwise D{D}", "dtype": dn, **same})
            if not all(same.values()):
                raise AssertionError(f"paged/ragged decode D{D} [{dn}]: bits differ: {same}")
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
            rounds = time_rounds({
                "ms": lambda: paged_attention_cuda(q, k, v, bt, ctx, block_size=bs),
                "library_ms": sdpa(qd, kd, vd, mask, H, KVH)})
            summary.setdefault("paged_attention", {})[dn] = {
                "max_abs_err": err,
                **_rate(rounds, bytes_moved, bound, by),
                "plain_ms": time_ms(lambda: paged_attention_torch(q, k, v, bt, ctx, block_size=bs)),
                "splits": num_splits(B, KVH, MB * bs, sm_count(dev)),
                "split_sweep_ms": _split_sweep(q, k, v, bt, ctx, bs),
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
            again = run()
            ref = ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)
            torch.cuda.synchronize()
            err = _check(f"ragged_attention mixed D{D}", got, ref, dn, checks)
            if not torch.equal(got, again):
                raise AssertionError(f"ragged_attention mixed D{D} [{dn}]: two launches differ")
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
            rounds = time_rounds({"ms": run, "library_ms": sdpa(qd, kd, vd, mask, H, KVH)})
            summary.setdefault("ragged_attention", {})[dn] = {
                "max_abs_err": err,
                **_rate(rounds, bytes_moved, bound, by),
                "plain_ms": time_ms(lambda: ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)),
                "kernels_ms": _split_ms(run, ("ragged_attention_decode_kernel",
                                              "ragged_attention_combine_kernel",
                                              "ragged_attention_chunk_kernel",
                                              "ragged_attention_kernel<")),
                "shape": f"T{T}(pad {T_pad}) q_lens 256+128+12x1+2x0 H{H} KVH{KVH} D{D} bs{bs}",
            }

    # ---- K4 at the speculative verify shape: 16 sequences of q_len 1..5 ----
    # ---- (1 + draft length, k = 4) over contexts up to 2048 ------------------
    q_lens = [int(x) for x in rng.integers(1, 6, size=16)]
    seq_ctx = [int(x) for x in rng.integers(64, 2049, size=16)]
    T = sum(q_lens)
    H, KVH, D, B = 32, 8, 128, 16
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        _, k, v, bt, ctx = _paged_case(gen, dev, dtype, B, H, KVH, D, bs, seq_ctx, MB)
        q = torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
        cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device=dev)
        run = lambda: ragged_attention_cuda(q, k, v, bt, cu, ctx, block_size=bs, max_q_len=5)  # noqa: E731
        got = run()
        ref = ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)
        torch.cuda.synchronize()
        err = _check("ragged_attention verify q_len 1..5", got, ref, dn, checks)
        elt = q.element_size()
        visible = sum(c - ql + j + 1 for c, ql in zip(seq_ctx, q_lens) for j in range(ql))
        pages = sum(-(-c // bs) for c in seq_ctx)
        bytes_moved = (2 * T * H * D * elt + 2 * sum(seq_ctx) * KVH * D * elt
                       + 4 * (pages + 2 * B + 1))
        bound, by = _bound(bytes_moved, 4 * H * D * visible, dn)
        qd = torch.zeros(B, H, 5, D, dtype=dtype, device=dev)
        qpos = torch.full((B, 5), -1, dtype=torch.long, device=dev)
        for b, (c, ql) in enumerate(zip(seq_ctx, q_lens)):
            s0 = int(cu[b])
            qd[b, :, :ql] = q[s0 : s0 + ql].transpose(0, 1)
            qpos[b, :ql] = torch.arange(c - ql, c, device=dev)
        kd, vd = dense_kv(k, v, bt, KVH)
        kvpos = torch.arange(MB * bs, device=dev)
        mask = ((kvpos[None, None, :] <= qpos[:, :, None])
                & (kvpos[None, None, :] < ctx[:, None, None].long()))[:, None]
        rounds = time_rounds({"ms": run, "library_ms": sdpa(qd, kd, vd, mask, H, KVH)})
        summary["ragged_attention"][dn]["verify_shape"] = {
            "max_abs_err": err,
            **_rate(rounds, bytes_moved, bound, by),
            "plain_ms": time_ms(lambda: ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)),
            "kernels_ms": _split_ms(run, ("ragged_attention_decode_kernel",
                                          "ragged_attention_combine_kernel",
                                          "ragged_attention_chunk_kernel",
                                          "ragged_attention_kernel<")),
            "shape": f"T{T} q_lens {q_lens} H{H} KVH{KVH} D{D} bs{bs} ctx 64..2048 "
                     f"(sum {sum(seq_ctx)})",
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


# bf16 at the train shape: the CUDA-core kernels that served bf16 before
# the tensor-core kernels (PERF.md's kernel table, measured by this script
# on an NVIDIA H100 80GB HBM3, 700 W) and the times the tensor-core
# kernels are held to
CUDA_CORE_MS = {"flash_fwd": 0.7003, "flash_bwd": 2.6348}
TARGET_MS = {"flash_fwd": 0.12, "flash_bwd": 0.45}


def _split_ms(fn, names, reps: int = 10) -> dict:
    """Mean device ms per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, by_name = _device_time(prof)
    return {n: sum(ms for k, ms, _ in by_name if n in k) / reps for n in names}


def _busy_per_call(fn, reps: int = 5) -> tuple[float, float]:
    """(device busy ms, kernels launched) per call of ``fn``, from
    torch.profiler over ``reps`` calls after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_ms, by_name = _device_time(prof)
    return busy_ms / reps, sum(n for _, _, n in by_name) / reps


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
            # the bf16 backward is deterministic (no atomics): a second launch
            # on the same inputs gives the same bits
            if dn == "bfloat16":
                again = flash_bwd_cuda(*bargs, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got_g, again))
                checks.append({"check": f"flash_bwd bitwise repeatable {tag} [{dn}]", "ok": same})
                if not same:
                    raise AssertionError(f"flash_bwd {tag}: two launches on the same inputs differ")
                del again
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

            # K2's like-for-like yardstick: SDPA's backward alone, on a graph
            # kept from one forward
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=1.0,
                                                      enable_gqa=True)

            def sdpa_bwd():
                return torch.autograd.grad(sdpa_out, (qg, kg, vg), dot, retain_graph=True)

            fwd_ms = time_ms(lambda: flash_fwd_cuda(q, k, v, **kw), iters=20)
            bwd_ms = time_ms(lambda: flash_bwd_cuda(*bargs, **kw), iters=20)

            summary.setdefault("flash_fwd", {})[dn] = {
                "max_abs_err": err_o, "ms": fwd_ms,
                "plain_ms": time_ms(lambda: flash_attention_fwd_torch(q, k, v, **kw),
                                    iters=5, warmup=1),
                "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                "library_ms": time_ms(sdpa_fwd, iters=20), "shape": tag + " causal",
                "gflop": fwd_flops / 1e9, "tflops": fwd_flops / fwd_ms / 1e9,
                "bound_share": fwd_bound[0] / fwd_ms,
                **({"cuda_core_ms": CUDA_CORE_MS["flash_fwd"], "target_ms": TARGET_MS["flash_fwd"]}
                   if dn == "bfloat16" else {}),
            }
            summary.setdefault("flash_bwd", {})[dn] = {
                "max_abs_err": err_g, "ms": bwd_ms,
                "plain_ms": time_ms(lambda: flash_attention_bwd_torch(*bargs, **kw),
                                    iters=5, warmup=1),
                "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                "library_ms": time_ms(sdpa_bwd, iters=20),
                "library_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, iters=20),
                "shape": tag + " causal, dlse != 0",
                "library_note": "SDPA backward alone (library_fwd_bwd_ms: forward + backward)",
                "gflop": 2.5 * fwd_flops / 1e9, "tflops": 2.5 * fwd_flops / bwd_ms / 1e9,
                "bound_share": bwd_bound[0] / bwd_ms,
                "kernels_ms": _split_ms(lambda: flash_bwd_cuda(*bargs, **kw),
                                        ("flash_dkv_kernel", "flash_dq_kernel")),
                # the wrapper's delta = rowsum(dO * O) - dlse (PyTorch ops), in "ms"
                "delta_ms": time_ms(lambda: (do.to(torch.float32, copy=True).mul_(ref_o)
                                             .sum(-1).transpose(1, 2) - dlse).contiguous(),
                                    iters=20),
                **({"cuda_core_ms": CUDA_CORE_MS["flash_bwd"], "target_ms": TARGET_MS["flash_bwd"]}
                   if dn == "bfloat16" else {}),
            }
            del ref_g, got_g, sdpa_out
        torch.cuda.empty_cache()
    emit({"phase": "flash_kernels", "checks": checks, "timings": summary,
          "library_note": "scaled_dot_product_attention(is_causal, enable_gqa) on [B, H, S, D] "
                          "copies; the port never calls it"})
    return summary


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


ENGINE_KW = dict(num_blocks=2048, block_size=16, max_num_seqs=16, max_prefill_len=2048,
                 mixed_batch=True, mixed_prefill_chunk=256, decode_chunk=8,
                 enable_prefix_caching=True)


def params_8b(dev):
    """LLAMA3_8B's random bf16 weights from a seeded generator on the card
    (shared by the engine and spec phases), and the seconds they took."""
    import torch

    from ray_tpu_torch.models.llama import LLAMA3_8B, init_params

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(LLAMA3_8B, gen, dev, dtype=LLAMA3_8B.dtype)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _launch_counts(eng, before: dict) -> dict:
    """Kernel launches on the device since ``before`` (from ``_launch_marks``):
    the wrappers' eager launches plus the launches of graph replays (a
    wrapper counts a launch once, when it is recorded into a graph)."""
    now = _launch_marks(eng)
    return {n: now[n] - before[n] for n in now}


def _families(eng) -> tuple:
    """The engine's graph families: decode chunks, mixed steps, ragged
    verify passes."""
    return eng._graphs, eng._mixed_graphs, eng._verify_graphs


def _launch_marks(eng) -> dict:
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    return {n: f.launches + sum(g.launches.get(n, 0) - g.captured_launches.get(n, 0)
                                for g in _families(eng))
            for n, f in (("paged_attention", paged_attention_cuda),
                         ("ragged_attention", ragged_attention_cuda))}


def _replayed_marks(eng) -> dict:
    """Launches made by graph replays so far, per kernel."""
    return {n: sum(g.launches.get(n, 0) for g in _families(eng))
            for n in ("paged_attention", "ragged_attention")}


def _pass_marks(eng) -> tuple:
    """Taken just before a pass (the peak-memory counter reset): what
    ``_pass_graphs`` diffs against."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    return ({id(f): {k: len(v) for k, v in f.capture_s_by_key.items()}
             for f in _families(eng)}, {id(f): f.replays for f in _families(eng)})


def _pass_graphs(eng, marks) -> dict:
    """Over one pass: the packed programs' graph captures and capture
    seconds per T_pad bucket, their replays, and peak device memory."""
    import torch

    seen, replays = marks
    out = {}
    for name, fam in (("mixed", eng._mixed_graphs), ("verify", eng._verify_graphs)):
        by_t = {}
        for key, secs in fam.capture_s_by_key.items():
            new = secs[seen[id(fam)].get(key, 0):]
            if new:
                d = by_t.setdefault(f"T_pad {key[1]}", {"captures": 0, "capture_s": 0.0})
                d["captures"] += len(new)
                d["capture_s"] += sum(new)
        out[name] = {"captures_by_T_pad": by_t, "replays": fam.replays - replays[id(fam)],
                     "graphs_live": len(fam._graphs)}
    out["decode_chunk_replays"] = eng._graphs.replays - replays[id(eng._graphs)]
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _replay_equals_eager(eng, fam, fn) -> dict:
    """The largest captured bucket of a packed-program family, on the
    inputs its last step left in the buffers: the program run eagerly on
    them, then the graph replayed, from the same cache (the slots the step
    writes are put back after each). Raises unless the logits and the K/V
    written have the same bits."""
    import torch

    key = max(fam._graphs, key=lambda k: k[1])
    bufs = fam._bufs[key]
    slots = torch.unique(bufs.slots.long())
    slots = slots[slots < fam.trash_slot]
    snap = {n: t[:, :, slots].clone() for n, t in eng.cache.items()}

    def written_then_restore():
        kv = {n: t[:, :, slots].clone() for n, t in eng.cache.items()}
        for n, t in snap.items():
            eng.cache[n][:, :, slots] = t
        return kv

    with torch.no_grad():
        eager = fn(bufs).clone()
        kv_eager = written_then_restore()
        replay = fam.run(fn, bufs).clone()
        kv_replay = written_then_restore()
    torch.cuda.synchronize()
    same = torch.equal(eager, replay) and all(torch.equal(kv_eager[n], kv_replay[n])
                                             for n in kv_eager)
    res = {"bucket": list(key), "tokens": int(bufs.cu_q_lens[-1]),
           "dtype": str(eng.config.model.dtype).replace("torch.", ""),
           "logits_and_kv_bits_equal": same}
    if not same:
        raise AssertionError(f"a {key[0]} replay differs from the eager program: {res}")
    return res


def _check_packed_replays(st_family: dict, dispatches: int, what: str) -> None:
    """Every dispatch of a packed program ran as a graph replay, with K4
    launched inside the replays."""
    if dispatches <= 0 or st_family["replays"] != dispatches:
        raise AssertionError(f"{what}: {st_family['replays']} graph replays for {dispatches} "
                             f"dispatches")
    if st_family["replay_kernel_launches"].get("ragged_attention", 0) <= 0:
        raise AssertionError(f"{what}: the ragged kernel did not run inside the replays")


def engine_phase(dev, params, params_s: float) -> dict:
    """Serve 12 requests through LLMEngine at LLAMA3_8B width: the default
    (pipelined decode on captured CUDA graphs), then the same requests on
    the sync path with the same weights."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA3_8B

    model = LLAMA3_8B
    cfg = EngineConfig(model=model, **ENGINE_KW)
    if not cfg.pipeline_decode:
        raise AssertionError("EngineConfig no longer defaults to the pipelined path")
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, params=params, device=dev)
    torch.cuda.synchronize()
    init_s = params_s + time.perf_counter() - t0

    prompts, sps = _engine_traffic(model)

    # the kernels' counters, zeroed just before the main path runs
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    marks = _launch_marks(eng)
    replayed0 = _replayed_marks(eng)
    pmarks = _pass_marks(eng)
    finals, reqs, wall, steps = _serve(eng, prompts, sps, "r")
    launches = _launch_counts(eng, marks)
    replayed = {n: v - replayed0[n] for n, v in _replayed_marks(eng).items()}
    first_graphs = _pass_graphs(eng, pmarks)

    st = eng.stats()
    _check_served(eng, finals, model, 12, 32)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if st.get("mixed", {}).get("dispatches", 0) <= 0:
        raise AssertionError("no mixed dispatch ran")
    _check_packed_replays(st["mixed"]["graphs"], st["mixed"]["dispatches"], "engine: mixed steps")
    if st["prefix_cache"]["hit_tokens"] <= 0:
        raise AssertionError("the prefix cache recorded no hit")
    graphs = st["pipeline"]["graphs"]
    if graphs["replays"] <= 0 or graphs["replay_kernel_launches"].get("paged_attention", 0) <= 0:
        raise AssertionError(f"no decode chunk ran as a graph replay with the paged kernel: {graphs}")
    ttft = [r.t_first_token - r.arrival for r in reqs.values()]
    res = {
        "phase": "engine", "model": "LLAMA3_8B", "layers": model.n_layers,
        "first_pass_tokens": {f"r{i}": finals[f"r{i}"] for i in range(12)},
        "d_model": model.d_model, "dtype": "bfloat16", "requests": 12,
        "prompt_tokens": int(sum(len(p) for p in prompts)), "output_tokens": 12 * 32,
        "engine_steps": steps, "init_s": init_s, "wall_s": wall,
        "output_tok_per_s": 12 * 32 / wall, "mean_ttft_s": float(np.mean(ttft)),
        "kernel_launches": launches,
        "kernel_launches_in_replays": replayed,
        "kernel_launches_eager": {n: launches[n] - replayed[n] for n in launches},
        "first_pass_graphs": first_graphs, "pipeline": st["pipeline"], "mixed": st["mixed"],
        "prefix_cache": st["prefix_cache"], "free_blocks": eng.allocator.num_free,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    # the same work again, warm (the first pass pays graph captures, cuBLAS
    # plan choice and allocator growth for every new shape), then under
    # torch.profiler: where the device time goes, and its idle share in the
    # decode-only rounds and in the mixed steps. The prefix cache is
    # emptied first so each pass runs the same prefill.
    # A later pass may capture graphs too: the chunk controller may step to
    # a longer chunk, whose bucket is captured on first use. So a third pass
    # reads the steady state, and each says how many graphs exist after it.
    for key, tag in (("warm", "w"), ("steady", "x")):
        eng.allocator.drop_prefix_cache()
        pmarks = _pass_marks(eng)
        finals_w, reqs_w, wall_w, _ = _serve(eng, prompts, sps, tag)
        res[key] = {**_pass_summary(finals_w, reqs_w, wall_w, finals),
                    "graphs": _pass_graphs(eng, pmarks),
                    "graphs_captured_so_far": eng._graphs.captures,
                    "chunks_by_steps_so_far": eng.stats()["pipeline"]["chunks_by_steps"]}
    eng.allocator.drop_prefix_cache()
    prof = _profile_serving(eng, prompts, sps)
    st = eng.stats()
    _check_packed_replays(st["mixed"]["graphs"], st["mixed"]["dispatches"], "engine: mixed steps")
    res["graphs_after_all_passes"] = st["pipeline"]["graphs"]
    res["mixed_graphs_after_all_passes"] = st["mixed"]["graphs"]
    res["mixed_replay_equals_eager"] = _replay_equals_eager(eng, eng._mixed_graphs,
                                                            eng._mixed_program)
    del eng
    torch.cuda.empty_cache()

    # the sync decode path (pipeline_decode=False), same weights and requests
    eng = LLMEngine(EngineConfig(model=model, pipeline_decode=False, **ENGINE_KW),
                    params=params, device=dev)
    pmarks = _pass_marks(eng)
    finals_s, reqs_s, wall_s, steps_s = _serve(eng, prompts, sps, "s")
    _check_served(eng, finals_s, model, 12, 32)
    st = eng.stats()
    _check_packed_replays(st["mixed"]["graphs"], st["mixed"]["dispatches"], "sync: mixed steps")
    res["sync"] = {"engine_steps": steps_s, **_pass_summary(finals_s, reqs_s, wall_s, finals),
                   "graphs": _pass_graphs(eng, pmarks)}
    eng.allocator.drop_prefix_cache()
    finals_sw, reqs_sw, wall_sw, _ = _serve(eng, prompts, sps, "t")
    res["sync"]["warm"] = _pass_summary(finals_sw, reqs_sw, wall_sw, finals)
    eng.allocator.drop_prefix_cache()
    prof_sync = _profile_serving(eng, prompts, sps)
    del eng
    torch.cuda.empty_cache()
    emit({k: v for k, v in res.items() if k != "first_pass_tokens"})
    emit({**prof, "phase": "engine_profile", "decode": "pipelined"})
    emit({**prof_sync, "phase": "engine_profile", "decode": "sync"})
    return {**res, "profile": prof}


def _engine_traffic(model):
    """The engine phase's 12 requests (numpy seed 0): 64-1536 prompt
    tokens, requests 0 and 11 on one 512-token prefix, 32 outputs each, 10
    greedy and 2 seeded top-k/top-p."""
    import numpy as np

    from ray_tpu_torch.llm import SamplingParams

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1537, size=12)
    prompts = [rng.integers(3, model.vocab_size, size=int(n)).tolist() for n in lens]
    shared = rng.integers(3, model.vocab_size, size=512).tolist()
    prompts[0] = shared + prompts[0][: max(1, int(lens[0]) - 512)]
    prompts[11] = shared + prompts[11][: max(1, int(lens[11]) - 512)]
    greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    seeded = [SamplingParams(max_tokens=32, temperature=0.8, top_k=50, top_p=0.9,
                             seed=100 + i, ignore_eos=True) for i in range(2)]
    return prompts, [greedy] * 10 + seeded


# ---------------------------------------------------------------------------
# lora
# ---------------------------------------------------------------------------


LORA_KW = dict(max_loras=4, lora_rank=8, lora_targets=("wq", "wv"))
LORA_B_STD = 0.25


def lora_adapter(model, seed: int, targets, rank: int) -> dict:
    """Random adapter weights from a numpy seed: A ~ N(0, 1/d_model), so a
    row's down-projection has unit scale, and B ~ N(0, LORA_B_STD^2): each
    delta element is about sqrt(rank) * 0.25 ~ 0.7, as large as the
    projections themselves (fan-in init), so an adapter changes the stream."""
    import numpy as np

    rng = np.random.default_rng(seed)
    outs = {"wq": model.n_heads * model.head_dim, "wk": model.n_kv_heads * model.head_dim,
            "wv": model.n_kv_heads * model.head_dim}
    L, d = model.n_layers, model.d_model
    return {t: ((rng.standard_normal((L, d, rank), np.float32) / d ** 0.5),
                (rng.standard_normal((L, rank, outs[t]), np.float32) * LORA_B_STD))
            for t in targets}


def _lora_step_costs(eng) -> dict:
    """The delta ops' device ms and kernels in one decode step (B_pad 16:
    12 rows, contexts 64-2048, adapters round robin) and one mixed step (a
    256-token chunk at positions 512-767 and the 12 decode rows, T_pad
    512), at the engine's shapes, with and without the ``lora=`` argument
    (torch.profiler; new K/V to the trash page)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.llama_decode import decode_step, mixed_step

    c = eng.config
    dev = eng.device
    rng = np.random.default_rng(6)
    trash = c.num_blocks * c.block_size
    B, MB = 16, 128
    ctx = np.zeros(B, np.int32)
    ctx[:12] = rng.integers(64, 2049, size=12)
    bt = rng.integers(0, c.num_blocks, size=(B, MB)).astype(np.int32)
    ids = np.array([0, 1, 2, 3] * 3 + [0] * 4, np.int32)
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)  # noqa: E731
    tok = t(rng.integers(3, c.model.vocab_size, size=B).astype(np.int32))
    dec = (tok, t(np.maximum(ctx - 1, 0)), t(np.full(B, trash, np.int32)), t(bt), t(ctx))
    # mixed: sequence 0 a 256-token chunk, sequences 1-12 the decode rows
    q_lens = [256] + [1] * 12
    T_pad = 512
    cu = np.zeros(B + 1, np.int32)
    cu[1 : len(q_lens) + 1] = np.cumsum(q_lens)
    cu[len(q_lens) + 1 :] = cu[len(q_lens)]
    mctx = np.zeros(B, np.int32)
    mctx[0], mctx[1:13] = 768, ctx[:12]
    pos = np.zeros(T_pad, np.int32)
    pos[:256] = np.arange(512, 768)
    pos[256:268] = ctx[:12] - 1
    tok_ids = np.zeros(T_pad, np.int32)
    tok_ids[:256], tok_ids[256:268] = 1, ids[:12]
    mix = (t(rng.integers(3, c.model.vocab_size, size=T_pad).astype(np.int32)), t(pos),
           t(np.full(T_pad, trash, np.int32)), t(bt), t(cu), t(mctx))
    out = {}
    for name, call, ids_ in (
        ("decode_step", lambda lora: decode_step(eng.params, *dec, eng.cache, c.model,
                                                 block_size=c.block_size, lora=lora), ids),
        ("mixed_step", lambda lora: mixed_step(eng.params, *mix, eng.cache, c.model,
                                               block_size=c.block_size, max_q_len=256,
                                               lora=lora), tok_ids),
    ):
        lora = eng._lora_arg(ids_)
        with torch.no_grad():
            base_ms, base_k = _busy_per_call(lambda: call(None))
            lora_ms, lora_k = _busy_per_call(lambda: call(lora))
        out[name] = {"ms_without": base_ms, "ms_with": lora_ms, "delta_ms": lora_ms - base_ms,
                     "kernels_without": base_k, "kernels_with": lora_k}
    return out


def lora_phase(dev, params, engine_res: dict) -> dict:
    """The engine phase's requests through an 8B engine with 3 adapters
    loaded, a quarter of the rows base: a first and a warm pass, then 4
    steady passes in turns with 4 of the same requests all on the base
    model, then one of each under torch.profiler (the all-base one against
    the engine phase's gives the delta ops' device time), beside the engine
    phase's numbers from this run."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA3_8B
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    model = LLAMA3_8B
    eng = LLMEngine(EngineConfig(model=model, **ENGINE_KW, **LORA_KW), params=params, device=dev)
    names = ["a1", "a2", "a3"]
    for i, name in enumerate(names):
        eng.add_lora(name, lora_adapter(model, i + 1, LORA_KW["lora_targets"],
                                        LORA_KW["lora_rank"]))
    prompts, sps = _engine_traffic(model)
    lora_ids = [([None] + names)[i % 4] for i in range(12)]
    # an adapter a request holds cannot be removed
    held = eng.add_request(prompts[1], sps[1], lora_id="a1")
    try:
        eng.remove_lora("a1")
    except ValueError:
        pass
    else:
        raise AssertionError("remove_lora of an adapter a waiting request holds did not raise")
    eng.abort_request(held)

    # rows under an adapter in each dispatched chunk (host view of the batch)
    adapter_chunks = []
    run = eng._graphs.run

    def counting_run(fn, bufs, n_steps, mode):
        adapter_chunks.append(any(r.lora_slot for r in eng.running))
        return run(fn, bufs, n_steps, mode)

    # mixed steps with adapter tokens (host view of the packed rows)
    adapter_steps = []
    mixed_run = eng._mixed_graphs.run

    def counting_mixed_run(fn, bufs):
        adapter_steps.append(any(r.lora_slot for r in eng.running))
        return mixed_run(fn, bufs)

    eng._graphs.run = counting_run
    eng._mixed_graphs.run = counting_mixed_run
    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    marks = _launch_marks(eng)
    replayed0 = _replayed_marks(eng)
    pmarks = _pass_marks(eng)
    finals, reqs, wall, steps = _serve(eng, prompts, sps, "r", lora_ids=lora_ids)
    launches = _launch_counts(eng, marks)
    replayed = {n: v - replayed0[n] for n, v in _replayed_marks(eng).items()}
    first_graphs = _pass_graphs(eng, pmarks)
    st = eng.stats()
    _check_served(eng, finals, model, 12, 32)
    if min(launches.values()) <= 0:
        raise AssertionError(f"lora: a kernel of the path never launched: {launches}")
    graphs = st["pipeline"]["graphs"]
    if graphs["replays"] <= 0 or not any(adapter_chunks):
        raise AssertionError(f"lora: no graph replay ran with an adapter row: {graphs}")
    _check_packed_replays(st["mixed"]["graphs"], st["mixed"]["dispatches"], "lora: mixed steps")
    if not all(adapter_steps):
        raise AssertionError(f"lora: a mixed step ran without adapter tokens: {adapter_steps}")
    base = engine_res["first_pass_tokens"]
    same_as_base = [finals[f"r{i}"] == base[f"r{i}"] for i in range(12)]
    differ = [i for i, lid in enumerate(lora_ids) if lid is not None and same_as_base[i]]
    if differ:
        raise AssertionError(f"lora: adapter requests {differ} gave the base stream")
    # the two requests on the shared prefix run under different salts
    # (base and a3): their blocks are not shared
    if st["prefix_cache"]["hit_tokens"] != 0:
        raise AssertionError(f"lora: a prefix hit across adapters: {st['prefix_cache']}")
    base_rows = [i for i, lid in enumerate(lora_ids) if lid is None]
    eng_pass = lambda r: {k: r[k] for k in ("output_tok_per_s", "mean_ttft_s")}  # noqa: E731
    res = {
        "phase": "lora", "model": "LLAMA3_8B", "dtype": "bfloat16", **LORA_KW,
        "adapters": "3, numpy seeds 1-3, A ~ N(0, 1/d_model), B ~ N(0, 0.25^2)",
        "rows_per_adapter": {str(k): lora_ids.count(k) for k in [None] + names},
        "engine_steps": steps, "wall_s": wall, "output_tok_per_s": 12 * 32 / wall,
        "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival for r in reqs.values()])),
        "kernel_launches": launches, "kernel_launches_in_replays": replayed,
        "first_pass_graphs": first_graphs,
        "mixed_steps_with_adapter_tokens": f"{sum(adapter_steps)}/{len(adapter_steps)}",
        "chunks_dispatched": len(adapter_chunks),
        "chunks_with_adapter_rows": sum(adapter_chunks), "pipeline": st["pipeline"],
        "mixed": st["mixed"], "prefix_cache": st["prefix_cache"],
        # reported, not asserted: the batches around them differ from the
        # engine phase's (no prefix hit here: another packing, other plans)
        "base_rows_equal_engine_phase": f"{sum(same_as_base[i] for i in base_rows)}/"
                                        f"{len(base_rows)}",
        "engine_phase": {"first": eng_pass(engine_res), "warm": eng_pass(engine_res["warm"]),
                         "steady": eng_pass(engine_res["steady"])},
    }
    # as the engine phase: a warm pass (a longer chunk picked by the
    # controller captures its graph on first use); then steady passes in
    # turns, with the adapters and with every row on the base model (the
    # engine phase's batches and prefix hit through the same programs, the
    # delta ops included). The controller may still step to a longer chunk
    # and capture its graph in one of them, and host times swing from pass
    # to pass: the median of the passes that captured nothing is read
    eng.allocator.drop_prefix_cache()
    pmarks = _pass_marks(eng)
    finals_w, reqs_w, wall_w, _ = _serve(eng, prompts, sps, "w", lora_ids=lora_ids)
    res["warm"] = {**_pass_summary(finals_w, reqs_w, wall_w, finals),
                   "graphs": _pass_graphs(eng, pmarks),
                   "graphs_captured_so_far": eng._graphs.captures}
    passes = {"adapters": [], "all_base": []}
    for rnd in range(4):
        for key, ids, ref in (("adapters", lora_ids, finals), ("all_base", None, base)):
            eng.allocator.drop_prefix_cache()
            c0 = sum(g.captures for g in _families(eng))
            s0 = sum(g.capture_s for g in _families(eng))
            tag = ("ijkl" if key == "adapters" else "uvyz")[rnd]  # one letter: _pass_summary
            f, rq, w, _ = _serve(eng, prompts, sps, tag, lora_ids=ids)
            passes[key].append({**_pass_summary(f, rq, w, ref),
                                "graphs_captured": sum(g.captures for g in _families(eng)) - c0,
                                "capture_s": sum(g.capture_s for g in _families(eng)) - s0})
    for key, runs in passes.items():
        read = [r for r in runs if not r["graphs_captured"]] or runs
        res[f"steady_{key}"] = {
            "median_output_tok_per_s": float(np.median([r["output_tok_per_s"] for r in read])),
            "median_mean_ttft_s": float(np.median([r["mean_ttft_s"] for r in read])),
            "passes_read": len(read), "passes": runs,
        }
    # reported, not asserted (bf16): slot 0 adds exactly zero, so the engine
    # phase's batches give its bits (greedy rows)
    res["steady_all_base"]["compared_with"] = "the engine phase's first pass"
    eng.allocator.drop_prefix_cache()
    prof = _profile_serving(eng, prompts, sps, lora_ids=lora_ids)
    eng.allocator.drop_prefix_cache()
    prof_base = _profile_serving(eng, prompts, sps)
    eng_prof = engine_res["profile"]
    res["graphs_after_all_passes"] = eng.stats()["pipeline"]["graphs"]
    # the delta ops' device time: the all-base profiled pass runs the engine
    # phase's batches with the LoRA ops in every layer
    res["lora_delta_device_ms"] = {
        "read_as": "device busy ms (torch.profiler) of a pass of this engine with every "
                   "row on the base model minus the engine phase's profiled pass: the same "
                   "requests, batches and prefix hit, with and without the delta ops",
        "busy_ms_all_base": prof_base["device_busy_ms"],
        "engine_busy_ms": eng_prof["device_busy_ms"],
        "delta_ms": prof_base["device_busy_ms"] - eng_prof["device_busy_ms"],
        "busy_ms_with_adapters": prof["device_busy_ms"],
        "mixed_steps_busy_ms": [prof_base["mixed_steps"]["device_busy_ms"],
                                eng_prof["mixed_steps"]["device_busy_ms"]],
        "decode_rounds_busy_ms": [prof_base["decode_rounds"]["device_busy_ms"],
                                  eng_prof["decode_rounds"]["device_busy_ms"]],
    }
    res["lora_delta_per_step"] = _lora_step_costs(eng)
    res["idle_share"] = {
        "mixed_steps": prof["mixed_steps"]["device_idle_share"],
        "decode_rounds": prof["decode_rounds"]["device_idle_share"],
        "all_base_mixed_steps": prof_base["mixed_steps"]["device_idle_share"],
        "all_base_decode_rounds": prof_base["decode_rounds"]["device_idle_share"],
        "engine_phase_mixed_steps": eng_prof["mixed_steps"]["device_idle_share"],
        "engine_phase_decode_rounds": eng_prof["decode_rounds"]["device_idle_share"],
    }
    eng._graphs.run = run
    eng._mixed_graphs.run = mixed_run
    res["mixed_graphs_after_all_passes"] = eng.stats()["mixed"]["graphs"]
    res["mixed_replay_equals_eager"] = _replay_equals_eager(eng, eng._mixed_graphs,
                                                            eng._mixed_program)
    del eng
    torch.cuda.empty_cache()
    emit(res)
    emit({**prof, "phase": "lora_profile", "decode": "pipelined", "rows": "adapters"})
    emit({**prof_base, "phase": "lora_profile", "decode": "pipelined", "rows": "all base"})
    return res


def _check_served(eng, finals, model, n, max_tokens) -> None:
    for rid, toks in finals.items():
        if len(toks) != max_tokens or not all(0 <= t < model.vocab_size for t in toks):
            raise AssertionError(f"{rid}: {len(toks)} tokens, not {max_tokens} in [0, vocab)")
    if len(finals) != n:
        raise AssertionError(f"{len(finals)} of {n} requests finished")
    if eng.allocator.num_free != eng.config.num_blocks:
        raise AssertionError(
            f"KV not returned: {eng.allocator.num_free} of {eng.config.num_blocks} free")


def _pass_summary(finals, reqs, wall, first) -> dict:
    """tok/s, TTFT and how many greedy streams (requests 0-9) equal the
    first pipelined pass's (bf16: an equal count is reported, not asserted,
    since a different padded batch may take another cuBLAS algorithm)."""
    import numpy as np

    tag = next(iter(finals))[0]
    same = sum(finals[f"{tag}{i}"] == first[f"r{i}"] for i in range(10))
    tokens_same = sum(a == b for i in range(10)
                      for a, b in zip(finals[f"{tag}{i}"], first[f"r{i}"]))
    return {"wall_s": wall, "output_tok_per_s": sum(map(len, finals.values())) / wall,
            "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival for r in reqs.values()])),
            "greedy_streams_equal_first_pass": f"{same}/10",
            "greedy_tokens_equal_first_pass": f"{tokens_same}/{10 * len(first['r0'])}"}


def _serve(eng, prompts, sps, tag, mark_steps: bool = False, lora_ids=None):
    """Run the requests to completion (request i under adapter
    ``lora_ids[i]``, default none); the last request (the second on the
    shared prefix) arrives once the first one has its first token, so its
    admission can hit the prefix cache. With ``mark_steps`` each step runs
    inside a profiler range and its kind is recorded: "mixed" when it made
    a mixed dispatch, else "decode"."""
    import torch
    from torch.profiler import record_function

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = len(prompts)
    lora_ids = lora_ids or [None] * n
    reqs = {}
    for i in range(n - 1):
        rid = eng.add_request(prompts[i], sps[i], request_id=f"{tag}{i}", lora_id=lora_ids[i])
        reqs[rid] = eng.requests[rid]
    finals: dict = {}
    kinds: list = []
    late = None
    steps = 0
    while eng.has_unfinished() or late is None:
        if late is None and reqs[f"{tag}0"].output_token_ids:
            late = eng.add_request(prompts[n - 1], sps[n - 1], request_id=f"{tag}{n - 1}",
                                   lora_id=lora_ids[n - 1])
            reqs[late] = eng.requests[late]
        mixed0 = eng._mixed_stats.dispatches if eng._mixed_stats else 0
        if mark_steps:
            with record_function("chip_smoke.step"):
                outs = eng.step()
        else:
            outs = eng.step()
        kinds.append("mixed" if eng._mixed_stats and eng._mixed_stats.dispatches > mixed0
                     else "decode")
        for out in outs:
            if out.finished:
                finals[out.request_id] = out.output_token_ids
        steps += 1
        if steps > 10_000:
            raise AssertionError("the engine made no progress")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (finals, reqs, wall, steps) if not mark_steps else (finals, reqs, wall, steps, kinds)


# kernel-name prefixes of the serving kernels' families: the paged family
# (split-KV kernel and its combine kernel) and the ragged family (decode
# rows, their combine, the bf16 chunk kernel, the fp32 chunk kernel)
SERVING_FAMILIES = {"paged_attention": "paged_attention_", "ragged_attention": "ragged_attention_"}


def _profile_serving(eng, prompts, sps, lora_ids=None) -> dict:
    """Serve under torch.profiler: device busy time (union of kernel
    intervals) against the host wall time, split between the mixed steps'
    windows and the rest of the pass (the decode-only rounds, whose chunks
    run while the host is already in the next step); device time by kernel
    and by serving-kernel family with its launches on the device. Raises
    if a family launched but no kernel of its name prefix shows device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = _launch_marks(eng)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall, _, kinds = _serve(eng, prompts, sps, "p", mark_steps=True,
                                      lora_ids=lora_ids)
    calls = _launch_counts(eng, marks)
    busy_ms, by_name = _device_time(prof)
    device_ms = sum(ms for _, ms, _ in by_name)

    def share(*words):
        return sum(ms for k, ms, _ in by_name if any(w in k for w in words))

    families = {}
    for fam, prefix in SERVING_FAMILIES.items():
        kernels = [(k, ms, n) for k, ms, n in by_name if prefix in k]
        ms = sum(x[1] for x in kernels)
        if calls[fam] > 0 and ms <= 0.0:
            raise AssertionError(f"engine_profile: {calls[fam]} {fam} launches but no device "
                                 f"time under '{prefix}*': {[k for k, _, _ in by_name[:20]]}")
        families[fam] = {
            "ms": ms, "launches": calls[fam],
            "ms_per_launch": ms / calls[fam] if calls[fam] else None,
            "kernels": [{"name": k[:90], "ms": t, "launches": n, "ms_per_launch": t / n}
                        for k, t, n in kernels],
        }
    # step windows (host clock of the trace) and kernel intervals
    steps = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.name == "chip_smoke.step")
    if len(steps) != len(kinds):
        raise AssertionError(f"{len(steps)} step ranges in the trace for {len(kinds)} steps")
    spans = _merged(sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                           if e.device_type == DeviceType.CUDA and e.name not in ANNOTATIONS))
    mixed = [w for w, k in zip(steps, kinds) if k == "mixed"]
    whole = [(steps[0][0], max(steps[-1][1], spans[-1][1] if spans else steps[-1][1]))]
    whole_us = whole[0][1] - whole[0][0]
    mixed_us = sum(e - s for s, e in mixed)
    busy_all = _overlap(spans, whole)
    busy_mixed = _overlap(spans, mixed)
    decode_us = whole_us - mixed_us
    return {
        "wall_s_profiled": wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / 1e3 / wall,
        "steps": {"mixed": kinds.count("mixed"), "decode": kinds.count("decode")},
        "mixed_steps": {"wall_ms": mixed_us / 1e3, "share_of_pass": mixed_us / whole_us,
                        "device_busy_ms": busy_mixed / 1e3,
                        "device_idle_share": 1.0 - busy_mixed / mixed_us if mixed_us else None},
        "decode_rounds": {"wall_ms": decode_us / 1e3, "share_of_pass": decode_us / whole_us,
                          "device_busy_ms": (busy_all - busy_mixed) / 1e3,
                          "device_idle_share": (1.0 - (busy_all - busy_mixed) / decode_us
                                                if decode_us else None)},
        "device_kernel_ms": device_ms,
        "paged_attention_ms": families["paged_attention"]["ms"],
        "ragged_attention_ms": families["ragged_attention"]["ms"],
        "serving_families": families,
        "gemm_ms": share(*GEMM_WORDS),
        "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in by_name[:12]],
    }


def _merged(spans: list) -> list:
    out: list = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(spans: list, windows: list) -> float:
    """Total length of the (merged, sorted) spans inside the (sorted,
    disjoint) windows."""
    total, i = 0.0, 0
    for ws, we in windows:
        while i < len(spans) and spans[i][1] <= ws:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < we:
            total += max(0.0, min(we, spans[j][1]) - max(ws, spans[j][0]))
            j += 1
    return total


GEMM_WORDS = ("nvjet", "gemm", "Gemm", "cutlass", "xmma")
# profiler ranges the script opens itself (they also appear as device-side
# ranges): never counted as device time
ANNOTATIONS = ("chip_smoke.step",)


def _device_time(prof):
    """(device busy ms as the union of kernel intervals, or None without
    device events; [(kernel name, device ms, calls)] largest first)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in ANNOTATIONS)
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
         if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0
         and a.key not in ANNOTATIONS),
        key=lambda x: -x[1],
    )
    return (busy_us / 1e3 if spans else None), by_name


# ---------------------------------------------------------------------------
# api
# ---------------------------------------------------------------------------


class ApiRequest:
    """What LLMServer takes: an HTTP request's method, path and JSON body."""

    def __init__(self, method: str, path: str, body=None):
        self.method, self.path, self.body = method, path, body

    def json(self):
        return self.body


class IdTextTokenizer:
    """The api phase's tokenizer: ByteTokenizer's encoding (UTF-8 bytes +
    BOS, so the prompts have the engine phase's token lengths) and a decode
    that writes every id as "<id>". With random weights nearly every token
    is past ByteTokenizer's 256 byte ids, which it decodes to nothing: this
    decode gives each token its text, so completions and stream deltas
    carry every token."""

    def __init__(self, vocab_size: int):
        from ray_tpu_torch.llm import ByteTokenizer

        self._bytes = ByteTokenizer(vocab_size)
        self.eos_token_id = self._bytes.eos_token_id

    def encode(self, text: str) -> list:
        return self._bytes.encode(text)

    def decode(self, ids: list) -> str:
        return "".join(f"<{i}>" for i in ids)


def _api_traffic(seed: int = 0) -> tuple:
    """The engine phase's 12 requests as /v1/completions bodies: random
    printable ASCII whose ByteTokenizer encodings (BOS included) have the
    engine phase's lengths (numpy seed 0: 64-1536 tokens), requests 0 and
    11 on one 512-character prefix, 32 outputs, 10 greedy and 2 seeded
    top-k/top-p; no ignore_eos, so a stream may stop on EOS. Then the two
    chat bodies and the two generate_stream prompts that ride along."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1537, size=12)

    def text(n):
        return rng.integers(32, 127, size=int(n)).astype(np.uint8).tobytes().decode()

    texts = [text(n - 1) for n in lens]
    shared = text(512)
    texts[0] = shared + texts[0][: int(lens[0]) - 1 - 512]
    texts[11] = shared + texts[11][: int(lens[11]) - 1 - 512]
    greedy = {"max_tokens": 32, "temperature": 0.0}
    bodies = [{"prompt": t, **greedy} for t in texts[:10]]
    bodies += [{"prompt": t, "max_tokens": 32, "temperature": 0.8, "top_k": 50, "top_p": 0.9,
                "seed": 100 + i} for i, t in enumerate(texts[10:])]
    chats = [{"messages": [{"role": "system", "content": text(80)},
                           {"role": "user", "content": text(n)}], **greedy} for n in (120, 300)]
    streams = [text(n) for n in (200, 400)]
    return bodies, chats, streams


def _record_requests(eng) -> dict:
    """Wrap ``eng.add_request`` (called on the runner's loop thread) so the
    engine's Request objects stay readable after they finish: rid ->
    Request."""
    reqs: dict = {}
    add = eng.add_request

    def recording(*args, **kwargs):
        rid = add(*args, **kwargs)
        reqs[rid] = eng.requests[rid]
        return rid

    eng.add_request = recording
    return reqs


def _api_pass(server, recorded: dict, bodies, chats, streams) -> dict:
    """One pass of the api traffic, all sent together on one event loop:
    the completions, the chats and the streams. Client-side wall, tok/s
    (every output token the server made for the pass / wall; also the 12
    completions' alone), engine TTFT (first token booked - arrival) and the
    streams' client TTFT (first delta - the pass's start)."""
    import asyncio

    import numpy as np
    import torch

    recorded.clear()
    server.runner.call(lambda: server.engine.allocator.drop_prefix_cache())

    async def stream(prompt, t0):
        first, deltas = None, []
        async for d in server.generate_stream(prompt, max_tokens=32, temperature=0.0):
            if first is None:
                first = time.perf_counter() - t0
            deltas.append(d)
        return first, "".join(deltas)

    async def go():
        t0 = time.perf_counter()
        outs = await asyncio.gather(
            *[server(ApiRequest("POST", "/v1/completions", b)) for b in bodies],
            *[server(ApiRequest("POST", "/v1/chat/completions", b)) for b in chats],
            *[stream(p, t0) for p in streams])
        return outs, time.perf_counter() - t0

    torch.cuda.synchronize()
    outs, wall = asyncio.run(go())
    torch.cuda.synchronize()
    n_cmpl = len(bodies)
    completions, chat_outs, stream_outs = (outs[:n_cmpl], outs[n_cmpl:n_cmpl + len(chats)],
                                           outs[n_cmpl + len(chats):])
    for o in completions + chat_outs:
        if "choices" not in o:
            raise AssertionError(f"api: a request failed: {o}")
        for ch in o["choices"]:
            if ch["finish_reason"] not in ("length", "stop"):
                raise AssertionError(f"api: finish_reason {ch['finish_reason']!r}")
    for o in completions:
        n, reason = o["usage"]["completion_tokens"], o["choices"][0]["finish_reason"]
        if not (n == 32 or reason == "stop"):
            raise AssertionError(f"api: {n} tokens, finish {reason!r}, not 32 or a stop")
    if len(recorded) != len(bodies) + len(chats) + len(streams):
        raise AssertionError(f"api: {len(recorded)} engine requests for the pass")
    tokens = sum(len(r.output_token_ids) for r in recorded.values())
    cmpl_tokens = sum(o["usage"]["completion_tokens"] for o in completions)
    finishes = [o["choices"][0]["finish_reason"] for o in completions + chat_outs]
    return {
        "wall_s": wall, "output_tokens": tokens, "output_tok_per_s": tokens / wall,
        "completions_output_tok_per_s": cmpl_tokens / wall,
        "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival for r in recorded.values()])),
        "stream_ttft_s": [first for first, _ in stream_outs],
        "finish_reasons": {k: finishes.count(k) for k in sorted(set(finishes))},
        "completions": completions, "streams": [t for _, t in stream_outs],
    }


def _frontend_ab(server, recorded: dict, bodies) -> dict:
    """The host cost of the front end on like-for-like traffic: the 12
    completions alone, served through the LLMServer and handed to
    ``LLMEngine.generate`` on the runner's loop thread (the same engine,
    graphs and sampling parameters), in turns S E E S S E, then one pass
    of each under torch.profiler for the device's idle share. Each pass
    starts from an empty prefix cache; tok/s is every output token the
    engine made over the pass's wall."""
    import asyncio

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = server.engine
    ids = [server.tokenizer.encode(b["prompt"]) for b in bodies]
    sps = [server._sampling_from_body(b) for b in bodies]

    def served():
        recorded.clear()

        async def go():
            t0 = time.perf_counter()
            outs = await asyncio.gather(
                *[server(ApiRequest("POST", "/v1/completions", b)) for b in bodies])
            return outs, time.perf_counter() - t0

        outs, wall = asyncio.run(go())
        if any("choices" not in o for o in outs):
            raise AssertionError(f"api A/B: a request failed: {outs}")
        return wall, sum(len(r.output_token_ids) for r in recorded.values())

    def direct():
        t0 = time.perf_counter()
        outs = server.runner.call(lambda: eng.generate(ids, sps))
        return time.perf_counter() - t0, sum(len(o) for o in outs)

    def run(fn):
        server.runner.call(lambda: eng.allocator.drop_prefix_cache())
        c0 = sum(g.captures for g in _families(eng))
        torch.cuda.synchronize()
        wall, tokens = fn()
        torch.cuda.synchronize()
        return {"wall_s": wall, "output_tokens": tokens, "output_tok_per_s": tokens / wall,
                "graphs_captured": sum(g.captures for g in _families(eng)) - c0}

    t0 = time.perf_counter()
    order = "SEESSE"
    passes = [{"path": k, **run(served if k == "S" else direct)} for k in order]
    res = {"order": order, "passes": passes, "turns_s": time.perf_counter() - t0}
    for k, name in (("S", "server"), ("E", "engine")):
        res[f"{name}_tok_per_s_median"] = float(np.median(
            [p["output_tok_per_s"] for p in passes if p["path"] == k]))
    res["server_over_engine"] = res["server_tok_per_s_median"] / res["engine_tok_per_s_median"]
    for k, name in (("S", "server"), ("E", "engine")):
        # device events only: no host op is recorded, so the profiler adds
        # no host time to either path, and its trace is quick to read
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            p = run(served if k == "S" else direct)
        busy_ms, _ = _device_time(prof)
        res[f"profiled_{name}"] = {
            **p, "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / 1e3 / p["wall_s"],
            "with_profiler_s": time.perf_counter() - t0}
    return res


def api_phase(dev, params, engine_res: dict) -> dict:
    """LLAMA3_8B served through the port's OpenAI front end (LLMServer over
    the engine phase's configuration and weights, the model resolved by the
    registry): the engine phase's 12 requests as text completions with two
    chats and two token streams riding along, a first pass, four more (the
    steady reading: the median of those that captured no graph) and one
    under torch.profiler; the 12 completions alone through the server and
    through ``LLMEngine.generate`` in turns (``_frontend_ab``); then the
    checks: /v1/models, a streamed
    greedy request's deltas against its completion, a preemption during a
    mixed step and a crash during a pipelined decode chunk (every position
    delivered once, two recoveries), a burst past max_queue_depth (429s
    with Retry-After), and 503 after a drain."""
    import asyncio

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm import EngineConfig, EnginePreempted, LLMConfig, LLMServer
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.admission import (
        AdmissionConfig,
        AdmissionController,
        retry_after_header,
    )
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    t_phase = t0 = time.perf_counter()
    cfg = EngineConfig(model="llama3-8b", **ENGINE_KW)
    server = LLMServer(LLMConfig(model_id="llama3-8b", engine=cfg, params=params,
                                 tokenizer=IdTextTokenizer(cfg.model.vocab_size),
                                 device=str(dev)))
    init_s = time.perf_counter() - t0
    eng = server.engine
    recorded = _record_requests(eng)
    model = eng.config.model
    res = {"phase": "api", "model": "LLAMA3_8B (registry name llama3-8b)", "dtype": "bfloat16",
           "layers": model.n_layers, "d_model": model.d_model, "server_init_s": init_s}
    bodies, chats, streams = _api_traffic()
    res["requests"] = {"completions": len(bodies), "chats": len(chats), "streams": len(streams),
                       "prompt_tokens": [len(server.tokenizer.encode(b["prompt"]))
                                         for b in bodies]}
    models = asyncio.run(server(ApiRequest("GET", "/v1/models")))
    card = models["data"][0]
    if card["id"] != "llama3-8b" or card["max_model_len"] != 8192:
        raise AssertionError(f"api: /v1/models says {models}")

    # the main path: the counters zeroed just before the first pass, read
    # just after (eager launches + those of graph replays)
    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    marks = _launch_marks(eng)
    pmarks = _pass_marks(eng)
    first = _api_pass(server, recorded, bodies, chats, streams)
    launches = _launch_counts(eng, marks)
    res["first_pass_graphs"] = _pass_graphs(eng, pmarks)
    if min(launches.values()) <= 0:
        raise AssertionError(f"api: a kernel of the path never launched: {launches}")
    res["kernel_launches"] = launches
    summary = lambda p: {k: v for k, v in p.items() if k not in ("completions", "streams")}  # noqa: E731
    res["first"] = summary(first)
    if None in first["stream_ttft_s"]:
        raise AssertionError("api: a stream yielded no delta")
    # four more passes: the chunk controller may step to a longer chunk in
    # any of them and capture its graph (seconds of the pass), so "warm" is
    # the second pass and "steady" the median of the passes that captured
    # no graph
    passes = []
    for _ in range(4):
        c0 = sum(g.captures for g in _families(eng))
        p = summary(_api_pass(server, recorded, bodies, chats, streams))
        passes.append({**p, "graphs_captured": sum(g.captures for g in _families(eng)) - c0})
    res["warm"] = passes[0]
    read = [p for p in passes if not p["graphs_captured"]] or passes
    res["steady"] = {
        "output_tok_per_s": float(np.median([p["output_tok_per_s"] for p in read])),
        "completions_output_tok_per_s": float(np.median(
            [p["completions_output_tok_per_s"] for p in read])),
        "mean_ttft_s": float(np.median([p["mean_ttft_s"] for p in read])),
        "stream_ttft_s": [float(np.median([p["stream_ttft_s"][i] for p in read]))
                          for i in range(len(streams))],
        "passes_read": len(read), "passes": passes,
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = _api_pass(server, recorded, bodies, chats, streams)
    busy_ms, by_name = _device_time(prof)
    res["profiled"] = {
        **summary(profiled), "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / 1e3 / profiled["wall_s"],
        "paged_attention_ms": sum(ms for k, ms, _ in by_name if "paged_attention_" in k),
        "ragged_attention_ms": sum(ms for k, ms, _ in by_name if "ragged_attention_" in k),
        "gemm_ms": sum(ms for k, ms, _ in by_name if any(w in k for w in GEMM_WORDS)),
    }
    eng_prof = engine_res["profile"]
    res["engine_phase"] = {
        "output_tok_per_s": {"first": engine_res["output_tok_per_s"],
                             "warm": engine_res["warm"]["output_tok_per_s"],
                             "steady": engine_res["steady"]["output_tok_per_s"]},
        "mean_ttft_s": {"first": engine_res["mean_ttft_s"],
                        "warm": engine_res["warm"]["mean_ttft_s"],
                        "steady": engine_res["steady"]["mean_ttft_s"]},
        "profiled_device_busy_ms": eng_prof["device_busy_ms"],
        "profiled_device_idle_share": eng_prof["device_idle_share"],
        "note": "12 requests, 32 tokens each (ignore_eos); the api pass adds 2 chats and 2 "
                "streams, so its decode batch is 16 rows where the engine phase's is 12 "
                "(both pad to B_pad 16)",
    }
    res["steady_tok_per_s_over_engine_phase"] = (
        res["steady"]["output_tok_per_s"] / engine_res["steady"]["output_tok_per_s"])
    res["frontend_ab"] = _frontend_ab(server, recorded, bodies)

    # a greedy request alone, as a completion and then as a token stream on
    # the same batch shapes (prefix cache emptied before each): the deltas
    # join to the completion's text
    probe = {"prompt": bodies[1]["prompt"], "max_tokens": 32, "temperature": 0.0}
    texts = []
    for kind in ("completion", "stream"):
        server.runner.call(lambda: eng.allocator.drop_prefix_cache())

        async def one():
            if kind == "completion":
                return (await server(ApiRequest("POST", "/v1/completions", probe)))[
                    "choices"][0]["text"]
            return "".join([d async for d in server.generate_stream(
                probe["prompt"], max_tokens=32, temperature=0.0)])

        texts.append(asyncio.run(one()))
    if texts[0] != texts[1] or not texts[0]:
        raise AssertionError(f"api: the streamed deltas do not join to the completion's "
                             f"text: {texts}")
    res["stream_equals_completion"] = {"tokens": texts[0].count("<"), "equal": True}

    # recovery at 8B: a preemption raised before a mixed step (a prompt
    # mid-prefill), then a crash raised after a step that left a pipelined
    # decode chunk in flight (its outputs lost); every request must get
    # each of its 32 positions exactly once
    faults = {"preempted": None, "crashed": None, "steps": 0}
    step = eng.step

    def faulty_step():
        faults["steps"] += 1
        if faults["preempted"] is None and faults["steps"] >= 3 and eng._mixed_prefills:
            faults["preempted"] = faults["steps"]
            raise EnginePreempted("injected before a mixed step")
        out = step()
        if (faults["preempted"] is not None and faults["crashed"] is None
                and eng._pipe_inflight is not None and not eng._mixed_prefills):
            faults["crashed"] = faults["steps"]
            raise RuntimeError("injected during a pipelined decode chunk")
        return out

    server.runner.call(lambda: eng.allocator.drop_prefix_cache())
    recoveries0 = server.stats()["engine_recoveries"]
    eng.step = faulty_step
    ids = [server.tokenizer.encode(b["prompt"]) for b in bodies]
    sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    t0 = time.perf_counter()
    # posted together, so the loop admits them in one step
    subs = [f.result() for f in [server.runner.submit_future(p, sp) for p in ids]]
    delivered_ok = 0
    for rid, q in subs:
        got, final = [], None
        while final is None:
            out = q.get(timeout=300)
            if isinstance(out, BaseException) or out is None:
                raise AssertionError(f"api recovery: {rid} got {out!r}")
            got += out.new_token_ids
            if out.finished:
                final = out.output_token_ids
        if got != final or len(final) != 32:
            raise AssertionError(f"api recovery: {rid} delivered {len(got)} positions, final "
                                 f"{len(final)}, equal {got == final}")
        delivered_ok += 1
    recovery_wall = time.perf_counter() - t0
    del eng.step  # the class's step again
    stats = server.stats()
    if faults["preempted"] is None or faults["crashed"] is None:
        raise AssertionError(f"api recovery: a fault never fired: {faults}")
    if stats["engine_recoveries"] - recoveries0 != 2:
        raise AssertionError(f"api recovery: {stats['engine_recoveries']} recoveries, not 2")
    if stats["free_blocks"] != stats["total_blocks"]:
        raise AssertionError(f"api recovery: KV not returned: {stats['free_blocks']}")
    res["recovery"] = {"faults_at_step": {k: faults[k] for k in ("preempted", "crashed")},
                       "engine_recoveries": stats["engine_recoveries"],
                       "requests_each_position_once": f"{delivered_ok}/{len(subs)}",
                       "wall_s": recovery_wall, "num_preemptions": eng.num_preemptions}

    # a burst of 24 past max_queue_depth 3: every admission check runs
    # before any of them enqueues, so the reservations admit 3 and shed 21
    saved = server.admission
    server.admission = AdmissionController(AdmissionConfig(max_queue_depth=3),
                                           model_tag="llama3-8b")

    async def burst():
        return await asyncio.gather(*[server.completions(
            {"prompt": b["prompt"], "max_tokens": 8, "temperature": 0.0})
            for b in (bodies * 2)[:24]])

    outs = asyncio.run(burst())
    shed = [o for o in outs if o.get("error", {}).get("code") == 429]
    admitted = [o for o in outs if "choices" in o]
    if not shed or len(shed) + len(admitted) != 24 or server._admit_reserved != 0:
        raise AssertionError(f"api burst: {len(shed)} shed, {len(admitted)} admitted")
    for o in shed:
        if not retry_after_header(o):
            raise AssertionError(f"api burst: a 429 without Retry-After: {o}")
    for o in admitted:
        if o["usage"]["completion_tokens"] != 8 and o["choices"][0]["finish_reason"] != "stop":
            raise AssertionError(f"api burst: an admitted request did not finish: {o}")
    res["burst"] = {"requests": 24, "max_queue_depth": 3, "admitted": len(admitted),
                    "shed_429": len(shed), "retry_after_header": retry_after_header(shed[0])}
    server.admission = saved

    # drain: in-flight work finishes, a new request gets 503
    drained = asyncio.run(server(ApiRequest("POST", "/v1/drain", {"timeout_s": 30.0})))
    late = asyncio.run(server(ApiRequest("POST", "/v1/completions", probe)))
    if not drained["drained"] or late.get("error", {}).get("code") != 503:
        raise AssertionError(f"api drain: {drained}, then {late}")
    res["drain"] = {**drained, "then": late["error"]["code"],
                    "retry_after_header": retry_after_header(late)}
    res["stats_after"] = {k: stats[k] for k in ("num_waiting", "num_running", "free_blocks",
                                                 "engine_recoveries", "admission")}
    server.shutdown()
    if server.runner._thread.is_alive():
        raise AssertionError("api: the engine loop did not stop")
    del server, eng
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# disagg
# ---------------------------------------------------------------------------


def _disagg_connector(namespace: str):
    """The disagg phase's in-process connector: it keeps each request's last
    handoff while ``keep`` is set (for the read-back check) and flips bytes
    of the handoff of request ``corrupt`` once (the reference's chaos
    corruption, not re-sealed)."""
    from ray_tpu_torch.llm.disagg import InProcessConnector
    from ray_tpu_torch.llm.disagg.connector import _corrupt_handoff

    class Recording(InProcessConnector):
        def __init__(self):
            super().__init__(namespace)
            self.keep, self.sent, self.corrupt, self.corrupted = False, {}, None, 0

        def send(self, target, handoff, timeout_s=30.0):
            if self.keep:
                self.sent[handoff.request_id] = handoff
            if handoff.request_id == self.corrupt:
                self.corrupt = None
                self.corrupted += 1
                handoff = _corrupt_handoff(handoff)
            super().send(target, handoff, timeout_s)

    return Recording()


def _watch_steps(eng, windows: list, hooks: dict) -> None:
    """Wrap ``eng.step`` (it runs on the engine's loop thread): each step's
    host window and whether it captured a graph go to ``windows``; a
    callable left in ``hooks["before_step"]`` runs once, before the next
    step, on that thread."""
    step = eng.step

    def watched():
        hook = hooks.pop("before_step", None)
        if hook is not None:
            hook()
        n0 = sum(f.captures for f in _families(eng))
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            windows.append((t0, time.perf_counter(),
                            sum(f.captures for f in _families(eng)) > n0))

    eng.step = watched


def _capture_overlap(windows: dict) -> dict:
    """Seconds during which an engine's capturing steps overlapped the
    other engine's steps, and how many capturing steps did."""
    out = {}
    for a, b in (("prefill", "decode"), ("decode", "prefill")):
        secs, steps = 0.0, 0
        for s, e, captured in windows[a]:
            if not captured:
                continue
            o = sum(max(0.0, min(e, e2) - max(s, s2)) for s2, e2, _ in windows[b])
            secs += o
            steps += o > 0
        out[f"{a}_capturing_while_{b}_steps"] = {"seconds": secs, "capturing_steps": steps}
    return out


def _pool_marks(pe) -> dict:
    """Per serving kernel, for one engine of the orchestrator: its loop
    thread's launch tally (read on that thread), the launches of its graph
    replays and those recorded into its captures."""
    from ray_tpu_torch.ops.paged_attention import thread_launches

    tally = pe.call(thread_launches)
    fams = _families(pe.engine)
    return {n: {"tally": tally.get(n, 0),
                "replayed": sum(g.launches.get(n, 0) for g in fams),
                "captured": sum(g.captured_launches.get(n, 0) for g in fams)}
            for n in ("paged_attention", "ragged_attention")}


def _pool_launches(before: dict, after: dict) -> dict:
    """Launches on the device between two ``_pool_marks``: eager (launches
    outside graphs: warm-ups and eager calls) plus those of replays."""
    out = {}
    for n in before:
        d = {k: after[n][k] - before[n][k] for k in before[n]}
        eager = d["tally"] - d["captured"]
        out[n] = {"device": eager + d["replayed"], "eager": eager, "in_replays": d["replayed"]}
    return out


def _hold(pe):
    """Park an engine's loop at its next step boundary until the returned
    event is set (what is posted meanwhile is drained right after); returns
    once the loop is parked."""
    import threading

    parked, release = threading.Event(), threading.Event()

    def hold():
        parked.set()
        release.wait(timeout=300)

    pe.post(hold)
    if not parked.wait(timeout=300):
        raise AssertionError(f"disagg: the {pe.role} loop did not park")
    return release


def _disagg_pass(orch, conn, prompts, sps, tag: str, gated: bool = False) -> dict:
    """Serve the 12 requests through the orchestrator. Ungated as the engine
    phase serves them: 11 at once, the last (the second on the shared
    prefix) once the first has its first token. Gated: the prefill loop is
    parked while all 12 are posted, so one step admits them all, and the
    decode loop is parked until the 12 handoffs are sent, so it imports
    them at one step boundary and decodes them as one batch from the first
    step (the same batch shapes in every gated pass: the same bf16 bits)."""
    import queue

    import torch

    out_q: queue.Queue = queue.Queue()

    class Sink:
        def __init__(self, rid):
            self.rid = rid

        def put(self, item):
            out_q.put((self.rid, time.perf_counter(), item))

    n = len(prompts)
    pe, de = orch._prefill[0], orch._decode[0]
    hand0 = len(orch.handoffs)
    sent0 = conn.num_sent
    caps0 = {r: (sum(f.captures for f in _families(p.engine)),
                 sum(f.capture_s for f in _families(p.engine)))
             for r, p in (("prefill", pe), ("decode", de))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    holds = (_hold(pe), _hold(de)) if gated else None
    t0 = time.perf_counter()
    t_submit = {}

    def submit(i):
        rid = f"{tag}{i}"
        t_submit[rid] = time.perf_counter()
        return orch.submit_future(prompts[i], sps[i], request_id=rid, sink=Sink(rid))

    first, last, finals = {}, {}, {}
    try:
        futs = [submit(i) for i in range(n if gated else n - 1)]
        if gated:
            holds[0].set()
            deadline = time.time() + 300
            while conn.num_sent - sent0 < n:
                if time.time() > deadline:
                    raise AssertionError(f"disagg: {conn.num_sent - sent0} of {n} handoffs sent")
                time.sleep(0.002)
            holds[1].set()
        while len(finals) < n:
            rid, t, item = out_q.get(timeout=300)
            if isinstance(item, BaseException) or item is None:
                raise AssertionError(f"disagg: request {rid} failed: {item!r}")
            if item.new_token_ids:
                first.setdefault(rid, t)
            if item.finished:
                finals[rid] = item.output_token_ids
                last[rid] = t
            if not gated and len(futs) < n and f"{tag}0" in first:
                futs.append(submit(n - 1))
    finally:
        for ev in holds or ():
            ev.set()
    wall = time.perf_counter() - t0
    for f in futs:
        f.result()
    torch.cuda.synchronize()
    hand = list(orch.handoffs)[hand0:]
    stages = ("pin_ms", "gather_ms", "d2h_ms", "seal_ms", "verify_ms", "h2d_ms", "scatter_ms")
    graphs = {}
    for r, p in (("prefill", pe), ("decode", de)):
        c0, s0 = caps0[r]
        graphs[r] = {"captured": sum(f.captures for f in _families(p.engine)) - c0,
                     "capture_s": sum(f.capture_s for f in _families(p.engine)) - s0}
    return {
        "finals": finals,
        "wall_s": wall, "output_tok_per_s": sum(map(len, finals.values())) / wall,
        "mean_ttft_s": sum(first[r] - t_submit[r] for r in finals) / n,
        "mean_tpot_s": sum((last[r] - first[r]) / max(1, len(finals[r]) - 1)
                           for r in finals) / n,
        "handoffs": len(hand), "bytes_handed_off": sum(h["bytes"] for h in hand),
        "handoff_ms": {s: {"mean": sum(h[s] for h in hand) / len(hand),
                           "min": min(h[s] for h in hand), "max": max(h[s] for h in hand)}
                       for s in stages if all(s in h for h in hand)} if hand else {},
        "largest_handoff_ms": {s: v for s, v in max(hand, key=lambda h: h["bytes"]).items()
                               if s in stages} if hand else {},
        "graphs": graphs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }


def _readback(eng, sent: dict, out: dict):
    """On the decode loop, before the first step after the imports: every
    imported request's K/V in the live cache equals its handoff's pages,
    bit for bit."""
    import torch

    def check():
        same = 0
        for rid, h in sent.items():
            req = eng.requests[rid]
            slots = torch.as_tensor(req.seq.slots_for_range(0, h.num_kv_tokens),
                                    device=eng.device)
            same += all(torch.equal(eng.cache[n].index_select(2, slots).cpu(), p)
                        for n, p in (("k", h.k_pages), ("v", h.v_pages)))
        out["requests"], out["bits_equal"] = len(sent), same

    return check


def disagg_phase(dev, params, engine_res: dict) -> dict:
    """LLAMA3_8B disaggregated: one DisaggOrchestrator, one prefill and one
    decode engine (each ENGINE_KW, on its own loop thread, sharing the
    engine phase's weights), the in-process connector; the engine phase's
    12 requests: a first pass (both engines capture while the other works),
    three more (steady: the median of those that captured no graph), two
    gated passes (one batch shape: the bf16 streams equal; the first reads
    every import back from the live cache) and a gated pass with one
    handoff corrupted in flight (re-prefilled once); then two completions
    through LLMServer(disagg=)."""
    import asyncio
    import gc

    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer
    from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator
    from ray_tpu_torch.models.llama import LLAMA3_8B
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    t_phase = time.perf_counter()
    model = LLAMA3_8B
    prompts, sps = _engine_traffic(model)
    conn = _disagg_connector("chip-disagg")
    t0 = time.perf_counter()
    orch = DisaggOrchestrator(
        DisaggConfig(engine=EngineConfig(model=model, **ENGINE_KW), num_prefill=1,
                     num_decode=1, connector="inproc"),
        params=params, model_tag="chip-disagg", connector=conn, device=dev)
    res = {"phase": "disagg", "model": "LLAMA3_8B", "dtype": "bfloat16",
           "layers": model.n_layers, "d_model": model.d_model, "requests": 12,
           "prompt_tokens": int(sum(map(len, prompts))), "output_tokens": 12 * 32,
           "init_s": time.perf_counter() - t0}
    try:
        pe, de = orch._prefill[0], orch._decode[0]
        flat = [(k, v) for k, v in params.items() if torch.is_tensor(v)]
        flat += [(f"{k}.{n}", t) for k, v in params.items() if not torch.is_tensor(v)
                 for n, t in v.items()]
        for p in (pe, de):
            got = p.engine.params
            for name, t in flat:
                a = got[name] if "." not in name else got[name.split(".")[0]][name.split(".")[1]]
                if a.data_ptr() != t.data_ptr():
                    raise AssertionError(f"disagg: {p.role} engine holds a copy of {name}")
        res["weights_shared"] = True
        cache_ptrs = {n: t.data_ptr() for n, t in de.engine.cache.items()}
        windows = {"prefill": [], "decode": []}
        hooks = {"prefill": {}, "decode": {}}
        for p in (pe, de):
            _watch_steps(p.engine, windows[p.role], hooks[p.role])

        # the first pass: the kernels' counters zeroed just before it
        paged_attention_cuda.launches = 0
        ragged_attention_cuda.launches = 0
        marks = {p.role: _pool_marks(p) for p in (pe, de)}
        first = _disagg_pass(orch, conn, prompts, sps, "d")
        launches = {p.role: _pool_launches(marks[p.role], _pool_marks(p)) for p in (pe, de)}
        total = {n: paged_attention_cuda.launches if n == "paged_attention"
                 else ragged_attention_cuda.launches for n in ("paged_attention",
                                                               "ragged_attention")}
        tallied = {n: sum(launches[r][n]["eager"] for r in launches) for n in total}
        # every wrapper launch of the pass is booked to one engine's thread
        captured = {n: sum(_pool_marks(p)[n]["captured"] - marks[p.role][n]["captured"]
                           for p in (pe, de)) for n in total}
        if {n: tallied[n] + captured[n] for n in total} != total:
            raise AssertionError(f"disagg: per-thread launch tallies {tallied} + captured "
                                 f"{captured} != the wrappers' counts {total}")
        finals = first.pop("finals")
        st = orch.stats()
        pre_st, dec_st = st["prefill"][0], st["decode"][0]
        _check_served(de.engine, finals, model, 12, 32)
        if st["transfer"]["kv_transfers"] != 12 or st["transfer"]["reprefills"] != 0:
            raise AssertionError(f"disagg: {st['transfer']}")
        if dec_st["num_prefill_batches"] != 0 or dec_st.get("mixed", {}).get("dispatches", 0):
            raise AssertionError("disagg: the decode engine ran a prefill or a mixed step")
        _check_packed_replays(pre_st["mixed"]["graphs"], pre_st["mixed"]["dispatches"],
                              "disagg prefill engine: mixed steps")
        graphs = dec_st["pipeline"]["graphs"]
        if graphs["replays"] <= 0 or launches["decode"]["paged_attention"]["in_replays"] <= 0:
            raise AssertionError(f"disagg: no decode chunk replay with the paged kernel: {graphs}")
        if launches["decode"]["ragged_attention"]["device"] or \
                launches["prefill"]["paged_attention"]["device"]:
            raise AssertionError(f"disagg: a kernel ran in the wrong pool: {launches}")
        overlap = _capture_overlap(windows)
        if not any(v["capturing_steps"] for v in overlap.values()):
            raise AssertionError(f"disagg: no capture overlapped the other engine's work: "
                                 f"{overlap}")
        first_tokens = engine_res["first_pass_tokens"]
        res["first"] = {**first, "kernel_launches": launches, "capture_overlap": overlap,
                        "greedy_streams_equal_engine_phase": sum(
                            finals[f"d{i}"] == first_tokens[f"r{i}"] for i in range(10))}
        res["kernel_launches"] = {n: sum(launches[r][n]["device"] for r in launches)
                                  for n in total}

        # three more passes (the decode engine's batch shapes follow the
        # handoffs' timing, so a later pass may still capture a bucket)
        passes, steady = [], []
        for k in range(3):
            for p in (pe, de):
                p.call(p.engine.allocator.drop_prefix_cache)
            r = _disagg_pass(orch, conn, prompts, sps, f"s{k}")
            f = r.pop("finals")
            r["greedy_streams_equal_first_pass"] = sum(f[f"s{k}{i}"] == finals[f"d{i}"]
                                                       for i in range(10))
            passes.append(r)
            if not any(g["captured"] for g in r["graphs"].values()):
                steady.append(r)
        res["passes"] = passes
        res["steady_from"] = f"{len(steady)} capture-free of {len(passes)}"
        if steady:
            steady.sort(key=lambda r: r["output_tok_per_s"])
            res["steady"] = steady[len(steady) // 2]

        # gated passes (the first captures the 12-row batch's graphs): the
        # second one's imports land after every graph it replays was captured
        fams = _families(de.engine)
        gated, back = [], {}
        for k in range(2):
            for p in (pe, de):
                p.call(p.engine.allocator.drop_prefix_cache)
            if k == 1:
                keys0 = [set(f._graphs) for f in fams]
                replays0 = [dict(f.replays_by_key) for f in fams]
                conn.keep, conn.sent = True, {}
                hooks["decode"]["before_step"] = _readback(de.engine, conn.sent, back)
            gated.append(_disagg_pass(orch, conn, prompts, sps, "g", gated=True))
        conn.keep, conn.sent = False, {}
        reused = sum(f.replays_by_key[key] - r0.get(key, 0)
                     for f, keys, r0 in zip(fams, keys0, replays0) for key in keys)
        same_ptrs = {n: t.data_ptr() for n, t in de.engine.cache.items()} == cache_ptrs
        equal = sum(gated[0]["finals"][f"g{i}"] == gated[1]["finals"][f"g{i}"]
                    for i in range(12))
        res["gated"] = {"readback": back, "replays_of_graphs_captured_before": reused,
                        "graphs_captured": [sum(g["graphs"][r]["captured"] for r in g["graphs"])
                                            for g in gated],
                        "cache_tensors_unchanged": same_ptrs, "streams_equal": f"{equal}/12",
                        "tok_per_s": [g["output_tok_per_s"] for g in gated]}
        if back.get("bits_equal") != 12 or back.get("requests") != 12:
            raise AssertionError(f"disagg: imported K/V read back from the live cache: {back}")
        if not same_ptrs or reused <= 0 or equal != 12:
            raise AssertionError(f"disagg: imports after capture: {res['gated']}")

        # a handoff corrupted in flight: verify fails, one re-prefill; the
        # 11 others keep their batch shapes (the corrupted request is the
        # last exported, and not the one that sets the block-table width)
        victim = "g11"
        for p in (pe, de):
            p.call(p.engine.allocator.drop_prefix_cache)
        n_re, n_fail = orch.num_reprefills, orch.num_transfer_failures
        conn.corrupt = victim
        bad = _disagg_pass(orch, conn, prompts, sps, "g", gated=True)
        clean = gated[1]["finals"]
        others = sum(bad["finals"][f"g{i}"] == clean[f"g{i}"] for i in range(11))
        res["corrupted"] = {
            "request": victim, "corrupted_sends": conn.corrupted,
            "reprefills": orch.num_reprefills - n_re,
            "transfer_failures": orch.num_transfer_failures - n_fail,
            "tokens": len(bad["finals"][victim]),
            "first_token_equal_clean": bad["finals"][victim][:1] == clean[victim][:1],
            "stream_equal_clean": bad["finals"][victim] == clean[victim],
            "other_streams_equal_clean": f"{others}/11",
        }
        c = res["corrupted"]
        if (c["corrupted_sends"], c["reprefills"], c["transfer_failures"], c["tokens"]) != \
                (1, 1, 1, 32) or not c["first_token_equal_clean"] or others != 11:
            raise AssertionError(f"disagg: corrupted handoff: {c}")
        st = orch.stats()
        res["graphs"] = {p.role: {"captured": sum(f.captures for f in _families(p.engine)),
                                  "capture_s": sum(f.capture_s for f in _families(p.engine)),
                                  "replays": sum(f.replays for f in _families(p.engine)),
                                  "buckets": [str(k) for f in _families(p.engine)
                                              for k in f.capture_s_by_key]}
                         for p in (pe, de)}
        res["transfer"] = st["transfer"]
        _check_packed_replays(st["prefill"][0]["mixed"]["graphs"],
                              st["prefill"][0]["mixed"]["dispatches"],
                              "disagg prefill engine: mixed steps, every pass")
    finally:
        orch.shutdown()
    del orch, pe, de
    gc.collect()
    torch.cuda.empty_cache()

    # two completions through the OpenAI front end, disaggregated
    bodies, _chats, _streams = _api_traffic()
    cfg = EngineConfig(model="llama3-8b", **ENGINE_KW)
    server = LLMServer(LLMConfig(model_id="llama3-8b", engine=cfg, params=params,
                                 tokenizer=IdTextTokenizer(cfg.model.vocab_size),
                                 device=str(dev), disagg={"num_prefill": 1, "num_decode": 1}))
    try:
        async def go():
            outs = await asyncio.gather(*[server(ApiRequest("POST", "/v1/completions", b))
                                          for b in bodies[:2]])
            return outs, await server(ApiRequest("GET", "/v1/stats"))

        outs, stats = asyncio.run(go())
    finally:
        server.shutdown()
    n_out = [o["usage"]["completion_tokens"] for o in outs]
    res["api"] = {"completion_tokens": n_out, "mode": stats.get("mode"),
                  "kv_transfers": stats["transfer"]["kv_transfers"],
                  "decode_prefill_batches": stats["decode"][0]["num_prefill_batches"]}
    if stats.get("mode") != "disagg" or stats["transfer"]["kv_transfers"] != 2 or \
            any(not (0 < n <= 32) for n in n_out):
        raise AssertionError(f"disagg: LLMServer(disagg=): {res['api']}")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


PARITY_MODEL = dict(vocab_size=2048, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2,
                    d_ff=1024, max_seq=512)


def _parity_setup(dev):
    """The fp32 parity model's weights on the CPU and the card, and its
    greedy prompts."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    model = LlamaConfig(**PARITY_MODEL, dtype=torch.float32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    params_cpu = init_params(model, gen, "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, model.vocab_size, size=int(n)).tolist()
               for n in (5, 37, 90, 130, 200, 17)]
    return model, params_cpu, _to(params_cpu, dev), prompts


def _to(params, dev):
    import torch

    return {k: (v.to(dev) if torch.is_tensor(v) else {kk: vv.to(dev) for kk, vv in v.items()})
            for k, v in params.items()}


# the parity phase's adapters: every target, two adapters and base rows
PARITY_LORA_KW = dict(max_loras=2, lora_rank=8, lora_targets=("wq", "wk", "wv"))
PARITY_LORA_IDS = ["a", None, "b", "a", None, "b"]


def _generate(eng, prompts, sp, lora_ids):
    """Greedy outputs of ``prompts`` (request i under ``lora_ids[i]``), in order."""
    rids = [eng.add_request(p, sp, lora_id=lid) for p, lid in zip(prompts, lora_ids)]
    finals = {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = out.output_token_ids
    return [finals[r] for r in rids]


def parity_phase(dev) -> None:
    """The same fp32 weights and greedy prompts through the engine on the
    card (CUDA kernels; pipelined decode on graphs, and the sync path) and
    on the CPU (plain versions): the same tokens, mixed batching on and off,
    without LoRA and with a batch mixing two adapters and base rows."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams

    model, params_cpu, params_gpu, prompts = _parity_setup(dev)
    sp = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    result = {"phase": "parity", "model": "fp32 d512 L2 H4 KVH2 D128 V2048"}
    adapters = {name: lora_adapter(model, seed, PARITY_LORA_KW["lora_targets"],
                                   PARITY_LORA_KW["lora_rank"])
                for name, seed in (("a", 21), ("b", 22))}
    for lora in (False, True):
        for mixed in (True, False):
            outs, replays, mixed_replays, replay_check = {}, 0, {}, None
            for where, params, pipelined in (("cuda pipelined", params_gpu, True),
                                             ("cuda sync", params_gpu, False),
                                             ("cpu", params_cpu, True)):
                cfg = EngineConfig(model=model, num_blocks=256, block_size=16, max_num_seqs=8,
                                   max_prefill_len=256, mixed_batch=mixed,
                                   mixed_prefill_chunk=64, decode_chunk=8,
                                   pipeline_decode=pipelined,
                                   **(PARITY_LORA_KW if lora else {}))
                eng = LLMEngine(cfg, params=params, device=dev if where != "cpu" else "cpu")
                for name, ad in (adapters.items() if lora else ()):
                    eng.add_lora(name, ad)
                outs[where] = _generate(eng, prompts, sp,
                                        PARITY_LORA_IDS if lora else [None] * len(prompts))
                if where == "cuda pipelined":
                    replays = eng.stats()["pipeline"]["graphs"]["replays"]
                if mixed and where != "cpu":
                    # fp32: every mixed step on the card a graph replay
                    st = eng.stats()["mixed"]
                    _check_packed_replays(st["graphs"], st["dispatches"],
                                          f"parity {where}: mixed steps")
                    mixed_replays[where] = st["graphs"]["replays"]
                if mixed and where == "cuda pipelined":
                    replay_check = _replay_equals_eager(eng, eng._mixed_graphs,
                                                        eng._mixed_program)
            same = outs["cuda pipelined"] == outs["cuda sync"] == outs["cpu"]
            key = f"{'lora_' if lora else ''}mixed_{mixed}"
            result[key] = {"identical": same, "graph_replays": replays,
                           "tokens": sum(map(len, outs["cpu"])),
                           "mixed_step_replays": mixed_replays,
                           "mixed_replay_equals_eager": replay_check}
            if not lora:
                result[key]["disagg"] = _parity_disagg(dev, model, params_cpu, params_gpu,
                                                       prompts, sp, mixed, outs["cpu"])
            if not same or replays <= 0:
                emit(result)
                raise AssertionError(f"{key}: pipelined-card, sync-card and CPU tokens "
                                     f"differ, or no graph replay ran ({replays})")
    result["api_server"] = _parity_server(dev, model, params_cpu, params_gpu)
    emit(result)


def _parity_disagg(dev, model, params_cpu, params_gpu, prompts, sp, mixed, colocated) -> dict:
    """fp32, the parity model, disaggregated (one prefill and one decode
    engine): greedy tokens on the card and on the CPU equal the colocated
    engine's; two seeded requests equal the colocated engine's streams of
    the same request ids, on each device; on the card, a handoff corrupted
    in flight is re-prefilled once and its tokens equal the clean run's."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator

    cfg = dict(model=model, num_blocks=256, block_size=16, max_num_seqs=8, max_prefill_len=256,
               mixed_batch=mixed, mixed_prefill_chunk=64, decode_chunk=8)
    seeded = [SamplingParams(max_tokens=16, temperature=0.9, top_k=40, top_p=0.9, seed=7 + i,
                             ignore_eos=True) for i in range(2)]
    res = {}

    def run(params, device, connector=None):
        orch = DisaggOrchestrator(DisaggConfig(engine=EngineConfig(**cfg)), params=params,
                                  device=device, model_tag="parity-disagg", connector=connector)
        try:
            greedy = orch.generate(prompts, sp, timeout_s=300)
            subs = [orch.submit(prompts[i], seeded[i], request_id=f"seeded{i}")
                    for i in range(2)]
            outs = []
            for _rid, q in subs:
                out = None
                while out is None or not out.finished:
                    out = q.get(timeout=300)
                    if isinstance(out, BaseException) or out is None:
                        raise AssertionError(f"parity disagg: {out!r}")
                outs.append(out.output_token_ids)
            st = orch.stats()
        finally:
            orch.shutdown()
        if st["decode"][0]["num_prefill_batches"] or st["transfer"]["imported"] < len(prompts):
            raise AssertionError(f"parity disagg: {st['transfer']}")
        return greedy, outs, st

    for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        device = dev if where == "cuda" else "cpu"
        greedy, outs, st = run(params, device)
        eng = LLMEngine(EngineConfig(**cfg), params=params, device=device)
        for i in range(2):
            eng.add_request(prompts[i], seeded[i], request_id=f"seeded{i}")
        want = {}
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    want[o.request_id] = o.output_token_ids
        res[where] = {"greedy_equal_colocated": greedy == colocated,
                      "seeded_equal_colocated": outs == [want["seeded0"], want["seeded1"]],
                      "reprefills": st["transfer"]["reprefills"]}
        if where == "cuda":
            conn = _disagg_connector("parity-disagg-corrupt")
            conn.corrupt = "dreq-2"
            bad, _, st = run(params, device, connector=conn)
            res["cuda"]["corrupted"] = {"equal_clean": bad == greedy,
                                        "reprefills": st["transfer"]["reprefills"],
                                        "corrupted_sends": conn.corrupted}
    ok = all(r["greedy_equal_colocated"] and r["seeded_equal_colocated"] and not r["reprefills"]
             for r in res.values())
    c = res["cuda"]["corrupted"]
    if not ok or not c["equal_clean"] or (c["reprefills"], c["corrupted_sends"]) != (1, 1):
        raise AssertionError(f"parity disagg (mixed {mixed}): {res}")
    return res


def _parity_server(dev, model, params_cpu, params_gpu) -> dict:
    """fp32, the parity model: LLMServer's greedy completions of 6 text
    prompts on the card equal the CPU server's and LLMEngine.generate's on
    the same ids (tokens read from the engine's requests; EOS live, as the
    server has it); then, graphs already captured, a crash raised after the
    third step of a second pass (the runner's second rung:
    recover(rebuild_kv=True), the cache zeroed in place) and the streams
    equal the fault-free pass, replays of graphs captured before the fault
    included."""
    import asyncio

    import numpy as np

    from ray_tpu_torch.llm import (
        ByteTokenizer,
        EngineConfig,
        LLMConfig,
        LLMEngine,
        LLMServer,
        SamplingParams,
    )

    rng = np.random.default_rng(12)
    texts = [rng.integers(32, 127, size=n).astype(np.uint8).tobytes().decode()
             for n in (4, 36, 89, 129, 199, 16)]
    kw = dict(num_blocks=256, block_size=16, max_num_seqs=8, max_prefill_len=256,
              mixed_batch=True, mixed_prefill_chunk=64, decode_chunk=8)

    def serve(server, recorded):
        recorded.clear()

        async def go():
            return await asyncio.gather(*[server(ApiRequest(
                "POST", "/v1/completions", {"prompt": t, "max_tokens": 16, "temperature": 0.0}))
                for t in texts])

        outs = asyncio.run(go())
        by_prompt = {tuple(r.prompt_token_ids): list(r.output_token_ids)
                     for r in recorded.values()}
        return ([o["choices"][0]["text"] for o in outs],
                [by_prompt[tuple(server.tokenizer.encode(t))] for t in texts])

    out, res = {}, {}
    for where, params, device in (("cuda", params_gpu, str(dev)), ("cpu", params_cpu, "cpu")):
        server = LLMServer(LLMConfig(model_id="parity", engine=EngineConfig(model=model, **kw),
                                     params=params, device=device))
        eng = server.engine
        recorded = _record_requests(eng)
        try:
            out[where] = serve(server, recorded)
            if where != "cuda":
                continue
            fams = _families(eng)
            captured = [set(f._graphs) for f in fams]
            replays0 = [dict(f.replays_by_key) for f in fams]
            step, calls = eng.step, [0]

            def crash():
                calls[0] += 1
                outs = step()
                if calls[0] == 3:
                    raise RuntimeError("injected after the third step")
                return outs

            server.runner.call(lambda: eng.allocator.drop_prefix_cache())
            eng.step = crash
            again = serve(server, recorded)
            del eng.step
            reused = sum(f.replays_by_key[k] - r0.get(k, 0)
                         for f, keys, r0 in zip(fams, captured, replays0) for k in keys)
            st = server.stats()
            res["recover_rebuild_kv"] = {
                "identical": again == out["cuda"], "engine_recoveries": st["engine_recoveries"],
                "replays_of_graphs_captured_before": reused,
                "graphs_captured_before": sum(map(len, captured)),
            }
            if again != out["cuda"] or st["engine_recoveries"] != 1 or reused <= 0:
                raise AssertionError(f"parity api: after recover(rebuild_kv=True) {res}")
        finally:
            server.shutdown()
    ids = [ByteTokenizer(model.vocab_size).encode(t) for t in texts]
    direct = LLMEngine(EngineConfig(model=model, **kw), params=params_gpu, device=dev).generate(
        ids, SamplingParams(max_tokens=16, temperature=0.0))
    same = out["cuda"] == out["cpu"] and out["cuda"][1] == direct
    res.update({"identical": same, "tokens": sum(map(len, direct)),
                "stopped_on_eos": sum(1 for t in direct if t and t[-1] == 2)})
    if not same:
        raise AssertionError(f"parity api: card server, CPU server and LLMEngine.generate "
                             f"differ: {res}")
    return res


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------


def spec_phase(dev, params) -> dict:
    """Speculative decoding at LLAMA3_8B (bf16, full width and depth, mixed
    batching so that verify runs the ragged kernel): prompt lookup with k=4,
    then a LLAMA3_1B draft model at full width, both on random weights.
    Then fp32 greedy spec == non-spec tokens on the parity model, both
    drafters, on the card."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.kv_cache import KVCacheConfig
    from ray_tpu_torch.llm.spec import SpecConfig
    from ray_tpu_torch.models.llama import LLAMA3_1B, LLAMA3_8B, LlamaConfig, init_params

    model = LLAMA3_8B
    # 8 requests of 256-768 prompt tokens, each a 16-64-token phrase repeated
    # (prompt lookup finds n-gram matches from the first round on)
    rng = np.random.default_rng(2)
    prompts = []
    for _ in range(8):
        phrase = rng.integers(3, model.vocab_size, size=int(rng.integers(16, 65))).tolist()
        n = int(rng.integers(256, 769))
        prompts.append((phrase * (n // len(phrase) + 1))[:n])
    sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    result = {"phase": "spec", "model": "LLAMA3_8B", "dtype": "bfloat16", "requests": 8,
              "prompt_tokens": sum(map(len, prompts)), "output_tokens": 8 * 32}
    for method in ("prompt_lookup", "draft_model"):
        spec = SpecConfig(num_draft_tokens=4, method=method,
                          **({"draft_model": LLAMA3_1B,
                              "draft_kv": KVCacheConfig(num_blocks=1024, block_size=16)}
                             if method == "draft_model" else {}))
        eng = LLMEngine(EngineConfig(model=model, spec=spec, **ENGINE_KW), params=params,
                        device=dev)
        marks = _launch_marks(eng)
        pmarks = _pass_marks(eng)
        finals, reqs, wall, steps = _serve(eng, prompts, [sp] * 8, method[0])
        launches = _launch_counts(eng, marks)
        _check_served(eng, finals, model, 8, 32)
        stats = eng.stats()
        st = stats["spec"]
        if st["steps"] <= 0:
            raise AssertionError(f"{method}: no verify pass ran: {st}")
        _check_packed_replays(st["verify_graphs"], st["steps"], f"{method}: verify passes")
        _check_packed_replays(stats["mixed"]["graphs"], stats["mixed"]["dispatches"],
                              f"{method}: mixed steps")
        if launches["ragged_attention"] < st["steps"] * model.n_layers:
            raise AssertionError(f"{method}: {launches['ragged_attention']} ragged launches for "
                                 f"{st['steps']} verify passes of {model.n_layers} layers")
        result[method] = {
            "engine_steps": steps, "wall_s": wall, "output_tok_per_s": 8 * 32 / wall,
            "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival for r in reqs.values()])),
            "spec": st, "kernel_launches": launches, "graphs": _pass_graphs(eng, pmarks),
        }
        # the same requests again, warm and steady (the first pass pays the
        # mixed and verify graphs' captures), each from an empty prefix cache
        first = [finals[f"{method[0]}{i}"] for i in range(8)]
        for key, tag in (("warm", "w"), ("steady", "x")):
            eng.allocator.drop_prefix_cache()
            pmarks = _pass_marks(eng)
            f, rq, w, _ = _serve(eng, prompts, [sp] * 8, method[0] + tag)
            result[method][key] = {
                "wall_s": w, "output_tok_per_s": 8 * 32 / w,
                "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival for r in rq.values()])),
                "streams_equal_first_pass": [f[f"{method[0]}{tag}{i}"] for i in range(8)] == first,
                "graphs": _pass_graphs(eng, pmarks),
            }
        if method == "prompt_lookup":
            result[method]["verify_replay_equals_eager"] = _replay_equals_eager(
                eng, eng._verify_graphs, eng._verify_program)
        if method == "draft_model":
            result[method]["draft_model"] = "LLAMA3_1B bf16, random weights (seed 0)"
        del eng
        torch.cuda.empty_cache()

    # fp32 greedy: spec == non-spec on the card, both drafters. The parity
    # model with a 256-token vocabulary, and prompts that each hold every
    # token id: whatever a row generates occurred earlier in its history,
    # so prompt lookup drafts in every round, whatever the random weights
    smodel = LlamaConfig(**{**PARITY_MODEL, "vocab_size": 256}, dtype=torch.float32)
    draft = LlamaConfig(**{**PARITY_MODEL, "vocab_size": 256, "d_model": 256, "n_layers": 1,
                           "d_ff": 512}, dtype=torch.float32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    sparams = _to(init_params(smodel, gen, "cpu"), dev)
    prng = np.random.default_rng(13)
    pprompts = [prng.permutation(256).tolist() for _ in range(4)]
    psp = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    base = dict(model=smodel, num_blocks=256, block_size=16, max_num_seqs=8,
                max_prefill_len=256, mixed_batch=True, mixed_prefill_chunk=64)
    ref = LLMEngine(EngineConfig(**base), params=sparams, device=dev).generate(pprompts, psp)
    for method in ("prompt_lookup", "draft_model"):
        spec = SpecConfig(num_draft_tokens=4, method=method,
                          **({"draft_model": draft} if method == "draft_model" else {}))
        eng = LLMEngine(EngineConfig(spec=spec, **base), params=sparams, device=dev)
        got = eng.generate(pprompts, psp)
        st = eng.stats()["spec"]
        result[f"fp32_{method}"] = {"identical_to_non_spec": got == ref, "spec": st}
        if got != ref or st["steps"] <= 0:
            emit(result)
            raise AssertionError(f"fp32 greedy spec ({method}): tokens != non-spec tokens, "
                                 f"or no verify pass ran ({st['steps']})")
        _check_packed_replays(st["verify_graphs"], st["steps"], f"fp32 {method}: verify passes")
        if method == "prompt_lookup":
            result[f"fp32_{method}"]["verify_replay_equals_eager"] = _replay_equals_eager(
                eng, eng._verify_graphs, eng._verify_program)
    # prompt lookup under adapters (ragged verify, per-token adapter ids):
    # greedy spec == non-spec with the same adapters; the drafter takes none
    ids = ["a", None, "b", "a"]
    outs = {}
    for name, spec in (("non_spec", None), ("spec", SpecConfig(num_draft_tokens=4))):
        eng = LLMEngine(EngineConfig(spec=spec, **base, **PARITY_LORA_KW), params=sparams,
                        device=dev)
        for a, seed in (("a", 21), ("b", 22)):
            eng.add_lora(a, lora_adapter(smodel, seed, PARITY_LORA_KW["lora_targets"],
                                         PARITY_LORA_KW["lora_rank"]))
        outs[name] = _generate(eng, pprompts, psp, ids)
        if spec is not None:
            st = eng.stats()["spec"]
            _check_packed_replays(st["verify_graphs"], st["steps"],
                                  "fp32 prompt lookup under adapters: verify passes")
    same = outs["spec"] == outs["non_spec"]
    changed = all(o != r for o, r, lid in zip(outs["non_spec"], ref, ids) if lid is not None)
    result["fp32_prompt_lookup_lora"] = {"identical_to_non_spec": same, "spec": st,
                                         "adapters_change_tokens": changed}
    if not (same and changed and st["steps"] > 0):
        emit(result)
        raise AssertionError("fp32 greedy spec under adapters: tokens != non-spec tokens, "
                             "an adapter left its stream unchanged, or no verify pass ran")
    emit(result)
    return result


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

    from ray_tpu_torch.ops.flash import flash_bwd_cuda, flash_fwd_cuda

    torch.cuda.synchronize()
    fwd0, bwd0 = flash_fwd_cuda.launches, flash_bwd_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd_cuda.launches - fwd0,
                "flash_bwd": flash_bwd_cuda.launches - bwd0}
    busy_ms, by_name = _device_time(prof)
    device_ms = sum(ms for _, ms, _ in by_name)

    def share(*words):
        return sum(ms for k, ms, _ in by_name if any(w in k for w in words))

    groups = {"gemm_ms": share(*GEMM_WORDS), "flash_fwd_ms": share("flash_fwd_kernel"),
              "flash_bwd_ms": share("flash_dkv_kernel", "flash_dq_kernel")}
    # the groups match kernel names: a renamed kernel must not read as 0 ms
    for name, n in launches.items():
        if n > 0 and groups[f"{name}_ms"] <= 0.0:
            raise AssertionError(f"train_profile: {n} {name} launches but no device time "
                                 f"under its kernel names: {[k for k, _, _ in by_name[:20]]}")
    return {
        "flash_launches": launches,
        "flash_ms": groups["flash_fwd_ms"] + groups["flash_bwd_ms"],
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

PHASES = ("build", "kernels", "flash_kernels", "engine", "lora", "api", "disagg", "parity",
          "spec", "train", "train_parity")

SOURCES = {
    "paged_attention": ("ray_tpu_torch/ops/csrc/paged_attention.cu",
                        "ray_tpu/ops/paged_attention.py:74"),
    "ragged_attention": ("ray_tpu_torch/ops/csrc/ragged_attention.cu",
                         "ray_tpu/ops/ragged.py:97"),
    "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/flash.py:143"),
    "flash_bwd": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                  "ray_tpu/ops/flash.py:491, ray_tpu/ops/flash.py:251, ray_tpu/ops/flash.py:323"),
}


def _ptxas_summary(log: str) -> list:
    """One line per kernel from ``nvcc -Xptxas -v``: the entry's (mangled)
    name, its registers, and its stack and spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name is not None:
            regs = ln.split("Used", 1)[-1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {spill}")
            name, spill = None, ""
    return out


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
    if {"lora", "api", "disagg"} & set(phases) and "engine" not in phases:
        ap.error("the lora, api and disagg phases read the engine phase's results: add engine")
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
    ptxas = {name: _ptxas_summary(log) for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {k: round(v, 2) for k, v in built.items()}, "ptxas": ptxas})
    timings, launches = {}, {}
    if "kernels" in phases:
        timings.update(kernels_phase(dev))
    if "flash_kernels" in phases:
        timings.update(flash_kernels_phase(dev))
    params, params_s = (params_8b(dev) if {"engine", "spec", "api", "disagg"} & set(phases)
                        else (None, 0.0))
    lora_launches, api_launches, disagg_launches, replayed = {}, {}, {}, {}
    if "engine" in phases:
        engine_res = engine_phase(dev, params, params_s)
        launches.update(engine_res["kernel_launches"])
        replayed = engine_res["kernel_launches_in_replays"]
    if "lora" in phases:
        lora_launches = lora_phase(dev, params, engine_res)["kernel_launches"]
    if "api" in phases:
        api_launches = api_phase(dev, params, engine_res)["kernel_launches"]
    if "disagg" in phases:
        disagg_launches = disagg_phase(dev, params, engine_res)["kernel_launches"]
    if "engine" in phases:
        del engine_res
    if "parity" in phases:
        parity_phase(dev)
    if "spec" in phases:
        spec_phase(dev, params)
    del params  # the 8B weights go before training
    torch.cuda.empty_cache()
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
            **({"launches_in_graph_replays": replayed[name]} if name in replayed else {}),
            **({"launches_lora_phase": lora_launches[name]} if name in lora_launches else {}),
            **({"launches_api_phase": api_launches[name]} if name in api_launches else {}),
            **({"launches_disagg_phase": disagg_launches[name]}
               if name in disagg_launches else {}),
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"], "dtype": "bfloat16", "shape": bf["shape"],
            "fp32": timings[name]["float32"],
            **({"verify_shape": bf["verify_shape"]} if "verify_shape" in bf else {}),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
