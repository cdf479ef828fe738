#!/usr/bin/env python3
"""Smoke run of the ray_tpu_torch serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py                         # one card, no arguments: every phase
    python3 chip_smoke.py --phases build,flash_kernels   # a short first check of a kernel edit
    python3 chip_smoke.py --phases build,engine,api      # the serving front end alone
    python3 chip_smoke.py --phases build,engine,api,serve  # ... and through a Serve deployment
    python3 chip_smoke.py --phases build,engine,api,serve_disagg  # ... disaggregated Serve
    python3 chip_smoke.py --phases build,engine,data     # batch inference over a Dataset
    python3 chip_smoke.py --phases build,train,data_feed # the train step fed by a Dataset
    python3 chip_smoke.py --phases build,engine,disagg   # disaggregated, inproc and device legs
    python3 chip_smoke.py --phases build,kvtier          # the tiered KV cache alone
    python3 chip_smoke.py --phases build,fleet           # the canary ladder at LLAMA3_8B
    python3 chip_smoke.py --phases build,train,publish   # train -> publish -> serve
    python3 chip_smoke.py --phases build,engine,process  # 8B in a pinned worker process
    python3 chip_smoke.py --phases build,engine,cluster_ha  # 8B across a GCS failover

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
           seconds per T_pad bucket, and its peak device memory.
           Observability: fails unless every request of the first pass has
           the engine.queue_wait, engine.prefill and llm.request spans and a
           decode_chunk or mixed_round span, its spans cover >= 90 % of
           arrival -> finish, each pass adds one TTFT / TPOT / queue-wait /
           e2e sample per request, and the utilization gauges refreshed at
           the third step read the engine's own values. The hooks' host ms
           per pass (timed by wrapping them on that engine instance) and a
           steady A/B in turns, hooks made no-ops on the instance then on,
           each pass under a device-events-only profiler: tok/s, TTFT and
           the device's idle share
  lora     LoRA multiplexing at LLAMA3_8B (the engine phase's weights,
           configuration and 12 requests): max_loras 4, rank 8, targets wq
           and wv, 3 adapters of random weights (numpy seeds 1-3, A ~
           N(0, 1/d_model), B ~ N(0, 0.25^2): a delta about as large as q
           and v themselves, so every adapter changes the greedy stream),
           assigned round robin so a quarter of the rows are base; a first
           and a warm pass, 2 steady passes in turns with 2 of the requests
           all on the base model (cut from 4 and 4 for the smoke's time; medians of the
           passes that captured no graph), then one of each under
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
           a first pass, two more (steady: the median of those that
           captured no graph; cut from four for the smoke's time) and one under torch.profiler:
           client tok/s, engine TTFT and the streams' first-delta TTFT,
           device busy and idle share, beside the engine phase's; the
           kernels' launches counted over the first pass. Fails unless
           every completion has its 32 tokens or a stop, /v1/models names
           llama3-8b at 8192, a greedy request's streamed deltas join to
           its completion's text, the first pass adds one TTFT sample per
           row to the exported Prometheus text, the last steady pass's rows
           each have api.* and engine.* spans covering >= 90 % of their
           /v1/requests/{id}/trace, a preemption before a mixed step and a
           crash after a step with a decode chunk in flight each recover
           (2 recoveries; every position delivered once), a burst of 24 at
           max_queue_depth 3 sheds 429s with Retry-After while the admitted
           finish, and a drain turns a new request into a 503
  serve    LLAMA3_8B through a Serve deployment: ray_tpu_torch.init(),
           serve.start on a free loopback port, build_openai_app over the
           api phase's configuration and weights (one replica; its engine
           built on the replica's actor thread, its loop on its own
           thread). The api traffic, the completions and chats over HTTP
           (stdlib proxy -> handle -> router -> replica -> LLMServer) and
           the 2 streams through the app handle's generate_stream, each
           request on its own client thread: a first pass (the kernels'
           launches counted over it as in the api phase) and one more (cut
           from two for the smoke's time), then
           the replica's LLMServer driven directly (the api phase's pass)
           and through Serve in turns, S D S D after a direct warm-up
           pass, on the same engine; steady: the median of the Serve
           passes after the first that captured no graph; client tok/s,
           engine TTFT and the streams' client TTFT beside the api phase's
           and the direct passes'; the first pass's peak memory beside the api phase's,
           /v1/models' round trip over HTTP and through the handle,
           server_init_s. Fails unless every completion has its 32 tokens
           or a stop, /v1/models names llama3-8b at 8192, /-/healthz
           answers and an unknown route is a 404, the replica engine's
           weights are the caller's tensors (same data_ptr), a greedy
           completion sent alone over HTTP has the text of the same
           completion sent alone through the handle, 24 completions over
           HTTP at max_queue_depth 3 (the engine loop parked) give 21 429s
           with Retry-After and 3 completions, the 12 completions over
           HTTP, through the framed-RPC ingress and (where grpc is
           installed) the gRPC ingress give equal greedy texts, each leg
           sent to a parked engine loop in one order, and after
           serve.shutdown() the engine loop has exited, the ingresses'
           ports are free and the card's allocated memory fell by at least
           the KV cache's bytes
  serve_disagg  LLAMA3_8B through build_disagg_openai_app on the in-process
           runtime: a prefill and a decode replica (role-tagged pools), each
           engine the api phase's configuration plus the tiered cache
           (kvtier={}) over the caller's weights (by reference), stepped by
           its replica's loop thread; KV over the device fabric
           (connector="device"); an ingress that pins each decode wait and
           routes by the app's prefix index. The api phase's 12
           completions through the ingress handle, each on its own client
           thread: a first pass (K3/K4 counted per engine from its loop
           thread's tally, eager and in replays), then the two
           shared-prefix requests again. Fails unless every completion has
           its 32 tokens or a stop, K4 launched on the prefill engine and
           K3 on the decode engine, the 12 first-pass handoffs went by the
           device plane with no stage through host memory, the ingress
           routed one request or more by prefix, serve.status() tags the
           roles, both engines hold the caller's tensors, and after
           serve.shutdown() both loops exited and the card's allocated
           memory fell by at least the two KV caches' bytes. Reports TTFT
           (at the prefill engine) and tok/s a pass, captures per engine,
           send ms per handoff, the greedy streams against the api phase's.
           Then its autoscale leg on the same app: a GcsServer in the
           process fed by a TelemetryReporter, and a PoolAutoscaler over
           the real autoscale_signals RPC acting through a
           ServePoolActuator (prefill pool 1-2, decode 1-1). A warm
           single-request TTFT sets the TTFT threshold (a stated multiple,
           percentile and count); the 12 completions with their first
           character shifted (no prefix-cache hit) sent at once breach it;
           a STALL_GCS window of 3 ticks lands while the breach builds;
           quiet single requests one at a time follow until the pool has
           drained back to 1. Fails unless the pool reaches 2 within 60 s
           of the first breached tick by a scale_up, the decode pool takes
           no action, the stall gives exactly 3 dark ticks and no action and
           the window is re-earned after it, the added engine holds the
           caller's tensors and launches K4 (its loop thread's tally), no
           request is lost, the drained replica's loop exits, the card's
           allocated memory is back within 64 MB of its value before the
           scale-up, and the GCS's autoscale block shows the scale-up, the
           scale-down and a prefill target of 1
  data     offline batch inference at LLAMA3_8B through the port's
           datasets: build_processor(ProcessorConfig(...)) over
           data.from_items of 48 text prompts (64-1536 bytes, numpy seed
           0, two on a 512-byte prefix) in 4 blocks, batch_size 16, the
           engine phase's EngineConfig and weights (by reference), 32
           greedy outputs; the stage on an actor pool of one (a thread of
           the in-process runtime), its engine and graphs built there,
           handed 16 + 8 rows per bundle of 2 blocks. A direct pass
           (LLMEngine.generate on the same batches), then
           dataset and direct in turns (S D, cut from S D D S for the
           smoke's time): rows/s, tok/s, peak
           memory, the stage's graph captures, and the bytes freed once each
           dataset pass's pool is killed; K3/K4 launches counted over the
           first dataset pass. Fails unless each dataset pass's rows come
           back in order with their columns carried and every
           generated_text equals the direct pass's, both kernels launched,
           and each killed pool freed at least its KV cache's bytes
  disagg   LLAMA3_8B disaggregated (the engine phase's weights, one copy
           shared, configuration and 12 requests), two legs alive at once,
           each a DisaggOrchestrator with one prefill and one decode engine
           on their own loop threads: inproc (the in-process connector:
           pinned host pages, CRC both ways) and device (the fabric: pages
           gathered and sealed on the card, handed to the decode engine's
           cache device by reference, verified on the card, scattered in
           place). Each leg's first pass (fresh engines, each capturing
           while the other works; the kernels' counters zeroed just before
           and read after), one more ungated inproc pass, then gated passes
           in turns, inproc, device, inproc, device, device, inproc (all 12
           admitted in one step, the decode loop parked until the 12
           handoffs are sent, so one batch shape: the same bf16 bits), and
           up to three more pairs in turns until one pair captured no graph
           on either leg (a chunk controller that steps to a new chunk
           length captures its graph: host timing decides), then
           a gated pass on each leg with one handoff corrupted in flight
           (CORRUPT_KV_TRANSFER at the connector's gate; on the device leg
           CORRUPT_DEVICE_TRANSFER in the transport, which degrades the edge
           to the RPC fallback); tok/s, TTFT, TPOT, per handoff the export
           (pin, gather, d2h, seal) and import (verify, h2d, scatter) ms
           and the host ms a pass, bytes handed off, the pinned allocator's
           movement, graphs and capture seconds per engine, K3/K4 launches
           per engine (eager and in replays), peak memory, the RPC
           handoff's send ms. Fails unless each first pass makes 12
           transfers and no re-prefill, the decode engine runs no prefill
           or mixed step, every request has 32 tokens, each request of a
           first pass has an llm.kv_transfer span between its prefill and
           decode spans and its spans cover >= 90 %, every pass books one
           llm_kv_transfer_seconds sample per handoff, every mixed step of
           the prefill engine is a replay with K4 inside and the decode
           chunks replays with K3 inside, a capture of one engine overlaps
           the other's steps, the per-thread launch tallies account for
           every wrapper launch, imports after capture leave the cache
           tensors in place and read back bit for bit, and are read by
           replays of graphs captured before them; every device-leg gated
           stream equals the inproc one, K3/K4 launches per engine are
           equal on both legs in capture-free passes and no device handoff
           has a pin, d2h or h2d stage; the corrupted handoff is
           re-prefilled once (its first token and the 11 other streams
           equal the clean gated pass's; on the device leg the edge falls
           back to RPC once); and two completions through
           LLMServer(disagg=DisaggConfig(connector="device")) report "mode":
           "disagg" over device edges
  kvtier   the tiered KV cache at LLAMA3_8B (the engine phase's weights and
           configuration, but 640 blocks, a 3 GiB pinned host tier, no
           object tier, async spill and prefetch on): returning multi-turn
           chat (numpy seed 0): pass A serves 8 conversations of 1 024
           history tokens, 32 greedy outputs each; 10 distinct 1 088-token
           fillers (one at a time) push every conversation block out of HBM;
           pass B serves the 8 conversations again, reply and a 64-token new
           turn appended. Two rounds in turns with the same three passes on
           an engine without the tier (pass B recomputes): tier, recompute,
           tier, recompute, the second round after drop_prefix_cache (graphs
           captured). Fails unless, before each tier pass B, no conversation
           block is in HBM and >= 90 % are in the host tier, every
           resurrected block verifies, every conversation block resurrects,
           and K3 and K4 launch in graph replays in pass B. Reports spilled
           bytes and resurrected tokens by tier, per block the capture,
           gather, pin (a slab slot), seal, verify, h2d and scatter ms, pass
           B's TTFT and tok/s with the tier and with recompute, peak device
           memory and the pinned slab
  parity   a reduced fp32 model served by the same engine on the card
           (kernels; pipelined on graphs, and sync) and on the CPU (plain
           versions): identical greedy tokens, mixed batching on and off
           (on: every mixed step on the card a graph replay, and a replay
           bit for bit the eager step); then the same with a batch mixing
           two adapters (wq, wk, wv) and base rows; then LLMServer's greedy
           completions on the card = the CPU server's = LLMEngine.generate,
           and after recover(rebuild_kv=True) with graphs captured the
           streams equal the fault-free pass; and, mixed batching on and
           off, the disaggregated path on the card and on the CPU, over the
           in-process connector and over the device fabric, gives the
           colocated greedy tokens and the colocated streams of two seeded
           requests, and a handoff corrupted in flight on the card is
           re-prefilled once with the clean run's tokens (over the fabric
           through the RPC fallback); and the tiered
           cache: a prefix spilled to the host tier and resurrected gives
           the cold prefill's tokens on the card and on the CPU, and a
           decode graph captured before the resurrection replays over the
           resurrected pages
  spec     speculative decoding at LLAMA3_8B (bf16, mixed batching, so the
           verify pass runs the ragged kernel at q_len 1..5, every pass a
           replay of a graph per packed-token bucket, bit for bit the
           eager pass): prompt lookup
           with k = 4, then a LLAMA3_1B draft model at full width, random
           weights, a first and a warm pass each (a steady third was cut for
           the smoke's time); acceptance, tok/s and ragged launches (> 0); then fp32
           greedy spec == non-spec tokens on the parity model (vocabulary
           cut to 256, prompts holding every id, so prompt lookup always
           drafts), both drafters, and prompt lookup under adapters
  fleet    the multi-tenant fleet at LLAMA3_8B (bf16, full width): a
           FleetManager of 2 replicas (r0 serves the smoke's weights, r1 a
           clone), 1 024 blocks of 16 and max_num_seqs 8 each, max_loras 2
           (rank 8, wq and wv), tenants gold (priority 2, weight 3) and
           batch (priority 0, weight 1) over a queue budget of 96 (batch
           holds 24 in flight, 8 more than the two replicas' slots), the
           engine phase's prompts: a noisy neighbour (32 batch threads
           flood, alone for 8 s, then while gold sends 4, each once every
           replica runs 8 rows:
           gold's TTFT and SLO grade, batch requests shed, priority
           preemptions); a base canary (every leaf x 1.01) graded on 8
           greedy gold requests (their shapes captured in a pass before)
           and promoted; a second one rolled back to the
           retained v1; an adapter canary whose swap keeps the other
           adapter's prefix hits; a seeded PREEMPT_ENGINE mid-canary. Fails
           unless gold is served while batch is shed and preempted, every
           promote and rollback is bit for bit on distinct storages with
           equal greedy tokens, the adapter swap drops only its own chains,
           no request is lost, and K3/K4 launch in replays. Reports publish
           ms by stage (seal, verify, the in-place write), each apply's ms,
           promote and rollback wall time, K3/K4 launches per replica (eager
           and in replays) and peak memory
  process  GPU work in worker processes: ray_tpu_torch.init(worker_mode=
           "process") (one GPU, detected; the shared-memory store built with
           g++). A GPU task defined here (so it ships by value) serves
           LLAMA3_8B in a worker pinned to the card (CUDA_VISIBLE_DEVICES
           "0"): params_8b on the worker's card, the engine phase's
           configuration and 12 requests (prompts as one int32 array through
           the store), K3/K4 counted by the engine's marks, then each greedy
           row's last step again (a 1-token request) for its logits, a bf16
           CPU tensor [10, 128256] back through the store. Fails unless K3
           and K4 launched in the worker, this process's allocated card
           memory did not grow, the store is empty after, and the parity
           model's fp32 greedy tokens in a worker equal this process's on the
           card (the 8B streams' equality with the engine phase's first pass
           is reported, with any differing tokens); a GPU task that holds 8
           GiB and checks K3 at the kernels phase's shape against its plain
           twin, then dies, retries in a fresh worker; a chaos KILL_WORKER at
           process_pool.task on a GPU task retries to success; after
           shutdown the card's free bytes are back within 256 MiB. Reports a
           worker's cold start (fork to entry, import torch, first CUDA
           context), a warm GPU task's round trip, a 64 MiB numpy argument
           and result through the store and through the pipe in turns, the
           8B task's param-init, capture and pass seconds and peak memory
  cluster  LLAMA3_8B in a num_gpus=1 actor of a port cluster (a GCS, node
           "gpu" holding the card and node "cpu"), attached with
           ray_tpu_torch.init(address=...): the engine phase's streams on
           two passes, then two more through a compiled DAG over the actor
           (ClusterServer8B.serve bound to an InputNode's fields; one host,
           so the shm channel), gated 10/10, no capture and pass s's
           launches all in replays, the actor answering within 30 s of
           teardown(), and a trivial echo's round trip through .remote and
           through a DAG; the actor killed and the card's memory back, a GPU
           worker's cold start, a bf16 CUDA tensor through the store, the
           driver's tensor pulled by the CPU node, a crashed GPU task
           retried; then Serve on the cluster: a num_gpus=1 replica of a
           deployment around LLMServer that builds the 8B weights on its own
           card (params_8b, the actor's seeded generator), its tiered cache
           publishing into the GCS's prefix index through a GcsPrefixIndex;
           the api phase's 12 completions through the handle twice, served
           one at a time as a cluster actor serves its calls (K3/K4 counted
           in the replica over the first); fails unless the replica
           is a worker on node "gpu" pinned to card 0, every completion is
           complete, K3 and K4 launched there, the GCS's kvtier_stats has
           rows after a flush and a driver-side lookup of the 512-token
           shared prefix names the replica's key with n_tokens >= 512, and
           the card's free bytes are back after serve.delete; nothing left
           after shutdown
  cluster_ha  the cluster phase's nodes under a GCS with a warm standby
           (LocalCluster(standby=True)), attached with both endpoints; a
           seeded DROP_RPC on telemetry_push handed to the cluster's
           processes through the environment. A num_gpus=1 actor serves
           LLAMA3_8B (ClusterServer8B) and reports its registry to both
           endpoints every 0.5 s; it serves the engine phase's 12 requests
           three times: r with the primary up, s while a ChaosRunner
           SIGKILLs the primary 0.3 s after the submit (KILL_GCS_PRIMARY),
           t once the standby has promoted. Fails unless each pass's 10
           greedy streams equal the engine phase's first pass, pass r
           launches K3/K4 1 056 / 480 times and passes s and t 1 024 / 320,
           all in graph replays with no capture; the promoted GCS reports
           role primary, the term one above the old, one failover and no
           fenced write; its merged TTFT histogram equals the worker's own
           bucket for bucket over the 36 requests, the SLO grade is not
           no_data, both daemons' node gauges arrived, format_status names
           the new primary; the reporter lost pushes; the killed actor's
           lease is released there and the card's memory comes back; a GPU
           task leases through the new primary; nothing (standby included)
           is left after shutdown, and no control-plane process loaded
           torch. Reports the start, lease to ready, each pass, kill to
           promoted, the reporter's counts, staleness after the failover,
           the cold GPU task's round trip and the shutdown
  train    LLAMA_400M at full width and depth (bf16 compute, fp32 params,
           remat "dots", flash attention, AdamW lr 3e-4 wd 1e-4), B 8,
           S 1024, one fixed batch (numpy seed 0), with bench.py's gates:
           initial loss near ln V, timed runs of 10 and 30 chained steps
           linear in the count, the loss decreasing, MFU in (0, 1]; the
           flash counters are zeroed just before the steps and read just
           after; then one step under torch.profiler (it fails if a flash
           kernel launched but its kernel-name group reads no time)
  data_feed  the train phase's setup fed by the port's datasets: 6 batches
           of int32 tokens [8, 1025] (numpy seed 0) through data.from_numpy
           and iter_device_batches(batch_size=8, prefetch=1) (pinned host
           batches copied non_blocking on the feed's side stream, the
           step's stream waiting on each copy's event) into 6 steps from a
           fresh state (torch seed 0), and the same steps on the same
           batches copied synchronously beforehand, in turns (F P P F);
           K1/K2 counted over the first fed run. Fails unless every fed
           tensor equals its host batch and every run's losses equal bit
           for bit. Reports step ms of each run, the feed's host ms per
           batch and the consumer's wait
  publish  train -> publish -> serve at LLAMA_400M: an engine (bf16, the
           engine phase's batching, 1 024 blocks, chunks held at 8) serves
           the engine phase's 12 requests (graphs captured), the train
           phase's state takes 3 AdamW steps (K1/K2 counted), a snapshot of
           its fp32 params is published as v1 over a DeviceTransport
           endpoint on the engine's device and written into the engine's
           bf16 tensors between two passes. Fails unless the tensors keep
           their addresses and hold the snapshot cast to bf16, no pre-swap
           block is a prefix hit, weight_version is 1, the second pass's
           greedy tokens equal a fresh engine's on the snapshot bit for bit,
           it captures nothing for the first pass's buckets and K3/K4 run in
           its replays, a publish of the live params followed by a step is
           refused (and the engine's bytes unchanged), and a cold start
           through publish_latest is bitwise identical. Reports the seal,
           verify and write ms, the snapshot clone's ms and peak memory
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

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                                  # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}    # dense; fp32 without tensor cores
BANDS = {"bfloat16": 2e-2, "float32": 2e-5}


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase's line gains ``t_s``, the
    script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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


# K3's contexts in the kernels phase and the process phase's crash: B 16 over
# 1..2048, one pad row
K3_CTX_LENS = [0, 1, 17, 100, 255, 256, 511, 700, 1000, 1023, 1300, 1500, 1777, 1999, 2047,
               2048]


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
    ctx_lens = K3_CTX_LENS
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


# the engine's observability hooks (host-only dict writes): timed, or made
# no-ops, by wrapping them on one engine instance, never in the package
# every observability method of the engine: the span hooks, the gauges, and
# ``_obs_series``, through which every other registry write goes (the
# prefix counters, the pipeline's two histograms, the spec series, an
# abort's SLO record). Left on in the A/B's "off" side: the chaos guard (an
# attribute read) and the gauge throttle (a clock read) once a step, and
# the ``time.time()`` stamps the spans read.
OBS_HOOKS = ("_obs_span", "_obs_prefilled", "_obs_decode_round", "_obs_finalize",
             "_count_preemption", "update_telemetry_gauges", "_obs_series")
# the first pass's launches at this configuration before the observability
# hooks existed (PERF.md kernel table)
FIRST_PASS_LAUNCHES = {"paged_attention": {"device": 1056, "eager": 32, "in_replays": 1024},
                       "ragged_attention": {"device": 480, "eager": 160, "in_replays": 320}}
TRACE_NEED = {"engine.queue_wait", "engine.prefill", "llm.request"}
DECODE_SPANS = {"engine.decode_chunk", "engine.mixed_round"}


def _time_hooks(eng) -> dict:
    """Wrap the engine's hooks on this instance: host seconds inside them
    (``s``: outermost calls only, since a round's span and finalize calls
    nest; ``by_hook``: inclusive) and the spans recorded. The caller
    resets the counters per pass (``_hook_cost``)."""
    acc = {"s": 0.0, "calls": 0, "spans": 0, "depth": 0,
           "by_hook": dict.fromkeys(OBS_HOOKS, 0.0)}
    for name in OBS_HOOKS:
        fn = getattr(type(eng), name).__get__(eng)

        def timed(*a, _fn=fn, _name=name, **k):
            acc["spans"] += _name == "_obs_span"
            acc["depth"] += 1
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                acc["by_hook"][_name] += dt
                acc["depth"] -= 1
                if not acc["depth"]:
                    acc["s"] += dt
                    acc["calls"] += 1

        setattr(eng, name, timed)
    return acc


def _hooks_off(eng) -> None:
    """The hooks as no-ops on this instance (the A/B's "off" side)."""
    for name in OBS_HOOKS:
        setattr(eng, name, lambda *a, **k: None)
    eng._obs_decode_round = lambda batch, outputs, *a, **k: outputs


def _hook_cost(acc: dict) -> dict:
    out = {"host_ms": acc["s"] * 1e3, "calls": acc["calls"], "spans": acc["spans"],
           "ms_by_hook": {k: v * 1e3 for k, v in acc["by_hook"].items()}}
    acc.update(s=0.0, calls=0, spans=0, by_hook=dict.fromkeys(OBS_HOOKS, 0.0))
    return out


def _check_traces(rec, traces: dict, what: str, need=TRACE_NEED, one_of=DECODE_SPANS) -> dict:
    """Every request's trace (rid -> trace_id in the recorder ``rec``) holds
    the ``need`` spans and one of ``one_of``, and its spans cover >= 90 %
    of its root (arrival -> finish)."""
    covs, n_spans = [], []
    for rid, tid in traces.items():
        spans = rec.get(tid)
        names = {s.name for s in spans}
        if not need <= names or (one_of and not names & one_of):
            raise AssertionError(f"{what}: {rid}'s trace lacks spans: {sorted(names)}")
        covs.append(rec.summary(tid)["coverage_pct"])
        n_spans.append(len(spans))
    if min(covs) < 90.0:
        raise AssertionError(f"{what}: span coverage {min(covs)} % < 90 %")
    return {"requests": len(covs), "coverage_pct_min": min(covs),
            "spans_per_request_mean": sum(n_spans) / len(n_spans)}


def _slo_counts(tag: str) -> dict:
    """Samples so far in the SLO histograms of one model tag."""
    from ray_tpu_torch.obs import slo

    out = {}
    for name, h in (("ttft", slo.ttft_histogram()), ("tpot", slo.tpot_histogram()),
                    ("queue_wait", slo.queue_wait_histogram()), ("e2e", slo.e2e_histogram())):
        out[name] = sum(n for k, (_b, _s, n) in h.hist_data().items() if k[0] == tag)
    return out


def _check_slo_delta(before: dict, tag: str, n: int, what: str) -> dict:
    d = {k: v - before[k] for k, v in _slo_counts(tag).items()}
    if any(v != n for v in d.values()):
        raise AssertionError(f"{what}: SLO samples {d} for {n} finished requests")
    return d


def _gauge_probe(eng, out: dict):
    """An ``on_step`` callback for ``_serve``: at the third step, refresh the
    engine's gauges and hold them against its own state."""
    from ray_tpu_torch.llm.engine import utilization_gauges

    def probe(step_i):
        if step_i != 3:
            return
        eng.update_telemetry_gauges()
        tag = (eng.model_tag,)
        got = {k: g.series()[tag] for k, g in utilization_gauges().items()}
        c = eng.config
        want = {"kv_pages_used": c.num_blocks - eng.allocator.num_free,
                "kv_pages_total": c.num_blocks,
                "kv_hbm_bytes": sum(t.numel() * t.element_size() for t in eng.cache.values()),
                "queue_depth": len(eng.waiting), "running": len(eng.running)}
        if got != {k: float(v) for k, v in want.items()}:
            raise AssertionError(f"engine: gauges {got} != the engine's {want}")
        out.update(got)

    return probe


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
    from ray_tpu_torch import obs

    eng.model_tag = tag = "chip-engine"
    hooks = _time_hooks(eng)
    gauges: dict = {}

    prompts, sps = _engine_traffic(model)

    # the kernels' counters, zeroed just before the main path runs
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    marks = _launch_marks(eng)
    replayed0 = _replayed_marks(eng)
    pmarks = _pass_marks(eng)
    slo0 = _slo_counts(tag)
    finals, reqs, wall, steps = _serve(eng, prompts, sps, "r",
                                       on_step=_gauge_probe(eng, gauges))
    launches = _launch_counts(eng, marks)
    replayed = {n: v - replayed0[n] for n, v in _replayed_marks(eng).items()}
    first_graphs = _pass_graphs(eng, pmarks)
    first_hooks = _hook_cost(hooks)
    first_obs = {"traces": _check_traces(obs.get_recorder(), _trace_ids(reqs),
                                         "engine first pass"),
                 "slo_samples": _check_slo_delta(slo0, tag, 12, "engine first pass"),
                 "gauges_at_step_3": gauges, "hooks": first_hooks}
    if not gauges:
        raise AssertionError("engine: the gauge probe never ran")

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
    # the hooks add no launch and no sync: the first pass launches and
    # replays what it did before they existed
    got = {n: {"device": launches[n], "eager": launches[n] - replayed[n],
               "in_replays": replayed[n]} for n in FIRST_PASS_LAUNCHES}
    if got != FIRST_PASS_LAUNCHES:
        raise AssertionError(f"engine: first-pass launches {got} != {FIRST_PASS_LAUNCHES}")
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
        "obs": first_obs,
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
    for key, rtag in (("warm", "w"), ("steady", "x")):
        eng.allocator.drop_prefix_cache()
        pmarks = _pass_marks(eng)
        slo0 = _slo_counts(tag)
        finals_w, reqs_w, wall_w, _ = _serve(eng, prompts, sps, rtag)
        res[key] = {**_pass_summary(finals_w, reqs_w, wall_w, finals),
                    "graphs": _pass_graphs(eng, pmarks),
                    "graphs_captured_so_far": eng._graphs.captures,
                    "chunks_by_steps_so_far": eng.stats()["pipeline"]["chunks_by_steps"],
                    "hooks": _hook_cost(hooks),
                    "traces": _check_traces(obs.get_recorder(), _trace_ids(reqs_w),
                                            f"engine {key} pass"),
                    "slo_samples": _check_slo_delta(slo0, tag, 12, f"engine {key} pass")}
    # one steady pair, hooks off then on, under a device-events-only
    # profiler (scripts/port_hooks_ab.py runs several pairs in turns)
    ab = {side: _ab_pass(eng, prompts, sps, finals, side, rtag, profiled=True)
          for side, rtag in (("off", "a"), ("on", "b"))}
    ab["on_over_off_tok_per_s"] = ab["on"]["output_tok_per_s"] / ab["off"]["output_tok_per_s"]
    res["hooks_ab"] = ab
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


def _ab_pass(eng, prompts, sps, first: dict, side: str, rtag: str, profiled: bool) -> dict:
    """One steady pass of the hooks A/B, the prefix cache emptied first:
    ``side`` "off" makes every hook a no-op on the instance, "on" times
    them (``_time_hooks``) and checks every request's trace. With
    ``profiled``, under torch.profiler recording device events only (no
    host op is recorded, so it costs both sides the same): the device's
    idle share. Also the interpreter's garbage-collection pauses inside the
    pass. The instance has the class's hooks again after it."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import obs

    for name in OBS_HOOKS:
        eng.__dict__.pop(name, None)
    acc = _time_hooks(eng) if side == "on" else None
    if side == "off":
        _hooks_off(eng)
    eng.allocator.drop_prefix_cache()
    c0 = sum(g.captures for g in _families(eng))

    def serve():
        with _gc_pauses() as gcp:
            return (*_serve(eng, prompts, sps, rtag), gcp)

    try:
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                finals, reqs, wall, _, pauses = serve()
        else:
            finals, reqs, wall, _, pauses = serve()
    finally:
        for name in OBS_HOOKS:
            eng.__dict__.pop(name, None)
    out = {"side": side, **_pass_summary(finals, reqs, wall, first),
           "gc_pause_ms": pauses["ms"], "gc_collections": pauses["n"],
           "graphs_captured": sum(g.captures for g in _families(eng)) - c0}
    if profiled:
        busy_ms, _ = _device_time(prof)
        out["device_busy_ms"] = busy_ms
        out["device_idle_share"] = None if busy_ms is None else 1.0 - busy_ms / 1e3 / wall
    if acc is not None:
        out["hooks"] = _hook_cost(acc)
        out["traces"] = _check_traces(obs.get_recorder(), _trace_ids(reqs),
                                      f"hooks A/B {side} pass")
    return out


@contextlib.contextmanager
def _gc_pauses():
    """The interpreter's garbage-collection pauses inside the block, as
    ``{"ms": ..., "n": ..., "ms_by_gen": [g0, g1, g2], "n_by_gen": [...]}``
    (by the generation collected)."""
    acc = {"ms": 0.0, "n": 0, "t0": None, "ms_by_gen": [0.0] * 3, "n_by_gen": [0] * 3}

    def cb(phase, info):
        if phase == "start":
            acc["t0"] = time.perf_counter()
        elif acc["t0"] is not None:
            dt = (time.perf_counter() - acc["t0"]) * 1e3
            acc["ms"] += dt
            acc["n"] += 1
            acc["ms_by_gen"][info["generation"]] += dt
            acc["n_by_gen"][info["generation"]] += 1
            acc["t0"] = None

    gc.callbacks.append(cb)
    try:
        yield acc
    finally:
        gc.callbacks.remove(cb)


def _trace_ids(reqs: dict) -> dict:
    return {r: q.trace.trace_id for r, q in reqs.items()}


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
    loaded, a quarter of the rows base: a first and a warm pass, then 2
    steady passes in turns with 2 of the same requests all on the base
    model (cut from 4 and 4 for the smoke's time), then one of each under
    torch.profiler (the all-base one against the engine phase's gives the
    delta ops' device time), beside the engine phase's numbers from this
    run."""
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
    for rnd in range(2):  # cut from four rounds for the smoke's time
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


def _serve(eng, prompts, sps, tag, mark_steps: bool = False, lora_ids=None, on_step=None):
    """Run the requests to completion (request i under adapter
    ``lora_ids[i]``, default none); the last request (the second on the
    shared prefix) arrives once the first one has its first token, so its
    admission can hit the prefix cache. With ``mark_steps`` each step runs
    inside a profiler range and its kind is recorded: "mixed" when it made
    a mixed dispatch, else "decode". ``on_step(i)`` runs after step i."""
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
        if on_step is not None:
            on_step(steps)
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
    events = _trace_events(prof)
    steps = sorted((s, e) for name, dt, s, e, _ in events
                   if dt == DeviceType.CPU and name == "chip_smoke.step")
    if len(steps) != len(kinds):
        raise AssertionError(f"{len(steps)} step ranges in the trace for {len(kinds)} steps")
    spans = _merged(sorted((s, e) for name, dt, s, e, _ in events
                           if dt == DeviceType.CUDA and name not in ANNOTATIONS))
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


def _trace_events(prof) -> list:
    """The trace's device events and the script's own host ranges, as
    (name, device type, start us, end us, async), read from the profiler's
    raw kineto results with ``prof.events()``'s filters, demangled names and
    times: the same intervals without building its FunctionEvent list,
    which takes seconds a pass at 8B."""
    cached = getattr(prof, "_chip_smoke_events", None)
    if cached is not None:
        return cached
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names: dict = {}
    out = []
    for e in res.events():
        dt, raw = e.device_type(), e.name()
        if dt == DeviceType.CPU and raw not in ANNOTATIONS:
            continue
        if _filter_name(raw) or getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        out.append((name, dt, (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000,
                    e.is_async() or e.start_thread_id() != e.end_thread_id()))
    prof._chip_smoke_events = out
    return out


def _device_time(prof):
    """(device busy ms as the union of kernel intervals, or None without
    device events; [(kernel name, device ms, calls)] largest first)."""
    from torch.autograd import DeviceType

    dev = [ev for ev in _trace_events(prof)
           if ev[1] == DeviceType.CUDA and ev[0] not in ANNOTATIONS]
    spans = sorted((s, e) for _, _, s, e, _ in dev)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    # device time by kernel name (an async entry counts no device time, as
    # in prof.key_averages())
    acc: dict = {}
    for name, _, s, e, is_async in dev:
        ms_n = acc.setdefault(name, [0.0, 0])
        ms_n[0] += 0.0 if is_async else (e - s) / 1e3
        ms_n[1] += 1
    by_name = sorted(((k, ms, n) for k, (ms, n) in acc.items() if ms > 0), key=lambda x: -x[1])
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
        "completions": completions, "chats": chat_outs, "streams": [t for _, t in stream_outs],
    }


def _ttft_count(model: str) -> int:
    """``llm_ttft_seconds``' sample count of one model, read from the
    Prometheus text the port exports."""
    from ray_tpu_torch.util.metrics import prometheus_text

    line = f'ray_tpu_llm_ttft_seconds_count{{model="{model}"}} '
    return next((int(ln[len(line):]) for ln in prometheus_text().splitlines()
                 if ln.startswith(line)), 0)


def _check_api_traces(server, rows: list, what: str) -> dict:
    """Every row's /v1/requests/{id}/trace holds api.* and engine.* spans
    and covers >= 90 % of the api span."""
    covs, n_spans = [], []
    for o in rows:
        t = server.request_trace(o["id"])
        names = {s["name"] for s in t.get("spans", ())}
        if not any(n.startswith("api.") for n in names) or not TRACE_NEED <= names \
                or not names & DECODE_SPANS:
            raise AssertionError(f"{what}: {o['id']}'s trace lacks spans: {sorted(names)}")
        covs.append(t["coverage_pct"])
        n_spans.append(t["total_spans"])
    if min(covs) < 90.0:
        raise AssertionError(f"{what}: span coverage {min(covs)} % < 90 %")
    return {"rows": len(covs), "coverage_pct_min": min(covs),
            "spans_per_row_mean": sum(n_spans) / len(n_spans)}


def _frontend_ab(server, recorded: dict, bodies) -> dict:
    """The host cost of the front end on like-for-like traffic: the 12
    completions alone, served through the LLMServer and handed to
    ``LLMEngine.generate`` on the runner's loop thread (the same engine,
    graphs and sampling parameters), in turns S E E S (cut from S E E S S E
    for the smoke's time), then one pass
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
    order = "SEES"  # cut from S E E S S E for the smoke's time
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
    chats and two token streams riding along, a first pass, two more (the
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
    ttft0 = _ttft_count("llama3-8b")
    first = _api_pass(server, recorded, bodies, chats, streams)
    launches = _launch_counts(eng, marks)
    res["first_pass_graphs"] = _pass_graphs(eng, pmarks)
    # one TTFT sample per finished row in the exported text
    res["ttft_samples_first_pass"] = _ttft_count("llama3-8b") - ttft0
    if res["ttft_samples_first_pass"] != len(recorded):
        raise AssertionError(f"api: {res['ttft_samples_first_pass']} TTFT samples for "
                             f"{len(recorded)} finished rows")
    if min(launches.values()) <= 0:
        raise AssertionError(f"api: a kernel of the path never launched: {launches}")
    res["kernel_launches"] = launches
    summary = lambda p: {k: v for k, v in p.items()  # noqa: E731
                         if k not in ("completions", "chats", "streams")}
    res["first"] = summary(first)
    # the 12 completions' texts, which the serve_disagg phase reports against
    res["first_texts"] = [o["choices"][0]["text"] for o in first["completions"]]
    if None in first["stream_ttft_s"]:
        raise AssertionError("api: a stream yielded no delta")
    # two more passes (cut from four for the smoke's time): the chunk controller may step to
    # a longer chunk in either and capture its graph (seconds of the pass),
    # so "warm" is the second pass and "steady" the median of the passes
    # that captured no graph
    passes = []
    for k in range(2):
        c0 = sum(g.captures for g in _families(eng))
        raw = _api_pass(server, recorded, bodies, chats, streams)
        passes.append({**summary(raw),
                       "graphs_captured": sum(g.captures for g in _families(eng)) - c0})
    # the traces of the last pass's rows (a first pass's requests may wait
    # in the runner's inbox behind a capturing step, outside every span)
    res["traces_last_pass"] = _check_api_traces(server, raw["completions"] + raw["chats"],
                                                "api last pass")
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
# serve
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method: str, url: str, body=None, timeout: float = 300.0) -> tuple:
    """(status, headers, body bytes) of one request over loopback; an HTTP
    error status is a result, not an exception."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _replica_server():
    """The LLMServer inside the serve phase's one replica: the in-process
    runtime's actors are threads of this process, so its object is here."""
    from ray_tpu_torch.core import runtime as rt

    servers = [a.instance._callable for a in rt.get_runtime().gcs.list_actors()
               if type(a.instance).__name__ == "Replica" and a.instance._callable is not None]
    if len(servers) != 1:
        raise AssertionError(f"serve: {len(servers)} LLMServer replicas, not 1")
    return servers[0]


def _serve_pass(base: str, handle, server, recorded: dict, bodies, chats, streams) -> dict:
    """One pass of the api traffic through Serve, every request on its own
    client thread, all started together: the completions and chats over
    HTTP (proxy -> handle -> router -> replica -> LLMServer), the streams
    through the app handle's ``generate_stream``. Client wall and tok/s
    (every output token the engine made for the pass / wall; also the 12
    completions' alone), engine TTFT, the streams' client TTFT."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    recorded.clear()
    server.runner.call(lambda: server.engine.allocator.drop_prefix_cache())
    t0 = 0.0

    def post(path, body):
        st, _, raw = _http("POST", base + path, body)
        if st != 200:
            raise AssertionError(f"serve: {path} answered {st}: {raw[:300]!r}")
        return json.loads(raw)

    def stream(prompt):
        first, deltas = None, []
        gen = handle.options(method_name="generate_stream", stream=True).remote(
            prompt, max_tokens=32, temperature=0.0)
        for d in gen:
            if first is None:
                first = time.perf_counter() - t0
            deltas.append(d)
        return first, "".join(deltas)

    n = len(bodies) + len(chats) + len(streams)
    torch.cuda.synchronize()
    with ThreadPoolExecutor(n) as pool:
        t0 = time.perf_counter()
        futs = ([pool.submit(post, "/v1/completions", b) for b in bodies]
                + [pool.submit(post, "/v1/chat/completions", b) for b in chats]
                + [pool.submit(stream, p) for p in streams])
        outs = [f.result() for f in futs]
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    completions, chat_outs, stream_outs = (outs[:len(bodies)],
                                           outs[len(bodies):len(bodies) + len(chats)],
                                           outs[len(bodies) + len(chats):])
    for o in completions + chat_outs:
        if o["choices"][0]["finish_reason"] not in ("length", "stop"):
            raise AssertionError(f"serve: finish_reason {o['choices'][0]['finish_reason']!r}")
    for o in completions:
        k, reason = o["usage"]["completion_tokens"], o["choices"][0]["finish_reason"]
        if not (k == 32 or reason == "stop"):
            raise AssertionError(f"serve: {k} tokens, finish {reason!r}, not 32 or a stop")
    if any(first is None for first, _ in stream_outs):
        raise AssertionError("serve: a handle stream yielded no delta")
    if len(recorded) != n:
        raise AssertionError(f"serve: {len(recorded)} engine requests for {n} sent")
    tokens = sum(len(r.output_token_ids) for r in recorded.values())
    cmpl_tokens = sum(o["usage"]["completion_tokens"] for o in completions)
    finishes = [o["choices"][0]["finish_reason"] for o in completions + chat_outs]
    return {
        "wall_s": wall, "output_tokens": tokens, "output_tok_per_s": tokens / wall,
        "completions_output_tok_per_s": cmpl_tokens / wall,
        "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival for r in recorded.values()])),
        "stream_ttft_s": [first for first, _ in stream_outs],
        "finish_reasons": {k: finishes.count(k) for k in sorted(set(finishes))},
    }


def _serve_burst(base: str, server, bodies) -> dict:
    """24 completions over HTTP at max_queue_depth 3, with the engine loop
    parked on a posted call so no submit is taken: the admission
    reservations admit 3, the other 21 come back 429 with Retry-After;
    then the loop goes on and the 3 finish."""
    import concurrent.futures
    import threading

    from ray_tpu_torch.llm.admission import AdmissionConfig, AdmissionController

    saved = server.admission
    server.admission = AdmissionController(AdmissionConfig(max_queue_depth=3),
                                           model_tag="llama3-8b")
    gate, parked = threading.Event(), concurrent.futures.Future()
    server.runner._post(("call", parked, lambda: gate.wait(120)))
    try:
        with concurrent.futures.ThreadPoolExecutor(24) as pool:
            futs = [pool.submit(_http, "POST", base + "/v1/completions",
                                {"prompt": b["prompt"], "max_tokens": 8, "temperature": 0.0})
                    for b in (bodies * 2)[:24]]
            deadline = time.time() + 120
            while sum(f.done() for f in futs) < 21 and time.time() < deadline:
                time.sleep(0.01)
            shed_before_release = sum(f.done() for f in futs)
            gate.set()
            outs = [f.result() for f in futs]
    finally:
        gate.set()
        server.admission = saved
    parked.result(timeout=60)
    shed = [(h, json.loads(raw)) for st, h, raw in outs if st == 429]
    admitted = [json.loads(raw) for st, _, raw in outs if st == 200]
    if len(shed) != 21 or len(admitted) != 3 or shed_before_release != 21:
        raise AssertionError(f"serve burst: {len(shed)} shed, {len(admitted)} admitted, "
                             f"{shed_before_release} answered before the loop went on: "
                             f"{[st for st, _, _ in outs]}")
    for h, payload in shed:
        if not h.get("Retry-After") or payload["error"]["code"] != 429:
            raise AssertionError(f"serve burst: a 429 without Retry-After: {h}, {payload}")
    for o in admitted:
        if o["usage"]["completion_tokens"] != 8 and o["choices"][0]["finish_reason"] != "stop":
            raise AssertionError(f"serve burst: an admitted request did not finish: {o}")
    return {"requests": 24, "max_queue_depth": 3, "admitted": len(admitted),
            "shed_429": len(shed), "retry_after_header": shed[0][0]["Retry-After"]}


class GrpcCompletions:
    """The serve phase's bytes-in/bytes-out deployment for the gRPC front
    door: a JSON completion body -> the app's ``LLMServer.completions`` ->
    its JSON payload; ``Models`` the same for ``models``."""

    def __init__(self, app: str):
        self.app = app

    def _llm(self):
        from ray_tpu_torch import serve

        return serve.get_app_handle(self.app)

    def Completions(self, data: bytes) -> bytes:
        body = json.loads(data)
        return json.dumps(self._llm().completions.remote(body).result(timeout_s=600)).encode()

    def Models(self, data: bytes) -> bytes:
        return json.dumps(self._llm().models.remote().result(timeout_s=60)).encode()


def _ordered_leg(server, send, bodies, what: str) -> dict:
    """The completion bodies sent through ``send`` (a client thread each,
    all in flight together) while the engine loop is parked on a posted
    call, each sent once the one before it sits in the loop's inbox: every
    leg meets the engine with the same requests in the same order before
    its first step, so the same batches and graph buckets, and bf16 greedy
    texts can be held equal across front doors. The prefix cache is
    emptied first. Texts, client wall (from the loop's release), the graphs
    captured and K3/K4's device launches over the leg."""
    import concurrent.futures
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    eng = server.engine
    server.runner.call(lambda: eng.allocator.drop_prefix_cache())
    gate, parked_at = threading.Event(), threading.Event()
    parked = concurrent.futures.Future()

    def park():
        parked_at.set()
        gate.wait(120)

    server.runner._post(("call", parked, park))
    if not parked_at.wait(60):
        raise AssertionError(f"{what}: the engine loop never took the parking call")
    marks, captures = _launch_marks(eng), sum(g.captures for g in _families(eng))
    with ThreadPoolExecutor(len(bodies)) as pool:
        futs = []
        try:
            for i, b in enumerate(bodies):
                futs.append(pool.submit(send, b))
                deadline = time.time() + 60
                while len(server.runner._inbox) < i + 1:
                    if futs[-1].done() or time.time() > deadline:
                        futs[-1].result(timeout=1)  # its error, if it failed
                        raise AssertionError(f"{what}: request {i} never reached the engine "
                                             "loop's inbox")
                    time.sleep(0.001)
        finally:
            t0 = time.perf_counter()
            gate.set()
        outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    parked.result(timeout=60)
    torch.cuda.synchronize()
    launches = _launch_counts(eng, marks)
    for o in outs:
        k, reason = o["usage"]["completion_tokens"], o["choices"][0]["finish_reason"]
        if not (k == 32 or reason == "stop"):
            raise AssertionError(f"{what}: {k} tokens, finish {reason!r}, not 32 or a stop")
    tokens = sum(o["usage"]["completion_tokens"] for o in outs)
    return {"texts": [o["choices"][0]["text"] for o in outs], "wall_s": wall,
            "output_tokens": tokens, "output_tok_per_s": tokens / wall,
            "graphs_captured": sum(g.captures for g in _families(eng)) - captures,
            "kernel_launches": launches}


def _rtt_ms(fn, n: int = 21) -> dict:
    """Round trips of ``fn`` in ms: the median and max of all but the
    first, and the first."""
    import numpy as np

    rtt = []
    for _ in range(n):
        t1 = time.perf_counter()
        fn()
        rtt.append((time.perf_counter() - t1) * 1e3)
    return {"median": float(np.median(rtt[1:])), "first": rtt[0], "max": float(max(rtt[1:])),
            "n": n - 1}


def _port_free(addr) -> bool:
    """A fresh bind to ``addr`` succeeds: nothing listens there."""
    import socket

    with socket.socket() as s:
        try:
            s.bind(tuple(addr))
            return True
        except OSError:
            return False


def _front_doors(base: str, server, bodies) -> dict:
    """The serve phase's other front doors on the same app ("llm"), with the
    decode-chunk controller held so every leg runs one schedule: the 12
    completions over HTTP, then through the framed-RPC ingress
    (``rpc_ingress_call(..., method="completions")``) and, where ``grpc``
    is installed, through the gRPC ingress and a bytes-in/bytes-out
    deployment around the app; each leg ordered (``_ordered_leg``). Fails
    unless every greedy text of each leg equals the HTTP leg's. The round
    trip of ``models`` through each door beside HTTP's."""
    import importlib.util

    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import pipeline
    from ray_tpu_torch.serve.rpc_ingress import rpc_ingress_call

    greedy = sum(b.get("temperature", 1.0) == 0.0 for b in bodies)
    out: dict = {}

    def post(body):
        st, _, raw = _http("POST", base + "/v1/completions", body)
        if st != 200:
            raise AssertionError(f"serve http leg: answered {st}: {raw[:300]!r}")
        return json.loads(raw)

    rpc = serve.start_rpc_ingress(port=0)
    out["rpc_addr"] = list(rpc.addr)
    legs = {"http": post,
            "rpc": lambda b: rpc_ingress_call(rpc.addr, b, app="llm", method="completions",
                                              timeout=600.0)}
    out["rpc_models_rtt_ms"] = _rtt_ms(
        lambda: rpc_ingress_call(rpc.addr, app="llm", method="models", timeout=60.0))
    if importlib.util.find_spec("grpc") is None:
        out["grpc"] = "not installed"
    else:
        import grpc

        serve.run(serve.deployment(GrpcCompletions, name="GrpcCompletions").bind("llm"),
                  name="grpc-gateway", route_prefix="/grpc-gateway")
        gr = serve.start_grpc_ingress(port=0)
        out["grpc_addr"] = list(gr.addr)
        chan = grpc.insecure_channel(f"{gr.addr[0]}:{gr.addr[1]}")
        md = (("application", "grpc-gateway"),)

        def unary(method):
            return chan.unary_unary(method, request_serializer=lambda b: b,
                                    response_deserializer=lambda b: b)

        legs["grpc"] = lambda b: json.loads(unary("/openai.Gateway/Completions")(
            json.dumps(b).encode(), metadata=md, timeout=600))
        out["grpc_models_rtt_ms"] = _rtt_ms(
            lambda: unary("/openai.Gateway/Models")(b"{}", metadata=md, timeout=60))
    note_chunk = pipeline.ChunkController.note_chunk
    pipeline.ChunkController.note_chunk = lambda self, *a, **k: None
    try:
        for name, send in legs.items():
            out[name] = _ordered_leg(server, send, bodies, f"serve {name} leg")
    finally:
        pipeline.ChunkController.note_chunk = note_chunk
        if "grpc" in legs:
            chan.close()
    want = out["http"]["texts"][:greedy]
    for name in legs:
        got = out[name]["texts"][:greedy]
        same = sum(a == b for a, b in zip(got, want))
        out[name]["greedy_texts_equal_http"] = f"{same}/{greedy}"
        if same != greedy:
            raise AssertionError(f"serve {name} leg: {same}/{greedy} greedy texts equal the "
                                 "HTTP leg's")
        if min(out[name]["kernel_launches"].values()) <= 0:
            raise AssertionError(f"serve {name} leg: a kernel never launched: "
                                 f"{out[name]['kernel_launches']}")
        del out[name]["texts"]
    return out


def serve_phase(dev, params, api_res: dict) -> dict:
    """LLAMA3_8B served through a Serve deployment: the in-process runtime
    (``ray_tpu_torch.init``), ``serve.start`` on a free loopback port and
    ``build_openai_app`` over the api phase's configuration and weights
    (the caller's tensors, by reference). The api traffic, completions and
    chats over HTTP from concurrent client threads and the two streams
    through the app handle, a first pass (the kernels' launches counted
    over it as in the api phase) and one more, then the same engine driven
    directly and through Serve in turns (S D S D, after a direct
    warm-up pass); steady is the median of the Serve passes after the first
    that captured no graph, beside the api phase's direct LLMServer passes;
    the round trip of /v1/models over HTTP and through the handle; then
    the 12 completions over HTTP, through the framed-RPC ingress and, where
    ``grpc`` is installed, through the gRPC ingress (``_front_doors``),
    with the round trip of ``models`` through each. Fails unless every
    completion has its 32 tokens or a stop, every greedy text of the RPC
    and gRPC legs equals the HTTP leg's, /v1/models names llama3-8b at
    8192, /-/healthz answers and an unknown route is a 404, the replica
    engine's weights
    are the caller's tensors, a greedy completion sent alone over HTTP
    has the text of the same completion sent alone through the handle, a
    burst past max_queue_depth gives 429s with Retry-After over HTTP, and
    after ``serve.shutdown()`` the engine loop has exited, the ingresses'
    ports are free and the card's allocated memory has fallen by at least
    the KV cache's bytes."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, build_openai_app
    from ray_tpu_torch.models.llama import sorted_leaves
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    mem_start = torch.cuda.memory_allocated()
    ray_tpu_torch.init()
    port = _free_port()
    serve.start(host="127.0.0.1", port=port)
    base = f"http://127.0.0.1:{port}"
    cfg = EngineConfig(model="llama3-8b", **ENGINE_KW)
    t0 = time.perf_counter()
    handle = build_openai_app(LLMConfig(model_id="llama3-8b", engine=cfg, params=params,
                                        tokenizer=IdTextTokenizer(cfg.model.vocab_size),
                                        device=str(dev)), route_prefix="/")
    init_s = time.perf_counter() - t0
    server = _replica_server()
    eng = server.engine
    recorded = _record_requests(eng)
    model = eng.config.model
    res = {"phase": "serve", "model": "LLAMA3_8B (registry name llama3-8b)",
           "dtype": "bfloat16", "layers": model.n_layers, "d_model": model.d_model,
           "path": "HTTP -> stdlib proxy -> DeploymentHandle -> router -> replica (async "
                   "actor) -> LLMServer -> engine loop thread -> LLMEngine",
           "server_init_s": init_s,
           "runtime_resources": ray_tpu_torch.cluster_resources()}
    if res["runtime_resources"].get("GPU", 0) < 1:
        raise AssertionError(f"serve: the runtime sees no GPU: {res['runtime_resources']}")

    # the replica's engine serves the caller's tensors, not a copy
    mine, theirs = sorted_leaves(params), sorted_leaves(eng.params)
    if len(mine) != len(theirs) or any(a.data_ptr() != b.data_ptr()
                                       for a, b in zip(mine, theirs)):
        raise AssertionError("serve: the replica engine's weights are not the caller's tensors")
    res["weights_by_reference"] = {"tensors": len(mine), "same_data_ptr": True}

    st, _, raw = _http("GET", base + "/-/healthz")
    if (st, raw) != (200, b"success"):
        raise AssertionError(f"serve: /-/healthz answered {st} {raw!r}")
    st, _, raw = _http("GET", base + "/v1/no-such-route")
    if st != 404:
        raise AssertionError(f"serve: an unknown route answered {st} {raw!r}")
    answers = []
    res["http_models_rtt_ms"] = _rtt_ms(
        lambda: answers.append(_http("GET", base + "/v1/models")))
    st, _, raw = answers[-1]
    card = json.loads(raw)["data"][0]
    if st != 200 or card["id"] != "llama3-8b" or card["max_model_len"] != 8192:
        raise AssertionError(f"serve: /v1/models says {st} {raw!r}")
    res["handle_models_rtt_ms"] = _rtt_ms(lambda: handle.models.remote().result())

    bodies, chats, streams = _api_traffic()
    # the main path: the counters zeroed just before the first pass, read
    # just after (eager launches + those of graph replays)
    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    marks = _launch_marks(eng)
    pmarks = _pass_marks(eng)
    first = _serve_pass(base, handle, server, recorded, bodies, chats, streams)
    launches = _launch_counts(eng, marks)
    res["first_pass_graphs"] = _pass_graphs(eng, pmarks)
    if min(launches.values()) <= 0:
        raise AssertionError(f"serve: a kernel of the path never launched: {launches}")
    res["kernel_launches"] = launches
    res["first"] = first

    def counted(fn):
        c0 = sum(g.captures for g in _families(eng))
        out = fn()
        return {**{k: v for k, v in out.items() if k not in ("completions", "chats", "streams")},
                "graphs_captured": sum(g.captures for g in _families(eng)) - c0}

    def steady_of(passes):
        # a pass that captured a graph pays its capture (a decode chunk's at
        # 8B: seconds): read the passes that captured none, as the api phase
        read = [p for p in passes if not p["graphs_captured"]] or passes
        return {"output_tok_per_s": float(np.median([p["output_tok_per_s"] for p in read])),
                "mean_ttft_s": float(np.median([p["mean_ttft_s"] for p in read])),
                "stream_ttft_s": [float(np.median([p["stream_ttft_s"][i] for p in read]))
                                  for i in range(len(streams))],
                "passes_read": len(read)}

    serve_pass = lambda: _serve_pass(base, handle, server, recorded, bodies, chats,  # noqa: E731
                                     streams)
    passes = [counted(serve_pass)]  # cut from two for the smoke's time
    res["warm"] = passes[0]
    # the same engine driven directly (the api phase's pass: LLMServer from
    # this thread's event loop) and through Serve over HTTP, in turns, after
    # one direct pass that captures the direct pattern's buckets; only the
    # passes that captured no graph are read
    direct_pass = lambda: _api_pass(server, recorded, bodies, chats, streams)  # noqa: E731
    order = "SDSD"  # cut from S D D S S D for the smoke's time
    ab = {"order": order, "direct_warmup": counted(direct_pass)}
    ab["passes"] = [{"path": k, **counted(serve_pass if k == "S" else direct_pass)}
                    for k in order]
    for k, name in (("S", "serve"), ("D", "direct")):
        read = [t for t in ab["passes"] if t["path"] == k and not t["graphs_captured"]]
        ab[name] = steady_of(read) if read else None
    ab["serve_over_direct"] = (ab["serve"]["output_tok_per_s"] / ab["direct"]["output_tok_per_s"]
                               if ab["serve"] and ab["direct"] else None)
    res["same_engine_ab"] = ab
    # steady: every Serve pass after the first, the turns' too
    passes += [t for t in ab["passes"] if t["path"] == "S"]
    res["steady"] = {**steady_of(passes), "passes": passes}
    api_first, api_steady = api_res["first"], api_res["steady"]
    res["api_phase"] = {
        "output_tok_per_s": {"first": api_first["output_tok_per_s"],
                             "steady": api_steady["output_tok_per_s"]},
        "mean_ttft_s": {"first": api_first["mean_ttft_s"], "steady": api_steady["mean_ttft_s"]},
        "stream_ttft_s": {"first": api_first["stream_ttft_s"],
                          "steady": api_steady["stream_ttft_s"]},
        "first_pass_peak_mem_gb": api_res["first_pass_graphs"]["peak_mem_gb"],
    }
    res["serve_over_api_tok_per_s"] = {
        "first": first["output_tok_per_s"] / api_first["output_tok_per_s"],
        "steady": res["steady"]["output_tok_per_s"] / api_steady["output_tok_per_s"]}
    res["peak_mem_gb_minus_api_phase"] = (res["first_pass_graphs"]["peak_mem_gb"]
                                          - api_res["first_pass_graphs"]["peak_mem_gb"])

    # one greedy completion sent alone over HTTP, then alone through the
    # handle (prefix cache emptied before each): the same text
    probe = {"prompt": bodies[1]["prompt"], "max_tokens": 32, "temperature": 0.0}
    texts = []
    for via in ("http", "handle"):
        server.runner.call(lambda: eng.allocator.drop_prefix_cache())
        if via == "http":
            st, _, raw = _http("POST", base + "/v1/completions", probe)
            texts.append(json.loads(raw)["choices"][0]["text"])
        else:
            texts.append(handle.completions.remote(probe).result()["choices"][0]["text"])
    if texts[0] != texts[1] or not texts[0]:
        raise AssertionError(f"serve: HTTP and handle texts differ: {texts}")
    res["http_equals_handle"] = {"tokens": texts[0].count("<"), "equal": True}

    # the 12 completions over HTTP, the framed-RPC ingress and (with grpc)
    # the gRPC ingress, each leg on one schedule: the greedy texts equal
    res["front_doors"] = _front_doors(base, server, bodies)

    res["burst"] = _serve_burst(base, server, bodies)

    # shutdown: the replica's shutdown hook stops the engine loop and frees
    # the KV cache and graphs; the weights stay (they are the caller's)
    kv_bytes = eng._kv_cache_nbytes
    thread = server.runner._thread
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    serve.shutdown()
    ray_tpu_torch.shutdown()
    shutdown_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    if thread.is_alive():
        raise AssertionError("serve: the engine loop thread outlived serve.shutdown()")
    doors = res["front_doors"]
    freed = {k: _port_free(doors[f"{k}_addr"]) for k in ("rpc", "grpc") if f"{k}_addr" in doors}
    doors["ports_free_after_shutdown"] = freed
    if not all(freed.values()):
        raise AssertionError(f"serve: an ingress's port is still bound after serve.shutdown(): "
                             f"{freed}")
    if mem_before - mem_after < kv_bytes:
        raise AssertionError(f"serve: shutdown freed {mem_before - mem_after} B of the card, "
                             f"less than the KV cache's {kv_bytes} B")
    res["shutdown"] = {"seconds": shutdown_s, "kv_cache_bytes": kv_bytes,
                       "allocated_freed_bytes": mem_before - mem_after,
                       "allocated_left_over_phase_start_bytes": mem_after - mem_start}
    del server, eng, handle, recorded
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# serve_disagg
# ---------------------------------------------------------------------------


def _disagg_replicas() -> dict:
    """The serve_disagg phase's replica objects by class name (the
    in-process runtime's actors are threads of this process)."""
    from ray_tpu_torch.core import runtime as rt

    out: dict = {}
    for a in rt.get_runtime().gcs.list_actors():
        inst = a.instance
        if type(inst).__name__ == "Replica" and inst._callable is not None:
            out.setdefault(type(inst._callable).__name__, []).append(inst._callable)
    return out


def _replica_pool(server):
    """A disaggregated Serve replica as ``_pool_marks`` reads an engine of
    the orchestrator: its engine and its loop thread's ``call``."""
    import types

    return types.SimpleNamespace(call=server._loop.call, engine=server.engine)


def _disagg_serve_pass(handle, bodies, recorded: dict) -> dict:
    """One pass of completions through the disaggregated app's ingress
    handle, each on its own client thread, all started together: client
    wall and tok/s (completion tokens / wall), TTFT at the prefill engine
    (first token booked - arrival there)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    recorded.clear()

    def post(body):
        return handle.remote(ApiRequest("POST", "/v1/completions", body)).result(timeout_s=600)

    torch.cuda.synchronize()
    with ThreadPoolExecutor(len(bodies)) as pool:
        t0 = time.perf_counter()
        outs = [f.result() for f in [pool.submit(post, b) for b in bodies]]
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    for o in outs:
        if "choices" not in o:
            raise AssertionError(f"serve_disagg: a request failed: {o}")
        k, reason = o["usage"]["completion_tokens"], o["choices"][0]["finish_reason"]
        if not (k == 32 or reason == "stop"):
            raise AssertionError(f"serve_disagg: {k} tokens, finish {reason!r}, not 32 or a stop")
    if len(recorded) != len(bodies):
        raise AssertionError(f"serve_disagg: {len(recorded)} prefill requests for "
                             f"{len(bodies)} sent")
    tokens = sum(o["usage"]["completion_tokens"] for o in outs)
    return {"wall_s": wall, "output_tokens": tokens, "output_tok_per_s": tokens / wall,
            "finished_at_prefill": sum(o["usage"]["completion_tokens"] == 0
                                       and o["choices"][0]["finish_reason"] == "stop"
                                       for o in outs),
            "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival
                                          for r in recorded.values()])),
            "texts": [o["choices"][0]["text"] for o in outs]}


# the autoscale leg: thresholds from a warm single request's TTFT at the
# prefill engine (the median of AUTOSCALE_BASE_N), multiplied and then
# rounded up to the TTFT histogram's next boundary (a percentile over the
# merged buckets reads a bucket's upper boundary, so a threshold between
# two boundaries would grade a sample by the boundary above it anyway)
AUTOSCALE_TTFT_MULT = 2.0
AUTOSCALE_PERCENTILE = 50.0
AUTOSCALE_MIN_COUNT = 4
AUTOSCALE_BASE_N = 3
AUTOSCALE_QUIET_LEN = 128      # tokens of a warm / quiet request's prompt (BOS included)
AUTOSCALE_QUIET_MAX = 80       # quiet requests at most before the pool must be back at 1
AUTOSCALE_QUIET_AFTER = 2      # quiet requests served after the drain
AUTOSCALE_QUIET_GAP_S = 0.1
AUTOSCALE_INTERVAL_S = 0.5
AUTOSCALE_STALL_TICKS = 3
AUTOSCALE_MEM_SLACK = 64 << 20
AUTOSCALE_WAIT_S = 60.0        # every wait of the leg fails past this


def _salted(body: dict) -> dict:
    """``body`` with its prompt's first character moved one place along the
    printable range: same length, so the same batch shapes, and no block of
    it in any prefix cache."""
    p = body["prompt"]
    return {**body, "prompt": chr(32 + (ord(p[0]) - 31) % 95) + p[1:]}


def _watch_tally(srv, marks: dict) -> None:
    """Keep ``marks`` equal to ``srv``'s serving kernels' launches (its loop
    thread's tally, its graph families' replays and captures) after every
    step of its loop: they stay readable after the loop has exited and the
    thread's tally is gone."""
    from ray_tpu_torch.ops.paged_attention import thread_launches

    loop, step = srv._loop, srv._loop._step_fn

    def counted():
        try:
            return step()
        finally:
            tally = thread_launches()
            fams = _families(srv.engine)
            marks.update({n: {"tally": tally.get(n, 0),
                              "replayed": sum(g.launches.get(n, 0) for g in fams),
                              "captured": sum(g.captured_launches.get(n, 0) for g in fams)}
                          for n in ("paged_attention", "ragged_attention")})

    loop._step_fn = counted


def _leg_wait(cond, what: str, timeout_s: float = AUTOSCALE_WAIT_S, poll_s: float = 0.01):
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"serve_disagg autoscale: waited {timeout_s} s for {what}")
        time.sleep(poll_s)


def _stall_watch(auto, out: dict, stop) -> None:
    """Install STALL_GCS on ``autoscale_signals`` (max_fires 3) right after
    the first tick at which the prefill pool's up-window started building
    (its breach or span-sized streak at 1), and take it out once the three
    stalled ticks have run."""
    from ray_tpu_torch import chaos

    try:
        while not stop.is_set():
            st = auto.policy.state("prefill")
            if st.breach_streak or st.sized_streak:
                dark0 = auto.num_dark_ticks
                chaos.install(chaos.FaultSchedule(22, [chaos.FaultSpec(
                    chaos.STALL_GCS, site="gcs.call", match={"method": "autoscale_signals"},
                    max_fires=AUTOSCALE_STALL_TICKS)]))
                out.update(installed_at_tick=auto.num_ticks, t_installed=time.monotonic(),
                           streaks=(st.breach_streak, st.sized_streak), dark_before=dark0,
                           log_len=len(auto.decision_log()))
                deadline = time.monotonic() + AUTOSCALE_WAIT_S
                while auto.num_dark_ticks < dark0 + AUTOSCALE_STALL_TICKS:
                    if time.monotonic() > deadline:
                        out["error"] = "the stalled ticks never ran"
                        return
                    time.sleep(0.005)
                chaos.uninstall()
                out.update(uninstalled_at_tick=auto.num_ticks, t_uninstalled=time.monotonic())
                return
            time.sleep(0.005)
    finally:
        chaos.uninstall()


def _autoscale_leg(dev, handle, prefill, decode, params, bodies, recorded) -> dict:
    """The serve_disagg phase's autoscale leg (see the module docstring).
    Returns its report, with ``survivor``: the prefill replica left
    serving."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.autoscale import (
        ACTION_HOLD, ACTION_SCALE_DOWN, ACTION_SCALE_UP, POOL_DECODE, POOL_PREFILL,
        AutoscaleConfig, PoolAutoscaler, PoolLimits, ServePoolActuator)
    from ray_tpu_torch.cluster.gcs_service import GcsServer
    from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient
    from ray_tpu_torch.models.llama import sorted_leaves
    from ray_tpu_torch.obs.slo import ttft_histogram
    from ray_tpu_torch.obs.telemetry import TelemetryReporter
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda
    from ray_tpu_torch.util.metrics import clear_registry

    t_leg = time.perf_counter()
    rng = np.random.default_rng(22)

    def quiet_body():
        n = AUTOSCALE_QUIET_LEN - 1  # BOS
        text = rng.integers(32, 127, size=n).astype(np.uint8).tobytes().decode()
        return {"prompt": text, "max_tokens": 32, "temperature": 0.0}

    def post(body):
        o = handle.remote(ApiRequest("POST", "/v1/completions", body)).result(timeout_s=600)
        if "choices" not in o:
            raise AssertionError(f"serve_disagg autoscale: a request failed: {o}")
        k, reason = o["usage"]["completion_tokens"], o["choices"][0]["finish_reason"]
        if not (k == 32 or reason == "stop"):
            raise AssertionError(f"serve_disagg autoscale: {k} tokens, finish {reason!r}, "
                                 "not 32 or a stop")
        return o

    def ttfts(rids):
        return [recorded[r].t_first_token - recorded[r].arrival for r in rids]

    # warm the single-request buckets on both engines, then start the
    # telemetry from a registry holding no earlier phase's series (the
    # grades are the worst over every model tag the GCS holds)
    for _ in range(2):
        post(quiet_body())
    clear_registry()
    server = GcsServer(port=0)
    addr = server.start()
    res: dict = {}
    reporter = gcs = auto = None
    stop_watch = threading.Event()
    try:
        reporter = TelemetryReporter(addr, reporter_id="serve_disagg", kind="engine",
                                     interval_s=AUTOSCALE_INTERVAL_S / 2)
        gcs = ReconnectingRpcClient(*addr, timeout=5).connect()
        reporter.start()
        recorded.clear()
        for _ in range(AUTOSCALE_BASE_N):
            post(quiet_body())
        base = float(np.median(ttfts(list(recorded))))
        want = AUTOSCALE_TTFT_MULT * base
        bounds = ttft_histogram().boundaries
        thr = next((b for b in bounds if b >= want), bounds[-1])
        thresholds = {"ttft_p_s": thr, "percentile": AUTOSCALE_PERCENTILE,
                      "min_count": AUTOSCALE_MIN_COUNT}
        res["thresholds"] = {**thresholds, "warm_single_ttft_s": base,
                             "multiple": AUTOSCALE_TTFT_MULT,
                             "rule": "multiple x the median warm single-request TTFT at the "
                                     "prefill engine, rounded up to the next TTFT bucket "
                                     "boundary"}

        class Actuator(ServePoolActuator):
            """Reads the card's allocated bytes just before a scale-up."""
            mem_before_up = None

            def apply(self, decision):
                if decision.action == ACTION_SCALE_UP and self.mem_before_up is None:
                    self.mem_before_up = torch.cuda.memory_allocated(dev)
                super().apply(decision)

        act = Actuator(serve.api._get_controller_handle())
        auto = PoolAutoscaler(
            AutoscaleConfig(pools={POOL_PREFILL: PoolLimits(1, 2), POOL_DECODE: PoolLimits(1, 1)},
                            breach_ticks=2, green_ticks=3, scale_up_cooldown_s=0.0,
                            scale_down_cooldown_s=2.0, interval_s=AUTOSCALE_INTERVAL_S),
            act, gcs=gcs, thresholds=thresholds, log_len=1 << 14)
        pools = {"prefill": _replica_pool(prefill), "decode": _replica_pool(decode)}
        # the leg's K3/K4: the counters zeroed just before it, read after
        paged_attention_cuda.launches = 0
        ragged_attention_cuda.launches = 0
        before = {r: _pool_marks(p) for r, p in pools.items()}
        marks1: dict = {}  # the first prefill replica's, readable if it is the one drained
        _watch_tally(prefill, marks1)
        fam_before = {n: sum(g.launches.get(n, 0) - g.captured_launches.get(n, 0)
                             for srv in (prefill, decode) for g in _families(srv.engine))
                      for n in ("paged_attention", "ragged_attention")}
        auto.start()
        watch: dict = {}
        watcher = threading.Thread(target=_stall_watch, args=(auto, watch, stop_watch),
                                   name="chip-smoke-stall-watch", daemon=True)
        watcher.start()

        # the burst: the 12 at once, each on its own client thread
        recorded.clear()
        burst = [_salted(b) for b in bodies]
        torch.cuda.synchronize()
        with ThreadPoolExecutor(len(burst)) as pool:
            t0 = time.perf_counter()
            outs = [f.result() for f in [pool.submit(post, b) for b in burst]]
            burst_wall = time.perf_counter() - t0
        tt = ttfts(list(recorded))
        toks = sum(o["usage"]["completion_tokens"] for o in outs)
        res["burst"] = {"requests": len(outs), "wall_s": burst_wall, "output_tokens": toks,
                        "output_tok_per_s": toks / burst_wall,
                        "ttft_s": {"p50": float(np.percentile(tt, 50)),
                                   "p95": float(np.percentile(tt, 95)),
                                   "min": min(tt), "max": max(tt)},
                        "greedy_streams_vs_api_phase": "not compared: the prompts' first "
                                                       "character is shifted"}

        # the scale-up, and the stall window while its breach built
        ups = _leg_wait(lambda: [e for e in auto.decision_log()
                                 if e["pool"] == "prefill" and e["action"] == ACTION_SCALE_UP],
                        "a prefill scale_up decision")
        watcher.join(timeout=AUTOSCALE_WAIT_S)
        if watcher.is_alive() or "error" in watch or "installed_at_tick" not in watch:
            raise AssertionError(f"serve_disagg autoscale: the stall window {watch}")
        log = auto.decision_log()
        t_first_breach = watch["t_installed"]
        stall = log[watch["log_len"]:]
        dark = [e for e in stall if e["gcs_dark"]]
        after_dark = [e for e in stall if not e["gcs_dark"]]
        acted_in_dark = [e for e in dark if e["action"] != ACTION_HOLD]
        n_dark = len({e["t"] for e in dark})
        pre_up = [e for e in after_dark if e["pool"] == "prefill"]
        ticks_to_up = next((i + 1 for i, e in enumerate(pre_up)
                            if e["action"] == ACTION_SCALE_UP), None)
        if n_dark != AUTOSCALE_STALL_TICKS or acted_in_dark or ticks_to_up is None \
                or ticks_to_up < auto.config.breach_ticks \
                or any(e["action"] != ACTION_HOLD for e in log[:watch["log_len"]]):
            raise AssertionError(f"serve_disagg autoscale: stall window: {n_dark} dark ticks, "
                                 f"actions in it {acted_in_dark}, scale_up at recovered tick "
                                 f"{ticks_to_up}")
        up = ups[0]
        if up["target"] != 2 or not ("breach" in up["reason"] or "span-sized" in up["reason"]):
            raise AssertionError(f"serve_disagg autoscale: the scale-up {up}")
        res["stall"] = {"dark_ticks": n_dark, "actions_in_window": 0,
                        "streaks_at_install": watch["streaks"],
                        "recovered_ticks_to_scale_up": ticks_to_up}

        # the added replica: watched from before its first request
        added = _leg_wait(lambda: [s for s in _disagg_replicas().get("PrefillServer", [])
                                   if s is not prefill], "the added prefill replica")
        (added,) = added
        marks2: dict = {}
        _watch_tally(added, marks2)
        _leg_wait(lambda: act.pool_state()["prefill"]["replicas_running"] == 2,
                  "the prefill pool to run 2 replicas")
        t_running = time.monotonic()
        if t_running - t_first_breach > AUTOSCALE_WAIT_S:
            raise AssertionError("serve_disagg autoscale: 2 prefill replicas ran "
                                 f"{t_running - t_first_breach:.1f} s after the first breach")
        mine = sorted_leaves(params)
        theirs = sorted_leaves(added.engine.params)
        if len(mine) != len(theirs) or any(a.data_ptr() != b.data_ptr()
                                           for a, b in zip(mine, theirs)):
            raise AssertionError("serve_disagg autoscale: the added engine's weights are not "
                                 "the caller's tensors")
        res["scale_up"] = {"reason": up["reason"], "decision_to_running_s": t_running - up["t"],
                           "first_breach_to_running_s": t_running - t_first_breach,
                           "weights_by_reference": True}

        # quiet traffic, one request at a time, until the pool has drained
        caps_before = {"prefill": sum(g.captures for g in _families(prefill.engine)),
                       "decode": sum(g.captures for g in _families(decode.engine))}
        quiet, n_after, drained_at = [], 0, None
        t0 = time.perf_counter()
        while n_after < AUTOSCALE_QUIET_AFTER:
            if len(quiet) >= AUTOSCALE_QUIET_MAX:
                raise AssertionError(f"serve_disagg autoscale: the pool was not back at 1 "
                                     f"after {len(quiet)} quiet requests: "
                                     f"{[e for e in auto.decision_log() if e['action'] != ACTION_HOLD]}")
            quiet.append(post(quiet_body()))
            if drained_at is None and act.pool_state()["prefill"]["replicas_running"] == 1:
                drained_at = len(quiet)
            n_after += drained_at is not None
            time.sleep(AUTOSCALE_QUIET_GAP_S)
        quiet_wall = time.perf_counter() - t0
        qtoks = sum(o["usage"]["completion_tokens"] for o in quiet)
        res["quiet"] = {"requests": len(quiet), "pool_back_at_1_after": drained_at,
                        "wall_s": quiet_wall, "output_tokens": qtoks,
                        "output_tok_per_s": qtoks / quiet_wall}

        # the drain: the victim's loop exits, its memory comes back
        downs = [e for e in auto.decision_log() if e["pool"] == "prefill"
                 and e["action"] == ACTION_SCALE_DOWN]
        victims = _leg_wait(lambda: [s for s in (prefill, added)
                                     if not s._loop.thread.is_alive()],
                            "the drained replica's loop to exit")
        t_exit = time.monotonic()
        if len(downs) != 1 or downs[0]["target"] != 1 or len(victims) != 1:
            raise AssertionError(f"serve_disagg autoscale: scale-downs {downs}, drained "
                                 f"{len(victims)} replicas")
        (victim,) = victims
        survivor = added if victim is prefill else prefill
        mem_up = act.mem_before_up

        def mem_back():
            torch.cuda.synchronize()
            now = torch.cuda.memory_allocated(dev)
            return now if now - mem_up <= AUTOSCALE_MEM_SLACK else None

        mem_after = _leg_wait(mem_back, "the card's allocated memory to come back within "
                                        "64 MB of its value before the scale-up", poll_s=0.1)
        st = _leg_wait(lambda: (lambda a: a if (a["scale_ups_total"] or 0) >= 1
                                and (a["scale_downs_total"] or 0) >= 1
                                and a["pool_targets"].get("prefill") == 1 else None)(
            gcs.call("telemetry_status", {}, timeout=5)["autoscale"]),
            "the GCS's autoscale block to show a scale-up, a scale-down and a prefill "
            "target of 1", poll_s=0.1)
        log = auto.decision_log()
        if any(e["pool"] == "decode" and e["action"] != ACTION_HOLD for e in log):
            raise AssertionError("serve_disagg autoscale: the decode pool took a scale action")
        if [e["action"] for e in log if e["action"] != ACTION_HOLD] != \
                [ACTION_SCALE_UP, ACTION_SCALE_DOWN]:
            raise AssertionError(f"serve_disagg autoscale: actions "
                                 f"{[e for e in log if e['action'] != ACTION_HOLD]}")
        res["scale_down"] = {"reason": downs[0]["reason"],
                             "victim": "added" if victim is added else "first",
                             "decision_to_loop_exit_s": t_exit - downs[0]["t"],
                             "memory": {"before_scale_up": mem_up, "after_drain": mem_after,
                                        "delta_bytes": mem_after - mem_up}}
        res["gcs_autoscale_block"] = {k: st[k] for k in ("scale_ups_total", "scale_downs_total",
                                                         "pool_targets", "decisions_by_action",
                                                         "gcs_dark")}
        res["ticks"] = {"total": auto.num_ticks, "dark": auto.num_dark_ticks,
                        "scale_actions": auto.num_scale_actions}

        # every engine's K3/K4 in the leg, eager and in replays
        zero = {n: {"tally": 0, "replayed": 0, "captured": 0}
                for n in ("paged_attention", "ragged_attention")}
        per_engine = {"prefill": _pool_launches(before["prefill"], marks1),
                      "decode": _pool_launches(before["decode"], _pool_marks(pools["decode"])),
                      "prefill_added": _pool_launches(zero, marks2)}
        if per_engine["prefill_added"]["ragged_attention"]["device"] <= 0:
            raise AssertionError(f"serve_disagg autoscale: K4 never launched on the added "
                                 f"replica: {per_engine['prefill_added']}")
        total = {n: f.launches + sum(g.launches.get(n, 0) - g.captured_launches.get(n, 0)
                                     for srv in (prefill, decode, added)
                                     for g in _families(srv.engine)) - fam_before[n]
                 for n, f in (("paged_attention", paged_attention_cuda),
                              ("ragged_attention", ragged_attention_cuda))}
        res["kernel_launches"] = total
        res["kernel_launches_per_engine"] = per_engine
        fams2 = _families(added.engine)
        res["added_replica"] = {"captures": sum(g.captures for g in fams2),
                                "capture_s": sum(g.capture_s for g in fams2),
                                "quiet_captures_survivors": {
                                    "prefill": sum(g.captures for g in _families(prefill.engine))
                                    - caps_before["prefill"],
                                    "decode": sum(g.captures for g in _families(decode.engine))
                                    - caps_before["decode"]}}
        # every request of the leg returned its 32 tokens or a stop (post
        # raises otherwise)
        res["requests"] = {"warm_up": 2, "base": AUTOSCALE_BASE_N, "burst": len(outs),
                           "quiet": len(quiet), "lost": 0}
        res["survivor"] = survivor
    finally:
        stop_watch.set()
        if auto is not None:
            auto.stop()
        if reporter is not None:
            reporter.stop()
        if gcs is not None:
            gcs.close()
        server.stop()
    res["leg_s"] = time.perf_counter() - t_leg
    return res


def serve_disagg_phase(dev, params, api_res: dict) -> dict:
    """LLAMA3_8B served by ``build_disagg_openai_app`` on the in-process
    runtime: one prefill and one decode replica, each an engine over the api
    phase's configuration plus the tiered cache (``kvtier={}``) and the
    caller's weights (by reference), each stepped by its replica's loop
    thread, handing KV over the device fabric (``connector="device"``: pages
    gathered and sealed on the card, moved to the decode engine's cache
    device by reference) behind an ingress that pins each decode wait to
    its replica and routes by the app's prefix index. The api phase's 12
    completions through the ingress handle, each on its own client thread:
    a first pass (the kernels' counters zeroed just before and read after;
    each engine's K3/K4 launches, eager and in replays, from its loop
    thread's tally), then the two requests on the 512-token shared prefix
    again, then the autoscale leg (``_autoscale_leg``). Fails unless every completion has its 32 tokens or
    a stop, K4 launched on the prefill engine and K3 on the decode engine,
    all 12 first-pass handoffs went by the device plane with their pages on
    the card and no stage through host memory, the ingress routed at least
    one request by prefix, ``serve.status()`` tags the pools ``prefill`` and
    ``decode``, both engines hold the caller's tensors, and after
    ``serve.shutdown()`` both loops have exited and the card's allocated
    memory fell by at least the two KV caches' bytes. Reports each pass's
    TTFT (at the prefill engine) and tok/s, captures per engine, each
    handoff's send ms, and the greedy streams against the api phase's (not
    gated: another batch shape in bf16)."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, LLMConfig
    from ray_tpu_torch.models.llama import sorted_leaves
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda
    from ray_tpu_torch.serve import build_disagg_openai_app

    t_phase = time.perf_counter()
    ray_tpu_torch.init()
    cfg = EngineConfig(model="llama3-8b", **ENGINE_KW, kvtier={})
    tok = IdTextTokenizer(cfg.model.vocab_size)
    cfg.eos_token_id = tok.eos_token_id  # as LLMServer sets it on its config
    t0 = time.perf_counter()
    handle = build_disagg_openai_app(
        LLMConfig(model_id="llama3-8b", engine=cfg, params=params, tokenizer=tok,
                  device=str(dev)),
        num_prefill=1, num_decode=1, connector="device", name="llm-disagg",
        route_prefix=None)
    init_s = time.perf_counter() - t0
    reps = _disagg_replicas()
    (prefill,), (decode,) = reps["PrefillServer"], reps["DecodeServer"]
    model = prefill.engine.config.model
    res = {"phase": "serve_disagg", "model": "LLAMA3_8B (registry name llama3-8b)",
           "dtype": "bfloat16", "layers": model.n_layers, "d_model": model.d_model,
           "path": "DeploymentHandle -> DisaggIngress -> PrefillServer (engine loop: "
                   "prefill, export on the card) -> device fabric -> DecodeServer (engine "
                   "loop: import, decode) <- pinned wait_finish",
           "app_init_s": init_s}
    mine = sorted_leaves(params)
    for name, srv in (("prefill", prefill), ("decode", decode)):
        theirs = sorted_leaves(srv.engine.params)
        if len(mine) != len(theirs) or any(a.data_ptr() != b.data_ptr()
                                           for a, b in zip(mine, theirs)):
            raise AssertionError(f"serve_disagg: the {name} engine's weights are not the "
                                 "caller's tensors")
    res["weights_by_reference"] = {"tensors": len(mine), "engines": 2, "same_data_ptr": True}
    roles = {n: d.get("role") for a in serve.status()["applications"].values()
             for n, d in a["deployments"].items()}
    if roles.get("Prefill:llama3-8b") != "prefill" or roles.get("Decode:llama3-8b") != "decode":
        raise AssertionError(f"serve_disagg: serve.status() roles {roles}")
    res["roles"] = roles
    endpoint = decode.connector.transport.endpoint_device(decode.index_key())
    if endpoint != decode.engine.kv_cache_device():
        raise AssertionError(f"serve_disagg: the device endpoint {endpoint} is not the "
                             "decode cache's device")

    bodies, _, _ = _api_traffic()
    recorded = _record_requests(prefill.engine)
    sends = _record_sends(prefill.connector)
    sends["keep"] = True  # the first pass's handoffs, read after it

    def captures(srv):
        return sum(g.captures for g in _families(srv.engine))

    # the main path: the counters zeroed just before the first pass, read
    # just after (eager launches + those of graph replays, both engines)
    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    pools = {"prefill": _replica_pool(prefill), "decode": _replica_pool(decode)}
    before = {r: _pool_marks(p) for r, p in pools.items()}
    caps = {"prefill": captures(prefill), "decode": captures(decode)}
    first = _disagg_serve_pass(handle, bodies, recorded)
    per_engine = {r: _pool_launches(before[r], _pool_marks(p)) for r, p in pools.items()}
    total = {n: f.launches + sum(g.launches.get(n, 0) - g.captured_launches.get(n, 0)
                                 for srv in (prefill, decode) for g in _families(srv.engine))
             for n, f in (("paged_attention", paged_attention_cuda),
                          ("ragged_attention", ragged_attention_cuda))}
    first["captures"] = {r: captures(srv) - caps[r]
                         for r, srv in (("prefill", prefill), ("decode", decode))}
    if per_engine["prefill"]["ragged_attention"]["device"] <= 0 or \
            per_engine["decode"]["paged_attention"]["device"] <= 0 or min(total.values()) <= 0:
        raise AssertionError(f"serve_disagg: K4 on the prefill engine and K3 on the decode "
                             f"engine must launch: {per_engine}, total {total}")
    res["kernel_launches"] = total
    res["kernel_launches_per_engine"] = per_engine
    hand = list(sends["sent"].values())
    sends["keep"], sends["sent"] = False, {}
    backends = {prefill.connector.name: len(hand)} if hand else {}
    # a device handoff staged through host memory has a pin, d2h or h2d
    # stage, pages off the card or a host checksum
    staged = [h.request_id for h in hand
              if any(k in h.timings for k in ("pin_ms", "d2h_ms", "h2d_ms"))
              or h.k_pages.device.type != dev.type or h.checksum_kind != "device_u32"]
    # a request whose first token is EOS finishes at its prefill: no handoff
    at_prefill = first["finished_at_prefill"]
    if backends != {"device": len(bodies) - at_prefill} or staged:
        raise AssertionError(f"serve_disagg: first-pass handoffs {backends}, staged "
                             f"through host memory: {staged}")
    send_ms = [sends["send_ms"][h.request_id] for h in hand]
    first["handoffs"] = {"backends": backends, "staged": 0, "finished_at_prefill": at_prefill,
                         "bytes": sum(h.nbytes for h in hand),
                         "send_ms": {"mean": float(np.mean(send_ms)), "min": min(send_ms),
                                     "max": max(send_ms), "total": float(sum(send_ms))}}
    texts = first.pop("texts")
    want = api_res["first_texts"]
    same = sum(texts[i] == want[i] for i in range(10))
    first["greedy_streams_equal_api_phase"] = f"{same}/10"
    res["first"] = first

    # the two requests on the 512-token shared prefix again: the app's index
    # holds their chains on both engines by now (the autoscale leg's burst is
    # the phase's second pass of 12 at once)
    repeat = _disagg_serve_pass(handle, [bodies[0], bodies[11]], recorded)
    repeat.pop("texts")
    res["shared_prefix_repeat"] = repeat
    stats = handle.stats.remote().result(timeout_s=60)
    res["ingress_stats"] = {k: stats[k] for k in ("mode", "reprefills", "prefix_routed")}
    if stats["prefix_routed"] < 1 or stats["reprefills"] != 0:
        raise AssertionError(f"serve_disagg: ingress stats {res['ingress_stats']}")
    res["handoffs_total"] = len(sends["send_ms"])

    leg = _autoscale_leg(dev, handle, prefill, decode, params, bodies, recorded)
    prefill = leg.pop("survivor")
    res["autoscale"] = leg

    # shutdown: each replica's hook stops its loop and frees its engine's KV
    # cache and graphs; the weights stay (they are the caller's)
    kv_bytes = prefill.engine._kv_cache_nbytes + decode.engine._kv_cache_nbytes
    threads = [prefill._loop.thread, decode._loop.thread]
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    serve.shutdown()
    ray_tpu_torch.shutdown()
    shutdown_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve_disagg: an engine loop outlived serve.shutdown()")
    if mem_before - mem_after < kv_bytes:
        raise AssertionError(f"serve_disagg: shutdown freed {mem_before - mem_after} B of the "
                             f"card, less than the two KV caches' {kv_bytes} B")
    res["shutdown"] = {"seconds": shutdown_s, "kv_cache_bytes": kv_bytes,
                       "allocated_freed_bytes": mem_before - mem_after}
    del prefill, decode, reps, handle, recorded, sends, hand, pools, leg
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


DATA_ROWS, DATA_BATCH, DATA_BLOCKS = 48, 16, 4


def _stage_batches() -> list:
    """The (start, stop) rows of each batch the stage is handed: the
    executor bundles whole blocks until a bundle holds >= batch_size rows
    (2 blocks of 12 here), and the stage cuts each bundle into batch_size
    rows and a remainder (16 + 8)."""
    bounds = [round(i * DATA_ROWS / DATA_BLOCKS) for i in range(DATA_BLOCKS + 1)]
    out, lo, hi = [], 0, 0
    for b in range(DATA_BLOCKS):
        hi = bounds[b + 1]
        if hi - lo >= DATA_BATCH or b == DATA_BLOCKS - 1:
            out += [(s, min(s + DATA_BATCH, hi)) for s in range(lo, hi, DATA_BATCH)]
            lo = hi
    return out


def _data_rows(seed: int = 0) -> list:
    """48 rows of printable ASCII prompts (numpy seed 0) whose ByteTokenizer
    encodings (BOS included) are 64-1536 tokens, rows 0 and 47 on one
    512-byte prefix, each with its row number and byte count carried."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1537, size=DATA_ROWS)

    def text(n):
        return rng.integers(32, 127, size=int(n)).astype(np.uint8).tobytes().decode()

    texts = [text(n - 1) for n in lens]
    shared = text(512)
    for i in (0, DATA_ROWS - 1):
        texts[i] = shared + texts[i][: int(lens[i]) - 1 - 512]
    return [{"prompt": t, "row": i, "n_bytes": len(t)} for i, t in enumerate(texts)]


def _watch_stage(stages: list, cls):
    """Wrap ``cls.__call__`` (the stage's batch call, on its actor's thread)
    to keep, after every batch, the stage (by weak reference), its engine's
    K3/K4 launches so far (eager + graph replays), its KV cache bytes and the
    card's allocated bytes; returns the undo."""
    import weakref

    import torch

    call = cls.__call__

    def watched(self, batch):
        out = call(self, batch)
        eng = self.engine
        if not stages or stages[-1]["stage"]() is not self:
            stages.append({"stage": weakref.ref(self), "batches": []})
        torch.cuda.synchronize()
        stages[-1]["batches"].append(len(out[self.config.output_column]))
        stages[-1].update(launches=_launch_marks(eng),
                          kv_bytes=eng._kv_cache_nbytes,
                          allocated_live=torch.cuda.memory_allocated(),
                          graphs_captured=sum(f.captures for f in _families(eng)),
                          capture_s=sum(sum(sum(v) for v in f.capture_s_by_key.values())
                                        for f in _families(eng)))
        return out

    cls.__call__ = watched
    return lambda: setattr(cls, "__call__", call)


def _freed_after_kill(st: dict, deadline_s: float = 30.0) -> dict:
    """After a dataset pass: wait for the killed pool's actor to drop its
    stage (weak reference dead), then read what the card freed against the
    allocated bytes after the stage's last batch."""
    import torch

    t0 = time.perf_counter()
    while st["stage"]() is not None and time.perf_counter() - t0 < deadline_s:
        time.sleep(0.01)
    needed_gc = st["stage"]() is not None
    if needed_gc:
        gc.collect()
    if st["stage"]() is not None:
        raise AssertionError("data: the killed pool's stage (and its engine) is still alive")
    torch.cuda.synchronize()
    freed = st["allocated_live"] - torch.cuda.memory_allocated()
    if freed < st["kv_bytes"]:
        raise AssertionError(f"data: killing the pool freed {freed} B of the card, less than "
                             f"the KV cache's {st['kv_bytes']} B")
    return {"freed_bytes": freed, "kv_cache_bytes": st["kv_bytes"], "needed_gc": needed_gc,
            "wait_s": time.perf_counter() - t0}


def data_phase(dev, params) -> dict:
    """Offline batch inference at LLAMA3_8B through the port's datasets:
    ``build_processor(ProcessorConfig(...))`` over ``data.from_items`` of
    48 prompts in 4 blocks, ``batch_size`` 16, the engine phase's
    EngineConfig and weights (by reference), 32 greedy outputs per row. The
    stage runs on an actor pool of one (a thread of the in-process runtime),
    its engine and graphs built there; it is handed batches of 16 and 8 rows
    (``_stage_batches``). First a direct pass (LLMEngine.generate on the same
    batches, a fresh engine of the same configuration),
    then the dataset and direct in turns (S D, cut from S D D S for the
    smoke's time; the direct engine's prefix
    cache dropped before each pass, so each does a fresh engine's work): rows/s,
    output tok/s, peak memory, the stage's construction and graph-capture
    seconds, and after each dataset pass the bytes freed once its pool was
    killed. K3/K4 launches counted over the first dataset pass (eager + graph
    replays of the stage's engine). Fails unless every dataset pass's rows come
    back in order with their columns carried and each ``generated_text`` equals
    the direct pass's text, both kernels launched, and each killed pool freed
    at least its KV cache's bytes."""
    import dataclasses

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, ProcessorConfig, SamplingParams
    from ray_tpu_torch.llm import batch as llm_batch
    from ray_tpu_torch.llm import build_processor
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    t_phase = time.perf_counter()
    cfg = EngineConfig(model="llama3-8b", **ENGINE_KW)
    tok = IdTextTokenizer(cfg.model.vocab_size)
    sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    rows = _data_rows()
    prompts = [r["prompt"] for r in rows]
    res = {"phase": "data", "model": "LLAMA3_8B (registry name llama3-8b)", "dtype": "bfloat16",
           "rows": DATA_ROWS, "blocks": DATA_BLOCKS, "batch_size": DATA_BATCH,
           "prompt_tokens": sum(len(tok.encode(p)) for p in prompts),
           "path": "from_items -> Read tasks -> map_batches(_EngineStage, concurrency=1) -> "
                   "actor pool of one (thread) -> LLMEngine.generate per batch"}

    eng = LLMEngine(dataclasses.replace(cfg, eos_token_id=tok.eos_token_id), params=params,
                    seed=0, device=dev)

    def direct():
        eng.allocator.drop_prefix_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = sum(f.captures for f in _families(eng))
        t0 = time.perf_counter()
        toks = []
        for lo, hi in _stage_batches():
            toks += eng.generate([tok.encode(p) for p in prompts[lo:hi]], sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sum(len(t) for t in toks)
        texts = [tok.decode(t[:-1] if t and t[-1] == tok.eos_token_id else t) for t in toks]
        return texts, {"path": "D", "seconds": wall, "rows_per_s": DATA_ROWS / wall,
                       "output_tok_per_s": n / wall, "output_tokens": n,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                       "graphs_captured": sum(f.captures for f in _families(eng)) - c0}

    want, first_direct = direct()
    n_out = first_direct["output_tokens"]
    res["direct_first"] = first_direct

    stages: list = []
    undo = _watch_stage(stages, llm_batch._EngineStage)
    ray_tpu_torch.init(num_cpus=4)
    pc = ProcessorConfig(engine=dataclasses.replace(cfg), tokenizer=tok, params=params,
                         sampling=sp, batch_size=DATA_BATCH, device=str(dev))

    def through_dataset(first: bool = False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if first:  # the main path: the counters zeroed just before, read after
            paged_attention_cuda.launches = 0
            ragged_attention_cuda.launches = 0
        n_stages = len(stages)
        t0 = time.perf_counter()
        ds = data.from_items(rows, parallelism=DATA_BLOCKS)
        got = build_processor(pc)(ds).take_all()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        if len(stages) != n_stages + 1:
            raise AssertionError(f"data: {len(stages) - n_stages} stages served one pass")
        st = stages[-1]
        if st["batches"] != [hi - lo for lo, hi in _stage_batches()]:
            raise AssertionError(f"data: the stage saw batches of {st['batches']} rows")
        if [r["row"] for r in got] != list(range(DATA_ROWS)) or any(
                (r["prompt"], r["n_bytes"]) != (w["prompt"], w["n_bytes"])
                for r, w in zip(got, rows)):
            raise AssertionError("data: rows came back out of order or a column was not carried")
        texts = [r["generated_text"] for r in got]
        if texts != want:
            bad = [i for i, (a, b) in enumerate(zip(texts, want)) if a != b]
            raise AssertionError(f"data: {len(bad)} rows differ from direct generate "
                                 f"(first {bad[:5]}; row {bad[0]}: {texts[bad[0]][:120]!r} "
                                 f"vs {want[bad[0]][:120]!r})")
        out = {"path": "S", "seconds": wall, "rows_per_s": DATA_ROWS / wall,
               "output_tok_per_s": n_out / wall, "output_tokens": n_out, "peak_mem_gb": peak,
               "stage_batches": st["batches"], "graphs_captured": st["graphs_captured"],
               "capture_s": st["capture_s"], "pool_kill": _freed_after_kill(st)}
        return out, {k: v for k, v in st["launches"].items()}

    try:
        first, launches = through_dataset(first=True)
        if min(launches.values()) <= 0:
            raise AssertionError(f"data: a kernel of the path never launched: {launches}")
        res["kernel_launches"] = launches
        res["dataset_first"] = first
        order = "SD"  # cut from S D D S for the smoke's time
        res["order"] = order
        passes = []
        for k in order:
            if k == "S":
                passes.append(through_dataset()[0])
            else:
                texts, d = direct()
                passes.append({**d, "texts_equal_first_direct": texts == want})
        res["passes"] = passes
    finally:
        undo()
        ray_tpu_torch.shutdown()
    for k, name in (("S", "dataset"), ("D", "direct")):
        read = [p for p in res["passes"] if p["path"] == k]
        res[name] = {m: float(sum(p[m] for p in read) / len(read))
                     for m in ("rows_per_s", "output_tok_per_s", "peak_mem_gb")}
    res["dataset_over_direct_rows_per_s"] = res["dataset"]["rows_per_s"] / res["direct"]["rows_per_s"]
    res["rows_equal_direct"] = True
    eng.release()
    del eng
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# disagg
# ---------------------------------------------------------------------------


def _record_sends(conn) -> dict:
    """Wrap a connector's ``send`` on the instance: while ``rec["keep"]`` is
    set it keeps each request's last handoff in ``rec["sent"]`` (for the
    read-back check); every send's host ms goes to ``rec["send_ms"]``."""
    rec = {"keep": False, "sent": {}, "send_ms": {}}
    send = conn.send

    def recording(target, handoff, timeout_s=30.0):
        if rec["keep"]:
            rec["sent"][handoff.request_id] = handoff
        t0 = time.perf_counter()
        try:
            return send(target, handoff, timeout_s)
        finally:
            rec["send_ms"][handoff.request_id] = (time.perf_counter() - t0) * 1e3

    conn.send = recording
    return rec


def _corrupt_once(request_id: str, device: bool = False):
    """Install a chaos schedule that corrupts the handoff of ``request_id``
    once in flight (site ``disagg.kv_transfer``, not re-sealed): at a host
    connector's gate (CORRUPT_KV_TRANSFER, the pages bit-flipped), or, with
    ``device``, in the fabric transport (CORRUPT_DEVICE_TRANSFER, flipped on
    the card). The caller uninstalls it."""
    from ray_tpu_torch import chaos
    from ray_tpu_torch.chaos.schedule import CORRUPT_DEVICE_TRANSFER

    if device:
        kind, match = CORRUPT_DEVICE_TRANSFER, {"bundle_id": request_id}
    else:
        kind, match = chaos.CORRUPT_KV_TRANSFER, {"request_id": request_id}
    return chaos.install(chaos.FaultSchedule(0, [chaos.FaultSpec(
        kind, site="disagg.kv_transfer", match=match, max_fires=1)]))


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


def _sent(orch) -> int:
    return sum(c.num_sent for c in orch.connectors.values())


def _xfer_samples(orch) -> int:
    """``llm_kv_transfer_seconds`` samples of this orchestrator, every plane."""
    from ray_tpu_torch.obs import slo

    data = slo.kv_transfer_histogram().hist_data()
    return sum(data.get((orch.model_tag, b), ([], 0.0, 0))[2] for b in orch.connectors)


def _pinned_stats() -> dict:
    import torch

    st = torch.cuda.host_memory_stats()
    return {k: v for k, v in st.items() if k.startswith(("allocations.", "allocated_bytes."))
            or k in ("num_host_alloc", "num_host_free")}


# host-clock stages of a handoff (the others are device times between events)
HOST_STAGES = ("pin_ms", "seal_ms", "verify_ms")
HANDOFF_STAGES = ("pin_ms", "gather_ms", "d2h_ms", "seal_ms", "verify_ms", "h2d_ms",
                  "scatter_ms")


def _disagg_pass(orch, prompts, sps, tag: str, gated: bool = False) -> dict:
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

    from ray_tpu_torch import obs
    from ray_tpu_torch.obs import slo

    n = len(prompts)
    pe, de = orch._prefill[0], orch._decode[0]
    hand0 = len(orch.handoffs)
    xfer0 = _xfer_samples(orch)
    traces = {}
    sent0 = _sent(orch)
    caps0 = {r: (sum(f.captures for f in _families(p.engine)),
                 sum(f.capture_s for f in _families(p.engine)))
             for r, p in (("prefill", pe), ("decode", de))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pinned0 = _pinned_stats()
    holds = (_hold(pe), _hold(de)) if gated else None
    t0 = time.perf_counter()
    t_submit = {}

    def submit(i):
        rid = f"{tag}{i}"
        traces[rid] = obs.new_context()
        t_submit[rid] = time.perf_counter()
        return orch.submit_future(prompts[i], sps[i], request_id=rid, sink=Sink(rid),
                                  trace=traces[rid])

    first, last, finals = {}, {}, {}
    try:
        futs = [submit(i) for i in range(n if gated else n - 1)]
        if gated:
            holds[0].set()
            deadline = time.time() + 300
            while _sent(orch) - sent0 < n:
                if time.time() > deadline:
                    raise AssertionError(f"disagg: {_sent(orch) - sent0} of {n} handoffs sent")
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
    pinned = _pinned_stats()
    hand = list(orch.handoffs)[hand0:]
    # one llm_kv_transfer_seconds sample per imported handoff
    n_xfer = _xfer_samples(orch) - xfer0
    if n_xfer != len(hand):
        raise AssertionError(f"disagg: {n_xfer} kv-transfer samples for {len(hand)} handoffs")
    stages = HANDOFF_STAGES
    backends = {}
    for h in hand:
        backends[h["backend"]] = backends.get(h["backend"], 0) + 1
    graphs = {}
    for r, p in (("prefill", pe), ("decode", de)):
        c0, s0 = caps0[r]
        graphs[r] = {"captured": sum(f.captures for f in _families(p.engine)) - c0,
                     "capture_s": sum(f.capture_s for f in _families(p.engine)) - s0}
    return {
        "finals": finals, "traces": {rid: c.trace_id for rid, c in traces.items()},
        "kv_transfer_samples": n_xfer,
        "wall_s": wall, "output_tok_per_s": sum(map(len, finals.values())) / wall,
        "mean_ttft_s": sum(first[r] - t_submit[r] for r in finals) / n,
        "mean_tpot_s": sum((last[r] - first[r]) / max(1, len(finals[r]) - 1)
                           for r in finals) / n,
        "handoffs": len(hand), "bytes_handed_off": sum(h["bytes"] for h in hand),
        "handoff_backends": backends,
        "handoff_host_ms": sum(h.get(s, 0.0) for h in hand for s in HOST_STAGES),
        "handoff_stage_ms_total": {s: sum(h.get(s, 0.0) for h in hand) for s in stages},
        "pinned_delta": {k: pinned.get(k, 0) - pinned0.get(k, 0) for k in pinned},
        # device-edge handoffs that went through host memory (pinned pages,
        # a copy either way): 0 on the device path
        "staged_device_handoffs": sum(h["backend"] == "device" and any(
            k in h for k in ("pin_ms", "d2h_ms", "h2d_ms")) for h in hand),
        "handoff_ms": {s: {"mean": sum(h[s] for h in hand) / len(hand),
                           "min": min(h[s] for h in hand), "max": max(h[s] for h in hand)}
                       for s in stages if all(s in h for h in hand)} if hand else {},
        "largest_handoff_ms": {s: v for s, v in max(hand, key=lambda h: h["bytes"]).items()
                               if s in stages} if hand else {},
        "graphs": graphs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }


def _readback(eng, sent: dict, out: dict):
    """On the decode loop, before the first step after the imports: every
    imported request's K/V in the live cache equals its handoff's pages
    (host or device), bit for bit."""
    import torch

    def check():
        same = 0
        for rid, h in sent.items():
            req = eng.requests[rid]
            slots = torch.as_tensor(req.seq.slots_for_range(0, h.num_kv_tokens),
                                    device=eng.device)
            same += all(torch.equal(eng.cache[n].index_select(2, slots).to(p.device), p)
                        for n, p in (("k", h.k_pages), ("v", h.v_pages)))
        out["requests"], out["bits_equal"] = len(sent), same

    return check


def _check_first_pass(orch, first: dict, launches: dict, model, what: str) -> dict:
    """The first pass's checks, on either leg: 12 handoffs, no re-prefill,
    no prefill on the decode engine, every mixed step a replay, the paged
    kernel in decode replays, each kernel in its own pool, the spans."""
    from ray_tpu_torch import obs

    finals = first.pop("finals")
    first["traces"] = _check_traces(obs.get_recorder(), first.pop("traces"), f"{what} first pass",
                                    need=TRACE_NEED | {"llm.kv_transfer"},
                                    one_of={"engine.decode_chunk"})
    st = orch.stats()
    pre_st, dec_st = st["prefill"][0], st["decode"][0]
    _check_served(orch._decode[0].engine, finals, model, 12, 32)
    if st["transfer"]["kv_transfers"] != 12 or st["transfer"]["reprefills"] != 0:
        raise AssertionError(f"{what}: {st['transfer']}")
    if dec_st["num_prefill_batches"] != 0 or dec_st.get("mixed", {}).get("dispatches", 0):
        raise AssertionError(f"{what}: the decode engine ran a prefill or a mixed step")
    _check_packed_replays(pre_st["mixed"]["graphs"], pre_st["mixed"]["dispatches"],
                          f"{what} prefill engine: mixed steps")
    graphs = dec_st["pipeline"]["graphs"]
    if graphs["replays"] <= 0 or launches["decode"]["paged_attention"]["in_replays"] <= 0:
        raise AssertionError(f"{what}: no decode chunk replay with the paged kernel: {graphs}")
    if launches["decode"]["ragged_attention"]["device"] or \
            launches["prefill"]["paged_attention"]["device"]:
        raise AssertionError(f"{what}: a kernel ran in the wrong pool: {launches}")
    return finals


def _first_pass(orch, prompts, sps, tag: str, what: str) -> tuple:
    """The leg's first pass with the kernels' counters zeroed just before it
    and read just after: (pass result, launches per engine, totals)."""
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    pe, de = orch._prefill[0], orch._decode[0]
    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    marks = {p.role: _pool_marks(p) for p in (pe, de)}
    first = _disagg_pass(orch, prompts, sps, tag)
    launches = {p.role: _pool_launches(marks[p.role], _pool_marks(p)) for p in (pe, de)}
    total = {"paged_attention": paged_attention_cuda.launches,
             "ragged_attention": ragged_attention_cuda.launches}
    tallied = {n: sum(launches[r][n]["eager"] for r in launches) for n in total}
    # every wrapper launch of the pass is booked to one engine's thread
    captured = {n: sum(_pool_marks(p)[n]["captured"] - marks[p.role][n]["captured"]
                       for p in (pe, de)) for n in total}
    if {n: tallied[n] + captured[n] for n in total} != total:
        raise AssertionError(f"{what}: per-thread launch tallies {tallied} + captured "
                             f"{captured} != the wrappers' counts {total}")
    return first, launches, total


def _weights_shared(orch, params) -> None:
    import torch

    flat = [(k, v) for k, v in params.items() if torch.is_tensor(v)]
    flat += [(f"{k}.{n}", t) for k, v in params.items() if not torch.is_tensor(v)
             for n, t in v.items()]
    for p in orch._prefill + orch._decode:
        got = p.engine.params
        for name, t in flat:
            a = got[name] if "." not in name else got[name.split(".")[0]][name.split(".")[1]]
            if a.data_ptr() != t.data_ptr():
                raise AssertionError(f"disagg: {p.role} engine holds a copy of {name}")


def _leg_summary(passes: list) -> dict:
    """Per gated pass of one leg: tok/s, TTFT, TPOT, the handoffs' host ms and
    stage ms, peak memory and the pinned allocator's movement."""
    keys = ("output_tok_per_s", "mean_ttft_s", "mean_tpot_s", "wall_s", "handoff_host_ms",
            "peak_mem_gb")
    out = {k: [p[k] for p in passes] for k in keys}
    out["handoff_ms"] = [p["handoff_ms"] for p in passes]
    out["pinned_delta"] = [p["pinned_delta"] for p in passes]
    out["handoff_backends"] = [p["handoff_backends"] for p in passes]
    out["graphs_captured"] = [sum(g["captured"] for g in p["graphs"].values()) for p in passes]
    return out


def disagg_phase(dev, params, engine_res: dict) -> dict:
    """LLAMA3_8B disaggregated, two legs on the same weights and the engine
    phase's 12 requests, each one DisaggOrchestrator with one prefill and
    one decode engine (ENGINE_KW, each on its own loop thread):

     * inproc: the in-process connector (pinned host pages, CRC both ways);
       a first pass (both engines capture while the other works) and one
       more ungated pass;
     * device: the fabric (connector="device"): pages exported as device
       tensors sealed on the card, handed over by reference to the decode
       engine's cache device, verified on the card and scattered in place;
       a first pass with the kernels' counters zeroed just before it.

    Then gated passes (one batch shape, so the same bf16 bits) in turns,
    inproc, device, inproc, device, device, inproc: the device streams equal
    the inproc ones, K3/K4 launches per engine equal the inproc leg's in
    capture-free passes, no device handoff goes through host memory, and
    the imports are read back from the live caches. Then a gated pass on
    each leg with one handoff corrupted in flight: inproc re-prefills it;
    device degrades the edge to RPC (``to_host()``, pickled over loopback
    TCP, CRC'd) and re-prefills it once. Then two completions through
    LLMServer(disagg=DisaggConfig(connector="device"))."""
    import asyncio
    import gc

    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer
    from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator
    from ray_tpu_torch.models.llama import LLAMA3_8B

    t_phase = time.perf_counter()
    model = LLAMA3_8B
    prompts, sps = _engine_traffic(model)
    cfg = EngineConfig(model=model, **ENGINE_KW)
    res = {"phase": "disagg", "model": "LLAMA3_8B", "dtype": "bfloat16",
           "layers": model.n_layers, "d_model": model.d_model, "requests": 12,
           "prompt_tokens": int(sum(map(len, prompts))), "output_tokens": 12 * 32}
    orchs, recs, windows, hooks = {}, {}, {}, {}
    try:
        for leg in ("inproc", "device"):
            t0 = time.perf_counter()
            o = orchs[leg] = DisaggOrchestrator(
                DisaggConfig(engine=cfg, num_prefill=1, num_decode=1, connector=leg),
                params=params, model_tag=f"chip-disagg-{leg}", device=dev)
            res[f"init_s_{leg}"] = time.perf_counter() - t0
            _weights_shared(o, params)
            recs[leg] = _record_sends(o.connector)
            windows[leg] = {"prefill": [], "decode": []}
            hooks[leg] = {"prefill": {}, "decode": {}}
            for p in o._prefill + o._decode:
                _watch_steps(p.engine, windows[leg][p.role], hooks[leg][p.role])
        res["weights_shared"] = True
        recs["rpc"] = _record_sends(orchs["device"].connectors["rpc"])
        cache_ptrs = {leg: {n: t.data_ptr() for n, t in o._decode[0].engine.cache.items()}
                      for leg, o in orchs.items()}
        if orchs["device"]._decode[0].engine.kv_cache_device() != dev:
            raise AssertionError("disagg: the device endpoint is not the decode cache's device")

        # each leg's first pass (the counters zeroed just before, read after)
        first_tokens = engine_res["first_pass_tokens"]
        finals = {}
        for leg, tag in (("inproc", "d"), ("device", "e")):
            first, launches, total = _first_pass(orchs[leg], prompts, sps, tag, f"disagg {leg}")
            finals[leg] = _check_first_pass(orchs[leg], first, launches, model, f"disagg {leg}")
            overlap = _capture_overlap(windows[leg])
            if not any(v["capturing_steps"] for v in overlap.values()):
                raise AssertionError(f"disagg {leg}: no capture overlapped the other engine's "
                                     f"work: {overlap}")
            res[f"first_{leg}"] = {
                **first, "kernel_launches": launches, "capture_overlap": overlap,
                "greedy_streams_equal_engine_phase": sum(
                    finals[leg][f"{tag}{i}"] == first_tokens[f"r{i}"] for i in range(10))}
            res[f"kernel_launches_{leg}"] = {n: sum(launches[r][n]["device"] for r in launches)
                                             for n in total}
        if res["first_device"]["handoff_backends"] != {"device": 12} or \
                res["first_device"]["staged_device_handoffs"]:
            raise AssertionError(f"disagg device: handoffs {res['first_device']}")

        # one more ungated inproc pass (not a steady reading: the decode
        # engine meets new buckets in every ungated pass)
        for p in orchs["inproc"]._prefill + orchs["inproc"]._decode:
            p.call(p.engine.allocator.drop_prefix_cache)
        r = _disagg_pass(orchs["inproc"], prompts, sps, "s")
        f = r.pop("finals")
        r.pop("traces")
        r["greedy_streams_equal_first_pass"] = sum(f[f"s{i}"] == finals["inproc"][f"d{i}"]
                                                   for i in range(10))
        res["ungated_inproc"] = r

        # gated passes in turns: the first of each leg captures the 12-row
        # batch's graphs; the second reads its imports back from the cache
        gated = {"inproc": [], "device": []}
        reuse = {}

        def gated_pass(leg):
            o = orchs[leg]
            pe, de = o._prefill[0], o._decode[0]
            for p in (pe, de):
                p.call(p.engine.allocator.drop_prefix_cache)
            k = len(gated[leg])
            if k == 1:
                back = {}
                fams = _families(de.engine)
                reuse[leg] = (fams, [set(f._graphs) for f in fams],
                              [dict(f.replays_by_key) for f in fams], back)
                recs[leg]["keep"], recs[leg]["sent"] = True, {}
                hooks[leg]["decode"]["before_step"] = _readback(de.engine, recs[leg]["sent"], back)
            marks = {p.role: _pool_marks(p) for p in (pe, de)}
            g = _disagg_pass(o, prompts, sps, "g", gated=True)
            g["kernel_launches"] = {p.role: _pool_launches(marks[p.role], _pool_marks(p))
                                    for p in (pe, de)}
            g.pop("traces")
            recs[leg]["keep"], recs[leg]["sent"] = False, {}
            gated[leg].append(g)

        def capture_free() -> list:
            return [j for j in range(len(gated["device"]))
                    if not any(sum(c["captured"] for c in gated[leg][j]["graphs"].values())
                               for leg in gated)]

        for leg in ("inproc", "device", "inproc", "device", "device", "inproc"):
            gated_pass(leg)
        # a pass whose chunk controller steps to a new chunk length captures
        # its graph (host timing decides): until a pair is capture-free on
        # both legs, up to three more pairs in turns
        for order in (("inproc", "device"), ("device", "inproc"), ("inproc", "device")):
            if capture_free():
                break
            for leg in order:
                gated_pass(leg)
        summary = {}
        for leg in ("inproc", "device"):
            fams, keys0, replays0, back = reuse[leg]
            reused = sum(f.replays_by_key[key] - r0.get(key, 0)
                         for f, keys, r0 in zip(fams, keys0, replays0) for key in keys)
            same_ptrs = {n: t.data_ptr() for n, t in
                         orchs[leg]._decode[0].engine.cache.items()} == cache_ptrs[leg]
            g = gated[leg]
            equal = sum(g[1]["finals"][f"g{i}"] == g[2]["finals"][f"g{i}"] for i in range(12))
            summary[leg] = {"readback": back, "replays_of_graphs_captured_before": reused,
                            "cache_tensors_unchanged": same_ptrs,
                            "streams_equal_within_leg": f"{equal}/12", **_leg_summary(g)}
            if back.get("bits_equal") != 12 or back.get("requests") != 12:
                raise AssertionError(f"disagg {leg}: imported K/V read back: {back}")
            if not same_ptrs or reused <= 0 or equal != 12:
                raise AssertionError(f"disagg {leg}: imports after capture: {summary[leg]}")
        # the device leg against the inproc leg, pass for pass
        dev_equal = [sum(d["finals"][f"g{i}"] == p["finals"][f"g{i}"] for i in range(12))
                     for d, p in zip(gated["device"], gated["inproc"])]
        free = capture_free()
        launches_equal = [gated["device"][j]["kernel_launches"]
                          == gated["inproc"][j]["kernel_launches"] for j in free]
        staged = [g["staged_device_handoffs"] for g in gated["device"]]
        summary["device_vs_inproc"] = {
            "streams_equal": [f"{e}/12" for e in dev_equal],
            "capture_free_pairs": free, "kernel_launches_equal": launches_equal,
            "kernel_launches": {leg: gated[leg][free[-1]]["kernel_launches"] if free else None
                                for leg in gated},
            "staged_device_handoffs": staged}
        res["gated"] = summary
        if any(e != 12 for e in dev_equal) or not free or not all(launches_equal) or \
                any(staged) or \
                any(b != {"device": 12} for b in summary["device"]["handoff_backends"]):
            raise AssertionError(f"disagg: device leg against inproc: {summary['device_vs_inproc']}")

        # a handoff corrupted in flight on each leg: re-prefilled once; the
        # 11 others keep their batch shapes (the corrupted request is the
        # last exported, and not the one that sets the block-table width)
        victim = "g11"
        from ray_tpu_torch import chaos

        res["corrupted"] = {}
        for leg in ("inproc", "device"):
            o = orchs[leg]
            for p in o._prefill + o._decode:
                p.call(p.engine.allocator.drop_prefix_cache)
            n_re, n_fail = o.num_reprefills, o.num_transfer_failures
            hand0 = len(o.handoffs)
            sched = _corrupt_once(victim, device=leg == "device")
            try:
                bad = _disagg_pass(o, prompts, sps, "g", gated=True)
            finally:
                chaos.uninstall()
            bad.pop("traces")
            clean = gated[leg][-1]["finals"]
            others = sum(bad["finals"][f"g{i}"] == clean[f"g{i}"] for i in range(11))
            c = res["corrupted"][leg] = {
                "request": victim, "corrupted_sends": len(sched.log),
                "via": sched.log[0].kind if sched.log else None,
                "reprefills": o.num_reprefills - n_re,
                "transfer_failures": o.num_transfer_failures - n_fail,
                "tokens": len(bad["finals"][victim]),
                "first_token_equal_clean": bad["finals"][victim][:1] == clean[victim][:1],
                "stream_equal_clean": bad["finals"][victim] == clean[victim],
                "other_streams_equal_clean": f"{others}/11",
                "handoff_backends": bad["handoff_backends"], "tok_per_s": bad["output_tok_per_s"],
            }
            if (c["corrupted_sends"], c["reprefills"], c["transfer_failures"], c["tokens"]) != \
                    (1, 1, 1, 32) or not c["first_token_equal_clean"] or others != 11:
                raise AssertionError(f"disagg {leg}: corrupted handoff: {c}")
            if leg == "device":
                st = o.stats()
                rpc = [h for h in list(o.handoffs)[hand0:] if h["backend"] == "rpc"]
                c["fabric"] = {k: v for k, v in st["fabric"].items() if k != "topology"}
                c["rpc_handoff"] = {**{s: rpc[0][s] for s in HANDOFF_STAGES if s in rpc[0]},
                                    "bytes": rpc[0]["bytes"],
                                    "send_ms": recs["rpc"]["send_ms"].get(victim)} if rpc else None
                if st["fabric"]["fallbacks"] != 1 or len(rpc) != 1 or \
                        bad["handoff_backends"] != {"device": 11, "rpc": 1} or \
                        st["fabric"]["edges"][0]["backend"] != "rpc":
                    raise AssertionError(f"disagg device: the fallback to RPC: {c}")
        for leg, o in orchs.items():
            st = o.stats()
            res[f"graphs_{leg}"] = {
                p.role: {"captured": sum(f.captures for f in _families(p.engine)),
                         "capture_s": sum(f.capture_s for f in _families(p.engine)),
                         "replays": sum(f.replays for f in _families(p.engine))}
                for p in o._prefill + o._decode}
            res[f"transfer_{leg}"] = st["transfer"]
            _check_packed_replays(st["prefill"][0]["mixed"]["graphs"],
                                  st["prefill"][0]["mixed"]["dispatches"],
                                  f"disagg {leg} prefill engine: mixed steps, every pass")
    finally:
        for o in orchs.values():
            o.shutdown()
    del orchs
    gc.collect()
    torch.cuda.empty_cache()

    # two completions through the OpenAI front end, over the device fabric
    bodies, _chats, _streams = _api_traffic()
    acfg = EngineConfig(model="llama3-8b", **ENGINE_KW)
    server = LLMServer(LLMConfig(model_id="llama3-8b", engine=acfg, params=params,
                                 tokenizer=IdTextTokenizer(acfg.model.vocab_size),
                                 device=str(dev), disagg={"num_prefill": 1, "num_decode": 1,
                                                          "connector": "device"}))
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
                  "fabric_backends": stats.get("fabric", {}).get("backends"),
                  "decode_prefill_batches": stats["decode"][0]["num_prefill_batches"]}
    if stats.get("mode") != "disagg" or stats["transfer"]["kv_transfers"] != 2 or \
            res["api"]["fabric_backends"] != {"device": 2} or \
            any(not (0 < n <= 32) for n in n_out):
        raise AssertionError(f"disagg: LLMServer(disagg=): {res['api']}")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    res["kernel_launches"] = res["kernel_launches_inproc"]
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# kvtier
# ---------------------------------------------------------------------------


KVTIER_BLOCKS = 640
KVTIER_HOST_BYTES = 3 << 30


def _kvtier_traffic(model):
    """Returning multi-turn chat (numpy seed 0): 8 histories of 1 024
    tokens, 8 new turns of 64, and 10 distinct 1 088-token fillers."""
    import numpy as np

    rng = np.random.default_rng(0)
    hists = [rng.integers(3, model.vocab_size, size=1024).tolist() for _ in range(8)]
    turns = [rng.integers(3, model.vocab_size, size=64).tolist() for _ in range(8)]
    fillers = [rng.integers(3, model.vocab_size, size=1088).tolist() for _ in range(10)]
    return hists, turns, fillers


def _serve_all(eng, prompts, sp, tag, prefetch_wait: bool = False) -> dict:
    """Every request added at once, stepped to completion: finals, wall,
    tok/s and mean TTFT (first token booked - arrival). With
    ``prefetch_wait`` the first step waits until the prefetch worker has
    processed every request (what a queue wait gives it)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = {}
    for i, p in enumerate(prompts):
        rid = eng.add_request(p, sp, request_id=f"{tag}{i}")
        reqs[rid] = eng.requests[rid]
    waited = 0.0
    if prefetch_wait:
        if not eng.kvfetch.wait_idle(60.0):
            raise AssertionError("kvtier: the prefetch worker did not finish in 60 s")
        waited = time.perf_counter() - t0
    finals = {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = list(out.output_token_ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"finals": finals, "wall_s": wall,
           "output_tok_per_s": sum(map(len, finals.values())) / wall,
           "mean_ttft_s": float(np.mean([r.t_first_token - r.arrival for r in reqs.values()]))}
    if prefetch_wait:
        out["prefetch_wait_s"] = waited
        out["mean_ttft_after_wait_s"] = out["mean_ttft_s"] - waited
    return out


def _kvtier_round(eng, traffic, tag: str, prefetch_wait: bool = False) -> dict:
    """Pass A, the fillers, pass B on one engine (tiered or not); with
    ``prefetch_wait`` pass B's requests wait for the prefetch worker."""
    import torch

    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.kv_cache import BlockAllocator

    hists, turns, fillers = traffic
    bs = eng.config.block_size
    greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    torch.cuda.reset_peak_memory_stats()
    a = _serve_all(eng, hists, greedy, f"{tag}a")
    for i, f in enumerate(fillers):  # one at a time: traffic spread over time
        _serve_all(eng, [f], SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True),
                   f"{tag}f{i}")
    convs = [hists[i] + a["finals"][f"{tag}a{i}"] + turns[i] for i in range(8)]
    res = {"pass_a": {k: v for k, v in a.items() if k != "finals"}}
    if eng.kvtier is not None:
        if not eng.kvtier.flush_spills(60.0):
            raise AssertionError("kvtier: the spill queue did not drain in 60 s")
        # the conversation blocks pass A sealed (history and reply)
        n_full = [(len(hists[i]) + 32) // bs for i in range(8)]
        in_hbm = in_host = total = 0
        for i, c in enumerate(convs):
            h = 0
            for j in range(n_full[i]):
                h = BlockAllocator.chain_hash(h, tuple(c[j * bs:(j + 1) * bs]))
                in_hbm += eng.allocator.contains_hash(h)
                in_host += eng.kvtier.peek(h) == "host"
                total += 1
        # what admission must resurrect: each conversation's contiguous
        # host-tier prefix (a spill dropped from the bounded queue ends it),
        # short of the last prompt token
        limit = [(len(c) - 1) // bs * bs for c in convs]
        advertised = sum(min(eng.peek_prefix_tiered(c)["by_tier"].get("host", 0), lim)
                         for c, lim in zip(convs, limit))
        res["before_pass_b"] = {"conversation_blocks": total, "in_hbm": in_hbm,
                                "in_host": in_host, "host_share": in_host / total,
                                "resurrectable_tokens": advertised}
        if in_hbm or in_host < 0.9 * total:
            raise AssertionError(f"kvtier: before pass B {res['before_pass_b']}")
    marks, replayed = _launch_marks(eng), _replayed_marks(eng)
    t_before = eng.kvtier.timings() if eng.kvtier is not None else None
    hits_before = dict(eng.stats()["prefix_cache"]["by_tier"])
    b = _serve_all(eng, convs, greedy, f"{tag}b", prefetch_wait=prefetch_wait)
    launches = _launch_counts(eng, marks)
    in_replays = {n: v - replayed[n] for n, v in _replayed_marks(eng).items()}
    res["pass_b"] = {k: v for k, v in b.items() if k != "finals"}
    res["pass_b"]["kernel_launches"] = launches
    res["pass_b"]["kernel_launches_in_replays"] = in_replays
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["finals"] = b["finals"]
    st = eng.stats()
    res["pass_b"]["hit_tokens_by_tier"] = {t: n - hits_before.get(t, 0)
                                           for t, n in st["prefix_cache"]["by_tier"].items()}
    if eng.kvtier is not None:
        torch.cuda.synchronize()
        kt = eng.kvtier.stats()
        res["kv_tiers"] = {k: kt[k] for k in ("host", "spilled_bytes_total", "resurrected_tokens",
                                              "corrupt_dropped", "spills_dropped",
                                              "evicted_blocks", "spill_queue", "slab")}
        res["kv_tiers"]["prefetch"] = st["kv_tiers"]["fetch"]["prefetch"]
        res["timings_ms_per_block"] = {s: v["ms_per_block"] for s, v in kt["timings"].items()}
        res["timings_blocks"] = {s: v["blocks"] for s, v in kt["timings"].items()}
        res["timings_pass_b_blocks"] = {s: kt["timings"][s]["blocks"] - t_before[s]["blocks"]
                                        for s in ("verify", "h2d", "scatter")}
        want = res["before_pass_b"]["resurrectable_tokens"]
        got = res["pass_b"]["hit_tokens_by_tier"].get("host", 0)
        if kt["corrupt_dropped"] != {"host": 0, "object": 0} or got != want:
            raise AssertionError(f"kvtier: pass B resurrected {got} host tokens of {want}, "
                                 f"corrupt {kt['corrupt_dropped']}")
        if min(in_replays.values()) <= 0:
            raise AssertionError(f"kvtier: no K3/K4 launch in pass B's replays: {in_replays}")
    return res


def kvtier_phase(dev, params) -> dict:
    """LLAMA3_8B with the tiered KV cache against recompute: two rounds of
    pass A, fillers, pass B, in turns (tier, recompute, tier, recompute)."""
    import gc

    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.llm.kvtier import KVTierConfig
    from ray_tpu_torch.models.llama import LLAMA3_8B

    t_phase = time.perf_counter()
    model = LLAMA3_8B
    traffic = _kvtier_traffic(model)
    kw = {**ENGINE_KW, "num_blocks": KVTIER_BLOCKS}
    kvt = KVTierConfig(host_bytes=KVTIER_HOST_BYTES, object_bytes=0)
    t0 = time.perf_counter()
    tiered = LLMEngine(EngineConfig(model=model, kvtier=kvt, **kw), params=params, device=dev)
    init_s = time.perf_counter() - t0
    plain = LLMEngine(EngineConfig(model=model, **kw), params=params, device=dev)
    res = {"phase": "kvtier", "model": "LLAMA3_8B", "dtype": "bfloat16",
           "num_blocks": KVTIER_BLOCKS, "host_bytes": KVTIER_HOST_BYTES,
           "block_bytes": tiered.kvtier.block_nbytes, "tiered_init_s": init_s,
           "slab": tiered.kvtier.stats()["slab"]}
    try:
        rounds = []
        for k in range(2):
            if k:
                for eng in (tiered, plain):
                    eng.allocator.drop_prefix_cache()  # every tier too
            rnd = {"tier": _kvtier_round(tiered, traffic, f"t{k}"),
                   "recompute": _kvtier_round(plain, traffic, f"r{k}")}
            ft, fr = rnd["tier"].pop("finals"), rnd["recompute"].pop("finals")
            rnd["pass_b_streams_equal_recompute"] = \
                f"{sum(ft[f't{k}b{i}'] == fr[f'r{k}b{i}'] for i in range(8))}/8"
            rnd["pass_b_tokens_equal_recompute"] = \
                f"{sum(a == b for i in range(8) for a, b in zip(ft[f't{k}b{i}'], fr[f'r{k}b{i}']))}/256"
            for i in range(8):
                toks = ft[f"t{k}b{i}"]
                if len(toks) != 32 or not all(0 <= t < model.vocab_size for t in toks):
                    raise AssertionError(f"kvtier: request {i}: {len(toks)} tokens")
            rounds.append(rnd)
        res["rounds"] = rounds
        # the prefetch's best case: pass B's requests wait in the queue
        # until the worker has verified (and the tick scattered) their
        # prefixes; graphs captured
        tiered.allocator.drop_prefix_cache()
        pre = _kvtier_round(tiered, traffic, "p", prefetch_wait=True)
        pre.pop("finals")
        res["prefetched"] = pre
        res["kernel_launches"] = rounds[0]["tier"]["pass_b"]["kernel_launches"]
        res["kernel_launches_in_replays"] = rounds[0]["tier"]["pass_b"][
            "kernel_launches_in_replays"]
        try:
            res["host_memory_stats"] = {k: v for k, v in torch.cuda.host_memory_stats().items()
                                        if "bytes" in k and ("peak" in k or "current" in k)}
        except Exception as e:  # noqa: BLE001 — reported, not needed
            res["host_memory_stats"] = repr(e)
    finally:
        tiered.close()
    del tiered, plain
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
    result["kvtier"] = _parity_kvtier(dev, model, params_cpu, params_gpu)
    emit(result)


def _parity_kvtier(dev, model, params_cpu, params_gpu) -> dict:
    """fp32, the parity model, the tiered cache on a 32-block cache: a
    prefix served, pushed out of HBM into the host tier, then resurrected.
    The resurrected request's tokens equal a cold prefill's on the card, and
    the CPU engine's; on the card the cache tensors stay in place and decode
    graphs captured before the resurrection replay over its pages."""
    import numpy as np

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams

    rng = np.random.default_rng(13)
    shared = rng.integers(3, model.vocab_size, size=96).tolist()
    warm = shared + rng.integers(3, model.vocab_size, size=16).tolist()
    probe = shared + rng.integers(3, model.vocab_size, size=16).tolist()
    fillers = [rng.integers(3, model.vocab_size, size=160).tolist() for _ in range(4)]
    sp = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    kw = dict(model=model, num_blocks=32, block_size=16, max_num_seqs=4, max_prefill_len=256,
              mixed_batch=True, mixed_prefill_chunk=64, decode_chunk=8)
    res = {}
    for where, params, device in (("cuda", params_gpu, dev), ("cpu", params_cpu, "cpu")):
        eng = LLMEngine(EngineConfig(kvtier={"object_bytes": 0}, **kw), params=params,
                        device=device)
        # chunks held at 8: a step-up on host timing would give the
        # resurrected request's decode a chunk length no earlier request used
        _pin_chunks(eng)
        try:
            eng.generate([warm], sp)
            for f in fillers:
                eng.generate([f], sp)
            if not eng.kvtier.flush_spills(60.0):
                raise AssertionError("parity kvtier: the spill queue did not drain in 60 s")
            peek = eng.peek_prefix_tiered(probe)
            out = {"peek_before": peek}
            if device != "cpu":
                fams = _families(eng)
                keys0 = [set(f._graphs) for f in fams]
                replays0 = [dict(f.replays_by_key) for f in fams]
                ptrs = {n: t.data_ptr() for n, t in eng.cache.items()}
            rid = eng.add_request(probe, sp, request_id="resurrected")
            cached, toks = None, None
            while eng.has_unfinished():
                for o in eng.step():
                    if o.finished and o.request_id == rid:
                        cached, toks = o.num_cached_tokens, list(o.output_token_ids)
            st = eng.stats()
            out.update({"num_cached_tokens": cached,
                        "by_tier": st["prefix_cache"]["by_tier"],
                        "resurrected_tokens": st["kv_tiers"]["resurrected_tokens"],
                        "corrupt_dropped": st["kv_tiers"]["corrupt_dropped"], "tokens": toks})
            if device != "cpu":
                out["replays_of_graphs_captured_before"] = sum(
                    f.replays_by_key[k] - r0.get(k, 0)
                    for f, keys, r0 in zip(fams, keys0, replays0) for k in keys)
                out["cache_tensors_unchanged"] = \
                    {n: t.data_ptr() for n, t in eng.cache.items()} == ptrs
        finally:
            eng.close()
        cold = LLMEngine(EngineConfig(**kw), params=params, device=device)
        out["cold_tokens_equal"] = cold.generate([probe], sp)[0] == toks
        res[where] = out
    c = res["cuda"]
    ok = (c["cold_tokens_equal"] and res["cpu"]["cold_tokens_equal"]
          and c["tokens"] == res["cpu"]["tokens"]
          and c["peek_before"]["by_tier"].get("host", 0) >= 96 and c["num_cached_tokens"] >= 96
          and c["resurrected_tokens"]["host"] >= 96 and c["replays_of_graphs_captured_before"] > 0
          and c["cache_tensors_unchanged"])
    if not ok:
        raise AssertionError(f"parity kvtier: {res}")
    for r in res.values():
        r.pop("tokens")
    return res


def _parity_disagg(dev, model, params_cpu, params_gpu, prompts, sp, mixed, colocated) -> dict:
    """fp32, the parity model, disaggregated (one prefill and one decode
    engine), over the in-process connector and over the device fabric:
    greedy tokens on the card and on the CPU equal the colocated engine's;
    two seeded requests equal the colocated engine's streams of the same
    request ids, on each device; on the card, a handoff corrupted in flight
    is re-prefilled once and its tokens equal the clean run's (on the device
    leg the corrupt device transfer degrades the edge to RPC)."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator

    cfg = dict(model=model, num_blocks=256, block_size=16, max_num_seqs=8, max_prefill_len=256,
               mixed_batch=mixed, mixed_prefill_chunk=64, decode_chunk=8)
    seeded = [SamplingParams(max_tokens=16, temperature=0.9, top_k=40, top_p=0.9, seed=7 + i,
                             ignore_eos=True) for i in range(2)]
    res = {}

    def run(params, device, connector):
        orch = DisaggOrchestrator(DisaggConfig(engine=EngineConfig(**cfg), connector=connector),
                                  params=params, device=device, model_tag="parity-disagg")
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

    want = {}
    for connector in ("inproc", "device"):
        for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            device = dev if where == "cuda" else "cpu"
            greedy, outs, st = run(params, device, connector)
            if where not in want:
                eng = LLMEngine(EngineConfig(**cfg), params=params, device=device)
                for i in range(2):
                    eng.add_request(prompts[i], seeded[i], request_id=f"seeded{i}")
                got = {}
                while eng.has_unfinished():
                    for o in eng.step():
                        if o.finished:
                            got[o.request_id] = o.output_token_ids
                want[where] = [got["seeded0"], got["seeded1"]]
            r = res[f"{connector}_{where}"] = {
                "greedy_equal_colocated": greedy == colocated,
                "seeded_equal_colocated": outs == want[where],
                "reprefills": st["transfer"]["reprefills"],
                "backends": st["fabric"]["backends"]}
            if r["backends"] != {connector: len(prompts) + 2}:
                raise AssertionError(f"parity disagg {connector} {where}: {st['fabric']}")
            if where == "cuda":
                from ray_tpu_torch import chaos

                sched = _corrupt_once("dreq-2", device=connector == "device")
                try:
                    bad, _, st = run(params, device, connector)
                finally:
                    chaos.uninstall()
                r["corrupted"] = {"equal_clean": bad == greedy,
                                  "reprefills": st["transfer"]["reprefills"],
                                  "corrupted_sends": len(sched.log),
                                  "fallbacks": st["fabric"]["fallbacks"]}
    ok = all(r["greedy_equal_colocated"] and r["seeded_equal_colocated"] and not r["reprefills"]
             for r in res.values())
    for connector in ("inproc", "device"):
        c = res[f"{connector}_cuda"]["corrupted"]
        if not c["equal_clean"] or (c["reprefills"], c["corrupted_sends"]) != (1, 1) or \
                c["fallbacks"] != (connector == "device"):
            ok = False
    if not ok:
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
        # the same requests again, warm (the first pass pays the mixed and
        # verify graphs' captures), from an empty prefix cache; a third,
        # "steady" pass was cut for the smoke's time
        first = [finals[f"{method[0]}{i}"] for i in range(8)]
        for key, tag in (("warm", "w"),):
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


def _host_state() -> dict:
    """What the process holds on the host: its threads, the port's recorder
    and registry, and the interpreter's tracked objects."""
    import threading

    from ray_tpu_torch import obs
    from ray_tpu_torch.util import metrics

    rec = obs.get_recorder()
    return {"threads": sorted(t.name for t in threading.enumerate()),
            "recorder_traces": len(rec),
            "registry_series": sum(len(m.series()) if not isinstance(m, metrics.Histogram)
                                   else len(m.hist_data()) for m in metrics.registry_snapshot()),
            "gc_tracked_objects": len(gc.get_objects())}


def train_phase(dev, keep_state: bool = False) -> dict:
    """LLAMA_400M at full width and depth (bf16 compute, fp32 params, remat
    "dots", flash attention) trained on one fixed batch, with bench.py's
    gates (bench.py:122-178). With ``keep_state`` the result carries
    ``"trained"``: (state, step, batch, config), for the publish phase."""
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
        with _gc_pauses() as gcp:
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
        # the host paces this step: what it shares the interpreter with
        "gc_pause_ms_timed_steps": gcp["ms"], "gc_collections_timed_steps": gcp["n"],
        "gc_by_generation_timed_steps": {"ms": gcp["ms_by_gen"], "n": gcp["n_by_gen"]},
        "left_by_earlier_phases": _host_state(),
    }
    emit(res)
    emit(_profile_train(step, state, batch))
    if keep_state:
        res["trained"] = (state, step, batch, cfg)
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


FEED_BATCHES = 6


def data_feed_phase(dev) -> dict:
    """The train step fed by the port's datasets: 6 batches of int32 tokens
    [8, 1025] (numpy seed 0) through ``data.from_numpy``, then
    ``iter_device_batches(batch_size=8, prefetch=1)`` (pinned host batches
    copied non_blocking on the feed's side stream by the data-prefetch
    thread, the step's stream waiting on each copy's event), into 6 steps
    of ``make_train_step`` at LLAMA_400M (the train phase's setup) from a
    fresh state (torch seed 0); and the same 6 steps from the same fresh
    state on the same batches copied synchronously by ``.to(dev)`` before
    the steps (pre-placed), in turns: F P P F, after a warm-up of 2 steps on
    a throwaway state. K1/K2 launches counted over the first fed run. Fails
    unless every fed tensor equals its host batch and every run's losses
    equal the first's bit for bit. Reports step ms of each run, the feed's
    host ms per batch on the prefetch thread (pin + issuing the copies) and
    the consumer's wait for each batch."""
    import dataclasses

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.data import iterator
    from ray_tpu_torch.models.llama import LLAMA_400M, init_params, loss_and_weight_fn
    from ray_tpu_torch.ops.flash import flash_bwd_cuda, flash_fwd_cuda
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(LLAMA_400M, attention_impl="flash")
    B, S = 8, 1024
    host = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(FEED_BATCHES * B, S + 1),
                                             dtype=np.int32)
    step = make_train_step(lambda p, b: loss_and_weight_fn(p, b, cfg), None)

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return TrainState.create(init_params(cfg, gen, dev), adamw(3e-4, weight_decay=1e-4))

    def split(t):
        return {"tokens": t[:, :-1], "targets": t[:, 1:]}

    state = fresh()  # warm-up: cuBLAS plans, allocator growth
    warm = torch.from_numpy(host[:B]).to(dev)
    for _ in range(2):
        state, m = step(state, split(warm))
    float(m["loss"])
    del state, warm

    copy_ms = []
    copy = iterator._CudaFeed._copy

    def timed_copy(self, b):
        t0 = time.perf_counter()
        out = copy(self, b)
        copy_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    iterator._CudaFeed._copy = timed_copy

    def fed_run():
        state = fresh()
        torch.cuda.synchronize()
        n_copies = len(copy_ms)
        fed, losses, waits = [], [], []
        t0 = time.perf_counter()
        it = iter(ds.iter_device_batches(batch_size=B, prefetch=1))
        while True:
            tw = time.perf_counter()
            b = next(it, None)
            waits.append((time.perf_counter() - tw) * 1e3)
            if b is None:
                break
            fed.append(b["tokens"])
            state, m = step(state, split(b["tokens"]))
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        wall = time.perf_counter() - t0
        if len(fed) != FEED_BATCHES:
            raise AssertionError(f"data_feed: {len(fed)} batches fed, not {FEED_BATCHES}")
        for i, t in enumerate(fed):
            if not (t.device.type == dev.type and t.dtype == torch.int32
                    and torch.equal(t.cpu(), torch.from_numpy(host[i * B:(i + 1) * B]))):
                raise AssertionError(f"data_feed: fed batch {i} differs from its host batch")
        return losses, {"path": "F", "step_ms": wall / FEED_BATCHES * 1e3,
                        "copy_host_ms": copy_ms[n_copies:], "consumer_wait_ms": waits[:-1]}

    def placed_run():
        state = fresh()
        placed = [torch.from_numpy(host[i * B:(i + 1) * B]).to(dev)
                  for i in range(FEED_BATCHES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for t in placed:
            state, m = step(state, split(t))
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        return losses, {"path": "P", "step_ms": (time.perf_counter() - t0) / FEED_BATCHES * 1e3}

    ray_tpu_torch.init(num_cpus=4)
    try:
        ds = data.from_numpy({"tokens": host})
        # the main path: the counters zeroed just before the first fed run, read after it
        flash_fwd_cuda.launches = 0
        flash_bwd_cuda.launches = 0
        losses, first = fed_run()
        launches = {"flash_fwd": flash_fwd_cuda.launches, "flash_bwd": flash_bwd_cuda.launches}
        order = "PPF"  # in turns after the first fed run: F P P F
        runs = [first]
        for k in order:
            got, run = fed_run() if k == "F" else placed_run()
            if got != losses:
                raise AssertionError(f"data_feed: run {len(runs)} ({k}) losses {got} differ "
                                     f"from the first fed run's {losses}")
            runs.append(run)
    finally:
        iterator._CudaFeed._copy = copy
        ray_tpu_torch.shutdown()
    if min(launches.values()) <= 0:
        raise AssertionError(f"data_feed: a kernel of the path never launched: {launches}")
    torch.cuda.empty_cache()
    fed = [r for r in runs if r["path"] == "F"]
    waits = [w for r in fed for w in r["consumer_wait_ms"]]
    res = {"phase": "data_feed", "model": "LLAMA_400M", "batch": B, "seq": S,
           "batches": FEED_BATCHES, "prefetch": 1, "dtype": "bfloat16", "param_dtype": "float32",
           "order": "F" + order, "losses": losses, "losses_equal_bitwise": True,
           "fed_equal_host": True,
           "step_ms": {r["path"] + str(i): r["step_ms"] for i, r in enumerate(runs)},
           "step_ms_fed": float(np.mean([r["step_ms"] for r in fed])),
           "step_ms_preplaced": float(np.mean([r["step_ms"] for r in runs if r["path"] == "P"])),
           "feed_copy_host_ms": {"first_run": fed[0]["copy_host_ms"],
                                 "last_run": fed[-1]["copy_host_ms"]},
           "consumer_wait_ms": {"first_batch": [r["consumer_wait_ms"][0] for r in fed],
                                "rest_mean": float(np.mean([w for r in fed
                                                            for w in r["consumer_wait_ms"][1:]])),
                                "rest_max": float(max(w for r in fed
                                                      for w in r["consumer_wait_ms"][1:]))},
           "batch_bytes": B * (S + 1) * 4, "kernel_launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


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
# weight publishing (publish) and the multi-tenant fleet (fleet)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _weight_stages():
    """Time the weight plane's stages while the block runs, by wrapping the
    classes' methods (restored after): each weight bundle's seal and verify
    (host ms; each ends in a 4-byte read per leaf, so the reduction is done)
    and each ``LLMEngine.write_params`` (device-complete: synchronized
    before and after). Yields {"seal_ms": [...], "verify_ms": [...],
    "write_ms": [...]}."""
    import torch

    from ray_tpu_torch.fabric.transport import ArrayBundle
    from ray_tpu_torch.llm.engine import LLMEngine

    acc = {"seal_ms": [], "verify_ms": [], "write_ms": []}
    seal, verify, write = ArrayBundle.seal, ArrayBundle.verify, LLMEngine.write_params

    def timed(fn, key, sync=False, only_weights=False):
        def wrapper(self, *a, **k):
            if only_weights and not self.bundle_id.startswith("weights-"):
                return fn(self, *a, **k)
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            if sync:
                torch.cuda.synchronize()
            acc[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    ArrayBundle.seal = timed(seal, "seal_ms", only_weights=True)
    ArrayBundle.verify = timed(verify, "verify_ms", only_weights=True)
    LLMEngine.write_params = timed(write, "write_ms", sync=True)
    try:
        yield acc
    finally:
        ArrayBundle.seal, ArrayBundle.verify, LLMEngine.write_params = seal, verify, write


def _stage_summary(acc: dict) -> dict:
    return {k: {"n": len(v), "ms": v} for k, v in acc.items()}


def _pin_chunks(eng) -> None:
    """Hold the pipelined decode's chunk length at 8 (no step-up on host
    timing), so two passes of the same requests decode the same chunks."""
    from ray_tpu_torch.llm.pipeline import ChunkController, PipelineStats

    eng._pipe_ctl, eng._pipe_stats = ChunkController(initial=8, target_ratio=0.0), PipelineStats()


def _graph_keys(eng) -> dict:
    """Captures so far per graph family and key."""
    return {name: {str(k): len(v) for k, v in fam.capture_s_by_key.items()}
            for name, fam in (("decode", eng._graphs), ("mixed", eng._mixed_graphs),
                              ("verify", eng._verify_graphs))}


PUBLISH_BLOCKS = 1024


def publish_phase(dev, trained) -> dict:
    """Train -> publish -> serve at LLAMA_400M: an engine serves the engine
    phase's 12 requests (its graphs captured), the trainer takes 3 more
    AdamW steps, a snapshot of its params is published as v1 and applied
    between two passes; the second pass must equal a fresh engine on the
    snapshot bit for bit, replaying the first pass's graphs. Then the
    aliasing guard and a cold start."""
    import torch

    from ray_tpu_torch.autoscale import cold_start_engine, params_bitwise_equal
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import sorted_leaves
    from ray_tpu_torch.ops.flash import flash_bwd_cuda, flash_fwd_cuda
    from ray_tpu_torch.train.weight_sync import WeightPublisher, WeightSubscriber, snapshot

    t_phase = time.perf_counter()
    state, step, batch, tcfg = trained
    model = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    cfg = EngineConfig(model=model, **{**ENGINE_KW, "num_blocks": PUBLISH_BLOCKS})
    prompts, sps = _engine_traffic(model)
    greedy = [i for i, sp in enumerate(sps) if sp.greedy]
    res = {"phase": "publish", "model": "LLAMA_400M", "dtype": "bfloat16",
           "param_dtype": "float32", "num_blocks": PUBLISH_BLOCKS, "requests": len(prompts)}
    torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(cfg, seed=1, device=dev)  # v0: random weights
    _pin_chunks(eng)
    first, reqs, wall, _ = _serve(eng, prompts, sps, "a")
    _check_served(eng, first, model, len(prompts), 32)
    keys_a = _graph_keys(eng)
    res["first_pass"] = {"wall_s": wall, "graphs": keys_a,
                         "prefix_hit_tokens": eng.stats()["prefix_cache"]["hit_tokens"]}

    # 3 AdamW steps of the train phase's state, the flash counters zeroed
    flash_fwd_cuda.launches = flash_bwd_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    res["train"] = {"steps": 3, "wall_s": time.perf_counter() - t0, "loss": loss,
                    "flash_launches": {"flash_fwd": flash_fwd_cuda.launches,
                                       "flash_bwd": flash_bwd_cuda.launches}}
    launches = dict(res["train"]["flash_launches"])
    if min(launches.values()) <= 0:
        raise AssertionError(f"publish: the train steps launched no flash kernel: {launches}")

    with _weight_stages() as stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = snapshot(state.params)  # fp32, the learner's own copy
        torch.cuda.synchronize()
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        pub = WeightPublisher(namespace="chip-publish")
        target = pub.register_rollout("publish/e0", device=eng.kv_cache_device())
        sub = WeightSubscriber(pub.transport, "publish/e0")
        ptrs = [t.data_ptr() for t in sorted_leaves(eng.params)]
        before_peek = [eng.peek_prefix_tokens(p) for p in prompts]
        t0 = time.perf_counter()
        version = pub.publish(snap, [target])
        publish_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        applied = sub.apply_to_engine(eng)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
    if applied != version or version != 1 or eng.stats()["weight_version"] != 1:
        raise AssertionError(f"publish: applied {applied} of v{version}")
    if [t.data_ptr() for t in sorted_leaves(eng.params)] != ptrs:
        raise AssertionError("publish: the apply rebound the engine's weights")
    if not params_bitwise_equal(snap, eng.params):
        raise AssertionError("publish: the engine's bytes differ from the snapshot cast to bf16")
    after_peek = [eng.peek_prefix_tokens(p) for p in prompts]
    if any(after_peek):
        raise AssertionError(f"publish: pre-swap blocks still hit after the swap: {after_peek}")
    nbytes = sum(t.numel() * t.element_size() for t in sorted_leaves(snap))
    res["weights"] = {
        "bytes_published": nbytes, "leaves": len(ptrs), "version": version,
        "snapshot_clone_ms": snapshot_ms, "publish_ms": publish_ms, "apply_ms": apply_ms,
        "stages": _stage_summary(stages), "data_ptrs_unchanged": True,
        "prefix_tokens_before_swap": before_peek, "prefix_tokens_after_swap": after_peek,
    }
    if not before_peek[11]:
        raise AssertionError("publish: request 11's prefix was not cached before the swap")

    # the same pass on the swapped engine: the first pass's graphs replayed
    marks, replayed = _launch_marks(eng), _replayed_marks(eng)
    swapped, reqs, wall, _ = _serve(eng, prompts, sps, "p")
    pass_launches = _launch_counts(eng, marks)
    in_replays = {n: v - replayed[n] for n, v in _replayed_marks(eng).items()}
    keys_p = _graph_keys(eng)
    recaptured = {fam: {k: keys_p[fam][k] - n for k, n in keys.items() if keys_p[fam][k] != n}
                  for fam, keys in keys_a.items()}
    new_keys = {fam: [k for k in keys_p[fam] if k not in keys_a[fam]] for fam in keys_p}
    fresh = LLMEngine(cfg, params=snap, device=dev)
    _pin_chunks(fresh)
    want, _, fresh_wall, _ = _serve(fresh, prompts, sps, "p")
    del fresh
    same = [swapped[f"p{i}"] == want[f"p{i}"] for i in range(len(prompts))]
    res["second_pass"] = {
        "wall_s": wall, "fresh_engine_wall_s": fresh_wall,
        "greedy_streams_equal_fresh_engine": f"{sum(same[i] for i in greedy)}/{len(greedy)}",
        "all_streams_equal_fresh_engine": f"{sum(same)}/{len(same)}",
        "kernel_launches": pass_launches, "kernel_launches_in_replays": in_replays,
        "recaptured_first_pass_keys": recaptured, "new_graph_keys": new_keys,
        "streams_differ_from_v0": sum(swapped[f"p{i}"] != first[f"a{i}"] for i in greedy),
    }
    launches.update(pass_launches)
    if not all(same[i] for i in greedy):
        emit(res)
        raise AssertionError("publish: the swapped engine's greedy tokens differ from a fresh "
                             "engine's on the snapshot")
    if any(recaptured.values()) or min(in_replays.values()) <= 0:
        emit(res)
        raise AssertionError(f"publish: recaptured {recaptured}, replays {in_replays}")

    # the aliasing guard: the live params published, then a step writes them
    guard = WeightPublisher(namespace="chip-publish-live")
    try:
        gt = guard.register_rollout("live/e0", device=eng.kv_cache_device())
        gsub = WeightSubscriber(guard.transport, "live/e0")
        guard.publish(state.params, [gt])
        fwd0, bwd0 = flash_fwd_cuda.launches, flash_bwd_cuda.launches
        state, _ = step(state, batch)
        launches["flash_fwd"] += flash_fwd_cuda.launches - fwd0
        launches["flash_bwd"] += flash_bwd_cuda.launches - bwd0
        refused = gsub.apply_to_engine(eng)
        res["aliasing_guard"] = {"applied": refused, **gsub.stats(),
                                 "engine_still_equals_snapshot": params_bitwise_equal(
                                     snap, eng.params)}
    finally:
        guard.close()
    if refused is not None or gsub.num_mutated_dropped != 1 or \
            not res["aliasing_guard"]["engine_still_equals_snapshot"]:
        emit(res)
        raise AssertionError(f"publish: the aliasing guard did not refuse: {res['aliasing_guard']}")

    # cold start: a new engine from nothing, through publish_latest
    cold, report = cold_start_engine(lambda: LLMEngine(cfg, seed=2, device=dev), pub,
                                     "publish/cold", pool="decode", reference_params=snap)
    _pin_chunks(cold)
    cold_out, _, _, _ = _serve(cold, prompts, sps, "p")
    res["cold_start"] = {**dataclasses.asdict(report),
                         "greedy_streams_equal_fresh_engine":
                             f"{sum(cold_out[f'p{i}'] == want[f'p{i}'] for i in greedy)}"
                             f"/{len(greedy)}"}
    if not report.bitwise_identical or report.weight_version != 1:
        raise AssertionError(f"publish: cold start {report}")
    pub.close()
    del cold, eng, snap, state
    gc.collect()
    torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["kernel_launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


FLEET_BLOCKS = 1024
FLEET_KW = dict(max_loras=2, lora_rank=8, lora_targets=("wq", "wv"))
FLEET_SEQS = 8            # max_num_seqs per replica
# the tenants' admission budget: batch (weight 1 of 4) holds up to 24 requests
# in flight, more than both replicas' 8 sequences, so each replica keeps
# batch rows waiting behind a full batch and a gold arrival must preempt
# (at exactly 16, a row between finishing and its thread's next submit left
# a slot free, least-loaded routing sent gold there, and no preemption
# fired); 32 flood threads exceed the share, so batch is also shed
FLEET_QUEUE_BUDGET = 96
FLEET_FLOOD_THREADS = 32
FLEET_FLOOD_WARM_S = 8.0  # flood alone before gold's graded requests


def _fleet_spec():
    from ray_tpu_torch.fleet import AdapterSpec, FleetSpec, ModelSpec, TenantSpec

    return FleetSpec(
        models=(ModelSpec("llama3-8b", replicas=2,
                          adapters=(AdapterSpec("styleA", rank=8), AdapterSpec("styleB", rank=8))),),
        tenants=(TenantSpec("gold", priority=2, weight=3.0),
                 TenantSpec("batch", priority=0, weight=1.0)),
        total_queue_budget=FLEET_QUEUE_BUDGET,
    )


def _wait_every_slot_batch(mgr, deadline_s: float = 60.0) -> None:
    """Return once every replica runs ``FLEET_SEQS`` rows, so a gold request
    sent now finds no free slot and has a batch row to preempt; fail after
    ``deadline_s``."""
    end = time.monotonic() + deadline_s
    while any(r.runner.depths()[1] < FLEET_SEQS for r in mgr.replicas("llama3-8b")):
        if time.monotonic() > end:
            raise AssertionError(f"fleet: the flood never filled every replica's "
                                 f"{FLEET_SEQS} slots in {deadline_s} s")
        time.sleep(0.001)


def _scaled(params, factor: float) -> dict:
    """Every leaf x factor, in the leaf's dtype (a new tree on the card)."""
    return {k: (_scaled(v, factor) if isinstance(v, dict) else v * factor)
            for k, v in params.items()}


def _replica_marks(r) -> dict:
    """``_pool_marks`` of a fleet replica (its runner's ``call`` runs on its
    loop thread)."""
    import types

    return _pool_marks(types.SimpleNamespace(call=r.runner.call, engine=r.engine))


def _gold_pass(mgr, prompts, sp, tag: str, model_ref: str = "llama3-8b") -> list:
    """Submit every prompt as gold at once and collect them all."""
    tickets = [mgr.submit("gold", model_ref, p, sp, request_id=f"{tag}{i}")
               for i, p in enumerate(prompts)]
    return [list(mgr.collect(t, timeout_s=600).output_token_ids) for t in tickets]


def _on_replica(r, prompt, sp, rid, lora_id=None):
    """One request served on one replica (through its runner)."""
    _rid, q = r.runner.submit(prompt, sp, request_id=rid, lora_id=lora_id)
    while True:
        out = q.get(timeout=600)
        if isinstance(out, BaseException) or out is None:
            raise AssertionError(f"fleet: request {rid} on {r.tag} failed: {out!r}")
        if out.finished:
            return list(out.output_token_ids)


def fleet_phase(dev, params) -> dict:
    """The canary ladder at LLAMA3_8B: a FleetManager of two replicas (r0
    on the smoke's weights, r1 on a clone), two tenants, two adapters: a
    noisy neighbour, a base canary promoted, a second one rolled back, an
    adapter canary with a scoped drop, and a seeded PREEMPT_ENGINE mid
    canary; every gate bit for bit on distinct storages."""
    import concurrent.futures
    import threading

    import torch

    from ray_tpu_torch import chaos
    from ray_tpu_torch.fleet import (
        FleetAdmissionRejected,
        FleetManager,
        bitwise_equal,
        local_slo_histograms,
        shares_storage,
    )
    from ray_tpu_torch.llm import EngineConfig, SamplingParams
    from ray_tpu_torch.llm.engine import preemption_counter
    from ray_tpu_torch.models.llama import LLAMA3_8B, sorted_leaves
    from ray_tpu_torch.obs.telemetry import SLOThresholds, evaluate_slo

    t_phase = time.perf_counter()
    model = LLAMA3_8B
    cfg = EngineConfig(model=model, **{**ENGINE_KW, "num_blocks": FLEET_BLOCKS,
                                       "max_num_seqs": FLEET_SEQS}, **FLEET_KW)
    prompts, _sps = _engine_traffic(model)
    greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    thresholds = SLOThresholds()  # green: p95 TTFT <= 2 s, TPOT <= 0.2 s, queue wait <= 1 s
    res = {"phase": "fleet", "model": "LLAMA3_8B", "dtype": "bfloat16", "replicas": 2,
           "num_blocks": FLEET_BLOCKS, "max_num_seqs": FLEET_SEQS, **FLEET_KW,
           "thresholds": thresholds.to_dict()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peaks = {}
    t0 = time.perf_counter()
    mgr = FleetManager(_fleet_spec(), engine_config=cfg, params={"llama3-8b": params}, seed=0,
                       thresholds=thresholds, device=dev)
    torch.cuda.synchronize()
    res["spawn_s"] = time.perf_counter() - t0
    lost = 0
    try:
        r0, r1 = mgr.replicas("llama3-8b")
        if r0.engine.params["embed"] is not params["embed"] or \
                shares_storage(r0.engine.params, r1.engine.params):
            raise AssertionError("fleet: r0 must hold the given weights and r1 a clone")
        for r in (r0, r1):  # both replicas decode the same chunks for one request
            r.runner.call(lambda e=r.engine: _pin_chunks(e))

        def alone(r, prompt, rid, lora_id=None):
            """One greedy request on one replica from an empty prefix cache,
            so two replicas (or two versions) serve it with the same shapes."""
            r.runner.call(r.engine.drop_prefix_cache)
            return _on_replica(r, prompt, greedy, rid, lora_id=lora_id)
        marks0 = {r.tag: _replica_marks(r) for r in (r0, r1)}
        plane = mgr.weights
        apply_ms: list = []
        apply_base = plane._apply_base

        def timed_apply(replica):
            t = time.perf_counter()
            try:
                return apply_base(replica)
            finally:
                torch.cuda.synchronize()
                apply_ms.append((time.perf_counter() - t) * 1e3)

        plane._apply_base = timed_apply
        with _weight_stages() as stages:
            # a. noisy neighbour: batch floods while gold sends
            _gold_pass(mgr, prompts[:2], greedy, "warm")  # captures on both replicas
            stop, shed, flood_done = threading.Event(), [0], [0]

            def flood(i):
                j = i
                while not stop.is_set():
                    p = prompts[j % len(prompts)]
                    j += FLEET_FLOOD_THREADS
                    try:
                        t = mgr.submit("batch", "llama3-8b", p, SamplingParams(
                            max_tokens=64, temperature=0.0, ignore_eos=True))
                    except FleetAdmissionRejected:
                        shed[0] += 1
                        time.sleep(0.02)
                        continue
                    mgr.collect(t, timeout_s=600)  # a failure shows in batch_completed
                    flood_done[0] += 1

            threads = [threading.Thread(target=flood, args=(i,), name=f"flood-{i}")
                       for i in range(FLEET_FLOOD_THREADS)]
            for th in threads:
                th.start()
            # the flood fills both replicas' batches and captures its first
            # buckets; gold is graded on what follows
            time.sleep(FLEET_FLOOD_WARM_S)
            baseline = local_slo_histograms()
            pre0 = {k: v for k, v in preemption_counter().series().items()}
            gold_ttft, gold_tokens = [], 0
            try:
                for i in range(4):
                    _wait_every_slot_batch(mgr)
                    t = time.perf_counter()
                    ticket = mgr.submit("gold", "llama3-8b", prompts[2 + i], greedy,
                                        request_id=f"nn{i}")
                    first = ticket.queue.get(timeout=600)
                    gold_ttft.append(time.perf_counter() - t)
                    out = mgr.collect(ticket, timeout_s=600)
                    gold_tokens += len(out.output_token_ids)
                    if first is None or isinstance(first, BaseException):
                        raise AssertionError(f"fleet: gold request failed: {first!r}")
            finally:
                stop.set()
                for th in threads:
                    th.join(timeout=600)
            grades = evaluate_slo(local_slo_histograms(baseline=baseline), thresholds)
            pre = {"/".join(k): v - pre0.get(k, 0) for k, v in preemption_counter().series().items()
                   if k[2] == "priority" and v - pre0.get(k, 0) > 0}
            gold_grade = grades["model_tags"].get("tenant:gold", {})
            res["noisy_neighbor"] = {
                "gold_ttft_s": gold_ttft, "gold_tokens": gold_tokens,
                "gold_grade": gold_grade.get("grade"),
                "gold_slo": {s: gold_grade.get(s) for s in ("ttft", "tpot", "queue_wait")},
                "batch_shed": shed[0], "batch_completed": flood_done[0],
                "priority_preemptions": pre,
            }
            peaks["noisy_neighbor_gb"] = torch.cuda.max_memory_allocated() / 2**30
            if gold_tokens != 4 * 32 or shed[0] < 1 or not any("batch" in k for k in pre):
                emit(res)
                raise AssertionError(f"fleet: noisy neighbour {res['noisy_neighbor']}")

            # b. base canary, promoted; the graded pass's shapes captured first
            _gold_pass(mgr, prompts[:8], greedy, "cw")
            cand1 = _scaled(r0.engine.params, 1.01)
            torch.cuda.synchronize()
            t = time.perf_counter()
            info = plane.begin_canary("llama3-8b", params=cand1)
            torch.cuda.synchronize()
            begin_s = time.perf_counter() - t
            canary = next(r for r in (r0, r1) if r.tag == info["replica"])
            graded = _gold_pass(mgr, prompts[:8], greedy, "cb")
            grade = plane.canary_grade()
            peaks["canary_gb"] = torch.cuda.max_memory_allocated() / 2**30
            t = time.perf_counter()
            promoted = plane.promote()
            torch.cuda.synchronize()
            promote_s = time.perf_counter() - t
            gate_b = {r.tag: bitwise_equal(r.engine.params, cand1) for r in (r0, r1)}
            distinct_b = not shares_storage(r0.engine.params, r1.engine.params)
            toks_b = {r.tag: alone(r, prompts[3], f"pb-{r.tag}") for r in (r0, r1)}
            res["canary_promote"] = {
                "info": info, "begin_s": begin_s, "canary_grade": grade["grade"],
                "canary_slo": {s: (grade["detail"] or {}).get(s) for s in
                               ("ttft", "tpot", "queue_wait")},
                "graded_requests": len(graded), "promote_s": promote_s, "outcome": promoted,
                "bitwise_equal_candidate": gate_b, "distinct_storages": distinct_b,
                "greedy_tokens_equal_across_replicas": toks_b[r0.tag] == toks_b[r1.tag],
            }
            if not (all(gate_b.values()) and distinct_b and toks_b[r0.tag] == toks_b[r1.tag]):
                emit(res)
                raise AssertionError(f"fleet: promote {res['canary_promote']}")

            # c. a second candidate, rolled back to the retained v1
            cand2 = _scaled(r0.engine.params, 1.01)
            info = plane.begin_canary("llama3-8b", params=cand2)
            canary = next(r for r in (r0, r1) if r.tag == info["replica"])
            on_canary = alone(canary, prompts[3], "c2")
            peaks["rollback_gb"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.synchronize()
            t = time.perf_counter()
            rolled = plane.rollback()
            torch.cuda.synchronize()
            rollback_s = time.perf_counter() - t
            back = alone(canary, prompts[3], "cb2")
            res["canary_rollback"] = {
                "info": info, "rollback_s": rollback_s, "outcome": rolled,
                "canary_equals_v1": bitwise_equal(canary.engine.params, cand1),
                "distinct_from_v1": not shares_storage(canary.engine.params, cand1),
                "candidate_changed_tokens": on_canary != toks_b[r0.tag],
                "tokens_equal_r0": back == toks_b[r0.tag],
            }
            if not (res["canary_rollback"]["canary_equals_v1"] and back == toks_b[r0.tag]):
                emit(res)
                raise AssertionError(f"fleet: rollback {res['canary_rollback']}")

            # d. adapter canary: the swap drops only the swapped adapter's chains
            lid_prompt = prompts[4]
            for aid, seed in (("styleA", 1), ("styleB", 2)):
                mgr.register_adapter("llama3-8b", aid, lora_adapter(model, seed, ("wq", "wv"), 8))
            canary = r1  # the newest replica takes every canary
            for aid in ("styleA", "styleB"):
                mgr.ensure_adapter(canary, aid)
            # v1 from an empty cache (the rollback's stream starts from one
            # too); then styleB's chains, so both adapters' prefixes are hot
            v1_tokens = alone(canary, lid_prompt, "d-v1", lora_id="styleA")
            _on_replica(canary, lid_prompt, greedy, "d-styleB", lora_id="styleB")
            probe = lambda aid: canary.runner.call(  # noqa: E731
                lambda: canary.engine.peek_prefix_tokens(lid_prompt, lora_id=aid))
            before = {aid: probe(aid) for aid in ("styleA", "styleB")}
            info = plane.begin_canary("llama3-8b", adapter_id="styleA",
                                      payload=lora_adapter(model, 9, ("wq", "wv"), 8))
            if info["replica"] != canary.tag:
                raise AssertionError(f"fleet: the adapter canary went to {info['replica']}")
            after = {aid: probe(aid) for aid in ("styleA", "styleB")}
            v2_tokens = _on_replica(canary, lid_prompt, greedy, "d-v2", lora_id="styleA")
            rolled_a = plane.rollback()
            back_a = _on_replica(canary, lid_prompt, greedy, "d-back", lora_id="styleA")
            res["adapter_canary"] = {
                "info": info, "prefix_tokens_before_swap": before,
                "prefix_tokens_after_swap": after, "outcome": rolled_a,
                "v2_changed_tokens": v2_tokens != v1_tokens, "rollback_tokens_equal_v1":
                    back_a == v1_tokens,
            }
            if not (before["styleB"] > 0 and after["styleB"] == before["styleB"]
                    and after["styleA"] == 0 and back_a == v1_tokens):
                emit(res)
                raise AssertionError(f"fleet: adapter canary {res['adapter_canary']}")

            # e. PREEMPT_ENGINE mid-canary: nothing lost, the promote bitwise
            info = plane.begin_canary("llama3-8b", params=cand2)
            sched = chaos.install(chaos.FaultSchedule(13, [chaos.FaultSpec(
                chaos.PREEMPT_ENGINE, site="llm.engine.step", start_after=6, every_n=25,
                max_fires=2)]))
            rec0 = sum(r.runner.num_recoveries for r in (r0, r1))
            try:
                def one(i):
                    t = mgr.submit("gold", "llama3-8b", prompts[i], greedy, request_id=f"e{i}")
                    return mgr.collect(t, timeout_s=600)

                with concurrent.futures.ThreadPoolExecutor(8) as ex:
                    outs = list(ex.map(one, range(8)))
                fired = sched.fired_kinds()
            finally:
                chaos.uninstall()
            lost = sum(not (o.finished and len(o.output_token_ids) == 32) for o in outs)
            promoted_e = plane.promote()
            res["preempt_mid_canary"] = {
                "info": info, "fired": fired, "requests": len(outs), "requests_lost": lost,
                "recoveries": sum(r.runner.num_recoveries for r in (r0, r1)) - rec0,
                "outcome": promoted_e,
                "bitwise_equal_candidate": {r.tag: bitwise_equal(r.engine.params, cand2)
                                            for r in (r0, r1)},
                "distinct_storages": not shares_storage(r0.engine.params, r1.engine.params),
            }
            if lost or chaos.PREEMPT_ENGINE not in fired or \
                    not all(res["preempt_mid_canary"]["bitwise_equal_candidate"].values()):
                emit(res)
                raise AssertionError(f"fleet: preempt mid-canary {res['preempt_mid_canary']}")
        res["weights"] = {"apply_ms": apply_ms, "stages": _stage_summary(stages),
                          "bytes_a_publish": sum(t.numel() * t.element_size()
                                                 for t in sorted_leaves(cand1)),
                          "timeline": plane.timeline}
        marks1 = {r.tag: _replica_marks(r) for r in (r0, r1)}
        per = {tag: _pool_launches(marks0[tag], marks1[tag]) for tag in marks0}
        res["kernel_launches_by_replica"] = per
        res["kernel_launches"] = {n: sum(per[t][n]["device"] for t in per)
                                  for n in ("paged_attention", "ragged_attention")}
        res["kernel_launches_in_replays"] = {n: sum(per[t][n]["in_replays"] for t in per)
                                             for n in ("paged_attention", "ragged_attention")}
        res["stats"] = mgr.stats()
        if min(res["kernel_launches_in_replays"].values()) <= 0:
            raise AssertionError(f"fleet: no K3/K4 launch in replays: {per}")
    finally:
        mgr.close()
    peaks["phase_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["peak_mem_gb"] = peaks
    res["requests_lost"] = lost
    del mgr, cand1, cand2
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# process
# ---------------------------------------------------------------------------


PROCESS_CRASH_GIB = 8           # what the crashing task holds on its card
PROCESS_FREE_SLACK = 256 << 20  # the card's free bytes back within this after shutdown
STORE_PIPE_BYTES = 64 << 20     # the numpy argument and result, store against pipe
WARM_TRIPS = 20


def _cold_start_probe(submitted: float, device: str) -> dict:
    """A fresh GPU worker's first task: fork to entry, ``import torch``,
    the first CUDA context."""
    import os
    import sys

    entered = time.time()
    t0 = time.perf_counter()
    had_torch = "torch" in sys.modules
    import torch

    t1 = time.perf_counter()
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "submit_to_entry_s": entered - submitted, "torch_imported_before": had_torch,
            "import_torch_s": t1 - t0, "cuda_context_s": t2 - t1,
            "device": torch.cuda.get_device_name(0), "cards_seen": torch.cuda.device_count()}


def _warm_trip() -> int:
    import os

    return os.getpid()


def _unflatten(flat, lens) -> list:
    """Prompts shipped as one int32 array and their lengths, as lists."""
    import numpy as np

    offs = np.concatenate([[0], np.cumsum(lens)])
    return [flat[offs[i]:offs[i + 1]].tolist() for i in range(len(lens))]


def _captures(eng) -> int:
    return sum(len(s) for f in _families(eng) for s in f.capture_s_by_key.values())


def _counted_pass(eng, prompts, sps, tag: str) -> dict:
    """One pass of the requests on ``eng``: its tokens, K3/K4's device
    launches (the engine's marks), the launches made by graph replays, and
    the graph captures it made and their seconds."""
    captures0 = _captures(eng)
    capture_s0 = sum(sum(s) for f in _families(eng) for s in f.capture_s_by_key.values())
    marks, replayed0 = _launch_marks(eng), _replayed_marks(eng)
    finals, _reqs, wall, steps = _serve(eng, prompts, sps, tag)
    return {"tokens": finals, "kernel_launches": _launch_counts(eng, marks),
            "kernel_launches_in_replays": {n: v - replayed0[n]
                                           for n, v in _replayed_marks(eng).items()},
            "captures": _captures(eng) - captures0,
            "capture_s": sum(sum(s) for f in _families(eng)
                             for s in f.capture_s_by_key.values()) - capture_s0,
            "pass_s": wall, "steps": steps}


def _serve_8b_in_worker(flat, lens, sps, greedy: int, device: str) -> dict:
    """In a GPU worker: LLAMA3_8B's weights (``params_8b``, torch seed 0)
    made on the worker's own card, the engine phase's configuration, the
    engine phase's 12 requests (their prompts shipped as one int32 array),
    K3/K4 counted over the pass by the engine's marks; then each greedy
    row's last step again as a 1-token request (prompt + outputs but the
    last: a prefix-cache hit), its logits taken at the sampler."""
    import os

    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA3_8B
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    dev = torch.device(device)
    params, params_s = params_8b(dev)
    t0 = time.perf_counter()
    eng = LLMEngine(EngineConfig(model=LLAMA3_8B, **ENGINE_KW), params=params, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _unflatten(flat, lens)
    paged_attention_cuda.launches = 0
    ragged_attention_cuda.launches = 0
    counted = _counted_pass(eng, prompts, sps, "r")
    finals, launches, replayed = (counted["tokens"], counted["kernel_launches"],
                                  counted["kernel_launches_in_replays"])
    wall, steps, capture_s = counted["pass_s"], counted["steps"], counted["capture_s"]

    logits, sample = {}, eng._sample_batch

    def take_logits(lg, batch):
        for j, r in enumerate(batch):
            logits[r.request_id] = lg[j].detach().to(torch.bfloat16).cpu()
        return sample(lg, batch)

    eng._sample_batch = take_logits
    one = SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True)
    for i in range(greedy):
        eng.add_request(prompts[i] + finals[f"r{i}"][:-1], one, request_id=f"z{i}")
    scored = {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                scored[out.request_id] = out.output_token_ids
    del eng._sample_batch
    last = torch.stack([logits[f"z{i}"] for i in range(greedy)])
    peak = torch.cuda.max_memory_allocated()
    del eng, params
    torch.cuda.empty_cache()  # the pooled worker keeps no 8B cache
    return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "tokens": finals, "last_step_logits": last,
            "scored_equal_last_token": sum(scored[f"z{i}"] == finals[f"r{i}"][-1:]
                                           for i in range(greedy)),
            "kernel_launches": launches, "kernel_launches_in_replays": replayed,
            "params_s": params_s, "engine_init_s": init_s,
            "capture_s": capture_s, "pass_s": wall, "steps": steps,
            "peak_mem_gb": peak / 2**30}


def _fp32_greedy_tokens(device: str) -> list:
    """The parity model's fp32 greedy tokens on this process's card."""
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams

    model, _, params, prompts = _parity_setup(torch.device(device))
    cfg = EngineConfig(model=model, num_blocks=256, block_size=16, max_num_seqs=8,
                       max_prefill_len=256, mixed_batch=True, mixed_prefill_chunk=64,
                       decode_chunk=8)
    eng = LLMEngine(cfg, params=params, device=device)
    sp = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    return _generate(eng, prompts, sp, [None] * len(prompts))


def _crash_after_k3(marker: str, gib: int, device: str) -> dict:
    """First attempt: hold ``gib`` GiB on the card, launch K3 at the
    kernels phase's shape and check it against its plain twin, write the
    finding to ``marker`` and kill the process. The retry returns."""
    import os

    import torch

    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda, paged_attention_torch

    if os.path.exists(marker):
        with open(marker) as f:
            return {"retry_pid": os.getpid(), "first": json.load(f)}
    dev = torch.device(device)
    hog = torch.ones(gib << 30, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    q, k, v, bt, ctx = _paged_case(gen, dev, torch.bfloat16, 16, 32, 8, 128, 16, K3_CTX_LENS,
                                   128)
    got = paged_attention_cuda(q, k, v, bt, ctx, block_size=16)
    ref = paged_attention_torch(q, k, v, bt, ctx, block_size=16)
    err = float((got.float() - ref.float()).abs().max())
    torch.cuda.synchronize()
    with open(marker, "w") as f:
        json.dump({"pid": os.getpid(), "max_abs_err": err, "held_gib":
                   torch.cuda.memory_allocated() / 2**30, "hog_bytes": hog.numel()}, f)
    os._exit(9)


def _echo(a):
    return a


def _free_bytes_back(want: int, deadline_s: float = 30.0) -> tuple:
    """Poll the card's free bytes until they reach ``want``."""
    import torch

    t0 = time.perf_counter()
    while True:
        free = torch.cuda.mem_get_info()[0]
        if free >= want or time.perf_counter() - t0 > deadline_s:
            return free, time.perf_counter() - t0
        time.sleep(0.25)


def process_phase(dev, engine_first: dict) -> dict:
    """LLAMA3_8B served by a GPU task in a worker process pinned to the
    card, under ``ray_tpu_torch.init(worker_mode="process")``; the fp32
    identity of a worker and this process on the card; a crashed GPU task
    and a chaos-killed one retried to success; the card's memory back."""
    import os
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import chaos
    from ray_tpu_torch.core import process_pool
    from ray_tpu_torch.core import runtime as rt
    from ray_tpu_torch.models.llama import LLAMA3_8B

    t_phase = time.perf_counter()
    if rt.is_initialized():
        raise AssertionError("process: a runtime outlived an earlier phase")
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    res: dict = {"phase": "process"}
    ray_tpu_torch.init(worker_mode="process")
    try:
        if ray_tpu_torch.cluster_resources().get("GPU") != 1:
            raise AssertionError(f"process: {ray_tpu_torch.cluster_resources()}")
        pool = rt.get_runtime().process_pool
        channel = pool._get_channel()
        if channel.store is None:
            raise AssertionError("process: the shared-memory store did not build or open")
        gpu_task = ray_tpu_torch.remote(num_gpus=1)

        # worker cold start, then a warm worker's round trip
        t0 = time.perf_counter()
        cold = ray_tpu_torch.get(gpu_task(_cold_start_probe).remote(time.time(), dev.type),
                                 timeout=300)
        cold["round_trip_s"] = time.perf_counter() - t0
        if cold["visible"] != "0" or cold["cards_seen"] != 1:
            raise AssertionError(f"process: the GPU worker is not pinned to card 0: {cold}")
        trips, pids = [], set()
        for _ in range(WARM_TRIPS):
            t0 = time.perf_counter()
            pids.add(ray_tpu_torch.get(gpu_task(_warm_trip).remote(), timeout=60))
            trips.append((time.perf_counter() - t0) * 1e3)
        res["cold_start"] = cold
        res["warm_round_trip_ms"] = {"median": float(np.median(trips)), "min": min(trips),
                                     "max": max(trips), "n": len(trips),
                                     "one_worker": pids == {cold["pid"]}}

        # (a) LLAMA3_8B in the worker: the engine phase's traffic and tokens
        prompts, sps = _engine_traffic(LLAMA3_8B)
        lens = np.asarray([len(p) for p in prompts], np.int64)
        flat = np.concatenate([np.asarray(p, np.int32) for p in prompts])
        greedy = sum(sp.temperature == 0.0 for sp in sps)
        moved0 = dict(channel.moved)
        alloc0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = ray_tpu_torch.get(
            gpu_task(_serve_8b_in_worker).remote(flat, lens, sps, greedy, dev.type), timeout=900)
        task_s = time.perf_counter() - t0
        alloc1 = torch.cuda.memory_allocated()
        objects_left = channel.store.stats()["num_objects"]
        moved = {k: channel.moved[k] - moved0[k] for k in moved0}
        differ = [(f"r{i}", j, a, b) for i in range(greedy)
                  for j, (a, b) in enumerate(zip(out["tokens"][f"r{i}"], engine_first[f"r{i}"]))
                  if a != b]
        same_streams = sum(out["tokens"][f"r{i}"] == engine_first[f"r{i}"]
                           for i in range(greedy))
        last = out.pop("last_step_logits")
        res["serve_8b"] = {
            **{k: v for k, v in out.items() if k != "tokens"}, "task_s": task_s,
            "greedy_streams_equal_engine_phase": f"{same_streams}/{greedy}",
            "differing_tokens": differ[:20],
            "last_step_logits": {"shape": list(last.shape), "dtype": str(last.dtype),
                                 "finite": bool(torch.isfinite(last.float()).all()),
                                 "argmax_equals_last_token": int(sum(
                                     int(last[i].float().argmax()) == out["tokens"][f"r{i}"][-1]
                                     for i in range(greedy)))},
            "bytes_moved": moved, "parent_allocated_delta": alloc1 - alloc0,
            "store_objects_after": objects_left,
        }
        if min(out["kernel_launches"].values()) <= 0:
            raise AssertionError(f"process: K3/K4 did not launch in the worker: {out}")
        if alloc1 > alloc0:
            raise AssertionError(f"process: this process's card memory grew by "
                                 f"{alloc1 - alloc0} B during the worker's task")
        if objects_left != 0:
            raise AssertionError(f"process: {objects_left} objects left in the store")
        if last.shape != (greedy, LLAMA3_8B.vocab_size) or last.dtype != torch.bfloat16:
            raise AssertionError(f"process: logits {tuple(last.shape)} {last.dtype}")
        if moved["shm"] < sum(n for n in (flat.nbytes, last.numel() * last.element_size())
                              if n >= process_pool._SHM_THRESHOLD):
            raise AssertionError(f"process: the prompts and logits did not ride the store: "
                                 f"{moved}")

        # (b) fp32: the parity model's greedy tokens, worker = this process
        in_worker = ray_tpu_torch.get(gpu_task(_fp32_greedy_tokens).remote(dev.type),
                                      timeout=300)
        here = _fp32_greedy_tokens(dev.type)
        gc.collect()
        torch.cuda.empty_cache()
        res["fp32_worker_equals_parent"] = in_worker == here
        res["fp32_tokens"] = sum(map(len, here))
        if in_worker != here:
            raise AssertionError("process: fp32 greedy tokens differ between a worker and "
                                 "this process on the card")

        # a 64 MiB numpy argument and result: the store, then the pipe, in turns
        big = np.arange(STORE_PIPE_BYTES // 8, dtype=np.float64)
        echo = ray_tpu_torch.remote(_echo)
        ray_tpu_torch.get(echo.remote(big), timeout=120)  # the CPU worker's cold start
        routes: dict = {"store": [], "pipe": []}
        for route in ("store", "pipe", "pipe", "store"):
            saved = process_pool._SHM_THRESHOLD
            if route == "pipe":
                process_pool._SHM_THRESHOLD = 1 << 62
            try:
                m0 = dict(channel.moved)
                t0 = time.perf_counter()
                back = ray_tpu_torch.get(echo.remote(big), timeout=120)
                dt = time.perf_counter() - t0
            finally:
                process_pool._SHM_THRESHOLD = saved
            if not np.array_equal(back, big):
                raise AssertionError(f"process: the 64 MiB echo through the {route} differs")
            via = {k: channel.moved[k] - m0[k] for k in m0}
            if via["shm" if route == "store" else "inline"] < 2 * big.nbytes:
                raise AssertionError(f"process: the {route} round did not go by it: {via}")
            routes[route].append({"s": dt, "MB_per_s": 2 * big.nbytes / dt / 1e6})
        res["store_vs_pipe_64MiB"] = routes

        # (c) a GPU task holding 8 GiB and K3 crashes; its retry runs in a fresh worker
        marker = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_process_"), "first_attempt")
        crash = ray_tpu_torch.remote(num_gpus=1, max_retries=1)(_crash_after_k3)
        got = ray_tpu_torch.get(crash.remote(marker, PROCESS_CRASH_GIB, dev.type), timeout=300)
        first = got["first"]
        res["crash"] = got
        if first["held_gib"] < PROCESS_CRASH_GIB or first["max_abs_err"] > BANDS["bfloat16"]:
            raise AssertionError(f"process: the crashing attempt: {first}")
        if got["retry_pid"] == first["pid"]:
            raise AssertionError("process: the retry ran in the crashed worker")
        sched = chaos.install(chaos.FaultSchedule(17, [
            chaos.FaultSpec(chaos.KILL_WORKER, site="process_pool.task", max_fires=1)]))
        try:
            killed = ray_tpu_torch.remote(num_gpus=1, max_retries=1)(_warm_trip)
            pid = ray_tpu_torch.get(killed.remote(), timeout=300)
        finally:
            chaos.uninstall()
        res["chaos_kill_worker"] = {"fired": sched.fired_kinds(), "retry_pid": pid}
        if sched.fired_kinds() != [chaos.KILL_WORKER]:
            raise AssertionError(f"process: KILL_WORKER fired {sched.fired_kinds()}")
    finally:
        ray_tpu_torch.shutdown()
    free1, wait_s = _free_bytes_back(free0 - PROCESS_FREE_SLACK)
    res["free_bytes"] = {"before": free0, "after_shutdown": free1, "waited_s": wait_s}
    if free1 < free0 - PROCESS_FREE_SLACK:
        raise AssertionError(f"process: the card's free bytes {free1} not back within 256 MiB "
                             f"of {free0} after shutdown")
    res["kernel_launches"] = out["kernel_launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------


CLUSTER_FREE_SLACK = 64 << 20         # the card's free bytes back within this after a kill
CLUSTER_TENSOR_BYTES = 256 << 20      # the bf16 CUDA tensor a GPU task returns
CLUSTER_PULL_BYTES = 64 << 20         # the tensor the CPU node pulls from the GPU node
CLUSTER_STORE_BYTES = 1 << 30         # each daemon's object store


class ClusterServer8B:
    """LLAMA3_8B in a cluster actor: the weights (``params_8b``, torch seed
    0) made on the card of the worker's lease, the engine phase's
    configuration; each ``serve`` is one pass of the engine phase's 12
    requests, counted as the process phase counts its worker's pass, with
    the prefix cache emptied first so each pass runs the same prefill (as
    the engine phase's later passes do). The decode-chunk controller is
    held at its initial length (8, the length the engine phase's first
    pass runs at), so a later pass meets only buckets the first captured:
    the worker's process is the actor's alone."""

    def __init__(self, device: str):
        import os

        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMEngine, pipeline
        from ray_tpu_torch.models.llama import LLAMA3_8B

        pipeline.ChunkController.note_chunk = lambda self, *a, **k: None

        entered = time.time()
        dev = torch.device(device)
        params, params_s = params_8b(dev)
        t0 = time.perf_counter()
        self.eng = LLMEngine(EngineConfig(model=LLAMA3_8B, **ENGINE_KW), params=params, device=dev)
        torch.cuda.synchronize()
        self.info_ = {"pid": os.getpid(), "node": os.environ.get("RAY_TPU_NODE_ID"),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "cards_seen": torch.cuda.device_count(),
                      "device": torch.cuda.get_device_name(0), "entered": entered,
                      "params_s": params_s, "engine_init_s": time.perf_counter() - t0}

    def info(self) -> dict:
        return self.info_

    def echo(self, x):
        return x

    def serve(self, flat, lens, sps, tag: str) -> dict:
        import torch

        self.eng.allocator.drop_prefix_cache()
        torch.cuda.reset_peak_memory_stats()
        out = _counted_pass(self.eng, _unflatten(flat, lens), sps, tag)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        return out


class ClusterLLMServer8B:
    """The cluster phase's Serve leg: a deployment around LLMServer whose
    replica builds LLAMA3_8B on its own card (``params_8b``, torch seed 0:
    the seeded generator the phase's actor uses, so nothing 16 GB crosses
    the store), over the engine phase's configuration plus the tiered cache,
    which publishes its resident chains through the ``GcsPrefixIndex`` it is
    given under a key of its own. The decode-chunk controller is held at its
    initial length, as the phase's actor holds it, so the second pass meets
    only buckets the first captured."""

    def __init__(self, device: str, index):
        import os

        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer, pipeline

        pipeline.ChunkController.note_chunk = lambda self, *a, **k: None
        entered = time.time()
        dev = torch.device(device)
        params, params_s = params_8b(dev)
        cfg = EngineConfig(model="llama3-8b", **ENGINE_KW, kvtier={})
        t0 = time.perf_counter()
        self.server = LLMServer(LLMConfig(model_id="llama3-8b", engine=cfg, params=params,
                                          tokenizer=IdTextTokenizer(cfg.model.vocab_size),
                                          device=device))
        self.key = f"serve-{os.environ.get('RAY_TPU_NODE_ID')}-{os.getpid()}"
        eng = self.server.engine
        self.server.runner.call(lambda: eng.kvtier.attach_index(index, engine_key=self.key))
        torch.cuda.synchronize()
        self.info_ = {"pid": os.getpid(), "node": os.environ.get("RAY_TPU_NODE_ID"),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "cards_seen": torch.cuda.device_count(), "index_key": self.key,
                      "entered": entered, "params_s": params_s,
                      "server_init_s": time.perf_counter() - t0}

    def info(self) -> dict:
        return self.info_

    async def completions(self, body: dict) -> dict:
        return await self.server.completions(body)

    def zero_counts(self) -> None:
        from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
        from ray_tpu_torch.ops.ragged import ragged_attention_cuda

        paged_attention_cuda.launches = 0
        ragged_attention_cuda.launches = 0

    def marks(self) -> dict:
        eng = self.server.engine
        return {"launches": self.server.runner.call(lambda: _launch_marks(eng)),
                "captures": sum(g.captures for g in _families(eng))}

    def flush(self) -> None:
        eng = self.server.engine
        self.server.runner.call(lambda: eng.kvtier.flush_index(force=True))

    def shutdown(self) -> None:
        self.server.shutdown()


def _cluster_serve_leg(dev, bodies) -> dict:
    """One replica of ``ClusterLLMServer8B`` with ``num_gpus=1`` on the
    attached cluster: lease to ready, the 12 completions through the handle
    from the driver, each on its own thread (a first pass, K3/K4 counted in
    the replica, and a second), the GCS's prefix index after a flush, the
    card's free bytes after ``serve.delete``. A cluster worker runs an
    actor's calls one at a time (its per-actor FIFO lock, as the
    reference's), so the replica serves the 12 one after another."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.llm.kvtier import GcsPrefixIndex, chain_hashes
    from ray_tpu_torch.models.llama import LLAMA3_8B

    out: dict = {}
    gcs = core_api._cluster().client.gcs
    index = GcsPrefixIndex(gcs, timeout_s=5)
    free0 = torch.cuda.mem_get_info()[0]
    dep = serve.deployment(ClusterLLMServer8B, name="LLMServer8B",
                           ray_actor_options={"num_gpus": 1})
    t0 = time.time()
    handle = serve.run(dep.bind(dev.type, index), name="cluster-llm", route_prefix=None)
    info = handle.info.remote().result(timeout_s=600)
    info["lease_to_ready_s"] = time.time() - t0
    info["submit_to_entry_s"] = info.pop("entered") - t0
    out["replica"] = info
    if info["node"] != "gpu" or info["visible"] != "0" or info["cards_seen"] != 1 \
            or info["pid"] == os.getpid():
        raise AssertionError(f"cluster serve: the replica is not a worker pinned to the gpu "
                             f"node's card: {info}")

    def serve_pass() -> dict:
        def post(body):
            return handle.completions.remote(body).result(timeout_s=600)

        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            outs = [f.result() for f in [pool.submit(post, b) for b in bodies]]
        wall = time.perf_counter() - t1
        for o in outs:
            k, reason = o["usage"]["completion_tokens"], o["choices"][0]["finish_reason"]
            if not (k == 32 or reason == "stop"):
                raise AssertionError(f"cluster serve: {k} tokens, finish {reason!r}")
        tokens = sum(o["usage"]["completion_tokens"] for o in outs)
        return {"wall_s": wall, "output_tokens": tokens, "output_tok_per_s": tokens / wall}

    # the main path in the replica: its counters zeroed just before the
    # first pass, read just after
    handle.zero_counts.remote().result(timeout_s=60)
    m0 = handle.marks.remote().result(timeout_s=60)
    first = serve_pass()
    m1 = handle.marks.remote().result(timeout_s=60)
    first["kernel_launches"] = {n: m1["launches"][n] - m0["launches"][n] for n in m0["launches"]}
    first["captures"] = m1["captures"] - m0["captures"]
    if min(first["kernel_launches"].values()) <= 0:
        raise AssertionError(f"cluster serve: a kernel never launched in the replica: {first}")
    second = serve_pass()
    m2 = handle.marks.remote().result(timeout_s=60)
    second["captures"] = m2["captures"] - m1["captures"]
    out["passes"] = [first, second]
    out["kernel_launches"] = first["kernel_launches"]

    # the GCS's prefix index after a flush: the replica's rows, and the
    # 512-token shared prefix (bodies 0 and 11) under the replica's key
    handle.flush.remote().result(timeout_s=60)
    stats = gcs.call("kvtier_stats", None, timeout=10)
    ids = IdTextTokenizer(LLAMA3_8B.vocab_size).encode(bodies[0]["prompt"])
    hashes = chain_hashes(ids, ENGINE_KW["block_size"])[:512 // ENGINE_KW["block_size"]]
    got = index.lookup(hashes)
    held = (got or {}).get("engines", {}).get(info["index_key"], {})
    out["gcs_index"] = {"stats": stats, "lookup_512": held, "num_dark": index.num_dark}
    if stats["rows"] <= 0 or held.get("n_tokens", 0) < 512:
        raise AssertionError(f"cluster serve: the GCS's prefix index: {out['gcs_index']}")

    # delete the app: the replica's worker goes and the card's bytes come back
    t1 = time.perf_counter()
    serve.delete("cluster-llm")
    free1, wait_s = _free_bytes_back(free0 - CLUSTER_FREE_SLACK)
    out["delete"] = {"free_before": free0, "free_after": free1, "waited_s": wait_s,
                     "s": time.perf_counter() - t1}
    if free1 < free0 - CLUSTER_FREE_SLACK:
        raise AssertionError(f"cluster serve: the card's free bytes {free1} not back within "
                             f"64 MB of {free0} after serve.delete")
    serve.shutdown()
    return out


def _bits_tensor(n: int, device: str):
    """A bf16 tensor of ``n`` elements whose bit patterns cover every int16
    (NaNs and infinities included): equal only bit for bit."""
    import torch

    bits = (torch.arange(n, dtype=torch.int64, device=device) * 40503 % 65536) - 32768
    return bits.to(torch.int16).view(torch.bfloat16)


def _tensor_on_card(n: int, device: str):
    import os

    return os.environ.get("RAY_TPU_NODE_ID"), _bits_tensor(n, device)


def _pull_from_the_other_node(oid: bytes) -> dict:
    """On the CPU node: pull the driver's object from the GPU node's store
    into this node's (timed alone), then read it from the shared mapping
    and hash its bytes."""
    import hashlib
    import os

    import torch  # noqa: F401 — imported before the clock: a cold worker's import is seconds

    from ray_tpu_torch.cluster.client import ClusterObjectRef, _ambient_client

    client = _ambient_client()
    t0 = time.perf_counter()
    marker = client.local_daemon.call(
        "fetch_objects", {"object_ids": [oid], "timeout": 120.0,
                          "shm_direct": client._local_shm() is not None}, timeout=180)[0]
    pull_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    t = client.get(ClusterObjectRef(oid, client, "put"), timeout=120)
    read_s = time.perf_counter() - t1
    return {"node": os.environ.get("RAY_TPU_NODE_ID"),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "via_shm": isinstance(marker, dict), "pull_s": pull_s, "read_s": read_s,
            "nbytes": t.numel() * t.element_size(),
            "sha256": hashlib.sha256(t.numpy().tobytes()).hexdigest()}


def _exit_once(marker: str, device: str) -> dict:
    """First attempt: note the pid in ``marker`` and kill the worker
    process; the retry returns both pids."""
    import os

    import torch

    torch.zeros(1, device=device)  # the crash takes a live CUDA context with it
    if os.path.exists(marker):
        with open(marker) as f:
            return {"first_pid": int(f.read()), "retry_pid": os.getpid(),
                    "node": os.environ.get("RAY_TPU_NODE_ID")}
    with open(marker, "w") as f:
        f.write(str(os.getpid()))
    os._exit(9)


def _no_torch_in(pids) -> None:
    for pid in pids:
        with open(f"/proc/{pid}/maps") as f:
            if "libtorch" in f.read():
                raise AssertionError(f"cluster: control-plane process {pid} loaded torch")


def _cluster_dag_leg(server, flat, lens, sps, greedy: int, engine_first: dict,
                     pass_s: dict) -> dict:
    """``ClusterServer8B.serve`` compiled into a DAG over the cluster actor,
    bound to an InputNode's fields: one host, so ``channel_mode="auto"``
    picks the shm channel. The 12 requests twice through it; each pass's
    greedy streams equal the engine phase's, it captures no graph, and its
    K3/K4 launches equal pass s's, all in graph replays. After
    ``teardown()`` the actor answers ``info`` within 30 s. Then the median
    round trip of a trivial method (``echo``), 50 calls through
    ``.remote`` and 50 through a compiled DAG."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    out: dict = {}
    with InputNode() as inp:
        node = server.serve.bind(inp.flat, inp.lens, inp.sps, inp.tag)
    t0 = time.perf_counter()
    dag = node.experimental_compile()
    out["compile_s"] = time.perf_counter() - t0
    out["channel"] = dag.channel_kind
    passes = []
    try:
        if dag.channel_kind != "shm":
            raise AssertionError(f"cluster dag: one host picked {dag.channel_kind!r}, not shm")
        for tag in ("d", "e"):
            t0 = time.perf_counter()
            got = dag.execute({"flat": flat, "lens": lens, "sps": sps, "tag": tag}).get(
                timeout=600)
            got["round_trip_s"] = time.perf_counter() - t0
            toks = got.pop("tokens")
            same = sum(toks[f"{tag}{i}"] == engine_first[f"r{i}"] for i in range(greedy))
            got["greedy_streams_equal_engine_phase"] = f"{same}/{greedy}"
            passes.append(got)
            if same != greedy:
                raise AssertionError(f"cluster dag: pass {tag}: {same}/{greedy} greedy streams "
                                     "equal the engine phase's")
            if got["captures"] != 0:
                raise AssertionError(f"cluster dag: pass {tag} captured {got['captures']} graphs")
            if got["kernel_launches"] != pass_s["kernel_launches"] \
                    or got["kernel_launches_in_replays"] != got["kernel_launches"]:
                raise AssertionError(f"cluster dag: pass {tag}'s launches {got['kernel_launches']} "
                                     f"({got['kernel_launches_in_replays']} in replays), pass "
                                     f"s's {pass_s['kernel_launches']}")
    finally:
        t0 = time.perf_counter()
        dag.teardown()
        out["teardown_s"] = time.perf_counter() - t0
    out["passes"] = passes
    t0 = time.perf_counter()
    ray_tpu_torch.get(server.info.remote(), timeout=30)
    out["actor_answers_after_teardown_s"] = time.perf_counter() - t0

    def echo_through(call) -> dict:
        if call(7) != 7:
            raise AssertionError("cluster dag: echo returned another value")
        return _rtt_ms(lambda: call(7), n=51)

    out["echo_remote_ms"] = echo_through(
        lambda x: ray_tpu_torch.get(server.echo.remote(x), timeout=60))
    with InputNode() as inp:
        echo = server.echo.bind(inp).experimental_compile()
    try:
        out["echo_dag_ms"] = echo_through(lambda x: echo.execute(x).get(timeout=60))
    finally:
        echo.teardown()
    ray_tpu_torch.get(server.info.remote(), timeout=30)
    out["kernel_launches"] = {n: sum(p["kernel_launches"][n] for p in passes)
                              for n in pass_s["kernel_launches"]}
    return out


def cluster_phase(dev, engine_first: dict) -> dict:
    """LLAMA3_8B served by a ``num_gpus=1`` actor in a worker process of a
    port cluster (a GCS and two node daemons, ``"gpu"`` holding the card
    and ``"cpu"``), attached with ``ray_tpu_torch.init(address=...)``: the
    engine phase's greedy streams on two passes, then on two more through a
    compiled DAG over the actor (``_cluster_dag_leg``), the actor killed and the
    card's memory back, a GPU worker's cold start through a daemon, a bf16
    CUDA tensor returned through the store bit for bit, the driver's
    tensor pulled by the CPU node, a crashed GPU task retried, Serve on the
    cluster (``_cluster_serve_leg``: LLMServer in a ``num_gpus=1`` replica,
    its tiered cache published into the GCS's prefix index), and nothing of
    the cluster left after shutdown."""
    import hashlib
    import os
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.cluster import LocalCluster
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.core import runtime as rt
    from ray_tpu_torch.models.llama import LLAMA3_8B

    t_phase = time.perf_counter()
    if rt.is_initialized():
        raise AssertionError("cluster: a runtime outlived an earlier phase")
    gc.collect()
    torch.cuda.empty_cache()
    res: dict = {"phase": "cluster"}
    c = LocalCluster(node_death_timeout_s=10.0)
    try:
        t0 = time.perf_counter()
        c.start()
        c.add_node({"num_cpus": 2, "GPU": 1}, node_id="gpu",
                   object_capacity_bytes=CLUSTER_STORE_BYTES)
        c.add_node({"num_cpus": 2}, node_id="cpu", object_capacity_bytes=CLUSTER_STORE_BYTES)
        c.wait_for_nodes(2, timeout=60)
        ray_tpu_torch.init(address=c.address)
        res["cluster_start_s"] = time.perf_counter() - t0
        res["resources"] = ray_tpu_torch.cluster_resources()
        if res["resources"].get("GPU") != 1 or res["resources"].get("num_cpus") != 4:
            raise AssertionError(f"cluster: resources {res['resources']}")
        _no_torch_in(c.pids())

        # (1) LLAMA3_8B in a num_gpus=1 actor on node "gpu": two passes
        free0 = torch.cuda.mem_get_info()[0]
        prompts, sps = _engine_traffic(LLAMA3_8B)
        lens = np.asarray([len(p) for p in prompts], np.int64)
        flat = np.concatenate([np.asarray(p, np.int32) for p in prompts])
        greedy = sum(sp.temperature == 0.0 for sp in sps)
        t0 = time.time()
        server = ray_tpu_torch.remote(num_gpus=1)(ClusterServer8B).remote(dev.type)
        info = ray_tpu_torch.get(server.info.remote(), timeout=600)
        info["create_to_ready_s"] = time.time() - t0
        info["submit_to_entry_s"] = info.pop("entered") - t0
        if info["node"] != "gpu" or info["visible"] != "0" or info["cards_seen"] != 1:
            raise AssertionError(f"cluster: the actor is not pinned to the gpu node's card: {info}")
        res["actor"] = info
        passes = []
        for tag in ("r", "s"):
            t0 = time.perf_counter()
            out = ray_tpu_torch.get(server.serve.remote(flat, lens, sps, tag), timeout=600)
            out["round_trip_s"] = time.perf_counter() - t0
            toks = out.pop("tokens")
            same = sum(toks[f"{tag}{i}"] == engine_first[f"r{i}"] for i in range(greedy))
            out["greedy_streams_equal_engine_phase"] = f"{same}/{greedy}"
            out["differing_tokens"] = [(f"{tag}{i}", j, a, b) for i in range(greedy)
                                       for j, (a, b) in enumerate(zip(toks[f"{tag}{i}"],
                                                                      engine_first[f"r{i}"]))
                                       if a != b][:20]
            passes.append(out)
            if same != greedy:
                raise AssertionError(f"cluster: pass {tag}: {same}/{greedy} greedy streams equal "
                                     f"the engine phase's: {out['differing_tokens']}")
        res["passes"] = passes
        first = passes[0]["kernel_launches"]
        want = {n: FIRST_PASS_LAUNCHES[n]["device"] for n in FIRST_PASS_LAUNCHES}
        if first != want:
            raise AssertionError(f"cluster: first-pass launches in the actor {first} != {want}")
        if passes[1]["captures"] != 0:
            raise AssertionError(f"cluster: the second pass captured {passes[1]['captures']} "
                                 "graphs")
        # the same actor behind a compiled DAG: two passes, then teardown
        res["dag"] = _cluster_dag_leg(server, flat, lens, sps, greedy, engine_first, passes[1])

        # (2) kill the actor: its lease is released and the card's memory comes back
        t0 = time.perf_counter()
        ray_tpu_torch.kill(server)
        del server
        free1, wait_s = _free_bytes_back(free0 - CLUSTER_FREE_SLACK)
        gpu_addr = next(tuple(n["addr"]) for n in ray_tpu_torch.nodes() if n["node_id"] == "gpu")
        stats = core_api._cluster().client.pool.get(gpu_addr).call("stats", None)
        res["kill"] = {"free_before": free0, "free_after": free1, "waited_s": wait_s,
                       "s": time.perf_counter() - t0, "gpu_node_leases": stats["num_leases"],
                       "gpu_node_available": stats["available"]}
        if free1 < free0 - CLUSTER_FREE_SLACK:
            raise AssertionError(f"cluster: the card's free bytes {free1} not back within 64 MB "
                                 f"of {free0} after the kill")
        if stats["num_leases"] != 0 or stats["available"].get("GPU") != 1:
            raise AssertionError(f"cluster: the actor's lease was not released: {stats}")

        # (3) a GPU worker's cold start through the daemon, then a 256 MiB
        # bf16 CUDA tensor back through the gpu node's store, bit for bit
        gpu_task = ray_tpu_torch.remote(num_gpus=1)
        t0 = time.perf_counter()
        cold = ray_tpu_torch.get(gpu_task(_cold_start_probe).remote(time.time(), dev.type),
                                 timeout=300)
        cold["round_trip_s"] = time.perf_counter() - t0
        if cold["visible"] != "0" or cold["cards_seen"] != 1:
            raise AssertionError(f"cluster: the GPU worker is not pinned to card 0: {cold}")
        res["cold_start"] = cold
        n = CLUSTER_TENSOR_BYTES // 2
        t0 = time.perf_counter()
        node, got = ray_tpu_torch.get(gpu_task(_tensor_on_card).remote(n, dev.type), timeout=300)
        torch.cuda.synchronize()
        back_s = time.perf_counter() - t0
        want_t = _bits_tensor(n, dev.type)
        same_bits = bool(torch.equal(got.view(torch.int16), want_t.view(torch.int16)))
        res["cuda_tensor"] = {"node": node, "bytes": CLUSTER_TENSOR_BYTES, "device": str(got.device),
                              "dtype": str(got.dtype), "bit_for_bit": same_bits, "s": back_s,
                              "MB_per_s": CLUSTER_TENSOR_BYTES / back_s / 1e6}
        if (node != "gpu" or got.device.type != dev.type or got.dtype != torch.bfloat16
                or not same_bits):
            raise AssertionError(f"cluster: the CUDA tensor: {res['cuda_tensor']}")
        del got, want_t

        # (4) the CPU node pulls a 64 MiB tensor the driver put (GPU node's store)
        host = torch.arange(CLUSTER_PULL_BYTES // 8, dtype=torch.int64)
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(host)
        put_s = time.perf_counter() - t0
        on_cpu = ray_tpu_torch.remote(scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
            "cpu"))(_pull_from_the_other_node)
        pulled = ray_tpu_torch.get(on_cpu.remote(ref.id), timeout=300)
        pulled["put_s"] = put_s
        pulled["MB_per_s"] = CLUSTER_PULL_BYTES / pulled["pull_s"] / 1e6
        want_sha = hashlib.sha256(host.numpy().tobytes()).hexdigest()
        res["pull_between_nodes"] = pulled
        if (pulled["node"] != "cpu" or pulled["visible"] != "" or pulled["sha256"] != want_sha
                or pulled["nbytes"] != CLUSTER_PULL_BYTES):
            raise AssertionError(f"cluster: the pull between nodes: {pulled}")
        del ref

        # (5) a GPU task that kills its worker on the first attempt is retried
        marker = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_cluster_"), "first_attempt")
        t0 = time.perf_counter()
        crash = ray_tpu_torch.remote(num_gpus=1, max_retries=1)(_exit_once)
        retried = ray_tpu_torch.get(crash.remote(marker, dev.type), timeout=300)
        retried["s"] = time.perf_counter() - t0
        res["crash_retry"] = retried
        if retried["retry_pid"] == retried["first_pid"] or retried["node"] != "gpu":
            raise AssertionError(f"cluster: the retry: {retried}")

        # (6) Serve on the cluster: LLMServer in a num_gpus=1 replica, its
        # tiered cache published into the GCS's prefix index
        bodies, _, _ = _api_traffic()
        res["serve"] = _cluster_serve_leg(dev, bodies)
        _no_torch_in(c.pids())  # the GCS and the daemons, after all of it
    finally:
        from ray_tpu_torch import serve

        serve.shutdown()
        ray_tpu_torch.shutdown()
        t0 = time.perf_counter()
        c.shutdown()
        res["shutdown_s"] = time.perf_counter() - t0
    left = c.leftovers()
    res["left_after_shutdown"] = left
    if left != {"processes": [], "store_files": []}:
        raise AssertionError(f"cluster: left after shutdown: {left}")
    res["kernel_launches"] = first
    res["serve_kernel_launches"] = res["serve"]["kernel_launches"]
    res["dag_kernel_launches"] = res["dag"]["kernel_launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# cluster_ha
# ---------------------------------------------------------------------------


HA_DROP_SEED = 31337                 # the seeded DROP_RPC on telemetry_push
HA_KILL_AT_S = 0.3                   # KILL_GCS_PRIMARY this long after pass s's submit
HA_DEADLINE_S = 15.0                 # every control-plane query and wait of the phase
HA_REPORTER = "llama3-8b-host"
HA_MODEL_TAG = "llama3-8b-ha"


class ClusterHAServer8B(ClusterServer8B):
    """``ClusterServer8B`` with a ``TelemetryReporter`` to both GCS
    endpoints (every 0.5 s, the engine's utilization gauges refreshed
    before each snapshot), its requests' SLO samples tagged
    ``HA_MODEL_TAG``."""

    def __init__(self, device: str, endpoints):
        super().__init__(device)
        from ray_tpu_torch.obs.telemetry import TelemetryReporter

        self.eng.model_tag = HA_MODEL_TAG
        self.reporter = TelemetryReporter(tuple(tuple(e) for e in endpoints),
                                          reporter_id=HA_REPORTER, kind="engine",
                                          interval_s=0.5,
                                          collect=[self.eng.update_telemetry_gauges]).start()

    def flush_telemetry(self, attempts: int = 20) -> dict:
        """Push until one push lands (the seeded schedule drops some); the
        worker's own TTFT histogram and the reporter's counts."""
        from ray_tpu_torch.obs import slo

        landed = any(self.reporter.push_once() for _ in range(attempts))
        hist = slo.ttft_histogram().hist_data().get((HA_MODEL_TAG,))
        return {"landed": landed, "num_ok": self.reporter.num_ok,
                "num_dropped": self.reporter.num_dropped,
                "ttft_buckets": list(hist[0]) if hist else None,
                "ttft_count": hist[2] if hist else 0}


def _watch_promotion(endpoints, term0: int, out: dict, stop) -> None:
    """Poll ``ha_status`` through a client of both endpoints until a GCS
    answers with term ``term0 + 1``: ``out["promoted_at"]`` (wall clock)."""
    from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient

    client = ReconnectingRpcClient(*endpoints, timeout=2.0, failover_attempts=2)
    deadline = time.monotonic() + 60.0
    try:
        while not stop.is_set() and time.monotonic() < deadline:
            try:
                st = client.call("ha_status", {}, timeout=2.0)
            except Exception:  # noqa: BLE001 — the failover window
                stop.wait(0.05)
                continue
            if st.get("term") == term0 + 1 and st.get("role") == "primary":
                out["promoted_at"] = time.time()
                out["status"] = st
                return
            stop.wait(0.05)
    finally:
        client.close()


def _ha_status(gcs, want_term: int) -> dict:
    """``ha_status`` through the driver's client until it shows
    ``want_term`` (HA_DEADLINE_S)."""
    deadline = time.monotonic() + HA_DEADLINE_S
    st: dict = {}
    while True:
        try:
            st = gcs.call("ha_status", {}, timeout=5.0)
            if st.get("term") == want_term:
                return st
        except Exception:  # noqa: BLE001 — the failover window
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"cluster_ha: no GCS at term {want_term} within "
                                 f"{HA_DEADLINE_S} s: {st}")
        time.sleep(0.1)


def cluster_ha_phase(dev, engine_first: dict) -> dict:
    """LLAMA3_8B served by a ``num_gpus=1`` actor across a GCS failover: a
    port cluster whose GCS has a warm standby (the cluster phase's nodes),
    attached with both endpoints; the engine phase's streams on a pass
    before, during and after ``KILL_GCS_PRIMARY``; the promotion, the
    telemetry plane on the promoted GCS (the actor's pushes partly dropped
    by a seeded schedule), the actor's kill and a GPU task through the new
    primary, nothing left after shutdown."""
    import threading

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import chaos
    from ray_tpu_torch.chaos.runner import ChaosRunner
    from ray_tpu_torch.cluster import LocalCluster
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.core import runtime as rt
    from ray_tpu_torch.models.llama import LLAMA3_8B
    from ray_tpu_torch.obs.telemetry import format_status

    t_phase = time.perf_counter()
    if rt.is_initialized():
        raise AssertionError("cluster_ha: a runtime outlived an earlier phase")
    gc.collect()
    torch.cuda.empty_cache()
    res: dict = {"phase": "cluster_ha"}
    drops = chaos.FaultSchedule(HA_DROP_SEED, [chaos.FaultSpec(
        chaos.DROP_RPC, site="rpc.call", match={"method": "telemetry_push"}, every_n=2)])
    # installed before the cluster starts: the daemons copy this process's
    # environment and their workers adopt it (install_from_env)
    chaos.install(drops, propagate_env=True)
    c = LocalCluster(node_death_timeout_s=10.0, standby=True)
    watch_stop = threading.Event()
    try:
        t0 = time.perf_counter()
        c.start()
        c.add_node({"num_cpus": 2, "GPU": 1}, node_id="gpu",
                   object_capacity_bytes=CLUSTER_STORE_BYTES)
        c.add_node({"num_cpus": 2}, node_id="cpu", object_capacity_bytes=CLUSTER_STORE_BYTES)
        c.wait_for_nodes(2, timeout=60)
        ray_tpu_torch.init(address=c.address)
        res["cluster_start_s"] = time.perf_counter() - t0
        endpoints = c.gcs_endpoints
        gcs = core_api._cluster().client.gcs
        res["address"] = c.address
        if len(endpoints) != 2 or gcs.endpoints != endpoints:
            raise AssertionError(f"cluster_ha: the driver's GCS client {gcs.endpoints} is not "
                                 f"the pair {endpoints}")
        _no_torch_in(c.pids())  # the primary, the standby and the daemons
        term0 = _ha_status(gcs, 0)["term"]

        # the actor: LLAMA3_8B on the gpu node's card, reporting to both endpoints
        free0 = torch.cuda.mem_get_info()[0]
        prompts, sps = _engine_traffic(LLAMA3_8B)
        lens = np.asarray([len(p) for p in prompts], np.int64)
        flat = np.concatenate([np.asarray(p, np.int32) for p in prompts])
        greedy = sum(sp.temperature == 0.0 for sp in sps)
        t0 = time.time()
        server = ray_tpu_torch.remote(num_gpus=1)(ClusterHAServer8B).remote(dev.type, endpoints)
        info = ray_tpu_torch.get(server.info.remote(), timeout=600)
        info["lease_to_ready_s"] = time.time() - t0
        info["submit_to_entry_s"] = info.pop("entered") - t0
        if info["node"] != "gpu" or info["visible"] != "0" or info["cards_seen"] != 1:
            raise AssertionError(f"cluster_ha: the actor is not pinned to the gpu node's card: "
                                 f"{info}")
        res["actor"] = info

        returned_at: dict = {}  # wall time at which each pass's get returned

        def serve_pass(tag: str, before_get=None) -> dict:
            t0 = time.perf_counter()
            ref = server.serve.remote(flat, lens, sps, tag)
            if before_get is not None:
                before_get()
            out = ray_tpu_torch.get(ref, timeout=600)
            returned_at[tag] = time.time()
            out["round_trip_s"] = time.perf_counter() - t0
            toks = out.pop("tokens")
            same = sum(toks[f"{tag}{i}"] == engine_first[f"r{i}"] for i in range(greedy))
            out["greedy_streams_equal_engine_phase"] = f"{same}/{greedy}"
            if same != greedy:
                diff = [(f"{tag}{i}", j, a, b) for i in range(greedy)
                        for j, (a, b) in enumerate(zip(toks[f"{tag}{i}"], engine_first[f"r{i}"]))
                        if a != b][:20]
                raise AssertionError(f"cluster_ha: pass {tag}: {same}/{greedy} greedy streams "
                                     f"equal the engine phase's: {diff}")
            return out

        passes = {"r": serve_pass("r")}
        want_first = {n: FIRST_PASS_LAUNCHES[n]["device"] for n in FIRST_PASS_LAUNCHES}
        if passes["r"]["kernel_launches"] != want_first:
            raise AssertionError(f"cluster_ha: pass r launches {passes['r']['kernel_launches']} "
                                 f"!= {want_first}")

        # pass s: the primary is SIGKILLed 0.3 s after the submit
        runner = ChaosRunner(chaos.FaultSchedule(HA_DROP_SEED + 1, [chaos.FaultSpec(
            chaos.KILL_GCS_PRIMARY, at_s=HA_KILL_AT_S)]), cluster=c)
        watched: dict = {}
        watcher = threading.Thread(target=_watch_promotion, args=(endpoints, term0, watched,
                                                                  watch_stop),
                                   name="chip-smoke-ha-watch", daemon=True)

        def kill_primary():
            runner.start()
            watcher.start()

        passes["s"] = serve_pass("s", kill_primary)
        runner.join(timeout=HA_DEADLINE_S)
        runner.stop()
        watcher.join(timeout=60)
        if [f.kind for f in runner.executed] != [chaos.KILL_GCS_PRIMARY]:
            raise AssertionError(f"cluster_ha: the runner executed {runner.executed}")
        t_kill = runner.executed[0].t
        # the kill must land while pass s is still in flight, not after it returned
        res["kill_before_pass_s_returned_s"] = returned_at["s"] - t_kill
        if t_kill >= returned_at["s"]:
            raise AssertionError(f"cluster_ha: the primary was killed "
                                 f"{t_kill - returned_at['s']:.3f} s after pass s returned")
        if "promoted_at" not in watched:
            raise AssertionError("cluster_ha: the standby did not promote within 60 s of the "
                                 "kill")
        res["kill_to_promoted_s"] = watched["promoted_at"] - t_kill
        ha = _ha_status(gcs, term0 + 1)
        res["ha_status"] = ha
        if (ha["role"] != "primary" or ha["failovers_total"] != 1
                or ha["fenced_writes_total"] != 0 or tuple(gcs.addr) != tuple(c.standby_addr)):
            raise AssertionError(f"cluster_ha: after the failover {ha} at {gcs.addr}")

        passes["t"] = serve_pass("t")
        want_steady = {n: FIRST_PASS_LAUNCHES[n]["in_replays"] for n in FIRST_PASS_LAUNCHES}
        for tag in ("s", "t"):
            p = passes[tag]
            if (p["kernel_launches"] != want_steady or p["kernel_launches_in_replays"] != want_steady
                    or p["captures"] != 0):
                raise AssertionError(f"cluster_ha: pass {tag}: launches {p['kernel_launches']}, "
                                     f"in replays {p['kernel_launches_in_replays']}, captures "
                                     f"{p['captures']}; want {want_steady} in replays and none")
        res["passes"] = passes

        # the telemetry plane on the promoted GCS
        flushed = ray_tpu_torch.get(server.flush_telemetry.remote(), timeout=HA_DEADLINE_S)
        res["reporter"] = {k: flushed[k] for k in ("landed", "num_ok", "num_dropped")}
        agg = gcs.call("telemetry_cluster", {}, timeout=HA_DEADLINE_S)
        merged = agg["histograms"].get("ray_tpu_llm_ttft_seconds", {}).get(
            "series", {}).get(f"model={HA_MODEL_TAG}")
        served = 3 * len(prompts)
        res["ttft"] = {"gcs_count": merged and merged["count"], "worker_count": flushed["ttft_count"],
                       "gcs_p50_s": merged and merged.get("p50"),
                       "gcs_p95_s": merged and merged.get("p95")}
        if (not flushed["landed"] or flushed["num_dropped"] == 0 or merged is None
                or merged["buckets"] != flushed["ttft_buckets"] or merged["count"] != served
                or flushed["ttft_count"] != served):
            raise AssertionError(f"cluster_ha: the promoted GCS's TTFT histogram {merged} against "
                                 f"the worker's {flushed}")
        res["staleness_after_failover_s"] = agg["staleness"].get(HA_REPORTER)
        slo = gcs.call("telemetry_slo", {}, timeout=HA_DEADLINE_S)
        res["slo_grade"] = slo["model_tags"].get(HA_MODEL_TAG, {}).get("grade")
        if res["slo_grade"] in (None, "no_data"):
            raise AssertionError(f"cluster_ha: SLO grade {res['slo_grade']}")
        deadline = time.monotonic() + HA_DEADLINE_S
        while True:
            workers = gcs.call("telemetry_cluster", {}, timeout=HA_DEADLINE_S)["gauges"].get(
                "ray_tpu_node_workers", {}).get("series", {})
            if {"node=gpu", "node=cpu"} <= set(workers) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        res["node_gauges"] = workers
        if not {"node=gpu", "node=cpu"} <= set(workers):
            raise AssertionError(f"cluster_ha: node gauges on the promoted GCS: {workers}")
        text = format_status(gcs.call("telemetry_status", {}, timeout=HA_DEADLINE_S))
        for want in ("role primary", f"term {term0 + 1}", "failovers 1"):
            if want not in text:
                raise AssertionError(f"cluster_ha: status text lacks {want!r}:\n{text}")

        # kill the actor: its lease released on the promoted GCS, the card's memory back
        t0 = time.perf_counter()
        ray_tpu_torch.kill(server)
        del server
        free1, wait_s = _free_bytes_back(free0 - CLUSTER_FREE_SLACK)
        deadline = time.monotonic() + HA_DEADLINE_S
        while True:
            gpu_row = next(n for n in gcs.call("list_nodes", None, timeout=HA_DEADLINE_S)
                           if n["node_id"] == "gpu")
            if gpu_row["available"].get("GPU") == 1 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        stats = core_api._cluster().client.pool.get(tuple(gpu_row["addr"])).call("stats", None)
        res["kill"] = {"free_before": free0, "free_after": free1, "waited_s": wait_s,
                       "s": time.perf_counter() - t0, "gcs_gpu_available": gpu_row["available"],
                       "gpu_node_leases": stats["num_leases"]}
        if free1 < free0 - CLUSTER_FREE_SLACK:
            raise AssertionError(f"cluster_ha: the card's free bytes {free1} not back within "
                                 f"64 MB of {free0} after the kill")
        if (gpu_row["available"].get("GPU") != 1 or stats["num_leases"] != 0
                or stats["available"].get("GPU") != 1):
            raise AssertionError(f"cluster_ha: the actor's lease was not released: {res['kill']}")

        # a GPU task leased through the new primary
        t0 = time.perf_counter()
        cold = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(_cold_start_probe).remote(
            time.time(), dev.type), timeout=300)
        cold["round_trip_s"] = time.perf_counter() - t0
        res["cold_gpu_task"] = cold
        if cold["device"] != torch.cuda.get_device_name(0) or cold["visible"] != "0":
            raise AssertionError(f"cluster_ha: the GPU task after the failover: {cold}")
        _no_torch_in(c.pids())  # the promoted standby and the daemons, after all of it
    finally:
        watch_stop.set()
        ray_tpu_torch.shutdown()
        chaos.uninstall()
        t0 = time.perf_counter()
        c.shutdown()
        res["shutdown_s"] = time.perf_counter() - t0
    left = c.leftovers()
    res["left_after_shutdown"] = left
    if left != {"processes": [], "store_files": []}:
        raise AssertionError(f"cluster_ha: left after shutdown: {left}")
    res["kernel_launches"] = {n: sum(p["kernel_launches"][n] for p in passes.values())
                              for n in want_first}
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------

PHASES = ("build", "kernels", "flash_kernels", "engine", "lora", "api", "serve", "serve_disagg",
          "data", "disagg",
          "kvtier", "parity", "spec", "fleet", "process", "cluster", "cluster_ha", "train",
          "data_feed", "publish", "train_parity")

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
    if {"lora", "api", "data", "disagg", "process", "cluster", "cluster_ha"} & set(phases) \
            and "engine" not in phases:
        ap.error("the lora, api, data, disagg, process, cluster and cluster_ha phases read the "
                 "engine phase's results: add engine")
    if {"serve", "serve_disagg"} & set(phases) and "api" not in phases:
        ap.error("the serve and serve_disagg phases read the api phase's results: add "
                 "engine,api")
    if "publish" in phases and "train" not in phases:
        ap.error("the publish phase trains on from the train phase's state: add train")
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
    params, params_s = (params_8b(dev) if {"engine", "spec", "api", "serve", "serve_disagg",
                                            "data", "disagg", "kvtier", "fleet"} & set(phases)
                        else (None, 0.0))
    lora_launches, api_launches, disagg_launches, replayed = {}, {}, {}, {}
    serve_launches, serve_disagg_launches, data_launches, feed_launches = {}, {}, {}, {}
    serve_disagg_autoscale_launches = {}
    serve_rpc_launches, serve_grpc_launches, cluster_dag_launches = {}, {}, {}
    disagg_device_launches = {}
    kvtier_launches, fleet_launches, publish_launches, process_launches = {}, {}, {}, {}
    cluster_launches, cluster_serve_launches, cluster_ha_launches = {}, {}, {}
    if "engine" in phases:
        engine_res = engine_phase(dev, params, params_s)
        engine_first = engine_res["first_pass_tokens"]  # a few KB, for the process phase
        launches.update(engine_res["kernel_launches"])
        replayed = engine_res["kernel_launches_in_replays"]
    if "lora" in phases:
        lora_launches = lora_phase(dev, params, engine_res)["kernel_launches"]
    if "api" in phases:
        api_res = api_phase(dev, params, engine_res)
        api_launches = api_res["kernel_launches"]
    if "serve" in phases:
        serve_res = serve_phase(dev, params, api_res)
        serve_launches, doors = serve_res["kernel_launches"], serve_res["front_doors"]
        serve_rpc_launches = doors["rpc"]["kernel_launches"]
        if isinstance(doors.get("grpc"), dict):
            serve_grpc_launches = doors["grpc"]["kernel_launches"]
    if "serve_disagg" in phases:
        sd_res = serve_disagg_phase(dev, params, api_res)
        serve_disagg_launches = sd_res["kernel_launches"]
        serve_disagg_autoscale_launches = sd_res["autoscale"]["kernel_launches"]
        del sd_res
    if "api" in phases:
        del api_res
    if "data" in phases:
        data_launches = data_phase(dev, params)["kernel_launches"]
    if "disagg" in phases:
        disagg_res = disagg_phase(dev, params, engine_res)
        disagg_launches = disagg_res["kernel_launches"]
        disagg_device_launches = disagg_res["kernel_launches_device"]
        del disagg_res
    if "engine" in phases:
        del engine_res
    if "kvtier" in phases:
        kvtier_launches = kvtier_phase(dev, params)["kernel_launches"]
    if "parity" in phases:
        parity_phase(dev)
    if "spec" in phases:
        spec_phase(dev, params)
    if "fleet" in phases:  # the last reader of the 8B weights: r0 serves them
        fleet_launches = fleet_phase(dev, params)["kernel_launches"]
    del params  # the 8B weights go before the process phase and training
    torch.cuda.empty_cache()
    if "process" in phases:
        process_launches = process_phase(dev, engine_first)["kernel_launches"]
    if "cluster" in phases:
        cluster_res = cluster_phase(dev, engine_first)
        cluster_launches = cluster_res["kernel_launches"]
        cluster_serve_launches = cluster_res["serve_kernel_launches"]
        cluster_dag_launches = cluster_res["dag_kernel_launches"]
    if "cluster_ha" in phases:
        cluster_ha_launches = cluster_ha_phase(dev, engine_first)["kernel_launches"]
    if "train" in phases:
        train_res = train_phase(dev, keep_state="publish" in phases)
        launches.update(train_res["kernel_launches"])
    if "data_feed" in phases:
        feed_launches = data_feed_phase(dev)["kernel_launches"]
    if "publish" in phases:
        publish_launches = publish_phase(dev, train_res.pop("trained"))["kernel_launches"]
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
            **({"launches_serve_phase": serve_launches[name]} if name in serve_launches else {}),
            **({"launches_serve_phase_rpc": serve_rpc_launches[name]}
               if name in serve_rpc_launches else {}),
            **({"launches_serve_phase_grpc": serve_grpc_launches[name]}
               if name in serve_grpc_launches else {}),
            **({"launches_serve_disagg_phase": serve_disagg_launches[name]}
               if name in serve_disagg_launches else {}),
            **({"launches_serve_disagg_autoscale": serve_disagg_autoscale_launches[name]}
               if name in serve_disagg_autoscale_launches else {}),
            **({"launches_data_phase": data_launches[name]} if name in data_launches else {}),
            **({"launches_data_feed_phase": feed_launches[name]} if name in feed_launches else {}),
            **({"launches_disagg_phase": disagg_launches[name]}
               if name in disagg_launches else {}),
            **({"launches_disagg_device_leg": disagg_device_launches[name]}
               if name in disagg_device_launches else {}),
            **({"launches_kvtier_phase": kvtier_launches[name]}
               if name in kvtier_launches else {}),
            "launches_publish_phase": publish_launches[name],
            "launches_fleet_phase": fleet_launches.get(name, 0),
            **({"launches_process_phase": process_launches[name]}
               if name in process_launches else {}),
            **({"launches_cluster_phase": cluster_launches[name]}
               if name in cluster_launches else {}),
            **({"launches_cluster_phase_serve": cluster_serve_launches[name]}
               if name in cluster_serve_launches else {}),
            **({"launches_cluster_phase_dag": cluster_dag_launches[name]}
               if name in cluster_dag_launches else {}),
            **({"launches_cluster_ha_phase": cluster_ha_launches[name]}
               if name in cluster_ha_launches else {}),
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
