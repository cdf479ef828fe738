"""`status` — one-look cluster health from ONE GCS query (counterpart of
the repo's ``scripts/ray_tpu_status.py``, which drives the JAX package).

Prints nodes (liveness, resources, telemetry staleness), serve pools
(role-tagged replica counts), fleet utilization (KV-page occupancy, HBM
bytes, queue depth, KV-transfer bytes/s, spec-decode acceptance), and
per-model-tag SLO grades computed from the GCS-merged TTFT/TPOT/
queue-wait histograms (ray_tpu_torch.obs.telemetry).

Usage:
    python -m ray_tpu_torch.scripts.status --gcs HOST:PORT [--json]
        [--ttft S] [--tpot S] [--queue-wait S]

The whole report comes from the single ``telemetry_status`` RPC — the
CLI works against any live GCS, including one whose nodes are partitioned
(they show up as stale, not absent).
"""

from __future__ import annotations

import argparse
import json
import sys


def fetch_status(gcs: str, thresholds=None, timeout: float = 10.0) -> dict:
    from ray_tpu_torch.cluster.rpc import RpcClient

    host, port = gcs.rsplit(":", 1)
    client = RpcClient(host, int(port), timeout=timeout).connect(retries=2)
    try:
        return client.call(
            "telemetry_status",
            {"thresholds": thresholds} if thresholds else {},
            timeout=timeout,
        )
    finally:
        client.close()


def render_status(gcs: str, thresholds=None) -> str:
    from ray_tpu_torch.obs.telemetry import format_status

    return format_status(fetch_status(gcs, thresholds))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gcs", required=True, help="GCS address host:port")
    p.add_argument("--json", action="store_true",
                   help="dump the raw status payload instead of the table")
    p.add_argument("--ttft", type=float, default=None,
                   help="green TTFT threshold (s) at the SLO percentile")
    p.add_argument("--tpot", type=float, default=None,
                   help="green TPOT threshold (s)")
    p.add_argument("--queue-wait", type=float, default=None,
                   help="green queue-wait threshold (s)")
    p.add_argument("--percentile", type=float, default=None,
                   help="SLO percentile (default 95)")
    args = p.parse_args(argv)
    thresholds = {}
    if args.ttft is not None:
        thresholds["ttft_p_s"] = args.ttft
    if args.tpot is not None:
        thresholds["tpot_p_s"] = args.tpot
    if args.queue_wait is not None:
        thresholds["queue_wait_p_s"] = args.queue_wait
    if args.percentile is not None:
        thresholds["percentile"] = args.percentile
    try:
        report = fetch_status(args.gcs, thresholds or None)
    except Exception as e:  # noqa: BLE001 — CLI surface
        print(f"ray_tpu_torch status: cannot reach GCS at {args.gcs}: {e}",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report, indent=2, default=str))
        return 0
    from ray_tpu_torch.obs.telemetry import format_status

    print(format_status(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
