"""Standalone dashboard process for cluster deployments (counterpart of
``ray_tpu/dashboard/__main__.py``).

`python -m ray_tpu_torch.dashboard --gcs HOST:PORT [--host H] [--port P]`

Reference analog: the dashboard head process `ray start` boots next to the
GCS (python/ray/dashboard/dashboard.py). The CLI's head mode spawns this
when --dashboard-port is given; the k8s head manifest uses it so the
Service's 8265 port has a real listener behind it. ``--port 0`` binds an
ephemeral port; the banner ``DASHBOARD_ADDRESS host:port`` names the bound
one. SIGTERM shuts the server down and exits.
"""

from __future__ import annotations

import argparse
import signal
import threading


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--gcs", required=True, help="GCS address HOST:PORT")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8265)
    args = p.parse_args()

    from ray_tpu_torch.dashboard import Dashboard

    dash = Dashboard(host=args.host, port=args.port, gcs_address=args.gcs)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"DASHBOARD_ADDRESS {args.host}:{dash.port}", flush=True)
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    dash.shutdown()


if __name__ == "__main__":
    main()
