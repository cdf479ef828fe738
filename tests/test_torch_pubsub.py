"""The port's GCS pubsub push tier: long-poll event feed + blocking
kv_wait (the 4 cases of ``tests/test_pubsub.py`` on
``ray_tpu_torch.cluster.gcs_service``, to those tests' expectations).

Reference analog: GCS pubsub delivers table updates to subscribers by
parking their long-poll channels (src/ray/pubsub/publisher.h); here
`events_since(wait=...)` and `kv_wait` park the handler thread on a
condition variable that every emit/put notifies.
"""

import threading
import time

import pytest

from ray_tpu_torch.cluster.gcs_service import GcsService

pytestmark = pytest.mark.torch_port


def test_events_long_poll_wakes_on_emit():
    gcs = GcsService()
    got = {}

    def poll():
        t0 = time.monotonic()
        out = gcs.rpc_events_since({"cursor": 0, "wait": 10.0}, None)
        got["latency"] = time.monotonic() - t0
        got["events"] = out["events"]

    t = threading.Thread(target=poll)
    t.start()
    time.sleep(0.2)  # ensure the poller is parked
    gcs.rpc_register_node(
        {"node_id": "n0", "addr": ("127.0.0.1", 1), "resources": {}}, None
    )
    t.join(timeout=5)
    assert not t.is_alive()
    # woke promptly on the push, not at the 10s budget
    assert got["latency"] < 5.0
    assert any(e[1] == "node_added" for e in got["events"])


def test_events_long_poll_timeout_returns_empty():
    gcs = GcsService()
    t0 = time.monotonic()
    out = gcs.rpc_events_since({"cursor": 0, "wait": 0.2}, None)
    assert out["events"] == []
    assert 0.15 <= time.monotonic() - t0 < 2.0


def test_kv_wait_blocks_until_put():
    gcs = GcsService()
    got = {}

    def wait():
        got["value"] = gcs.rpc_kv_wait({"ns": "t", "key": b"k", "wait": 5.0}, None)

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.2)
    gcs.rpc_kv_put({"ns": "t", "key": b"k", "value": b"v"}, None)
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["value"] == b"v"


def test_kv_wait_timeout_none():
    gcs = GcsService()
    assert gcs.rpc_kv_wait({"ns": "t", "key": b"absent", "wait": 0.1}, None) is None
