"""Device-direct tensor transfer plane: ``send_arrays`` / ``recv_arrays``
(counterpart of ``ray_tpu/fabric/transport.py``).

Named tensors move between registered **device endpoints** without being
staged through host memory. ``tensor.to(device)`` is the transfer
primitive: a no-op when the endpoint is the tensor's own device (the
one-card deployment, where prefill and decode engines share the H100 and
the handoff crosses by reference), a device-to-device copy between two
cards of one host. The API is the same either way, so the tests on the
CPU run the code path the card runs.

The KV handoff of disaggregated serving is the client in this package
(``fabric.device_connector.DeviceKVConnector`` ships ``k_pages`` /
``v_pages``); the device fetch client of the fetch plane is the other
(``llm/kvfetch/plane.py``).

Integrity: a bundle is sealed with a checksum reduced **on the tensors'
own device** (``device_checksum``: the bytes read as unsigned lanes of
the element's width, widened and summed mod 2^32), so sealing a 201 MB
handoff costs one reduction and a 4-byte read, not a copy to the host.
The sum is the reference's for the same bytes, so a bundle sealed by one
package verifies in the other. ``ArrayBundle.verify()`` reduces again
where the bundle arrives; a transfer that flips bits in flight is caught
there and handled as a lost transfer.

Chaos: every send passes the ``disagg.kv_transfer`` hook site (shared
with the host-path connectors, so one schedule targets the whole transfer
plane) with the device kinds: ``DROP_DEVICE_TRANSFER`` raises
``FabricTransferError`` before the move, ``CORRUPT_DEVICE_TRANSFER``
flips bits of the pages on the device without re-sealing (the receiver's
verify catches it), ``DELAY_RPC`` sleeps.

Streams: the moved tensors are enqueued by reference. A sealed payload's
checksum read (``.item()``) has completed every kernel that wrote it on
the sender's stream before it is enqueued; a consumer on another stream
records its own stream on the tensors it reads (``LLMEngine.import_handoff``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import zlib
from typing import Any, Optional

import torch

from ray_tpu_torch.chaos import harness as _chaos


class FabricTransferError(Exception):
    """A tensor transfer was dropped, timed out, or arrived corrupt.
    Callers re-send or re-derive from the source, never decode from it."""


# -- device-side integrity ----------------------------------------------------

# the signed lane of each element width (torch has no uint16/uint32
# arithmetic on CUDA), and the mask that reads it as unsigned. 8-byte
# elements are summed as two 32-bit halves, as the reference does.
_LANES = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF),
          4: (torch.int32, 0xFFFFFFFF), 8: (torch.int32, 0xFFFFFFFF)}
# lanes widened at once: bounds the int64 temporary at 128 MiB
_SLICE = 1 << 24


def _lanes(t: torch.Tensor) -> tuple:
    """A tensor's bytes as a flat view of its same-width lanes (8-byte
    elements as twice as many 32-bit lanes), and the unsigned mask."""
    dtype, mask = _LANES[t.element_size()]
    return t.contiguous().reshape(-1).view(dtype), mask


def device_checksum(t) -> int:
    """Order-independent modular checksum reduced ON the tensor's device:
    every lane read as unsigned, widened, summed mod 2^32. Only the 4-byte
    result crosses to the host. Deterministic (an integer reduction) and
    equal to ``ray_tpu.fabric.transport.device_checksum`` for the same
    bytes. Accepts a numpy array too (reduced on the CPU)."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    if t.numel() == 0:
        return 0
    flat, mask = _lanes(t)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for i in range(0, flat.numel(), _SLICE):
        w = flat[i:i + _SLICE].to(torch.int64)
        total += w.bitwise_and_(mask).sum()
    return int(total.item()) & 0xFFFFFFFF


def corrupt_on_device(t: torch.Tensor) -> torch.Tensor:
    """Deterministic bit flip on the tensor's device (CORRUPT_DEVICE_TRANSFER):
    invert up to 16 lanes in the middle of the flattened tensor, in a NEW
    tensor (copy-on-corrupt: the sender's copy stays intact, as on a torn
    wire)."""
    if t.numel() == 0:
        return t
    out = t.contiguous().clone()
    flat, _mask = _lanes(out)  # a view of ``out``: flipping it flips ``out``
    mid = flat.numel() // 2
    span = max(1, min(16, flat.numel() - mid))
    flat[mid:mid + span].bitwise_not_()
    return out


@dataclasses.dataclass
class ArrayBundle:
    """One named set of tensors in flight between endpoints. ``arrays``
    values are device tensors on the device path (CPU tensors too:
    ``seal`` / ``verify`` reduce wherever the data lives). ``meta`` is a
    small host-side dict that rides along (versions, request ids, token
    lists, never bulk data)."""

    bundle_id: str
    arrays: dict
    meta: dict = dataclasses.field(default_factory=dict)
    checksum: int = 0

    def _sum(self) -> int:
        # a CHAINED CRC over (name, per-tensor device sum) pairs: it binds
        # each sum to its name, so two same-shape tensors delivered with
        # their contents swapped fail (a commutative fold would pass); only
        # the 4-byte sums cross to the host
        crc = 0
        for name in sorted(self.arrays):
            crc = zlib.crc32(name.encode(), crc)
            crc = zlib.crc32(device_checksum(self.arrays[name]).to_bytes(4, "big"), crc)
        return crc & 0xFFFFFFFF

    def seal(self) -> "ArrayBundle":
        self.checksum = self._sum()
        return self

    def verify(self) -> bool:
        return self.checksum == self._sum()

    @property
    def nbytes(self) -> int:
        return int(sum(getattr(a, "nbytes", 0) for a in self.arrays.values()))


# process-global endpoint queues and device map, namespaced like the
# in-process KV connector's: two fabrics in one process never cross-deliver,
# and a sender-side transport instance resolves an endpoint registered by
# another instance through the shared map (the device pin travels with the
# endpoint, not the instance)
_ENDPOINT_LOCK = threading.Lock()
_ENDPOINT_QUEUES: dict[tuple, "queue.Queue[ArrayBundle]"] = {}
_ENDPOINT_DEVICES: dict[tuple, Any] = {}


def _default_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceTransport:
    """``send_arrays`` / ``recv_arrays`` over device placement.

    ``register_endpoint`` binds an endpoint id to a torch device (callers
    pass the device their consumer computes on, e.g. the decode engine's
    KV-cache device, or let the transport take the visible devices in
    turn). ``send_arrays`` moves every tensor onto the target's device and
    enqueues only references: nothing is serialized and no host staging
    buffer exists on this path. With no ``devices`` given the transport
    uses the visible CUDA devices and raises when there are none; it uses
    the CPU only where the caller passes it.
    """

    name = "device"

    def __init__(self, namespace: str = "default", devices: Optional[list] = None,
                 endpoint_capacity: int = 64):
        self.namespace = namespace
        self._devices = [torch.device(d) for d in devices] if devices is not None \
            else _default_devices()
        if not self._devices:
            raise FabricTransferError(
                "no CUDA devices visible to the transport (pass devices= to use others)"
            )
        # bounded endpoints: every queued bundle pins device memory, so a
        # receiver that stopped draining fails the SENDER after timeout_s
        # instead of growing until the device runs out of memory
        self.endpoint_capacity = int(endpoint_capacity)
        self._lock = threading.Lock()
        self._endpoints: dict[str, Any] = {}  # endpoint_id -> device
        self._rr = 0
        self.num_sent = 0
        self.num_received = 0
        self.num_dropped = 0
        self.bytes_sent = 0

    def _count(self, **deltas) -> None:
        # senders and receivers count from several threads
        with self._lock:
            for name, n in deltas.items():
                setattr(self, name, getattr(self, name) + n)

    # -- endpoints ------------------------------------------------------------

    def register_endpoint(self, endpoint_id: str, device: Any = None) -> tuple:
        """Create the receive side of ``endpoint_id`` pinned to ``device``
        (the transport's devices in turn when omitted); returns the opaque
        target token ``send_arrays`` addresses."""
        with self._lock:
            if device is None:
                device = self._devices[self._rr % len(self._devices)]
                self._rr += 1
            device = torch.device(device)
            self._endpoints[endpoint_id] = device
        with _ENDPOINT_LOCK:
            _ENDPOINT_QUEUES.setdefault((self.namespace, endpoint_id),
                                        queue.Queue(maxsize=self.endpoint_capacity))
            _ENDPOINT_DEVICES[(self.namespace, endpoint_id)] = device
        return (self.namespace, endpoint_id)

    def endpoint_device(self, endpoint_id: str):
        with self._lock:
            dev = self._endpoints.get(endpoint_id)
        if dev is not None:
            return dev
        with _ENDPOINT_LOCK:
            return _ENDPOINT_DEVICES.get((self.namespace, endpoint_id))

    def _queue(self, endpoint_id: str) -> "queue.Queue[ArrayBundle]":
        with _ENDPOINT_LOCK:
            q = _ENDPOINT_QUEUES.get((self.namespace, endpoint_id))
        if q is None:
            raise FabricTransferError(
                f"unknown fabric endpoint {endpoint_id!r} in namespace "
                f"{self.namespace!r} (register_endpoint first)"
            )
        return q

    # -- transfer -------------------------------------------------------------

    def send_arrays(self, target: tuple, arrays: dict, meta: Optional[dict] = None,
                    timeout_s: float = 30.0, bundle_id: str = "", seal: bool = True) -> None:
        """Move ``arrays`` (name -> tensor) onto the target endpoint's device
        and deliver them as one ``ArrayBundle``. Raises FabricTransferError on
        a dropped transfer (chaos, an unknown endpoint, or an endpoint whose
        backlog stayed full past ``timeout_s``). ``seal=False`` when the
        payload carries its OWN integrity (the KV connector's device-sealed
        handoff): it saves a reduction per tensor, and the consumer then
        verifies the payload, not the bundle."""
        # the token names the endpoint's own namespace (normally this
        # instance's; a token from another transport addresses fine)
        ns, endpoint_id = target
        if not bundle_id:
            with self._lock:
                bundle_id = f"{endpoint_id}-{self.num_sent}"
        bundle = ArrayBundle(bundle_id=bundle_id,
                             arrays=dict(arrays), meta=dict(meta or {}))
        if seal:
            bundle.seal()
        if _chaos.ACTIVE is not None:
            for f in _chaos.fire(
                "disagg.kv_transfer",
                kinds=(_chaos.DROP_DEVICE_TRANSFER, _chaos.CORRUPT_DEVICE_TRANSFER,
                       _chaos.DELAY_RPC),
                bundle_id=bundle.bundle_id, connector=self.name, target=endpoint_id,
            ):
                if f.kind == _chaos.DROP_DEVICE_TRANSFER:
                    self._count(num_dropped=1)
                    raise FabricTransferError(
                        f"chaos: dropped device transfer of {bundle.bundle_id!r} to {endpoint_id}"
                    )
                if f.kind == _chaos.DELAY_RPC:
                    time.sleep(f.delay_s)
                if f.kind == _chaos.CORRUPT_DEVICE_TRANSFER:
                    # NOT re-sealed: the receiver's verify catches it
                    first = min(bundle.arrays)
                    bundle = dataclasses.replace(bundle, arrays={
                        name: corrupt_on_device(a) if name == first else a
                        for name, a in bundle.arrays.items()
                    })
        with _ENDPOINT_LOCK:
            q = _ENDPOINT_QUEUES.get((ns, endpoint_id))
            device = _ENDPOINT_DEVICES.get((ns, endpoint_id))
        if q is None:
            raise FabricTransferError(
                f"unknown fabric endpoint {endpoint_id!r} in namespace {ns!r} "
                "(register_endpoint first)"
            )
        if device is not None:
            bundle.arrays = {name: a.to(device) for name, a in bundle.arrays.items()}
        try:
            q.put(bundle, timeout=timeout_s)
        except queue.Full:
            self._count(num_dropped=1)
            raise FabricTransferError(
                f"endpoint {endpoint_id!r} backlog full ({self.endpoint_capacity} bundles) "
                f"for {timeout_s}s: the consumer stopped draining"
            ) from None
        self._count(num_sent=1, bytes_sent=bundle.nbytes)

    def recv_arrays(self, endpoint_id: str, timeout_s: float = 0.1) -> Optional[ArrayBundle]:
        """Bounded receive; None when nothing arrived within the timeout
        (callers poll: the transfer plane never parks a consumer loop)."""
        try:
            b = self._queue(endpoint_id).get(timeout=timeout_s)
        except queue.Empty:
            return None
        self._count(num_received=1)
        return b

    def close(self) -> None:
        with self._lock:
            eids = list(self._endpoints)
            self._endpoints.clear()
        with _ENDPOINT_LOCK:
            for eid in eids:
                _ENDPOINT_QUEUES.pop((self.namespace, eid), None)
                _ENDPOINT_DEVICES.pop((self.namespace, eid), None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "transport": self.name,
                "namespace": self.namespace,
                "num_sent": self.num_sent,
                "num_received": self.num_received,
                "num_dropped": self.num_dropped,
                "bytes_sent": self.bytes_sent,
            }
