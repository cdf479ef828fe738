"""DeviceKVConnector: the third KV-transfer backend (counterpart of
``ray_tpu/fabric/device_connector.py``).

Implements the ``llm/disagg/connector.KVConnector`` contract:
``register_target`` binds a decode engine to a **device endpoint** (the
device its paged KV cache lives on), and ``send`` moves ``k_pages`` /
``v_pages`` as device tensors through ``fabric.transport.DeviceTransport``.
On one card the endpoint is the pages' own device, so the handoff crosses
by reference: the pages are never pickled, framed or staged through host
memory. Only the small header (token ids, seed base, timestamps, the
stage timings) rides the bundle's ``meta``.

Failure modes are the host-path connectors': a dropped transfer raises
``KVTransferError`` at the sender (chaos: ``DROP_DEVICE_TRANSFER``), a
corrupt one arrives with a failing device checksum and is caught by
``KVHandoff.verify()`` where it is received (chaos:
``CORRUPT_DEVICE_TRANSFER``). The orchestrator answers both with its
budgeted re-prefill, the faulted edge degraded to its RPC fallback
(``fabric/topology.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ray_tpu_torch.fabric.transport import ArrayBundle, DeviceTransport, FabricTransferError
from ray_tpu_torch.llm.disagg.connector import KVConnector, KVTransferError
from ray_tpu_torch.llm.disagg.handoff import KVHandoff

# the KVHandoff fields that ride the bundle meta: every field but the pages
_META_FIELDS = tuple(f.name for f in dataclasses.fields(KVHandoff)
                     if f.name not in ("k_pages", "v_pages"))


class DeviceKVConnector(KVConnector):
    """KV handoffs as device-tensor bundles over the fabric transport."""

    name = "device"

    def __init__(self, namespace: str = "default", transport: Optional[DeviceTransport] = None):
        super().__init__()
        self.transport = transport or DeviceTransport(namespace=namespace)
        self.namespace = self.transport.namespace

    def register_target(self, target_id: str, device: Any = None) -> tuple:
        """Bind ``target_id`` to a device endpoint. Pass the decode engine's
        KV-cache device, so the transfer lands where the import's scatter
        reads it (on the pages' own device the move is a no-op)."""
        return self.transport.register_endpoint(target_id, device=device)

    def send(self, target: tuple, handoff: KVHandoff, timeout_s: float = 30.0) -> None:
        """Ship one handoff: pages as device tensors, the header as meta. A
        host-sealed handoff is sealed again on its pages' device here (one
        more pair of reductions), so the receiver verifies on the device."""
        if handoff.checksum_kind != "device_u32":
            handoff = dataclasses.replace(handoff, timings=dict(handoff.timings)).seal(device=True)
        meta = {f: getattr(handoff, f) for f in _META_FIELDS}
        try:
            # seal=False: the handoff's own device checksum (in the meta,
            # verified where it arrives) is the integrity gate; a bundle seal
            # would reduce both page tensors again for nothing
            self.transport.send_arrays(
                target, {"k_pages": handoff.k_pages, "v_pages": handoff.v_pages},
                meta=meta, timeout_s=timeout_s, bundle_id=handoff.request_id, seal=False,
            )
        except FabricTransferError as e:
            self._count(num_dropped=1)
            raise KVTransferError(f"device transfer of {handoff.request_id!r} failed: {e}") from e
        self._count(num_sent=1, bytes_sent=handoff.nbytes)

    def recv(self, target_id: str, timeout_s: float = 0.1) -> Optional[KVHandoff]:
        b = self.transport.recv_arrays(target_id, timeout_s=timeout_s)
        if b is None:
            return None
        self._count(num_received=1)
        return self._to_handoff(b)

    @staticmethod
    def _to_handoff(bundle: ArrayBundle) -> KVHandoff:
        """Reassemble the KVHandoff. Its ``checksum`` (sealed on the sender
        over the pages and the token ids) rides the meta, so ``verify()``
        where it arrives checks the same device sums."""
        kw = dict(bundle.meta)
        kw["k_pages"] = bundle.arrays["k_pages"]
        kw["v_pages"] = bundle.arrays["v_pages"]
        return KVHandoff(**kw)

    def close(self) -> None:
        self.transport.close()

    def stats(self) -> dict:
        s = super().stats()
        s["transport"] = self.transport.stats()
        return s
