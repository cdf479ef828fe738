"""Learner -> rollout weight publishing over the device transfer plane
(counterpart of ``ray_tpu/train/weight_sync.py``).

The second client of ``fabric.transport.send_arrays`` (the first is the
disaggregated KV handoff). ``WeightPublisher`` (learner side) flattens a
params tree and ships its leaves as one versioned, sealed bundle per
rollout endpoint; ``WeightSubscriber`` (rollout side) polls its endpoint
between generation rounds, verifies the bundle's device checksum and
writes the newest version into the serving engine's weights. Versions are
monotonic: an older publish that lands after a newer one is dropped, never
applied backwards.

Where the port differs from the reference, and why:

 * **The swap writes in place.** The reference rebinds ``engine.params``
   (its programs take the weights as jit arguments). The port's decode,
   mixed and verify programs are CUDA graphs that read the weight tensors
   by address, so a rebind would leave every replay serving the old
   weights. ``LLMEngine.write_params`` copies each leaf into the engine's
   existing tensor, on the stream the chunks run on, after checking every
   leaf's count, shape and dtype class (a mismatch writes nothing).
 * **The engine holds the compute dtype.** A publish of fp32 learner
   params to a bf16 engine is cast in the copy; identity checks compare
   the engine's bytes with the published leaf cast to the engine's dtype
   (``params_bitwise_equal``, the one rule every gate uses).
 * **Tensors are mutable.** On one device the transport delivers the
   sender's own tensors (``tensor.to(device)`` returns them), and the
   publisher keeps its latest tree by reference, as the reference does (no
   copy, so an 8B fleet fits). A learner that goes on training the
   published tensors in place would have the subscriber apply a
   half-updated tree. So the publisher records each leaf's storage and
   in-place version counter at send, and the subscriber refuses, and
   counts, a bundle whose delivered leaves were written after the send:
   once while it drains the endpoint, again right before the copy, and
   once more after the copy has landed (a write that raced the copy leaves
   the engine holding a mixed tree, and the apply raises). Publish a
   ``snapshot(params)`` to keep training while the bundle is in flight.

Leaf order is ``llama.sorted_leaves``: the dicts' keys sorted, which is
``jax.tree_util.tree_leaves``' order, so leaf i of a port bundle is leaf i
of the reference's for the same params. The subscriber writes the leaves
against the receiving engine's own tree; the structure never crosses.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch.fabric.transport import DeviceTransport, FabricTransferError
from ray_tpu_torch.models.llama import sorted_leaves

logger = logging.getLogger("ray_tpu_torch.train.weight_sync")


class WeightSyncError(Exception):
    """A publish failed, arrived corrupt, or doesn't match the
    subscriber's params structure."""


def _leaf_key(i: int) -> str:
    return f"w{i:05d}"  # fixed width: sorted() order == leaf order


def _as_tensor(leaf) -> torch.Tensor:
    # detach() shares the storage and the in-place write counter
    return leaf.detach() if torch.is_tensor(leaf) else torch.from_numpy(np.ascontiguousarray(leaf))


def tree_leaves(params: Any) -> list:
    """A params tree's leaves as tensors, in the weight plane's order
    (``llama.sorted_leaves``); a list is taken as leaves already."""
    leaves = params if isinstance(params, (list, tuple)) else sorted_leaves(params)
    return [_as_tensor(x) for x in leaves]


def snapshot(params: Mapping) -> dict:
    """A detached copy of a params tree, on the tensors' own device: what a
    learner publishes to keep training while the bundle is in flight."""
    return {k: (snapshot(v) if isinstance(v, Mapping) else v.detach().clone())
            for k, v in params.items()}


def params_bitwise_equal(reference: Any, served: Any) -> bool:
    """Leaf-by-leaf bytes equality of two params trees, the first cast to
    each leaf's dtype in the second (the engine's): the identity check is
    on the exact bytes the engine serves, not an allclose (the identity
    cast when the dtypes agree). Every gate of the weight plane uses it."""
    la, lb = tree_leaves(reference), tree_leaves(served)
    if len(la) != len(lb):
        return False
    return all(
        tuple(x.shape) == tuple(y.shape) and torch.equal(x.to(device=y.device, dtype=y.dtype), y)
        for x, y in zip(la, lb)
    )


def _storage_key(t: torch.Tensor) -> tuple:
    return (str(t.device), t.data_ptr())


class WeightPublisher:
    """Learner-side: publish a params tree to rollout endpoints."""

    def __init__(self, transport: Optional[DeviceTransport] = None,
                 namespace: str = "weights", devices: Optional[list] = None):
        # owns the transport iff it constructed it: close() then removes the
        # registered endpoints from the process-global plane (each queue can
        # pin up to endpoint_capacity params trees on the device). With no
        # transport and no ``devices`` the CUDA devices are used
        self._owns_transport = transport is None
        self.transport = transport or DeviceTransport(namespace=namespace, devices=devices)
        self._version = 0
        self.num_published = 0
        # the newest published tree, BY REFERENCE, for late joiners
        # (publish_latest, the cold start): never mutate a published tree
        # in place (publish a snapshot)
        self._latest_params: Any = None

    def register_rollout(self, endpoint_id: str, device: Any = None) -> tuple:
        """Bind one rollout engine's receive endpoint (pass the engine's
        cache device so the put lands where generation reads)."""
        return self.transport.register_endpoint(endpoint_id, device=device)

    def publish(self, params: Any, targets: list, version: Optional[int] = None,
                timeout_s: float = 30.0) -> int:
        """Ship ``params`` to every target as one sealed device bundle;
        returns the published version (monotonic when auto-assigned)."""
        leaves = tree_leaves(params)
        if version is None:
            self._version += 1
            version = self._version
        else:
            self._version = max(self._version, int(version))
        arrays = {_leaf_key(i): leaf for i, leaf in enumerate(leaves)}
        # the aliasing guard: where each leaf lives and its in-place write
        # count now; a delivered leaf at the same storage with another count
        # was written after the send
        written = [(*_storage_key(t), t._version) for t in leaves]
        meta = {"version": int(version), "num_leaves": len(leaves), "leaf_writes": written}
        for target in targets:
            try:
                self.transport.send_arrays(target, arrays, meta=meta, timeout_s=timeout_s,
                                           bundle_id=f"weights-v{version}")
            except FabricTransferError as e:
                raise WeightSyncError(f"weight publish v{version} to {target!r} failed: {e}") from e
        self.num_published += 1
        self._latest_params = params
        return int(version)

    @property
    def latest_version(self) -> int:
        return self._version

    def publish_latest(self, target, timeout_s: float = 30.0) -> int:
        """Re-publish the most recent tree to ONE late-joining endpoint at
        the SAME version (a cold-started replica catching up). Raises
        WeightSyncError before any publish has happened."""
        if self._latest_params is None:
            raise WeightSyncError(
                "publish_latest: no publish retained yet — nothing to stream to a late joiner"
            )
        return self.publish(self._latest_params, [target], version=self._version,
                            timeout_s=timeout_s)

    def close(self) -> None:
        if self._owns_transport:
            self.transport.close()


def _senders_leaves(bundle) -> list:
    """(delivered leaf, its write count at send) for every leaf that is the
    sender's own tensor (the same storage). A leaf the transport copied to
    another device is the receiver's alone, and is left out."""
    writes = bundle.meta.get("leaf_writes") or []
    out = []
    for key, (dev, ptr, count) in zip(sorted(bundle.arrays), writes):
        t = bundle.arrays[key]
        if _storage_key(t) == (dev, ptr):
            out.append((t, count))
    return out


def _written_after_send(bundle) -> bool:
    """True when a leaf the sender still holds was written in place after
    the send."""
    return any(t._version != count for t, count in _senders_leaves(bundle))


def _leaves(bundle) -> list:
    return [bundle.arrays[k] for k in sorted(bundle.arrays)]


class WeightSubscriber:
    """Rollout-side: poll for publishes, apply the newest to an engine."""

    def __init__(self, transport: DeviceTransport, endpoint_id: str):
        self.transport = transport
        self.endpoint_id = endpoint_id
        self.version = 0          # newest applied (or held) version
        self.num_applied = 0
        self.num_stale_dropped = 0
        self.num_corrupt_dropped = 0
        # bundles refused because the learner wrote their leaves after the send
        self.num_mutated_dropped = 0

    def _refuse_written(self, bundle, when: str) -> bool:
        """Count and log a bundle whose leaves were written after the send."""
        if not _written_after_send(bundle):
            return False
        self.num_mutated_dropped += 1
        logger.warning("dropping weight bundle %r: its leaves were written after the send, "
                       "%s (publish a snapshot)", bundle.bundle_id, when)
        return True

    def _poll_bundle(self, timeout_s: float):
        """Drain the endpoint; the newest verified bundle newer than
        anything seen, or None."""
        newest = None
        while True:
            b = self.transport.recv_arrays(self.endpoint_id, timeout_s=timeout_s)
            if b is None:
                break
            timeout_s = 0.0  # only the first wait blocks; then drain
            if self._refuse_written(b, "found on receipt"):
                continue
            if not b.verify():
                self.num_corrupt_dropped += 1
                logger.warning("dropping corrupt weight bundle %r", b.bundle_id)
                continue
            v = int(b.meta.get("version", 0))
            if v <= self.version or (newest and v <= int(newest.meta["version"])):
                self.num_stale_dropped += 1
                continue
            if len(b.arrays) != int(b.meta.get("num_leaves", len(b.arrays))):
                self.num_corrupt_dropped += 1
                continue
            newest = b
        return newest

    def poll(self, timeout_s: float = 0.05):
        """Drain the endpoint; returns the newest verified (version, leaves)
        newer than anything seen, or None. Corrupt bundles, and bundles
        whose leaves were written after the send, are counted and dropped
        (the learner's next publish supersedes)."""
        b = self._poll_bundle(timeout_s)
        return None if b is None else (int(b.meta["version"]), _leaves(b))

    def apply_to_engine(self, engine: Any, timeout_s: float = 0.05) -> Optional[int]:
        """Poll and, if a newer version arrived, write it into the engine's
        weights in place (``LLMEngine.write_params``), drop its prefix cache
        in every tier and set ``engine.weight_version``. Returns the applied
        version or None. Call between two steps, on the thread that steps
        the engine (``_EngineRunner.call`` for a served engine).

        A bundle whose leaves the learner wrote after the send is refused
        (None, counted in ``num_mutated_dropped``) when the write is seen
        right before the copy, the engine untouched. A write seen once the
        copy has landed means the engine may hold a mix of two trees: it is
        counted, the prefix cache dropped, the version left as it was, and
        ``WeightSyncError`` raised; the next publish rewrites every leaf."""
        b = self._poll_bundle(timeout_s)
        if b is None:
            return None
        version, leaves = int(b.meta["version"]), _leaves(b)
        if self._refuse_written(b, "before the copy"):
            return None
        try:
            engine.write_params(leaves)
        except ValueError as e:
            raise WeightSyncError(
                f"weight bundle v{version} does not fit the rollout engine: {e} — "
                "publisher and rollout engine disagree on architecture"
            ) from e
        # sealed prefix K/V was computed with the OLD weights: a hit after
        # the swap would splice stale keys and values into new-weight
        # attention. Running requests keep their own blocks; the drop
        # cascades through every tier
        engine.drop_prefix_cache()
        shared = _senders_leaves(b)
        # the copies run on the engine's stream: only once they have landed
        # does an unchanged write count vouch for the bytes they read
        for dev in {t.device for t, _ in shared if t.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        if self._refuse_written(b, "while it was copied"):
            raise WeightSyncError(
                f"weight bundle v{version} was written by the learner while it was copied "
                f"into the engine, which may now hold a mix of two trees (still reporting "
                f"v{self.version}); publish a snapshot"
            )
        self.version = version
        self.num_applied += 1
        engine.weight_version = int(version)
        return version

    def stats(self) -> dict:
        return {
            "endpoint": self.endpoint_id,
            "version": self.version,
            "num_applied": self.num_applied,
            "num_stale_dropped": self.num_stale_dropped,
            "num_corrupt_dropped": self.num_corrupt_dropped,
            "num_mutated_dropped": self.num_mutated_dropped,
        }

    def close(self) -> None:
        """Drop any queued bundles; the transport (publisher-owned) outlives
        the subscriber, so only the backlog is drained here."""
        try:
            while self.transport.recv_arrays(self.endpoint_id, timeout_s=0.0) is not None:
                pass
        except FabricTransferError:
            pass  # endpoint already gone (publisher closed first)
