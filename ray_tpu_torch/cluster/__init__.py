"""Distributed runtime: GCS service, node daemons, workers, driver client
(counterpart of ``ray_tpu/cluster``).

The multi-process control plane (reference: src/ray/gcs + src/ray/raylet
+ src/ray/core_worker split across processes). The single-process
runtime in ``ray_tpu_torch.core`` stays the fast path of the process that
owns the card; this package is the cross-process / cross-host tier, and
``ray_tpu_torch.init(address=...)`` attaches the public API to it. A
``num_gpus`` lease runs in a worker pinned to the cards of the node that
holds it. The GCS may run with a warm standby that promotes when the
primary dies (``cluster/ha.py``, ``LocalCluster(standby=True)``), and it
aggregates the cluster's telemetry (``obs/telemetry.py``). Also here: the
KV prefix index table the GCS hosts and the frame RPC under the transfer
planes. Serve, Datasets (with their exchanges' merges placed on the nodes
that hold the data) and ``fabric.build_fabric`` run on it unchanged.
"""

import importlib

# name -> module; loaded at first use, so ``python -m
# ray_tpu_torch.cluster.gcs_service`` (or ``.node_daemon``) does not import
# its own module twice through this package
_EXPORTS = {
    "ActorDiedError": "client",
    "ClusterActorHandle": "client",
    "ClusterClient": "client",
    "ClusterObjectRef": "client",
    "ClusterTaskError": "client",
    "GetTimeoutError": "client",
    "LocalCluster": "cluster",
    "GcsServer": "gcs_service",
    "GcsService": "gcs_service",
    "NodeDaemon": "node_daemon",
    "ClientPool": "rpc",
    "RemoteError": "rpc",
    "RpcClient": "rpc",
    "RpcError": "rpc",
    "RpcServer": "rpc",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
