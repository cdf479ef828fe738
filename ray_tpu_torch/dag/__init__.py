"""ray_tpu_torch.dag: compiled static graphs of actor method calls
(counterpart of ``ray_tpu/dag``).

A DAG of actor-method calls (``actor.method.bind(...)``) is compiled once
into per-actor execution loops wired with reusable channels, so each
``execute()`` is one write to the input channel and no task submission.
Channels carry host objects: in one process they are queue-backed
(``channels.py``); between cluster worker processes on one host they are
rings in a shared-memory store (``shm_channel.py``), across hosts TCP
streams (``socket_channel.py``). A CUDA tensor that crosses a process
boundary goes through the port's serialization, by value through host
memory, and is rebuilt on the reader's card.
"""

from ray_tpu_torch.dag.channels import Channel, ChannelClosedError
from ray_tpu_torch.dag.compiled import CompiledDAG, CompiledDAGRef
from ray_tpu_torch.dag.nodes import (
    ClassMethodNode,
    CollectiveOutputNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "Channel",
    "ChannelClosedError",
    "ClassMethodNode",
    "CollectiveOutputNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGNode",
    "InputAttributeNode",
    "InputNode",
    "MultiOutputNode",
]
