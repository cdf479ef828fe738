"""DAG node types and ``.bind()`` graph construction (counterpart of
``ray_tpu/dag/nodes.py``).

``actor.method.bind(args)`` records a ClassMethodNode; InputNode is the
value of each ``execute()``; MultiOutputNode gathers several leaves into
one result list; CollectiveOutputNode reduces N actors' values on the
host (``allreduce_bind``).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional

_node_counter = itertools.count()


class DAGNode:
    def __init__(self, upstream: list["DAGNode"]):
        self.id = next(_node_counter)
        self.upstream = upstream
        self.downstream: list[DAGNode] = []
        for u in upstream:
            u.downstream.append(self)

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)

    def walk(self, seen: Optional[set] = None) -> list["DAGNode"]:
        """Every ancestor and self, in topological order (ids follow
        creation, and bind() can only name existing nodes)."""
        seen = set()
        order: list[DAGNode] = []

        def visit(n: DAGNode):
            if n.id in seen:
                return
            seen.add(n.id)
            for u in n.upstream:
                visit(u)
            order.append(n)

        visit(self)
        return order


class InputNode(DAGNode):
    """The value passed to ``execute()``; also a context manager
    (``with InputNode() as inp``)."""

    def __init__(self):
        super().__init__([])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, key: str):
        if key.startswith("_") or key in ("id", "upstream", "downstream"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)


class InputAttributeNode(DAGNode):
    """``inp.x`` / ``inp[k]``: a field of the ``execute()`` input."""

    def __init__(self, parent: InputNode, key: Any):
        super().__init__([parent])
        self.key = key

    def extract(self, value: Any) -> Any:
        if isinstance(self.key, str) and hasattr(value, self.key) and not isinstance(value, dict):
            return getattr(value, self.key)
        return value[self.key]


class ClassMethodNode(DAGNode):
    """One actor method call per execution."""

    def __init__(self, actor_handle, method_name: str, args: tuple, kwargs: dict):
        deps = [a for a in args if isinstance(a, DAGNode)]
        deps += [v for v in kwargs.values() if isinstance(v, DAGNode)]
        super().__init__(deps)
        self.actor_handle = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs


class FunctionNode(DAGNode):
    """One remote-function invocation (``remote_fn.bind``), for workflows;
    compiled graphs run ClassMethodNodes."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        deps = [a for a in args if isinstance(a, DAGNode)]
        deps += [v for v in kwargs.values() if isinstance(v, DAGNode)]
        super().__init__(deps)
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs
        self.task_name = getattr(remote_fn, "__name__", "task")


class MultiOutputNode(DAGNode):
    """Several leaves -> one result list."""

    def __init__(self, outputs: list[DAGNode]):
        super().__init__(list(outputs))
        self.outputs = list(outputs)


class CollectiveOutputNode(DAGNode):
    """Elementwise reduction of N actors' values, on the host (a
    driver-side loop of the compiled DAG)."""

    def __init__(self, inputs: list[DAGNode], op: Callable[[Any, Any], Any]):
        super().__init__(list(inputs))
        self.inputs = list(inputs)
        self.op = op


def allreduce_bind(inputs: list[DAGNode], op: Callable[[Any, Any], Any] = None):
    """The reference's ``allreduce.bind``: every contributing actor's
    downstream method receives the same reduction."""
    import operator

    node = CollectiveOutputNode(inputs, op or operator.add)
    return [node] * len(inputs)


def bind_actor_method(actor_handle, method_name: str):
    """A ``.bind()``-capable callable for one actor method."""

    def bind(*args, **kwargs) -> ClassMethodNode:
        return ClassMethodNode(actor_handle, method_name, args, kwargs)

    return bind
