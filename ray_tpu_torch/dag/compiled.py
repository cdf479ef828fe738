"""CompiledDAG: a bound DAG lowered to per-actor exec loops and channels
(counterpart of ``ray_tpu/dag/compiled.py``).

At compile time: method nodes are grouped by actor, one channel is
allocated per edge between loops, and every op's argument sources are
fixed (const, input, input field, local value, channel read). Each
``execute()`` is one write to the input channel; the loops stream values
through the channels, with no task submission.

Each actor's loop runs as the framework method
``__ray_tpu_dag_exec_loop__`` on the actor's own executor (an in-process
actor's thread, or a cluster worker's executor under the actor's FIFO
lock), so user state stays where the actor's other calls see it, and the
actor serves no other call until ``teardown()`` closes the channels and
the loop returns. A collective node's reduction runs on a driver thread.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

from ray_tpu_torch.dag.channels import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
)
from ray_tpu_torch.dag.nodes import (
    ClassMethodNode,
    CollectiveOutputNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.dag")

_INPUT = "__input__"


class _Op:
    """One step of a loop's per-iteration schedule."""

    def __init__(self, node_id: int, method_name: Optional[str], arg_sources,
                 kwarg_sources, out_channel: Optional[Channel]):
        self.node_id = node_id
        self.method_name = method_name  # None for pure routing ops
        self.arg_sources = arg_sources
        self.kwarg_sources = kwarg_sources
        self.out_channel = out_channel


# bound on mid-iteration channel reads (op args fed by peer loops): the
# upstream loop is already executing this iteration, so a read parked
# past this is a dead peer or a value dropped in flight — surface the
# typed error instead of a hung exec loop
EXEC_READ_TIMEOUT_S = float(os.environ.get("RAY_TPU_DAG_READ_TIMEOUT_S", "120"))


def _bounded_chan_read(ch, reader_idx: int):
    """Exec-loop channel read with the DAG-wide bound, normalized to the
    typed ChannelTimeoutError across channel flavors (the queue-backed
    in-process channel and the shm/socket channels all raise queue.Empty
    on an explicit-timeout expiry)."""
    import queue as _q

    try:
        return ch.read(reader_idx, timeout=EXEC_READ_TIMEOUT_S)
    except _q.Empty:
        raise ChannelTimeoutError(
            f"exec-loop channel read parked > {EXEC_READ_TIMEOUT_S}s "
            "(peer loop dead, stalled, or value dropped in flight)"
        ) from None


def _resolve_source(src, input_value, local: dict, started=None):
    """``started`` is a one-element cell shared across an iteration's
    reads: while False, a channel read is the loop WAITING for its next
    iteration to begin — an idle DAG is legal for any length of time, so
    timeouts there retry (close still exits via ChannelClosedError).
    Once any value has been consumed the iteration is in flight and a
    parked read past the bound is a dead/stalled peer — fatal, typed."""
    kind = src[0]
    if kind == "const":
        return src[1]
    if kind == "input":
        return input_value
    if kind == "input_attr":
        return src[1].extract(input_value)
    if kind == "local":
        return local[src[1]]
    if kind == "chan":
        while True:
            try:
                v = _bounded_chan_read(src[1], src[2])
                break
            except ChannelTimeoutError:
                if started is None or started[0]:
                    raise
        if started is not None:
            started[0] = True
        return v
    raise AssertionError(src)


def _run_loop_iteration(instance, plan, input_value, local: dict,
                        have_input: bool = True):
    started = [have_input]
    for op in plan:
        args = [
            _resolve_source(s, input_value, local, started)
            for s in op.arg_sources
        ]
        kwargs = {
            k: _resolve_source(s, input_value, local, started)
            for k, s in op.kwarg_sources.items()
        }
        out = getattr(instance, op.method_name)(*args, **kwargs)
        started[0] = True
        local[op.node_id] = out
        if op.out_channel is not None:
            op.out_channel.write(out)


_POISON = object()


def _actor_exec_loop(instance, plan, input_source):
    """Runs on the actor's executor thread until channels close.
    input_source: None | ("chan", channel, reader_idx).

    Input reads overlap compute: a prefetch thread keeps up to 2 upcoming
    input values decoded while iteration N runs, so the channel wait +
    unpickle of iteration N+1 hides behind N's method calls. Mid-plan
    channel reads (op args fed by peer actors) still happen inline —
    they carry data dependencies the schedule must respect anyway.
    """
    import queue as _q

    prefetch = None
    dead = [False]  # set by the main loop so the prefetch thread exits
    if input_source is not None:
        prefetch = _q.Queue(maxsize=2)

        def _put(item) -> bool:
            while True:
                try:
                    prefetch.put(item, timeout=0.2)
                    return True
                except _q.Full:
                    if dead[0]:
                        return False  # consumer gone: drop and exit

        def _read_ahead():
            while not dead[0]:
                try:
                    # bounded slices, not one unbounded park: an idle DAG
                    # (driver not calling execute()) is legal forever, but
                    # each park re-checks the dead flag and channel close
                    v = input_source[1].read(input_source[2], timeout=1.0)
                except _q.Empty:
                    continue  # idle: no execute() in flight
                except ChannelClosedError:
                    _put(_POISON)
                    return
                except Exception as e:  # noqa: BLE001 — surface in main loop
                    _put(("__err__", e))
                    return
                if not _put((None, v)):
                    return

        threading.Thread(
            target=_read_ahead, name="dag-input-prefetch", daemon=True
        ).start()

    try:
        while True:
            try:
                if prefetch is not None:
                    while True:
                        try:
                            # bounded park (check_timeouts contract): the
                            # prefetch thread owns the unbounded wait in
                            # 1s close-aware slices; this side just polls
                            item = prefetch.get(timeout=0.5)
                            break
                        except _q.Empty:
                            continue
                    if item is _POISON:
                        raise ChannelClosedError("input channel closed")
                    tag, input_value = item
                    if tag == "__err__":
                        raise input_value
                else:
                    input_value = None
                _run_loop_iteration(
                    instance, plan, input_value, {},
                    have_input=prefetch is not None,
                )
            except ChannelClosedError:
                # propagate the poison downstream: close OUR out channels
                # too, else a mid-pipeline failure only unblocks immediate
                # consumers
                for op in plan:
                    if op.out_channel is not None:
                        op.out_channel.close()
                return "dag-loop-exit"
            except Exception:
                # poison the pipeline: close out channels so peers unblock
                logger.exception("compiled DAG actor loop failed")
                for op in plan:
                    if op.out_channel is not None:
                        op.out_channel.close()
                raise
    finally:
        dead[0] = True  # the prefetch thread must not outlive the loop


class CompiledDAGRef:
    """Future for one execute() call."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value = None
        self._have = False

    def get(self, timeout: Optional[float] = None):
        if not self._have:
            self._value = self._dag._fetch(self._seq, timeout)
            self._have = True
        return self._value


class CompiledDAG:
    def __init__(self, root: DAGNode, max_in_flight: int = 8,
                 channel_mode: str = "auto"):
        """channel_mode: 'auto' (shm on one host, TCP across hosts),
        'shm', or 'socket' (force TCP — e.g. daemons with divergent
        TMPDIRs, or tests exercising the cross-node path)."""
        import ray_tpu_torch  # noqa: F401  (runtime must be up for actor calls)

        if channel_mode not in ("auto", "shm", "socket"):
            raise ValueError(
                f"channel_mode {channel_mode!r}: 'auto', 'shm' or 'socket'"
            )
        self._lock = threading.Lock()
        self._max_in_flight = max_in_flight
        self._seq = 0
        self._fetched = -1
        self._results: dict[int, Any] = {}
        self._torn_down = False

        nodes = root.walk()
        input_nodes = [n for n in nodes if isinstance(n, InputNode)]
        if len(input_nodes) > 1:
            raise ValueError("compiled DAG supports exactly one InputNode")
        self._input_node = input_nodes[0] if input_nodes else None

        outputs = root.outputs if isinstance(root, MultiOutputNode) else [root]
        self._outputs = outputs
        self._single = not isinstance(root, MultiOutputNode)

        # group executable nodes by loop: one loop per actor, one per
        # collective node (driver-side thread)
        actor_loops: dict = {}  # actor identity -> {handle, nodes}
        collectives: list[CollectiveOutputNode] = []
        self._cluster_mode = False
        for n in nodes:
            if isinstance(n, ClassMethodNode):
                h = n.actor_handle
                if hasattr(h, "_actor"):  # in-process handle
                    key = id(h._actor)
                else:  # cluster handle: PROCESS actor -> shm channels
                    key = h._actor_id
                    self._cluster_mode = True
                loop = actor_loops.setdefault(key, {"handle": h, "nodes": []})
                loop["nodes"].append(n)
            elif isinstance(n, CollectiveOutputNode):
                collectives.append(n)

        loop_of: dict[int, Any] = {}  # node_id -> loop key ('driver' for none)
        for key, loop in actor_loops.items():
            for n in loop["nodes"]:
                loop_of[n.id] = key
        for cn in collectives:
            loop_of[cn.id] = ("coll", cn.id)

        # --- channel allocation -------------------------------------------
        # consumers of node n = downstream executable nodes in OTHER loops
        # (+ the driver if n is an output). readers are indexed per channel.
        def consumers_of(n: DAGNode):
            cons = []
            for d in n.downstream:
                if isinstance(d, (ClassMethodNode, CollectiveOutputNode)):
                    if loop_of[d.id] != loop_of.get(n.id):
                        cons.append(loop_of[d.id])
            # dedupe, keep order
            seen, out = set(), []
            for c in cons:
                if c not in seen:
                    seen.add(c)
                    out.append(c)
            return out

        self._channels: list[Channel] = []
        chan_for: dict[int, Channel] = {}
        reader_idx: dict[tuple, int] = {}  # (node_id, consumer_loop) -> idx

        self._socket_channels = False
        if self._cluster_mode:
            # the shm data plane requires every participant (actors AND
            # the driver, which writes input / reads outputs) to share one
            # /dev/shm; when actors span HOSTS the channels become direct
            # writer->reader TCP streams (dag/socket_channel.py) instead
            hosts = set()
            for loop in actor_loops.values():
                h = loop["handle"]
                if hasattr(h, "_actor"):
                    continue
                info = h._client.gcs.call("get_actor", {"actor_id": h._actor_id})
                addr = (info or {}).get("node_addr") or (info or {}).get(
                    "worker_addr"
                )
                if addr:
                    hosts.add(addr[0])
                hosts.add(h._client.local_daemon_addr[0])
            if channel_mode == "socket" or (
                channel_mode == "auto" and len(hosts) > 1
            ):
                self._socket_channels = True
            elif channel_mode == "shm" and len(hosts) > 1:
                # fail HERE, not with "No such file" deep inside a remote
                # exec loop attaching a mapping that only exists on one host
                raise ValueError(
                    f"channel_mode='shm' requires all actors and the driver "
                    f"on ONE host; got hosts {sorted(hosts)} — use 'auto' "
                    "or 'socket'"
                )

        # which channel flavor this DAG runs on: "queue" (in-process
        # actors), "shm" (cluster actors on one host) or "socket"
        self.channel_kind = ("socket" if self._socket_channels
                             else "shm" if self._cluster_mode else "queue")

        def make_channel(num_readers: int):
            if self._cluster_mode:
                if self._socket_channels:
                    from ray_tpu_torch.dag.socket_channel import SocketChannel

                    return SocketChannel(
                        num_readers=num_readers, maxsize=max_in_flight
                    )
                # PROCESS actors, one host: named single-writer ring over a
                # shared memory mapping (dag/shm_channel.py)
                from ray_tpu_torch.dag.shm_channel import ShmChannel

                return ShmChannel(num_readers=num_readers, maxsize=max_in_flight)
            return Channel(num_readers=num_readers, maxsize=max_in_flight)

        def alloc_channel(n: DAGNode, extra_driver_reads: int):
            cons = consumers_of(n)
            total = len(cons) + extra_driver_reads
            if total == 0:
                return None
            ch = make_channel(total)
            self._channels.append(ch)
            chan_for[n.id] = ch
            for i, c in enumerate(cons):
                reader_idx[(n.id, c)] = i
            if extra_driver_reads:
                reader_idx[(n.id, "driver")] = len(cons)
            return ch

        output_ids = {n.id for n in outputs}
        for n in nodes:
            if isinstance(n, (ClassMethodNode, CollectiveOutputNode)):
                alloc_channel(n, 1 if n.id in output_ids else 0)

        # input channel: read by every loop that consumes the input
        self._input_channel = None
        if self._input_node is not None:
            consuming_loops = []
            for n in nodes:
                if isinstance(n, ClassMethodNode):
                    for a in list(n.args) + list(n.kwargs.values()):
                        if isinstance(a, (InputNode, InputAttributeNode)):
                            lk = loop_of[n.id]
                            if lk not in consuming_loops:
                                consuming_loops.append(lk)
            if any(isinstance(o, (InputNode, InputAttributeNode)) for o in outputs):
                raise ValueError("DAG output cannot be the input itself")
            self._input_consumers = consuming_loops
            if consuming_loops:
                self._input_channel = make_channel(len(consuming_loops))
                self._channels.append(self._input_channel)

        # --- build per-loop plans ------------------------------------------
        def arg_source(loop_key, a):
            if isinstance(a, InputNode):
                return ("input",)
            if isinstance(a, InputAttributeNode):
                return ("input_attr", a)
            if isinstance(a, DAGNode):
                if loop_of.get(a.id) == loop_key:
                    return ("local", a.id)
                return ("chan", chan_for[a.id], reader_idx[(a.id, loop_key)])
            return ("const", a)

        self._loop_handles = []
        for key, loop in actor_loops.items():
            plan = []
            for n in loop["nodes"]:  # creation order == topo order per actor
                plan.append(
                    _Op(
                        n.id,
                        n.method_name,
                        [arg_source(key, a) for a in n.args],
                        {k: arg_source(key, v) for k, v in n.kwargs.items()},
                        chan_for.get(n.id),
                    )
                )
            if self._input_channel is not None and key in self._input_consumers:
                in_src = ("chan", self._input_channel, self._input_consumers.index(key))
            else:
                in_src = None
            self._loop_handles.append(
                _submit_exec_loop(loop["handle"], plan, in_src)
            )

        # collective loops run as driver-side threads
        self._coll_threads = []
        for cn in collectives:
            key = ("coll", cn.id)
            srcs = [arg_source(key, a) for a in cn.inputs]
            out_ch = chan_for.get(cn.id)
            t = threading.Thread(
                target=_collective_loop,
                args=(cn.op, srcs, out_ch),
                daemon=True,
                name=f"dag-collective-{cn.id}",
            )
            t.start()
            self._coll_threads.append(t)

        # driver-side output readers
        self._output_sources = []
        for o in outputs:
            self._output_sources.append(
                ("chan", chan_for[o.id], reader_idx[(o.id, "driver")])
            )

    # -- execution ------------------------------------------------------------

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG has been torn down")
        with self._lock:
            # a full pipeline must fail loudly, not self-deadlock: draining
            # requires _fetch, which a blocked write (holding _lock) starves
            if self._seq - self._fetched - 1 >= self._max_in_flight:
                raise RuntimeError(
                    f"compiled DAG has {self._max_in_flight} executions in "
                    f"flight; call .get() on earlier refs before execute()"
                )
            seq = self._seq
            self._seq += 1
            if self._input_channel is not None:
                if kwargs and not args:
                    value = kwargs
                elif len(args) == 1 and not kwargs:
                    value = args[0]
                else:
                    value = args
                self._input_channel.write(value)
        return CompiledDAGRef(self, seq)

    def _fetch(self, seq: int, timeout: Optional[float]):
        import queue as _queue

        from ray_tpu_torch.dag.channels import DEFAULT_READ_TIMEOUT

        # timeout=None means the BOUNDED default for every channel
        # flavor: the shm/socket channels' read(timeout=None) parks
        # forever, and a value dropped on the final output edge (the
        # exec loops all stay healthy) would hang the driver's get()
        eff = DEFAULT_READ_TIMEOUT if timeout is None else timeout
        with self._lock:
            while self._fetched < seq:
                try:
                    vals = [
                        src[1].read(src[2], timeout=eff)
                        for src in self._output_sources
                    ]
                except (_queue.Empty, ChannelTimeoutError):
                    raise TimeoutError(
                        f"compiled DAG output {seq} not ready after {eff}s"
                    ) from None
                self._fetched += 1
                self._results[self._fetched] = (
                    vals[0] if self._single else list(vals)
                )
            out = self._results.pop(seq)
        return out

    # -- lifecycle ------------------------------------------------------------

    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        for ch in self._channels:
            ch.close()
        import ray_tpu_torch

        for ref in self._loop_handles:
            try:
                ray_tpu_torch.get(ref, timeout=5)
            except Exception:
                pass
        for ch in self._channels:
            if hasattr(ch, "unlink"):  # shm channels: reclaim the mapping
                ch.unlink()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


def _submit_exec_loop(handle, plan, input_source):
    """Kick off the framework exec-loop task on the actor; returns its ref."""
    if hasattr(handle, "_actor"):  # in-process actor
        from ray_tpu_torch.core.api import ActorMethod

        method = ActorMethod(handle, "__ray_tpu_dag_exec_loop__")
    else:  # cluster (process) actor
        from ray_tpu_torch.cluster.client import _ActorMethod

        method = _ActorMethod(handle, "__ray_tpu_dag_exec_loop__")
    return method.remote(plan, input_source)


def _collective_loop(op, srcs, out_ch):
    while True:
        try:
            started = [False]  # idle-tolerant until the round's first value
            vals = [_resolve_source(s, None, {}, started) for s in srcs]
            acc = vals[0]
            for v in vals[1:]:
                acc = op(acc, v)
            if out_ch is not None:
                out_ch.write(acc)
        except ChannelClosedError:
            if out_ch is not None:
                out_ch.close()  # propagate poison downstream
            return
        except Exception:
            logger.exception("collective loop failed")
            if out_ch is not None:
                out_ch.close()
            return
