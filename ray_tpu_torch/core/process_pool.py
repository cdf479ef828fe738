"""Process worker pool: crash-isolated task execution (counterpart of
``ray_tpu/core/process_pool.py``).

Counterpart of the reference WorkerPool (src/ray/raylet/worker_pool.h:125):
persistent worker processes leased per task, cached between tasks. Used
only for ``worker_mode="process"`` tasks — the default is thread execution
inside the process that owns the card (see scheduler.py). Worker death
surfaces as WorkerCrashedError so the scheduler can retry (the
reference's max_retries path, src/ray/core_worker/task_manager.h:260).

Three things differ from the reference, all for the card:

- Functions go by value through the port's own pickler
  (``core/serialization.py``), not ``cloudpickle``, which the card's host
  is not promised to have. Tensors cross as out-of-band buffers, so a big
  one rides the shared-memory store like a numpy array; a CUDA tensor is
  rebuilt on the receiver's own card.
- Card pinning. A task that holds ``"GPU"`` runs in a worker whose
  ``CUDA_VISIBLE_DEVICES`` names the cards it was granted
  (``TaskSpec.gpu_ids``, set by the scheduler); a task without runs in a
  worker with ``CUDA_VISIBLE_DEVICES=""``. Workers fork from a forkserver
  whose environment is the one it started with, so the child sets the
  variable itself, first, before anything touches CUDA; and pooled workers
  are keyed by it, so a CPU task never lands in a worker holding a CUDA
  context (≈ 0.5 GB of the card while pooled).
- The store's file is the port's own (``ray_tpu_torch_store_{pid}.shm``):
  the reference's pool in the same process uses ``ray_tpu_store_{pid}``.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import os
import pickle
import threading
import traceback
import weakref
from typing import TYPE_CHECKING, Optional

from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.core import errors
from ray_tpu_torch.core.serialization import Pickler, dumps
from ray_tpu_torch.core.task import TaskSpec
from ray_tpu_torch.utils.logging import get_logger
from ray_tpu_torch.utils.shm import shm_dir

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import Runtime

logger = get_logger("ray_tpu_torch.process_pool")

# forkserver: children fork from a clean helper process that has never
# initialized CUDA (a child forked from a process with a CUDA context
# cannot use the card), and that holds no thread of the parent
_CTX = mp.get_context("forkserver")

# Buffers above this ride the C++ shared-memory store (zero-copy mmap views
# in the peer process) instead of being copied through the pipe. The store
# is the plasma-equivalent (ray_tpu_torch/native/src/shm_store.cc). The
# parent sends its value with each task, and the worker encodes the result
# with it, so raising it sends both directions through the pipe.
_SHM_THRESHOLD = 32 * 1024
_shm_counter = threading.Lock(), [0]


def _next_shm_id(prefix: int) -> bytes:
    lock, counter = _shm_counter
    with lock:
        counter[0] += 1
        n = counter[0]
    return prefix.to_bytes(4, "little") + os.getpid().to_bytes(4, "little") + n.to_bytes(8, "little")


def visible_devices(gpu_ids: Optional[tuple]) -> str:
    """The ``CUDA_VISIBLE_DEVICES`` of a worker granted ``gpu_ids`` (indices
    of the cards this process sees): the parent's own entries for those
    indices when it has the variable set, else the indices; "" for none."""
    if not gpu_ids:
        return ""
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    names = [t.strip() for t in parent.split(",")] if parent else []
    return ",".join(names[i] if i < len(names) else str(i) for i in gpu_ids)


class _BufferChannel:
    """Pickle-5 out-of-band buffer transport: big buffers via the shm
    store, small ones inline. Symmetric for both directions. ``moved``
    counts the bytes this side sent and received by each route."""

    def __init__(self, store):
        self.store = store  # ShmObjectStore or None (inline-only fallback)
        self.moved = {"shm": 0, "inline": 0}

    def encode(self, buffers: list, threshold: int = _SHM_THRESHOLD) -> tuple[list, list[bytes]]:
        """Returns (meta list, shm ids to delete after the peer is done)."""
        meta, owned = [], []
        for b in buffers:
            try:
                raw = b.raw() if hasattr(b, "raw") else memoryview(b)
            except BufferError:  # non-contiguous pickle buffer
                data = bytes(b)
                self.moved["inline"] += len(data)
                meta.append(("inline", data))
                continue
            if self.store is not None and raw.nbytes >= threshold:
                oid = _next_shm_id(0xB0F)
                try:
                    # keep the producer ref until the peer is done: put()
                    # would release it and expose the buffer to eviction
                    # before the peer's get(). Single copy: source view ->
                    # mapping, no intermediate bytes materialization.
                    buf, _ = self.store.create_buffer(oid, raw.nbytes)
                    memoryview(buf).cast("B")[:] = raw.cast("B")
                    self.store.seal(oid)
                    meta.append(("shm", oid, raw.nbytes))
                    owned.append(oid)
                    self.moved["shm"] += raw.nbytes
                    continue
                except MemoryError:
                    pass  # store full: fall through to inline
            self.moved["inline"] += raw.nbytes
            meta.append(("inline", raw.tobytes()))
        return meta, owned

    def decode(self, meta: list) -> tuple[list, list[bytes]]:
        """Returns (buffer views, shm ids to release after use)."""
        views, held = [], []
        for m in meta:
            if m[0] == "shm":
                view = self.store.get(m[1])
                if view is None:
                    raise errors.ObjectLostError(
                        f"shm buffer {m[1]!r} missing (evicted?)"
                    )
                views.append(view[: m[2]])
                held.append(m[1])
                self.moved["shm"] += m[2]
            else:
                views.append(memoryview(m[1]))
                self.moved["inline"] += len(m[1])
        return views, held

    def release(self, ids: list[bytes]) -> None:
        for oid in ids:
            try:
                self.store.release(oid)
            except Exception:
                pass

    def delete(self, ids: list[bytes]) -> None:
        for oid in ids:
            try:
                self.store.delete(oid)
            except Exception:
                pass

    def producer_done(self, ids: list[bytes]) -> None:
        """Drop the encode()-held refs and free the objects."""
        self.release(ids)
        self.delete(ids)

    def consumer_done_and_free(self, ids: list[bytes]) -> None:
        """Consumer drops its get() ref AND the remote producer's encode
        ref (the producer moved on — cross-process handoff), then frees."""
        self.release(ids)
        self.release(ids)
        self.delete(ids)

    def reclaim_dead_peer(self, ids: list[bytes]) -> None:
        """A peer died holding refs (crash mid-task): refcounts are stuck,
        so reclaim unconditionally or the capacity leaks forever."""
        if self.store is None:
            return
        for oid in ids:
            try:
                self.store.force_delete(oid)
            except Exception:
                pass


class _ValueUnpickler(pickle.Unpickler):
    """Child side: persistent ids carry already-resolved object values."""

    def persistent_load(self, pid):
        kind, value = pid
        if kind == "resolved":
            return value
        raise pickle.UnpicklingError(f"unknown persistent id {kind!r}")


def _loads_with_values_buffers(data: bytes, buffers: list):
    return _ValueUnpickler(io.BytesIO(data), buffers=buffers or None).load()


class _RefResolvingPickler(Pickler):
    """Parent side: an ObjectRef nested anywhere in the args crosses as its
    resolved value (the child has no runtime — a pickled ref would rebuild
    against the wrong store and hang forever); an ActorHandle cannot cross
    (the actor lives in this process) and fails loudly, not with a hang."""

    def __init__(self, file, runtime: "Runtime", buffer_callback):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self._runtime = runtime

    def persistent_id(self, o):
        from ray_tpu_torch.core.api import ActorHandle
        from ray_tpu_torch.core.ref import ObjectRef

        if isinstance(o, ObjectRef):
            return ("resolved", self._runtime.object_store.get(o.id))
        if isinstance(o, ActorHandle):
            raise TypeError(
                "ActorHandle cannot be passed to a process-mode task: "
                "actors live in the host process (use worker_mode='thread' "
                "tasks to interact with actors)"
            )
        return None


def _dumps_resolving_refs(obj, runtime) -> tuple[bytes, list]:
    """Parent side: the task's (func, args, kwargs) with refs resolved.
    Returns (payload, out-of-band pickle-5 buffers)."""
    buf = io.BytesIO()
    buffers: list = []
    _RefResolvingPickler(buf, runtime, buffers.append).dump(obj)
    return buf.getvalue(), buffers


def _dumps_error(e: BaseException) -> bytes:
    tb = traceback.format_exc()
    try:
        return dumps(("err", (e, tb)))
    except Exception:  # noqa: BLE001 — an exception that cannot be pickled
        return dumps(("err", (RuntimeError(f"{type(e).__name__}: {e}"), tb)))


def _worker_main(conn, shm_path: Optional[str], visible: str) -> None:
    # before anything can touch CUDA: the card(s) this worker was leased for
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    channel = None

    def get_channel():
        nonlocal channel
        if channel is None:
            store = None
            if shm_path is not None and os.path.exists(shm_path):
                from ray_tpu_torch.native.shm import ShmObjectStore

                store = ShmObjectStore.open(shm_path)
            channel = _BufferChannel(store)
        return channel

    while True:
        try:
            msg = conn.recv_bytes()
        except (EOFError, OSError):
            return
        held: list = []
        try:
            envelope, meta, threshold = pickle.loads(msg)
            if meta:
                views, held = get_channel().decode(meta)
            else:
                views = []
            func, args, kwargs = _loads_with_values_buffers(envelope, views)
            result = func(*args, **kwargs)
            out_buffers: list = []
            out_payload = dumps(("ok", result), buffer_callback=out_buffers.append)
            out_meta, _owned = (
                get_channel().encode(out_buffers, threshold) if out_buffers else ([], [])
            )
            payload = pickle.dumps((out_payload, out_meta))
        except BaseException as e:  # noqa: BLE001 — reported: the parent raises it as TaskError
            payload = pickle.dumps((_dumps_error(e), []))
        finally:
            if held and channel is not None:
                channel.release(held)
        try:
            conn.send_bytes(payload)
        except (BrokenPipeError, OSError):
            return


class _Worker:
    def __init__(self, shm_path: Optional[str], visible: str):
        self.visible = visible
        self.parent_conn, child_conn = _CTX.Pipe()
        self.proc = _CTX.Process(
            target=_worker_main, args=(child_conn, shm_path, visible), daemon=True
        )
        self.proc.start()
        child_conn.close()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        try:
            self.proc.kill()
        except Exception:
            pass


class ProcessPool:
    def __init__(self, max_workers: int = 8, shm_capacity: int = 256 << 20):
        self._free: dict[str, list[_Worker]] = {}  # CUDA_VISIBLE_DEVICES -> idle workers
        self._lock = threading.Lock()
        self._max = max_workers
        self._running: dict[bytes, _Worker] = {}  # task_id bytes -> worker
        self._shm_capacity = shm_capacity
        self._shm_path: Optional[str] = os.path.join(
            shm_dir(), f"ray_tpu_torch_store_{os.getpid()}.shm")
        self._channel: Optional[_BufferChannel] = None
        # eager: workers fork knowing whether the store exists (tmpfs files
        # are sparse, so unused capacity costs nothing)
        self._get_channel()

    def _get_channel(self) -> _BufferChannel:
        """Lazily create the shared store (plasma-equivalent); fall back to
        inline pipe transport if the native lib can't build."""
        with self._lock:
            if self._channel is None:
                store = None
                try:
                    from ray_tpu_torch.native.shm import ShmObjectStore

                    # tmpfs files are sparse: a capacity past the directory's
                    # free space would turn a write into SIGBUS, not MemoryError
                    st = os.statvfs(os.path.dirname(self._shm_path))
                    store = ShmObjectStore.create(
                        self._shm_path, min(self._shm_capacity, st.f_bavail * st.f_frsize // 2)
                    )
                    # the file in /dev/shm must not outlive the process, even
                    # when the runtime is never shut down (close is idempotent)
                    weakref.finalize(self, store.close)
                except Exception:
                    logger.warning(
                        "native shm store unavailable; using inline transport",
                        exc_info=True,
                    )
                    self._shm_path = None
                self._channel = _BufferChannel(store)
            return self._channel

    def run(self, spec: TaskSpec):
        """Execute the task in a leased worker pinned to the task's cards;
        blocks until done."""
        from ray_tpu_torch.core.runtime import get_runtime
        from ray_tpu_torch.core.scheduler import resolve_args

        runtime = get_runtime()
        args, kwargs = resolve_args(runtime, spec.args, spec.kwargs)
        envelope, out_buffers = _dumps_resolving_refs(
            (spec.func, args, kwargs), runtime
        )
        channel = self._get_channel()
        threshold = _SHM_THRESHOLD
        arg_meta, owned = channel.encode(out_buffers, threshold) if out_buffers else ([], [])
        payload_out = pickle.dumps((envelope, arg_meta, threshold))
        worker = self._lease(visible_devices(spec.gpu_ids))
        tid = spec.task_id.binary()
        self._running[tid] = worker
        if _chaos.ACTIVE is not None:
            for _f in _chaos.fire("process_pool.task",
                                  kinds=(_chaos.KILL_WORKER,),
                                  desc=spec.describe()):
                if _f.kind == _chaos.KILL_WORKER:
                    # worker dies out from under the task: the pipe EOF
                    # below surfaces as WorkerCrashedError and the
                    # scheduler's max_retries path re-runs the task
                    worker.kill()
        try:
            try:
                try:
                    worker.parent_conn.send_bytes(payload_out)
                    payload = worker.parent_conn.recv_bytes()
                except (EOFError, BrokenPipeError, OSError):
                    # the dead worker may hold refs on the arg objects:
                    # normal delete would fail, leaking store capacity
                    if owned:
                        channel.reclaim_dead_peer(owned)
                        owned = []
                    raise errors.WorkerCrashedError(
                        f"worker pid={worker.pid} died executing {spec.describe()}"
                    ) from None
            finally:
                if owned and channel.store is not None:
                    channel.producer_done(owned)
            result_payload, result_meta = pickle.loads(payload)
            held: list = []
            views = []
            if result_meta:
                raw_views, held = channel.decode(result_meta)
                # own the data BEFORE unpickling: reconstructed objects of
                # ANY container shape then never alias soon-freed shm pages
                views = [bytearray(v) for v in raw_views]
                del raw_views
                channel.consumer_done_and_free(held)
                held = []
            status, value = pickle.loads(result_payload, buffers=views or None)
            if status == "err":
                exc, tb = value
                raise errors.TaskError(exc, tb, spec.describe())
            self._release(worker)
            return value
        except errors.WorkerCrashedError:
            # never re-pool after a crash signal, even if is_alive() races
            self._discard(worker)
            raise
        except errors.RayTpuError:
            if not worker.alive():
                self._discard(worker)
            else:
                self._release(worker)
            raise
        except BaseException:
            # e.g. parent-side unpickling failure: never abandon the lease
            self._discard(worker)
            raise
        finally:
            self._running.pop(tid, None)

    def kill_worker_for(self, task_id_bytes: bytes) -> bool:
        """Fault injection: kill the worker running the given task."""
        worker = self._running.get(task_id_bytes)
        if worker is None:
            return False
        worker.kill()
        return True

    def _lease(self, visible: str) -> _Worker:
        with self._lock:
            free = self._free.get(visible, [])
            while free:
                w = free.pop()
                if w.alive():
                    return w
                self._discard_locked(w)
            return _Worker(self._shm_path, visible)

    def _release(self, worker: _Worker) -> None:
        with self._lock:
            idle = sum(map(len, self._free.values()))
            if worker.alive() and idle < self._max:
                self._free.setdefault(worker.visible, []).append(worker)
            else:
                self._discard_locked(worker)

    def _discard(self, worker: _Worker) -> None:
        with self._lock:
            self._discard_locked(worker)

    def _discard_locked(self, worker: _Worker) -> None:
        worker.kill()

    def shutdown(self, join_timeout_s: float = 10.0) -> None:
        # kill running workers first so blocked run() calls fail fast via
        # the crash path, then close the store (its Python guard turns any
        # straggler access into OSError instead of a native SIGSEGV); wait
        # for the killed processes, so the cards they held are free on return
        doomed = list(self._running.values())
        with self._lock:
            for ws in self._free.values():
                doomed += ws
            self._free.clear()
            if self._channel is not None and self._channel.store is not None:
                self._channel.store.close()
                self._channel = None
        for w in doomed:
            w.kill()
        for w in doomed:
            w.proc.join(timeout=join_timeout_s)
