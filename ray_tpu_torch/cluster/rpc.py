"""Message-framed RPC over TCP (counterpart of ``ray_tpu/cluster/rpc.py``).

Length-prefixed pickled frames over asyncio TCP:

    frame    := uint32 length | pickled body
    request  := (msg_id, method: str, payload)
    response := (msg_id, ok: bool, payload | exception)

A server runs an asyncio loop on a thread of its own and dispatches each
method to the function registered with ``route``, else to its handler
object's ``rpc_<method>``; plain functions run in the loop's thread pool,
so a slow handler never stalls the connection, and each dispatch feeds the
per-method latency histogram (``lockstats.rpc_latency_histogram``). A
client is thread-safe: one persistent connection, requests pipelined and
matched by ``msg_id``; one writer thread owns the socket's send side and a
reader thread its receive side, so no caller blocks on the socket while
holding a lock. With ``RAY_TPU_NATIVE_FRAMING=1`` both threads move their
frames through ``native/framing.py``'s C loop. Every call is bounded by a
timeout, and a peer that stalls mid-frame reads as a lost connection.
``ClientPool`` caches one client per address and re-dials a dead one;
``ReconnectingRpcClient`` re-dials a GCS restarted at the same address.

A handler's exception reaches the caller as ``RemoteError``, which names
the remote type (``type_name``) even when the exception itself does not
pickle.

The transfer planes (``llm/disagg/connector.RpcKVConnector``,
``llm/kvfetch/plane.RpcFetchServer`` / ``RpcFetchClient``) chunk their
payloads under ``MAX_FRAME``. Not ported yet, with the GCS's high
availability (ROADMAP.md Queue 1, item 6, part 3b): the fencing-term
envelope of a replicated control plane and the client that fails over
across several GCS endpoints.

Peers are trusted (same-user local processes, cluster hosts): a frame is
unpickled as it arrives.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import queue
import select
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.native import framing as _framing
from ray_tpu_torch.util.backoff import ExponentialBackoff

logger = logging.getLogger("ray_tpu_torch.cluster.rpc")

_LEN = struct.Struct("!I")
MAX_FRAME = 1 << 31


class RpcError(Exception):
    """Transport-level failure (peer died, connection refused, timeout)."""


class RemoteFailure(Exception):
    """Stands in for a remote exception that does not pickle: its type
    name and its repr."""

    def __init__(self, type_name: str, text: str):
        super().__init__(type_name, text)
        self.type_name = type_name
        self.text = text

    def __str__(self) -> str:
        return f"{self.type_name}: {self.text}"


class RemoteError(Exception):
    """The remote handler raised; carries the original exception (or its
    ``RemoteFailure`` stand-in) and the remote type's name."""

    def __init__(self, cause: BaseException):
        super().__init__(repr(cause))
        self.cause = cause
        self.type_name = (cause.type_name if isinstance(cause, RemoteFailure)
                          else type(cause).__name__)


PART_3B = "the GCS's high availability (ROADMAP.md Queue 1, item 6, part 3b)"


def format_gcs_addr(addr) -> str:
    """``"host:port"``: the ``--gcs`` flag form of a GCS address (a
    ``(host, port)`` pair, or a one-endpoint list of pairs)."""
    if isinstance(addr, str):
        return addr
    addr = tuple(addr)
    if len(addr) == 2 and isinstance(addr[0], str):
        return f"{addr[0]}:{int(addr[1])}"
    if len(addr) == 1:
        return format_gcs_addr(addr[0])
    raise NotImplementedError(f"a GCS of {len(addr)} endpoints waits for {PART_3B}")


def parse_gcs_addr(s: str) -> tuple:
    """Inverse of ``format_gcs_addr``: ``"host:port"`` -> ``(host, port)``."""
    parts = s.split(",")
    if len(parts) != 1:
        raise NotImplementedError(f"GCS address {s!r}: several endpoints wait for {PART_3B}")
    host, port = parts[0].rsplit(":", 1)
    return host, int(port)


def _dump(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=5)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class RpcServer:
    """Asyncio TCP server on its own thread. Each method goes to the
    function registered with ``route``, else to ``handler.rpc_<method>``.
    A handler (plain function or coroutine) receives ``(payload, peer)``,
    where peer is the connection's ("host", port)."""

    def __init__(self, handler: Any = None, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 64):
        self._handler = handler
        self._routes: dict[str, Callable] = {}
        self._host = host
        self._port = port
        self._max_workers = max_workers
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._tasks: set = set()  # the loop holds tasks weakly
        self.address: Optional[tuple[str, int]] = None
        from ray_tpu_torch.cluster.lockstats import rpc_latency_histogram

        self._latency_hist = rpc_latency_histogram()

    def route(self, method: str, fn: Callable) -> None:
        self._routes[method] = fn

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(target=self._run, name="rpc-server", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RpcError("rpc server failed to start")
        if self.address is None:
            raise RpcError(f"rpc server failed to bind {self._host}:{self._port}")
        return self.address

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        # plain handlers run in this pool: a blocking one (a fetch, a
        # long-poll, a task) never holds the loop
        pool = ThreadPoolExecutor(max_workers=self._max_workers, thread_name_prefix="rpc-handler")
        loop.set_default_executor(pool)
        self._loop = loop
        try:
            loop.run_until_complete(self._serve())
            loop.run_forever()
        finally:
            self._started.set()  # a failed bind must not park start() for 10 s
            pool.shutdown(wait=False)
            loop.close()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self._host, self._port)
        self.address = tuple(self._server.sockets[0].getsockname()[:2])
        self._started.set()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        if self._loop is None:
            raise RpcError("rpc server not started")
        return self._loop

    async def _shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
        tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def stop(self, timeout_s: float = 5.0) -> None:
        """Close the listener and every connection, stop the loop and join
        its thread (bounded)."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            asyncio.run_coroutine_threadsafe(self._shutdown(), loop).result(timeout=timeout_s)
        except Exception:  # noqa: BLE001 — stopping regardless
            logger.warning("rpc server at %s: unclean shutdown", self.address, exc_info=True)
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass  # already closed
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        write_lock = asyncio.Lock()
        try:
            while True:
                (n,) = _LEN.unpack(await reader.readexactly(_LEN.size))
                if n > MAX_FRAME:
                    raise RpcError(f"frame too large: {n}")
                body = await reader.readexactly(n)
                try:
                    msg_id, method, payload = pickle.loads(body)[:3]
                except Exception as e:  # noqa: BLE001 — a torn or corrupted frame
                    # the framing offsets are gone: drop the CONNECTION, not
                    # the server (the peer re-dials)
                    logger.warning("dropping connection from %s: undecodable frame (%r)", peer, e)
                    break
                # concurrent dispatch: a slow handler must not block the connection
                self._spawn(self._dispatch(msg_id, method, payload, peer, writer, write_lock))
        except (asyncio.IncompleteReadError, ConnectionError, RpcError):
            pass
        finally:
            writer.close()

    def _lookup(self, method: str) -> Callable:
        fn = self._routes.get(method)
        if fn is None and self._handler is not None:
            fn = getattr(self._handler, f"rpc_{method}", None)
        if fn is None:
            raise RpcError(f"no route {method!r} on this server")
        return fn

    async def _dispatch(self, msg_id, method, payload, peer, writer, write_lock) -> None:
        t0 = time.perf_counter()
        try:
            fn = self._lookup(method)
            if asyncio.iscoroutinefunction(fn):
                result = await fn(payload, peer)
            else:
                result = await asyncio.get_running_loop().run_in_executor(None, fn, payload, peer)
                if asyncio.iscoroutine(result):
                    result = await result
            body = _dump((msg_id, True, result))
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — serialized to the caller
            try:
                body = _dump((msg_id, False, e))
            except Exception:  # noqa: BLE001 — an exception that does not pickle
                body = _dump((msg_id, False, RemoteFailure(type(e).__name__, repr(e))))
        # handler latency including executor queueing (part of what a
        # caller waits for), excluding the response write
        self._latency_hist.observe((time.perf_counter() - t0) * 1e3, {"method": str(method)})
        async with write_lock:
            try:
                writer.write(_LEN.pack(len(body)) + body)
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class RpcClient:
    """Thread-safe pipelined client over one persistent connection."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.addr = (host, port)
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._next_id = 0
        self._pending: dict[int, tuple[threading.Event, list]] = {}
        self._plock = threading.Lock()
        # frames for the writer thread, the only thread that sends (None
        # wakes it to exit)
        self._outbox: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._io_threads: list[threading.Thread] = []
        self._closed = False
        self._dead = False  # the peer vanished or a send failed
        self._native = None  # the framing library, when RAY_TPU_NATIVE_FRAMING is on

    def connect(self, retries: int = 0, delay: float = 0.1) -> "RpcClient":
        last: Optional[BaseException] = None
        backoff = ExponentialBackoff(base=delay, cap=max(2.0, delay))
        for _ in range(retries + 1):
            try:
                s = socket.create_connection(self.addr, timeout=self._timeout)
            except OSError as e:
                last = e
                backoff.sleep()
                continue
            # back to BLOCKING mode: a timeout-mode sendall can give up
            # mid-frame (bytes written: unknown) and corrupt the stream for
            # every pending call. The reader bounds itself with select().
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._native = _framing.load_library() if _framing.enabled() else None
            for target, name in ((self._read_loop, "rpc-client-reader"),
                                 (self._write_loop, "rpc-client-writer")):
                t = threading.Thread(target=target, args=(s,), name=name, daemon=True)
                t.start()
                self._io_threads.append(t)
            return self
        raise RpcError(f"cannot connect to {self.addr}: {last}")

    def close(self) -> None:
        self._closed = True
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        self._fail_all(RpcError(f"connection to {self.addr} closed"))
        self._outbox.put(None)
        for t in self._io_threads:
            if t is not threading.current_thread():
                t.join(timeout=1.0)  # both poll _closed at least every 0.25 s

    @property
    def connected(self) -> bool:
        return self._sock is not None and not self._closed and not self._dead

    def call(self, method: str, payload: Any = None, timeout: Optional[float] = None) -> Any:
        if self._sock is None:
            raise RpcError("not connected")
        if self._dead:
            raise RpcError(f"connection to {self.addr} is dead")
        if _chaos.ACTIVE is not None:
            # before the pending slot exists, so a dropped call leaves no waiter
            for f in _chaos.fire(
                "rpc.call", kinds=(_chaos.DROP_RPC, _chaos.DELAY_RPC, _chaos.PARTIAL_PARTITION),
                method=method, peer=f"{self.addr[0]}:{self.addr[1]}",
            ):
                if f.kind == _chaos.DELAY_RPC:
                    time.sleep(f.delay_s)
                elif f.kind == _chaos.DROP_RPC:
                    raise RpcError(f"chaos: dropped rpc {method!r} to {self.addr}")
                elif f.kind == _chaos.PARTIAL_PARTITION:
                    raise RpcError(f"chaos: partial partition — {method!r} to {self.addr} "
                                   "unreachable")
        ev: tuple[threading.Event, list] = (threading.Event(), [])
        with self._plock:
            msg_id = self._next_id
            self._next_id += 1
            self._pending[msg_id] = ev
        body = _dump((msg_id, method, payload))
        if len(body) > MAX_FRAME:
            # the server's read-side limit, checked before the uint32 length
            # prefix overflows: an oversized frame fails loudly here instead
            # of poisoning the stream for every pipelined caller
            with self._plock:
                self._pending.pop(msg_id, None)
            raise RpcError(f"rpc {method!r} frame of {len(body)} bytes exceeds "
                           f"MAX_FRAME={MAX_FRAME}; chunk the payload")
        if _chaos.ACTIVE is not None:
            for f in _chaos.fire("rpc.frame", kinds=(_chaos.CORRUPT_FRAME,), method=method,
                                 peer=f"{self.addr[0]}:{self.addr[1]}"):
                if f.kind == _chaos.CORRUPT_FRAME:
                    # the peer reads a whole frame, fails to decode it and
                    # drops the connection: the torn-wire mode
                    body = _chaos.corrupt_frame(body)
        self._outbox.put(body)
        if self._dead:
            # the writer may have failed before it took this frame
            self._fail_all(RpcError(f"connection to {self.addr} is dead"))
        if not ev[0].wait(timeout if timeout is not None else self._timeout):
            with self._plock:
                self._pending.pop(msg_id, None)
            raise RpcError(f"rpc {method} to {self.addr} timed out")
        ok, result = ev[1]
        if isinstance(result, RpcError) and not ok:
            raise result
        if not ok:
            raise RemoteError(result)
        return result

    def _write_loop(self, sock: socket.socket) -> None:
        """Send queued frames in order. A failed send never delivered a whole
        frame (length-prefixed framing: a partial frame is never executed),
        so the connection is dead and every pending call fails at once."""
        while not self._closed and not self._dead:
            try:
                body = self._outbox.get(timeout=0.25)
            except queue.Empty:
                continue
            if body is None:
                return
            try:
                if self._native is not None:
                    # one writev in C, GIL released, bounded by the timeout
                    _framing.write_frame(self._native, sock.fileno(), body,
                                         int(self._timeout * 1000))
                else:
                    sock.sendall(_LEN.pack(len(body)))
                    sock.sendall(body)
            except OSError as e:
                self._fail_all(RpcError(f"send to {self.addr} failed: {e}"))
                return

    def _recv_exact(self, sock: socket.socket, n: int, mid_frame: bool) -> bytearray:
        """``n`` bytes through select() readability polls (NOT settimeout,
        which is socket-wide and would make the writer's sendall fail
        mid-frame). Idle polls re-check ``_closed``; a peer that stalls
        mid-frame past the client timeout reads as a lost connection."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        stall_deadline = time.monotonic() + self._timeout
        while got < n:
            if self._closed:
                raise ConnectionError("client closed")
            readable, _, _ = select.select([sock], [], [], 0.25)
            if not readable:
                if (mid_frame or got) and time.monotonic() >= stall_deadline:
                    raise ConnectionError(f"peer stalled mid-frame > {self._timeout}s")
                continue
            k = sock.recv_into(view[got:], min(n - got, 1 << 20))
            if k == 0:
                raise ConnectionError("peer closed")
            got += k
            stall_deadline = time.monotonic() + self._timeout
        return buf

    def _read_loop(self, sock: socket.socket) -> None:
        native = None
        if self._native is not None:
            # the C receive loop: idle polls re-check _closed, a mid-frame
            # stall past the timeout reads as a lost connection
            native = _framing.FrameReader(sock.fileno(), timeout_ms=int(self._timeout * 1000),
                                          should_stop=lambda: self._closed)
        try:
            while not self._closed:
                if native is not None:
                    body = native.read_frame()
                    if body is None:
                        raise ConnectionError("peer closed")
                else:
                    (n,) = _LEN.unpack(self._recv_exact(sock, _LEN.size, mid_frame=False))
                    body = self._recv_exact(sock, n, mid_frame=True)
                msg_id, ok, result = pickle.loads(body)[:3]
                with self._plock:
                    ev = self._pending.pop(msg_id, None)
                if ev is not None:
                    ev[1][:] = [ok, result]
                    ev[0].set()
        except (ConnectionError, OSError, MemoryError, pickle.UnpicklingError) as e:
            self._fail_all(RpcError(f"connection to {self.addr} lost: {e}"))

    def _fail_all(self, err: RpcError) -> None:
        self._dead = True  # the pool re-dials, callers fail fast
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        for ev, slot in pending:
            slot[:] = [False, err]
            ev.set()


class ReconnectingRpcClient:
    """An ``RpcClient`` that re-dials a dead connection: the peer (a GCS
    restarted from its snapshot) may come back at the same address
    (reference: raylets reconnect to a restored GCS). A call on a dead
    connection gets up to ``redial_attempts`` fresh dials with jittered
    backoff; a timeout on a live connection is raised as it is, since the
    request may still run and a resend would repeat a mutation. One
    endpoint only: the failover across several waits for part 3b."""

    def __init__(self, host, port=None, *extra, timeout: float = 30.0, retries: int = 20,
                 redial_attempts: int = 3):
        if port is None and not isinstance(host, str):
            host, port = parse_gcs_addr(format_gcs_addr(host))
        if extra:
            raise NotImplementedError(f"a GCS of several endpoints waits for {PART_3B}")
        self.addr = (host, int(port))
        self._timeout = timeout
        self._retries = retries
        self._redial_attempts = max(1, int(redial_attempts))
        self._lock = threading.Lock()
        self._client: Optional[RpcClient] = None
        self._closed = False

    def _get(self) -> RpcClient:
        with self._lock:
            if self._closed:
                raise RpcError(f"client to {self.addr} closed")
            c = self._client
            if c is not None and c.connected:
                return c
        # dial outside the lock: a connect timeout must not hold every caller
        c = RpcClient(*self.addr, timeout=self._timeout).connect(retries=self._retries)
        with self._lock:
            if self._closed:
                c.close()
                raise RpcError(f"client to {self.addr} closed")
            existing = self._client
            if existing is not None and existing.connected:
                c.close()  # another thread won the dial race; keep theirs
                return existing
            old, self._client = self._client, c
        if old is not None:
            old.close()
        return c

    def connect(self, retries: Optional[int] = None) -> "ReconnectingRpcClient":
        if retries is not None:
            self._retries = retries
        self._get()
        return self

    def call(self, method: str, payload: Any = None, timeout: Optional[float] = None) -> Any:
        if _chaos.ACTIVE is not None:
            # STALL_GCS: a control-plane outage without a process death;
            # this client is only pointed at the GCS
            for f in _chaos.fire("gcs.call", kinds=(_chaos.STALL_GCS,), method=method,
                                 peer=f"{self.addr[0]}:{self.addr[1]}"):
                if f.kind == _chaos.STALL_GCS:
                    raise RpcError(f"chaos: GCS stalled — {method!r} to {self.addr} lost")
        backoff = ExponentialBackoff(base=0.05, cap=1.0)
        redials = 0
        while True:
            c = self._get()
            try:
                return c.call(method, payload, timeout)
            except RpcError:
                if c.connected or redials >= self._redial_attempts:
                    raise
                redials += 1
                backoff.sleep()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            c, self._client = self._client, None
        if c is not None:
            c.close()


class ClientPool:
    """Cache of RpcClients keyed by address; a dead client is evicted and
    re-dialed at its next use."""

    def __init__(self, timeout: float = 30.0):
        self._clients: dict[tuple[str, int], RpcClient] = {}
        self._lock = threading.Lock()
        self._timeout = timeout

    def get(self, addr: tuple[str, int]) -> RpcClient:
        addr = (addr[0], int(addr[1]))
        with self._lock:
            c = self._clients.get(addr)
            if c is not None and c.connected:
                return c
        # dial OUTSIDE the lock: a connect timeout must not serialize every
        # other address behind one wedged peer
        c = RpcClient(addr[0], addr[1], timeout=self._timeout).connect(retries=2)
        with self._lock:
            existing = self._clients.get(addr)
            if existing is not None and existing.connected:
                c.close()  # another thread won the dial race; keep theirs
                return existing
            self._clients[addr] = c
            return c

    def invalidate(self, addr: tuple[str, int]) -> None:
        """Drop and close the client of ``addr`` (its peer died)."""
        with self._lock:
            c = self._clients.pop((addr[0], int(addr[1])), None)
        if c is not None:
            c.close()

    def close_all(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
