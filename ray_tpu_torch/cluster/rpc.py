"""Message-framed RPC over TCP (counterpart of ``ray_tpu/cluster/rpc.py``,
the part the transfer planes use).

Length-prefixed pickled frames over asyncio TCP:

    frame    := uint32 length | pickled body
    request  := (msg_id, method: str, payload)
    response := (msg_id, ok: bool, payload | exception)

A server runs an asyncio loop on a thread of its own and dispatches each
method to the function registered with ``route``; plain functions run in
the loop's thread pool, so a slow handler never stalls the connection. A client is thread-safe: one
persistent connection, requests pipelined and matched by ``msg_id``; one
writer thread owns the socket's send side and a reader thread its receive
side, so no caller blocks on the socket while holding a lock. Every call
is bounded by a timeout, and a peer that stalls mid-frame reads as a lost
connection. ``ClientPool`` caches one client per address and re-dials a
dead one.

The transfer planes (``llm/disagg/connector.RpcKVConnector``,
``llm/kvfetch/plane.RpcFetchServer`` / ``RpcFetchClient``) chunk their
payloads under ``MAX_FRAME``. Not ported, with the cluster runtime
(ROADMAP.md, Queue 1, B8): handler objects with ``rpc_<method>``
methods, the fencing-term envelope of a replicated control plane, the
reconnecting multi-endpoint client, the native framing and the per-method
latency histogram.

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
from ray_tpu_torch.util.backoff import ExponentialBackoff

logger = logging.getLogger("ray_tpu_torch.cluster.rpc")

_LEN = struct.Struct("!I")
MAX_FRAME = 1 << 31


class RpcError(Exception):
    """Transport-level failure (peer died, connection refused, timeout)."""


class RemoteError(Exception):
    """The remote handler raised; carries the original exception."""

    def __init__(self, cause: BaseException):
        super().__init__(repr(cause))
        self.cause = cause


def _dump(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=5)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class RpcServer:
    """Asyncio TCP server on its own thread; dispatches each method to the
    function registered with ``route``. A handler (plain function or coroutine) receives
    ``(payload, peer)``, where peer is the connection's ("host", port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._routes: dict[str, Callable] = {}
        self._host = host
        self._port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._tasks: set = set()  # the loop holds tasks weakly
        self.address: Optional[tuple[str, int]] = None

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
        # plain handlers run in this pool: a blocking one never holds the loop
        pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="rpc-handler")
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

    async def _dispatch(self, msg_id, method, payload, peer, writer, write_lock) -> None:
        try:
            fn = self._routes.get(method)
            if fn is None:
                raise RpcError(f"no route {method!r} on this server")
            if asyncio.iscoroutinefunction(fn):
                result = await fn(payload, peer)
            else:
                result = await asyncio.get_running_loop().run_in_executor(None, fn, payload, peer)
            body = _dump((msg_id, True, result))
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — serialized to the caller
            try:
                body = _dump((msg_id, False, e))
            except Exception:  # noqa: BLE001 — an exception that does not pickle
                body = _dump((msg_id, False, RpcError(repr(e))))
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
        try:
            while not self._closed:
                (n,) = _LEN.unpack(self._recv_exact(sock, _LEN.size, mid_frame=False))
                msg_id, ok, result = pickle.loads(self._recv_exact(sock, n, mid_frame=True))[:3]
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

    def close_all(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
