"""TCP channel: the cross-host data plane of compiled DAGs (counterpart of
``ray_tpu/dag/socket_channel.py``).

A channel whose writer and readers sit on different hosts is a direct
writer->reader TCP stream: pipelined length-prefixed frames on persistent
connections, no task submission, no object store, no RPC per hop:

  * rendezvous: the writer binds an ephemeral port on its first write and
    publishes "host:port" under the channel name in the GCS KV (namespace
    "dagchan"); readers long-poll the key and connect once;
  * frames: (seq, serialized payload), pushed in order to each reader;
    each reader acks seq on the same socket when it has the frame;
  * backpressure: before writing seq N the writer waits until every
    reader acked N - maxsize, as the shm channel does;
  * close: an in-stream CLOSE sentinel for connected readers, plus a GCS
    close marker for processes that never connected and for closes from
    processes that are not the writer; the writer's close-poll thread
    long-polls the marker.

Every wait is bounded: the accept loop and the readers' socket reads park
in short slices that re-check the closed flag. Values go through the
port's pickler (``core/serialization.py``). The object pickles as its
name and metadata; sockets and threads are made in whichever process
touches it.
"""

from __future__ import annotations

import pickle
import queue as _queue
import socket
import struct
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.core.serialization import dumps
from ray_tpu_torch.dag.channels import ChannelClosedError, chaos_channel_op

_NS = "dagchan"
_CLOSE_SEQ = -1
_HDR = struct.Struct("<qI")  # seq, payload length
_ACK = struct.Struct("<q")


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[float],
                closed_check=None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None and time.monotonic() >= deadline:
            raise _queue.Empty()
        sock.settimeout(0.2 if closed_check or deadline is not None else None)
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if closed_check is not None and closed_check():
                raise ChannelClosedError("channel closed")
            continue
        if not chunk:
            raise ChannelClosedError("channel writer hung up")
        buf.extend(chunk)
    return bytes(buf)


class _WriterServer:
    """Accept loop + per-reader sender threads, owned by the writer."""

    def __init__(self, chan: "SocketChannel"):
        self.chan = chan
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.buffer: dict[int, bytes] = {}  # seq -> payload (bounded)
        self.next_seq = 0
        self.acked = [-1] * chan.num_readers
        self.closed = False
        self.sock = socket.create_server(("0.0.0.0", 0))
        self.port = self.sock.getsockname()[1]
        self._threads: list[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"dagchan-accept-{chan.name[:8]}")
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._close_poll_loop, daemon=True,
                             name=f"dagchan-poll-{chan.name[:8]}")
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        # bounded accept: each park re-checks the closed flag so a closed
        # channel reaps this thread instead of leaving it parked forever
        self.sock.settimeout(1.0)
        while True:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                with self.lock:
                    if self.closed:
                        return
                continue
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_reader, args=(conn,),
                                 daemon=True,
                                 name=f"dagchan-reader-{self.chan.name[:8]}")
            t.start()
            self._threads.append(t)

    def _close_poll_loop(self):
        """A non-writer process can only close via the GCS marker; surface
        it here so blocked writers/readers unblock. kv_wait long-polls
        server-side (~0.2 RPC/s per channel), not a tight get loop."""
        while True:
            with self.lock:
                if self.closed:
                    return
            try:
                self.chan._client().kv_wait(
                    self.chan._kv_close_key(), ns=_NS, timeout=5.0
                )
                self.mark_closed()
                return
            except TimeoutError:
                continue
            except Exception:  # noqa: BLE001 — GCS gone: nothing to learn
                return

    def _serve_reader(self, conn: socket.socket):
        try:
            raw = _recv_exact(conn, _ACK.size, None)
            (reader_idx,) = _ACK.unpack(raw)

            def ack_loop():
                while True:
                    try:
                        raw = _recv_exact(conn, _ACK.size, None)
                    except (ChannelClosedError, OSError):
                        return
                    (seq,) = _ACK.unpack(raw)
                    with self.cond:
                        self.acked[reader_idx] = max(
                            self.acked[reader_idx], seq
                        )
                        self.cond.notify_all()

            at = threading.Thread(target=ack_loop, daemon=True,
                                  name=f"dagchan-ack-{self.chan.name[:8]}")
            at.start()
            with self.cond:
                # resume point races ack_loop's writes — read under cond
                sent = self.acked[reader_idx]
            while True:
                with self.cond:
                    while (sent + 1) not in self.buffer and not self.closed:
                        self.cond.wait(0.2)
                    if (sent + 1) in self.buffer:
                        seq = sent + 1
                        payload = self.buffer[seq]
                    elif self.closed:
                        seq, payload = _CLOSE_SEQ, b""
                conn.sendall(_HDR.pack(seq, len(payload)) + payload)
                if seq == _CLOSE_SEQ:
                    return
                sent = seq
        except (OSError, ChannelClosedError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def write(self, payload: bytes, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            seq = self.next_seq
            old = seq - self.chan.maxsize
            while any(a < old for a in self.acked) and not self.closed:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"channel {self.chan.name} write backpressure: "
                        f"readers acked {self.acked}, need {old}"
                    )
                self.cond.wait(0.2)
            if self.closed:
                raise ChannelClosedError("channel closed")
            if old in self.buffer:
                del self.buffer[old]
            self.buffer[seq] = payload
            self.next_seq = seq + 1
            self.cond.notify_all()

    def mark_closed(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    def shutdown(self):
        self.mark_closed()
        try:
            self.sock.close()
        except OSError:
            pass


class SocketChannel:
    """Single-writer, N-reader, bounded, named, cross-HOST."""

    def __init__(self, num_readers: int = 1, maxsize: int = 2,
                 name: Optional[str] = None):
        import uuid

        if num_readers < 1:
            raise ValueError("channel needs at least one reader")
        self.name = name or uuid.uuid4().hex
        self.num_readers = num_readers
        self.maxsize = max(1, maxsize)
        self._server: Optional[_WriterServer] = None
        # one process can hold SEVERAL reader indices of the same channel
        # (e.g. the driver reads a node both as a collective input and as
        # a DAG output) — each gets its own connection + stream buffer
        self._rsocks: dict[int, socket.socket] = {}
        self._rbufs: dict[int, bytearray] = {}

    def __reduce__(self):
        return (_rebuild, (self.name, self.num_readers, self.maxsize))

    # -- GCS rendezvous -------------------------------------------------------

    @staticmethod
    def _client():
        from ray_tpu_torch.cluster.client import _ambient_client

        return _ambient_client()

    def _kv_key(self) -> bytes:
        return f"addr/{self.name}".encode()

    def _kv_close_key(self) -> bytes:
        return f"closed/{self.name}".encode()

    def _kv_closed(self) -> bool:
        return self._client().kv_get(self._kv_close_key(), ns=_NS) is not None

    # -- writer side ----------------------------------------------------------

    def _ensure_server(self) -> _WriterServer:
        if self._server is None:
            self._server = _WriterServer(self)
            client = self._client()
            # advertise the address this process's daemon registered with —
            # loopback on a single-host cluster, the routable NIC otherwise
            host = client.local_daemon_addr[0]
            client.kv_put(
                self._kv_key(), f"{host}:{self._server.port}".encode(), ns=_NS
            )
        return self._server

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        if chaos_channel_op("send", transport="socket"):
            return  # DROP_CHANNEL: lost in flight (never framed)
        self._ensure_server().write(dumps(value), timeout)

    # -- reader side ----------------------------------------------------------

    def _connect(self, reader_idx: int, timeout: Optional[float]):
        if reader_idx in self._rsocks:
            return
        client = self._client()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            addr = client.kv_get(self._kv_key(), ns=_NS)
            if addr is not None:
                break
            if self._kv_closed():
                raise ChannelClosedError("channel closed before first write")
            if deadline is not None and time.monotonic() >= deadline:
                raise _queue.Empty()
            try:
                addr = client.kv_wait(self._kv_key(), ns=_NS, timeout=2.0)
                break
            except TimeoutError:
                continue
        host, port = bytes(addr).decode().rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=30)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(_ACK.pack(reader_idx))
        self._rsocks[reader_idx] = sock
        self._rbufs[reader_idx] = bytearray()

    def _fill_to(self, reader_idx: int, n: int,
                 deadline: Optional[float]) -> None:
        """Grow the per-reader buffer to >= n bytes WITHOUT consuming —
        a timeout mid-frame must leave the stream intact so the next
        read() resumes at the same frame boundary."""
        sock = self._rsocks[reader_idx]
        buf = self._rbufs[reader_idx]
        while len(buf) < n:
            if deadline is not None and time.monotonic() >= deadline:
                raise _queue.Empty()
            sock.settimeout(0.2 if deadline is not None else None)
            try:
                chunk = sock.recv(65536)
            except socket.timeout:
                continue
            if not chunk:
                raise ChannelClosedError("channel writer hung up")
            buf.extend(chunk)

    def read(self, reader_idx: int = 0, timeout: Optional[float] = None) -> Any:
        chaos_channel_op("recv", transport="socket")
        deadline = None if timeout is None else time.monotonic() + timeout
        self._connect(reader_idx, timeout)
        buf = self._rbufs[reader_idx]
        self._fill_to(reader_idx, _HDR.size, deadline)
        seq, ln = _HDR.unpack(bytes(buf[:_HDR.size]))
        if seq == _CLOSE_SEQ:
            raise ChannelClosedError("channel closed")
        self._fill_to(reader_idx, _HDR.size + ln, deadline)
        payload = bytes(buf[_HDR.size:_HDR.size + ln])
        del buf[:_HDR.size + ln]  # consume header+payload atomically
        self._rsocks[reader_idx].sendall(_ACK.pack(seq))
        return pickle.loads(payload)

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        try:
            self._client().kv_put(self._kv_close_key(), b"1", ns=_NS)
        except Exception:  # noqa: BLE001 — GCS gone at teardown
            pass
        if self._server is not None:
            # full shutdown, not just the flag: the writer lives in an
            # ACTOR process where unlink() is never called — leaving the
            # listener open would leak an fd + accept thread per channel
            # per compile/teardown cycle. Sender threads still drain the
            # buffered frames and the CLOSE sentinel before exiting.
            self._server.shutdown()

    def unlink(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
        for sock in self._rsocks.values():
            try:
                sock.close()
            except OSError:
                pass
        self._rsocks.clear()
        self._rbufs.clear()
        try:
            c = self._client()
            c.kv_del(self._kv_key(), ns=_NS)
            c.kv_del(self._kv_close_key(), ns=_NS)
        except Exception:  # noqa: BLE001
            pass


def _rebuild(name, num_readers, maxsize):
    return SocketChannel(num_readers=num_readers, maxsize=maxsize, name=name)
