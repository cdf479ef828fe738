"""Channels: reusable single-slot pipes between compiled-DAG actors
(counterpart of ``ray_tpu/dag/channels.py``).

In one process a bounded queue per reader gives the reference's channel
semantics: backpressure at capacity, ordered delivery, N-reader fan-out.

Reads are bounded by default: ``read(timeout=None)`` parks at most
``default_timeout`` seconds and raises the typed ``ChannelTimeoutError``,
so a peer that died outside the channel protocol never hangs an exec loop.
The channel plane is a chaos surface: ``DROP_CHANNEL`` (a written value
lost in flight; the reader's bounded wait surfaces it) and
``STALL_CHANNEL`` (``delay_s`` late) fire at the ``dag.channel.send`` and
``dag.channel.recv`` sites; a drop is eligible only at a send, since
nothing is in flight to lose at a recv.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.chaos.schedule import DROP_CHANNEL, STALL_CHANNEL


class ChannelClosedError(Exception):
    pass


class ChannelTimeoutError(TimeoutError):
    """A bounded channel read expired with no value: the writer is dead,
    stalled past the bound, or its value was lost in flight. Typed so an
    exec loop poisons the pipeline instead of hanging, and a caller can
    tell a dead peer from a closed channel."""


# bound of read(timeout=None): longer than any legitimate upstream compute,
# finite so a dead writer never parks a loop forever
DEFAULT_READ_TIMEOUT = 120.0


def chaos_channel_op(role: str, **attrs) -> bool:
    """The chaos hook of every channel flavor (queue, shm ring, socket
    stream): True when the op's value is to be dropped (send side only);
    ``STALL_CHANNEL`` sleeps ``delay_s`` here. One attribute load when
    chaos is off."""
    if _chaos.ACTIVE is None:
        return False
    if role == "send":
        fired = _chaos.fire("dag.channel.send", kinds=(DROP_CHANNEL, STALL_CHANNEL), **attrs)
    else:
        fired = _chaos.fire("dag.channel.recv", kinds=(STALL_CHANNEL,), **attrs)
    drop = False
    for f in fired:
        if f.kind == STALL_CHANNEL:
            time.sleep(f.delay_s)
        elif f.kind == DROP_CHANNEL:
            drop = True
    return drop


_CLOSED = object()


class Channel:
    """Single-writer, N-reader channel: each reader gets every value."""

    def __init__(self, num_readers: int = 1, maxsize: int = 2,
                 default_timeout: float = DEFAULT_READ_TIMEOUT):
        if num_readers < 1:
            raise ValueError("channel needs at least one reader")
        self._queues = [queue.Queue(maxsize=maxsize) for _ in range(num_readers)]
        self._closed = threading.Event()
        self._default_timeout = float(default_timeout)

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        if self._closed.is_set():
            raise ChannelClosedError("channel closed")
        if chaos_channel_op("send"):
            return  # lost in flight: the readers' bounded waits surface it
        for q in self._queues:
            q.put(value, timeout=timeout)

    def read(self, reader_idx: int = 0, timeout: Optional[float] = None) -> Any:
        """The next value. ``timeout=None`` is the channel's default bound,
        not forever: its expiry raises ``ChannelTimeoutError``. An explicit
        timeout raises ``queue.Empty``, for pollers."""
        chaos_channel_op("recv")
        bounded_default = timeout is None
        eff = self._default_timeout if bounded_default else timeout
        try:
            v = self._queues[reader_idx].get(timeout=eff)
        except queue.Empty:
            if self._closed.is_set():
                raise ChannelClosedError("channel closed") from None
            if bounded_default:
                raise ChannelTimeoutError(
                    f"channel read parked > {eff}s with no value (writer dead, stalled, "
                    "or value dropped in flight)") from None
            raise
        if v is _CLOSED:
            raise ChannelClosedError("channel closed")
        return v

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for q in self._queues:
            try:
                q.put_nowait(_CLOSED)
            except queue.Full:
                # drain one slot so the sentinel always fits
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    q.put_nowait(_CLOSED)
                except queue.Full:
                    pass
