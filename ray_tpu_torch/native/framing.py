"""ctypes binding for the native RPC frame reader and writer
(``src/framing.cc``; counterpart of ``ray_tpu/native/framing.py``).

Opt-in (``RAY_TPU_NATIVE_FRAMING=1``, the reference's flag): the RPC
client's reader thread then blocks inside C with the GIL released, and
its writer thread sends each frame with one ``writev``. Off, both threads
stay in Python.

The library is built with ``g++`` at first use into ``_build/`` (listed
in ``.gitignore``), under a name keyed by a hash of the source and flags,
as the store's is (``shm.py``). A cluster starts its GCS and its daemons
together, so several processes can meet an unbuilt library at once: the
build holds an exclusive file lock, and each compile writes a file of its
own and renames it into place, so no process ever loads half a library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import threading
from typing import Optional

from ray_tpu_torch.native.shm import BUILD_DIR, LIB_FLAGS, SRC, _artifact, _compile

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    return os.environ.get("RAY_TPU_NATIVE_FRAMING", "") not in ("", "0")


def library_path() -> "os.PathLike":
    """The framing library, built first if needed (under a file lock, so
    processes that start together build it once)."""
    src = (SRC / "framing.cc",)
    out = _artifact("libframing", src, LIB_FLAGS, ".so")
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".framing.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            return _compile(out, src, LIB_FLAGS)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(library_path()))
        lib.frame_read.restype = ctypes.c_long
        lib.frame_read.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)), ctypes.c_int,
        ]
        lib.frame_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.frame_write.restype = ctypes.c_int
        lib.frame_write.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int]
        _LIB = lib
        return lib


class FrameReader:
    """Blocking frame reader over a connected socket's fd.

    ``timeout_ms`` bounds every C-side poll: a peer that stalls mid-frame
    reads as a lost connection (None); an idle expiry (no frame started)
    calls ``should_stop`` and goes on waiting unless it says stop.
    """

    def __init__(self, fileno: int, timeout_ms: int = -1, should_stop=None):
        self._lib = load_library()
        self._fd = fileno
        self._timeout_ms = int(timeout_ms)
        self._should_stop = should_stop

    def read_frame(self) -> Optional[bytes]:
        """One whole frame body, or None on EOF, a lost connection or stop."""
        out = ctypes.POINTER(ctypes.c_ubyte)()
        while True:
            n = self._lib.frame_read(self._fd, ctypes.byref(out), self._timeout_ms)
            if n == -3:  # idle: nothing consumed, safe to keep waiting
                if self._should_stop is not None and self._should_stop():
                    return None
                continue
            if n == -1:
                return None
            if n < 0:
                raise MemoryError("native frame_read failed (oversized frame or allocation)")
            try:
                return ctypes.string_at(out, n)
            finally:
                self._lib.frame_free(out)


def write_frame(lib: ctypes.CDLL, fileno: int, body: bytes, timeout_ms: int) -> None:
    """Header and body with one ``writev``; raises ``OSError`` when the
    peer is gone or stalls past ``timeout_ms`` (the connection is then
    dead: part of a frame may be on the wire)."""
    if lib.frame_write(fileno, body, len(body), int(timeout_ms)) != 0:
        raise OSError("native frame_write failed or timed out")
