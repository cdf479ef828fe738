"""ctypes binding for the C++ shared-memory object store (counterpart of
``ray_tpu/native/shm.py``).

Counterpart of the plasma client (src/ray/object_manager/plasma/
client.cc) — but there is no broker socket: every process maps the same
tmpfs file and calls into the store's library directly; sealed objects
are zero-copy memoryview slices of the mapping.

The library is built from ``src/shm_store.cc`` with ``g++`` at first use
into ``_build/`` (listed in ``.gitignore``), under a name keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads. Each build writes a file of its own (pid and thread) and
renames it into place, so processes and threads that build together
never load a half-written library. A missing compiler or a failed build
raises with the compiler's output. ``run_stress`` builds the store with
the multithreaded stress harness ``src/shm_stress.cc`` under ASan/UBSan or TSan
and runs it (the reference's ``make asan`` / ``make tsan``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ray_tpu_torch.utils.shm import shm_dir

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
SANITIZER_FLAGS = {
    "asan": ("-O1", "-g", "-std=c++17", "-Wall", "-fsanitize=address,undefined",
             "-fno-omit-frame-pointer"),
    "tsan": ("-O1", "-g", "-std=c++17", "-Wall", "-fsanitize=thread",
             "-fno-omit-frame-pointer"),
}

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def cxx_path() -> str:
    """The C++ compiler: $CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found ($CXX unset, no g++ on PATH): the shared-memory store of "
            "ray_tpu_torch is built from source at first use"
        )
    return cxx


def _artifact(stem: str, sources: tuple, flags: tuple, suffix: str) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def _compile(out: Path, sources: tuple, flags: tuple) -> Path:
    """Build ``out`` from ``sources`` unless it exists; atomic rename."""
    if out.exists():
        return out
    cxx = cxx_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), *map(str, sources), "-lpthread"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed:\n$ {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library_path() -> Path:
    """The store's shared library, built first if needed."""
    src = (SRC / "shm_store.cc",)
    return _compile(_artifact("libshm_store", src, LIB_FLAGS, ".so"), src, LIB_FLAGS)


def run_stress(kind: str, timeout: float = 300.0) -> subprocess.CompletedProcess:
    """Build the store and ``shm_stress.cc`` under sanitizer ``kind``
    ("asan" or "tsan") and run it over a store file of its own; a
    sanitizer report or a failed check exits non-zero, a clean run prints
    ``failures=0``."""
    flags = SANITIZER_FLAGS[kind]
    srcs = (SRC / "shm_store.cc", SRC / "shm_stress.cc")
    binary = _compile(_artifact(f"shm_stress_{kind}", srcs, flags, ""), srcs, flags)
    path = os.path.join(shm_dir(), f"ray_tpu_torch_shm_stress_{kind}_{os.getpid()}")
    return subprocess.run([str(binary), path], capture_output=True, text=True,
                          timeout=timeout)


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the store's library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(library_path()))
        lib.shm_store_create.restype = ctypes.c_void_p
        lib.shm_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.shm_store_open.restype = ctypes.c_void_p
        lib.shm_store_open.argtypes = [ctypes.c_char_p]
        lib.shm_store_close.restype = None
        lib.shm_store_close.argtypes = [ctypes.c_void_p]
        lib.shm_create.restype = ctypes.c_uint64
        lib.shm_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.shm_seal.restype = ctypes.c_int
        lib.shm_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.shm_get.restype = ctypes.c_uint64
        lib.shm_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.shm_release.restype = ctypes.c_int
        lib.shm_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.shm_delete.restype = ctypes.c_int
        lib.shm_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.shm_force_delete.restype = ctypes.c_int
        lib.shm_force_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.shm_contains.restype = ctypes.c_int
        lib.shm_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.shm_base.restype = ctypes.c_void_p
        lib.shm_base.argtypes = [ctypes.c_void_p]
        lib.shm_stats.restype = None
        lib.shm_stats.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_uint64)
        ] * 4
        _LIB = lib
        return lib


class ShmObjectStore:
    """One store = one tmpfs file. The creating process owns the file's
    lifetime; other processes attach with open()."""

    def __init__(self, lib: ctypes.CDLL, handle: int, path: str, owner: bool):
        self._lib = lib
        self._h = handle
        self.path = path
        self._owner = owner
        self._closed = False

    # -- lifecycle ------------------------------------------------------------

    @classmethod
    def create(cls, path: str, capacity: int) -> "ShmObjectStore":
        lib = load_library()
        h = lib.shm_store_create(path.encode(), capacity)
        if not h:
            raise OSError(f"failed to create shm store at {path}")
        return cls(lib, h, path, owner=True)

    @classmethod
    def open(cls, path: str) -> "ShmObjectStore":
        lib = load_library()
        h = lib.shm_store_open(path.encode())
        if not h:
            raise OSError(f"failed to open shm store at {path}")
        return cls(lib, h, path, owner=False)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._lib.shm_store_close(self._h)
        if self._owner:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- object API -----------------------------------------------------------

    @staticmethod
    def _id16(object_id: bytes) -> bytes:
        if len(object_id) != 16:
            object_id = (object_id + b"\x00" * 16)[:16]
        return object_id

    def _check_open(self) -> None:
        # a dangling handle would be a SIGSEGV in C; fail in Python instead
        if self._closed:
            raise OSError(f"shm store {self.path} is closed")

    def create_buffer(self, object_id: bytes, size: int):
        """Allocate an unsealed object; returns (writable buffer, offset)."""
        self._check_open()
        oid = self._id16(object_id)
        off = self._lib.shm_create(self._h, oid, size)
        if off == 0:
            raise MemoryError(
                f"shm store cannot allocate {size} bytes (exists or full)"
            )
        base = self._lib.shm_base(self._h)
        return (ctypes.c_uint8 * size).from_address(base + off), off

    def put(self, object_id: bytes, data: bytes) -> None:
        """create + write + seal + release in one call."""
        buf, _ = self.create_buffer(object_id, max(1, len(data)))
        ctypes.memmove(buf, data, len(data))
        self.seal(object_id)
        self.release(object_id)

    def put_pinned(self, object_id: bytes, data) -> bool:
        """create + write + seal, keeping the creator's reference: the
        object is pinned against LRU eviction until release() or
        delete(). False (not an exception) when the store is full or the
        id exists: the one sealing protocol of the cluster's daemons and
        workers."""
        if len(data) == 0:
            return False  # the store rounds 0 up to 1 byte: the size would lie
        try:
            buf, _ = self.create_buffer(object_id, len(data))
            ctypes.memmove(buf, data, len(data))
            self.seal(object_id)
        except (MemoryError, OSError, KeyError):
            return False
        return True

    def get_slice(self, object_id: bytes, offset: int, length: int) -> Optional[bytes]:
        """Copy out one slice of a sealed object (a chunked pull between
        nodes must not copy the whole object per chunk)."""
        view = self.get(object_id)
        if view is None:
            return None
        try:
            return bytes(view[offset:offset + length])
        finally:
            self.release(object_id)

    def size_of(self, object_id: bytes) -> Optional[int]:
        view = self.get(object_id)
        if view is None:
            return None
        try:
            return len(view)
        finally:
            self.release(object_id)

    def seal(self, object_id: bytes) -> None:
        self._check_open()
        if self._lib.shm_seal(self._h, self._id16(object_id)) != 0:
            raise KeyError(f"cannot seal {object_id!r} (missing or sealed)")

    def get(self, object_id: bytes) -> Optional[memoryview]:
        """Zero-copy read view of a sealed object (takes a reference —
        call release() when done)."""
        self._check_open()
        size = ctypes.c_uint64()
        off = self._lib.shm_get(self._h, self._id16(object_id), ctypes.byref(size))
        if off == 0:
            return None
        base = self._lib.shm_base(self._h)
        arr = np.ctypeslib.as_array(
            (ctypes.c_uint8 * size.value).from_address(base + off)
        )
        return memoryview(arr)

    def get_bytes(self, object_id: bytes) -> Optional[bytes]:
        view = self.get(object_id)
        if view is None:
            return None
        try:
            return bytes(view)
        finally:
            self.release(object_id)

    def release(self, object_id: bytes) -> None:
        self._check_open()
        self._lib.shm_release(self._h, self._id16(object_id))

    def delete(self, object_id: bytes) -> bool:
        self._check_open()
        return self._lib.shm_delete(self._h, self._id16(object_id)) == 0

    def force_delete(self, object_id: bytes) -> bool:
        """Reclaim regardless of refcount — for objects whose referencing
        process died holding refs (plasma reclaims on client disconnect;
        with no broker the surviving peer does it explicitly)."""
        self._check_open()
        return self._lib.shm_force_delete(self._h, self._id16(object_id)) == 0

    def contains(self, object_id: bytes) -> bool:
        self._check_open()
        return bool(self._lib.shm_contains(self._h, self._id16(object_id)))

    def stats(self) -> dict:
        self._check_open()
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.shm_stats(self._h, *[ctypes.byref(v) for v in vals])
        return {
            "capacity": vals[0].value,
            "used": vals[1].value,
            "num_objects": vals[2].value,
            "num_evictions": vals[3].value,
        }
