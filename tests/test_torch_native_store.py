"""The port's C++ shared-memory store (``ray_tpu_torch/native``), built with
g++ at first use into ``ray_tpu_torch/native/_build/``.

The scenarios of ``tests/test_native_store.py`` on the port's store (put
and get, zero-copy views, refcounts, LRU eviction, pinned objects, an
exact fit, a duplicate create, coalescing, another process's access),
then the two libraries on one file: the port's copy has the reference's
layout, so a store file made by either is read and written by the other.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu.native.shm import ShmObjectStore as RefStore
from ray_tpu_torch.native import shm as tshm
from ray_tpu_torch.native.shm import ShmObjectStore

pytestmark = pytest.mark.torch_port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def store(tmp_path):
    s = ShmObjectStore.create(str(tmp_path / "store.shm"), capacity=1 << 20)
    yield s
    s.close()


def oid(i: int) -> bytes:
    return i.to_bytes(16, "little")


def test_library_built_into_the_ignored_build_dir():
    path = tshm.library_path()
    assert path.parent == tshm.BUILD_DIR and path.name.startswith("libshm_store-")
    assert path.exists() and not list(tshm.BUILD_DIR.glob("*.tmp"))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "ray_tpu_torch/native/_build/" in f.read().split()


def test_put_get_roundtrip(store):
    store.put(oid(1), b"hello world")
    assert store.contains(oid(1))
    assert store.get_bytes(oid(1))[:11] == b"hello world"
    assert store.get(oid(99)) is None


def test_zero_copy_view(store):
    data = np.arange(1000, dtype=np.float64)
    store.put(oid(2), data.tobytes())
    view = store.get(oid(2))
    arr = np.frombuffer(view, dtype=np.float64, count=1000)
    np.testing.assert_array_equal(arr, data)
    store.release(oid(2))


def test_refcount_blocks_delete(store):
    store.put(oid(3), b"x" * 100)
    store.get(oid(3))  # holds a reference
    assert not store.delete(oid(3))  # refused: refcount > 0
    store.release(oid(3))
    assert store.delete(oid(3))
    assert not store.contains(oid(3))


def test_lru_eviction_under_pressure(tmp_path):
    s = ShmObjectStore.create(str(tmp_path / "small.shm"), capacity=1 << 16)
    try:
        chunk = b"z" * (1 << 13)  # 8 KiB
        for i in range(20):  # 160 KiB through a 64 KiB store
            s.put(oid(100 + i), chunk)
        assert s.stats()["num_evictions"] > 0
        # newest object still resident, oldest evicted
        assert s.contains(oid(119))
        assert not s.contains(oid(100))
    finally:
        s.close()


def test_pinned_objects_survive_eviction(tmp_path):
    s = ShmObjectStore.create(str(tmp_path / "pin.shm"), capacity=1 << 16)
    try:
        chunk = b"p" * (1 << 13)
        s.put(oid(1), chunk)
        view = s.get(oid(1))  # pin it
        for i in range(20):
            s.put(oid(200 + i), chunk)
        assert s.contains(oid(1))  # pinned: never evicted
        arr = np.frombuffer(view, dtype=np.uint8)
        assert bytes(arr[:4]) == b"pppp"  # data intact
        s.release(oid(1))
    finally:
        s.close()


def test_exact_fit_allocation(tmp_path):
    s = ShmObjectStore.create(str(tmp_path / "exact.shm"), capacity=1 << 12)
    try:
        s.put(oid(1), b"a" * (1 << 12))  # entire capacity, exact fit
        assert s.contains(oid(1))
    finally:
        s.close()


def test_duplicate_create_fails(store):
    store.put(oid(7), b"first")
    with pytest.raises(MemoryError):
        store.create_buffer(oid(7), 10)


def test_free_list_coalescing(tmp_path):
    s = ShmObjectStore.create(str(tmp_path / "coal.shm"), capacity=1 << 16)
    try:
        third = (1 << 16) // 4
        for i in range(3):
            s.put(oid(10 + i), b"c" * third)
        for i in range(3):
            assert s.delete(oid(10 + i))
        # after coalescing, one allocation of ~3/4 capacity must succeed
        s.put(oid(50), b"big" * third)
        assert s.contains(oid(50))
    finally:
        s.close()


def test_cross_process_access(tmp_path):
    path = str(tmp_path / "xproc.shm")
    s = ShmObjectStore.create(path, capacity=1 << 20)
    try:
        payload = np.arange(512, dtype=np.int32).tobytes()
        s.put(oid(42), payload)
        code = f"""
import sys
sys.modules["jax"] = sys.modules["ray_tpu"] = None
sys.path.insert(0, {REPO!r})
from ray_tpu_torch.native.shm import ShmObjectStore
s = ShmObjectStore.open({path!r})
data = s.get_bytes((42).to_bytes(16, "little"))
assert data[:{len(payload)}] == {payload!r}, "payload mismatch"
s.put((43).to_bytes(16, "little"), b"from-child")
s.close()
print("child-ok")
"""
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=60)
        assert "child-ok" in out.stdout, out.stderr
        # object written by the child is visible to the parent
        assert s.get_bytes(oid(43))[:10] == b"from-child"
    finally:
        s.close()


@pytest.mark.parametrize("maker", ["ref", "port"])
def test_one_layout_both_libraries(tmp_path, maker):
    """A store file made by one library is read, written, evicted from and
    freed by the other: the port's copy keeps the reference's layout."""
    make, attach = (RefStore, ShmObjectStore) if maker == "ref" else (ShmObjectStore, RefStore)
    path = str(tmp_path / f"{maker}.shm")
    owner = make.create(path, capacity=1 << 16)
    try:
        data = np.arange(1024, dtype=np.float32).tobytes()
        owner.put(oid(1), data)
        other = attach.open(path)
        try:
            assert other.get_bytes(oid(1)) == data
            other.put(oid(2), b"other side")
            view = other.get(oid(1))  # a reference taken through the other library
            assert not owner.delete(oid(1))
            other.release(oid(1))
            del view
            assert owner.get_bytes(oid(2))[:10] == b"other side"
            for i in range(12):  # 96 KiB through 64 KiB: both sides' objects evict
                other.put(oid(100 + i), b"e" * (1 << 13))
            assert owner.stats() == other.stats() and owner.stats()["num_evictions"] > 0
            assert owner.delete(oid(111)) and not other.contains(oid(111))
        finally:
            other.close()
    finally:
        owner.close()
    assert not os.path.exists(path)
