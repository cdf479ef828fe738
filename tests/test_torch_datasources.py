"""The port's extended datasources held against ray_tpu.data's.

Every scenario of ``tests/test_datasources.py`` (TFRecord round trips,
Arrow/Feather and ``from_arrow``, SQL, images, WebDataset shards) runs on
both packages, each on its own in-process runtime started with an explicit
``num_cpus`` and torn down after: the rows must be equal, images included.
Files are written under each case's ``tmp_path``. The port imports pyarrow
and PIL inside the readers only, as the reference does.
"""

import io
import os
import sqlite3
import tarfile

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu.data import datasources_ext as jext
from ray_tpu_torch import data as tdata
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.data import datasources_ext as text

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

PACKAGES = {"ref": (ray_tpu, jrt, jserve, jdata), "port": (ray_tpu_torch, trt, tserve, tdata)}
EXT = {jdata: jext, tdata: text}
_RESULTS: dict = {}


def _reset(runtime, serve):
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()


def _run(name: str, scenario, root):
    """``scenario(data module, directory)`` on package ``name`` with a fresh
    runtime of 4 CPUs (explicit: an auto-init sizes the pool to the host
    and outlives the test), torn down after."""
    api, runtime, serve, data = PACKAGES[name]
    _reset(runtime, serve)
    api.init(num_cpus=4)
    d = root / name
    d.mkdir(exist_ok=True)
    try:
        return scenario(data, d)
    finally:
        _reset(runtime, serve)


def canon(x):
    if isinstance(x, dict):
        return ("dict", tuple((k, canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v) for v in x))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, canon(x.tolist()))
    if isinstance(x, np.generic):
        return (type(x).__name__, x.item())
    return (type(x).__name__, x)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return request.param


def check(pkg: str, scenario, root):
    """This package's result; on the port, also equal to the reference's
    (from its case, or run now when that case was not selected)."""
    got = _run(pkg, scenario, root)
    _RESULTS[(pkg, scenario.__name__)] = got
    if pkg == "port":
        ref = _RESULTS.get(("ref", scenario.__name__))
        if ref is None:
            ref = _run("ref", scenario, root)
        assert canon(got) == canon(ref)
    return got


def _rel(rows, root):
    """Image rows with their path relative to the case's directory (each
    case writes under its own)."""
    return [{**r, "path": os.path.relpath(r["path"], root)} for r in rows]


def s_tfrecords_roundtrip(rd, root):
    path = str(root / "data.tfrecord")
    EXT[rd].write_tfrecord_block(rd.Block.from_rows([
        {"label": 3, "score": 0.5, "name": b"ab"},
        {"label": 7, "score": 1.25, "name": b"cd"},
    ]), path)
    return sorted(rd.read_tfrecords([path]).take_all(), key=lambda r: r["label"])


def test_tfrecords_roundtrip(pkg, tmp_path):
    rows = check(pkg, s_tfrecords_roundtrip, tmp_path)
    assert [r["label"] for r in rows] == [3, 7]
    assert rows[0]["score"] == pytest.approx(0.5)
    assert rows[1]["name"] == b"cd"


def s_arrow_feather_and_from_arrow(rd, root):
    import pyarrow as pa
    import pyarrow.feather as feather

    table = pa.table({"x": [1, 2, 3], "y": [0.1, 0.2, 0.3]})
    path = str(root / "t.feather")
    feather.write_feather(table, path)
    ds = rd.read_arrow([path])
    ds2 = rd.from_arrow(table)
    return ds.count(), ds.sum("x"), ds2.take_all(), ds2.schema()


def test_arrow_feather_and_from_arrow(pkg, tmp_path):
    n, total, rows, schema = check(pkg, s_arrow_feather_and_from_arrow, tmp_path)
    assert (n, total) == (3, 6)
    assert [r["x"] for r in rows] == [1, 2, 3]
    assert schema["y"].startswith("float")


def s_read_sql(rd, root):
    db = str(root / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE metrics (step INTEGER, loss REAL)")
    conn.executemany("INSERT INTO metrics VALUES (?, ?)", [(i, 1.0 / (i + 1)) for i in range(10)])
    conn.commit()
    conn.close()
    ds = rd.read_sql("SELECT * FROM metrics WHERE step < 5", lambda: sqlite3.connect(db))
    return sorted(ds.take_all(), key=lambda r: r["step"])


def test_read_sql(pkg, tmp_path):
    rows = check(pkg, s_read_sql, tmp_path)
    assert len(rows) == 5 and rows[0] == {"step": 0, "loss": 1.0}


def s_read_images(rd, root):
    from PIL import Image

    for i in range(3):
        Image.fromarray(np.full((8, 6, 3), i * 40, np.uint8)).save(root / f"img{i}.png")
    return _rel(rd.read_images([str(root)], size=(4, 4)).take_all(), root)


def test_read_images(pkg, tmp_path):
    rows = check(pkg, s_read_images, tmp_path)
    assert len(rows) == 3 and all(r["image"].shape == (4, 4, 3) for r in rows)


def s_read_webdataset(rd, root):
    from PIL import Image

    shard = str(root / "shard-000.tar")
    with tarfile.open(shard, "w") as tar:
        for i in range(2):
            img = io.BytesIO()
            Image.fromarray(np.zeros((5, 5, 3), np.uint8)).save(img, "PNG")
            for ext, payload in [("png", img.getvalue()), ("cls", str(i).encode()),
                                 ("txt", f"caption {i}".encode())]:
                info = tarfile.TarInfo(f"sample{i}.{ext}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
    return sorted(rd.read_webdataset([shard]).take_all(), key=lambda r: r["__key__"])


def test_read_webdataset(pkg, tmp_path):
    rows = check(pkg, s_read_webdataset, tmp_path)
    assert len(rows) == 2
    assert rows[0]["cls"] == 0 and rows[1]["txt"] == "caption 1"
    assert rows[0]["png"].shape == (5, 5, 3)


def s_tfrecords_negative_ints_roundtrip(rd, root):
    path = str(root / "neg.tfrecord")
    EXT[rd].write_tfrecord_block(rd.Block.from_rows([{"v": -1}, {"v": -1234567}]), path)
    return sorted(rd.read_tfrecords([path]).take_all(), key=lambda r: r["v"])


def test_tfrecords_negative_ints_roundtrip(pkg, tmp_path):
    rows = check(pkg, s_tfrecords_negative_ints_roundtrip, tmp_path)
    assert [r["v"] for r in rows] == [-1234567, -1]


def s_read_images_mixed_sizes(rd, root):
    from PIL import Image

    Image.fromarray(np.zeros((8, 6, 3), np.uint8)).save(root / "a.png")
    Image.fromarray(np.zeros((10, 12, 3), np.uint8)).save(root / "b.png")
    return (sorted(r["image"].shape for r in rd.read_images([str(root)]).take_all()),
            _rel(rd.read_images([str(root)], size=(4, 6)).take_all(), root))


def test_read_images_mixed_sizes(pkg, tmp_path):
    shapes, sized = check(pkg, s_read_images_mixed_sizes, tmp_path)
    assert shapes == [(8, 6, 3), (10, 12, 3)]
    # explicit size is (height, width), reference convention
    assert all(r["image"].shape == (4, 6, 3) for r in sized)


def s_webdataset_heterogeneous_samples(rd, root):
    shard = str(root / "h.tar")
    with tarfile.open(shard, "w") as tar:
        for name, payload in [("s0.txt", b"has caption"), ("s0.cls", b"1"), ("s1.cls", b"2")]:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return sorted(rd.read_webdataset([shard]).take_all(), key=lambda r: r["__key__"])


def test_webdataset_heterogeneous_samples(pkg, tmp_path):
    rows = check(pkg, s_webdataset_heterogeneous_samples, tmp_path)
    assert rows[0]["txt"] == "has caption"
    assert rows[1]["txt"] is None  # missing field filled, not KeyError
    assert [r["cls"] for r in rows] == [1, 2]
