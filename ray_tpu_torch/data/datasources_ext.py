"""Extended datasources: TFRecord, Arrow/Feather, SQL, images, webdataset.

Reference analog: python/ray/data/_internal/datasource/ — the tfrecords,
arrow/feather, sql, image, and webdataset readers (of its 38 modules,
the ones a training stack feeds from). All pure
stdlib + pyarrow + PIL; each reader yields one Block per file/shard so
the streaming executor parallelizes per-file.
"""

from __future__ import annotations

import io
import struct
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.datasource import Datasource, FileDatasource, ReadTask, _expand_paths


# ---------------------------------------------------------------------------
# TFRecord
# ---------------------------------------------------------------------------


def _read_tfrecord_records(path: str):
    """Raw records from a TFRecord file (format: u64 length, u32 masked
    crc(length), payload, u32 masked crc(payload)); CRCs are skipped —
    corruption surfaces as a struct error, matching fast-path readers."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            f.read(4)  # data crc
            yield payload


def _parse_tf_example(payload: bytes) -> dict:
    """Minimal tf.train.Example proto parser (features -> python values).

    Wire format: Example{1: Features{1: map<string, Feature>}} where
    Feature is one of bytes_list(1)/float_list(2)/int64_list(3). A full
    protobuf runtime is deliberately avoided (hermetic hosts)."""

    def read_varint(buf, i):
        out = shift = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out, i
            shift += 7

    def read_fields(buf):
        i = 0
        while i < len(buf):
            tag, i = read_varint(buf, i)
            field, wire = tag >> 3, tag & 7
            if wire == 2:  # length-delimited
                n, i = read_varint(buf, i)
                yield field, buf[i:i + n]
                i += n
            elif wire == 0:
                v, i = read_varint(buf, i)
                yield field, v
            elif wire == 5:
                yield field, buf[i:i + 4]
                i += 4
            elif wire == 1:
                yield field, buf[i:i + 8]
                i += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    def parse_feature(buf):
        for field, val in read_fields(buf):
            if field == 1:  # bytes_list
                return [v for f, v in read_fields(val) if f == 1]
            if field == 2:  # float_list: packed or repeated
                floats = []
                for f, v in read_fields(val):
                    if f == 1:
                        if isinstance(v, (bytes, bytearray)) and len(v) != 4:
                            floats.extend(
                                struct.unpack(f"<{len(v)//4}f", v)
                            )
                        elif isinstance(v, (bytes, bytearray)):
                            floats.append(struct.unpack("<f", v)[0])
                        else:
                            floats.append(v)
                return floats
            if field == 3:  # int64_list
                def signed(x):  # varints are unsigned on the wire
                    return x - (1 << 64) if x >= 1 << 63 else x

                ints = []
                for f, v in read_fields(val):
                    if f == 1:
                        if isinstance(v, (bytes, bytearray)):
                            i = 0
                            while i < len(v):
                                x, i = read_varint(v, i)
                                ints.append(signed(x))
                        else:
                            ints.append(signed(v))
                return ints
        return []

    out = {}
    for field, features_buf in read_fields(payload):
        if field != 1:
            continue
        for f, entry in read_fields(features_buf):
            if f != 1:
                continue
            name = value = None
            for ef, ev in read_fields(entry):
                if ef == 1:
                    name = ev.decode()
                elif ef == 2:
                    value = parse_feature(ev)
            if name is not None:
                out[name] = value
    return out


class TFRecordDatasource(FileDatasource):
    """tf.train.Example TFRecords -> columns (single-element lists are
    scalarized, matching the reference's tfrecords reader)."""

    def _read_file(self, path: str) -> Block:
        rows = []
        for payload in _read_tfrecord_records(path):
            ex = _parse_tf_example(payload)
            rows.append({
                k: (v[0] if isinstance(v, list) and len(v) == 1 else v)
                for k, v in ex.items()
            })
        # tf.train.Example features are optional per record: union the
        # keys (missing -> None) so heterogeneous records neither crash
        # schema inference nor silently drop late-appearing features
        keys = sorted({k for r in rows for k in r})
        rows = [{k: r.get(k) for k in keys} for r in rows]
        return [Block.from_rows(rows)]


def write_tfrecord_block(block: Block, path: str) -> None:
    """Write a block as tf.train.Example TFRecords (masked CRCs zeroed —
    readers that verify CRCs should use the parquet path instead)."""

    def varint(n: int) -> bytes:
        n &= 0xFFFFFFFFFFFFFFFF  # negatives: 10-byte two's-complement varint
        out = b""
        while True:
            b = n & 0x7F
            n >>= 7
            out += bytes([b | (0x80 if n else 0)])
            if not n:
                return out

    def field(num: int, payload: bytes, wire: int = 2) -> bytes:
        return varint((num << 3) | wire) + varint(len(payload)) + payload

    def feature(value) -> bytes:
        if isinstance(value, (bytes, str)):
            raw = value.encode() if isinstance(value, str) else value
            return field(1, field(1, raw))
        arr = np.asarray(value).reshape(-1)
        if np.issubdtype(arr.dtype, np.integer):
            body = b"".join(varint(int(x)) for x in arr)
            return field(3, field(1, body))
        body = struct.pack(f"<{arr.size}f", *arr.astype(np.float32))
        return field(2, field(1, body))

    with open(path, "wb") as f:
        for row in block.iter_rows():
            entries = b"".join(
                field(1, field(1, k.encode()) + field(2, feature(v)))
                for k, v in row.items()
            )
            example = field(1, entries)
            f.write(struct.pack("<Q", len(example)) + b"\x00" * 4)
            f.write(example + b"\x00" * 4)


# ---------------------------------------------------------------------------
# Arrow IPC / Feather + interop
# ---------------------------------------------------------------------------


class ArrowDatasource(FileDatasource):
    """Arrow IPC / Feather files -> Blocks (zero-copy numpy columns where
    the types allow)."""

    def _read_file(self, path: str) -> Block:
        import pyarrow.feather as feather

        return [block_from_arrow(feather.read_table(path))]


def block_from_arrow(table) -> Block:
    cols = {}
    for name in table.column_names:
        col = table.column(name).combine_chunks()
        try:
            cols[name] = col.to_numpy(zero_copy_only=False)
        except Exception:
            cols[name] = np.asarray(col.to_pylist(), dtype=object)
    return Block(cols)


def block_to_arrow(block: Block):
    import pyarrow as pa

    return pa.table({k: pa.array(v) for k, v in block.columns.items()})


def write_arrow_block(block: Block, path: str) -> None:
    import pyarrow.feather as feather

    feather.write_feather(block_to_arrow(block), path)


# ---------------------------------------------------------------------------
# SQL (sqlite3 or any DB-API connection factory)
# ---------------------------------------------------------------------------


class SQLDatasource(Datasource):
    """One ReadTask per query: `connection_factory() -> DB-API conn`.
    (reference: ray.data.read_sql)"""

    def __init__(self, sql: str, connection_factory: Callable[[], Any],
                 parallelism_queries: Optional[Sequence[str]] = None):
        self.sql = sql
        self.factory = connection_factory
        self.queries = list(parallelism_queries or [sql])

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        def make(query: str):
            def read():
                conn = self.factory()
                try:
                    cur = conn.cursor()  # DB-API 2.0 (conn.execute is sqlite-only)
                    cur.execute(query)
                    names = [d[0] for d in cur.description]
                    rows = [dict(zip(names, r)) for r in cur.fetchall()]
                finally:
                    conn.close()
                return [Block.from_rows(rows)]

            return read

        return [ReadTask(make(q)) for q in self.queries]


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


class ImageDatasource(FileDatasource):
    """Image files -> {"image": HWC uint8, "path": str} (reference:
    ray.data.read_images)."""

    def __init__(self, paths, size: Optional[tuple] = None, mode: str = "RGB"):
        super().__init__(paths)
        self.size = size
        self.mode = mode

    def _read_file(self, path: str):
        from PIL import Image

        img = Image.open(path).convert(self.mode)
        if self.size is not None:
            h, w = self.size  # reference convention (height, width)
            img = img.resize((w, h))
        arr = np.asarray(img)
        if self.size is None:
            # mixed sizes must survive Block.concat: object column
            col = np.empty(1, object)
            col[0] = arr
        else:
            col = arr[None]
        return [Block({
            "image": col,
            "path": np.asarray([path]),
        })]


# ---------------------------------------------------------------------------
# webdataset (tar shards of grouped files)
# ---------------------------------------------------------------------------


class WebDatasetDatasource(FileDatasource):
    """Tar shards where `key.ext` members group into one sample per key
    (reference: ray.data.read_webdataset). Decoding: .txt/.cls utf-8,
    .json json, image extensions via PIL, rest raw bytes."""

    IMG_EXTS = {"jpg", "jpeg", "png", "bmp", "gif", "webp"}

    def _read_file(self, path: str) -> Block:
        import json
        import tarfile

        samples: dict[str, dict] = {}
        with tarfile.open(path) as tar:
            for member in tar.getmembers():
                if not member.isfile():
                    continue
                key, dot, ext = member.name.rpartition(".")
                if not dot:
                    # extensionless member (README, LICENSE, ...): no
                    # sample key to group under — lumping them into one
                    # "" sample would cross-contaminate the shard
                    continue
                data = tar.extractfile(member).read()
                ext = ext.lower()
                if ext in ("txt", "cls"):
                    value: Any = data.decode()
                    if ext == "cls":
                        value = int(value)
                elif ext == "json":
                    value = json.loads(data)
                elif ext in self.IMG_EXTS:
                    from PIL import Image

                    value = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                else:
                    value = data
                samples.setdefault(key, {"__key__": key})[ext] = value
        rows = list(samples.values())
        # heterogeneous shards: union the keys (missing fields -> None) so
        # a caption-less sample doesn't KeyError the columnar build
        all_keys = sorted({k for r in rows for k in r})
        rows = [{k: r.get(k) for k in all_keys} for r in rows]
        return [Block.from_rows(rows)]
