"""The port's datasets held against ray_tpu.data.

Every scenario of ``tests/test_data.py`` (transforms, shuffles, groupby,
aggregates, iteration, splits, actor pools, streaming splits, file
round trips) runs on both packages, each on its own in-process runtime
(4 CPUs) started and torn down around the scenario. Each case asserts what
the reference's test asserts; the ``[port]`` case also requires the port's
rows, or the error type names, equal to the reference's (from the ``[ref]``
case of the same scenario, or run on the spot when that case was not
selected). The reference's ``test_iter_jax_batches_sharded`` maps to
``iter_device_batches(device="cpu")``. Then what is the port's own: the
feed's dtypes and columns on the CPU, ``device="cuda"`` without CUDA, and
an actor pool that frees its instance when it is killed.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu_torch import data as tdata
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

PACKAGES = {"ref": (ray_tpu, jrt, jserve, jdata), "port": (ray_tpu_torch, trt, tserve, tdata)}
JOIN_S = 30.0  # every wait on a consumer thread is bounded by this
_RESULTS: dict = {}


def _reset(runtime, serve):
    """Serve down, then the runtime: a Serve controller left by an earlier
    test belongs to the runtime it was started on."""
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()


def _run(name: str, scenario, *args):
    """``scenario(data module, *args)`` on package ``name`` with a fresh
    runtime of 4 CPUs, torn down after; an exception is a result: (error
    type name, "raised")."""
    api, runtime, serve, data = PACKAGES[name]
    _reset(runtime, serve)
    api.init(num_cpus=4)
    try:
        return scenario(data, *args)
    except BaseException as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__, "raised"
    finally:
        _reset(runtime, serve)


def canon(x):
    """A value as nested tuples of (type name, content): equal canon means
    equal rows, column order and element types."""
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


def check(pkg: str, scenario, *args):
    """Run ``scenario`` on ``pkg``; on the port, require the reference's
    result. Returns this package's result."""
    key = (scenario.__name__, repr(args))
    got = _run(pkg, scenario, *args)
    _RESULTS[(pkg,) + key] = got
    if pkg == "port":
        ref = _RESULTS.get(("ref",) + key)
        if ref is None:
            ref = _run("ref", scenario, *args)
        assert canon(got) == canon(ref)
    if isinstance(got, tuple) and got[1:] == ("raised",):
        raise AssertionError(f"{scenario.__name__} raised {got[0]} on {pkg}")
    return got


# -- the scenarios of tests/test_data.py ------------------------------------


def s_range_take_count(rd):
    ds = rd.range(100)
    return ds.count(), ds.take(5)


def test_range_take_count(pkg):
    assert check(pkg, s_range_take_count) == (100, [0, 1, 2, 3, 4])


def s_map_batches_lazy_and_streaming(rd):
    calls = []

    def double(batch):
        calls.append(len(batch["item"]))
        return {"item": batch["item"] * 2}

    ds = rd.range(100, parallelism=10).map_batches(double)
    lazy = calls == []
    first = ds.take(3)
    # streaming: take(3) should not have processed all 10 blocks
    return lazy, first, sum(calls) < 100


def test_map_batches_lazy_and_streaming(pkg):
    assert check(pkg, s_map_batches_lazy_and_streaming) == (True, [0, 2, 4], True)


def s_map_filter_flatmap(rd):
    ds = rd.range(20).map(lambda x: x + 1).filter(lambda x: x % 2 == 0)
    return ds.take_all(), rd.from_items([1, 2]).flat_map(lambda x: [x, x * 10]).take_all()


def test_map_filter_flatmap(pkg):
    evens, flat = check(pkg, s_map_filter_flatmap)
    assert evens == [x for x in range(1, 21) if x % 2 == 0]
    assert flat == [1, 10, 2, 20]


def s_map_batches_batch_size_rebatching(rd):
    sizes = []

    def record(batch):
        sizes.append(len(batch["item"]))
        return batch

    rd.range(100, parallelism=20).map_batches(record, batch_size=25).materialize()
    return sorted(sizes)


def test_map_batches_batch_size_rebatching(pkg):
    sizes = check(pkg, s_map_batches_batch_size_rebatching)
    assert all(s >= 25 for s in sizes[1:]) and sum(sizes) == 100


def s_dict_rows_and_columns(rd):
    ds = rd.from_items([{"a": i, "b": float(i) * 2} for i in range(10)])
    return ds.schema(), ds.select_columns(["b"]).take(2), ds.rename_columns({"a": "x"}).take(1)[0]


def test_dict_rows_and_columns(pkg):
    schema, selected, renamed = check(pkg, s_dict_rows_and_columns)
    assert schema == {"a": "int64", "b": "float64"}
    assert selected == [{"b": 0.0}, {"b": 2.0}]
    assert set(renamed) == {"x", "b"}


def s_add_drop_columns(rd):
    ds = rd.from_items([{"a": 1}, {"a": 2}]).add_column("b", lambda b: b["a"] * 10)
    return ds.take_all(), ds.drop_columns(["a"]).take_all()


def test_add_drop_columns(pkg):
    added, dropped = check(pkg, s_add_drop_columns)
    assert added == [{"a": 1, "b": 10}, {"a": 2, "b": 20}]
    assert dropped == [{"b": 10}, {"b": 20}]


def s_repartition_no_shuffle_preserves_order(rd):
    mat = rd.range(50, parallelism=7).repartition(3).materialize()
    return mat.num_blocks(), mat.take_all()


def test_repartition_no_shuffle_preserves_order(pkg):
    assert check(pkg, s_repartition_no_shuffle_preserves_order) == (3, list(range(50)))


def s_repartition_shuffle(rd):
    return rd.range(50, parallelism=5).repartition(4, shuffle=True).take_all()


def test_repartition_shuffle(pkg):
    assert sorted(check(pkg, s_repartition_shuffle)) == list(range(50))


def s_random_shuffle(rd):
    return rd.range(100, parallelism=5).random_shuffle(seed=7).take_all()


def test_random_shuffle(pkg):
    out = check(pkg, s_random_shuffle)
    assert sorted(out) == list(range(100)) and out != list(range(100))


def s_sort(rd):
    vals = np.random.default_rng(0).permutation(200)
    asc = rd.from_items([{"v": int(v)} for v in vals]).sort("v")
    desc = rd.from_items([{"v": int(v)} for v in vals]).sort("v", descending=True)
    return [r["v"] for r in asc.take_all()], [r["v"] for r in desc.take_all()]


def test_sort(pkg):
    asc, desc = check(pkg, s_sort)
    assert asc == sorted(asc) and desc == sorted(desc, reverse=True) and len(asc) == 200


def s_groupby_aggregate(rd):
    rows = [{"k": i % 3, "v": i} for i in range(30)]
    return rd.from_items(rows).groupby("k").aggregate(rd.Count(), rd.Sum("v"),
                                                      rd.Mean("v")).take_all()


def test_groupby_aggregate(pkg):
    out = {r["k"]: r for r in check(pkg, s_groupby_aggregate)}
    assert set(out) == {0, 1, 2}
    for k in (0, 1, 2):
        vals = [i for i in range(30) if i % 3 == k]
        assert out[k]["count()"] == 10
        assert out[k]["sum(v)"] == sum(vals)
        assert out[k]["mean(v)"] == pytest.approx(np.mean(vals))


def s_global_aggregates(rd):
    ds = rd.from_items([{"v": float(i)} for i in range(10)])
    return ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"), ds.std("v")


def test_global_aggregates(pkg):
    s, lo, hi, mean, std = check(pkg, s_global_aggregates)
    assert (s, lo, hi) == (45.0, 0.0, 9.0)
    assert mean == pytest.approx(4.5)
    assert std == pytest.approx(np.std(np.arange(10.0), ddof=1))


def s_limit_short_circuits(rd):
    calls = []

    def spy(batch):
        calls.append(1)
        return batch

    rows = rd.range(1000, parallelism=100).map_batches(spy).limit(5).take_all()
    return rows, len(calls) < 100


def test_limit_short_circuits(pkg):
    assert check(pkg, s_limit_short_circuits) == ([0, 1, 2, 3, 4], True)


def s_union_zip(rd):
    a, b = rd.range(5), rd.range(5).map(lambda x: x + 5)
    z = rd.from_items([{"a": i} for i in range(6)]).zip(
        rd.from_items([{"b": i * 2} for i in range(6)]))
    return a.union(b).take_all(), z.take_all()


def test_union_zip(pkg):
    union, zipped = check(pkg, s_union_zip)
    assert union == list(range(10))
    assert zipped == [{"a": i, "b": i * 2} for i in range(6)]


def s_iter_batches_sizes(rd):
    ds = rd.range(103, parallelism=10)
    return ([len(b["item"]) for b in ds.iter_batches(batch_size=25)],
            [len(b["item"]) for b in ds.iter_batches(batch_size=25, drop_last=True)])


def test_iter_batches_sizes(pkg):
    assert check(pkg, s_iter_batches_sizes) == ([25, 25, 25, 25, 3], [25, 25, 25, 25])


def s_iter_device_batches(rd, cpu_devices):
    """The reference's iter_jax_batches over a dp=8 sharding; the port's
    iter_device_batches on the CPU (no sharding until the mesh is ported).
    Returned: the batches as numpy, and what kind of array each package
    handed out."""
    ds = rd.from_numpy({"x": np.arange(64, dtype=np.float32)})
    if rd is jdata:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ray_tpu.parallel.mesh import MeshSpec, make_mesh

        sharding = NamedSharding(make_mesh(MeshSpec(dp=8), devices=cpu_devices), P(("dp",)))
        batches = list(ds.iter_jax_batches(batch_size=16, sharding=sharding))
        assert isinstance(batches[0]["x"], jax.Array) and batches[0]["x"].sharding == sharding
    else:
        batches = list(ds.iter_device_batches(batch_size=16, device="cpu"))
        assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
                   for b in batches)
    return [{k: np.asarray(v) for k, v in b.items()} for b in batches]


def test_iter_jax_batches_sharded(pkg, cpu_devices):
    batches = check(pkg, s_iter_device_batches, cpu_devices)
    assert len(batches) == 4
    np.testing.assert_array_equal(np.concatenate([b["x"] for b in batches]),
                                  np.arange(64, dtype=np.float32))


class AddState:
    def __init__(self, offset):
        self.offset = offset

    def __call__(self, batch):
        return {"item": batch["item"] + self.offset}


def s_actor_pool_map_batches(rd):
    return rd.range(40, parallelism=8).map_batches(
        AddState, compute=rd.ActorPoolStrategy(size=2), fn_constructor_args=(100,)).take_all()


def test_actor_pool_map_batches(pkg):
    assert check(pkg, s_actor_pool_map_batches) == [i + 100 for i in range(40)]


def s_streaming_split_disjoint_and_complete(rd):
    its = rd.range(100, parallelism=10).streaming_split(2)
    results = [[], []]

    def consume(i):
        for row in its[i].iter_rows():
            results[i].append(row)

    ts = [threading.Thread(target=consume, args=(i,)) for i in (0, 1)]
    [t.start() for t in ts]
    [t.join(timeout=JOIN_S) for t in ts]
    assert not any(t.is_alive() for t in ts), "a split's consumer outlived its join"
    return results


def test_streaming_split_disjoint_and_complete(pkg):
    results = check(pkg, s_streaming_split_disjoint_and_complete)
    assert sorted(results[0] + results[1]) == list(range(100))
    assert results[0] and results[1]


def s_local_shuffle_buffer(rd):
    out = []
    for b in rd.range(100, parallelism=4).iter_batches(batch_size=10,
                                                        local_shuffle_buffer_size=50):
        out.extend(b["item"].tolist())
    # unseeded, as the reference's test: the order is not comparable
    return sorted(out), out != list(range(100))


def test_local_shuffle_buffer(pkg):
    assert check(pkg, s_local_shuffle_buffer) == (list(range(100)), True)


def s_csv_json_roundtrip(rd, root):
    rows = [{"a": i, "b": float(i) / 2} for i in range(25)]
    ds = rd.from_items(rows)
    ds.write_csv(str(root / "csv"))
    got_csv = sorted(rd.read_csv(str(root / "csv")).take_all(), key=lambda r: r["a"])
    ds.write_json(str(root / "json"))
    got_json = sorted(rd.read_json(str(root / "json")).take_all(), key=lambda r: r["a"])
    return rows, got_csv, got_json


def test_csv_json_roundtrip(pkg, tmp_path):
    rows, got_csv, got_json = check(pkg, s_csv_json_roundtrip, tmp_path)
    assert [r["a"] for r in got_csv] == [r["a"] for r in rows]
    assert got_json == rows


def s_read_text(rd, root):
    p = root / "f.txt"
    p.write_text("hello\nworld\n")
    return [r["text"] for r in rd.read_text(str(p)).take_all()]


def test_read_text(pkg, tmp_path):
    assert check(pkg, s_read_text, tmp_path) == ["hello", "world"]


def s_random_split_and_split(rd):
    parts = rd.range(100).random_split([0.7, 0.3], seed=0)
    return (parts[0].take_all(), parts[1].take_all(),
            sorted(len(x.take_all()) for x in rd.range(10).split(3)))


def test_random_split_and_split(pkg):
    a, b, sizes = check(pkg, s_random_split_and_split)
    assert len(a) == 70 and len(b) == 30 and sorted(a + b) == list(range(100))
    assert sizes == [3, 3, 4]


def s_schema_and_size(rd):
    ds = rd.from_items([{"a": 1}]).materialize()
    return ds.schema(), ds.size_bytes()


def test_schema_and_size(pkg):
    schema, size = check(pkg, s_schema_and_size)
    assert schema == {"a": "int64"} and size > 0


def s_ragged_object_columns(rd):
    rows = [{"x": [1, 2]}, {"x": [1]}, {"x": [5, 6, 7]}]
    return [list(r["x"]) for r in rd.from_items(rows, parallelism=1).take_all()]


def test_ragged_object_columns(pkg):
    assert check(pkg, s_ragged_object_columns) == [[1, 2], [1], [5, 6, 7]]


def s_map_groups(rd):
    rows = [{"k": i % 2, "v": i} for i in range(10)]
    return (rd.from_items(rows).groupby("k")
            .map_groups(lambda b: {"k": b["k"][:1], "n": [len(b["v"])]}).take_all())


def test_map_groups(pkg):
    out = check(pkg, s_map_groups)
    assert sorted((r["k"], r["n"]) for r in out) == [(0, 5), (1, 5)]


def s_seeded_shuffle_not_block_correlated(rd):
    return rd.range(64, parallelism=4).random_shuffle(seed=3).take_all()


def test_seeded_shuffle_not_block_correlated(pkg):
    out = check(pkg, s_seeded_shuffle_not_block_correlated)
    assert sorted(out) == list(range(64))
    pos = {v: i for i, v in enumerate(out)}
    assert len({pos[v + 16] - pos[v] for v in range(16)}) > 1, "block-correlated shuffle"


def s_streaming_split_close_unblocks(rd):
    its = rd.range(1000, parallelism=50).streaming_split(2)
    it0 = iter(its[0].iter_rows())
    next(it0)
    its[0].splitter.close()
    # the pump must exit; split 1 sees end-of-stream instead of hanging
    rows = []
    t = threading.Thread(target=lambda: rows.extend(its[1].iter_rows()))
    t.start()
    t.join(timeout=JOIN_S)
    return not t.is_alive()


def test_streaming_split_close_unblocks(pkg):
    assert check(pkg, s_streaming_split_close_unblocks) is True


def s_iter_batches_large_block_linear(rd):
    ds = rd.from_numpy({"x": np.arange(200_000)})
    t0 = time.monotonic()
    n = sum(len(b["x"]) for b in ds.iter_batches(batch_size=128))
    dt = time.monotonic() - t0
    return n, dt < 5.0


def test_iter_batches_large_block_linear(pkg):
    assert check(pkg, s_iter_batches_large_block_linear) == (200_000, True)


# -- error types --------------------------------------------------------------


def e_zip_row_counts(rd):
    return rd.range(3).zip(rd.range(4)).take_all()


def e_actor_pool_needs_a_class(rd):
    return rd.range(4).map_batches(lambda b: b, compute=rd.ActorPoolStrategy(size=1)).take_all()


def e_aggregate_needs_on(rd):
    return rd.from_items([{"a": 1, "b": 2}]).sum()


def e_fractions_must_sum_to_one(rd):
    return rd.range(10).random_split([0.5, 0.2])


def e_map_batches_raises(rd):
    def boom(batch):
        raise KeyError("no such column")

    return rd.range(4).map_batches(boom).take_all()


def e_no_files(rd, root):
    return rd.read_csv(str(root / "missing" / "*.csv")).take_all()


def e_ragged_block(rd):
    return rd.Block({"a": np.arange(2), "b": np.arange(3)})


ERRORS = {f.__name__[2:]: (f, n) for f, n in [
    (e_zip_row_counts, "ValueError"), (e_actor_pool_needs_a_class, "ValueError"),
    (e_aggregate_needs_on, "TaskError"), (e_fractions_must_sum_to_one, "ValueError"),
    (e_map_batches_raises, "TaskError"), (e_no_files, "FileNotFoundError"),
    (e_ragged_block, "ValueError")]}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_type_names_equal_reference(pkg, case, tmp_path):
    fn, name = ERRORS[case]
    args = (tmp_path,) if case == "no_files" else ()
    key = (fn.__name__, repr(args))
    got = _run(pkg, fn, *args)
    _RESULTS[(pkg,) + key] = got
    assert got == (name, "raised")
    if pkg == "port":
        assert got == _RESULTS.get(("ref",) + key) or got == _run("ref", fn, *args)


# -- the port's own -----------------------------------------------------------


@pytest.fixture
def port_rt():
    _reset(trt, tserve)
    ray_tpu_torch.init(num_cpus=4)
    yield
    _reset(trt, tserve)


def test_device_feed_dtypes_and_object_columns_on_cpu(port_rt):
    """Every column of every batch equals its host batch; dtypes apply on
    the host (a numpy dtype, and bfloat16, which numpy lacks); object
    columns stay lists; a batch owns its memory."""
    rng = np.random.default_rng(0)
    cols = {"tok": rng.integers(0, 1000, (20, 5), dtype=np.int32),
            "x": rng.standard_normal((20, 3)).astype(np.float32),
            "w": rng.standard_normal(20),
            "s": np.array([f"r{i}" for i in range(20)], dtype=object)}
    ds = tdata.from_numpy(cols)
    host = list(ds.iter_batches(batch_size=8))
    fed = list(ds.iter_device_batches(batch_size=8, device="cpu",
                                      dtypes={"w": np.float32, "x": torch.bfloat16}))
    assert [len(b["s"]) for b in fed] == [8, 8, 4]
    for h, f in zip(host, fed):
        assert torch.equal(f["tok"], torch.from_numpy(h["tok"]))
        assert f["w"].dtype == torch.float32
        assert torch.equal(f["w"], torch.from_numpy(h["w"].astype(np.float32)))
        assert f["x"].dtype == torch.bfloat16
        assert torch.equal(f["x"], torch.from_numpy(h["x"]).to(torch.bfloat16))
        assert f["s"] == list(h["s"])
        assert f["tok"].data_ptr() != torch.from_numpy(h["tok"]).data_ptr()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_feed_order_and_last_batch(port_rt, prefetch):
    ds = tdata.range(50, parallelism=7)
    got = [b["item"].tolist() for b in ds.iter_device_batches(batch_size=16, device="cpu",
                                                              prefetch=prefetch)]
    assert got == [list(range(i, min(i + 16, 50))) for i in range(0, 50, 16)]
    dropped = list(ds.iter_device_batches(batch_size=16, device="cpu", drop_last=True,
                                          prefetch=prefetch))
    assert [len(b["item"]) for b in dropped] == [16, 16, 16]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_device_feed_on_cuda_without_a_gpu_raises(port_rt):
    ds = tdata.range(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.iter_device_batches(batch_size=4)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.iterator().iter_device_batches(batch_size=4, device="cuda:0")


class _Held:
    def __call__(self):
        return 1


def test_killed_actor_drops_its_instance(port_rt):
    """A killed actor's instance (an engine stage holds the KV cache and
    graphs there) is freed although a handle to the actor lives on."""
    h = ray_tpu_torch.remote(_Held).remote()
    assert ray_tpu_torch.get(h.__call__.remote(), timeout=JOIN_S) == 1
    actor = h._actor
    ref = weakref.ref(actor.instance)
    ray_tpu_torch.kill(h)
    actor._thread.join(timeout=JOIN_S)
    assert not actor._thread.is_alive()
    assert ref() is None and actor.instance is None


class _Stage:
    """A map_batches class that records its instances."""

    made: list = []

    def __init__(self):
        _Stage.made.append(weakref.ref(self))

    def __call__(self, batch):
        return {"item": batch["item"] + 1}


def test_actor_pool_frees_the_stage_after_the_stream(port_rt):
    _Stage.made = []
    out = tdata.range(32, parallelism=4).map_batches(_Stage, concurrency=1).take_all()
    assert out == list(range(1, 33)) and len(_Stage.made) == 1
    deadline = time.monotonic() + JOIN_S
    while _Stage.made[0]() is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    gc.collect()
    assert _Stage.made[0]() is None
