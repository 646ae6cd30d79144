"""The port's data layer against the JAX package's, on the CPU.

Both runtimes run in this process (``ray_tpu.init``, then
``ray_tpu_torch.init``, in a module fixture).  The same rows, made from a
seed with numpy, go through ``ray_tpu.data`` (Arrow blocks) and
``ray_tpu_torch.data`` (numpy blocks), and the rows that come out must be
equal as Python values (a tensor row as a list): map_batches, filters by
callable and by expression, sorts with nulls and NaN in both directions,
groupby aggregates, every join kind, zip, the seeded shuffle and split,
``train_test_split`` and ``random_sample``, then whole pipelines.  Joins
and groups compare as multisets (Acero's and Arrow's grouper's row orders
are unspecified).  Float aggregates
(sum, mean, std over float columns) may differ in summation order and are
held to a relative 1e-12; every other value is exact.

Then the ingest layer: a streaming split with one consumer drained in the
middle of an epoch delivers every row exactly once in both packages; the
partial-batch modes and the ``mask`` column are the JAX package's; and a
subprocess with pyarrow and pandas blocked runs the port's pipeline to
torch batches, as the card's machine (which has neither) does.
"""

import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

PKGS = ("ray_tpu", "ray_tpu_torch")
FLOAT_RTOL = 1e-12  # float aggregates: another summation order


@pytest.fixture(scope="module")
def runtimes():
    os.environ.setdefault("RAY_TPU_NUM_CHIPS", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ray_tpu.init(num_cpus=2)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _data(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.data")


def _py(v):
    """A value as plain Python (numpy arrays and scalars converted)."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _py(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_py(x) for x in v]
    return v


def _same(a, b):
    """Equal as Python values, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _both(fn):
    """fn(data module) for each package, as Python values."""
    return [_py(fn(_data(p))) for p in PKGS]


def _assert_rows_equal(fn):
    want, got = _both(fn)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert _same(w, g), (i, w, g)
    return got


def _multiset(rows):
    return sorted(rows, key=repr)


def _rows(n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = float(np.round(rng.normal(), 6))
        out.append({
            "id": i,
            "k": None if i % 7 == 3 else int(rng.integers(0, 4)),
            "v": float(np.round(rng.normal(), 6)),
            "f": None if i % 11 == 5 else (float("nan") if i % 13 == 4 else f),
            "s": None if i % 9 == 2 else str(rng.choice(["a", "bb", "c"])),
            "tags": [int(x) for x in rng.integers(0, 9, int(rng.integers(0, 4)))],
        })
    return out


ROWS = _rows()


def _ds(d, rows=ROWS, parallelism=4):
    return d.from_items(rows, parallelism=parallelism)


# -- (a) the block functions, fed the same rows ----------------------------

def test_map_batches_in_numpy_batches(runtimes):
    def fn(b):
        return {"id": b["id"], "y": b["v"] * 2 + b["id"]}

    _assert_rows_equal(lambda d: _ds(d).drop_columns(["tags", "f", "s", "k"])
                       .map_batches(fn, batch_size=7).take_all())


@pytest.mark.parametrize("pred", [
    lambda r: r["k"] is not None and r["k"] > 1,
    lambda r: "a" in (r["s"] or ""),
    lambda r: len(r["tags"]) == 2,
], ids=["int-with-nulls", "string", "ragged-list"])
def test_filter_by_callable(runtimes, pred):
    _assert_rows_equal(lambda d: _ds(d).filter(pred).take_all())


@pytest.mark.parametrize("expr", ["v > 0.3", "k != 2", "k >= 1", "s == 'bb'",
                                  "id < 17", "f <= 0.5"])
def test_filter_by_expression(runtimes, expr):
    rows = _assert_rows_equal(lambda d: _ds(d).filter(expr=expr).take_all())
    assert 0 < len(rows) < len(ROWS)


@pytest.mark.parametrize("key", ["k", "f", "s", "v"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_with_nulls(runtimes, key, descending):
    rows = _assert_rows_equal(
        lambda d: _ds(d).sort(key, descending=descending).take_all())
    if key in ("k", "s", "f"):
        assert rows[-1][key] is None  # nulls last in both directions


def test_sort_merge_of_parts_is_stable(runtimes):
    """The reduce side on its own: ties keep their input order."""
    from ray_tpu.data import dataset as jd
    from ray_tpu.data.block import to_arrow
    from ray_tpu_torch.data import dataset as td
    from ray_tpu_torch.data.block import iter_block_rows, to_block

    parts = [ROWS[:13], ROWS[13:29], ROWS[29:]]
    for desc in (False, True):
        want = jd._sort_merge_parts("k", desc, *[to_arrow(p) for p in parts])
        got = td._sort_merge_parts("k", desc, *[to_block(p) for p in parts])
        assert _same(_py(list(iter_block_rows(got))), want.to_pylist())


def _agg_equal(want, got, float_cols):
    """Group rows equal, float aggregates within FLOAT_RTOL; groups compare
    by key (Arrow's grouper orders them as it likes)."""
    assert len(want) == len(got)
    first = lambda r: repr(next(iter(r.values())))  # noqa: E731 — the key
    for w, g in zip(sorted(want, key=first), sorted(got, key=first)):
        assert w.keys() == g.keys()
        for c in w:
            if c in float_cols and w[c] is not None:
                assert g[c] == pytest.approx(w[c], rel=FLOAT_RTOL), (c, w, g)
            else:
                assert _same(w[c], g[c]), (c, w, g)


@pytest.mark.parametrize("agg", ["count", "sum", "mean", "min", "max", "std"])
def test_groupby_aggregate(runtimes, agg):
    def run(d):
        g = _ds(d).groupby("k")
        return g.count() if agg == "count" else getattr(g, agg)("v")

    want, got = _both(lambda d: run(d).take_all())
    _agg_equal(want, got, {"sum(v)", "mean(v)", "std(v)"})


def test_groupby_aggregate_many(runtimes):
    aggs = [("id", "sum"), ("v", "min"), ("id", "max"), ("f", "count"),
            ("s", "count_distinct"), ("v", "variance")]
    want, got = _both(lambda d: _ds(d).groupby("s").aggregate(*aggs).take_all())
    _agg_equal(want, got, {"v_variance"})


def test_groupby_map_groups(runtimes):
    def fn(rows):
        return {"k": rows[0]["k"], "n": len(rows),
                "ids": sorted(r["id"] for r in rows)}

    want, got = _both(lambda d: _ds(d).groupby("k")
                      .map_groups(fn, num_partitions=3).take_all())
    assert _multiset(want) == _multiset(got)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("right_key", ["k", "key"])
def test_join(runtimes, how, right_key):
    rng = np.random.default_rng(3)
    right = [{right_key: None if i == 4 else int(rng.integers(0, 6)),
              "w": i * 10, "s": f"r{i}"} for i in range(9)]

    def run(d):
        left = _ds(d).select_columns(["id", "k", "s"])
        other = d.from_items(right, parallelism=2)
        return left.join(other, on="k", right_on=right_key, how=how,
                         num_partitions=3).take_all()

    want, got = _both(run)
    assert _multiset(want) == _multiset(got)
    assert len(got) > 0


def test_zip(runtimes):
    def run(d):
        a = _ds(d).select_columns(["id", "s"])
        b = d.from_items([{"s": r["id"] * 2, "z": r["v"]} for r in ROWS],
                         parallelism=3)
        return a.zip(b).take_all()

    rows = _assert_rows_equal(run)
    assert set(rows[0]) == {"id", "s", "s_1", "z"}


def test_random_shuffle_under_a_seed(runtimes):
    rows = _assert_rows_equal(lambda d: _ds(d).random_shuffle(seed=3).take_all())
    assert [r["id"] for r in rows] != list(range(len(ROWS)))


def test_split(runtimes):
    want, got = _both(lambda d: [p.take_all() for p in _ds(d).split(3)])
    assert len(got) == 3 and _same(want, got)


@pytest.mark.parametrize("shuffle", [False, True])
def test_train_test_split(runtimes, shuffle):
    want, got = _both(lambda d: [p.take_all() for p in _ds(d).train_test_split(
        0.25, shuffle=shuffle, seed=5)])
    assert _same(want, got)
    assert len(got[1]) == 10


def test_random_sample(runtimes):
    rows = _assert_rows_equal(
        lambda d: _ds(d).random_sample(0.4, seed=7).take_all())
    assert 0 < len(rows) < len(ROWS)


# -- (b) pipelines end to end through both runtimes ------------------------

def test_pipeline_map_flat_map_filter_repartition_sort(runtimes):
    def run(d):
        return (d.range(100, parallelism=5)
                .map_batches(lambda b: {"id": b["id"], "x": b["id"] * 3},
                             batch_size=7)
                .flat_map(lambda r: [r, {"id": -r["id"], "x": r["x"] + 1}])
                .filter(lambda r: r["x"] % 2 == 0)
                .repartition(3).sort("id").take_all())

    assert len(_assert_rows_equal(run)) == 100


def _add_offset():
    # made in a function, so it travels by value (workers cannot import
    # this module)
    class AddOffset:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, batch):
            return {"id": batch["id"], "y": batch["id"] + self.offset}

    return AddOffset


def test_pipeline_on_an_actor_pool(runtimes):
    def run(d):
        return (d.range(60, parallelism=6)
                .map_batches(_add_offset(), batch_size=10,
                             compute=d.ActorPoolStrategy(size=2),
                             fn_constructor_args=(1000,))
                .take_all())

    rows = _assert_rows_equal(run)
    assert rows[5] == {"id": 5, "y": 1005}


def test_iter_batches_across_block_boundaries(runtimes):
    def run(d):
        ds = d.from_numpy(np.arange(50, dtype=np.int64)).repartition(4)
        return [b["data"] for b in ds.iter_batches(batch_size=16)]

    batches = _assert_rows_equal(run)
    assert [len(b) for b in batches] == [16, 16, 16, 2]


def test_limit_union_unique_count_and_aggregates(runtimes):
    def run(d):
        ds = _ds(d)
        return {
            "limit": ds.limit(9).take_all(),
            "union": ds.limit(3).union(ds.limit(2)).take_all(),
            "unique": ds.unique("k"),
            "count": ds.count(),
            "columns": ds.columns(),
            "min": ds.min("v"), "max": ds.max("v"), "sum_id": ds.sum("id"),
            "rows": list(ds.iter_rows())[:5],
        }

    want, got = _both(run)
    assert _same(want, got)
    for agg in ("sum", "mean", "std"):
        w, g = _both(lambda d: getattr(_ds(d), agg)("v"))
        assert g == pytest.approx(w, rel=FLOAT_RTOL)


# -- (c) streaming_split: a consumer drained in the middle of an epoch --------

@pytest.mark.parametrize("pkg", PKGS)
def test_streaming_split_drain_delivers_every_row_once(runtimes, pkg):
    import importlib

    d = _data(pkg)
    ingest = importlib.import_module(f"{pkg}.data._internal.ingest")
    splits = d.range(96, parallelism=1).repartition(12).streaming_split(2)
    seen = {0: [], 1: []}
    drained = threading.Event()
    errors = []

    def drained_consumer():
        try:
            shard = ingest.DataShard(
                splits[0], name="drain",
                drain_probe=lambda: len(seen[0]) >= 16)
            for b in shard.iter_batches(batch_size=8, prefetch_batches=0):
                seen[0].extend(int(x) for x in b["id"])
            assert shard.drained
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        finally:
            drained.set()

    def survivor():
        try:
            for i, b in enumerate(splits[1].iter_batches(batch_size=8)):
                seen[1].extend(int(x) for x in b["id"])
                if i == 0:
                    drained.wait(60)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (drained_consumer,
                                                     survivor)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    everything = seen[0] + seen[1]
    assert sorted(everything) == list(range(96))
    assert 16 <= len(seen[0]) < 48 < len(seen[1])


# -- (d) partial batches and the mask column -------------------------------

@pytest.mark.parametrize("mode", ["error", "drop", "pad"])
def test_apply_partial_batch(mode):
    from ray_tpu.data._internal import ingest as ji
    from ray_tpu_torch.data._internal import ingest as ti

    rng = np.random.default_rng(1)
    batch = {"x": rng.normal(size=(5, 3)).astype(np.float32),
             "id": np.arange(5, dtype=np.int64)}
    want = ji.apply_partial_batch(dict(batch), 8, mode)
    got = ti.apply_partial_batch(dict(batch), 8, mode)
    if mode == "drop":
        assert want is None and got is None
        return
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    if mode == "pad":
        assert got["mask"].tolist() == [1.0] * 5 + [0.0] * 3
    with pytest.raises(ValueError, match="partial_batch"):
        ti.apply_partial_batch(dict(batch), 8, "nope")


@pytest.mark.parametrize("mode", ["error", "drop", "pad"])
def test_device_batches_in_each_partial_mode(runtimes, mode):
    """The port's iter_device_batches (host tensors: device="cpu") against
    the JAX package's iter_jax_batches on its CPU device."""
    import jax

    x = np.random.default_rng(2).normal(size=21).astype(np.float32)

    def ds(d):  # 1-D columns: the JAX package's blocks take no 2-D array
        return d.from_numpy({"x": x, "id": np.arange(21)}).repartition(2)

    want = [{k: np.asarray(v) for k, v in b.items()}
            for b in ds(_data("ray_tpu")).iter_jax_batches(
                batch_size=8, partial_batch=mode, device=jax.devices("cpu")[0])]
    got = [{k: v.numpy() for k, v in b.items()}
           for b in ds(_data("ray_tpu_torch")).iter_device_batches(
               batch_size=8, partial_batch=mode, device="cpu")]
    assert [len(b["id"]) for b in got] == {"error": [8, 8, 5], "drop": [8, 8],
                                           "pad": [8, 8, 8]}[mode]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            if k != "id":  # JAX keeps int64 as int32 without jax_enable_x64
                assert g[k].dtype == w[k].dtype, k


def test_device_batches_refuse_a_mesh_and_a_missing_card(runtimes):
    import torch

    from ray_tpu_torch.parallel.mesh import MeshSpec

    ds = ray_tpu_torch.data.range(4)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        ds.iter_device_batches(device=MeshSpec(data=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device|none is available"):
            ds.iter_device_batches()


# -- (h) where pyarrow and pandas are not installed -------------------------

_NO_ARROW = r"""
import os, sys
sys.modules["pyarrow"] = None
sys.modules["pandas"] = None
os.environ["RAY_TPU_NUM_CHIPS"] = "0"
os.environ["RAY_TPU_DISABLE_METADATA_SERVER"] = "1"
import numpy as np
import ray_tpu_torch
import ray_tpu_torch.data as rd
ray_tpu_torch.init(num_cpus=2)
try:
    tok = np.arange(24 * 5).reshape(24, 5)
    ds = rd.from_numpy({"tok": tok, "id": np.arange(24)}).map_batches(
        lambda b: {"tok": b["tok"] + 1, "id": b["id"]}, batch_size=6)
    (split,) = ds.streaming_split(1)
    got = [b for b in split.iter_torch_batches(batch_size=10)]
    assert [len(b["id"]) for b in got] == [10, 10, 4], got
    import torch
    assert torch.equal(torch.cat([b["tok"] for b in got]),
                       torch.from_numpy(tok + 1))
    try:
        ds.iter_batches(batch_format="pyarrow").__next__()
    except ImportError as e:
        assert "pyarrow" in str(e)
    else:
        raise AssertionError("batch_format='pyarrow' did not raise")
finally:
    ray_tpu_torch.shutdown()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("pyarrow", "pandas")
             and sys.modules[m] is not None)
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_the_port_runs_its_pipeline_without_pyarrow_or_pandas():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _NO_ARROW], cwd=root, env=env,
                         capture_output=True, text=True, timeout=50)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "LOADED []" in res.stdout
