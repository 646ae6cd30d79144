"""The port's readers and writers against the JAX package's, on the CPU.

The same files, written from a seed, read through ``ray_tpu.data`` and
``ray_tpu_torch.data``: the rows must be equal as Python values (a tensor
row as a list).  Parquet, CSV and JSON go through pyarrow inside the call
in both packages (the port's numpy blocks are made from its tables);
numpy, text and binary files need no Arrow in the port.  Then the port's
writers: what it writes, the JAX package reads back as the same rows.
"""

import importlib
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest

import ray_tpu
import ray_tpu_torch

from test_torch_data import _py, _same

PKGS = ("ray_tpu", "ray_tpu_torch")


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


def _rows(n=30, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": i, "x": float(np.round(rng.normal(), 5)),
             "name": str(rng.choice(["ann", "bo", "cy"])),
             "n": None if i % 6 == 1 else int(rng.integers(0, 100))}
            for i in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("readers")
    rows = _rows()
    table = pa.Table.from_pylist(rows)
    for i, (lo, hi) in enumerate([(0, 12), (12, 30)]):
        pq.write_table(table.slice(lo, hi - lo), d / f"p{i}.parquet")
        pacsv.write_csv(table.slice(lo, hi - lo).drop_columns(["n"]),
                        d / f"c{i}.csv")
        with open(d / f"j{i}.jsonl", "w") as f:
            for r in rows[lo:hi]:
                f.write(json.dumps(r) + "\n")
    rng = np.random.default_rng(1)
    np.save(d / "flat.npy", rng.integers(0, 9, 7))
    np.save(d / "rows.npy", rng.normal(size=(5, 3)))
    np.savez(d / "both.npz", a=np.arange(4), b=rng.normal(size=(4, 2)))
    (d / "t0.txt").write_text("alpha\nbeta gamma\n\ndelta\n")
    (d / "t1.txt").write_text("épsilon\n")
    (d / "b0.bin").write_bytes(bytes(range(40)))
    (d / "b1.bin").write_bytes(b"\x00\xffxyz")
    return d


def _read(pkg, reader, path, **kw):
    d = importlib.import_module(f"{pkg}.data")
    return _py(getattr(d, reader)(str(path), **kw).take_all())


@pytest.mark.parametrize("reader,pattern", [
    ("read_parquet", "p*.parquet"), ("read_csv", "c*.csv"),
    ("read_json", "j*.jsonl"), ("read_numpy", "flat.npy"),
    ("read_numpy", "rows.npy"), ("read_numpy", "both.npz"),
    ("read_text", "t*.txt"), ("read_binary_files", "b*.bin"),
], ids=["parquet", "csv", "json", "npy", "npy-2d", "npz", "text", "binary"])
def test_reader(runtimes, files, reader, pattern):
    want, got = (_read(p, reader, files / pattern) for p in PKGS)
    assert len(got) > 0
    assert _same(want, got), (want[:3], got[:3])


def test_parquet_pushdown_of_columns_and_predicate(runtimes, files):
    def run(pkg):
        d = importlib.import_module(f"{pkg}.data")
        ds = (d.read_parquet(str(files / "p*.parquet"))
              .select_columns(["id", "x", "n"]).filter(expr="id >= 7"))
        return _py(ds.take_all())

    want, got = (run(p) for p in PKGS)
    assert _same(want, got) and len(got) == 23 and set(got[0]) == {"id", "x", "n"}


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_the_ports_writer_is_read_back_by_the_jax_package(runtimes, tmp_path,
                                                          fmt):
    rows = [{k: v for k, v in r.items() if fmt == "parquet" or k != "n"}
            for r in _rows(seed=2)]
    out = tmp_path / fmt
    ray_tpu_torch.data.from_items(rows, parallelism=3).__getattribute__(
        f"write_{fmt}")(str(out))
    reader = {"parquet": "read_parquet", "csv": "read_csv",
              "json": "read_json"}[fmt]
    back = _read("ray_tpu", reader, out)
    assert _same(sorted(back, key=lambda r: r["id"]), rows)


def test_connectors_refuse_with_a_roadmap_pointer(runtimes, tmp_path):
    d = ray_tpu_torch.data
    for call in (lambda: d.read_avro(str(tmp_path)),
                 lambda: d.read_delta(str(tmp_path)),
                 lambda: d.range(3).write_avro(str(tmp_path))):
        with pytest.raises(NotImplementedError, match="ROADMAP A16, data/ connectors"):
            call()
