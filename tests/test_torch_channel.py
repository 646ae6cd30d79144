"""The port's channels and device objects on the CPU, across the port's
actors (``ray_tpu_torch.experimental``).

- the accelerator-context registry and the communicator over a collective
  group (the counterparts of ``tests/test_communicator.py``);
- ``CudaTensorChannel`` over the store backend between two actors: a
  nested value of tensors (fp32, bf16, int64), a numpy array, scalars and
  None round-trips exactly; values in turn wait for the reader's
  acknowledgement; an int8 channel sends large float leaves as the codec's
  codes and scales (the reader's leaf is, bit for bit, the JAX package's
  ``dequantize_blocks(quantize_blocks(x))``) and small or integer ones
  exactly, and ``last_write_nbytes``/``last_read_nbytes`` are the wire
  bytes (the counterparts of ``tests/test_xla_tensor_channel.py:86-143``,
  without the DAG); a closed channel fails its reader;
- device objects (the counterparts of ``tests/test_device_objects.py``): a
  local round trip, metadata-only pickling, a fetch from another actor
  through the host and cached after, through a shared collective group, a
  missing object, a driver-owned ref.

CUDA leaves (CUDA IPC between two processes on one card) are the card's:
``tests/test_torch_cuda_collective.py`` and smoke phase 4c.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.util.collective import compression as jcomp
from ray_tpu_torch.experimental import device_objects as dobj
from ray_tpu_torch.experimental.channel import (
    ChannelClosed,
    CollectiveGroupCommunicator,
    Communicator,
    CudaTensorChannel,
    get_accelerator_context,
    register_accelerator_context,
    set_accelerator_context,
)
from ray_tpu_torch.experimental.channel.accelerator_context import (
    current_context_name,
)


@rt.remote
class _End:
    def __init__(self):
        torch.set_num_threads(1)

    def write(self, chan, values):
        for v in values:
            chan.write(v, timeout=60)
        n = chan.last_write_nbytes
        chan.release(timeout=60)
        return n

    def read(self, chan, count=1):
        got = [chan.read(timeout=60) for _ in range(count)]
        n, path = chan.last_read_nbytes, chan.last_read_path
        chan.release(timeout=60)
        return got, n, path

    def comm(self, world, rank):
        cls = get_accelerator_context()
        comm = cls(world, rank, group_name="comm-test")
        x = torch.full((4,), float(rank + 1))
        total = comm.allreduce(x)
        gathered = comm.allgather(torch.tensor([float(rank)]))
        bcast = comm.broadcast(torch.tensor([42.0]) if rank == 0
                               else torch.zeros(1))
        comm.barrier()
        return (comm.get_rank(), comm.get_world_size(), total.tolist(),
                torch.cat(gathered).tolist(), bcast.tolist())

    def put(self, n):
        return dobj.device_put(torch.arange(float(n)))

    def total(self, ref):
        before = dobj.store_size()
        first = float(dobj.device_get(ref).sum())
        path = dobj.last_fetch_path
        again = float(dobj.device_get(ref).sum())
        return first, path, again, dobj.last_fetch_path, \
            dobj.store_size() - before

    def join(self, world, rank, name):
        from ray_tpu_torch.util import collective

        collective.init_collective_group(world, rank, backend="nccl",
                                         group_name=name)

    def send_ref(self, ref, name):
        dobj.device_send(ref, dst_rank=1, group_name=name)

    def get_from(self, ref, name):
        got = dobj.device_get(ref, group_name=name, src_rank=0)
        return got, dobj.last_fetch_path


@pytest.fixture(scope="module")
def ends():
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    rt.init(num_cpus=4)
    try:
        yield [_End.options(num_cpus=0).remote() for _ in range(2)]
    finally:
        rt.shutdown()
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads


def _send(ends, chan, values):
    """Write ``values`` from one actor and read them in the other, at once
    (the store group's join meets both ends)."""
    w = ends[0].write.remote(chan, values)
    r = ends[1].read.remote(chan, len(values))
    try:
        return rt.get(w, timeout=90), rt.get(r, timeout=90)
    finally:
        chan.destroy()


def test_registry_and_platform_default():
    assert current_context_name() == "cpu"  # no card here
    assert get_accelerator_context() is CollectiveGroupCommunicator

    class VendorComm(Communicator):
        pass

    register_accelerator_context("vendor-x", VendorComm)
    set_accelerator_context("vendor-x")
    try:
        assert get_accelerator_context() is VendorComm
    finally:
        set_accelerator_context("cpu")
    with pytest.raises(ValueError, match="no accelerator context"):
        set_accelerator_context("nonexistent")


@pytest.mark.timeout(120)
def test_communicator_collectives_across_actors(ends):
    outs = rt.get([e.comm.remote(2, r) for r, e in enumerate(ends)],
                  timeout=60)
    for r, (rank, world, total, gathered, bcast) in enumerate(outs):
        assert (rank, world) == (r, 2)
        assert total == [3.0] * 4
        assert gathered == [0.0, 1.0]
        assert bcast == [42.0]


def _nested():
    g = torch.Generator().manual_seed(3)
    return {"x": torch.randn(33, 7, generator=g),
            "b": torch.randn(5, 3, generator=g).to(torch.bfloat16),
            "i": torch.arange(10, dtype=torch.int64) - 4,
            "np": np.arange(6, dtype=np.float32).reshape(2, 3),
            "meta": {"tag": "s", "n": 7, "none": None},
            "t": (torch.ones(2, 2), 3.5, [None, "z"])}


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in ("x", "b", "i"):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert isinstance(got["np"], np.ndarray)
    assert np.array_equal(got["np"], want["np"])
    assert got["meta"] == want["meta"]
    assert torch.equal(got["t"][0], want["t"][0])
    assert got["t"][1:] == want["t"][1:]


@pytest.mark.timeout(120)
def test_nested_value_round_trips_exactly(ends):
    chan = CudaTensorChannel("chan-nested")
    value = _nested()
    wrote, (got, read, path) = _send(ends, chan, [value])
    _assert_same(got[0], value)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (value["x"], value["b"], value["i"], value["t"][0])) \
        + value["np"].nbytes
    assert wrote == read == nbytes
    assert path == "comm"


@pytest.mark.timeout(120)
def test_values_in_turn(ends):
    """The writer waits for each value's acknowledgement before the next:
    three values, in order."""
    chan = CudaTensorChannel("chan-turns", backend="store")
    values = [{"k": torch.full((4,), float(i)), "i": i} for i in range(3)]
    _, (got, _, _) = _send(ends, chan, values)
    for g, v in zip(got, values):
        assert g["i"] == v["i"] and torch.equal(g["k"], v["k"])


@pytest.mark.timeout(120)
def test_int8_leaves_are_the_codecs(ends):
    spec = {"scheme": "int8", "min_bytes": 1024}
    chan = CudaTensorChannel("chan-int8", compression=spec)
    rng = np.random.default_rng(11)
    big = rng.standard_normal(8192 + 77).astype(np.float32)
    value = {"x": torch.from_numpy(big.copy()),
             "h": torch.from_numpy(big[:4096].copy()).to(torch.bfloat16),
             "small": torch.arange(64, dtype=torch.float32),
             "ids": torch.arange(4096, dtype=torch.int64), "tag": "q"}
    wrote, (got, read, _) = _send(ends, chan, [value])
    got = got[0]
    for k, src in (("x", big), ("h", value["h"].float().numpy())):
        codes, scales = jcomp.quantize_blocks(src)
        want = jcomp.dequantize_blocks(codes, scales, src.size)
        assert got[k].dtype == value[k].dtype
        assert torch.equal(got[k], torch.from_numpy(want).to(value[k].dtype)
                           .reshape(value[k].shape))
        assert not torch.equal(got[k], value[k])  # it went through the codec
    assert torch.equal(got["small"], value["small"])  # under min_bytes
    assert torch.equal(got["ids"], value["ids"])  # not float
    assert got["tag"] == "q"
    wire = sum(c.nbytes + s.nbytes for c, s in (
        jcomp.quantize_blocks(big), jcomp.quantize_blocks(
            value["h"].float().numpy()))) + 64 * 4 + 4096 * 8
    assert wrote == read == wire


@pytest.mark.timeout(60)
def test_a_closed_channel_fails_its_reader_and_bad_backends_raise(ends):
    chan = CudaTensorChannel("chan-lost")
    try:
        chan.close()
        with pytest.raises(ChannelClosed):
            chan.read(timeout=5)
    finally:
        chan.destroy()
    with pytest.raises(ValueError, match="backend"):
        CudaTensorChannel("chan-bad", backend="xla")


def test_device_ref_local_roundtrip():
    before = dobj.store_size()
    t = torch.arange(12.0).reshape(3, 4)
    ref = dobj.device_put(t)
    assert ref.shape == (3, 4) and ref.dtype == "float32"
    assert ref.device == "cpu"
    assert dobj.device_get(ref) is t and dobj.last_fetch_path == "local"
    dobj.device_free(ref)
    assert dobj.store_size() == before


def test_device_ref_serializes_metadata_only():
    ref = dobj.device_put(torch.zeros(1024, 1024))  # 4 MB
    try:
        assert len(pickle.dumps(ref)) < 1024
    finally:
        dobj.device_free(ref)


@pytest.mark.timeout(120)
def test_cross_actor_fetch(ends):
    producer, consumer = ends
    ref = rt.get(producer.put.remote(10), timeout=60)
    assert ref.shape == (10,) and ref.owner_actor_id is not None
    first, path, again, path2, added = rt.get(consumer.total.remote(ref),
                                              timeout=60)
    assert (first, path) == (45.0, "host")
    assert (again, path2, added) == (45.0, "local", 1)  # cached


@pytest.mark.timeout(120)
def test_fetch_through_a_shared_group(ends):
    producer, consumer = ends
    rt.get([e.join.remote(2, r, "dobj") for r, e in enumerate(ends)],
           timeout=60)
    ref = rt.get(producer.put.remote(6), timeout=60)
    sent = producer.send_ref.remote(ref, "dobj")
    got, path = rt.get(consumer.get_from.remote(ref, "dobj"), timeout=60)
    rt.get(sent, timeout=60)
    assert path == "group" and torch.equal(got, torch.arange(6.0))


def test_fetch_missing_object_errors():
    bogus = dobj.DeviceRef(object_id="deadbeef" * 4, owner_actor_id=None,
                           shape=(1,), dtype="float32")
    with pytest.raises(ValueError, match="no owner"):
        dobj.device_get(bogus)
    with pytest.raises(ValueError, match="BOTH group_name and src_rank"):
        dobj.device_get(bogus, group_name="g")


@pytest.mark.timeout(120)
def test_driver_owned_ref_fetched_by_actor(ends):
    ref = dobj.device_put(torch.arange(6.0))  # driver-owned
    try:
        first, path, _, _, _ = rt.get(ends[1].total.remote(ref), timeout=60)
        assert (first, path) == (15.0, "host")
    finally:
        dobj.device_free(ref)
