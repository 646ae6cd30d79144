"""The port's collectives and CUDA tensor channel on the card.

- ``NCCLGroup`` at world size 1 (NCCL refuses two ranks on one device, so a
  one-card machine runs no more): every op on CUDA tensors launches through
  NCCL (``last_backend == "nccl"``) and returns the right value;
- ``CudaTensorChannel`` between two processes on one card (two actors at
  half a card each): fp32 and bf16 tensors arrive bit for bit through CUDA
  IPC (``last_read_path == "ipc"``, no collective group made on either
  side), values in turn reuse one staging buffer, and a channel per value
  leaves the writer's allocated memory where it was once the reader has
  released; an int8 channel's CUDA leaf is the copied numpy codec's round
  trip; a CUDA tensor on a ``backend="store"`` channel raises.

The multi-GPU NCCL path (world size > 1) is unverified here.  Every test
needs an NVIDIA GPU (marker ``cuda``) and skips without one.  The file
imports only torch, numpy and ray_tpu_torch, so it runs where JAX is not
installed (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_collective.py
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.experimental.channel import CudaTensorChannel
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective import compression as comp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and CUDA IPC run on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def halves(card):
    """Two actors at half a card each: two processes on one card."""
    os.environ["RAY_TPU_NUM_CHIPS"] = "0"
    os.environ["RAY_TPU_DISABLE_METADATA_SERVER"] = "1"
    os.environ.setdefault("RAY_TPU_WORKER_QUIET", "1")
    rt.init(num_cpus=2, num_gpus=1)
    try:
        yield [_Half.remote() for _ in range(2)]
    finally:
        rt.shutdown()


@rt.remote(num_gpus=0.5, num_cpus=0)
class _Half:
    # the class travels to its worker by value; a module-level helper it
    # called would travel by reference to a module the worker cannot import
    @staticmethod
    def payload(seed, shape, dtype):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def write(self, name_or_chan, seeds, shape, dtype):
        chan = name_or_chan
        xs = [self.payload(s, shape, getattr(torch, dtype))
              for s in seeds]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for s, x in zip(seeds, xs):
            chan.write({"x": x, "seed": s}, timeout=120)
        staging = chan._staging.numel() if chan._staging is not None else 0
        chan.release(timeout=120)
        torch.cuda.synchronize()
        return base, torch.cuda.memory_allocated(), staging, \
            chan._comm is None

    def read(self, chan, count, shape, dtype):
        got = [chan.read(timeout=120) for _ in range(count)]
        path, nbytes = chan.last_read_path, chan.last_read_nbytes
        same = [bool(torch.equal(g["x"], self.payload(
            g["seed"], shape, getattr(torch, dtype)))) for g in got]
        on_card = all(g["x"].is_cuda for g in got)
        chan.release(timeout=120)
        return same, on_card, path, nbytes, chan._comm is None

    def quantized(self, chan, n):
        got = chan.read(timeout=120)["x"]
        chan.release(timeout=120)
        return got.cpu()


def _send(halves, chan, seeds, shape, dtype):
    w = halves[0].write.remote(chan, seeds, shape, dtype)
    r = halves[1].read.remote(chan, len(seeds), shape, dtype)
    try:
        return rt.get(w, timeout=300), rt.get(r, timeout=300)
    finally:
        chan.destroy()


def test_nccl_group_at_world_size_1(card):
    g = col.init_collective_group(1, 0, backend="nccl", group_name="solo")
    try:
        x = torch.arange(6.0, device=card).reshape(2, 3)
        checks = {
            "allreduce": torch.equal(col.allreduce(x, "solo"), x),
            "max": torch.equal(col.allreduce(x, "solo",
                                             op=col.ReduceOp.MAX), x),
            "reduce": torch.equal(col.reduce(x, 0, "solo"), x),
            "broadcast": torch.equal(col.broadcast(x, 0, "solo"), x),
            "allgather": torch.equal(col.allgather(x, "solo")[0], x),
            "reducescatter": torch.equal(col.reducescatter(x, "solo"), x),
        }
        backend = g.last_backend
        col.barrier("solo")
        tree = {"a": x, "b": [x.to(torch.bfloat16)]}
        out = col.allreduce_pytree(tree, "solo", bucket_bytes=16)
        checks["pytree"] = (torch.equal(out["a"], x)
                            and torch.equal(out["b"][0], tree["b"][0])
                            and out["a"].is_cuda)
        assert all(checks.values()), checks
        assert backend == g.last_backend == "nccl"
    finally:
        col.destroy_collective_group("solo")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ipc_channel_bit_for_bit(halves, dtype):
    shape = (3, 1000, 257)  # no multiple of the 256-byte alignment
    chan = CudaTensorChannel(f"ipc-{dtype}")
    (base, after, staging, no_group), (same, on_card, path, nbytes,
                                       no_group_r) = _send(
        halves, chan, [1, 2, 3], shape, dtype)
    assert same == [True, True, True] and on_card
    assert path == "ipc" and no_group and no_group_r
    assert nbytes == int(np.prod(shape)) * (4 if dtype == "float32" else 2)
    assert staging >= nbytes
    assert after == base  # the staging buffer freed after the release


def test_a_channel_per_value_leaves_no_buffer(halves):
    shape = (1 << 20,)
    for i in range(4):
        chan = CudaTensorChannel(f"per-value-{i}")
        (base, after, _, _), (same, _, path, _, _) = _send(
            halves, chan, [10 + i], shape, "bfloat16")
        assert same == [True] and path == "ipc"
        assert after == base


def test_int8_ipc_leaf_is_the_codecs_round_trip(halves):
    n = 70000
    chan = CudaTensorChannel("ipc-int8", compression={"scheme": "int8",
                                                     "min_bytes": 1024})
    w = halves[0].write.remote(chan, [5], (n,), "float32")
    r = halves[1].quantized.remote(chan, n)
    try:
        rt.get(w, timeout=300)
        got = rt.get(r, timeout=300)
    finally:
        chan.destroy()
    x = _Half._cls.payload(5, (n,), torch.float32).cpu().numpy()
    codes, scales = comp.quantize_blocks(x)
    want = comp.dequantize_blocks(codes, scales, n)
    assert np.array_equal(got.numpy(), want)


def test_a_cuda_tensor_never_crosses_the_host(card):
    chan = CudaTensorChannel("store-only", backend="store")
    try:
        with pytest.raises(TypeError, match="cross the host"):
            chan.write({"x": torch.ones(4, device=card)})
    finally:
        chan.destroy()
