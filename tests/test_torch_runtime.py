"""The port's runtime core (``ray_tpu_torch.init`` and what stands on it)
on the CPU, with CPU workers and a fake ``GPU`` resource of two cards.

- tasks, actors, ``get``/``put``/``wait``/``kill``/``cancel``, a
  streaming task and a placement group;
- ``num_gpus=1`` actors bind distinct ``CUDA_VISIBLE_DEVICES`` from their
  leases, ``num_gpus=0.5`` actors share one card, and ``get_gpu_ids()``
  agrees with the variable;
- the tensor reducer: CPU fp32, bf16 and non-contiguous tensors round-trip
  bit for bit through the store and through a worker, a CPU tensor read
  back aliases the store, and a reader with no card refuses a CUDA tensor;
- ``shutdown()`` leaves no framework thread and no process of the cluster;
- DAGs and ``ray://`` refuse, naming their ROADMAP item (the timeline
  is ported: ``tests/test_torch_state.py``).

One cluster serves the module (the per-test watchdog is 60 s and a worker
spawn costs seconds on a loaded host); the last two tests shut it down.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import serialization

# the lane's framework thread prefixes (tests/test_zz_lane_hygiene.py)
_FRAMEWORK_THREADS = (
    "raylet-", "gcs-", "rpc-", "pubsub-", "actor-pipeline-",
    "batch-prefetch", "proxy-", "train-fn", "cpu-profiler", "jax-profiler",
)


@pytest.fixture(scope="module")
def preexisting():
    """Threads alive before this module's cluster starts (another module's,
    under xdist): the last test judges only the cluster's own."""
    return {t.ident for t in threading.enumerate()}


@pytest.fixture(scope="module")
def cluster(preexisting):
    """The head node: 4 CPUs and 2 fake GPUs."""
    rt.init(num_cpus=4, num_gpus=2)
    try:
        yield rt._local_node
    finally:
        rt.shutdown()


@rt.remote
def _double(x):
    return 2 * x


@rt.remote
def _echo(x):
    return x


@rt.remote
class _Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n

    def pid(self):
        return os.getpid()


@rt.remote
class _Device:
    def seen(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids()


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, for bit-for-bit comparison (NaN payloads too)."""
    return t.detach().contiguous().view(torch.uint8).numpy()


def test_tasks_objects_and_wait(cluster):
    assert rt.get([_double.remote(i) for i in range(8)]) == [2 * i for i in range(8)]
    ref = rt.put({"a": [1, 2, 3]})
    assert rt.get(_echo.remote(ref)) == {"a": [1, 2, 3]}  # a ref arg resolves
    assert rt.get(_double.remote(_double.remote(5))) == 20  # task chaining
    refs = [_double.remote(i) for i in range(4)]
    ready, pending = rt.wait(refs, num_returns=4, timeout=30)
    assert len(ready) == 4 and not pending
    assert rt.cluster_resources()["CPU"] == 4


def test_actor_state_and_kill(cluster):
    c = _Counter.remote(10)
    assert [rt.get(c.add.remote(k)) for k in (1, 2, 3)] == [11, 13, 16]
    rt.kill(c)
    # the kill reaches the caller's view of the actor asynchronously (the
    # JAX package's test sleeps); calls fail once it has
    deadline = time.monotonic() + 30
    with pytest.raises((rt.ActorDiedError, rt.ActorUnavailableError)):
        while time.monotonic() < deadline:
            rt.get(c.add.remote(1), timeout=10)
            time.sleep(0.1)


def test_cancel_a_running_task(cluster):
    @rt.remote
    def spin():
        deadline = time.time() + 50
        x = 0
        while time.time() < deadline:  # interruptible at bytecode boundaries
            x += 1
        return x

    ref = spin.remote()
    time.sleep(2)  # lease, spawn and start
    assert rt.cancel(ref) is True
    with pytest.raises(rt.TaskCancelledError):
        rt.get(ref, timeout=30)


def test_streaming_task(cluster):
    @rt.remote(num_returns="streaming")
    def count(n):
        for i in range(n):
            yield i * i

    assert [rt.get(r) for r in count.remote(5)] == [0, 1, 4, 9, 16]


def test_placement_group(cluster):
    from ray_tpu_torch.util import (
        PlacementGroupSchedulingStrategy,
        placement_group,
        remove_placement_group,
    )

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(30)
    got = rt.get([_double.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
        pg, placement_group_bundle_index=i)).remote(i) for i in range(2)])
    assert got == [0, 2]
    remove_placement_group(pg)


def test_gpu_leases_bind_visible_devices(cluster):
    """Two whole-card actors see one distinct card each; two half-card
    actors share one; get_gpu_ids() reads what the lease bound."""
    whole = [_Device.options(num_gpus=1, num_cpus=0).remote() for _ in range(2)]
    seen = rt.get([a.seen.remote() for a in whole])
    assert sorted(s[0] for s in seen) == ["0", "1"]
    assert all(ids == [int(var)] for var, ids in seen)
    for a in whole:
        rt.kill(a)
    halves = [_Device.options(num_gpus=0.5, num_cpus=0).remote() for _ in range(2)]
    seen = rt.get([a.seen.remote() for a in halves], timeout=30)
    assert seen[0] == seen[1] and seen[0][1] == [int(seen[0][0])]
    for a in halves:
        rt.kill(a)


def _with_nan(t: torch.Tensor) -> torch.Tensor:
    t.view(-1)[:3] = float("nan")
    return t


@pytest.mark.parametrize("make", [
    lambda: _with_nan(torch.randn(512, 1024)),  # 2 MiB: stored, not inlined
    lambda: _with_nan(torch.randn(512, 1024).to(torch.bfloat16)),
    lambda: _with_nan(torch.randn(1024, 2048))[:, ::2],  # non-contiguous
], ids=["fp32", "bf16", "strided"])
def test_tensor_round_trips(cluster, make):
    x = make()
    # the refs go at once: each view read back pins its object (C6)
    via_store = rt.get(rt.put(x))
    via_worker = rt.get(_echo.remote(x))
    rt.get(rt.put(torch.ones_like(x)))  # a freed object's space is reused
    for y in (via_store, via_worker):
        assert y.dtype == x.dtype and y.shape == x.shape and y.device.type == "cpu"
        assert np.array_equal(_bits(y), _bits(x))


def test_cpu_tensor_read_back_aliases_the_store(cluster):
    ref = rt.put(torch.randn(1 << 20))
    a, b = rt.get(ref), rt.get(ref)
    assert a.data_ptr() == b.data_ptr()  # both views of the store, no copy


def test_reader_without_a_card_refuses_a_cuda_tensor():
    array = np.arange(4, dtype=np.float32)
    assert torch.equal(serialization._rebuild_tensor(array, torch.float32,
                                                     False, False),
                       torch.arange(4, dtype=torch.float32))
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialization._rebuild_tensor(array, torch.float32, True, False)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _node_workers(node_hex: str):
    """Live processes running the port's workers_main for this node."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if (b"ray_tpu_torch._private.workers_main" in cmd
                and f"RAY_TPU_NODE_ID={node_hex}".encode() in env
                and _alive(int(pid))):
            out.append(int(pid))
    return out


def test_shutdown_leaves_no_thread_and_no_process(cluster, preexisting):
    """Last in the module: shut the cluster down, then nothing it started
    may survive (polling loops get the lane's grace window)."""
    c = _Counter.remote(0)
    rt.get(c.pid.remote())
    node_hex = cluster.node_id.hex()
    pids = {w["pid"] for w in cluster.raylet.HandleListWorkers(None)
            if w["pid"]}
    zygote = cluster.raylet._zygote
    if zygote is not None and zygote._proc is not None:
        pids.add(zygote._proc.pid)
    assert pids
    rt.shutdown()
    assert not rt.is_initialized()
    deadline = time.monotonic() + 30
    while True:
        threads = sorted(t.name for t in threading.enumerate()
                         if t.name.startswith(_FRAMEWORK_THREADS)
                         and t.ident not in preexisting)
        procs = sorted({p for p in pids if _alive(p)} | set(_node_workers(node_hex)))
        if not threads and not procs:
            break
        assert time.monotonic() < deadline, (threads, procs)
        time.sleep(0.5)


def test_unported_parts_refuse_naming_their_roadmap_item():
    """DAGs and ray:// client mode are not ported: each raises at its
    entry, naming ROADMAP A16.  Last: it ends any cluster."""
    from ray_tpu_torch._private.ids import ActorID

    with pytest.raises(NotImplementedError, match="A16"):
        _double.bind(1)
    with pytest.raises(NotImplementedError, match="A16"):
        rt.ActorHandle(ActorID.random()).add.bind(1)
    if rt.is_initialized():
        rt.shutdown()
    with pytest.raises(NotImplementedError, match="A16"):
        rt.init("ray://localhost:10001")
    assert not rt.is_initialized()
