"""The port's collectives (``ray_tpu_torch.util.collective``) across the
port's actors on the CPU, against the JAX package's planner and codec.

- ``StoreGroup`` and ``NCCLGroup`` at world sizes 2 and 4 in the same four
  actors (four named groups side by side in each): every op — allreduce
  (sum, product, min, max), reduce, broadcast, allgather, reducescatter,
  barrier, send/recv of a bf16 tensor;
- the ring, tree and hierarchical schedules equal the flat allreduce bit
  for bit on integer-valued data, and a repeat is bit-identical; the
  quantized allreduce equals, bit for bit, what the JAX package's numpy
  codec (``ef_quantize``, ``quantize_blocks``, ``dequantize_blocks``) gives
  on the same per-rank inputs;
- ``allreduce_pytree``, bucketed, equals the fused one;
- a member's death aborts both kinds of group;
- the copied planner gives the JAX planner's choice and reason over a grid
  of sizes, world sizes, topologies and specs.

``NCCLGroup`` runs gloo here (CPU tensors); its NCCL half runs on the card
at world size 1 only (``tests/test_torch_cuda_collective.py``, smoke phase
4c): the multi-GPU NCCL path is unverified.  One cluster of four actors
serves the module; each test carries its own watchdog.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.util.collective import compression as jcomp
from ray_tpu.util.collective import planner as jplanner
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective import compression as tcomp
from ray_tpu_torch.util.collective import planner as tplanner
from ray_tpu_torch.util.collective.types import Backend, CollectiveAbortError

N = 3000  # a payload that is no multiple of the world, the block or 256


@rt.remote
class _Member:
    def __init__(self):
        torch.set_num_threads(1)

    def join(self, world, rank, backend, name):
        from ray_tpu_torch.util import collective

        g = collective.init_collective_group(world, rank, backend=backend,
                                             group_name=name)
        return type(g).__name__

    def ops(self, name):
        from ray_tpu_torch.util import collective

        r = collective.get_rank(name)
        w = collective.get_collective_group_size(name)
        out = {"rank": (r, w)}
        for op in ("SUM", "PRODUCT", "MIN", "MAX"):
            out[op] = collective.allreduce(
                torch.tensor([r + 1.0, 2.0 - r]), name,
                op=getattr(collective.ReduceOp, op))
        out["reduce"] = collective.reduce(torch.tensor([float(r)]), w - 1,
                                          name)
        out["broadcast"] = collective.broadcast(
            torch.tensor([42.0 if r == 0 else -1.0]), 0, name)
        out["allgather"] = collective.allgather(torch.tensor([float(r)]),
                                                name)
        out["reducescatter"] = collective.reducescatter(
            torch.arange(2.0 * w) * (r + 1), name)
        collective.barrier(name)
        if r == 0:
            collective.send(torch.arange(5, dtype=torch.bfloat16) / 3, w - 1,
                            name)
        if r == w - 1:
            out["recv"] = collective.recv(0, name)
        return out

    def allreduce(self, name, x, compression=None):
        from ray_tpu_torch.util import collective
        from ray_tpu_torch.util.collective.collective import _group_mgr

        out = collective.allreduce(x, name, compression=compression)
        s = _group_mgr.get_group(name).last_op_stats
        return out, None if s is None else s.algorithm

    def planned(self, name, x, algorithm, scheme="none", slice_size=1):
        """One schedule forced (the planner never picks "tree": its cost
        never beats flat's), twice."""
        from ray_tpu_torch.util.collective import compression
        from ray_tpu_torch.util.collective.collective import _group_mgr

        g = _group_mgr.get_group(name)
        spec = compression.CompressionSpec(scheme=scheme, min_bytes=0)
        plan = compression.Plan(algorithm, scheme, slice_size, spec)
        return [(g._planned(x, plan), g.last_op_stats) for _ in range(2)]

    def pytree(self, name, tree, bucket_bytes):
        from ray_tpu_torch.util import collective

        return collective.allreduce_pytree(tree, name,
                                           bucket_bytes=bucket_bytes)

    def explain(self, name, nbytes, compression):
        from ray_tpu_torch.util import collective

        return collective.plan_explain(nbytes, name, compression)

    def destroy(self, name):
        from ray_tpu_torch.util import collective

        collective.destroy_collective_group(name)
        return collective.is_group_initialized(name)

    def store_address(self, name):
        from ray_tpu_torch.util.collective.collective import _group_mgr

        g = _group_mgr.get_group(name)
        return g._tcp.host, g._tcp.port


@pytest.fixture(scope="module")
def members():
    """Four actors; in them, four named groups side by side: store and
    nccl (gloo here) at world 4 over all, and at world 2 over the first
    two."""
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    rt.init(num_cpus=4)
    try:
        ms = [_Member.options(num_cpus=0).remote() for _ in range(4)]
        for backend in ("store", "nccl"):
            for world in (4, 2):
                kinds = rt.get([m.join.remote(world, r, backend,
                                              f"{backend}{world}")
                                for r, m in enumerate(ms[:world])],
                               timeout=120)
                assert kinds == [{"store": "StoreGroup",
                                  "nccl": "NCCLGroup"}[backend]] * world
        yield ms
    finally:
        rt.shutdown()
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads


def _ranks(members, name):
    return members[:int(name[-1])]


def _data(rank, n=N, integer=False):
    rng = np.random.default_rng(100 + rank)
    x = (rng.integers(-8, 9, n) if integer else rng.standard_normal(n))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", ["store2", "store4", "nccl2", "nccl4"])
def test_every_op(members, name):
    ms = _ranks(members, name)
    w = len(ms)
    outs = rt.get([m.ops.remote(name) for m in ms], timeout=60)
    xs = [torch.tensor([r + 1.0, 2.0 - r]) for r in range(w)]
    want = {"SUM": sum(xs), "PRODUCT": torch.stack(xs).prod(0),
            "MIN": torch.stack(xs).amin(0), "MAX": torch.stack(xs).amax(0)}
    for r, out in enumerate(outs):
        assert out["rank"] == (r, w)
        for op, v in want.items():
            assert torch.equal(out[op], v), (op, out[op], v)
        assert torch.equal(out["broadcast"], torch.tensor([42.0]))
        assert torch.equal(torch.cat(out["allgather"]),
                           torch.arange(float(w)))
        full = sum(torch.arange(2.0 * w) * (q + 1) for q in range(w))
        assert torch.equal(out["reducescatter"], full[2 * r:2 * r + 2])
    assert torch.equal(outs[-1]["reduce"],
                       torch.tensor([float(sum(range(w)))]))
    got = outs[-1]["recv"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.arange(5, dtype=torch.bfloat16) / 3)


def test_backend_names():
    assert Backend.validate("nccl") == Backend.NCCL == "nccl"
    for name in ("gloo", "torch_gloo", "mpi", "store"):
        assert Backend.validate(name) == Backend.STORE
    with pytest.raises(ValueError, match="'nccl'"):
        Backend.validate("xla")
    with pytest.raises(ValueError):
        Backend.validate("bogus")


@pytest.mark.timeout(120)
@pytest.mark.parametrize("backend", ["store", "nccl"])
def test_ring_and_hierarchical_equal_flat_bit_for_bit(members, backend):
    """The planner's picks on a 2 MB payload at world 4 (ring, bandwidth
    bound on the host link) and with an explicit slice size of 2
    (hierarchical), on integer-valued data: the flat allreduce's bits."""
    name = f"{backend}4"
    big = 1 << 19  # fp32 elements: 2 MiB
    xs = [_data(r, big, integer=True) for r in range(4)]
    flat = rt.get([m.allreduce.remote(name, x)
                   for m, x in zip(members, xs)], timeout=60)
    assert torch.equal(flat[0][0], sum(xs))
    for spec, alg in (({"scheme": "none", "min_bytes": 1024}, "ring"),
                      ({"scheme": "none", "min_bytes": 1024,
                        "slice_size": 2}, "hierarchical")):
        outs = rt.get([m.allreduce.remote(name, x, spec)
                       for m, x in zip(members, xs)], timeout=60)
        for out, got_alg in outs:
            assert got_alg == alg
            assert torch.equal(out, flat[0][0]), alg


@pytest.mark.timeout(120)
@pytest.mark.parametrize("alg,world", [("ring", 4), ("tree", 4),
                                       ("tree", 2), ("hierarchical", 4)])
def test_nccl_schedules_equal_flat_and_repeat(members, alg, world):
    name = f"nccl{world}"
    xs = [_data(r, integer=True) for r in range(world)]
    outs = rt.get([m.planned.remote(name, x, alg, "none",
                                    2 if alg == "hierarchical" else 1)
                   for m, x in zip(members, xs)], timeout=60)
    want = sum(xs)
    for (a, stats_a), (b, _) in outs:  # each rank: two runs
        assert torch.equal(a, want) and torch.equal(b, a)
        assert stats_a.algorithm == alg
    # on real-valued data every rank still holds the same bits
    ys = [_data(r) for r in range(world)]
    outs = rt.get([m.planned.remote(name, y, alg, "none",
                                    2 if alg == "hierarchical" else 1)
                   for m, y in zip(members, ys)], timeout=60)
    first = outs[0][0][0]
    assert all(torch.equal(o[0][0], first) and torch.equal(o[1][0], first)
               for o in outs)
    torch.testing.assert_close(first, sum(ys), rtol=1e-5, atol=1e-5)


def _jax_two_phase(xs, bs=jcomp.DEFAULT_BLOCK_SIZE, accum="bfloat16"):
    """The EQuARX two-phase allreduce by the JAX package's numpy codec:
    quantize each rank's payload padded to world x block, per shard sum
    the dequantized contributions in rank order (fp32) and round once to
    the accumulator's dtype, requantize, dequantize."""
    w = len(xs)
    spec = jcomp.CompressionSpec(min_bytes=0, accum_dtype=accum)
    coded = [jcomp.ef_quantize("jax-ref", "allreduce", x.numpy(), spec,
                               pad_granule=w * bs)[:2] for x in xs]
    shard, shard_nb = coded[0][0].size // w, coded[0][1].size // w
    out = []
    for j in range(w):
        parts = [jcomp.dequantize_blocks(c[j * shard:(j + 1) * shard],
                                         s[j * shard_nb:(j + 1) * shard_nb],
                                         shard, bs) for c, s in coded]
        acc = parts[0].copy()
        for p in parts[1:]:
            acc = acc + p
        if accum == "bfloat16":
            acc = acc.astype(ml_dtypes.bfloat16).astype(np.float32)
        c2, s2 = jcomp.quantize_blocks(acc, bs)
        out.append(jcomp.dequantize_blocks(c2, s2, shard, bs))
    return np.concatenate(out)[:xs[0].numel()]


def _jax_flat_int8(xs, bs=jcomp.DEFAULT_BLOCK_SIZE):
    """The store backend's flat int8 allreduce by the JAX package's numpy
    codec: every rank's codes dequantized and summed in rank order."""
    acc = np.zeros(xs[0].numel(), np.float32)
    for x in xs:
        c, s = jcomp.quantize_blocks(x.numpy(), bs)
        acc += jcomp.dequantize_blocks(c, s, x.numel(), bs)
    return acc


@pytest.mark.timeout(120)
@pytest.mark.parametrize("backend,world", [("nccl", 4), ("nccl", 2),
                                           ("store", 4)])
def test_quantized_allreduce_is_the_numpy_codecs(members, backend, world):
    name = f"{backend}{world}"
    xs = [_data(r) for r in range(world)]
    spec = {"scheme": "int8", "min_bytes": 1024}
    outs = rt.get([m.allreduce.remote(name, x, spec)
                   for m, x in zip(members, xs)], timeout=60)
    want = (_jax_two_phase(xs) if backend == "nccl" else _jax_flat_int8(xs))
    for out, alg in outs:
        assert alg == "flat"
        assert np.array_equal(out.numpy(), want)
    exact = sum(xs)
    rel = float((outs[0][0] - exact).norm() / exact.norm())
    assert 0 < rel < 0.02  # lossy, within the codec's documented bound


@pytest.mark.timeout(120)
@pytest.mark.parametrize("backend", ["store", "nccl"])
def test_allreduce_pytree_bucketed_equals_fused(members, backend):
    name = f"{backend}4"

    def tree(r):
        g = torch.Generator().manual_seed(r)
        ints = lambda *s: torch.randint(-8, 9, s, generator=g)  # noqa: E731
        return {"w": ints(64, 32).float(), "b": (ints(32).float(),
                                                 ints(7).to(torch.int64)),
                "h": [ints(16, 3).to(torch.bfloat16)]}

    trees = [tree(r) for r in range(4)]
    fused = rt.get([m.pytree.remote(name, t, 1 << 30)
                    for m, t in zip(members, trees)], timeout=60)
    bucketed = rt.get([m.pytree.remote(name, t, 256)
                       for m, t in zip(members, trees)], timeout=60)
    want = {"w": sum(t["w"] for t in trees),
            "b": (sum(t["b"][0] for t in trees),
                  sum(t["b"][1] for t in trees)),
            "h": [sum(t["h"][0].float() for t in trees).to(torch.bfloat16)]}
    for f, b in zip(fused, bucketed):
        for got in (f, b):
            assert torch.equal(got["w"], want["w"])
            assert torch.equal(got["b"][0], want["b"][0])
            assert got["b"][1].dtype == torch.int64
            assert torch.equal(got["b"][1], want["b"][1])
            assert got["h"][0].dtype == torch.bfloat16
            assert torch.equal(got["h"][0], want["h"][0])


@pytest.mark.timeout(120)
def test_a_dead_member_aborts_its_groups(members):
    """Two fresh members in a store group and an nccl group; one is killed:
    the survivor's next op on each raises CollectiveAbortError within
    seconds, and again after (the group stays poisoned)."""
    pair = [_Member.options(num_cpus=0).remote() for _ in range(2)]
    for backend in ("store", "nccl"):
        rt.get([m.join.remote(2, r, backend, f"dead-{backend}")
                for r, m in enumerate(pair)], timeout=60)
    rt.kill(pair[1])
    for backend in ("nccl", "store"):
        for _ in range(2):
            with pytest.raises(CollectiveAbortError):
                rt.get(pair[0].allreduce.remote(f"dead-{backend}",
                                                torch.ones(4)), timeout=30)
    assert rt.get(pair[0].destroy.remote("dead-nccl"), timeout=30) is False


@pytest.mark.timeout(120)
def test_destroy_frees_the_group_and_its_store(members):
    """A destroyed NCCLGroup is gone from its members, and rank 0's
    TCPStore no longer takes connections; a group of the same name can be
    made again."""
    import socket

    for _ in range(2):
        rt.get([m.join.remote(2, r, "nccl", "again")
                for r, m in enumerate(members[:2])], timeout=60)
        host, port = rt.get(members[0].store_address.remote("again"),
                            timeout=30)
        outs = rt.get([m.allreduce.remote("again", torch.ones(3))
                       for m in members[:2]], timeout=30)
        assert all(torch.equal(o, torch.full((3,), 2.0)) for o, _ in outs)
        assert rt.get([m.destroy.remote("again") for m in members[:2]],
                      timeout=30) == [False, False]
        with pytest.raises(OSError):
            socket.create_connection((host, port), timeout=5).close()


def test_an_unknown_group_and_a_bad_rank_raise():
    with pytest.raises(RuntimeError, match="not initialized"):
        col.allreduce(torch.ones(2), "nowhere")
    with pytest.raises(ValueError, match="out of range"):
        col.init_collective_group(2, 2, backend="nccl", group_name="bad")


_SIZES = [0, 1 << 10, 64 << 10, 1 << 20, 3 << 20, 64 << 20]
_WORLDS = [1, 2, 3, 4, 8]
_SPECS = [None, "int8", "none", {"scheme": "none"},
          {"scheme": "none", "slice_size": 2},
          {"scheme": "int8", "slice_size": 2},
          {"scheme": "none", "hierarchical": True},
          {"scheme": "int8", "hierarchical": False, "min_bytes": 0}]


def _topologies(pkg, world):
    """(label, topology) pairs built the same way in either package; the
    fast intra link is ICI in JAX's and NVLink in the port's (equal
    priors)."""
    fast = pkg.LINK_ICI if pkg is jplanner else pkg.LINK_NVLINK
    tops = [("flat host", pkg.Topology.flat(world)),
            ("flat fast", pkg.Topology.flat(world, link=fast))]
    if world % 2 == 0 and world > 2:
        tops.append(("two hosts", pkg.Topology.from_slice_ids(
            [r // (world // 2) for r in range(world)], intra_link=fast)))
        tops.append(("interleaved", pkg.Topology.from_slice_ids(
            [r % 2 for r in range(world)], intra_link=fast)))
    if world >= 3:
        tops.append(("uneven", pkg.Topology.from_slice_ids(
            [0] * (world - 1) + [1], intra_link=fast)))
    return tops


@pytest.mark.parametrize("world", _WORLDS)
def test_planner_matches_jax(world):
    for (label, jt), (_, tt) in zip(_topologies(jplanner, world),
                                    _topologies(tplanner, world)):
        for raw in _SPECS:
            js = jcomp.resolve_spec(dict(raw) if isinstance(raw, dict)
                                    else raw)
            ts = tcomp.resolve_spec(dict(raw) if isinstance(raw, dict)
                                    else raw)
            for n in _SIZES:
                jp = jplanner.plan_allreduce(n, jt, js)
                tp = tplanner.plan_allreduce(n, tt, ts)
                key = (label, raw, n)
                assert (tp.algorithm, tp.scheme, tp.slice_size, tp.reason) \
                    == (jp.algorithm, jp.scheme, jp.slice_size,
                        jp.reason), key
                je = jplanner.plan_explain(n, jt, js)
                te = tplanner.plan_explain(n, tt, ts)
                assert te["modeled_cost_s"] == je["modeled_cost_s"], key
                for k in ("chosen", "reason", "scheme", "slice_size",
                          "is_stock"):
                    assert te[k] == je[k], (key, k)


@pytest.mark.timeout(60)
def test_plan_explain_on_a_group(members):
    """A group's planner reads its own topology: one host, host links."""
    got = rt.get(members[0].explain.remote("nccl4", 4 << 20, "int8"),
                 timeout=30)
    assert got["chosen"] == "flat" and got["reason"] == "quantized_two_phase"
    assert got["topology"]["world_size"] == 4
    assert got["topology"]["num_slices"] == 1
    assert got["topology"]["intra_link"] == "host"
