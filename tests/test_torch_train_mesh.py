"""Sharded Llama training in the port (one process per rank, over gloo on
the CPU) against the JAX package's sharded step (GSPMD on the 8 virtual
CPU devices the conftest provides), on the same state and batch.

- ``make_train_step(cfg, mesh)`` on seven meshes of four ranks: data=2 x
  fsdp=2, fsdp=4, tensor=2 x fsdp=2, tensor=4, context=2 x fsdp=2 with
  ``context_parallel``, pipeline=2 x fsdp=2 with four microbatches, and
  pipeline=2 x tensor=2.  Each rank starts from the JAX state's shards
  (``convert.train_state_from_jax(..., mesh=)``) and takes the global
  batch.  Loss and ``grad_norm`` within 1e-5 relative of JAX's at each of
  three steps (measured: 1.8e-7 at most); every rank's shard of every mu
  and nu after one step and after three within 1e-6 absolute of the JAX
  array's block (measured 6.5e-8), every param's within 1e-4 (measured
  1.2e-5: Adam divides each gradient by its own size, so an element whose
  gradient sits at fp32 noise moves by up to lr = 3e-4 a step, as
  ``tests/test_torch_train_step.py`` holds the flash path).  The same
  against the port's own mesh-free step.
- The "attn" and "dots" remat policies at tensor=2 x fsdp=2 give "full"'s
  step bit for bit (grad_norm and every param shard).
- ``make_pipeline_loss`` at pipeline=2: loss within 1e-5 relative and
  every gradient within 1e-5 absolute of ``jax.value_and_grad`` of the
  JAX pipeline loss; its refusals are JAX's.
- Each differentiable collective alone at world 2 and 4, its backward
  against its definition (one case is a gradient a wrong transpose would
  count ``world`` times).
- ``TensorGroup.permute``'s posting order: members that run their
  point-to-point calls in order on one stream, each send waiting for its
  receive (as NCCL may), finish every permutation the program sends
  (rings of 2, 3 and 4 both ways, the serving tree's swaps).
- ``overlap_grad_sync`` at data=2: three steps bit for bit the fused
  sync's, buckets started in ``partition_buckets`` order; held to JAX's
  plain data=2 step (not to JAX's overlap module).  ``grad_compression``
  at data=2 (leaves whole) held to JAX's.
- ``train_state_from_jax(..., mesh=, rank=)``: every rank's shard is the
  JAX array's shard on that mesh position's device.
- Refusals naming their ROADMAP items (the serving engines' meshes, item
  5) and JAX's own (MoE on a pipeline axis).

Every world is spawned once per module (rank 0 runs here); each spawned
rank imports torch and this module afresh.
"""

import dataclasses
import datetime
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models import llama as jl
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.pipeline import make_pipeline_loss as jax_pipeline_loss
from ray_tpu.parallel.pipeline import pipeline_param_specs as jax_pp_specs
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves_with_keys
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.parallel import functional as fn
from ray_tpu_torch.parallel import make_train_step
from ray_tpu_torch.parallel.bucketing import partition_buckets
from ray_tpu_torch.parallel.mesh import MeshSpec, shard_slice
from ray_tpu_torch.parallel.optim import find_adam_state
from ray_tpu_torch.parallel.pipeline import make_pipeline_loss
from ray_tpu_torch.parallel.train_step import _train_specs

torch.set_num_threads(1)

B, S, STEPS = 8, 32, 3
LOSS_RTOL = 1e-5
STATE_ATOL = {1: (1e-4, 1e-6, 1e-6), 3: (1e-4, 1e-6, 1e-6)}  # params, mu, nu
MESHES = {
    "data2-fsdp2": (dict(data=2, fsdp=2), {}),
    "fsdp4": (dict(fsdp=4), {}),
    "tensor2-fsdp2": (dict(tensor=2, fsdp=2), {}),
    "tensor4": (dict(tensor=4), {}),
    "context2-fsdp2-cp": (dict(context=2, fsdp=2), dict(context_parallel=True)),
    "pipeline2-fsdp2-m4": (dict(pipeline=2, fsdp=2),
                           dict(pipeline_microbatches=4)),
    "pipeline2-tensor2": (dict(pipeline=2, tensor=2), {}),
}
OVERLAP_BUCKET = 1 << 16  # several buckets at this width


def _cfgs(**kw):
    # n_kv_heads 4 divides over tensor=4; fp32 products
    return (jl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, **kw),
            tl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, **kw))


def _tokens():
    return np.random.default_rng(11).integers(0, 256, (B, S)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state0(**kw):
    jcfg, _ = _cfgs()
    init_fn, _ = jax_make_train_step(jcfg, **kw)
    return _np(init_fn(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def start():
    """The JAX step's initial state (numpy) and the batch."""
    return _jax_state0(), _tokens()


@pytest.fixture(scope="module")
def start_int8():
    """The initial state of JAX's step with the int8 codec chained."""
    return _jax_state0(grad_compression="int8")


def _jax_run(axes, kw, state0, tokens, steps=STEPS, **extra):
    """JAX's sharded step on ``axes``: per-step (loss, grad_norm) and the
    full state after steps 1 and ``steps``."""
    jcfg, _ = _cfgs()
    n = int(np.prod(list(axes.values())))
    mesh = JMeshSpec(**axes).build(jax.devices()[:n])
    _, step_fn = jax_make_train_step(jcfg, mesh, **kw, **extra)
    state = state0
    metrics, states = [], {}
    for i in range(steps):
        state, m = step_fn(state, jnp.asarray(tokens))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i + 1 in (1, steps):
            states[i + 1] = _np(state)
    return metrics, states


# -- the port's ranks ---------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _store(rank, n, port):
    return dist.TCPStore("127.0.0.1", port, n, rank == 0,
                         timeout=datetime.timedelta(seconds=120),
                         wait_for_workers=False)


def _state_np(state):
    """{key: numpy} of a port TrainState's params, mu and nu."""
    adam = find_adam_state(state.opt_state)
    out = {}
    for name, tree in (("params", state.params), ("mu", adam.mu),
                       ("nu", adam.nu)):
        for k, v in tree_leaves_with_keys(tree):
            out[f"{name}/{k}"] = v.detach().numpy().copy()
    return out


def _steps(tcfg, mesh, state0, tokens, kw, steps=STEPS, hook=None):
    _, step_fn = make_train_step(tcfg, mesh, device="cpu", **kw)
    state = convert.train_state_from_jax(state0, tcfg, device="cpu",
                                         mesh=mesh)
    metrics, states = [], {}
    for i in range(steps):
        state, m = step_fn(state, torch.from_numpy(tokens))
        if hook is not None:
            hook(step_fn)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i + 1 in (1, steps):
            states[i + 1] = _state_np(state)
    return metrics, states


def _job_meshes(rank, store, inputs):
    state0, tokens = inputs["state0"], inputs["tokens"]
    _, tcfg = _cfgs()
    out = {}
    for name, (axes, kw) in MESHES.items():
        mesh = MeshSpec(**axes).build(rank=rank, store=store, name=name)
        try:
            out[name] = _steps(tcfg, mesh, state0, tokens, kw)
        finally:
            mesh.destroy()
    for policy in ("full", "attn", "dots"):
        _, pcfg = _cfgs(remat_policy=policy)
        mesh = MeshSpec(tensor=2, fsdp=2).build(rank=rank, store=store,
                                                name=f"remat-{policy}")
        try:
            out[f"remat-{policy}"] = _steps(pcfg, mesh, state0, tokens, {},
                                            steps=1)
        finally:
            mesh.destroy()
    return out


def _collective_cases(rank, store, n):
    """{case: (input grads, output)} of each collective on this rank: the
    loss is sum(out * w) with w drawn from (seed, rank)."""
    mesh = MeshSpec(data=n).build(rank=rank, store=store, name=f"ops{n}")
    group = mesh.axis_group("data")
    out = {}
    try:
        for case in ("all_gather", "reduce_scatter", "psum", "psum_replicated",
                     "pvary", "ppermute_ring", "ppermute_pairs"):
            x = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(
                (n * 2, 3)).astype(np.float32)).requires_grad_(True)
            if case == "all_gather":
                y = fn.all_gather(x, group, 0)
            elif case == "reduce_scatter":
                y = fn.reduce_scatter(x, group, 0)
            elif case.startswith("psum"):
                y = fn.psum(x, group)
            elif case == "pvary":
                y = fn.pvary(x, group)
            elif case == "ppermute_ring":
                y = fn.ppermute(x, group, fn.ring_perm(n))
            else:  # 0 <-> 1 only: the others get zeros and send nothing
                y = fn.ppermute(x, group, [(0, 1), (1, 0)])
            if case == "psum_replicated":
                w = torch.ones_like(y)  # the same loss on every rank
            else:
                w = torch.from_numpy(np.random.default_rng(200 + rank)
                                     .standard_normal(tuple(y.shape))
                                     .astype(np.float32))
            (g,) = torch.autograd.grad((y * w).sum(), [x])
            out[case] = (g.numpy(), y.detach().numpy())
    finally:
        mesh.destroy()
    return out


def _job_ops(rank, store, inputs):
    return _collective_cases(rank, store, inputs["n"])


def _job_world2(rank, store, inputs):
    state0, tokens = inputs["state0"], inputs["tokens"]
    _, tcfg = _cfgs()
    out = {"ops": _collective_cases(rank, store, 2)}
    # overlapped against fused sync at data=2, the launch order beside
    for name, kw, s0 in (
            ("fused", {}, state0),
            ("overlap", dict(overlap_grad_sync=True,
                             bucket_bytes=OVERLAP_BUCKET), state0),
            ("int8", dict(grad_compression="int8"), inputs["state0_int8"])):
        mesh = MeshSpec(data=2).build(rank=rank, store=store, name=name)
        orders = []

        def hook(step_fn):
            if step_fn.overlap is not None:
                orders.append(list(step_fn.overlap.launched))

        try:
            out[name] = _steps(tcfg, mesh, s0, tokens, kw, hook=hook)
            out[f"{name}-order"] = orders
        finally:
            mesh.destroy()
    # the pipeline loss and its gradients at pipeline=2
    mesh = MeshSpec(pipeline=2).build(rank=rank, store=store, name="pp-loss")
    try:
        state = convert.train_state_from_jax(state0, tcfg, device="cpu",
                                             mesh=mesh)
        leaves = tree_leaves_with_keys(state.params)
        for _, p in leaves:
            p.requires_grad_(True)
        loss = make_pipeline_loss(2)(tcfg, state.params,
                                     torch.from_numpy(tokens), mesh=mesh)
        grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                    allow_unused=True)
        group = mesh.axis_group("pipeline")
        got = {}
        for (key, p), g in zip(leaves, grads):
            g = torch.zeros_like(p) if g is None else g
            if not key.startswith("layers/"):  # every stage holds it
                g = group.allreduce_(g.contiguous())
            got[key] = g.numpy()
        out["pp-loss"] = (float(loss.detach()), got)
    finally:
        mesh.destroy()
    return out


_JOBS = {"meshes": _job_meshes, "ops": _job_ops, "world2": _job_world2}


def _rank_main(rank, n, port, jobs, inputs, queue):
    torch.set_num_threads(1)
    store = _store(rank, n, port)
    try:
        queue.put((rank, {j: _JOBS[j](rank, store, inputs) for j in jobs}))
    except BaseException as e:  # the parent must not wait forever
        queue.put((rank, e))
        raise


_WORLDS = {}


def _world(n, jobs, inputs):
    """{rank: {job: result}} of ``n`` ranks running ``jobs`` (rank 0 in
    this process), made once per module."""
    key = (n, tuple(jobs))
    if key in _WORLDS:
        return _WORLDS[key]
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, jobs, inputs, queue))
             for r in range(1, n)]
    for p in procs:
        p.start()
    try:
        store = _store(0, n, port)
        res = {0: {j: _JOBS[j](0, store, inputs) for j in jobs}}
        for _ in procs:
            r, got = queue.get()
            if isinstance(got, BaseException):
                raise RuntimeError(f"rank {r} failed") from got
            res[r] = got
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
    return _WORLDS.setdefault(key, res)


@pytest.fixture(scope="module")
def world4(start):
    state0, tokens = start
    return _world(4, ("meshes", "ops"),
                  dict(state0=state0, tokens=tokens, n=4))


@pytest.fixture(scope="module")
def world2(start, start_int8):
    state0, tokens = start
    return _world(2, ("world2",), dict(state0=state0, tokens=tokens,
                                       state0_int8=start_int8))


_JAX = {}


@pytest.fixture(scope="module")
def jax_runs(start, start_int8):
    state0, tokens = start

    def run(name, axes, kw, **extra):
        s0 = start_int8 if "grad_compression" in extra else state0
        if name not in _JAX:
            _JAX[name] = _jax_run(axes, kw, s0, tokens, **extra)
        return _JAX[name]

    return run


# -- checks ---------------------------------------------------------------------


def _check_metrics(got, want, what):
    for i, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL, err_msg=f"{what} loss {i}")
        np.testing.assert_allclose(gn, wn, rtol=LOSS_RTOL,
                                   err_msg=f"{what} grad_norm {i}")


def _full_arrays(jstate):
    """{"params/<key>", "mu/<key>", "nu/<key>": numpy} of a JAX state."""
    adam = find_adam_state(jstate.opt_state)
    out = {}
    for name, tree in (("params", jstate.params), ("mu", adam.mu),
                       ("nu", adam.nu)):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        for path, leaf in flat:
            out[f"{name}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    return out


def _spec(specs, key):
    for part in key.split("/")[1:]:
        specs = specs[part]
    return specs


def _check_shards(rank_states, full, axes, step, what, atols=None):
    """Every rank's shard of every leaf against the full array's block."""
    _, tcfg = _cfgs()
    spec = MeshSpec(**axes)
    specs = _train_specs(tcfg, spec.build())
    atols = dict(zip(("params", "mu", "nu"), atols or STATE_ATOL[step]))
    for r, got in rank_states.items():
        mesh = spec.build(rank=r)
        assert sorted(got) == sorted(full), what
        for key, arr in got.items():
            want = shard_slice(torch.from_numpy(np.array(full[key])), _spec(specs, key),
                               mesh).numpy()
            assert arr.shape == want.shape, (what, key, r)
            np.testing.assert_allclose(
                arr, want, rtol=0, atol=atols[key.split("/")[0]],
                err_msg=f"{what} rank {r} {key} after {step} steps")


@pytest.fixture(scope="module")
def port_solo(start):
    """The port's mesh-free step on the same state: metrics and the full
    state after steps 1 and 3."""
    state0, tokens = start
    _, tcfg = _cfgs()
    return _steps(tcfg, None, state0, tokens, {})


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_jax_on_the_same_mesh(world4, jax_runs,
                                                   port_solo, name):
    axes, kw = MESHES[name]
    want_m, want_s = jax_runs(name, axes, kw)
    for r in range(4):
        got_m, _ = world4[r]["meshes"][name]
        _check_metrics(got_m, want_m, f"{name} rank {r} vs JAX")
        _check_metrics(got_m, port_solo[0], f"{name} rank {r} vs mesh-free")
    for step in (1, STEPS):
        ranks = {r: world4[r]["meshes"][name][1][step] for r in range(4)}
        _check_shards(ranks, _full_arrays(want_s[step]), axes, step,
                      f"{name} vs JAX")
        _check_shards(ranks, port_solo[1][step], axes, step,
                      f"{name} vs mesh-free")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_remat_policies_under_a_mesh_give_full_s_step(world4, policy):
    for r in range(4):
        full_m, full_s = world4[r]["meshes"]["remat-full"]
        got_m, got_s = world4[r]["meshes"][f"remat-{policy}"]
        assert got_m == full_m, (policy, r)
        for key, arr in full_s[1].items():
            assert np.array_equal(got_s[1][key], arr), (policy, r, key)


def _expected_grad(case, n, rank):
    """The input gradient of sum(op(x) * w_rank) by the op's definition."""
    def w(r, shape):
        return np.random.default_rng(200 + r).standard_normal(shape).astype(
            np.float32)

    if case == "all_gather":  # y_r = cat(x_0..x_{n-1}): d/dx_me = sum_r w_r[me]
        return sum(w(r, (2 * n * n, 3))[rank * 2 * n:(rank + 1) * 2 * n]
                   for r in range(n))
    if case == "reduce_scatter":  # y_r = sum_s x_s[block r]: d/dx_me[block r] = w_r
        return np.concatenate([w(r, (2, 3)) for r in range(n)])
    if case == "psum":  # identity backward: rank r's cotangent is its own
        return w(rank, (2 * n, 3))
    if case == "psum_replicated":  # the SAME loss on every rank: counted once
        return np.ones((2 * n, 3), np.float32)
    if case == "pvary":  # identity forward; the backward sums over the group
        return sum(w(r, (2 * n, 3)) for r in range(n))
    if case == "ppermute_ring":  # x_me lands on me + 1
        return w((rank + 1) % n, (2 * n, 3))
    # pairs 0 <-> 1: ranks 0 and 1 swap, the others send nothing
    if rank in (0, 1):
        return w(1 - rank, (2 * n, 3))
    return np.zeros((2 * n, 3), np.float32)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["all_gather", "reduce_scatter", "psum",
                                  "psum_replicated", "pvary", "ppermute_ring",
                                  "ppermute_pairs"])
def test_each_collective_s_backward_is_its_transpose(world2, world4, n, case):
    res = world2 if n == 2 else world4
    xs = [np.random.default_rng(100 + r).standard_normal((2 * n, 3)).astype(
        np.float32) for r in range(n)]
    for r in range(n):
        got_g, got_y = (res[r]["world2"]["ops"] if n == 2
                        else res[r]["ops"])[case]
        np.testing.assert_allclose(got_g, _expected_grad(case, n, r),
                                   rtol=0, atol=1e-5, err_msg=f"{case} {r}")
        if case == "psum_replicated":
            # a transpose that all-reduced would give n here
            assert np.allclose(got_g, 1.0) and n > 1
        want = {"all_gather": np.concatenate(xs),
                "reduce_scatter": sum(xs)[2 * r:2 * r + 2],
                "psum": sum(xs), "psum_replicated": sum(xs), "pvary": xs[r],
                "ppermute_ring": xs[(r - 1) % n],
                "ppermute_pairs": (xs[1 - r] if r in (0, 1)
                                   else np.zeros_like(xs[r]))}[case]
        np.testing.assert_allclose(got_y, want, rtol=0, atol=1e-5)


class _Posted:
    """A stand-in for one member's ``NCCLGroup``: its process group records
    the point-to-point calls the member posts, in order."""

    def __init__(self, rank, size, log):
        self.rank, self.world_size, self.last_backend = rank, size, None
        self.log = log

    def _pg(self, t):
        return self

    def name(self):
        return "nccl"

    def send(self, tensors, dst, tag):
        self.log.append(("send", dst))
        return _Done()

    def recv(self, tensors, src, tag):
        self.log.append(("recv", src))
        return _Done()


class _Done:
    def wait(self):
        return True


def _serial_channels_drain(posted) -> bool:
    """Whether members whose point-to-point calls run one at a time in
    posted order (one stream a member, as NCCL may run them), each send
    blocking until its peer's matching receive runs, finish them all."""
    queues = {r: list(ops) for r, ops in posted.items()}
    while any(queues.values()):
        for r, q in queues.items():
            if q and q[0][0] == "send":
                peer = q[0][1]
                if queues[peer] and queues[peer][0] == ("recv", r):
                    q.pop(0)
                    queues[peer].pop(0)
                    break
        else:
            return False
    return True


PERMUTATIONS = {
    "ring2": (2, [fn.ring_perm(2)]),
    "ring3": (3, [fn.ring_perm(3)]),
    "ring4": (4, [fn.ring_perm(4)]),
    "ring4-inverse": (4, [[(d, s) for s, d in fn.ring_perm(4)]]),
    "cycle4-0213": (4, [[(0, 2), (2, 1), (1, 3), (3, 0)]]),
    "shift4-open": (4, [[(i, i + 1) for i in range(3)]]),
    # the serving tree's butterfly: swaps with me ^ 1, then with me ^ 2
    "tree4": (4, [[(r, r ^ 1) for r in range(4)],
                  [(r, r ^ 2) for r in range(4)]]),
}


@pytest.mark.parametrize("case", list(PERMUTATIONS))
def test_permute_posts_in_an_order_serial_channels_finish(case):
    """``TensorGroup.permute`` (and ``exchange``, a swap) posts each
    member's send and receive so that a member running its calls in order
    on one stream, blocking until the peer's match runs, finishes: a swap
    between two members, a ring of two (context=2, pipeline=2) and the
    serving tree's butterfly included.  A ring of two where both members
    receive first is the control: the model must find it stuck."""
    from ray_tpu_torch.parallel.mesh import TensorGroup

    n, perms = PERMUTATIONS[case]
    posted = {r: [] for r in range(n)}
    x = torch.zeros(2)
    for perm in perms:
        for r in range(n):
            g = TensorGroup(_Posted(r, n, posted[r]))
            dst = [d for s_, d in perm if s_ == r]
            src = [s_ for s_, d in perm if d == r]
            g.permute(x, dst[0] if dst else None, src[0] if src else None)
    assert _serial_channels_drain(posted), posted
    assert not _serial_channels_drain(
        {0: [("recv", 1), ("send", 1)], 1: [("recv", 0), ("send", 0)]})


@pytest.mark.timeout(300)
def test_overlapped_sync_is_the_fused_sync_bit_for_bit(world2, jax_runs):
    _, tcfg = _cfgs()
    shapes = tl.init_params(tcfg, None, "meta", tl.train_param_dtypes(tcfg))
    buckets = partition_buckets(shapes, OVERLAP_BUCKET)
    assert len(buckets) > 2
    want_m, want_s = jax_runs("data2", dict(data=2), {})
    for r in range(2):
        fused_m, fused_s = world2[r]["world2"]["fused"]
        got_m, got_s = world2[r]["world2"]["overlap"]
        assert got_m == fused_m, r
        for step in (1, STEPS):
            for key, arr in fused_s[step].items():
                assert np.array_equal(got_s[step][key], arr), (r, key, step)
        orders = world2[r]["world2"]["overlap-order"]
        assert orders == [list(range(len(buckets)))] * STEPS
        assert world2[r]["world2"]["fused-order"] == []
        _check_metrics(got_m, want_m, f"overlap rank {r} vs JAX data=2")
        for step in (1, STEPS):
            _check_shards({r: got_s[step]}, _full_arrays(want_s[step]),
                          dict(data=2), step, "overlap vs JAX")


# tests/test_torch_grad_compression.py's tolerances for the codec: where
# fp32 rounding moves a gradient across a code boundary, its coded value
# moves by a whole block scale (params, mu, nu)
INT8_ATOL = (1e-4, 3e-5, 5e-7)


@pytest.mark.timeout(300)
def test_grad_compression_over_the_data_axis_matches_jax(world2, jax_runs):
    want_m, want_s = jax_runs("data2-int8", dict(data=2), {},
                              grad_compression="int8")
    for r in range(2):
        got_m, got_s = world2[r]["world2"]["int8"]
        _check_metrics(got_m, want_m, f"int8 rank {r}")
        for step in (1, STEPS):
            _check_shards({r: got_s[step]}, _full_arrays(want_s[step]),
                          dict(data=2), step, "int8 vs JAX", INT8_ATOL)


@pytest.mark.timeout(300)
def test_pipeline_loss_and_grads_match_jax(world2, start):
    state0, tokens = start
    jcfg, tcfg = _cfgs()
    mesh = JMeshSpec(pipeline=2).build(jax.devices()[:2])
    loss = jax_pipeline_loss(2)
    specs = jax_pp_specs(jcfg)
    from ray_tpu.parallel.mesh import shard_pytree as jshard

    params = jshard(jax.tree.map(jnp.asarray, state0.params), specs, mesh)
    val, grads = jax.jit(jax.value_and_grad(
        lambda p: loss(jcfg, p, jnp.asarray(tokens), mesh=mesh)))(params)
    full = {"params/" + "/".join(p.key for p in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    pspecs = _train_specs(tcfg, MeshSpec(pipeline=2).build())
    for r in range(2):
        got_loss, got = world2[r]["world2"]["pp-loss"]
        np.testing.assert_allclose(got_loss, float(val), rtol=LOSS_RTOL)
        pmesh = MeshSpec(pipeline=2).build(rank=r)
        for key, g in got.items():
            want = shard_slice(torch.from_numpy(full[f"params/{key}"]),
                               _spec(pspecs, f"params/{key}"), pmesh).numpy()
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {key}")


def test_pipeline_loss_refuses_what_jax_refuses(start):
    state0, tokens = start
    jcfg, tcfg = _cfgs()
    jmesh = JMeshSpec(pipeline=2).build(jax.devices()[:2])
    tmesh = MeshSpec(pipeline=2).build()  # refused before any collective
    tparams = convert.train_state_from_jax(state0, tcfg, device="cpu",
                                           mesh=tmesh).params
    cases = [(dict(context_parallel=True), NotImplementedError, "context"),
             (dict(loss_mask=np.ones((B, S), np.int32)), NotImplementedError,
              "loss_mask")]
    for kw, err, match in cases:
        with pytest.raises(err, match=match):
            jax_pipeline_loss(2)(jcfg, state0.params, jnp.asarray(tokens),
                                 mesh=jmesh, **kw)
        with pytest.raises(err, match=match):
            make_pipeline_loss(2)(tcfg, tparams, torch.from_numpy(tokens),
                                  mesh=tmesh, **kw)
    for m, match in ((3, "microbatches"),):
        with pytest.raises(ValueError, match=match):
            jax_pipeline_loss(m)(jcfg, state0.params, jnp.asarray(tokens),
                                 mesh=jmesh)
        with pytest.raises(ValueError, match=match):
            make_pipeline_loss(m)(tcfg, tparams, torch.from_numpy(tokens),
                                  mesh=tmesh)
    jcfg3 = dataclasses.replace(jcfg, n_layers=3)
    tcfg3 = dataclasses.replace(tcfg, n_layers=3)
    with pytest.raises(ValueError, match="n_layers"):
        jax_pipeline_loss(2)(jcfg3, state0.params, jnp.asarray(tokens),
                             mesh=jmesh)
    with pytest.raises(ValueError, match="n_layers"):
        make_pipeline_loss(2)(tcfg3, tparams, torch.from_numpy(tokens),
                              mesh=tmesh)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["tensor2-fsdp2", "pipeline2-fsdp2-m4"])
def test_train_state_from_jax_gives_each_rank_the_jax_shards(jax_runs, name):
    axes, kw = MESHES[name]
    jcfg, tcfg = _cfgs()
    n = int(np.prod(list(axes.values())))
    jmesh = JMeshSpec(**axes).build(jax.devices()[:n])
    init_fn, step_fn = jax_make_train_step(jcfg, jmesh, **kw)
    state = init_fn(jax.random.PRNGKey(0))
    state, _ = step_fn(state, jnp.asarray(_tokens()))
    full = _np(state)
    devices = list(jmesh.devices.flat)
    adam = state.opt_state[0]
    for r in range(n):
        ported = convert.train_state_from_jax(
            full, tcfg, device="cpu", mesh=MeshSpec(**axes).build(), rank=r)
        tadam = find_adam_state(ported.opt_state)
        for name_, jtree, ttree in (("params", state.params, ported.params),
                                    ("mu", adam.mu, tadam.mu),
                                    ("nu", adam.nu, tadam.nu)):
            jflat = dict(("/".join(p.key for p in path), leaf) for path, leaf
                         in jax.tree_util.tree_flatten_with_path(jtree)[0])
            for key, t in tree_leaves_with_keys(ttree):
                shard = [s for s in jflat[key].addressable_shards
                         if s.device == devices[r]][0]
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(shard.data),
                    err_msg=f"{name_}/{key} rank {r}")
        assert int(tadam.count) == 1 and int(ported.step) == 1


def test_refusals_name_their_roadmap_items():
    from ray_tpu_torch.llm.config import LLMConfig
    from ray_tpu_torch.llm.engine import TorchLLMEngine

    _, tcfg = _cfgs()
    # MoE meshes and the codec over sharded leaves run
    # (tests/test_torch_moe_mesh.py); MoE on a pipeline axis is refused in
    # the JAX builder's words
    with pytest.raises(NotImplementedError, match="expert-aware stage split"):
        make_train_step(tm.MoEConfig.tiny(), MeshSpec(pipeline=2).build(),
                        device="cpu")
    for kw in (dict(tensor_parallel_size=2), dict(pipeline_parallel_size=2)):
        with pytest.raises(NotImplementedError, match="A11 item 5"):
            TorchLLMEngine(LLMConfig(model_config=tcfg, max_seq_len=64, **kw),
                           device="cpu")
    # a mesh whose axes have no groups cannot run a sharded step
    with pytest.raises(ValueError, match="no group"):
        make_train_step(tcfg, MeshSpec(fsdp=2).build(), device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        make_train_step(tcfg, object(), device="cpu")


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_coordinates_are_jax_s_device_layout(name):
    """Rank r's coordinates are the index of ``jax.devices()[r]`` in the
    JAX mesh's device array, axis by axis; its batch group's members are
    the devices that differ from it on ("data", "fsdp") only."""
    from ray_tpu.parallel.mesh import batch_spec as jax_batch_spec
    from ray_tpu_torch.parallel.mesh import (MESH_AXES, batch_spec,
                                             coords_of, group_members)

    axes, _ = MESHES[name]
    spec = MeshSpec(**axes)
    jmesh = JMeshSpec(**axes).build(jax.devices()[:spec.num_devices])
    assert tuple(jmesh.axis_names) == MESH_AXES
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(spec.num_devices):
        where = tuple(int(i[0]) for i in np.nonzero(ids == r))
        assert tuple(coords_of(spec.shape, r).values()) == where
        batch = ids[where[0], :, :, where[3], where[4], where[5]].reshape(-1)
        assert group_members(spec.shape, r, ("data", "fsdp")) == list(batch)
    assert batch_spec() == tuple(jax_batch_spec())
    assert batch_spec(context_sharded=True) == tuple(
        jax_batch_spec(context_sharded=True))
