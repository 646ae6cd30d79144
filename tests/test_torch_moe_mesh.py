"""Sharded MoE training and the sharded gradient codec in the port (one
process per rank, over gloo on the CPU) against the JAX package's sharded
step (GSPMD on the 8 virtual CPU devices the conftest provides).

- ``make_train_step(MoEConfig.tiny(dispatch=...), mesh)`` on four meshes
  of four ranks (expert=2 x fsdp=2, expert=4, expert=2 x tensor=2, data=2
  x expert=2) under dispatch "auto" (GShard's dense dispatch under a
  mesh), "ragged" and "sorted_capacity", three steps from the JAX state's
  shards (``convert.train_state_from_jax(..., mesh=)``) on the global
  batch.  The state's router and embedding are biased so that most tokens
  pick expert 0 first and the capacity paths drop pairs (asserted: the
  JAX forward's logits move with ``capacity_factor``).  Loss and
  ``grad_norm`` within 1e-5 relative of JAX's at every step; every rank's
  shard of every param, mu and nu within (1e-4, 1e-6, 1e-6) of the JAX
  array's block after one step and after three (the tolerances of
  ``tests/test_torch_train_mesh.py``).
- ``grad_compression="int8"`` on Llama at tensor=2 x fsdp=2 and on MoE at
  expert=2 x fsdp=2, held to JAX's int8 steps with
  ``tests/test_torch_train_mesh.py``'s int8 tolerances, but for a param
  whose gradient crossed a code boundary (its Adam update moves by up to
  the learning rate a step): at most 0.1% of a leaf's elements, each
  within 2 lr a step.
- The control: the dense dispatch with capacity positions counted per
  rank (each rank's tokens slotted from zero) must fail that check.
- The codec over sharded leaves: the same gradient tree through the JAX
  transform on the logical leaves and through each rank's
  ``GradientCompression.update`` on its shards (``shard_layout``): the
  codes, the decoded gradient and the residual bit for bit, at fsdp=2,
  tensor=2, pipeline=2 x fsdp=2, expert=2 x fsdp=2 and data=2 x fsdp=2,
  with and without error feedback.  The embedding's blocks straddle the
  fsdp shards, the head's the tensor shards; both are at ``min_bytes``
  logically and under it by their shards.
- ``functional.all_to_all``'s backward against its definition at worlds 2
  and 4.

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
from ray_tpu.models import moe as jm
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.util.collective import compression as jcomp
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_leaves_with_keys
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.parallel import functional as fn
from ray_tpu_torch.parallel import make_train_step
from ray_tpu_torch.parallel.mesh import MeshSpec, shard_bounds, shard_slice
from ray_tpu_torch.parallel.optim import find_adam_state
from ray_tpu_torch.parallel.pipeline import pipeline_param_specs
from ray_tpu_torch.parallel.train_step import _spec_leaves, _train_specs
from ray_tpu_torch.util.collective import compression as tcomp

torch.set_num_threads(1)

B, S, STEPS = 8, 64, 3
LOSS_RTOL = 1e-5
STATE_ATOL = (1e-4, 1e-6, 1e-6)  # params, mu, nu
MESHES = {
    "expert2-fsdp2": dict(expert=2, fsdp=2),
    "expert4": dict(expert=4),
    "expert2-tensor2": dict(expert=2, tensor=2),
    "data2-expert2": dict(data=2, expert=2),
}
DISPATCHES = ("auto", "ragged", "sorted_capacity")
# the router and embedding bias that makes the capacity paths drop pairs
EMBED_BIAS, ROUTER_BIAS = 0.02, 0.1
# the codec's meshes: (axes, "llama" or "moe")
CODEC_MESHES = {
    "fsdp2": (dict(fsdp=2), "llama"),
    "tensor2": (dict(tensor=2), "llama"),
    "pipeline2-fsdp2": (dict(pipeline=2, fsdp=2), "llama"),
    "expert2-fsdp2": (dict(expert=2, fsdp=2), "moe"),
    "data2-fsdp2": (dict(data=2, fsdp=2), "llama"),
}
# min_bytes at the Llama embedding's and head's logical size: their fsdp
# (and tensor) shards are under it
CODEC_MIN_BYTES = 1 << 17
CODECS = {"int8": {"min_bytes": CODEC_MIN_BYTES},
          "int8-ef": {"min_bytes": CODEC_MIN_BYTES, "error_feedback": True}}


# the codec on sharded meshes: (family, mesh axes); Llama at n_kv_heads 4
INT8_MESHES = {"llama-tensor2-fsdp2": ("llama", dict(tensor=2, fsdp=2)),
               "moe-expert2-fsdp2": ("moe", dict(expert=2, fsdp=2))}
LLAMA = (jl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4),
         tl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4))
# tests/test_torch_train_mesh.py's int8 tolerances (params, mu, nu): where
# fp32 rounding moves a gradient across a code boundary, its coded value
# moves by a whole block scale
INT8_ATOL = (1e-4, 3e-5, 5e-7)
# ... and its Adam update by up to the learning rate a step (a code of 0
# against one of 1 is an update of 0 against one of lr): params within
# 2 lr a step, and no more than INT8_FLIPS of the elements past INT8_ATOL
LR = 3e-4
INT8_FLIPS = 1e-3


def _cfgs(dispatch="auto"):
    return (jm.MoEConfig.tiny(dispatch=dispatch),
            tm.MoEConfig.tiny(dispatch=dispatch))


def _tokens():
    return np.random.default_rng(11).integers(0, 256, (B, S)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _biased_state():
    """JAX's initial MoE state, its embedding and expert 0's router column
    shifted along one direction: most tokens pick expert 0 first."""
    jcfg, _ = _cfgs()
    init_fn, _ = jax_make_train_step(jcfg)
    state = _np(init_fn(jax.random.PRNGKey(0)))
    u = np.random.default_rng(5).choice([-1.0, 1.0], jcfg.dim).astype(
        np.float32)
    params = dict(state.params, layers=dict(state.params["layers"]))
    params["embed"] = params["embed"] + EMBED_BIAS * u
    router = params["layers"]["router"].copy()
    router[:, :, 0] += ROUTER_BIAS * u
    params["layers"]["router"] = router
    return state._replace(params=params)


@pytest.fixture(scope="module")
def start():
    return _biased_state(), _tokens()


def _int8_states():
    """{family: JAX's initial state with the int8 codec chained}: MoE's
    with the biased params, Llama's (``LLAMA``) as drawn."""
    init_fn, _ = jax_make_train_step(_cfgs()[0], grad_compression="int8")
    moe_state = _np(init_fn(jax.random.PRNGKey(0)))
    init_fn, _ = jax_make_train_step(LLAMA[0], grad_compression="int8")
    return {"moe": moe_state._replace(params=_biased_state().params),
            "llama": _np(init_fn(jax.random.PRNGKey(0)))}


def _jax_run(jcfg, axes, state0, tokens, **kw):
    n = int(np.prod(list(axes.values())))
    mesh = JMeshSpec(**axes).build(jax.devices()[:n])
    _, step_fn = jax_make_train_step(jcfg, mesh, **kw)
    state, metrics, states = state0, [], {}
    for i in range(STEPS):
        state, m = step_fn(state, jnp.asarray(tokens))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i + 1 in (1, STEPS):
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
    adam = find_adam_state(state.opt_state)
    out = {}
    for name, tree in (("params", state.params), ("mu", adam.mu),
                       ("nu", adam.nu)):
        for k, v in tree_leaves_with_keys(tree):
            out[f"{name}/{k}"] = v.detach().numpy().copy()
    return out


def _steps(tcfg, mesh, state0, tokens, steps=STEPS, **kw):
    _, step_fn = make_train_step(tcfg, mesh, device="cpu", **kw)
    state = convert.train_state_from_jax(state0, tcfg, device="cpu",
                                         mesh=mesh)
    metrics, states = [], {}
    for i in range(steps):
        state, m = step_fn(state, torch.from_numpy(tokens))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i + 1 in (1, steps):
            states[i + 1] = _state_np(state)
    return metrics, states


def _per_rank_counts(counts, sh):
    """The control's capacity positions: each rank's own counts as if its
    tokens were the whole batch."""
    return torch.zeros_like(counts), counts


def _job_moe(rank, store, inputs):
    state0, tokens = inputs["state0"], inputs["tokens"]
    out = {}
    for name, axes in MESHES.items():
        for dispatch in DISPATCHES:
            _, tcfg = _cfgs(dispatch)
            mesh = MeshSpec(**axes).build(rank=rank, store=store,
                                          name=f"{name}-{dispatch}")
            try:
                out[(name, dispatch)] = _steps(tcfg, mesh, state0, tokens)
            finally:
                mesh.destroy()
    for name, (family, axes) in INT8_MESHES.items():
        tcfg = LLAMA[1] if family == "llama" else _cfgs()[1]
        mesh = MeshSpec(**axes).build(rank=rank, store=store, name=name)
        try:
            out[name] = _steps(tcfg, mesh, inputs["int8"][family], tokens,
                               grad_compression="int8")
        finally:
            mesh.destroy()
    _, tcfg = _cfgs("auto")
    mesh = MeshSpec(**MESHES["expert2-fsdp2"]).build(rank=rank, store=store,
                                                     name="control")
    counts = tm._global_counts
    tm._global_counts = _per_rank_counts
    try:
        out["control"] = _steps(tcfg, mesh, state0, tokens, steps=1)
    finally:
        tm._global_counts = counts
        mesh.destroy()
    return out


def _codec_tree(kind):
    """(params-shaped numpy gradients, residuals) of the codec test's
    model, each leaf drawn from its own seed."""
    cfg = (tl.LlamaConfig.tiny(n_heads=8, n_kv_heads=4) if kind == "llama"
           else tm.MoEConfig.tiny())
    mod = tl if kind == "llama" else tm
    shapes = mod.init_params(cfg, None, "meta", mod.train_param_dtypes(cfg))
    leaves = tree_leaves_with_keys(shapes)
    grads = {k: np.random.default_rng(300 + i).standard_normal(
        tuple(t.shape)).astype(np.float32) for i, (k, t) in enumerate(leaves)}
    resid = {k: 0.01 * np.random.default_rng(400 + i).standard_normal(
        tuple(t.shape)).astype(np.float32) for i, (k, t) in enumerate(leaves)}
    return cfg, grads, resid


def _codec_specs(cfg, axes):
    if isinstance(cfg, tm.MoEConfig):
        return tm.param_specs(cfg)
    return (pipeline_param_specs(cfg) if axes.get("pipeline", 1) > 1
            else tl.param_specs(cfg))


def _job_codec(rank, store, inputs):
    """{(mesh, codec): {leaf: (codes or None, coded, residual)}} of this
    rank's shards."""
    out = {}
    for name, (axes, kind) in CODEC_MESHES.items():
        if int(np.prod(list(axes.values()))) != inputs["n"]:
            continue
        cfg, grads, resid = _codec_tree(kind)
        specs = _codec_specs(cfg, axes)
        mesh = MeshSpec(**axes).build(rank=rank, store=store,
                                      name=f"codec-{name}")
        try:
            keys = sorted(grads)
            spec_of = {k: _spec(specs, "x/" + k) for k in keys}
            layouts = [tcomp.shard_layout(grads[k].shape, spec_of[k], mesh)
                       for k in keys]

            def shards(tree):
                return [shard_slice(torch.from_numpy(tree[k]), spec_of[k],
                                    mesh).clone() for k in keys]

            for codec, spec in CODECS.items():
                tx = tcomp.compress_gradients(spec)
                g = shards(grads)
                r = shards(resid)
                state = (tcomp.ResidualState(dict(zip(keys, r)))
                         if tx.spec.error_feedback else None)
                coded = tx.update(g, state, layouts)
                res = {}
                for k, gk, rk, ck, lay in zip(keys, shards(grads),
                                              shards(resid), coded, layouts):
                    codes = None
                    if tx.eligible(gk, lay):
                        x = gk + rk if tx.spec.error_feedback else gk
                        codes = tcomp.code_shard(x, lay)[0].numpy()
                    res[k] = (codes, ck.numpy().copy(),
                              dict(zip(keys, r))[k].numpy().copy())
                out[(name, codec)] = res
        finally:
            mesh.destroy()
    return out


def _job_ops(rank, store, inputs):
    n = inputs["n"]
    mesh = MeshSpec(data=n).build(rank=rank, store=store, name=f"a2a{n}")
    try:
        x = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(
            (n * 2, 3)).astype(np.float32)).requires_grad_(True)
        y = fn.all_to_all(x, mesh.axis_group("data"))
        w = torch.from_numpy(np.random.default_rng(200 + rank).standard_normal(
            (n * 2, 3)).astype(np.float32))
        (g,) = torch.autograd.grad((y * w).sum(), [x])
        return g.numpy(), y.detach().numpy()
    finally:
        mesh.destroy()


_JOBS = {"moe": _job_moe, "codec": _job_codec, "ops": _job_ops}


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
    return _world(4, ("moe", "codec", "ops"),
                  dict(state0=state0, tokens=tokens, n=4,
                       int8=_int8_states()))


@pytest.fixture(scope="module")
def world2():
    return _world(2, ("codec", "ops"), dict(n=2))


_JAX = {}


@pytest.fixture(scope="module")
def jax_runs(start):
    state0, tokens = start

    def run(name, dispatch):
        if (name, dispatch) not in _JAX:
            _JAX[name, dispatch] = _jax_run(
                _cfgs(dispatch)[0], MESHES[name], state0, tokens)
        return _JAX[name, dispatch]

    return run


# -- checks -------------------------------------------------------------------


def _full_arrays(jstate):
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


def _check_run(got, want, axes, what, tcfg=None, atols=STATE_ATOL,
               flips=False):
    """Rank r's (metrics, states, r) of a port run against JAX's run;
    ``flips``: the int8 codec's code flips allowed for (``INT8_FLIPS``)."""
    got_m, got_s, rank = got
    want_m, want_s = want
    for i, ((gl, gn), (wl, wn)) in enumerate(zip(got_m, want_m)):
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL,
                                   err_msg=f"{what} loss {i}")
        np.testing.assert_allclose(gn, wn, rtol=LOSS_RTOL,
                                   err_msg=f"{what} grad_norm {i}")
    spec = MeshSpec(**axes)
    specs = _train_specs(tcfg or _cfgs()[1], spec.build())
    atols = dict(zip(("params", "mu", "nu"), atols))
    mesh = spec.build(rank=rank)
    for step, arrays in got_s.items():
        full = _full_arrays(want_s[step])
        assert sorted(arrays) == sorted(full), what
        for key, arr in arrays.items():
            want_arr = shard_slice(torch.from_numpy(np.array(full[key])),
                                   _spec(specs, key), mesh).numpy()
            assert arr.shape == want_arr.shape, (what, key)
            atol = atols[key.split("/")[0]]
            if flips and key.startswith("params/"):
                far = np.abs(arr - want_arr) > atol
                assert far.mean() <= INT8_FLIPS, (what, key, far.sum())
                atol = 2 * LR * step
            np.testing.assert_allclose(
                arr, want_arr, rtol=0, atol=atol,
                err_msg=f"{what} {key} after {step} steps")


def test_the_biased_router_makes_the_capacity_paths_drop(start):
    state0, tokens = start
    params = jax.tree.map(jnp.asarray, state0.params)
    for dispatch in ("dense", "sorted_capacity"):
        logits = [np.asarray(jm.forward(
            jm.MoEConfig.tiny(dispatch=dispatch, capacity_factor=cf), params,
            jnp.asarray(tokens))[0]) for cf in (1.25, 8.0)]
        assert np.abs(logits[0] - logits[1]).max() > 1e-3, dispatch


@pytest.mark.timeout(600)
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_moe_step_matches_jax_on_the_same_mesh(world4, jax_runs, name,
                                                       dispatch):
    want = jax_runs(name, dispatch)
    for r in range(4):
        got_m, got_s = world4[r]["moe"][(name, dispatch)]
        _check_run((got_m, got_s, r), want, MESHES[name],
                   f"{name} {dispatch} rank {r}")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", list(INT8_MESHES))
def test_grad_compression_on_sharded_meshes_matches_jax(world4, name):
    family, axes = INT8_MESHES[name]
    jcfg, tcfg = LLAMA if family == "llama" else _cfgs()
    want = _jax_run(jcfg, axes, _int8_states()[family], _tokens(),
                    grad_compression="int8")
    for r in range(4):
        got_m, got_s = world4[r]["moe"][name]
        _check_run((got_m, got_s, r), want, axes, f"{name} rank {r}", tcfg,
                   INT8_ATOL, flips=True)


@pytest.mark.timeout(600)
def test_per_rank_capacity_positions_fail_the_check(world4, jax_runs):
    want_m, want_s = jax_runs("expert2-fsdp2", "auto")
    got_m, got_s = world4[0]["moe"]["control"]
    with pytest.raises(AssertionError):
        _check_run((got_m, got_s, 0), (want_m[:1], want_s),
                   MESHES["expert2-fsdp2"], "control")


def _jax_codec(kind, codec):
    """{leaf: (codes or None, coded, residual)} of the JAX transform on the
    logical leaves."""
    cfg, grads, resid = _codec_tree(kind)
    tx = jcomp.compress_gradients(CODECS[codec])
    spec = jcomp.resolve_spec(CODECS[codec])
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    state = tx.init(g)
    if spec.error_feedback:
        state = state._replace(residual={k: jnp.asarray(v)
                                         for k, v in resid.items()})
    coded, new_state = tx.update(g, state)
    out = {}
    for k in grads:
        x = grads[k] + resid[k] if spec.error_feedback else grads[k]
        codes = None
        if x.nbytes >= spec.min_bytes:
            flat = x.reshape(-1)
            pad = np.pad(flat, (0, (-flat.size) % spec.block_size))
            codes = np.asarray(jcomp.jnp_quantize_blocks(
                jnp.asarray(pad), spec.block_size)[0])[:flat.size].reshape(
                    x.shape)
        r = (np.asarray(new_state.residual[k]) if spec.error_feedback
             else resid[k])
        out[k] = (codes, np.asarray(coded[k]), r)
    return cfg, out


def _straddles(shape, spec, mesh):
    """Whether some block of the leaf's flattened form spans two ranks'
    shards: a run of a shard starts or ends inside a block."""
    numel = int(np.prod(shape))
    for r in range(mesh.size):
        n, starts = tcomp._runs(shape, shard_bounds(shape, spec, mesh, r))
        ends = starts + n
        if np.any(starts % 256) or np.any((ends % 256 != 0) & (ends != numel)):
            return True
    return False


@pytest.mark.timeout(600)
@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("name", list(CODEC_MESHES))
def test_sharded_codec_is_jax_s_on_the_logical_leaves(world2, world4, name,
                                                      codec):
    axes, kind = CODEC_MESHES[name]
    spec = MeshSpec(**axes)
    world = world2 if spec.num_devices == 2 else world4
    cfg, want = _jax_codec(kind, codec)
    specs = _codec_specs(cfg, axes)
    straddles = set()
    for r in range(spec.num_devices):
        mesh = spec.build(rank=r)
        got = world[r]["codec"][(name, codec)]
        assert sorted(got) == sorted(want)
        for k, (codes, coded, resid) in got.items():
            def mine(a):
                return shard_slice(torch.from_numpy(np.array(a)),
                                   _spec(specs, "x/" + k), mesh).numpy()

            w_codes, w_coded, w_resid = want[k]
            assert (codes is None) == (w_codes is None), (name, k)
            if codes is not None:
                assert np.array_equal(codes, mine(w_codes)), (name, k, r)
            assert np.array_equal(coded.view(np.int32),
                                  mine(w_coded).view(np.int32)), (name, k, r)
            assert np.array_equal(resid.view(np.int32),
                                  mine(w_resid).view(np.int32)), (name, k, r)
            if codes is not None and _straddles(want[k][1].shape,
                                                _spec(specs, "x/" + k), mesh):
                straddles.add(k)
    # a leaf whose blocks the shards split is coded on every mesh that
    # shards the params over fsdp or tensor
    if any(a in axes for a in ("fsdp", "tensor")):
        assert straddles, name
    # the embedding: at min_bytes whole, under it by its fsdp shard
    if "fsdp" in axes and kind == "llama":
        emb = want["embed"][1]
        assert emb.nbytes == CODEC_MIN_BYTES
        assert want["embed"][0] is not None


@pytest.mark.timeout(600)
@pytest.mark.parametrize("n", [2, 4])
def test_all_to_all_s_backward_is_its_transpose(world2, world4, n):
    res = world2 if n == 2 else world4
    xs = [np.random.default_rng(100 + r).standard_normal((2 * n, 3)).astype(
        np.float32) for r in range(n)]
    ws = [np.random.default_rng(200 + r).standard_normal((2 * n, 3)).astype(
        np.float32) for r in range(n)]
    for r in range(n):
        got_g, got_y = res[r]["ops"]
        # y_r's block i is x_i's block r; so d/dx_r's block j is w_j's block r
        np.testing.assert_array_equal(
            got_y, np.concatenate([x[2 * r:2 * r + 2] for x in xs]))
        np.testing.assert_array_equal(
            got_g, np.concatenate([w[2 * r:2 * r + 2] for w in ws]))


def test_moe_specs_and_train_state_from_jax_shards():
    """``param_specs`` are JAX's, and ``train_state_from_jax(..., mesh=,
    rank=)`` gives each rank the JAX array's shard on that device."""
    jcfg, tcfg = _cfgs()
    axes = MESHES["expert2-tensor2"]
    jmesh = JMeshSpec(**axes).build(jax.devices()[:4])
    init_fn, _ = jax_make_train_step(jcfg, jmesh)
    state = init_fn(jax.random.PRNGKey(0))
    full = _np(state)
    devices = list(jmesh.devices.flat)
    for r in range(4):
        ported = convert.train_state_from_jax(
            full, tcfg, device="cpu", mesh=MeshSpec(**axes).build(), rank=r)
        jflat = dict(("/".join(p.key for p in path), leaf) for path, leaf
                     in jax.tree_util.tree_flatten_with_path(state.params)[0])
        for key, t in tree_leaves_with_keys(ported.params):
            shard = [s for s in jflat[key].addressable_shards
                     if s.device == devices[r]][0]
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data),
                                          err_msg=f"{key} rank {r}")
    assert jax.tree.map(tuple, jm.param_specs(jcfg)) == tm.param_specs(tcfg)
    assert len(_spec_leaves(tm.param_specs(tcfg))) == len(
        tree_leaves(ported.params))


def test_moe_mesh_refusals_are_jax_s():
    _, tcfg = _cfgs()
    for axes in (dict(pipeline=2), dict(pipeline=2, expert=2)):
        with pytest.raises(NotImplementedError,
                           match="expert-aware stage split"):
            make_train_step(tcfg, MeshSpec(**axes).build(), device="cpu")
    jcfg, _ = _cfgs()
    with pytest.raises(NotImplementedError, match="expert-aware stage split"):
        jax_make_train_step(jcfg, JMeshSpec(pipeline=2).build(
            jax.devices()[:2]))
    # a mesh whose axes have no groups cannot run a sharded step
    with pytest.raises(ValueError, match="no group"):
        make_train_step(tcfg, MeshSpec(expert=2).build(), device="cpu")
