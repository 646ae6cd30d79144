"""Tensor-parallel paged serving: the port's rank processes against
``ray_tpu``'s TP programs and engines, on the CPU over gloo.

- Programs: ``decode_step_paged``, ``prefill_chunk_paged`` and
  ``decode_window_paged`` at tensor-parallel world sizes 2 and 4 (one test
  per world, so a world's ranks are spawned once), one process per rank
  (rank 0 here, the others spawned), each on its shard of
  the weights (``inference_param_specs``) and of the pool
  (``paged_kv_cache_spec``), with the reductions unplanned (the twin of
  GSPMD's implicit psum) and planned flat, ring and tree.  Rank 0's logits
  equal the JAX package's programs over an 8-virtual-device mesh (GSPMD)
  within 2e-5 of the logits' largest magnitude (fp32; the JAX package's
  planned paths raise on this jax, whose ``shard_map`` takes no
  ``check_rep``, so every port schedule is held to GSPMD's result), and
  every rank's pool shard equals the JAX pool's shard on the same device,
  block by block, within 1e-5.
- Engines: ``PagedTorchLLMEngine(tensor_parallel_size=2)`` starts its rank
  process itself.  Greedy tokens equal the port's tp=1 engine and JAX's
  tp=2 engine (GSPMD collectives); ``utilization()["tp"]`` carries the
  JAX engine's keys with per-device bytes, and the planned collectives
  book on rank 0.  Speculative decoding, a merged LoRA adapter and a
  tp=2 -> tp=1 -> tp=2 handoff round trip are held to the port's own
  tp=1 run (ROADMAP's caveat: the JAX TP engine is red on those).

Each spawned rank imports torch afresh (about 2 s); every test that
starts ranks carries a 240 s watchdog.
"""

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.llm.config import GenerationConfig as JGen
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.paged import PagedJaxLLMEngine
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import shard_pytree as jshard
from ray_tpu_torch import convert
from ray_tpu_torch._private import runtime_metrics as trm
from ray_tpu_torch.llm import paged as tpaged
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

WORLDS = (2, 4)
ALGOS = ("gspmd", "flat", "ring", "tree")
PROGRAMS = ("decode", "prefill", "window")
NB, BS, W, C, T = 12, 8, 4, 16, 3

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2],
           [int(t) for t in np.random.RandomState(20).randint(1, 255, 34)]]
KW = dict(max_batch_size=4, max_seq_len=128, block_size=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig.tiny(n_kv_heads=4, compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tl.LlamaConfig.tiny(n_kv_heads=4)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def _inputs(cfg):
    rng = np.random.default_rng(3)
    kvd = cfg.n_kv_heads * cfg.head_dim
    return dict(
        pool=rng.standard_normal((2, cfg.n_layers, NB, BS, kvd)).astype(
            np.float32),
        decode=(np.array([5, 77], np.int32), np.array([[3, 7, 1, 9],
                                                       [4, 11, 2, 0]], np.int32),
                np.array([20, 13], np.int32)),
        prefill=(rng.integers(1, 255, (1, C)).astype(np.int32),
                 np.array([[3, 7, 1, 9]], np.int32), 16),
        window=(rng.integers(1, 255, (2, T)).astype(np.int32),
                np.array([[3, 7, 1, 9], [4, 11, 2, 0]], np.int32),
                np.array([17, 9], np.int32)))


def _port_programs(cfg, params, inputs, mesh):
    """Every program at every schedule on this rank: {(program, algo):
    (logits, k shard, v shard)} as numpy."""
    out = {}
    rope = tl.rope_cache(cfg, 64, "cpu")
    spec = tl.paged_kv_cache_spec()
    for algo in ALGOS:
        plan = None if algo == "gspmd" else tl.TPPlan(mesh=mesh, algorithm=algo)
        for prog in PROGRAMS:
            pool = {n: tmesh.shard_slice(torch.from_numpy(inputs["pool"][i]),
                                         spec[n], mesh).clone()
                    for i, n in enumerate(("k", "v"))}
            if prog == "decode":
                tok, table, lens = (torch.from_numpy(a) for a in inputs["decode"])
                logits, pool = tl.decode_step_paged(
                    cfg, params, tok, pool, table, lens, rope, mesh=mesh,
                    tp_plan=plan)
            elif prog == "prefill":
                tok, table, p0 = inputs["prefill"]
                logits, pool = tl.prefill_chunk_paged(
                    cfg, params, torch.from_numpy(tok), pool,
                    torch.from_numpy(table), p0, rope, tp_plan=plan, mesh=mesh)
            else:
                tok, table, lens = (torch.from_numpy(a) for a in inputs["window"])
                logits, pool = tl.decode_window_paged(
                    cfg, params, tok, pool, table, lens, rope, pos_limit=64,
                    tp_plan=plan, mesh=mesh)
            out[(prog, algo)] = (logits.numpy(), pool["k"].numpy(),
                                 pool["v"].numpy())
    return out


def _rank_mesh(rank, size, port, name):
    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    store = dist.TCPStore("127.0.0.1", port, size, rank == 0,
                          timeout=datetime.timedelta(seconds=120),
                          wait_for_workers=False)
    group = NCCLGroup(size, rank, name, store=store)
    return tmesh.Mesh({"tensor": size}, rank=rank,
                      group=tmesh.TensorGroup(group)), group


def _program_rank(rank, size, port, cfg, params, inputs, queue):
    torch.set_num_threads(1)
    mesh, group = _rank_mesh(rank, size, port, f"progs-{size}")
    try:
        shards = tmesh.shard_pytree(params, tl.inference_param_specs(cfg), mesh)
        queue.put((rank, _port_programs(cfg, shards, inputs, mesh)))
    finally:
        group.destroy()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RUNS = {}  # world -> {rank: results}, made once per process


@pytest.fixture(scope="module")
def port_runs(weights):
    """(inputs, run(world)): ``run`` gives {rank: results} of that world's
    ranks running every program at every schedule (rank 0 in this
    process), made at first use."""
    _, _, tcfg, tp = weights
    inputs = _inputs(tcfg)
    return inputs, lambda size: _RUNS.get(size) or _RUNS.setdefault(
        size, _run_world(tcfg, tp, inputs, size))


def _run_world(tcfg, tp, inputs, size):
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_program_rank, daemon=True,
                         args=(r, size, port, tcfg, tp, inputs, queue))
             for r in range(1, size)]
    for p in procs:
        p.start()
    try:
        mesh, group = _rank_mesh(0, size, port, f"progs-{size}")
        try:
            shards = tmesh.shard_pytree(tp, tl.inference_param_specs(tcfg),
                                        mesh)
            res = {0: _port_programs(tcfg, shards, inputs, mesh)}
        finally:
            group.destroy()
        for _ in procs:
            r, got = queue.get()
            res[r] = got
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
    return res


_JAX_RUNS = {}  # (world, program) -> (logits, per-device pool shards)


@pytest.fixture(scope="module")
def jax_runs(weights, port_runs):
    """run(world, program): the JAX program over a tensor mesh of that
    world (GSPMD), made at first use."""
    jcfg, jp, _, _ = weights
    inputs = port_runs[0]
    rope = tuple(jnp.asarray(x) for x in jl.rope_frequencies(
        jcfg.head_dim, 64, jcfg.rope_theta))

    def run(size, prog):
        key = (size, prog)
        if key in _JAX_RUNS:
            return _JAX_RUNS[key]
        mesh = JMeshSpec(tensor=size).build(jax.devices()[:size])
        jps = jshard(jp, jl.inference_param_specs(jcfg), mesh)
        pool = jshard({"k": jnp.asarray(inputs["pool"][0]),
                       "v": jnp.asarray(inputs["pool"][1])},
                      jl.paged_kv_cache_spec(), mesh)
        if prog == "decode":
            tok, table, lens = (jnp.asarray(a) for a in inputs["decode"])
            logits, pool = jl.decode_step_paged(
                jcfg, jps, tok, pool, table, lens, rope_cache=rope, mesh=mesh)
        elif prog == "prefill":
            tok, table, p0 = inputs["prefill"]
            logits, pool = jl.prefill_chunk_paged(
                jcfg, jps, jnp.asarray(tok), pool, jnp.asarray(table),
                jnp.int32(p0), rope_cache=rope)
        else:
            tok, table, lens = (jnp.asarray(a) for a in inputs["window"])
            logits, pool = jl.decode_window_paged(
                jcfg, jps, tok, pool, table, lens, rope_cache=rope,
                pos_limit=64)
        shards = {n: [np.asarray(sh.data) for sh in sorted(
            pool[n].addressable_shards, key=lambda sh: sh.device.id)]
            for n in ("k", "v")}
        return _JAX_RUNS.setdefault(key, (np.asarray(logits), shards))

    return run


@pytest.mark.timeout(240)
@pytest.mark.parametrize("size", WORLDS)
def test_programs_match_jax_tp_at_each_world(port_runs, jax_runs, size):
    """One world's ranks (spawned once: each rank imports torch afresh) at
    every program and schedule: rank 0's logits equal JAX's within 2e-5 of
    their largest magnitude; rank r's pool shard is the JAX pool's shard
    on device r, block by block, within 1e-5 (the schedules differ only
    after the writes); flat is one all-reduce like the unplanned twin, so
    bit-equal to it, and ring and tree sum in other orders, within fp32
    rounding of it."""
    res = port_runs[1](size)
    assert sorted(res) == list(range(size))
    for prog in PROGRAMS:
        want, shards = jax_runs(size, prog)
        base = res[0][(prog, "gspmd")][0]
        for algo in ALGOS:
            got = res[0][(prog, algo)][0]
            assert got.shape == want.shape, (prog, algo)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=2e-5 * float(np.abs(want).max()),
                err_msg=f"{prog} {algo}")
            if algo == "flat":
                assert np.array_equal(got, base), prog
            elif algo != "gspmd":
                np.testing.assert_allclose(got, base, rtol=0,
                                           atol=1e-5 * np.abs(base).max(),
                                           err_msg=f"{prog} {algo}")
            for r in range(size):
                _, k, v = res[r][(prog, algo)]
                for t, w in ((k, shards["k"][r]), (v, shards["v"][r])):
                    assert t.shape == w.shape, (prog, algo, r)
                    for b in range(NB):
                        np.testing.assert_allclose(
                            t[:, b], w[:, b], rtol=1e-5, atol=1e-5,
                            err_msg=f"{prog} {algo} rank {r} block {b}")


# -- the engine ---------------------------------------------------------------


def _engine(tcfg, tp, size, **kw):
    return tpaged.PagedTorchLLMEngine(
        LLMConfig(model_config=tcfg, tensor_parallel_size=size,
                  **dict(KW, **kw)), params=tp, device="cpu")


@pytest.fixture(scope="module")
def jax_tp2(weights):
    jcfg, jp, _, _ = weights
    return PagedJaxLLMEngine(JLLMConfig(model_config=jcfg, tensor_parallel_size=2,
                                       tp_planned_collectives=False, **KW),
                             params=jp)


@pytest.fixture(scope="module")
def engines(weights):
    _, _, tcfg, tp = weights
    e1 = _engine(tcfg, tp, 1)
    before = trm.plan_snapshot()
    e2 = _engine(tcfg, tp, 2)
    after = trm.plan_snapshot()
    plan_delta = {k: after.get(k, 0.0) - before.get(k, 0.0)
                  for k in after if after.get(k) != before.get(k, 0.0)}
    yield e1, e2, plan_delta
    e2.shutdown()


@pytest.mark.timeout(240)
def test_tp2_engine_tokens_equal_tp1_and_jax_tp2(engines, jax_tp2):
    e1, e2, _ = engines
    gen = GenerationConfig(max_new_tokens=12)
    want = e1.generate(PROMPTS, gen)
    assert e2.generate(PROMPTS, gen) == want
    je = jax_tp2
    assert je.mesh is not None
    assert je.generate(PROMPTS, JGen(max_new_tokens=12)) == want


@pytest.mark.timeout(240)
def test_tp4_engine_tokens_equal_tp1(weights):
    _, _, tcfg, tp = weights
    gen = GenerationConfig(max_new_tokens=8)
    want = _engine(tcfg, tp, 1).generate(PROMPTS, gen)
    e4 = _engine(tcfg, tp, 4, tp_collective_algorithm="tree")
    try:
        assert e4._tp_plan.algorithm == "tree"
        assert e4.generate(PROMPTS, gen) == want
        assert e4.pool["k"].shape[-1] * 4 == tcfg.n_kv_heads * tcfg.head_dim
    finally:
        e4.shutdown()
    assert all(not p.is_alive() for p in e4._ranks.procs)


@pytest.mark.timeout(240)
def test_utilization_tp_row_and_booked_collectives(engines, jax_tp2):
    """The JAX engine's ``tp`` keys; per-device bytes are half the tp=1
    engine's pool and under its weights; building the engine booked one
    flat/latency_bound plan per program kind; dispatches book the flat
    algorithm's bytes, and the tp=1 engine books nothing."""
    e1, e2, plan_delta = engines
    row = e2.utilization()["tp"]
    assert set(row) == set(jax_tp2.utilization()["tp"])
    assert row["degree"] == 2 and row["mesh_shape"] == {"tensor": 2}
    assert row["mesh_devices"] == 2
    from ray_tpu_torch._private import device_telemetry as tdt

    assert row["kv_bytes_per_device"] * 2 == tdt.tree_nbytes(e1.pool)
    assert 0 < row["weights_bytes_per_device"] < tdt.tree_nbytes(e1.params)
    assert set(row["planned_collectives"]) == {"decode", "prefill"}
    for r in row["planned_collectives"].values():
        assert r["chosen"] == "flat" and r["reason"] == "latency_bound"
        assert set(r["modeled_cost_s"]) >= {"flat", "ring", "tree"}
    assert plan_delta.get("flat/latency_bound", 0.0) >= 2.0, plan_delta
    assert "tp" not in e1.utilization()

    def flat_bytes():
        snap = trm.tp_collective_snapshot()
        return sum(a.get("flat", {}).get("bytes", 0.0) for a in snap.values())

    b0 = flat_bytes()
    e1.generate(PROMPTS[:1], GenerationConfig(max_new_tokens=4))
    assert flat_bytes() == b0
    e2.generate(PROMPTS[:1], GenerationConfig(max_new_tokens=4))
    assert flat_bytes() > b0


@pytest.mark.timeout(240)
@pytest.mark.parametrize("given", [False, True], ids=["drawn", "given"])
def test_the_leader_holds_only_its_shard(weights, given):
    """A tp=2 engine's leader keeps its shard of the weights and nothing
    more: every leaf its own storage (no view into a full tensor), equal
    to rank 0's slice of the full weights, and their bytes the sharded
    leaves' half plus the replicated ones whole.  Random weights (params
    None) are drawn tensor by tensor on every rank, each keeping its
    slice, so they are the tp=1 engine's draw: the tokens are equal."""
    from ray_tpu_torch._private.tree import tree_leaves

    _, _, tcfg, tp = weights
    full = tp if given else tl.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu")
    e2 = _engine(tcfg, tp if given else None, 2)
    try:
        specs = tl.inference_param_specs(tcfg)
        want = 0
        for key in ("embed", "final_norm", "lm_head", "layers"):
            if key not in full:
                continue
            subs = full[key] if key == "layers" else {key: full[key]}
            for name, t in subs.items():
                spec = (specs["layers"] if key == "layers" else specs)[name]
                got = (e2.params["layers"] if key == "layers"
                       else e2.params)[name]
                assert torch.equal(got, tmesh.shard_slice(t, spec, e2.mesh))
                want += t.nbytes // (2 if "tensor" in spec else 1)
        held = sum(t.untyped_storage().nbytes()
                   for t in tree_leaves(e2.params))
        assert held == want < sum(t.nbytes for t in tree_leaves(full))
        if not given:
            gen = GenerationConfig(max_new_tokens=8)
            assert e2.generate(PROMPTS, gen) == _engine(
                tcfg, None, 1).generate(PROMPTS, gen)
    finally:
        e2.shutdown()


@pytest.mark.timeout(240)
def test_ranks_stopped_before_their_weights_end_at_once(weights):
    """Ranks stopped before the hand-over (an engine whose construction
    failed) wait on their pipes, not in the group's loop: shutdown closes
    the pipes and they end without the group's timeout."""
    import time

    from ray_tpu_torch.llm import tp as ttp

    _, _, tcfg, _ = weights
    ranks = ttp.RankProcesses(
        LLMConfig(model_config=tcfg, tensor_parallel_size=2, **KW),
        torch.device("cpu"))
    t0 = time.monotonic()
    ranks.shutdown()
    assert not ranks.alive() and time.monotonic() - t0 < 20


def test_tp_overlap_collectives_false_is_refused(weights):
    """The reference's overlap switch drops a barrier with no numeric
    effect; the port orders its collectives on the stream, so False is
    refused rather than ignored."""
    _, _, tcfg, tp = weights
    with pytest.raises(NotImplementedError, match="tp_overlap_collectives"):
        _engine(tcfg, tp, 1, tp_overlap_collectives=False)


@pytest.mark.timeout(240)
def test_specdec_tp2_equals_tp1(weights):
    _, _, tcfg, tp = weights
    from ray_tpu_torch.llm.config import SpeculativeConfig

    dcfg = tl.LlamaConfig.tiny(n_kv_heads=2, n_layers=1)
    dparams = tl.init_params(dcfg, torch.Generator().manual_seed(8), "cpu")
    spec = SpeculativeConfig(draft_model_config=dcfg, num_speculative_tokens=3)
    gen = GenerationConfig(max_new_tokens=12)
    conf = LLMConfig(model_config=tcfg, speculative_config=spec, **KW)
    want = tpaged.PagedTorchLLMEngine(conf, params=tp, device="cpu",
                                      draft_params=dparams).generate(
        PROMPTS[:2], gen)
    e2 = tpaged.PagedTorchLLMEngine(
        dataclasses.replace(conf, tensor_parallel_size=2), params=tp,
        device="cpu", draft_params=dparams)
    try:
        assert e2._tp_collectives["verify"]["chosen"] == "flat"
        # the draft is replicated: whole on rank 0
        assert e2._draft_params["layers"]["wq"].shape == dparams["layers"]["wq"].shape
        assert e2.generate(PROMPTS[:2], gen) == want
        assert e2.spec_cycles > 0
    finally:
        e2.shutdown()


@pytest.mark.timeout(240)
def test_lora_merged_tp2_equals_tp1(weights):
    _, _, tcfg, tp = weights
    from ray_tpu_torch.llm import lora

    lcfg = lora.LoRAConfig(rank=4, alpha=32.0)
    adapter = lora.init_lora(tcfg, lcfg, torch.Generator().manual_seed(3))
    b = adapter["layers"]["wq"]["B"]
    adapter["layers"]["wq"]["B"] = torch.randn(
        b.shape, generator=torch.Generator().manual_seed(4)) * 0.5
    merged = lora.merge_lora(tp, adapter)
    gen = GenerationConfig(max_new_tokens=12)
    want = _engine(tcfg, merged, 1).generate(PROMPTS[:2], gen)
    e2 = _engine(tcfg, merged, 2)
    try:
        assert e2.generate(PROMPTS[:2], gen) == want
    finally:
        e2.shutdown()
    # the adapter's own specs: rank dims replicated, model dims as the
    # base's training layout (the reference's lora_param_specs)
    from ray_tpu.llm import lora as jlora

    jcfg = weights[0]
    want = jlora.lora_param_specs(jcfg, jlora.LoRAConfig(
        rank=4, alpha=32.0, targets=("wq", "wv", "wo")))
    got = lora.lora_param_specs(tcfg, lora.LoRAConfig(
        rank=4, alpha=32.0, targets=("wq", "wv", "wo")))
    assert got["config"] is None and set(got["layers"]) == set(want["layers"])
    for name, ab in want["layers"].items():
        assert {k: tuple(v) for k, v in ab.items()} == got["layers"][name]
    # a tensor-only mesh shards B of wq by its output dim, A of wo by its
    # input dim, and keeps the rest whole
    mesh = tmesh.Mesh({})
    assert tmesh.shard_slice(adapter["layers"]["wq"]["B"],
                             got["layers"]["wq"]["B"], mesh).shape == b.shape


def _handoff(src, dst, prompt, gen):
    rid = src.add_request(prompt, gen)
    for _ in range(2):
        src.step()
    ex = src.export_request(rid)
    # canonical payload: full width whatever the source's degree
    assert ex["k"].shape[-1] == src.cfg.n_kv_heads * src.cfg.head_dim
    res = dst.import_request(ex["prompt"], ex["first_token"], ex["k"],
                             ex["v"], gen=gen, emitted=ex["emitted"])
    assert res is not None
    toks = list(ex["emitted"])
    while dst.has_work():
        for r, t in dst.step().items():
            if r == res["request_id"]:
                toks.extend(t)
    return toks


@pytest.mark.timeout(240)
def test_handoff_tp2_to_tp1_and_back(weights, engines):
    _, _, tcfg, tp = weights
    e1, e2, _ = engines
    p = [3, 1, 4, 1, 5, 9, 2, 6]
    gen = GenerationConfig(max_new_tokens=48)
    solo = _engine(tcfg, tp, 1).generate([p], gen)[0]
    assert _handoff(e2, e1, p, gen) == solo  # tp=2 -> tp=1
    assert _handoff(e1, e2, p, gen) == solo  # tp=1 -> tp=2


@pytest.mark.timeout(240)
def test_the_prefix_tier_revives_into_a_sharded_pool(weights):
    """A tp=2 engine's host tier holds full-width blocks (gathered from
    both ranks) and revives them into both ranks' shards: tokens equal the
    tp=1 engine's and the tier's bytes match it."""
    _, _, tcfg, tp = weights
    kw = dict(max_batch_size=2, max_seq_len=128, block_size=8,
              prefill_chunk=16, decode_chunk=4, num_blocks=13)
    prompts = [[int(t) for t in np.random.RandomState(s).randint(1, 255, 33)]
               for s in range(1, 7)] + [[int(t) for t in np.random.RandomState(
                   1).randint(1, 255, 33)]]
    gen = GenerationConfig(max_new_tokens=4)
    e1 = _engine(tcfg, tp, 1, **kw)
    e2 = _engine(tcfg, tp, 2, **kw)
    try:
        for p in prompts:
            assert e2.generate([p], gen) == e1.generate([p], gen)
        assert e2.prefix_stats["host_hits"] == e1.prefix_stats["host_hits"] > 0
        assert e2._host_cache.hashes() == e1._host_cache.hashes()
        for h in e1._host_cache.hashes():
            for a, b in zip(e1._host_cache.get(h)[:2],
                            e2._host_cache.get(h)[:2]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    finally:
        e2.shutdown()


def test_build_engine_mesh_checks_the_degrees(weights):
    from ray_tpu_torch.llm.engine import build_engine_mesh, build_tp_mesh

    _, _, tcfg, _ = weights
    assert build_tp_mesh(tcfg, 1) is None
    with pytest.raises(ValueError, match="does not divide model n_heads"):
        build_tp_mesh(tcfg, 3)
    with pytest.raises(ValueError, match="degrees must agree"):
        build_tp_mesh(tcfg, 2, mesh=tmesh.Mesh({}))
    with pytest.raises(NotImplementedError, match="A11"):
        build_engine_mesh(tcfg, 1, 2)
    one = tmesh.Mesh({})
    assert build_tp_mesh(tcfg, 1, mesh=one) is one
    from ray_tpu_torch.llm import tp as ttp

    assert ttp.rank_devices(torch.device("cpu"), 2) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        ttp.rank_devices(torch.device("cuda"), 2)


@pytest.mark.timeout(240)
def test_llm_server_serves_tp2_and_stops_its_ranks(weights):
    """``LLMServer`` over ``tensor_parallel_size=2`` starts the engine's
    rank process itself, serves the tp=1 server's tokens from concurrent
    callers, and ``shutdown`` stops the rank."""
    import threading

    from ray_tpu_torch.llm.serve import LLMServer

    _, _, tcfg, tp = weights
    conf = LLMConfig(model_config=tcfg, **KW)
    one = LLMServer(conf, tp, device="cpu")
    try:
        want = [one.generate(p, max_new_tokens=10) for p in PROMPTS]
    finally:
        one.shutdown()
    two = LLMServer(dataclasses.replace(conf, tensor_parallel_size=2), tp,
                    device="cpu")
    ranks = two._engine._ranks
    try:
        assert ranks is not None and ranks.alive()
        got = [None] * len(PROMPTS)

        def call(i):
            got[i] = two.generate(PROMPTS[i], max_new_tokens=10)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert got == want
        assert two._engine.utilization()["tp"]["degree"] == 2
    finally:
        two.shutdown()
    assert not any(p.is_alive() for p in ranks.procs)


@pytest.mark.timeout(240)
def test_llm_server_tp2_merges_an_adapter_into_drawn_weights(weights):
    """A tp=2 ``LLMServer`` built without params keeps the full drawn base
    on the host, so an adapter's engine merges into the whole model: the
    adapter's tokens and the base's equal the tp=1 server's, and
    ``shutdown`` stops both engines' ranks."""
    from ray_tpu_torch.llm import lora
    from ray_tpu_torch.llm.serve import LLMServer

    _, _, tcfg, _ = weights
    adapter = lora.init_lora(tcfg, lora.LoRAConfig(rank=4, alpha=32.0),
                             torch.Generator().manual_seed(3))
    b = adapter["layers"]["wq"]["B"]
    adapter["layers"]["wq"]["B"] = torch.randn(
        b.shape, generator=torch.Generator().manual_seed(4)) * 0.5
    conf = LLMConfig(model_config=tcfg, **KW)

    def serve_both(server):
        try:
            return ([server.generate(p, max_new_tokens=8) for p in PROMPTS],
                    [server.generate(p, max_new_tokens=8, model="tuned")
                     for p in PROMPTS])
        finally:
            server.shutdown()

    want = serve_both(LLMServer(conf, lora_adapters={"tuned": adapter},
                                device="cpu"))
    assert want[0] != want[1]  # the adapter moves the tokens
    two = LLMServer(dataclasses.replace(conf, tensor_parallel_size=2),
                    lora_adapters={"tuned": adapter}, device="cpu")
    base = two._base_params["layers"]["wq"]
    assert base.device.type == "cpu"
    assert base.shape[-1] == 2 * two._engine.params["layers"]["wq"].shape[-1]
    engines = [two._engine]
    got = serve_both(two)
    engines += [e for m, e in two._engines.items() if m is not None]
    assert got == want
    assert len(engines) == 2
    assert not any(p.is_alive() for e in engines for p in e._ranks.procs)


@pytest.mark.timeout(240)
def test_a_tp2_deployment_serves_the_tp1_tokens(weights):
    """``serve.run(build_llm_deployment(...))`` at tensor_parallel_size=2:
    the replica's server starts its rank process inside the replica and
    answers through the handle with the tp=1 engine's tokens; tearing the
    deployment down ends the rank (it exits with its replica)."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_deployment

    _, _, tcfg, tp = weights
    conf = LLMConfig(model_config=tcfg, tensor_parallel_size=2, **KW)
    gen = GenerationConfig(max_new_tokens=8)
    want = _engine(tcfg, tp, 1).generate(PROMPTS, gen)
    assert conf.resources_per_replica(device="cpu") == {"CPU": 1.0}
    assert conf.resources_per_replica()["GPU"] == 2.0
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    rt.init(num_cpus=2)
    try:
        h = serve.run(build_llm_deployment(conf, tp, device="cpu"),
                      name="tp2", route_prefix="/tp2")
        got = [h.generate.remote(p, max_new_tokens=8).result(timeout_s=120)
               for p in PROMPTS]
        assert got == want
    finally:
        serve.shutdown()
        rt.shutdown()
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads
