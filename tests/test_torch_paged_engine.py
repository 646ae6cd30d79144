"""The port's paged engine against ``ray_tpu.llm.paged``.

- the host-side copies (BlockManager, prefix hashes, prefill planning) give
  the same sequences as the JAX package's originals;
- sampling's mask matches JAX's on the same logits;
- greedy tokens of ``PagedTorchLLMEngine(device="cpu")`` equal
  ``PagedJaxLLMEngine``'s exactly (same weights, fp32 tiny config) under
  chunked prefill, a prefix hit, preemption by recompute, and stop ids;
- ``warmup`` makes JAX's decode buckets and prefill widths, leaves engine
  state as it was, and changes no token; the per-width programs, run
  through a stand-in for CUDA graph capture and replay, give the direct
  call's tokens and book the paged kernel's launches per replay;
- construction refuses what this slice does not serve (a speculative
  config's per-adapter choice and the plasma prefix tier among it), serves
  the host-RAM tier at the JAX default, and ``make_engine`` builds the
  static engine for ``kv_cache="static"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import prefix_hash as jhash
from ray_tpu.llm import engine as jengine
from ray_tpu.llm import paged as jpaged
from ray_tpu.llm.config import GenerationConfig as JGen
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch._private import prefix_hash as thash
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import paged as tpaged
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tl.LlamaConfig.tiny()
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab - 1, n).tolist() for n in lens]


# -- host-side copies --------------------------------------------------------


def _bm_state(bm):
    return (list(bm.free_plain), list(bm.free_cached), list(bm.ref),
            dict(bm.hash_of), dict(bm.by_hash))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_same_sequences(seed):
    """A random script of alloc / register / release / match_prefix / adopt
    drives both BlockManagers; every return value, every demotion the
    ``on_evict`` hook sees and the whole state agree."""
    rng = np.random.default_rng(seed)
    evicted = [[], []]
    bms = [cls(24, 4, on_evict=lambda b, h, ev=ev: ev.append((b, h)))
           for cls, ev in zip((jpaged.BlockManager, tpaged.BlockManager),
                              evicted)]
    assert tpaged.BlockAllocator is tpaged.BlockManager
    base = rng.integers(0, 50, 40).tolist()
    prompts = [base[:n] + rng.integers(0, 50, 6).tolist()
               for n in (8, 12, 20, 33)]
    held = [[], []]  # per manager: lists of block ids it still owns
    for _ in range(80):
        op = rng.integers(0, 5)
        if op == 4:
            # a revival: one fresh block adopts a prompt's chain hash
            outs = [bm.alloc(1) for bm in bms]
            if outs[0] is not None:
                p = prompts[int(rng.integers(0, len(prompts)))]
                h = jhash.prefix_chain_hashes(p, 4)[
                    int(rng.integers(0, len(p) // 4))]
                for bm, o in zip(bms, outs):
                    bm.adopt(o[0], h)
        elif op == 0:
            n = int(rng.integers(1, 7))
            outs = [bm.alloc(n) for bm in bms]
        elif op == 1 and held[0]:
            i = int(rng.integers(0, len(held[0])))
            for bm, h in zip(bms, held):
                bm.release(h.pop(i))
            outs = [None, None]
        elif op == 2:
            p = prompts[int(rng.integers(0, len(prompts)))]
            outs = [bm.match_prefix(p) for bm in bms]
            outs = [o[0] or None for o in outs]
        else:
            p = prompts[int(rng.integers(0, len(prompts)))]
            outs = [bm.alloc(len(p) // 4) for bm in bms]
            if outs[0] is not None:
                for bm, o in zip(bms, outs):
                    bm.register(p, o)
        assert outs[0] == outs[1]
        if outs[0]:
            for h, o in zip(held, outs):
                h.append(list(o))
        assert _bm_state(bms[0]) == _bm_state(bms[1])
        assert evicted[0] == evicted[1]


def test_prefix_hashes_equal():
    rng = np.random.default_rng(5)
    held = set()
    for n in (1, 2, 15, 16, 17, 64, 129):
        p = rng.integers(0, 128256, n).tolist()
        for bs in (4, 16):
            want = jhash.prefix_chain_hashes(p, bs)
            assert thash.prefix_chain_hashes(p, bs) == want
            assert thash.prefix_chain_hashes(p, bs, limit=2) == want[:2]
            held.update(want[:1])
            assert (thash.longest_chain_match(want, held)
                    == jhash.longest_chain_match(want, held))
        assert thash.chain_hash(None, p) == jhash.chain_hash(None, p)
        data = np.asarray(p, np.int32)
        assert (thash.content_hash(data, extra=b"x")
                == jhash.content_hash(data, extra=b"x"))


@pytest.mark.parametrize("chunk,bs", [(16, 8), (256, 16), (64, 4)])
def test_prefill_planning_equal(chunk, bs):
    for plen in range(1, 3 * chunk + 7):
        for matched in range(0, plen, bs):
            assert (tpaged._prefill_plan(plen, matched, chunk, bs)
                    == jpaged._prefill_plan(plen, matched, chunk, bs))
        assert (tpaged._prefill_cover_worst(plen, chunk, bs)
                == jpaged._prefill_cover_worst(plen, chunk, bs))
    for max_seq in (chunk, 3 * chunk + 1, 992):
        assert (tpaged._prefill_table_width(max_seq, chunk, bs)
                == jpaged._prefill_table_width(max_seq, chunk, bs))


# -- sampling ----------------------------------------------------------------


@pytest.mark.parametrize("temps,top_ks", [
    ([0.0, 0.0, 0.0], [0, 0, 0]),
    ([0.7, 1.0, 2.5], [0, 5, 64]),
    ([0.0, 0.8, 1.3], [40, 1, 0]),
])
def test_masked_scaled_matches_jax(temps, top_ks):
    logits = np.random.default_rng(3).standard_normal((3, 300)).astype(
        np.float32) * 4
    want = np.asarray(jengine._masked_scaled(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_ks, jnp.int32)))
    got = tengine._masked_scaled(
        torch.from_numpy(logits), torch.tensor(temps, dtype=torch.float32),
        torch.tensor(top_ks, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sample_greedy_exact_and_top_k_support():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 200)).astype(np.float32))
    logits[0, 7] = logits[0, 9] = logits[0].max() + 1  # a tie: first index
    temps = torch.tensor([0.0, 1.0, 1.0, 0.0])
    top_ks = torch.tensor([0, 3, 1, 5], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        ids = tengine._sample(logits, gen, temps, top_ks)
        assert ids.dtype == torch.int32
        assert ids[0] == 7 and ids[3] == int(logits[3].argmax())
        assert int(ids[1]) in logits[1].topk(3).indices.tolist()
        assert ids[2] == int(logits[2].argmax())  # top-1 sampling


# -- engine parity -----------------------------------------------------------


def _engines(weights, **kw):
    jcfg, jp, tcfg, tp = weights
    je = jpaged.PagedJaxLLMEngine(
        JLLMConfig(model_config=jcfg, host_kv_cache_bytes=0, **kw), params=jp)
    te = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **kw),
                                    params=tp, device="cpu")
    return je, te


def _count_preemptions(eng):
    eng.preemptions = 0
    orig = eng._preempt_locked

    def spy(exclude_slot=-1):
        hit = orig(exclude_slot)
        eng.preemptions += int(hit)
        return hit

    eng._preempt_locked = spy


_SCENARIOS = {
    # mixed prompt lengths, several past prefill_chunk, more than the slots
    "chunked_prefill": dict(
        lens=(5, 40, 23, 17, 70), max_new=10,
        kw=dict(max_batch_size=3, max_seq_len=96, block_size=8,
                prefill_chunk=16, decode_chunk=4)),
    # request 3 repeats request 0's first 32 tokens, admitted after it
    "prefix_hit": dict(
        lens=(40, 12, 18, 36), max_new=8, share=(0, 3, 32),
        kw=dict(max_batch_size=2, max_seq_len=96, block_size=8,
                prefill_chunk=16, decode_chunk=4)),
    # a pool too small for three 56-token sequences: recompute preemption
    "preemption": dict(
        lens=(16, 16, 16), max_new=40,
        kw=dict(max_batch_size=4, max_seq_len=128, block_size=8,
                prefill_chunk=16, num_blocks=14, decode_chunk=4,
                enable_prefix_caching=False)),
    # stop ids: one taken from a free run's stream, and a second one
    "stop_ids": dict(
        lens=(9, 30, 14), max_new=16, stops=True,
        kw=dict(max_batch_size=3, max_seq_len=64, block_size=8,
                prefill_chunk=16, decode_chunk=4)),
}


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_greedy_tokens_equal_jax_engine(weights, name):
    sc = _SCENARIOS[name]
    prompts = _prompts(7, sc["lens"])
    if "share" in sc:
        src, dst, n = sc["share"]
        prompts[dst] = prompts[src][:n] + prompts[dst][n:]
    je, te = _engines(weights, **sc["kw"])
    stops = ()
    if sc.get("stops"):
        free = tpaged.PagedTorchLLMEngine(
            LLMConfig(model_config=weights[2], **sc["kw"]),
            params=weights[3], device="cpu").generate(
                prompts, GenerationConfig(max_new_tokens=sc["max_new"]))
        stops = (free[1][5], 255)
    _count_preemptions(je)
    _count_preemptions(te)
    want = je.generate(prompts, JGen(max_new_tokens=sc["max_new"],
                                     stop_token_ids=stops))
    got = te.generate(prompts, GenerationConfig(max_new_tokens=sc["max_new"],
                                                stop_token_ids=stops))
    assert got == want
    assert te.preemptions == je.preemptions
    if name == "preemption":
        assert te.preemptions > 0
        assert all(len(o) == sc["max_new"] for o in got)
    if name == "prefix_hit":
        assert te.prefill_tokens < sum(len(p) for p in prompts)
    if stops:
        assert got[1] == free[1][:free[1].index(stops[0]) + 1]
    assert not te.has_work()
    assert not any(te.blocks.ref)  # every block returned


# -- construction rules ------------------------------------------------------


def test_default_device_is_cuda_and_never_falls_back(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLMConfig(model_config=weights[2], max_seq_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpaged.PagedTorchLLMEngine(cfg, params=weights[3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.make_engine(cfg, params=weights[3])


def test_kernel_switch_on_cpu(weights):
    kw = dict(model_config=weights[2], max_seq_len=64)
    with pytest.raises(ValueError, match="paged_attention_kernel=True"):
        tpaged.PagedTorchLLMEngine(
            LLMConfig(paged_attention_kernel=True, **kw), params=weights[3],
            device="cpu")
    with pytest.raises(ValueError, match="interpret mode"):
        tpaged.PagedTorchLLMEngine(
            LLMConfig(paged_attention_kernel="interpret", **kw),
            params=weights[3], device="cpu")
    for want in (None, False):
        eng = tengine.make_engine(LLMConfig(paged_attention_kernel=want, **kw),
                                  params=weights[3], device="cpu")
        assert eng._use_kernel is False


@pytest.mark.parametrize("field,value", [
    # speculation is served; its per-adapter choice belongs to LLMServer
    ("speculative_config", SpeculativeConfig(
        draft_model_config=tl.LlamaConfig.tiny(),
        per_adapter={"tuned": {"num_speculative_tokens": 2}})),
    ("tensor_parallel_size", 2),
    ("pipeline_parallel_size", 2),
    ("data_parallel_size", 2),
    ("mesh", object()),
    ("plasma_kv_cache_blocks", 4),
])
def test_unported_config_values_raise(weights, field, value):
    cfg = dataclasses.replace(
        LLMConfig(model_config=weights[2], max_seq_len=64), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tengine.make_engine(cfg, params=weights[3], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpaged.PagedTorchLLMEngine(cfg, params=weights[3], device="cpu")


def test_host_tier_is_served_at_the_jax_default_and_plasma_names_a16(weights):
    assert LLMConfig().host_kv_cache_bytes == JLLMConfig().host_kv_cache_bytes
    assert LLMConfig().host_kv_cache_bytes == 64 * 2**20
    eng = tpaged.PagedTorchLLMEngine(
        LLMConfig(model_config=weights[2], max_seq_len=64), params=weights[3],
        device="cpu")
    assert eng._host_cache is not None and eng.blocks.on_evict is not None
    off = tpaged.PagedTorchLLMEngine(
        LLMConfig(model_config=weights[2], max_seq_len=64,
                  host_kv_cache_bytes=0), params=weights[3], device="cpu")
    assert off._host_cache is None and off.blocks.on_evict is None
    cfg = LLMConfig(model_config=weights[2], max_seq_len=64,
                    plasma_kv_cache_blocks=4)
    with pytest.raises(NotImplementedError, match="A16"):
        tpaged.PagedTorchLLMEngine(cfg, params=weights[3], device="cpu")


def test_make_engine_builds_the_static_engine(weights):
    cfg = LLMConfig(model_config=weights[2], max_seq_len=64, kv_cache="static")
    eng = tengine.make_engine(cfg, params=weights[3], device="cpu")
    assert isinstance(eng, tengine.TorchLLMEngine)
    assert tuple(eng.cache["k"].shape) == (2, 8, 64, 2, 32)
    assert len(eng.generate([[1, 2, 3]], GenerationConfig(max_new_tokens=4))[0]) == 4


@pytest.mark.parametrize("want", [None, True])
def test_kernel_switch_on_cuda_raises_where_the_kernel_cannot_run(want):
    # the decision only: no engine, so no card is needed
    bf16 = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    cfg = tl.LlamaConfig.llama3_8b(**bf16)
    assert tl.paged_kernel_supported(cfg, "cuda")
    assert not tl.paged_kernel_supported(cfg, "cpu")
    assert tpaged._use_paged_kernel(want, cfg, "cuda", torch.bfloat16)
    assert not tpaged._use_paged_kernel(False, cfg, "cuda", torch.float32)
    for bad, pool, why in ((cfg, torch.float32, "bf16 KV pool"),
                           (tl.LlamaConfig.tiny(**bf16), torch.bfloat16,
                            "head_dim 32"),
                           (tl.LlamaConfig.llama3_8b(n_kv_heads=2, **bf16),
                            torch.bfloat16, "over 2 kv heads")):
        with pytest.raises(ValueError, match=f"kernel={want}: .*{why}"):
            tpaged._use_paged_kernel(want, bad, "cuda", pool)


@pytest.mark.parametrize("want", [None, True])
def test_kernel_switch_on_cuda_refuses_a_block_size_the_kernel_cannot_take(want):
    bf16 = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    cfg = tl.LlamaConfig.llama3_8b(**bf16)
    for bs in (8, 16, 64, 128):
        assert tpaged._use_paged_kernel(want, cfg, "cuda", torch.bfloat16, bs)
    with pytest.raises(ValueError, match=f"kernel={want}: .*block size 24"):
        tpaged._use_paged_kernel(want, cfg, "cuda", torch.bfloat16, 24)
    assert not tpaged._use_paged_kernel(False, cfg, "cuda", torch.bfloat16, 24)


# -- warmup and the per-width programs ---------------------------------------

_WARM_KW = _SCENARIOS["chunked_prefill"]["kw"]


def _engine_state(eng):
    """Everything warmup must leave as it was (the pool's sink block 0
    aside)."""
    reqs = [None if r is None else (r.request_id, list(r.blocks),
                                    r.prefill_pos, list(r.out_tokens))
            for r in eng._slot_req]
    host = [a.copy() for a in (eng._lengths, eng._next_tok, eng._slot_temp,
                               eng._slot_topk)]
    dev = [getattr(eng._state, f).clone() for f in (
        "tokens", "lengths", "active", "remaining", "stops", "temps",
        "top_ks")]
    pool = [eng.pool[k][:, 1:].clone() for k in ("k", "v")]
    return (_bm_state(eng.blocks), reqs, host, dev, pool,
            eng._gen.get_state(), eng._inflight, eng._dirty,
            [r.request_id for r in eng._pending])


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_warmup_leaves_engine_state_unchanged(weights):
    """Warm mid-serving (a chunk in flight, one slot mid-prefill, one
    request queued): nothing but sink block 0 changes, and serving goes on
    to JAX's tokens."""
    prompts = _prompts(7, _SCENARIOS["chunked_prefill"]["lens"])
    je, te = _engines(weights, **_WARM_KW)
    want = je.generate(prompts, JGen(max_new_tokens=10))
    ids = [te.add_request(p, GenerationConfig(max_new_tokens=10))
           for p in prompts]
    got = {i: [] for i in ids}

    def busy():
        return (te._inflight is not None and te._pending
                and any(r is not None and not te._decode_ready(r)
                        for r in te._slot_req))

    for _ in range(30):
        for rid, toks in te.step().items():
            got[rid].extend(toks)
        if busy():
            break
    assert busy()
    before = _engine_state(te)
    te.warmup()
    assert _same(_engine_state(te), before)
    while te.has_work():
        for rid, toks in te.step().items():
            got[rid].extend(toks)
    assert [got[i] for i in ids] == want


def test_warmed_engine_tokens_equal_unwarmed_and_jax(weights):
    sc = _SCENARIOS["stop_ids"]
    prompts = _prompts(7, sc["lens"])
    je, te = _engines(weights, **sc["kw"])
    cold = tpaged.PagedTorchLLMEngine(
        LLMConfig(model_config=weights[2], **sc["kw"]), params=weights[3],
        device="cpu")
    te.warmup(max_len=40)
    gen = dict(max_new_tokens=sc["max_new"], stop_token_ids=(17,))
    got = te.generate(prompts, GenerationConfig(**gen))
    assert got == cold.generate(prompts, GenerationConfig(**gen))
    assert got == je.generate(prompts, JGen(**gen))


@pytest.mark.parametrize("max_len", [None, 20])
def test_warmup_buckets_follow_jax(weights, max_len):
    """The decode table widths and prefill chunk widths warmup runs are the
    JAX engine's (its programs spied on during its own warmup)."""
    je, te = _engines(weights, **_WARM_KW)
    seen = {"decode": [], "prefill": []}
    jdec, jpre = je._decode, je._prefill_chunk

    def spy_decode(*a):
        seen["decode"].append(a[3].shape[1])
        return jdec(*a)

    def spy_prefill(*a):
        seen["prefill"].append(a[1].shape[1])
        return jpre(*a)

    je._decode, je._prefill_chunk = spy_decode, spy_prefill
    je.warmup(max_len=max_len)
    widths = []
    tpre = te._prefill_chunk_impl

    def spy_tprefill(tokens, *a):
        widths.append(tokens.shape[1])
        return tpre(tokens, *a)

    te._prefill_chunk_impl = spy_tprefill
    te.warmup(max_len=max_len)
    assert sorted(te._programs.by_width) == seen["decode"]
    assert widths == seen["prefill"]
    assert sorted(te._programs.by_width)[-1] == (16 if max_len is None else 4)


class _StubGraph:
    """A stand-in for a CUDA graph on the CPU.  "Capture" runs the chunk's
    Python with the stream marked as capturing, then restores every tensor
    it wrote, since a real capture launches nothing; "replay" runs it for
    real with kernel counting off, since a real replay runs no Python."""

    replaying = False

    def __init__(self, fn, tensors, generator, monkeypatch):
        saved = [t.clone() for t in tensors]
        gstate = generator.get_state()
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        try:
            fn()
        finally:
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                                lambda: False)
        for t, s in zip(tensors, saved):
            t.copy_(s)
        generator.set_state(gstate)
        self.fn = fn
        self.replays = 0

    def replay(self):
        _StubGraph.replaying = True
        try:
            self.fn()
        finally:
            _StubGraph.replaying = False
        self.replays += 1


def _counting_kernel(q, pk, pv, li, table, lengths):
    """The paged kernel's plain version, counted as the wrapper counts a
    launch (never during a replay)."""
    if not _StubGraph.replaying:
        pa._count_launch()
    return pa.paged_decode_attention_reference(q, pk, pv, li, table, lengths)


def test_captured_programs_give_the_direct_tokens_and_count_launches(
        weights, monkeypatch):
    """An engine whose decode chunks are "captured" per table width (and
    its prefill per chunk width) and "replayed" gives the tokens of the
    engine that calls the programs directly; a capture books its kernel
    calls as captured, not launched, and every replay books that many
    launches (prefill attends by the table gather: none)."""
    monkeypatch.setattr(tl, "paged_decode_attention", _counting_kernel)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    sc = _SCENARIOS["preemption"]
    prompts = _prompts(7, sc["lens"])
    gen = GenerationConfig(max_new_tokens=sc["max_new"])
    cfg = LLMConfig(model_config=weights[2], **sc["kw"])
    direct = tpaged.PagedTorchLLMEngine(cfg, params=weights[3], device="cpu")
    direct._use_kernel = True
    want = direct.generate(prompts, gen)

    eng = tpaged.PagedTorchLLMEngine(cfg, params=weights[3], device="cpu",
                                     _graphs=True)
    eng._use_kernel = True
    graphs = []

    def capture(fn, pool, stream, generator):
        st = eng._state
        tensors = [eng.pool["k"], eng.pool["v"], st.tokens, st.lengths,
                   st.active, st.remaining]
        tensors += [p.emitted for p in eng._programs.by_width.values()]
        tensors += [p.emitted for p in eng._prefill_programs.by_width.values()]
        graphs.append(_StubGraph(fn, tensors, generator, monkeypatch))
        return graphs[-1]

    monkeypatch.setattr(tengine, "_capture_graph", capture)
    n_layers, chunk = weights[2].n_layers, sc["kw"]["decode_chunk"]
    monkeypatch.setattr(pa, "launches", 0)
    monkeypatch.setattr(pa, "captured_launches", 0)
    eng.warmup()
    widths = sorted(eng._programs.by_width)
    assert sorted(eng._prefill_programs.by_width) == [8, 16]
    assert len(graphs) == len(widths) + 2 and len(widths) == 5
    assert pa.captured_launches == n_layers * chunk * len(widths)
    # each width's warm-up run before its capture launches for real
    assert pa.launches == n_layers * chunk * len(widths)
    pa.launches = 0
    got = eng.generate(prompts, gen)
    assert got == want
    assert all(p.kernel_launches == n_layers * chunk
               for p in eng._programs.by_width.values())
    replays = sum(g.replays for g in graphs[:len(widths)])
    assert replays * chunk == eng.decode_steps > 0
    assert sum(g.replays for g in graphs[len(widths):]) > 0
    assert pa.launches == n_layers * eng.decode_steps
