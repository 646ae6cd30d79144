"""The port's tiered prefix cache, prefix digest, utilization and prefill
programs against ``ray_tpu.llm.paged``.

- ``HostBlockCache`` (the host-RAM tier) and the ``BlockManager`` eviction
  hook give the JAX package's results on the same operation sequences
  (tests/test_prefix_cache.py's cases, and random scripts);
- under pool pressure the engine demotes cached prompt blocks to the host
  tier and revives them: greedy tokens equal ``PagedJaxLLMEngine``'s
  exactly (same weights, fp32 tiny config), the (pool hits, misses,
  revivals) counts equal the ones the JAX engine books, the host tier
  holds the same chain hashes with the same KV (within 1e-5: fp32 programs
  of two frameworks), and every revived pool block holds exactly the
  bytes that were demoted;
- ``prefix_digest`` and ``utilization``'s bookkeeping equal JAX's;
- ``prefill_chunk_paged`` with p0 a device tensor gives the int form's
  logits and pool exactly, and JAX's within 1e-5, at two p0; the engine's
  prefill program, driven through its own input buffers at two p0, gives
  the direct call's results.

Every test that runs a JAX engine carries a 240 s watchdog, as
tests/test_torch_specdec.py's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import runtime_metrics as jrm
from ray_tpu._private.prefix_hash import prefix_chain_hashes
from ray_tpu.llm import paged as jpaged
from ray_tpu.llm.config import GenerationConfig as JGen
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm import paged as tpaged
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tl.LlamaConfig.tiny()
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 255, n)]


# -- host-side copies --------------------------------------------------------


def _block(fill, nbytes=64):
    n = nbytes // 8
    return (np.full((1, n), fill, np.float32), np.full((1, n), -fill, np.float32))


def _cache_script(name):
    """(capacity bytes, [("put", h, fill) | ("get", h)]): the cases of
    tests/test_prefix_cache.py, a re-put, and random scripts."""
    if name == "lru_byte_cap":
        ops = [("put", 100 + i, i) for i in range(5)]
        ops += [("get", 100), ("get", 101), ("get", 104), ("get", 102),
                ("put", 200, 9), ("get", 103), ("get", 102)]
        return 3 * 64, ops
    if name == "zero_capacity":
        return 0, [("put", 1, 1), ("get", 1)]
    if name == "hashes_for_digest":
        return 10 * 64, [("put", i, i) for i in range(3)]
    if name == "re_put_refreshes":
        return 2 * 64, [("put", 1, 1), ("put", 2, 2), ("put", 1, 5),
                        ("put", 3, 3), ("get", 1), ("get", 2)]
    rng = np.random.default_rng(int(name[-1]))
    ops = []
    for _ in range(60):
        h = int(rng.integers(0, 12))
        ops.append(("put", h, h) if rng.random() < 0.5 else ("get", h))
    return 5 * 64, ops


@pytest.mark.parametrize("name", ["lru_byte_cap", "zero_capacity",
                                  "hashes_for_digest", "re_put_refreshes",
                                  "random_0", "random_1"])
def test_host_block_cache_same_as_jax(name):
    cap, ops = _cache_script(name)
    jc, tc = jpaged.HostBlockCache(cap), tpaged.HostBlockCache(cap)
    for op in ops:
        if op[0] == "put":
            for c in (jc, tc):
                c.put(op[1], *_block(op[2]))
            continue
        got = [c.get(op[1]) for c in (jc, tc)]
        assert (got[0] is None) == (got[1] is None), op
        if got[0] is not None:
            assert got[0][2] == got[1][2] == "host"
            for a, b in zip(got[0][:2], got[1][:2]):
                np.testing.assert_array_equal(a, b)
        assert jc.hashes() == tc.hashes()
        assert len(jc) == len(tc) and jc.nbytes == tc.nbytes
    assert jc.hashes() == tc.hashes() and jc.nbytes == tc.nbytes


@pytest.mark.parametrize("case", ["cached_pair_repurposed", "plain_only"])
def test_on_evict_fires_as_jax_does(case):
    """tests/test_prefix_cache.py's two hook cases on both managers: the
    hook sees each repurposed cached (block, hash) once, and never a plain
    block; a revival's ``adopt`` registers the link both ways."""
    seen = [[], []]
    bms = [cls(num_blocks=5 if case == "cached_pair_repurposed" else 8,
               block_size=4, on_evict=lambda b, h, s=s: s.append((b, h)))
           for cls, s in zip((jpaged.BlockAllocator, tpaged.BlockAllocator),
                             seen)]
    prompt = list(range(30, 38))
    for bm in bms:
        blocks = bm.alloc(2 if case == "cached_pair_repurposed" else 3)
        if case == "cached_pair_repurposed":
            bm.register(prompt, blocks)
        bm.release(blocks)
        bm.alloc(4 if case == "cached_pair_repurposed" else 5)
        assert bm.by_hash == {} and bm.hash_of == {}
        b = bm.alloc(1)
        h = prefix_chain_hashes(prompt, 4)[0]
        if b is not None:
            bm.adopt(b[0], h)
            assert bm.by_hash == {h: b[0]} and bm.hash_of == {b[0]: h}
    assert seen[0] == seen[1]
    assert len(seen[0]) == (2 if case == "cached_pair_repurposed" else 0)
    assert (bms[0].by_hash, bms[0].hash_of) == (bms[1].by_hash, bms[1].hash_of)


# -- the engine's tier -------------------------------------------------------

# tests/test_llm_disagg.py's tier geometry: a 12-block pool that five
# 33-token prompts churn, so cached prompt blocks demote
_TIER_KW = dict(max_batch_size=2, max_seq_len=128, block_size=8,
                prefill_chunk=16, decode_chunk=4, num_blocks=13)
# per scenario: the prompts of each generate call, in order
_TIER_SCENARIOS = {
    # one prompt, five others one by one, then the first again
    "sequential": [[_prompt(1, 33)]] + [[_prompt(s, 33)] for s in range(2, 7)]
                  + [[_prompt(1, 33)]],
    # two at a time (both slots busy when demotions fire), then two
    # prompts reviving the first batch's chains, one of them extended
    "concurrent": [[_prompt(1, 33), _prompt(2, 25)],
                   [_prompt(3, 33), _prompt(4, 40)],
                   [_prompt(5, 41), _prompt(6, 17)],
                   [_prompt(1, 33) + [7, 9], _prompt(2, 25)]],
}


def _jax_prefix_counts():
    snap = jrm.prefix_cache_snapshot()
    return (snap["hits"].get("hbm", 0.0), snap["hits"].get("host", 0.0),
            snap["misses"])


def _watch_uploads(eng):
    """Record (block, k, v) of every host-tier upload the engine makes."""
    eng.uploads = []
    orig = eng._upload_block

    def spy(block, k, v):
        eng.uploads.append((block, k, v))
        return orig(block, k, v)

    eng._upload_block = spy


@pytest.mark.timeout(240)
@pytest.mark.parametrize("name", list(_TIER_SCENARIOS))
def test_tier_revival_matches_jax_engine(weights, name):
    jcfg, jp, tcfg, tp = weights
    je = jpaged.PagedJaxLLMEngine(JLLMConfig(model_config=jcfg, **_TIER_KW),
                                  params=jp)
    te = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **_TIER_KW),
                                    params=tp, device="cpu")
    assert te._host_cache is not None
    _watch_uploads(te)
    j0 = _jax_prefix_counts()
    for prompts in _TIER_SCENARIOS[name]:
        want = je.generate(prompts, JGen(max_new_tokens=4))
        got = te.generate(prompts, GenerationConfig(max_new_tokens=4))
        assert got == want
    j1 = _jax_prefix_counts()
    st = te.prefix_stats
    assert (st["hbm_hits"], st["host_hits"], st["misses"]) == tuple(
        int(b - a) for a, b in zip(j0, j1))
    assert st["host_hits"] > 0 and st["demoted"] > 0
    assert st["uploaded"] == st["host_hits"] == len(te.uploads)
    # the tier holds JAX's chains with JAX's KV
    assert te._host_cache.hashes() == je._host_cache.hashes()
    assert te._host_cache.nbytes == je._host_cache.nbytes
    for h in je._host_cache.hashes():
        jk, jv, _ = je._host_cache.get(h)
        tk, tv, _ = te._host_cache.get(h)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)
    # each revived pool block holds exactly the demoted bytes (the block
    # may have been recycled since: check those still registered)
    checked = 0
    for block, k, v in te.uploads:
        if block in te.blocks.hash_of:
            assert torch.equal(te.pool["k"][:, block], k)
            assert torch.equal(te.pool["v"][:, block], v)
            checked += 1
    assert checked > 0
    assert not te.has_work() and not any(te.blocks.ref)


@pytest.mark.timeout(240)
def test_revived_blocks_equal_the_demoted_ones(weights):
    """The bytes a demotion copies out are the pool block's, and a revival
    writes them back unchanged: pool block -> host tier -> another pool
    block, bit for bit."""
    _, _, tcfg, tp = weights
    te = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **_TIER_KW),
                                    params=tp, device="cpu")
    demoted = {}
    orig = te._demote_block

    def spy(block, h):
        demoted[h] = (te.pool["k"][:, block].clone(),
                      te.pool["v"][:, block].clone())
        return orig(block, h)

    te._demote_block = spy
    te.blocks.on_evict = spy
    _watch_uploads(te)
    for prompts in _TIER_SCENARIOS["sequential"][:-1]:
        te.generate(prompts, GenerationConfig(max_new_tokens=4))
    assert demoted
    for h, (k, v) in demoted.items():
        got = te._host_cache.get(h)
        if got is not None:
            assert torch.equal(got[0], k) and torch.equal(got[1], v)
    # revive: the last prompt's chain comes back from the tier
    rid = te.add_request(_TIER_SCENARIOS["sequential"][-1][0],
                         GenerationConfig(max_new_tokens=4))
    te.step(decode=False)
    assert te.uploads
    chain = prefix_chain_hashes(_TIER_SCENARIOS["sequential"][-1][0], 8)
    for block, k, v in te.uploads:
        h = te.blocks.hash_of[block]
        assert h in chain and h in demoted
        assert torch.equal(te.pool["k"][:, block], demoted[h][0])
        assert torch.equal(te.pool["v"][:, block], demoted[h][1])
    while te.has_work():
        te.step()
    assert rid not in te._requests


@pytest.mark.timeout(240)
def test_tier_off_and_caching_off_match_jax(weights):
    """host_kv_cache_bytes=0 keeps no tier and demotes nothing; prefix
    caching off books nothing; tokens equal JAX's either way."""
    jcfg, jp, tcfg, tp = weights
    prompts = [p for batch in _TIER_SCENARIOS["sequential"] for p in batch]
    for kw in (dict(host_kv_cache_bytes=0), dict(enable_prefix_caching=False)):
        je = jpaged.PagedJaxLLMEngine(
            JLLMConfig(model_config=jcfg, **_TIER_KW, **kw), params=jp)
        te = tpaged.PagedTorchLLMEngine(
            LLMConfig(model_config=tcfg, **_TIER_KW, **kw), params=tp,
            device="cpu")
        assert te._host_cache is None and je._host_cache is None
        got = te.generate(prompts, GenerationConfig(max_new_tokens=4))
        assert got == je.generate(prompts, JGen(max_new_tokens=4))
        assert te.prefix_stats["demoted"] == te.prefix_stats["host_hits"] == 0
        if "enable_prefix_caching" in kw:
            assert te.prefix_stats["hbm_hits"] == te.prefix_stats["misses"] == 0
            assert te.prefix_digest() == je.prefix_digest() == {
                "block_size": 8, "hashes": []}


# -- digest and utilization --------------------------------------------------


@pytest.mark.timeout(240)
def test_prefix_digest_and_utilization_equal_jax(weights):
    """Step both engines in lockstep through a tier scenario: after every
    step the digest (host-tier hashes first, newest last; capped) and
    utilization's slots, blocks and queue agree."""
    jcfg, jp, tcfg, tp = weights
    je = jpaged.PagedJaxLLMEngine(JLLMConfig(model_config=jcfg, **_TIER_KW),
                                  params=jp)
    te = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **_TIER_KW),
                                    params=tp, device="cpu")
    keys = ("slots", "kv_blocks", "pending")
    checks = 0
    for prompts in _TIER_SCENARIOS["concurrent"] * 2:
        for p in prompts + prompts[:1]:
            je.add_request(p, JGen(max_new_tokens=6))
            te.add_request(p, GenerationConfig(max_new_tokens=6))
        ju, tu = je.utilization(), te.utilization()
        assert tu["engine"] == ju["engine"] == "paged"
        assert {k: tu[k] for k in keys} == {k: ju[k] for k in keys}
        while je.has_work() or te.has_work():
            assert je.step() == te.step()
            ju, tu = je.utilization(), te.utilization()
            assert {k: tu[k] for k in keys} == {k: ju[k] for k in keys}
            assert te.prefix_digest() == je.prefix_digest()
            assert (te.prefix_digest(max_hashes=3)
                    == je.prefix_digest(max_hashes=3))
            checks += 1
    digest = te.prefix_digest()
    assert digest["block_size"] == 8 and len(digest["hashes"]) > 3
    # the host tier's chains (those not back in the pool) come first
    host = [h for h in te._host_cache.hashes() if h not in te.blocks.by_hash]
    assert host and digest["hashes"][:len(host)] == host
    assert checks > 10


# -- prefill with p0 on the device -------------------------------------------


def _pool(cfg, nb, bs, seed):
    rng = np.random.default_rng(seed)
    kvd = cfg.n_kv_heads * cfg.head_dim
    return rng.standard_normal((2, cfg.n_layers, nb, bs, kvd)).astype(
        np.float32)


@pytest.mark.parametrize("p0", [0, 16])
def test_prefill_chunk_paged_tensor_p0_matches_int_and_jax(weights, p0):
    jcfg, jp, tcfg, tp = weights
    bs, nb, w, c = 8, 12, 6, 16
    pool_np = _pool(tcfg, nb, bs, 1)
    table = np.array([[3, 7, 1, 9, 4, 11]], np.int32)
    tokens = np.random.default_rng(2).integers(1, 255, (1, c)).astype(np.int32)
    rope = tl.rope_cache(tcfg, 64, "cpu")
    pools = [{"k": torch.from_numpy(pool_np[0].copy()),
              "v": torch.from_numpy(pool_np[1].copy())} for _ in range(2)]
    out = [tl.prefill_chunk_paged(tcfg, tp, torch.from_numpy(tokens), pool,
                                  torch.from_numpy(table), p, rope)[0]
           for pool, p in zip(pools, (p0, torch.tensor([p0], dtype=torch.int32)))]
    assert torch.equal(out[0], out[1])
    for name in ("k", "v"):
        assert torch.equal(pools[0][name], pools[1][name])
    jrope = tuple(jnp.asarray(x) for x in jl.rope_frequencies(
        jcfg.head_dim, 64, jcfg.rope_theta))
    jlog, jpool = jl.prefill_chunk_paged(
        jcfg, jp, jnp.asarray(tokens),
        {"k": jnp.asarray(pool_np[0]), "v": jnp.asarray(pool_np[1])},
        jnp.asarray(table), jnp.int32(p0), rope_cache=jrope)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(pools[1][name].numpy(),
                                   np.asarray(jpool[name]), rtol=1e-5,
                                   atol=1e-5)


def test_prefill_chunk_host_checks_keep_their_messages(weights):
    _, _, tcfg, tp = weights
    pool = {n: torch.zeros((2, 4, 8, 64)) for n in ("k", "v")}
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="not block-aligned"):
        tl.prefill_chunk_paged(tcfg, tp, tokens, pool,
                               torch.zeros((1, 4), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="does not cover blocks"):
        tl.prefill_chunk_paged(tcfg, tp, tokens, pool,
                               torch.zeros((1, 4), dtype=torch.int32), 24)
    with pytest.raises(ValueError, match="does not cover blocks"):
        tl.check_prefill_chunk(24, 16, 8, 4)
    tl.check_prefill_chunk(16, 16, 8, 4)


def test_prefill_program_buffers_read_p0_at_every_run(weights):
    """The engine's prefill program at one width, fed through its own
    input buffers at p0 = 0 and then p0 = 16 (what a prefix hit gives),
    writes the pool and samples as the direct call with each p0 does:
    nothing of the first run's p0 stays behind."""
    _, _, tcfg, tp = weights
    kw = dict(max_batch_size=2, max_seq_len=64, block_size=8,
              prefill_chunk=16, decode_chunk=4, num_blocks=16)
    eng = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **kw),
                                     params=tp, device="cpu")
    ref = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **kw),
                                     params=tp, device="cpu")
    seq = _prompt(9, 40)
    blocks = [5, 2, 9, 7, 12]
    table = torch.zeros((1, eng._prefill_w), dtype=torch.int32)
    table[0, :5] = torch.tensor(blocks)
    for p0, sample_idx in ((0, 0), (16, 7)):
        ids = eng._run_prefill(
            eng._prefill_programs, seq, blocks, p0, 16,
            sample_idx=np.array([sample_idx], np.int32),
            temp=np.array([0.0], np.float32), top_k=np.array([0], np.int32))
        want = ref._prefill_chunk_impl(
            torch.tensor([seq[p0:p0 + 16]], dtype=torch.int32), table, p0,
            sample_idx, torch.zeros(1), torch.zeros(1, dtype=torch.int32))
        assert torch.equal(ids, want)
        for name in ("k", "v"):
            assert torch.equal(eng.pool[name][:, 1:], ref.pool[name][:, 1:])
    assert list(eng._prefill_programs.by_width) == [16]
    assert int(eng._prefill_programs.by_width[16].buffers["p0"][0]) == 16


def test_a_failed_capture_raises_and_nothing_falls_back(weights, monkeypatch):
    """With graphs on, a prefill program whose capture fails raises out of
    the engine: the width gets no program and nothing runs eagerly in its
    place."""
    from ray_tpu_torch.llm import engine as tengine

    _, _, tcfg, tp = weights
    eng = tpaged.PagedTorchLLMEngine(
        LLMConfig(model_config=tcfg, max_batch_size=2, max_seq_len=64,
                  block_size=8, prefill_chunk=16), params=tp, device="cpu",
        _graphs=True)

    def refuse(fn, pool, stream, generator):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(tengine, "_capture_graph", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.generate([[1, 2, 3]], GenerationConfig(max_new_tokens=2))
    assert eng._prefill_programs.by_width == {}
    assert eng.prefill_tokens == 0
