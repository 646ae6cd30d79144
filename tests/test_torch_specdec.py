"""The port's speculative decoding against ``ray_tpu``'s.

- ``decode_window_paged`` gives JAX's logits and pool, block by block, a
  window past ``pos_limit`` included (its overflow goes to sink block 0);
- ``_spec_accept`` draws what JAX's draws (by distribution: the generators
  differ), and the emitted token follows the target's law (chi-square);
- the speculative engine's greedy tokens equal ``PagedJaxLLMEngine``'s and
  the port's own non-speculative tokens, and its acceptance counts equal
  JAX's exactly, for k in {1, 2, 4}, with the target as its own draft and
  with a smaller draft, across prefill-chunk and block boundaries; under
  preemption with a draft pool too small for every request the tokens
  and preemptions equal JAX's;
- the draft's pool follows the target's KV across block boundaries
  (where the JAX engine's leaves a hole: ROADMAP C3);
- draft-pool exhaustion degrades with zero drops; a batch with no
  speculating slot runs the plain chunk at k+1 steps; preemption
  re-enables speculation;
- ``warmup`` makes the propose, verify and (k+1)-step programs of every
  width, and the programs, run through a stand-in for CUDA graph capture
  and replay, give the direct call's tokens and book the draft's paged
  kernel launches per replay.

The JAX engines are the expensive part (a few seconds of compiles each):
each test runs the one reference it compares with, and every test that
runs one carries a 240 s watchdog, as tests/test_specdec.py's do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import paged as jpaged
from ray_tpu.llm.config import GenerationConfig as JGen
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SpeculativeConfig as JSpec
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import paged as tpaged
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import paged_attention as pa
from test_torch_paged_engine import _counting_kernel, _StubGraph

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

# tests/test_specdec.py's fp32 micro model, and a 1-layer draft
_CFG_KW = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=128, max_seq_len=96)
_ENGINE_KW = dict(max_batch_size=3, max_seq_len=96, block_size=8,
                  prefill_chunk=16, decode_chunk=4)
# below, at and above the prefill chunk (16) and block (8) boundaries
_LENS = (5, 15, 16, 17, 31, 33)


@pytest.fixture(scope="module")
def micro():
    """(jax target cfg, params, jax draft cfg, params) and the port's."""
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.float32)
    jdcfg = jl.LlamaConfig.tiny(**{**_CFG_KW, "n_layers": 1},
                                compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    jdp = jl.init_params(jdcfg, jax.random.PRNGKey(1))
    tcfg = tl.LlamaConfig.tiny(**_CFG_KW)
    tdcfg = tl.LlamaConfig.tiny(**{**_CFG_KW, "n_layers": 1})
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    tdp = convert.params_from_jax(jax.tree.map(np.asarray, jdp), tdcfg,
                                  device="cpu")
    return {"jax": (jcfg, jp, jdcfg, jdp), "torch": (tcfg, tp, tdcfg, tdp)}


def _prompts(lens, seed=3):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(1, 63, size=n)] for n in lens]


def _jax_engine(micro, k, self_draft, **kw):
    jcfg, jp, jdcfg, jdp = micro["jax"]
    spec = None if k is None else JSpec(
        draft_model_config=jcfg if self_draft else jdcfg,
        num_speculative_tokens=k, draft_num_blocks=kw.pop("draft_blocks", None))
    return jpaged.PagedJaxLLMEngine(
        JLLMConfig(model_config=jcfg, speculative_config=spec,
                   host_kv_cache_bytes=0, **{**_ENGINE_KW, **kw}),
        params=jp, draft_params=None if k is None else
        (jp if self_draft else jdp))


def _torch_engine(micro, k, self_draft, graphs=None, **kw):
    tcfg, tp, tdcfg, tdp = micro["torch"]
    spec = None if k is None else SpeculativeConfig(
        draft_model_config=tcfg if self_draft else tdcfg,
        num_speculative_tokens=k, draft_num_blocks=kw.pop("draft_blocks", None))
    return tpaged.PagedTorchLLMEngine(
        LLMConfig(model_config=tcfg, speculative_config=spec,
                  **{**_ENGINE_KW, **kw}),
        params=tp, draft_params=None if k is None else
        (tp if self_draft else tdp), device="cpu", _graphs=graphs)


def _finished_stats(eng, n):
    return [eng.specdec_request_stats(r) for r in range(1, n + 1)]


# -- decode_window_paged -----------------------------------------------------


def test_decode_window_paged_matches_jax(micro):
    """Logits within 1e-5 of JAX's and the pool block by block, for windows
    of 5 tokens at ragged lengths; the last row's window runs past
    pos_limit, whose overflow must land in sink block 0, never clamped
    onto the row's own live KV."""
    jcfg, jp, _, _ = micro["jax"]
    tcfg, tp, _, _ = micro["torch"]
    bs, nb, w, limit, t = 8, 24, 6, 48, 5
    rng = np.random.default_rng(0)
    kvd = tcfg.n_kv_heads * tcfg.head_dim
    pool_np = rng.standard_normal((2, tcfg.n_layers, nb, bs, kvd)).astype(
        np.float32)
    lengths = np.array([3, 20, 45], np.int32)
    table = np.zeros((3, w), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for r, n in enumerate(lengths):
        cover = min(-(-(int(n) + t) // bs), w)
        table[r, :cover] = perm[:cover]
        perm = perm[cover:]
    tokens = rng.integers(0, tcfg.vocab_size, (3, t)).astype(np.int32)
    rope = jl.rope_frequencies(jcfg.head_dim, limit, jcfg.rope_theta)
    jlog, jpool = jl.decode_window_paged(
        jcfg, jp, jnp.asarray(tokens),
        {"k": jnp.asarray(pool_np[0]), "v": jnp.asarray(pool_np[1])},
        jnp.asarray(table), jnp.asarray(lengths),
        rope_cache=tuple(jnp.asarray(x) for x in rope), pos_limit=limit)
    tpool = {"k": torch.from_numpy(pool_np[0].copy()),
             "v": torch.from_numpy(pool_np[1].copy())}
    tlog, same = tl.decode_window_paged(
        tcfg, tp, torch.from_numpy(tokens), tpool, torch.from_numpy(table),
        torch.from_numpy(lengths), tl.rope_cache(tcfg, limit, "cpu"),
        pos_limit=limit)
    assert same is tpool and tuple(tlog.shape) == (3, t, tcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        want = np.asarray(jpool[name])
        got = tpool[name].numpy()
        for blk in range(1, nb):  # sink block 0 holds garbage by design
            np.testing.assert_allclose(got[:, blk], want[:, blk], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {blk}")
        # row 2 writes positions 45..47 and sends 48, 49 to the sink
        last = table[2, (limit - 1) // bs]
        assert not np.array_equal(got[:, last, 5:], pool_np[0 if name == "k"
                                                            else 1][:, last, 5:])
        assert not np.array_equal(got[:, 0], pool_np[0 if name == "k"
                                                     else 1][:, 0])
    # a one-token window is one decode step
    tpool = {"k": torch.from_numpy(pool_np[0].copy()),
             "v": torch.from_numpy(pool_np[1].copy())}
    step_pool = {"k": torch.from_numpy(pool_np[0].copy()),
                 "v": torch.from_numpy(pool_np[1].copy())}
    rope_t = tl.rope_cache(tcfg, limit, "cpu")
    one, _ = tl.decode_window_paged(
        tcfg, tp, torch.from_numpy(tokens[:, :1]), tpool,
        torch.from_numpy(table), torch.from_numpy(lengths), rope_t,
        pos_limit=limit)
    step, _ = tl.decode_step_paged(
        tcfg, tp, torch.from_numpy(tokens[:, 0]), step_pool,
        torch.from_numpy(table), torch.from_numpy(lengths), rope_t)
    np.testing.assert_allclose(one[:, 0].numpy(), step.numpy(), rtol=1e-5,
                               atol=1e-6)


# -- the acceptance core -----------------------------------------------------


def _accept_cases(n):
    """Three rows, each tiled ``n`` times: a random draft q != p with
    proposals drawn from q, a zeroed q row (a degraded slot), and a greedy
    row (one-hot p and q; the first proposal the target's argmax, the
    second not).  V = 8, k = 2."""
    v, k = 8, 2
    rs = np.random.RandomState(2)
    p = rs.dirichlet(np.ones(v), size=(3, k + 1)).astype(np.float32)
    q = rs.dirichlet(np.ones(v) * 0.5, size=(3, k)).astype(np.float32)
    q[1] = 0.0
    greedy = np.eye(v, dtype=np.float32)[[[2, 5, 1]]][0]
    p[2] = greedy
    q[2] = np.eye(v, dtype=np.float32)[[2, 6]]
    drafted = np.zeros((3 * n, k), np.int32)
    draws = rs.random_sample((n, k))
    for j in range(k):  # row 0's proposals from q by inverse CDF
        drafted[0::3, j] = np.minimum(
            np.searchsorted(np.cumsum(q[0, j]), draws[:, j]), v - 1)
    drafted[2::3] = [2, 6]
    return (np.tile(p, (n, 1, 1)), np.tile(q, (n, 1, 1)), drafted)


def _outcome_hist(a, corr, rows=3):
    """Per row kind, the counts of (a, correction) outcomes."""
    out = []
    for r in range(rows):
        key = a[r::rows] * 8 + corr[r::rows]
        out.append(np.bincount(key, minlength=3 * 8) / len(key))
    return out


def test_spec_accept_draws_what_jax_draws():
    n = 6000
    pdist, qdist, drafted = _accept_cases(n)
    ja, jc = jpaged._spec_accept(jnp.asarray(pdist), jnp.asarray(qdist),
                                 jnp.asarray(drafted), jax.random.PRNGKey(0))
    ta, tc = tpaged._spec_accept(torch.from_numpy(pdist),
                                 torch.from_numpy(qdist),
                                 torch.from_numpy(drafted),
                                 torch.Generator().manual_seed(0))
    assert ta.dtype == tc.dtype == torch.int32
    ta, tc = ta.numpy(), tc.numpy()
    ja, jc = np.asarray(ja), np.asarray(jc)
    # the greedy row: exactly one outcome, the same in both
    assert (ta[2::3] == 1).all() and (tc[2::3] == 5).all()
    assert (ja[2::3] == 1).all() and (jc[2::3] == 5).all()
    # the zeroed row: nothing accepted, the correction from p_0
    assert ta[1::3].max() == 0 and ja[1::3].max() == 0
    for got, want in zip(_outcome_hist(ta, tc), _outcome_hist(ja, jc)):
        assert 0.5 * np.abs(got - want).sum() < 0.04, (got, want)
    p0 = pdist[1, 0]
    emp = np.bincount(tc[1::3], minlength=8) / n
    assert 0.5 * np.abs(emp - p0).sum() < 0.03


def test_rejection_sampling_matches_target_distribution():
    """The speculative-sampling lemma: the token emitted at position 0
    (the accepted proposal, or the correction) follows p_0 for a draft
    q != p.  A chi-square over 20,000 seeded draws (7 degrees of freedom;
    24.32 is the 0.999 quantile).  Also q == p accepts everything, and a
    zeroed q accepts nothing with corrections following p."""
    v, n = 8, 20000
    rs = np.random.RandomState(2)
    p = rs.dirichlet(np.ones(v)).astype(np.float32)
    q = rs.dirichlet(np.ones(v) * 0.5).astype(np.float32)
    gen = torch.Generator().manual_seed(7)
    pdist = torch.from_numpy(np.stack([p, p]))[None].expand(n, 2, v)
    d = torch.multinomial(torch.from_numpy(q), n, replacement=True,
                          generator=gen).to(torch.int32)[:, None]
    qd = torch.from_numpy(q)[None, None].expand(n, 1, v)
    a, corr = tpaged._spec_accept(pdist, qd, d, gen)
    tok = torch.where(a >= 1, d[:, 0], corr).numpy()
    counts = np.bincount(tok, minlength=v)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts / n, p)
    # a control: the draft's own law fails the same test
    chi2_q = float(((np.bincount(d[:, 0].numpy(), minlength=v) - n * p) ** 2
                    / (n * p)).sum())
    assert chi2_q > 24.32
    pp = torch.from_numpy(p)[None, None].expand(n, 1, v)
    dp = torch.multinomial(torch.from_numpy(p), n, replacement=True,
                           generator=gen).to(torch.int32)[:, None]
    a, _ = tpaged._spec_accept(pdist, pp, dp, gen)
    assert int(a.min()) == 1
    a, corr = tpaged._spec_accept(pdist, torch.zeros((n, 1, v)),
                                  torch.zeros((n, 1), dtype=torch.int32), gen)
    assert int(a.max()) == 0
    emp = np.bincount(corr.numpy(), minlength=v) / n
    assert 0.5 * np.abs(emp - p).sum() < 0.03


# -- greedy engine parity ----------------------------------------------------


@pytest.mark.timeout(240)
@pytest.mark.parametrize("k,self_draft", [(1, True), (2, False), (4, True),
                                          (4, False)],
                         ids=["k1-self", "k2-draft", "k4-self", "k4-draft"])
def test_spec_greedy_tokens_equal_jax_and_plain(micro, k, self_draft):
    prompts = _prompts(_LENS)
    gen = dict(max_new_tokens=10)
    je = _jax_engine(micro, k, self_draft)
    want = je.generate(prompts, JGen(**gen))
    te = _torch_engine(micro, k, self_draft)
    got = te.generate(prompts, GenerationConfig(**gen))
    plain = _torch_engine(micro, None, False).generate(
        prompts, GenerationConfig(**gen))
    assert got == want
    assert got == plain
    assert te.specdec_stats() == je.specdec_stats()
    assert te.specdec_stats()["proposed"] > 0
    assert _finished_stats(te, len(prompts)) == _finished_stats(je, len(prompts))
    assert te.spec_cycles > 0
    assert not te.has_work() and not any(te.draft_blocks.ref)


def _drive(eng, jobs):
    """add_request each (prompt, gen), step to the end; tokens per job."""
    ids = [eng.add_request(p, g) for p, g in jobs]
    out = {i: [] for i in ids}
    while eng.has_work():
        for rid, toks in eng.step().items():
            out[rid].extend(toks)
    for rid, toks in eng.flush().items():
        out[rid].extend(toks)
    return [out[i] for i in ids]


@pytest.mark.timeout(240)
def test_spec_stops_and_the_cache_end_equal_jax(micro):
    """Stop ids (one taken from a free run's stream) on two requests, and a
    third whose budget ends at max_seq (its last windows cross pos_limit,
    whose overflow goes to sink block 0): the verify's stop/budget/max_seq
    order gives JAX's tokens."""
    prompts = _prompts((9, 30, 80), seed=13)
    free = _torch_engine(micro, None, False).generate(
        prompts[:1], GenerationConfig(max_new_tokens=16))[0]
    stops = dict(max_new_tokens=16, stop_token_ids=(free[5], 63))
    runs = []
    for eng, gen_cls in ((_jax_engine(micro, 4, True), JGen),
                         (_torch_engine(micro, 4, True), GenerationConfig)):
        jobs = [(p, gen_cls(**stops)) for p in prompts[:2]]
        jobs.append((prompts[2], gen_cls(max_new_tokens=16)))
        runs.append((_drive(eng, jobs), eng.specdec_stats(), eng))
    (want, jstats, _), (got, stats, te) = runs
    assert got == want
    assert got[0] == free[:6]  # stopped at its stop id
    assert len(got[2]) == 16  # its last windows reach past max_seq (96)
    # every self-draft proposal accepted; JAX's counts part from these
    # where C3 leaves its draft a hole (a block crossed mid-flight)
    assert stats["accepted"] == stats["proposed"] > 0
    assert jstats["accepted"] <= jstats["proposed"]
    assert not any(te.blocks.ref) and not any(te.draft_blocks.ref)


def test_cancel_returns_the_draft_blocks(micro):
    eng = _torch_engine(micro, 3, True)
    rids = [eng.add_request(p, GenerationConfig(max_new_tokens=30))
            for p in _prompts((12, 20))]
    for _ in range(4):
        eng.step()
    assert any(r is not None and r.draft_blocks for r in eng._slot_req)
    assert all(eng.cancel_request(r) for r in rids)
    assert not eng.has_work()
    assert not any(eng.blocks.ref) and not any(eng.draft_blocks.ref)


@pytest.mark.timeout(240)
def test_spec_preemption_and_degrade_equal_jax(micro):
    """A target pool too small for three 56-token sequences (recompute
    preemption) and a draft pool too small for all three (degrades):
    tokens and preemptions equal JAX's, every proposal of the self-draft
    is accepted, and every preempted request speculates again after its
    recompute.  The proposal counts are not JAX's here: the port extends
    the draft's blocks also in the pass where the target allocates
    (ROADMAP C3), which moves when the small draft pool runs dry."""
    kw = dict(max_batch_size=4, max_seq_len=128, num_blocks=14,
              enable_prefix_caching=False, draft_blocks=9)
    prompts = _prompts((16, 16, 16), seed=7)
    gen = dict(max_new_tokens=40)
    je = _jax_engine(micro, 3, True, **dict(kw))
    te = _torch_engine(micro, 3, True, **dict(kw))
    victims = []
    for eng in (je, te):
        eng.preemptions = 0
        orig = eng._preempt_locked

        def spy(exclude_slot=-1, eng=eng, orig=orig):
            before = {id(r): r.spec_enabled for r in eng._slot_req
                      if r is not None}
            hit = orig(exclude_slot)
            if hit and eng is te:
                victims.extend(
                    (before[id(r)], r.spec_enabled, r.draft_blocks)
                    for r in eng._pending if id(r) in before)
            eng.preemptions += int(hit)
            return hit

        eng._preempt_locked = spy
    want = je.generate(prompts, JGen(**gen))
    got = te.generate(prompts, GenerationConfig(**gen))
    assert got == want
    assert all(len(o) == 40 for o in got)
    assert te.preemptions == je.preemptions > 0
    stats = te.specdec_stats()
    assert stats["accepted"] == stats["proposed"] > 0
    assert victims and all(now and blocks == [] for _, now, blocks in victims)
    assert not any(te.blocks.ref) and not any(te.draft_blocks.ref)


@pytest.mark.timeout(240)
def test_draft_kv_follows_the_target_across_block_boundaries(micro):
    """ROADMAP C3.  With the target as its own draft at fp32, the draft's
    pool holds the target's KV at every live position of every slot at
    each verify, so every proposal is accepted.  The JAX engine, on the
    same requests, extends the draft's blocks only in an ensure pass where
    the target allocates none: a cycle in flight across a block boundary
    then writes the draft's first appends of the new block to sink block
    0, and later proposals read that hole (fewer accepted).  Tokens are
    the same either way."""
    prompts = _prompts(_LENS)
    gen = dict(max_new_tokens=40)
    je = _jax_engine(micro, 3, True)
    want = je.generate(prompts, JGen(**gen))
    te = _torch_engine(micro, 3, True)
    worst = []
    verify = te._verify_programs.run

    def checked(state, table, emitted, accepted, generator):
        bs = te.bs
        for s, (r, n) in enumerate(zip(te._slot_req, state.lengths.tolist())):
            if r is None or not state.spec[s]:
                continue
            pos = torch.arange(n)
            for name in ("k", "v"):
                d = te._draft_pool[name][:, torch.tensor(r.draft_blocks)[
                    pos // bs], pos % bs]
                t = te.pool[name][:, torch.tensor(r.blocks)[pos // bs],
                                  pos % bs]
                worst.append(float((d - t).abs().max()))
        return verify(state, table, emitted, accepted, generator)

    te._verify_programs.run = checked
    got = te.generate(prompts, GenerationConfig(**gen))
    assert got == want
    assert worst and max(worst) < 1e-4
    stats, jstats = te.specdec_stats(), je.specdec_stats()
    assert stats["accepted"] == stats["proposed"] > 0
    assert jstats["accepted"] < jstats["proposed"]


def test_draft_pool_exhaustion_degrades_zero_drops(micro):
    """Five usable draft blocks: one 17-19-token prompt's chunk-padded
    draft reserve (4 + 1) fits, the next cannot.  Every request completes
    with the plain engine's tokens; someone speculated, someone degraded,
    and every draft block comes back."""
    prompts = _prompts((17, 18, 19), seed=17)
    gen = GenerationConfig(max_new_tokens=8)
    want = _torch_engine(micro, None, False).generate(prompts, gen)
    eng = _torch_engine(micro, 3, True, draft_blocks=6)
    got = eng.generate(prompts, gen)
    assert got == want and all(len(o) == 8 for o in got)
    stats = eng.specdec_stats()
    assert stats["proposed"] > 0
    spoke = [s for s in _finished_stats(eng, 3) if s is not None]
    assert 0 < len(spoke) < len(prompts)
    assert eng.draft_blocks.num_free() == eng._draft_num_blocks - 1


def test_fully_degraded_batch_runs_the_plain_chunk_at_k_plus_1(micro):
    """A 2-block draft pool (1 usable) satisfies no admission: no propose
    or verify program is ever made, every dispatch is the plain chunk at
    k+1 = 4 token steps, and the tokens are the plain engine's."""
    prompts = _prompts((17, 18), seed=41)
    gen = GenerationConfig(max_new_tokens=8)
    want = _torch_engine(micro, None, False, max_batch_size=2).generate(
        prompts, gen)
    eng = _torch_engine(micro, 3, True, max_batch_size=2, draft_blocks=2)
    got = eng.generate(prompts, gen)
    assert got == want
    assert eng._programs.n_steps == 4
    assert eng.spec_cycles == 0
    assert not eng._propose_programs.by_width
    assert not eng._verify_programs.by_width
    assert eng.decode_steps > 0 and eng.decode_steps % 4 == 0
    assert eng.specdec_stats()["proposed"] == 0


def test_sampled_requests_complete_through_speculation(micro):
    """temperature > 0 and top-k through propose and verify: full budgets
    and in-vocabulary tokens (the law is pinned on the core above)."""
    eng = _torch_engine(micro, 3, True, max_batch_size=2)
    outs = eng.generate(_prompts((6, 11), seed=9),
                        GenerationConfig(max_new_tokens=8, temperature=0.8,
                                         top_k=8))
    assert all(len(o) == 8 for o in outs)
    assert all(0 <= t < 64 for o in outs for t in o)
    assert eng.specdec_stats()["proposed"] > 0


def test_config_validation_and_the_disabled_path(micro):
    tcfg, tp, tdcfg, _ = micro["torch"]
    base = LLMConfig(model_config=tcfg, **_ENGINE_KW)
    bad = [(SpeculativeConfig(), "draft_model_config is required"),
           (SpeculativeConfig(draft_model_config=dataclasses.replace(
               tdcfg, vocab_size=65)), "vocab_size"),
           (SpeculativeConfig(draft_model_config=tdcfg,
                              num_speculative_tokens=0), ">= 1")]
    for spec, why in bad:
        with pytest.raises(ValueError, match=why):
            tengine.make_engine(dataclasses.replace(
                base, speculative_config=spec), params=tp, device="cpu")
    eng = tengine.make_engine(base, params=tp, device="cpu")
    assert eng.specdec_stats() is None and eng.specdec_request_stats(1) is None
    assert not hasattr(eng, "_draft_pool")
    assert eng._programs.n_steps == _ENGINE_KW["decode_chunk"]
    spec = tengine.make_engine(dataclasses.replace(
        base, speculative_config=SpeculativeConfig(draft_model_config=tdcfg)),
        params=tp, device="cpu")
    assert spec._spec_k == 4 and spec._programs.n_steps == 5
    assert not spec._draft_use_kernel  # the CPU gathers


def test_default_device_is_cuda_with_a_draft_too(micro, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, tp, tdcfg, tdp = micro["torch"]
    cfg = LLMConfig(model_config=tcfg, speculative_config=SpeculativeConfig(
        draft_model_config=tdcfg), **_ENGINE_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.make_engine(cfg, params=tp, draft_params=tdp)


@pytest.mark.parametrize("want", [None, True])
def test_a_draft_the_kernel_cannot_take_raises_on_the_card(monkeypatch, want):
    """The draft follows the target's kernel switch: on the card, a draft
    whose shape B1 refuses (head_dim 96) raises naming the gather's switch
    instead of gathering unasked; a draft B1 takes runs it.  The device is
    made CUDA for the switch alone (the pools stay on the CPU)."""
    use = tpaged._use_paged_kernel
    monkeypatch.setattr(
        tpaged, "_use_paged_kernel",
        lambda w, cfg, device, dtype, bs=None: use(w, cfg, "cuda", dtype, bs))
    kw = dict(vocab_size=64, n_layers=1, ffn_dim=128, max_seq_len=96,
              compute_dtype=torch.bfloat16)
    tcfg = tl.LlamaConfig.tiny(dim=128, n_heads=2, n_kv_heads=2, **kw)

    def build(dcfg, want_):
        return tpaged.PagedTorchLLMEngine(
            LLMConfig(model_config=tcfg, paged_attention_kernel=want_,
                      speculative_config=SpeculativeConfig(
                          draft_model_config=dcfg), **_ENGINE_KW),
            device="cpu")

    d96 = tl.LlamaConfig.tiny(dim=192, n_heads=2, n_kv_heads=2, **kw)
    with pytest.raises(ValueError, match="paged_attention_kernel=False"):
        build(d96, want)
    assert not build(d96, False)._draft_use_kernel
    d64 = tl.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=1, **kw)
    eng = build(d64, want)
    assert eng._use_kernel and eng._draft_use_kernel


# -- warmup and the per-width programs ---------------------------------------


def test_spec_warmup_makes_every_program_and_changes_nothing(micro):
    """Warm mid-serving: propose, verify and the (k+1)-step chunk at the
    same widths, the draft's prefill program at every chunk width the
    target's has; nothing but the two pools' sink blocks changes, and
    serving goes on to the unwarmed engine's tokens."""
    prompts = _prompts(_LENS)
    gen = GenerationConfig(max_new_tokens=10)
    want = _torch_engine(micro, 2, False).generate(prompts, gen)
    eng = _torch_engine(micro, 2, False)
    ids = [eng.add_request(p, gen) for p in prompts]
    got = {i: [] for i in ids}
    for _ in range(6):
        for rid, toks in eng.step().items():
            got[rid].extend(toks)
    assert eng._inflight is not None
    assert (sorted(eng._prefill_programs.by_width)
            == sorted(eng._draft_prefill_programs.by_width))
    pools = [t[:, 1:].clone() for t in (*eng.pool.values(),
                                         *eng._draft_pool.values())]
    gstate = eng._gen.get_state()
    eng.warmup()
    w = sorted(eng._programs.by_width)
    assert w == [1, 2, 4, 8, 16]
    assert sorted(eng._propose_programs.by_width) == w
    assert sorted(eng._verify_programs.by_width) == w
    assert (sorted(eng._prefill_programs.by_width)
            == sorted(eng._draft_prefill_programs.by_width) == [8, 16])
    assert all(torch.equal(a, b[:, 1:]) for a, b in zip(
        pools, (*eng.pool.values(), *eng._draft_pool.values())))
    assert torch.equal(eng._gen.get_state(), gstate)
    while eng.has_work():
        for rid, toks in eng.step().items():
            got[rid].extend(toks)
    assert [got[i] for i in ids] == want


def test_spec_programs_captured_and_replayed_book_the_draft_launches(
        micro, monkeypatch):
    """Propose, verify and the plain chunk "captured" per width and
    "replayed" give the direct engine's tokens; the draft's paged kernel
    calls are booked per propose replay (k+1 a layer), the verify window
    gathers (none), and the plain chunk books the target's."""
    monkeypatch.setattr(tl, "paged_decode_attention", _counting_kernel)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    k = 3
    # one slot; the second request's draft reserve (6 blocks) exceeds the
    # draft pool's 5, so it runs degraded: both kinds of batch occur
    kw = dict(max_batch_size=1, num_blocks=24, draft_blocks=6)
    prompts = _prompts((17, 40), seed=5)
    gen = GenerationConfig(max_new_tokens=12)
    direct = _torch_engine(micro, k, False, **dict(kw))
    direct._use_kernel = direct._draft_use_kernel = True
    want = direct.generate(prompts, gen)

    eng = _torch_engine(micro, k, False, graphs=True, **dict(kw))
    eng._use_kernel = eng._draft_use_kernel = True
    graphs = []
    program_sets = (eng._programs, eng._propose_programs, eng._verify_programs)

    def capture(fn, pool, stream, generator):
        st = eng._state
        tensors = [*eng.pool.values(), *eng._draft_pool.values(), st.tokens,
                   st.lengths, st.active, st.remaining, eng._drafted,
                   eng._qdist]
        tensors += [t for progs in program_sets
                    for p in progs.by_width.values()
                    for name, t in p.buffers.items() if name != "table"]
        graphs.append(_StubGraph(fn, tensors, generator, monkeypatch))
        return graphs[-1]

    monkeypatch.setattr(tengine, "_capture_graph", capture)
    n_layers = micro["torch"][0].n_layers
    d_layers = micro["torch"][2].n_layers
    monkeypatch.setattr(pa, "launches", 0)
    monkeypatch.setattr(pa, "captured_launches", 0)
    eng.warmup(max_len=48)
    widths = sorted(eng._programs.by_width)
    n_decode = 3 * len(widths)  # the prefill programs' graphs follow
    assert len(graphs) == n_decode + 2 * len(eng._prefill_programs.by_width)
    assert n_decode > 3
    per_width = n_layers * (k + 1) + d_layers * (k + 1)
    assert pa.captured_launches == per_width * len(widths)
    assert pa.launches == per_width * len(widths)  # the warm-up runs
    assert all(p.kernel_launches == 0
               for p in eng._verify_programs.by_width.values())
    pa.launches = 0
    got = eng.generate(prompts, gen)
    assert got == want
    assert eng.spec_cycles > 0 and eng.decode_steps > 0
    replays = sum(g.replays for g in graphs[:n_decode])
    assert replays == 2 * eng.spec_cycles + eng.decode_steps // (k + 1)
    assert pa.launches == (n_layers * eng.decode_steps
                           + d_layers * (k + 1) * eng.spec_cycles)
    assert eng.specdec_stats() == direct.specdec_stats()
