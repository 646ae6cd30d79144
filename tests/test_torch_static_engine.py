"""The port's static engine and its model programs against the JAX package's.

- ``init_kv_cache``, ``prefill``, ``write_cache_slot`` and ``decode_step``
  against ``ray_tpu.models.llama``'s on the same weights (JAX's
  ``init_params`` carried over by ``convert``; fp32 ``LlamaConfig.tiny``).
  Tolerances: logits atol 1e-4, cache contents atol 1e-5 (the same fp32
  math in another summation order);
- the decode attention's block-diagonal products against the grouped
  einsum they replace, in fp32 and in bf16 (atol 1e-6: the same exact
  products summed in fp32);
- greedy tokens of ``TorchLLMEngine(device="cpu")`` equal
  ``JaxLLMEngine``'s exactly, step by step, with more requests than slots,
  a request joining mid-stream and a stop id that cuts a chunk short, at
  ``decode_chunk`` 1 and 4 (each prefill through the engine's per-bucket
  program, run directly on the CPU); ``prefix_digest`` and
  ``utilization``'s bookkeeping equal JAX's;
- ``_sample_dist`` equals JAX's; sampled rows of a mixed batch are held to
  the distribution (their frequencies, their top-k support), never by id;
- construction rules: CUDA by default, ``make_engine`` builds the static
  engine and refuses it a draft model, the ``llama3_70b`` preset's shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import engine as jengine
from ray_tpu.llm.config import GenerationConfig as JGen
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu.ops.rope import rope_frequencies
from ray_tpu_torch import convert
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny()
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


# -- model programs ------------------------------------------------------------


def test_static_programs_match_jax(weights):
    """Prefill two prompts, write them into slots 2 and 0 of a 3-slot
    cache, then three decode steps (slot 1 empty, its garbage masked)."""
    jcfg, jp, tcfg, tp = weights
    max_seq, slots = 48, 3
    cos, sin = rope_frequencies(jcfg.head_dim, max_seq, jcfg.rope_theta)
    jrope = (jnp.asarray(cos), jnp.asarray(sin))
    trope = tl.rope_cache(tcfg, max_seq, "cpu")

    jcache = jl.init_kv_cache(jcfg, slots, max_seq)
    tcache = tl.init_kv_cache(tcfg, slots, max_seq, device="cpu")
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        assert not tcache[name].any()

    rng = np.random.default_rng(0)
    plens = {2: 11, 0: 16}
    for slot, plen in plens.items():
        toks = rng.integers(0, 256, (1, 16)).astype(np.int32)
        jlog, jkv = jl.prefill(jcfg, jp, jnp.asarray(toks), jrope)
        tlog, tkv = tl.prefill(tcfg, tp, torch.from_numpy(toks), trope)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(tkv[name].numpy(),
                                       np.asarray(jkv[name]), rtol=0,
                                       atol=1e-5)
        jcache = jl.write_cache_slot(jcache, jkv, jnp.int32(slot))
        assert tl.write_cache_slot(tcache, tkv, slot) is tcache
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0, atol=1e-5)

    lengths = np.array([plens[0], 0, plens[2]], np.int32)
    tokens = rng.integers(0, 256, slots).astype(np.int32)
    for _ in range(3):
        jlog, jcache = jl.decode_step(jcfg, jp, jnp.asarray(tokens), jcache,
                                      jnp.asarray(lengths), jrope)
        tlog, out = tl.decode_step(tcfg, tp, torch.from_numpy(tokens), tcache,
                                   torch.from_numpy(lengths), trope)
        assert out is tcache
        for s in (0, 2):
            np.testing.assert_allclose(tlog[s].numpy(), np.asarray(jlog[s]),
                                       rtol=0, atol=1e-4)
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tcache[name][:, s, :lengths[s] + 1].numpy(),
                    np.asarray(jcache[name][:, s, :lengths[s] + 1]),
                    rtol=0, atol=1e-5)
        tokens = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        lengths = lengths + np.array([1, 0, 1], np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,group", [(2, 2), (1, 4), (4, 1)])
def test_decode_attention_block_diagonal_products(dtype, kv, group):
    """``_attend_cache`` reads the cache as [B, S, kv*hd] with q entering
    block-diagonally; it must be the grouped product it replaces."""
    g = torch.Generator().manual_seed(kv * 10 + group)
    b, s, hd = 3, 40, 16
    q = torch.randn((b, kv * group, hd), generator=g).to(dtype)
    ck = torch.randn((b, s, kv, hd), generator=g).to(dtype)
    cv = torch.randn((b, s, kv, hd), generator=g).to(dtype)
    lengths = torch.tensor([0, 17, 39])
    mask = torch.arange(s)[None, :] <= lengths[:, None]
    got = tl._attend_cache(q, ck, cv, mask)
    qg = q.float().view(b, kv, group, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck.float()) / hd ** 0.5
    scores = torch.where(mask[:, None, None], scores, torch.tensor(-1e30))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    want = torch.einsum("bkgs,bskd->bkgd", probs.float(), cv.float())
    torch.testing.assert_close(got, want.reshape(b, -1), rtol=0, atol=1e-6)


# -- engine parity ---------------------------------------------------------------


def _engines(weights, **kw):
    jcfg, jp, tcfg, tp = weights
    je = jengine.JaxLLMEngine(
        JLLMConfig(model_config=jcfg, kv_cache="static",
                   host_kv_cache_bytes=0, **kw), params=jp)
    te = tengine.make_engine(LLMConfig(model_config=tcfg, kv_cache="static",
                                       **kw), params=tp, device="cpu")
    assert isinstance(te, tengine.TorchLLMEngine)
    return je, te


def _drive(eng, script):
    """Run ``script`` [(steps before, prompt, max_new, stops)]: add each
    request after that many steps, then step to the end.  Returns every
    step's emitted dict, with request ids as indices into ``script``."""
    log, rids, step = [], {}, 0
    pending = list(script)
    while pending or eng.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, n, stops = pending.pop(0)
            rids[eng.add_request(prompt, _gen(eng, n, stops))] = len(rids)
        log.append({rids[r]: t for r, t in eng.step().items()})
        step += 1
    log.append({rids[r]: t for r, t in eng.flush().items()})
    return log


def _gen(eng, n, stops):
    cls = JGen if isinstance(eng, jengine.JaxLLMEngine) else GenerationConfig
    return cls(max_new_tokens=n, stop_token_ids=stops)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, n).tolist() for n in lens]


_SCENARIOS = {
    # five requests on two slots: each finished one frees a slot for the
    # next (prompt buckets 8, 16 and 32)
    "more_requests_than_slots": lambda p: [
        (0, p[i], 6, ()) for i in range(5)],
    # a second request joins while the first is mid-generation
    "join_mid_stream": lambda p: [(0, p[0], 30, ()), (2, p[1], 6, ())],
}


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_greedy_tokens_equal_jax_engine(weights, name, chunk):
    script = _SCENARIOS[name](_prompts(11, (3, 9, 17, 5, 30)))
    kw = dict(max_batch_size=2, max_seq_len=64, decode_chunk=chunk)
    je, te = _engines(weights, **kw)
    want = _drive(je, script)
    got = _drive(te, script)
    assert got == want
    assert sum(len(t) for s in got for t in s.values()) == sum(
        n for _, _, n, _ in script)
    assert not te.has_work() and te.prefill_tokens == sum(
        len(p) for _, p, _, _ in script)
    if name == "join_mid_stream":  # after its prefill, 1 decodes beside 0
        first = next(i for i, s in enumerate(got) if 1 in s)
        assert any(0 in s and 1 in s for s in got[first + 1:])


def test_prefix_digest_and_utilization_equal_jax(weights):
    """The static engine's digest is empty (no sharable blocks) and its
    utilization's slots, blocks and queue follow JAX's step by step."""
    je, te = _engines(weights, max_batch_size=2, max_seq_len=64,
                      decode_chunk=4)
    keys = ("engine", "slots", "kv_blocks", "pending")
    for p in _prompts(12, (3, 9, 17)):
        je.add_request(p, JGen(max_new_tokens=6))
        te.add_request(p, GenerationConfig(max_new_tokens=6))
    checks = 0
    while je.has_work() or te.has_work():
        ju, tu = je.utilization(), te.utilization()
        assert {k: tu[k] for k in keys} == {k: ju[k] for k in keys}
        assert je.step() == te.step()
        checks += 1
    assert te.prefix_digest() == je.prefix_digest() == {"block_size": 0,
                                                         "hashes": []}
    assert checks > 3


@pytest.mark.parametrize("chunk", [1, 4])
def test_stop_token_truncates_mid_chunk_as_jax(weights, chunk):
    """A stop id emitted inside a chunk deactivates the slot there; the
    next request in that slot generates cleanly."""
    prompt = [5, 6, 7]
    kw = dict(max_batch_size=2, max_seq_len=128, decode_chunk=chunk)
    je, te = _engines(weights, **kw)
    free = te.generate([prompt], GenerationConfig(max_new_tokens=24))[0]
    assert free == je.generate([prompt], JGen(max_new_tokens=24))[0]
    stop = next(t for t in free[2:] if t not in free[:2])
    cut = te.generate([prompt], GenerationConfig(max_new_tokens=24,
                                                 stop_token_ids=(stop,)))[0]
    assert cut == free[:free.index(stop) + 1]
    assert cut == je.generate([prompt], JGen(max_new_tokens=24,
                                             stop_token_ids=(stop,)))[0]
    assert te.generate([prompt], GenerationConfig(max_new_tokens=24))[0] == free


# -- sampling --------------------------------------------------------------------


@pytest.mark.parametrize("temps,top_ks", [
    ([0.0, 0.0, 0.0], [0, 0, 0]),
    ([0.7, 1.0, 2.5], [0, 5, 64]),
    ([0.0, 0.8, 1.3], [40, 1, 0]),
])
def test_sample_dist_matches_jax(temps, top_ks):
    logits = np.random.default_rng(6).standard_normal((3, 300)).astype(
        np.float32) * 4
    logits[0, 9] = logits[0, 11] = logits[0].max() + 1  # a tie: first index
    want = np.asarray(jengine._sample_dist(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_ks, jnp.int32)))
    got = tengine._sample_dist(
        torch.from_numpy(logits), torch.tensor(temps, dtype=torch.float32),
        torch.tensor(top_ks, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_mixed_batch_samples_by_distribution():
    """One batch of greedy, temperature and top-k rows: the greedy rows
    are the argmax every time; each sampled row's frequencies over 4,000
    draws lie within 5 standard errors of ``_sample_dist``."""
    rng = np.random.default_rng(8)
    logits = torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.7, 0.0])
    top_ks = torch.tensor([0, 0, 4, 3], dtype=torch.int32)
    dist = tengine._sample_dist(logits, temps, top_ks)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = torch.stack([tengine._sample(logits, gen, temps, top_ks)
                         for _ in range(n)])
    for row in range(4):
        freq = torch.bincount(draws[:, row].long(), minlength=12).double() / n
        p = dist[row].double()
        assert (freq - p).abs().max() <= 5 * (p * (1 - p) / n).sqrt().max() + 1e-9
    assert (draws[:, 0] == logits[0].argmax()).all()
    assert (draws[:, 3] == logits[3].argmax()).all()
    assert set(draws[:, 2].tolist()) <= set(logits[2].topk(4).indices.tolist())


def test_engine_mixed_batch_greedy_rows_exact_and_sampled_rows_in_support(weights):
    """Greedy and top-k sampled requests share the decode batch: the
    greedy rows equal JAX's greedy tokens, and every sampled token lies in
    the top-k of the JAX model's logits at its position."""
    jcfg, jp, tcfg, tp = weights
    prompts = _prompts(12, (6, 13, 4))
    kw = dict(max_batch_size=3, max_seq_len=64, decode_chunk=4)
    je, te = _engines(weights, **kw)
    greedy = GenerationConfig(max_new_tokens=8)
    hot = GenerationConfig(max_new_tokens=8, temperature=1.0, top_k=3)
    ids = [te.add_request(p, hot if i == 1 else greedy)
           for i, p in enumerate(prompts)]
    out = {i: [] for i in ids}
    while te.has_work():
        for rid, toks in te.step().items():
            out[rid].extend(toks)
    want = je.generate([prompts[0], prompts[2]], JGen(max_new_tokens=8))
    assert [out[ids[0]], out[ids[2]]] == want
    seq = list(prompts[1])
    for tok in out[ids[1]]:
        logits = jl.forward(jcfg, jp, jnp.asarray([seq]))[0, -1]
        assert tok in np.argsort(-np.asarray(logits))[:3].tolist()
        seq.append(tok)


# -- construction rules ----------------------------------------------------------


def test_default_device_is_cuda_and_never_falls_back(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLMConfig(model_config=weights[2], max_seq_len=64, kv_cache="static")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.TorchLLMEngine(cfg, params=weights[3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.make_engine(cfg, params=weights[3])


def test_make_engine_refuses_a_draft_model_and_unported_values(weights):
    cfg = LLMConfig(model_config=weights[2], max_seq_len=64, kv_cache="static")
    with pytest.raises(ValueError, match="requires kv_cache='paged'"):
        tengine.make_engine(dataclasses.replace(cfg, speculative_config=object()),
                            params=weights[3], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tengine.make_engine(dataclasses.replace(cfg, tensor_parallel_size=2),
                            params=weights[3], device="cpu")
    with pytest.raises(ValueError, match="kv_cache must be"):
        tengine.make_engine(dataclasses.replace(cfg, kv_cache="ring"),
                            params=weights[3], device="cpu")


def test_static_engine_refuses_a_config_the_flash_kernels_do_not_take(
        monkeypatch):
    # the decision only: it comes before anything is allocated, so no card
    # is needed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = tl.LlamaConfig.llama3_8b(compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        tengine.TorchLLMEngine(LLMConfig(model_config=cfg, kv_cache="static"),
                               params={})


def test_llama3_70b_preset_matches_jax():
    jcfg, tcfg = jl.LlamaConfig.llama3_70b(), tl.LlamaConfig.llama3_70b()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "ffn_dim", "max_seq_len", "rope_theta", "rms_norm_eps",
              "tie_embeddings", "head_dim", "num_params"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.num_params == 70_553_706_496
