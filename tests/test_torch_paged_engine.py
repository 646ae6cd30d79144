"""The port's paged engine against ``ray_tpu.llm.paged``.

- the host-side copies (BlockManager, prefix hashes, prefill planning) give
  the same sequences as the JAX package's originals;
- sampling's mask matches JAX's on the same logits;
- greedy tokens of ``PagedTorchLLMEngine(device="cpu")`` equal
  ``PagedJaxLLMEngine``'s exactly (same weights, fp32 tiny config) under
  chunked prefill, a prefix hit, preemption by recompute, and stop ids;
- construction refuses what this slice does not serve.
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
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tl.LlamaConfig.tiny()
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
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
    """A random script of alloc / register / release / match_prefix drives
    both BlockManagers; every return value and the whole state agree."""
    rng = np.random.default_rng(seed)
    bms = [jpaged.BlockManager(24, 4), tpaged.BlockManager(24, 4)]
    base = rng.integers(0, 50, 40).tolist()
    prompts = [base[:n] + rng.integers(0, 50, 6).tolist()
               for n in (8, 12, 20, 33)]
    held = [[], []]  # per manager: lists of block ids it still owns
    for _ in range(60):
        op = rng.integers(0, 4)
        if op == 0:
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
    ("kv_cache", "static"),
    ("speculative_config", object()),
    ("tensor_parallel_size", 2),
    ("pipeline_parallel_size", 2),
    ("data_parallel_size", 2),
    ("mesh", object()),
    ("host_kv_cache_bytes", 1 << 20),
    ("plasma_kv_cache_blocks", 4),
])
def test_unported_config_values_raise(weights, field, value):
    cfg = dataclasses.replace(
        LLMConfig(model_config=weights[2], max_seq_len=64), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tengine.make_engine(cfg, params=weights[3], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpaged.PagedTorchLLMEngine(cfg, params=weights[3], device="cpu")


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
