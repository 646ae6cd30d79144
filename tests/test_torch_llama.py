"""The port's paged Llama programs against the JAX package's.

Same weights (JAX's ``init_params`` carried over by ``convert``), fp32 on
``LlamaConfig.tiny``: two prompts prefilled in chunks, then three decode
steps for both.  Tolerances: logits atol 1e-4, pool contents atol 1e-5
(the same fp32 math in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops.rope import rope_frequencies
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

BS, NB, W, MAX_SEQ, CHUNK = 8, 16, 6, 64, 16
# seq 0 prefills in two chunks (27 tokens), seq 1 in one (13)
PLENS = (27, 13)
BLOCKS = ([3, 7, 1, 9, 12], [2, 5, 11, 14])


def _setup(tie):
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, tie_embeddings=tie)
    tcfg = tl.LlamaConfig.tiny(tie_embeddings=tie)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    assert ("lm_head" in tp) != tie
    cos, sin = rope_frequencies(jcfg.head_dim, MAX_SEQ, jcfg.rope_theta)
    return jcfg, tcfg, jp, tp, (jnp.asarray(cos), jnp.asarray(sin))


def _table(rows):
    t = np.zeros((len(rows), W), np.int32)
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def _check_pool(jpool, tpool, spans):
    """Pools equal at every live (block, offset) of each sequence."""
    for blocks, n in spans:
        for pos in range(n):
            blk, off = blocks[pos // BS], pos % BS
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tpool[name][:, blk, off].numpy(),
                    np.asarray(jpool[name][:, blk, off]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("tie", [False, True])
def test_prefill_chunks_then_decode_match_jax(tie, use_kernel):
    jcfg, tcfg, jp, tp, jrope = _setup(tie)
    trope = tl.rope_cache(tcfg, MAX_SEQ, "cpu")
    jpool = jl.init_paged_kv_cache(jcfg, NB, BS)
    tpool = tl.init_paged_kv_cache(tcfg, NB, BS, "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, jcfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    nxt = []
    for prompt, blocks in zip(prompts, BLOCKS):
        table = _table([blocks])
        for p0 in range(0, len(prompt), CHUNK):
            toks = np.zeros((1, CHUNK), np.int32)
            take = prompt[p0:p0 + CHUNK]
            toks[0, :len(take)] = take
            jlog, jpool = jl.prefill_chunk_paged(
                jcfg, jp, jnp.asarray(toks), jpool, jnp.asarray(table),
                jnp.int32(p0), rope_cache=jrope)
            tlog, tpool = tl.prefill_chunk_paged(
                tcfg, tp, torch.from_numpy(toks), tpool,
                torch.from_numpy(table), p0, trope)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=1e-4)
        last = (len(prompt) - 1) % CHUNK
        nxt.append(int(np.argmax(np.asarray(jlog)[0, last])))
    _check_pool(jpool, tpool, zip(BLOCKS, PLENS))

    table = _table(BLOCKS)
    lengths = np.array(PLENS, np.int32)
    tokens = np.array(nxt, np.int32)
    for _ in range(3):
        jlog, jpool = jl.decode_step_paged(
            jcfg, jp, jnp.asarray(tokens), jpool, jnp.asarray(table),
            jnp.asarray(lengths), rope_cache=jrope)
        tlog, tpool = tl.decode_step_paged(
            tcfg, tp, torch.from_numpy(tokens), tpool,
            torch.from_numpy(table), torch.from_numpy(lengths), trope,
            use_kernel=use_kernel)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4)
        tokens = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        lengths = lengths + 1
    _check_pool(jpool, tpool, zip(BLOCKS, lengths.tolist()))


def test_single_device_only_and_default_rope():
    _, tcfg, _, tp, _ = _setup(False)
    pool = tl.init_paged_kv_cache(tcfg, NB, BS, "cpu")
    toks = torch.tensor([4, 9], dtype=torch.int32)
    table = torch.from_numpy(_table(BLOCKS))
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    for kw in ({"mesh": object()}, {"tp_plan": object()}):
        with pytest.raises(NotImplementedError, match="A11"):
            tl.decode_step_paged(tcfg, tp, toks, pool, table, lengths, **kw)
    with pytest.raises(NotImplementedError, match="A11"):
        tl.prefill_chunk_paged(tcfg, tp, torch.zeros((1, CHUNK), dtype=torch.int32),
                               pool, table[:1], 0, tp_plan=object())
    # rope_cache=None builds the tables for cfg.max_seq_len; the second call
    # rewrites the same K/V, so the state and the logits repeat exactly
    a, _ = tl.decode_step_paged(tcfg, tp, toks, pool, table, lengths)
    b, _ = tl.decode_step_paged(tcfg, tp, toks, pool, table, lengths,
                                tl.rope_cache(tcfg, tcfg.max_seq_len, "cpu"))
    assert torch.equal(a, b)


def test_params_from_jax_is_a_copy_in_the_jax_layout():
    jcfg, tcfg, jp, tp, _ = _setup(False)
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["wq"]))
    assert tuple(tp["layers"]["w_down"].shape) == (
        tcfg.n_layers, tcfg.ffn_dim, tcfg.dim)
    with pytest.raises(ValueError, match="tie_embeddings"):
        convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                tl.LlamaConfig.tiny(tie_embeddings=True))
    bf = convert.params_from_jax(
        jax.tree.map(np.asarray, jl.init_params(
            jl.LlamaConfig.tiny(param_dtype=jnp.bfloat16),
            jax.random.PRNGKey(0))),
        tl.LlamaConfig.tiny(param_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16))
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["final_norm"].dtype == torch.bfloat16
