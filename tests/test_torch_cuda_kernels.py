"""The port's CUDA kernels on the card, each against its plain version.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch and ray_tpu_torch, so it also runs where
JAX is not installed; tests/conftest.py imports JAX, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _paged_inputs(dev, hd, group, kv=2, bs=16, seed=0,
                  lengths=(0, 15, 31, 100, 257, 64)):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths, np.int32)
    pages = [int(n) // bs + 1 for n in lengths]
    w = 1 << (max(pages) - 1).bit_length()
    nb = sum(pages) + 8
    perm = rng.permutation(np.arange(1, nb))
    table = np.zeros((len(lengths), w), np.int32)
    at = 0
    for r, n in enumerate(pages):
        table[r, :n] = perm[at:at + n]
        at += n
    dead = torch.as_tensor(np.concatenate([[0], perm[at:]]), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (3, nb, bs, kv * hd)
    pk = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    pv = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    pk[:, dead] = float("nan")  # pages outside every live span
    pv[:, dead] = float("nan")
    q = torch.randn((len(lengths), kv * group, hd), generator=g, device=dev,
                    dtype=torch.bfloat16)
    return (q, pk, pv, torch.as_tensor(table, device=dev),
            torch.as_tensor(lengths, device=dev))


@pytest.mark.parametrize("hd,group", [(128, 4), (128, 1), (64, 8), (64, 2)])
def test_paged_attention_kernel_matches_plain(cuda, hd, group):
    q, pk, pv, table, lengths = _paged_inputs(cuda, hd, group)
    before = pa.launches
    out = pa.paged_decode_attention(q, pk, pv, 2, table, lengths)
    assert pa.launches == before + 1
    ref = pa.paged_decode_attention_reference(q, pk, pv, 2, table, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    # both round the same exponentials to bf16; fp32 summation order may
    # carry one across a rounding boundary, within kernel_tolerance
    tol = pa.kernel_tolerance(q, pk, pv, 2, table, lengths)
    assert ((out - ref).abs() <= tol).all()
    # deterministic: fixed-order reductions
    assert torch.equal(out, pa.paged_decode_attention(q, pk, pv, 2, table,
                                                      lengths))


def test_paged_attention_kernel_takes_any_span(cuda):
    # 20,000 tokens at GQA group 8: nothing in the kernel grows with the span
    q, pk, pv, table, lengths = _paged_inputs(cuda, 128, 8,
                                              lengths=(19999, 3, 8191))
    out = pa.paged_decode_attention(q, pk, pv, 1, table, lengths)
    ref = pa.paged_decode_attention_reference(q, pk, pv, 1, table, lengths)
    tol = pa.kernel_tolerance(q, pk, pv, 1, table, lengths)
    assert ((out - ref).abs() <= tol).all()


def test_paged_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, pk, pv, table, lengths = _paged_inputs(cuda, 128, 4)
    with pytest.raises(ValueError, match="bf16"):
        pa.paged_decode_attention(q.float(), pk, pv, 0, table, lengths)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_decode_attention(q, pk, pv, 0, table.long(), lengths)
    with pytest.raises(ValueError, match="layer"):
        pa.paged_decode_attention(q, pk, pv, 3, table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                                  pk, pv, 0, table, lengths)
    q32, pk32, pv32, t32, l32 = _paged_inputs(cuda, 32, 2)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_decode_attention(q32, pk32, pv32, 0, t32, l32)


def test_engine_decodes_through_the_kernel(cuda):
    from ray_tpu_torch.llm import GenerationConfig, LLMConfig, make_engine
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=512,
                           param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
    assert cfg.head_dim == 128
    eng = make_engine(LLMConfig(model_config=cfg, max_batch_size=4,
                                max_seq_len=128, block_size=16,
                                prefill_chunk=32, decode_chunk=4),
                      generator=torch.Generator(device=cuda).manual_seed(0))
    assert eng._use_kernel
    pa.launches = 0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 70, 17, 33)]
    out = eng.generate(prompts, GenerationConfig(max_new_tokens=12))
    assert [len(o) for o in out] == [12] * 5
    assert pa.launches == cfg.n_layers * eng.decode_steps > 0
    assert math.isfinite(float(eng.pool["k"].float().abs().sum()))


def test_engine_refuses_a_config_the_kernel_cannot_take(cuda):
    from ray_tpu_torch.llm import LLMConfig, make_engine
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=128,  # head_dim 32
                           param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        make_engine(LLMConfig(model_config=cfg, max_seq_len=64),
                    generator=torch.Generator(device=cuda).manual_seed(0))
    eng = make_engine(LLMConfig(model_config=cfg, max_seq_len=64,
                                paged_attention_kernel=False),
                      generator=torch.Generator(device=cuda).manual_seed(0))
    assert not eng._use_kernel
