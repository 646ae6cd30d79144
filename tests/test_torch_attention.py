"""The port's attention ops against the JAX package's, on the same inputs.

Inputs come from seeded numpy.  fp32 throughout; tolerance 1e-5 (the same
fp32 softmax, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py


def _qkv(group, b=2, s=48, hkv=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), dtype=np.float32)
            for h in (hkv * group, hkv, hkv)]


def _segments(b, s, seed=1):
    rng = np.random.default_rng(seed)
    # packed rows: sorted ids, so each segment is contiguous
    return np.sort(rng.integers(0, 3, size=(b, s)), axis=1).astype(np.int32)


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal, group, segments):
    q, k, v = _qkv(group)
    seg = _segments(q.shape[0], q.shape[1]) if segments else None
    want = jattn.reference_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = tattn.reference_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_reference_attention_cross_lengths_and_scale():
    # Sq < Skv: causal queries sit at the end of the key span
    q, k, v = _qkv(2, s=40)
    q = q[:, -16:]
    want = jattn.reference_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=True, scale=0.3)
    got = tattn.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=True, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_repeat_kv_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tattn._repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(jattn._repeat_kv(jnp.asarray(x), 3)))


def test_multi_head_attention_gate_on_the_cpu():
    q, k, v = map(torch.from_numpy, _qkv(2, s=128, d=128))
    # the gate wants a CUDA device: the CPU takes the reference
    auto = tattn.multi_head_attention(q, k, v)
    ref = tattn.reference_attention(q, k, v)
    assert torch.equal(auto, ref)
    # forced: the flash path's plain version, the same attention
    flash = tattn.multi_head_attention(q, k, v, use_flash=True, block_q=64,
                                       block_k=64)
    torch.testing.assert_close(flash, ref, rtol=0, atol=1e-5)
    seg = torch.from_numpy(_segments(2, 128))
    with pytest.raises(ValueError, match="segment_ids"):
        tattn.multi_head_attention(q, k, v, segment_ids=seg, use_flash=True)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tattn.multi_head_attention(q[:, :64], k, v, use_flash=True)


def test_flash_refusal_reasons_for_a_cuda_device():
    # the gate's shape and dtype reasons, without a card: a stand-in device
    q, k, v = map(torch.from_numpy, _qkv(2, s=128, d=64))

    class OnCuda:
        def __init__(self, t):
            self.shape, self.dtype = t.shape, torch.bfloat16
            self.device = torch.device("cuda")

    qc, kc, vc = OnCuda(q), OnCuda(k), OnCuda(v)
    assert "multiples of 128" in tattn.flash_refusal(qc, kc, vc)
    q, k, v = map(torch.from_numpy, _qkv(2, s=128, d=128))
    qc, kc, vc = OnCuda(q), OnCuda(k), OnCuda(v)
    assert tattn.flash_refusal(qc, kc, vc) is None
    vc.dtype = torch.float32
    assert "one dtype" in tattn.flash_refusal(qc, kc, vc)
    qc.dtype = kc.dtype = torch.float32  # fp32 at D = 128: a built kernel
    assert tattn.flash_refusal(qc, kc, vc) is None
    for t in (qc, kc, vc):
        t.dtype = torch.float16
    assert "no flash kernel is built" in tattn.flash_refusal(qc, kc, vc)
