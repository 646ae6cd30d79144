"""The port's flash attention against the JAX package's Pallas kernels.

The plain versions of the port's CUDA kernels (``flash_attention_fwd_reference``
and ``flash_attention_bwd_reference``) run against ``_flash_fwd`` and
``_flash_bwd`` in interpret mode, on the same seeded numpy inputs, at fp32:
S 256 with 128-blocks, so the causal early exit cuts real tiles.
Tolerances as ``tests/test_ops.py``: 2e-5 forward, 5e-4 gradients.

Then, in bf16, an emulation of the CUDA kernels' tiled arithmetic (their
tiles, loop bounds, running power-of-two shifts and bf16 outputs) stays
within ``kernel_tolerance`` of the plain versions, and one dropped key
breaks it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops.attention import reference_attention

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

S, BLOCK, HKV = 256, 128, 2


def _inputs(n_rep, d, s=S, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q3, k3, v3, do = (rng.standard_normal((h, s, d)).astype(dtype)
                      for h in (HKV * n_rep, HKV, HKV, HKV * n_rep))
    return q3, k3, v3, do


def _jax_kw(causal, n_rep):
    return dict(causal=causal, block_q=BLOCK, block_k=BLOCK, n_rep=n_rep,
                interpret=True)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_and_backward_match_the_pallas_kernels(causal, n_rep, d):
    q3, k3, v3, do = _inputs(n_rep, d)
    scale = d ** -0.5
    jo, jlse = jfa._flash_fwd(*map(jnp.asarray, (q3, k3, v3)), scale=scale,
                              **_jax_kw(causal, n_rep))
    kw = dict(scale=scale, causal=causal, n_rep=n_rep)
    to, tlse = tfa.flash_attention_fwd_reference(
        *map(torch.from_numpy, (q3, k3, v3)), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0], rtol=0,
                               atol=2e-5)
    # the backward from the same q, k, v, O, LSE and dO
    o, lse = np.array(jo), np.array(jlse)
    want = jfa._flash_bwd(*map(jnp.asarray, (q3, k3, v3, o, lse, do)),
                          scale=scale, **_jax_kw(causal, n_rep))
    got = tfa.flash_attention_bwd_reference(
        *map(torch.from_numpy, (q3, k3, v3, o, lse[..., 0], do)), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32  # the final rounding is a no-op
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_autograd_through_the_reference(causal, n_rep):
    rng = np.random.default_rng(3)
    b, s, d = 2, 128, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
               .requires_grad_() for h in (HKV * n_rep, HKV, HKV))
    do = torch.from_numpy(rng.standard_normal((b, s, HKV * n_rep, d)).astype(np.float32))
    out = tfa.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    ref = reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref, (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=5e-4)
    # the CPU ran the plain versions: no kernel launch was counted
    assert tfa.fwd_launches == 0 and tfa.bwd_launches == 0


def test_flash_attention_checks_blocks_and_keeps_the_layout():
    q = torch.zeros((1, 96, 2, 16))
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q, q, q, block_q=64)
    out = tfa.flash_attention(q, q, q, block_q=32, block_k=96)
    assert out.shape == q.shape and not out.is_contiguous()  # [B, S, H, D] view


@pytest.mark.parametrize("b", [1, 3])
def test_flash_attention_hands_the_kernels_contiguous_heads(monkeypatch, b):
    """The kernels take contiguous [B*H, S, D] inputs; at B = 1 a reshape
    of the transposed heads would be a strided view (the static engine's
    prefill runs at B = 1)."""
    seen = []

    def spy(q3, k3, v3, *args):
        seen.extend(t.is_contiguous() for t in (q3, k3, v3))
        return q3.clone()

    monkeypatch.setattr(tfa._Flash, "apply", spy)
    q = torch.randn((b, 128, 4, 16))
    k = torch.randn((b, 128, 2, 16))
    tfa.flash_attention(q, k, k)
    assert seen == [True] * 3


# ---- the CUDA kernels' arithmetic, emulated tile by tile in bf16 ----------

def _emulated_fwd(q3, k3, v3, scale, causal, n_rep, bm=128, bn=128):
    """csrc/flash_attention.cu flash_fwd_kernel: per 128-row q tile,
    128-key tiles up to the diagonal, running shift = ceil of the max in
    log2 units, exponentials rounded to bf16 for PV, O rounded to bf16."""
    bhq, s, d = q3.shape
    sl = tfa._scale_log2(scale)
    kf = k3.float().repeat_interleave(n_rep, 0)
    vf = v3.float().repeat_interleave(n_rep, 0)
    o = torch.empty((bhq, s, d), dtype=q3.dtype)
    lse = torch.empty((bhq, s))
    for qt in range(s // bm):
        rows = torch.arange(qt * bm, (qt + 1) * bm)
        m = torch.full((bhq, bm, 1), -math.inf)
        l = torch.zeros((bhq, bm, 1))
        acc = torch.zeros((bhq, bm, d))
        for kt in range(qt + 1 if causal else s // bn):
            cols = torch.arange(kt * bn, (kt + 1) * bn)
            x = q3[:, rows].float() @ kf[:, cols].transpose(1, 2) * sl
            if causal:
                x = x.masked_fill(cols[None, :] > rows[:, None], -math.inf)
            m_new = torch.maximum(m, torch.ceil(x.amax(-1, keepdim=True)))
            corr = torch.where(m == -math.inf, 0.0, torch.exp2(m - m_new))
            p = torch.exp2(x - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(v3.dtype).float() @ vf[:, cols]
            m = m_new
        o[:, rows] = (acc / l).to(q3.dtype)
        lse[:, rows] = (m + torch.log2(l))[..., 0] * math.log(2)
    return o, lse


def _emulated_bwd(q3, k3, v3, o, lse, do, scale, causal, n_rep, bn=128,
                  bq=64):
    """The dK/dV kernel's loops (per 128-key tile: the group's q heads, then
    64-row q tiles from the diagonal) and the dQ kernel's (per 128-row q
    tile, 64-key tiles up to the diagonal); each gradient summed in fp32
    and rounded to bf16 once, as the kernels write it.  (The kernels skip
    the 64 x 64 blocks where every key follows every query: they add only
    zeros here.)"""
    bhq, s, d = q3.shape
    sl = tfa._scale_log2(scale)
    delta = (do.float() * o.float()).sum(-1)

    def tile(h, rows, cols):  # P and dS of q head h on rows x cols
        kvh = h // n_rep
        x = q3[h, rows].float() @ k3[kvh, cols].float().T * sl
        p = torch.exp2(x - lse[h, rows, None] * math.log2(math.e))
        if causal:
            p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
        dp = do[h, rows].float() @ v3[kvh, cols].float().T
        return p, p * (dp - delta[h, rows, None]) * scale

    dk = torch.zeros(k3.shape)
    dv = torch.zeros(v3.shape)
    for kvh in range(k3.shape[0]):
        for kt in range(s // bn):
            cols = torch.arange(kt * bn, (kt + 1) * bn)
            for h in range(kvh * n_rep, (kvh + 1) * n_rep):
                for qi in range(kt * bn // bq if causal else 0, s // bq):
                    rows = torch.arange(qi * bq, (qi + 1) * bq)
                    p, ds = tile(h, rows, cols)
                    dv[kvh, cols] += p.to(v3.dtype).float().T @ do[h, rows].float()
                    dk[kvh, cols] += ds.to(q3.dtype).float().T @ q3[h, rows].float()
    dq = torch.zeros((bhq, s, d))
    for h in range(bhq):
        for qt in range(s // bn):
            rows = torch.arange(qt * bn, (qt + 1) * bn)
            for kt in range((qt + 1) * bn // bq if causal else s // bq):
                cols = torch.arange(kt * bq, (kt + 1) * bq)
                _, ds = tile(h, rows, cols)
                dq[h, rows] += ds.to(k3.dtype).float() @ k3[h // n_rep, cols].float()
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _ratio(got, want, tol):
    return ((got.float() - want.float()).abs() / tol).max().item()


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_arithmetic_within_tolerance_and_a_dropped_key_breaks_it(causal):
    q3, k3, v3, do = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in _inputs(2, 128, seed=5))
    kw = dict(scale=128 ** -0.5, causal=causal, n_rep=2)
    ro, rlse = tfa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = tfa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    o, lse = _emulated_fwd(q3, k3, v3, **kw)
    assert _ratio(o, ro, tol["o"]) <= 1
    assert _ratio(lse, rlse, tol["lse"]) <= 1
    ref = tfa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse, do, **kw)
    got = _emulated_bwd(q3, k3, v3, ro, rlse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, ref):
        assert _ratio(g, w, tol[name]) <= 1, name
    if not causal:
        return
    # negative controls: the last key feeds only the last query row, and
    # only the last query row feeds the last key.  Without the last key's
    # V the forward must break O's tolerance there; without the last key's
    # K the dQ path misses one of that row's terms; without the last dO
    # row the dK/dV path misses the last key's only term
    v_cut = v3.clone()
    v_cut[:, -1] = 0
    o_cut, _ = _emulated_fwd(q3, k3, v_cut, **kw)
    assert _ratio(o_cut[:, -1], ro[:, -1], tol["o"][:, -1]) > 1
    k_cut = k3.clone()
    k_cut[:, -1] = 0
    dq_cut = _emulated_bwd(q3, k_cut, v3, ro, rlse, do, **kw)[0]
    assert _ratio(dq_cut[:, -1], ref[0][:, -1], tol["dq"][:, -1]) > 1
    do_cut = do.clone()
    do_cut[:, -1] = 0
    _, dk_cut, dv_cut = _emulated_bwd(q3, k3, v3, ro, rlse, do_cut, **kw)
    assert _ratio(dk_cut[:, -1], ref[1][:, -1], tol["dk"][:, -1]) > 1
    assert _ratio(dv_cut[:, -1], ref[2][:, -1], tol["dv"][:, -1]) > 1


def test_wrappers_refuse_a_device_without_a_kernel():
    q3, k3, v3, _ = (torch.from_numpy(x) for x in _inputs(1, 64, s=64))
    meta = [t.to("meta") for t in (q3, k3, v3)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(*meta, scale=0.1, causal=True, n_rep=1)
