"""The port's flash attention against the JAX package's Pallas kernels.

The plain versions of the port's CUDA kernels (``flash_attention_fwd_reference``
and ``flash_attention_bwd_reference``) run against ``_flash_fwd`` and
``_flash_bwd`` in interpret mode, on the same seeded numpy inputs, at fp32:
S 256 with 128-blocks, so the causal early exit cuts real tiles.
Tolerances as ``tests/test_ops.py``: 2e-5 forward, 5e-4 gradients.

Then, in bf16, an emulation of the CUDA kernels' tiled arithmetic (their
tiles, loop bounds, running power-of-two shifts and bf16 outputs) stays
within ``kernel_tolerance`` of the plain versions, and one dropped key
breaks it: the wgmma pairs' at head_dim 128 and 256, and the FFMA
family's at fp32 and head_dim 128 and 256 (the forward's 128-row (D 128)
or 64-row (D 256) q tiles against 32-key tiles; the backward's 64 (D 128)
or 32 (D 256) resident rows against 32-row streamed tiles, dK/dV per q
head then over the group; in both, each score over D / 32 lanes' slices
of D).
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


@pytest.mark.parametrize("d", [64, 128, 256])
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

def _dot_t(a, b, d_split):
    """a @ b.T over ``d_split`` lanes' slices of D (lane q: every
    d_split-th float4 from the q-th), the lanes' sums added pairwise,
    neighbours first (the FFMA kernels' reduce-scatter)."""
    parts = []
    for lane in range(d_split):
        idx = [4 * c + t for c in range(lane, a.shape[-1] // 4, d_split)
               for t in range(4)]
        parts.append(a[..., idx] @ b[..., idx].transpose(-1, -2))
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _emulated_fwd(q3, k3, v3, scale, causal, n_rep, bm=128, bn=128,
                  d_split=1):
    """csrc/flash_attention.cu flash_fwd_kernel: per 128-row q tile,
    128-key tiles up to the diagonal, running shift = ceil of the max in
    log2 units, exponentials rounded to bf16 for PV, O rounded to bf16.
    ``d_split``: each score summed over that many lanes' slices of D, as
    ``_dot_t`` (the FFMA forward)."""
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
        for kt in range((qt + 1) * bm // bn if causal else s // bn):
            cols = torch.arange(kt * bn, (kt + 1) * bn)
            x = _dot_t(q3[:, rows].float(), kf[:, cols], d_split) * sl
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
                  bq=64, dq_tiles=None, per_head=False, d_split=1):
    """The dK/dV kernel's loops (per 128-key tile: the group's q heads, then
    64-row q tiles from the diagonal) and the dQ kernel's (per 128-row q
    tile, 64-key tiles up to the diagonal; ``dq_tiles`` (q rows, keys)
    where they are not (bn, bq)); each gradient summed in fp32
    and rounded to bf16 once, as the kernels write it.  (The kernels skip
    the 64 x 64 blocks where every key follows every query: they add only
    zeros here.)  ``per_head``: dK/dV summed per q head, then each group's
    heads in order (the FFMA kernels' fourth pass); ``d_split``: each score
    summed over that many lanes' slices of D (lane q: every d_split-th
    float4 from the q-th), then the lanes' sums pairwise, neighbours first
    (the FFMA kernels' reduce-scatter)."""
    bhq, s, d = q3.shape
    sl = tfa._scale_log2(scale)
    delta = (do.float() * o.float()).sum(-1)

    def tile(h, rows, cols):  # P and dS of q head h on rows x cols
        kvh = h // n_rep
        x = _dot_t(q3[h, rows].float(), k3[kvh, cols].float(), d_split) * sl
        p = torch.exp2(x - lse[h, rows, None] * math.log2(math.e))
        if causal:
            p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
        dp = _dot_t(do[h, rows].float(), v3[kvh, cols].float(), d_split)
        return p, p * (dp - delta[h, rows, None]) * scale

    dk = torch.zeros((bhq if per_head else k3.shape[0],) + k3.shape[1:])
    dv = torch.zeros_like(dk)
    for kvh in range(k3.shape[0]):
        for kt in range(s // bn):
            cols = torch.arange(kt * bn, (kt + 1) * bn)
            for h in range(kvh * n_rep, (kvh + 1) * n_rep):
                at = h if per_head else kvh
                for qi in range(kt * bn // bq if causal else 0, s // bq):
                    rows = torch.arange(qi * bq, (qi + 1) * bq)
                    p, ds = tile(h, rows, cols)
                    dv[at, cols] += p.to(v3.dtype).float().T @ do[h, rows].float()
                    dk[at, cols] += ds.to(q3.dtype).float().T @ q3[h, rows].float()
    if per_head:  # each group's q heads in order
        heads = [t.view(-1, n_rep, s, d) for t in (dk, dv)]
        dk, dv = (t[:, 0].clone() for t in heads)
        for r in range(1, n_rep):
            dk += heads[0][:, r]
            dv += heads[1][:, r]
    dq = torch.zeros((bhq, s, d))
    qb, kb = dq_tiles or (bn, bq)
    for h in range(bhq):
        for qt in range(s // qb):
            rows = torch.arange(qt * qb, (qt + 1) * qb)
            for kt in range((qt + 1) * qb // kb if causal else s // kb):
                cols = torch.arange(kt * kb, (kt + 1) * kb)
                _, ds = tile(h, rows, cols)
                dq[h, rows] += ds.to(k3.dtype).float() @ k3[h // n_rep, cols].float()
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _ratio(got, want, tol):
    return ((got.float() - want.float()).abs() / tol).max().item()


# the kernels' tiles: (forward q rows, forward keys, dK/dV keys, dK/dV q rows)
# and dQ's (q rows, keys); the FFMA backward sums dK/dV per q head, then
# over the group; the FFMA kernels sum each score over D / 32 lanes' slices
# of D, forward and backward
TILES = {"bf16_d128": dict(fwd=(128, 128), bwd=(128, 64), dq=(128, 64)),
         "bf16_d256": dict(fwd=(128, 64), bwd=(64, 64), dq=(128, 64)),
         "fp32_d128": dict(fwd=(128, 32), bwd=(64, 32), dq=(64, 32),
                           per_head=True, d_split=4),
         "fp32_d256": dict(fwd=(64, 32), bwd=(32, 32), dq=(32, 32),
                           per_head=True, d_split=8)}


@pytest.mark.parametrize("kernel", sorted(TILES))
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_arithmetic_within_tolerance_and_a_dropped_key_breaks_it(
        causal, kernel):
    dtype = torch.float32 if kernel.startswith("fp32") else torch.bfloat16
    d = int(kernel.split("_d")[1])
    q3, k3, v3, do = (torch.from_numpy(x).to(dtype)
                      for x in _inputs(2, d, seed=5))
    assert tfa.instantiation(dtype, d) == kernel
    kw = dict(scale=d ** -0.5, causal=causal, n_rep=2)
    (bm, bn), (bk, bq) = TILES[kernel]["fwd"], TILES[kernel]["bwd"]
    split = TILES[kernel].get("d_split", 1)
    ro, rlse = tfa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = tfa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    o, lse = _emulated_fwd(q3, k3, v3, **kw, bm=bm, bn=bn, d_split=split)
    assert _ratio(o, ro, tol["o"]) <= 1
    assert _ratio(lse, rlse, tol["lse"]) <= 1
    ref = tfa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse, do, **kw)
    tiles = dict(bn=bk, bq=bq, dq_tiles=TILES[kernel]["dq"],
                 per_head=TILES[kernel].get("per_head", False),
                 d_split=split)
    got = _emulated_bwd(q3, k3, v3, ro, rlse, do, **kw, **tiles)
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
    o_cut, _ = _emulated_fwd(q3, k3, v_cut, **kw, bm=bm, bn=bn,
                             d_split=split)
    assert _ratio(o_cut[:, -1], ro[:, -1], tol["o"][:, -1]) > 1
    k_cut = k3.clone()
    k_cut[:, -1] = 0
    dq_cut = _emulated_bwd(q3, k_cut, v3, ro, rlse, do, **kw, **tiles)[0]
    assert _ratio(dq_cut[:, -1], ref[0][:, -1], tol["dq"][:, -1]) > 1
    do_cut = do.clone()
    do_cut[:, -1] = 0
    _, dk_cut, dv_cut = _emulated_bwd(q3, k3, v3, ro, rlse, do_cut, **kw,
                                      **tiles)
    assert _ratio(dk_cut[:, -1], ref[1][:, -1], tol["dk"][:, -1]) > 1
    assert _ratio(dv_cut[:, -1], ref[2][:, -1], tol["dv"][:, -1]) > 1


@pytest.mark.parametrize("kernel", ["fp32_d128", "fp32_d256"])
@pytest.mark.parametrize("causal", [True, False])
def test_ffma_forward_arithmetic_at_an_odd_q_tile_count(causal, kernel):
    """S = 384: three 128-row q tiles at D 128, six 64-row ones at D 256,
    the diagonal crossing the 32-key tiles mid-tile; within the tolerance,
    and without the last key's V the last row breaks it."""
    d = int(kernel.split("_d")[1])
    q3, k3, v3, do = (torch.from_numpy(x) for x in _inputs(2, d, s=384, seed=7))
    kw = dict(scale=d ** -0.5, causal=causal, n_rep=2)
    (bm, bn), split = TILES[kernel]["fwd"], TILES[kernel]["d_split"]
    ro, rlse = tfa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = tfa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    o, lse = _emulated_fwd(q3, k3, v3, **kw, bm=bm, bn=bn, d_split=split)
    assert _ratio(o, ro, tol["o"]) <= 1
    assert _ratio(lse, rlse, tol["lse"]) <= 1
    v_cut = v3.clone()
    v_cut[:, -1] = 0
    o_cut, _ = _emulated_fwd(q3, k3, v_cut, **kw, bm=bm, bn=bn, d_split=split)
    assert _ratio(o_cut[:, -1], ro[:, -1], tol["o"][:, -1]) > 1


def test_wrappers_refuse_a_device_without_a_kernel():
    q3, k3, v3, _ = (torch.from_numpy(x) for x in _inputs(1, 64, s=64))
    meta = [t.to("meta") for t in (q3, k3, v3)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(*meta, scale=0.1, causal=True, n_rep=1)
