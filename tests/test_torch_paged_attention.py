"""The plain version of the port's paged decode attention against the JAX
package: the Pallas TPU kernel run in interpret mode, and the model's
gather path ``llama._paged_attend``.  fp32 pools, atol 1e-5 (the same
softmax in another summation order).

The CUDA kernel itself runs only on the card: tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops.paged_attention import paged_decode_attention as jax_kernel
from ray_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

BS, W, HD, KV = 8, 8, 32, 2  # W=8 pages: the JAX kernel runs 2 chunks of 4
# empty; a span ending on a page (16 = 2 pages); one ending on a JAX chunk
# (32 = 4 pages); a full table; a ragged one
LENGTHS = np.array([0, 15, 31, 63, 40], np.int32)


def _inputs(group: int, seed: int = 0, nan_dead: bool = False):
    rng = np.random.default_rng(seed)
    b, nh = len(LENGTHS), KV * group
    nb, n_layers = 48, 2
    pk = rng.standard_normal((n_layers, nb, BS, KV * HD)).astype(np.float32)
    pv = rng.standard_normal((n_layers, nb, BS, KV * HD)).astype(np.float32)
    q = rng.standard_normal((b, nh, HD)).astype(np.float32)
    pages = rng.permutation(np.arange(1, nb))
    table = np.zeros((b, W), np.int32)
    used = 0
    for r, n in enumerate(LENGTHS):
        live = int(n) // BS + 1
        table[r, :live] = pages[used:used + live]
        used += live
    dead = pages[used:]
    for r, n in enumerate(LENGTHS):  # dead table entries -> unused pages
        live = int(n) // BS + 1
        table[r, live:] = rng.choice(dead, size=W - live)
    if nan_dead:
        pk[:, dead] = np.nan
        pv[:, dead] = np.nan
    return q, pk, pv, table


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("group", [1, 2, 4])
def test_plain_matches_pallas_interpret_and_gather(group):
    q, pk, pv, table = _inputs(group)
    li = 1
    got = pa.paged_decode_attention_reference(
        *_torch(q, pk, pv), li, *_torch(table, LENGTHS)).numpy()
    kern = np.asarray(jax_kernel(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), li,
        jnp.asarray(table), jnp.asarray(LENGTHS), interpret=True))
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-5)
    # the model's gather path on the same span
    b, nh = q.shape[:2]
    cfg = jllama.LlamaConfig.tiny(n_heads=nh, n_kv_heads=KV, dim=nh * HD)
    ck = jnp.asarray(pk[li][table]).reshape(b, W * BS, KV, HD)
    cv = jnp.asarray(pv[li][table]).reshape(b, W * BS, KV, HD)
    mask = jnp.arange(W * BS)[None, None, :] <= jnp.asarray(LENGTHS)[:, None, None]
    gather = np.asarray(jllama._paged_attend(
        cfg, jnp.asarray(q)[:, None], ck, cv, mask)[:, 0])
    np.testing.assert_allclose(got, gather, rtol=0, atol=1e-5)


def test_nan_pages_outside_spans_never_leak():
    q, pk, pv, table = _inputs(2, seed=3)
    _, pk_nan, pv_nan, _ = _inputs(2, seed=3, nan_dead=True)
    assert np.isnan(pk_nan).any()
    clean = pa.paged_decode_attention_reference(
        *_torch(q, pk, pv), 0, *_torch(table, LENGTHS))
    dirty = pa.paged_decode_attention_reference(
        *_torch(q, pk_nan, pv_nan), 0, *_torch(table, LENGTHS))
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)


def test_cpu_call_runs_plain_version_without_counting():
    q, pk, pv, table = _inputs(2, seed=4)
    before = pa.launches
    out = pa.paged_decode_attention(*_torch(q, pk, pv), 1,
                                    *_torch(table, LENGTHS))
    assert pa.launches == before
    want = pa.paged_decode_attention_reference(*_torch(q, pk, pv), 1,
                                               *_torch(table, LENGTHS))
    assert torch.equal(out, want)
    assert out.shape == (len(LENGTHS), q.shape[1] * HD)
    assert out.dtype == torch.float32


# -- the kernel's arithmetic against kernel_tolerance --------------------------


def _kernel_arithmetic(q, pk, pv, li, table, lengths, nw=8):
    """csrc/paged_attention.cu's arithmetic in torch, fp32: each of ``nw``
    warps walks the tokens the kernel gives it (chunks of U token slots of
    32 / (hd/8) tokens each) with an online softmax shifted by whole
    powers of two, rounding exp(s - m) to bf16 for the PV product; the
    warps merge at the end."""
    b, nh, hd = q.shape
    bs, kvd = pk.shape[2], pk.shape[3]
    kv = kvd // hd
    group = nh // kv
    tpw = 32 // (hd // 8)
    nslot, u = nw * tpw, 2 if group >= 8 else 4
    out = torch.zeros(b, kv, group, hd)
    seen = []
    for r in range(b):
        nvalid = int(lengths[r]) + 1
        rows = (table[r, torch.arange(nvalid) // bs].long(),
                torch.arange(nvalid) % bs)
        k = pk[li][rows].float().reshape(nvalid, kv, hd)
        v = pv[li][rows].float().reshape(nvalid, kv, hd)
        qs = q[r].float().reshape(kv, group, hd) * (np.log2(np.e) / hd ** 0.5)
        states = []
        for w in range(nw):
            m = torch.full((kv, group, 1), -torch.inf)
            l = torch.zeros(kv, group, 1)
            acc = torch.zeros(kv, group, hd)
            for base in range(w * tpw, nvalid, nslot * u):
                toks = [t for i in range(u) for t in range(
                    base + i * nslot, base + i * nslot + tpw) if t < nvalid]
                seen += [(r, t) for t in toks]
                s = torch.einsum("kgd,nkd->kgn", qs, k[toks])
                m_new = torch.maximum(m, s.amax(-1, keepdim=True).ceil())
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum(
                    "kgn,nkd->kgd", p.bfloat16().float(), v[toks])
                m = m_new
            states.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in states]).amax(0)
        c = [torch.exp2(m - mx) for m, _, _ in states]
        out[r] = (sum(a * ci for (_, _, a), ci in zip(states, c))
                  / sum(l * ci for (_, l, _), ci in zip(states, c)))
    return out.reshape(b, nh * hd), seen


@pytest.mark.parametrize("hd,group", [(128, 4), (128, 8), (64, 2)])
def test_kernel_arithmetic_within_tolerance_and_a_dropped_token_is_not(
        hd, group):
    rng = np.random.default_rng(7)
    kv, bs, lengths = 2, 16, np.array([0, 15, 37, 300, 255], np.int32)
    pages = lengths // bs + 1
    w = 1 << int(pages.max() - 1).bit_length()
    ids = rng.permutation(np.arange(1, pages.sum() + 1))
    table = np.zeros((len(lengths), w), np.int32)
    at = 0
    for r, n in enumerate(pages):
        table[r, :n] = ids[at:at + n]
        at += n
    shape = (2, pages.sum() + 1, bs, kv * hd)
    pk, pv = (torch.from_numpy(rng.standard_normal(shape, np.float32))
              .bfloat16() for _ in range(2))
    q = torch.from_numpy(rng.standard_normal(
        (len(lengths), kv * group, hd), np.float32)).bfloat16()
    table, lens = torch.from_numpy(table), torch.from_numpy(lengths)
    ref = pa.paged_decode_attention_reference(q, pk, pv, 1, table, lens)
    tol = pa.kernel_tolerance(q, pk, pv, 1, table, lens)
    got, seen = _kernel_arithmetic(q, pk, pv, 1, table, lens)
    # every live token once, none past the span
    assert sorted(seen) == [(r, t) for r, n in enumerate(lengths)
                            for t in range(n + 1)]
    assert ((got - ref).abs() <= tol).all()
    # the same values round to bf16: apart from the rare one that fp32
    # summation order carries across a rounding boundary, fp32 agreement
    assert ((got - ref).abs() > 1e-5).float().mean() < 0.01
    cut, _ = _kernel_arithmetic(q, pk, pv, 1, table,
                                lens - (lens == 300).int())
    assert ((cut - ref).abs() > tol)[3].any()
