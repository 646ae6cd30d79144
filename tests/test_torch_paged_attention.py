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
from ray_tpu_torch.models import llama as tllama
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


def _pieces(tokens, n_splits, nvalid, bs):
    """The kernel's page walk for one (row, kv head): {split: [stage: [(token
    of the piece's first row, table slot, row in the page)]]} for the
    splits whose blocks do work.  A piece is a page, or a 64-row slice of
    one above 64 tokens; only pieces holding live tokens are loaded."""
    piece = min(bs, pa.STAGE_TOKENS)
    walk = {}
    for sp in range(n_splits):
        t0, t1 = sp * tokens, min(sp * tokens + tokens, nvalid)
        if t1 <= t0:
            break  # past the span: the block exits (split 0 of an empty one
            # writes zeros)
        walk[sp] = [[(t, t // bs, t % bs) for t in range(
            st, min(st + pa.STAGE_TOKENS, t1), piece)]
            for st in range(t0, t1, pa.STAGE_TOKENS)]
    return walk


def _kernel_arithmetic(q, pk, pv, li, table, lengths, n_sm=132):
    """csrc/paged_attention.cu's arithmetic in torch, fp32: the host's split
    plan; per (row, kv head, split) its page walk in 64-token stages, each
    stage four warps of 16 tokens with their own online softmax shifted by
    whole powers of two (scores: fp32 dot of the bf16 operands, then the
    fp32 scale), exp2(s - m) rounded to bf16 for the PV product; tokens past
    the span masked out of a loaded page; the warps merged in warp order,
    then the splits in split order."""
    b, nh, hd = q.shape
    bs, kvd = pk.shape[2], pk.shape[3]
    kv = kvd // hd
    group = nh // kv
    w = table.shape[1]
    tokens, n_splits = pa.split_plan(b, kv, w, bs, n_sm)
    scale = torch.tensor(np.log2(np.e), dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(hd)))
    out = torch.zeros(b, kv, group, hd)
    seen = []
    for r in range(b):
        nvalid = min(int(lengths[r]) + 1, w * bs)
        walk = _pieces(tokens, n_splits, nvalid, bs)
        for h in range(kv):
            qh = q[r].float().reshape(kv, group, hd)[h]
            parts = []
            for sp, stages in walk.items():
                t1 = min(sp * tokens + tokens, nvalid)
                warps = [(torch.full((group,), -torch.inf), torch.zeros(group),
                          torch.zeros(group, hd)) for _ in range(4)]
                for pieces in stages:
                    st = pieces[0][0]
                    loaded = torch.cat([torch.arange(t, t + min(bs, pa.STAGE_TOKENS))
                                        for t, _, _ in pieces])
                    for wi in range(4):
                        lo = st + 16 * wi
                        live = min(16, min(st + pa.STAGE_TOKENS, t1) - lo)
                        if live <= 0:
                            continue
                        toks = torch.arange(lo, lo + live)
                        assert torch.isin(toks, loaded).all()  # read only what was loaded
                        seen += [(r, h, int(t)) for t in toks]
                        rows = (table[r, toks // bs].long(), toks % bs)
                        k = pk[li][rows][:, h * hd:(h + 1) * hd].float()
                        v = pv[li][rows][:, h * hd:(h + 1) * hd].float()
                        s = (k @ qh.T) * scale  # [live, group]
                        m, l, acc = warps[wi]
                        m_new = torch.maximum(m, s.amax(0).ceil())
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(s - m_new)
                        warps[wi] = (m_new, l * corr + p.sum(0),
                                     acc * corr[:, None]
                                     + p.bfloat16().float().T @ v)
                mx = torch.stack([m for m, _, _ in warps]).amax(0)
                c = [torch.exp2(m - mx) for m, _, _ in warps]
                parts.append((mx, sum(l * ci for (_, l, _), ci in zip(warps, c)),
                              sum(a * ci[:, None]
                                  for (_, _, a), ci in zip(warps, c))))
            if not parts:
                continue  # an empty span: zeros
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            c = [torch.exp2(m - mx) for m, _, _ in parts]
            out[r, h] = (sum(a * ci[:, None] for (_, _, a), ci in zip(parts, c))
                         / sum(l * ci for (_, l, _), ci in zip(parts, c))[:, None])
    return out.reshape(b, nh * hd), seen


# empty; a span of 1; spans ending just before, on and just after the
# 128- and the 512-token split boundaries; one of 8,191 tokens
ARITH_LENGTHS = np.array([-1, 0, 15, 37, 126, 127, 128, 300, 510, 511, 512,
                          8190], np.int32)


def _arith_inputs(hd, group, lengths, bs=16, kv=2, seed=7):
    rng = np.random.default_rng(seed)
    pages = np.maximum(lengths + 1, 1) // bs + (np.maximum(lengths + 1, 1) % bs > 0)
    w = 1 << int(pages.max() - 1).bit_length()
    ids = rng.permutation(np.arange(1, pages.sum() + 2))
    table = np.zeros((len(lengths), w), np.int32)
    at = 0
    for r, n in enumerate(pages):
        table[r, :n] = ids[at:at + n]
        at += n
    shape = (2, pages.sum() + 2, bs, kv * hd)
    pk, pv = (torch.from_numpy(rng.standard_normal(shape, np.float32))
              .bfloat16() for _ in range(2))
    q = torch.from_numpy(rng.standard_normal(
        (len(lengths), kv * group, hd), np.float32)).bfloat16()
    return q, pk, pv, torch.from_numpy(table), torch.from_numpy(lengths)


@pytest.mark.parametrize("hd,group,n_sm,split", [
    (128, 4, 132, 512), (128, 8, 132, 512), (64, 2, 132, 512),
    (128, 4, 4000, 128),  # a card with more SMs plans shorter splits
], ids=["128-4", "128-8", "64-2", "128-4-shorter-splits"])
def test_kernel_arithmetic_within_tolerance_and_a_dropped_token_is_not(
        hd, group, n_sm, split):
    lengths = ARITH_LENGTHS
    q, pk, pv, table, lens = _arith_inputs(hd, group, lengths)
    assert pa.split_plan(len(lengths), 2, table.shape[1], 16, n_sm)[0] == split
    ref = pa.paged_decode_attention_reference(q, pk, pv, 1, table, lens)
    tol = pa.kernel_tolerance(q, pk, pv, 1, table, lens)
    got, seen = _kernel_arithmetic(q, pk, pv, 1, table, lens, n_sm)
    # every live token once per kv head, none past the span
    kv = pk.shape[3] // hd
    assert sorted(seen) == [(r, h, t) for r, n in enumerate(lengths)
                            for h in range(kv) for t in range(n + 1)]
    assert ((got - ref).abs() <= tol).all()
    assert (got[0] == 0).all()  # the empty span
    # the same values round to bf16: apart from the rare one that fp32
    # summation order carries across a rounding boundary, fp32 agreement
    assert ((got - ref).abs() > 1e-5).float().mean() < 0.01
    # negative controls: the last token of the longest row, and the last
    # of a span ending on a split boundary, dropped
    edge = int(np.flatnonzero(lengths + 1 == split)[0])
    for r in (len(lengths) - 1, edge):
        cut, _ = _kernel_arithmetic(q, pk, pv, 1, table,
                                    lens - (torch.arange(len(lens)) == r).int(),
                                    n_sm)
        assert ((cut - ref).abs() > tol)[r].any()


@pytest.mark.parametrize("bs", [8, 32, 64, 128])
def test_kernel_arithmetic_at_every_block_size_kind(bs):
    # pages of 8 (8 a stage), 32, 64 (one a stage) and 128 (a stage holds
    # a 64-row slice of one page)
    lengths = np.array([0, 63, 64, 200, 127], np.int32)
    q, pk, pv, table, lens = _arith_inputs(128, 4, lengths, bs=bs)
    ref = pa.paged_decode_attention_reference(q, pk, pv, 1, table, lens)
    tol = pa.kernel_tolerance(q, pk, pv, 1, table, lens)
    got, seen = _kernel_arithmetic(q, pk, pv, 1, table, lens)
    assert sorted(seen) == [(r, h, t) for r, n in enumerate(lengths)
                            for h in range(2) for t in range(n + 1)]
    assert ((got - ref).abs() <= tol).all()


# -- the split plan and the block sizes ----------------------------------------


@pytest.mark.parametrize("b,kv,w,bs", [
    (8, 8, 128, 16),   # the decode batch of chip_smoke.py phase 3 (a)
    (1, 8, 512, 16),   # one user at 8,192 tokens
    (32, 8, 128, 16),  # 32 rows
    (1, 8, 8, 16),     # a short table: 64-token splits
    (4, 2, 64, 16),    # 128-token splits
    (2, 8, 8192, 16),  # past 131,072 tokens: 256 splits of 512
    (3, 2, 5, 8),
    (2, 1, 3, 64),
    (2, 4, 3, 128),
])
def test_split_plan_covers_every_live_page_once(b, kv, w, bs):
    tokens, n_splits = pa.split_plan(b, kv, w, bs, 132)
    assert tokens in (64, 128, 256, 512)
    assert (n_splits - 1) * tokens < w * bs <= n_splits * tokens
    # the longest split that leaves a block for a quarter of the SMs over
    # the full table
    assert 4 * b * kv * n_splits >= 132 or tokens == pa.STAGE_TOKENS
    assert tokens == 512 or 4 * b * kv * -(-w * bs // (2 * tokens)) < 132
    # the plan is the shapes': any lengths walk it, each live page (or
    # 64-row slice of one) loaded exactly once, none past the span
    rng = np.random.default_rng(b * 1000 + w)
    for n in [-1, 0, w * bs - 1, *rng.integers(0, w * bs, size=20)]:
        nvalid = min(int(n) + 1, w * bs)
        walk = _pieces(tokens, n_splits, nvalid, bs)
        got = [(slot, row) for stages in walk.values() for pieces in stages
               for _, slot, row in pieces]
        piece = min(bs, pa.STAGE_TOKENS)
        want = [(t // bs, t % bs) for t in range(0, max(nvalid, 0), piece)]
        assert got == want
        assert len(walk) == -(-max(nvalid, 0) // tokens)
    # the workspace: every split's [group, hd] output and (max, sum) per head
    assert pa.workspace_floats(b, kv, n_splits, 4, 128) == (
        b * kv * n_splits * 4 * 130)


def test_the_kernel_takes_the_block_sizes_it_names():
    assert [bs for bs in range(1, 300) if pa.block_size_supported(bs)] == [
        8, 16, 32, 64, 128, 192, 256]
    bf16 = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    cfg = tllama.LlamaConfig.llama3_8b(**bf16)
    assert tllama.paged_kernel_refusal(cfg, "cuda", block_size=16) is None
    for bs in (4, 12, 24, 96):
        why = tllama.paged_kernel_refusal(cfg, "cuda", block_size=bs)
        assert f"block size {bs}" in why
