"""Paged decode attention: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``ray_tpu/ops/paged_attention.py:_kernel``
(entered through ``paged_decode_attention``), which DMAs each row's live
pages into VMEM, double-buffered, and runs an online softmax per kv head.
The port's kernel is ``csrc/paged_attention.cu``: one thread block per
(batch row, kv head) walks only the row's live pages with 16-byte loads,
each warp streaming its share of the span with an online softmax in fp32
(exponentials rounded to the cache dtype before the PV product, as the TPU
kernel does); the warps merge through shared memory in a fixed order.  Its
shifts are whole powers of two, so it rounds the same values as the plain
version (``attend_gathered``).

What bounds it on the H100: bytes, not operations.  Decode attention reads
each live K and V element once and does a handful of flops per element, so
the least time is (q + live K/V span + table + lengths + output bytes) /
3.35 TB/s.  The design reads exactly the live span, once; it does not yet
fill the card (B * kv blocks, 64 at B=8 on 132 SMs) -- split-KV is the
first performance item (ROADMAP, queue C).

Pool layout (canonical, ``models/llama.py init_paged_kv_cache``):
[L, NB, bs, kv*hd]; a page is a contiguous [bs, kv*hd] slab and a kv head
is a column slice of it.

``paged_decode_attention`` launches the kernel for CUDA tensors and raises
on anything the kernel does not take; it takes the plain version only when
its tensors lie on the CPU.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import Optional

import torch

from ray_tpu_torch.ops import _build

# kernel launches since import (or since a caller last reset it); CPU calls
# of the plain version do not count
launches = 0

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
_LOG2E = math.log2(math.e)

_lib: Optional[ctypes.CDLL] = None


def kernel_supports(head_dim: int, group: int) -> bool:
    """Whether the CUDA kernel is compiled for this head_dim and GQA group
    (n_heads // n_kv_heads).  Any table width runs."""
    return head_dim in HEAD_DIMS and group in GROUPS


def attend_gathered(q, ck, cv, span_mask):
    """GQA attention of q [B, T, nh, hd] against gathered spans ck/cv
    [B, S, kv, hd]; span_mask [B, T, S] True = visible.  Returns
    [B, T, nh*hd] fp32.

    The TPU kernel's arithmetic, which the CUDA kernel repeats: scores
    from the cache-dtype operands accumulated in fp32 and masked to -1e30;
    exponentials exp(s - m) in fp32, rounded to the cache dtype for the PV
    product (accumulated in fp32) and summed unrounded for the normaliser.
    The shift m is the row's max in log2 units rounded up to an integer,
    so the kernel's running shifts differ from it by powers of two, which
    move no bf16 rounding: the two paths round the same values.
    (``ray_tpu.models.llama._paged_attend`` rounds the normalised
    probabilities instead; in fp32 the two are the same softmax.)"""
    b, t, nh, hd = q.shape
    kv = ck.shape[2]
    qg = q.reshape(b, t, kv, nh // kv, hd).float() * (_LOG2E / math.sqrt(hd))
    scores = torch.einsum("btkgd,bskd->bkgts", qg, ck.float())  # log2 units
    scores = scores.masked_fill(~span_mask[:, None, None], -1e30)
    e = torch.exp2(scores - torch.ceil(scores.amax(-1, keepdim=True)))
    attn = torch.einsum("bkgts,bskd->btkgd", e.to(ck.dtype).float(),
                        cv.float())
    attn = attn / e.sum(-1).permute(0, 3, 1, 2)[..., None]
    return attn.reshape(b, t, nh * hd)


def _gather_live(pk_all, pv_all, li, table, lengths, hd):
    """The table's pages as [B, W*bs, kv, hd] K and V, zero past each row's
    span (a page outside the live span may hold stale or NaN data, and
    0 * NaN is NaN -- the TPU kernel zeroes a skipped chunk's contribution
    for the same reason), and the live mask [B, W*bs]."""
    b, w = table.shape
    bs, kvd = pk_all.shape[2], pk_all.shape[3]
    idx = table.long()
    ck = pk_all[li][idx].reshape(b, w * bs, kvd // hd, hd)
    cv = pv_all[li][idx].reshape(b, w * bs, kvd // hd, hd)
    live = (torch.arange(w * bs, device=table.device)[None, :]
            <= lengths.long()[:, None])  # span = lengths + 1
    zero = torch.zeros((), dtype=ck.dtype, device=ck.device)
    ck = torch.where(live[:, :, None, None], ck, zero)
    cv = torch.where(live[:, :, None, None], cv, zero)
    return ck, cv, live


def paged_decode_attention_reference(q, pk_all, pv_all, li, table, lengths):
    """Plain PyTorch version of the kernel (same signature and result):
    gathers the table's live span and attends as ``attend_gathered``."""
    ck, cv, live = _gather_live(pk_all, pv_all, li, table, lengths,
                                q.shape[-1])
    return attend_gathered(q[:, None], ck, cv, live[:, None])[:, 0]


def kernel_tolerance(q, pk_all, pv_all, li, table, lengths):
    """Per-element bound on |kernel - plain version| for bf16 inputs,
    [B, nh*hd] fp32.

    Both round the same exponentials to bf16 (``attend_gathered``), but
    fp32 summation order can carry a value across a rounding boundary.
    Each such rounding moves p_i by at most 2**-8 of itself, independently
    of the others, so even with every p_i rounded apart the difference at
    one output element is a sum of independent terms of size
    ~2**-8 * p_i * v_i: its spread is 2**-8 * sqrt(sum_i (p_i v_i)**2).
    The bound is four times that, plus 1e-5 for fp32 summation order.  It
    shrinks with the span where a fixed atol would not, so a kernel that
    drops or double-counts one token of a long span still fails it."""
    hd = q.shape[-1]
    ck, cv, live = _gather_live(pk_all, pv_all, li, table, lengths, hd)
    b, nh = q.shape[:2]
    kv = ck.shape[2]
    qg = q.float().reshape(b, kv, nh // kv, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck.float()) / math.sqrt(hd)
    scores = scores.masked_fill(~live[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    spread = torch.einsum("bkgs,bskd->bkgd", probs.square(),
                          cv.float().square()).sqrt()
    return (4 * 2.0 ** -8 * spread + 1e-5).reshape(b, nh * hd)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("paged_attention")
        fn = lib.paged_decode_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda_inputs(q, pk_all, pv_all, li, table, lengths):
    dev = q.device
    for name, t in (("pk_all", pk_all), ("pv_all", pv_all),
                    ("table", table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(
                f"paged_decode_attention: {name} is on {t.device}, q on {dev}")
    if q.dim() != 3 or pk_all.dim() != 4 or pk_all.shape != pv_all.shape:
        raise ValueError(
            f"paged_decode_attention: q must be [B, nh, hd] and pk/pv "
            f"[L, NB, bs, kv*hd] of one shape (got {tuple(q.shape)}, "
            f"{tuple(pk_all.shape)}, {tuple(pv_all.shape)})")
    b, nh, hd = q.shape
    n_layers, _, _, kvd = pk_all.shape
    for name, t in (("q", q), ("pk_all", pk_all), ("pv_all", pv_all)):
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"paged_decode_attention: the kernel takes bf16 {name} "
                f"(got {t.dtype})")
    for name, t in (("table", table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(
                f"paged_decode_attention: {name} must be int32 (got {t.dtype})")
    if kvd % hd or nh % (kvd // hd):
        raise ValueError(
            f"paged_decode_attention: pool width {kvd} is not a whole number "
            f"of kv heads dividing nh={nh} at head_dim {hd}")
    group = nh // (kvd // hd)
    if table.dim() != 2 or table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(
            f"paged_decode_attention: table must be [B, W] and lengths [B] "
            f"for B={b} (got {tuple(table.shape)}, {tuple(lengths.shape)})")
    if table.shape[1] == 0 or not kernel_supports(hd, group):
        raise ValueError(
            f"paged_decode_attention: no kernel for head_dim {hd}, GQA group "
            f"{group} and a {table.shape[1]}-page table (head_dims "
            f"{HEAD_DIMS}, groups {GROUPS}, at least one page)")
    if not 0 <= li < n_layers:
        raise ValueError(
            f"paged_decode_attention: layer {li} outside [0, {n_layers})")
    for name, t in (("q", q), ("pk_all", pk_all), ("pv_all", pv_all),
                    ("table", table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(
                f"paged_decode_attention: {name} must be 16-byte aligned")


def paged_decode_attention(q, pk_all, pv_all, li, table, lengths):
    """GQA paged decode attention.

    q [B, nh, hd] (unscaled); pk/pv [L, NB, bs, kv*hd]; li the layer index
    (an int); table [B, W] int32 block ids; lengths [B] int32 -- the valid
    span is lengths + 1 (the freshly written token attends to itself).  The
    kv-head count comes from the pool's folded last dim.  Returns
    [B, nh*hd] fp32, matching ``ray_tpu.models.llama._paged_attend``.

    CUDA tensors launch the kernel (bf16 q and pool) and raise on anything
    it does not take; CPU tensors run the plain version."""
    global launches
    li = operator.index(li)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pk_all, pv_all, li, table, lengths)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: no kernel for device {q.device}")
    _check_cuda_inputs(q, pk_all, pv_all, li, table, lengths)
    b, nh, hd = q.shape
    _, nb, bs, kvd = pk_all.shape
    out = torch.empty((b, nh * hd), dtype=torch.float32, device=q.device)
    lib = _library()
    code = lib.paged_decode_attention_bf16(
        q.data_ptr(), pk_all.data_ptr(), pv_all.data_ptr(), table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), li * nb * bs * kvd, b, nh,
        kvd // hd, hd, table.shape[1], bs,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_decode_attention")
    launches += 1
    return out
