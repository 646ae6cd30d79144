"""Paged decode attention: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``ray_tpu/ops/paged_attention.py:_kernel``
(entered through ``paged_decode_attention``), which DMAs each row's live
pages into VMEM, double-buffered, and runs an online softmax per kv head.
The port's kernel is ``csrc/paged_attention.cu``: split-KV over a grid of
(kv head, row, split) blocks, each split's live pages brought in by TMA
into a three-stage mbarrier ring, the GQA group on the tensor cores
(mma.sync), an online softmax per warp with whole-power-of-two shifts and
exponentials rounded to the cache dtype before the PV product, as the TPU
kernel does; the last split of each (row, kv head) merges them all in
split order, in the same launch.  It rounds the same values as the plain
version (``attend_gathered``).

What bounds it on the H100: bytes, not operations.  Decode attention reads
each live K and V element once and does a handful of flops per element, so
the least time is (q + live K/V span + table + lengths + output bytes) /
3.35 TB/s.  The split plan (``split_plan``) comes from the shapes and the
SM count alone, never from ``lengths``, so a call makes no host sync and
can be captured in a CUDA graph.

Pool layout (canonical, ``models/llama.py init_paged_kv_cache``):
[L, NB, bs, kv*hd]; a page is a contiguous [bs, kv*hd] slab and a kv head
is a column slice of it.

``paged_decode_attention`` launches the kernel for CUDA tensors and raises
on anything the kernel does not take; it takes the plain version only when
its tensors lie on the CPU.  ``launches`` counts kernel launches.  A call
made while its stream is being captured into a CUDA graph launches
nothing: it adds to ``captured_launches`` instead, and whoever replays the
graph adds the capture's count to ``launches`` on every replay
(:func:`count_replayed`), since a replay runs no Python.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

# kernel launches since import (or since a caller last reset it); CPU calls
# of the plain version do not count
launches = 0
# calls recorded into CUDA graphs under capture (they launch at replay)
captured_launches = 0

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
STAGE_TOKENS = 64  # the kernel's ring stage: four 16-token tiles
MAX_SPLITS = 256  # splits per (row, kv head) the kernel's merge takes
BLOCK_SIZES = ("block sizes that are multiples of 8 dividing 64 or multiples "
               "of 64")
_LOG2E = math.log2(math.e)

_lib: Optional[ctypes.CDLL] = None
# per (device, stream): the kernel's arrival counters, one per (row, kv
# head), zero between calls (the last split of each resets its own)
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}


def kernel_supports(head_dim: int, group: int) -> bool:
    """Whether the CUDA kernel is compiled for this head_dim and GQA group
    (n_heads // n_kv_heads).  Any table width runs."""
    return head_dim in HEAD_DIMS and group in GROUPS


def block_size_supported(block_size: int) -> bool:
    """Whether the kernel takes pages of ``block_size`` tokens: a multiple
    of 8 (TMA's swizzled boxes are whole 8-row groups) that divides 64 (a
    ring stage holds whole pages) or is a multiple of 64 (a stage holds a
    64-row slice of one page): 8, 16, 32, 64, 128, 192, ..."""
    return (block_size > 0 and block_size % 8 == 0
            and (STAGE_TOKENS % block_size == 0
                 or block_size % STAGE_TOKENS == 0))


def split_plan(batch: int, kv_heads: int, table_width: int, block_size: int,
               n_sm: int) -> Tuple[int, int]:
    """(tokens per split, splits per (row, kv head)) of the kernel's grid,
    from the shapes and the SM count alone (never from ``lengths``, so the
    launch needs no host sync).  The grid has one block per split of the
    full table; a block past its row's span exits at once.

    A split row costs its blocks a partial's write, an arrival and a merge
    on top of their bytes, and a block's ring keeps 96 KB in flight, so
    splits are long: 512 tokens, halved (down to 64) only while the full
    table would give fewer blocks than a quarter of the SMs (PERF.md:
    512-token splits were the fastest or within a few percent of it at
    every decode shape timed on an H100).  At most MAX_SPLITS: the merge
    stages every split's (max, sum) in shared memory, so past
    131,072 tokens the splits grow."""
    span = table_width * block_size
    tokens = 8 * STAGE_TOKENS
    while (tokens > STAGE_TOKENS
           and 4 * batch * kv_heads * -(-span // tokens) < n_sm):
        tokens //= 2
    tokens = max(tokens,
                 STAGE_TOKENS * -(-span // (STAGE_TOKENS * MAX_SPLITS)))
    return tokens, -(-span // tokens)


def workspace_floats(batch: int, kv_heads: int, n_splits: int, group: int,
                     head_dim: int) -> int:
    """fp32 elements of the kernel's split workspace: each split's
    unnormalised output [group, head_dim] and its (max, sum) per head."""
    return batch * kv_heads * n_splits * group * (head_dim + 2)


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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
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
    bs = pk_all.shape[2]
    if (table.shape[1] == 0 or not kernel_supports(hd, group)
            or not block_size_supported(bs)):
        raise ValueError(
            f"paged_decode_attention: no kernel for head_dim {hd}, GQA group "
            f"{group}, block size {bs} and a {table.shape[1]}-page table "
            f"(head_dims {HEAD_DIMS}, groups {GROUPS}, {BLOCK_SIZES}, at "
            f"least one page)")
    if not 0 <= li < n_layers:
        raise ValueError(
            f"paged_decode_attention: layer {li} outside [0, {n_layers})")
    if pk_all.shape[0] * pk_all.shape[1] * bs >= 2 ** 31:
        raise ValueError(
            f"paged_decode_attention: a pool of {pk_all.shape[0]} x "
            f"{pk_all.shape[1]} x {bs} rows passes TMA's 32-bit coordinates")
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
    li = operator.index(li)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pk_all, pv_all, li, table, lengths)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: no kernel for device {q.device}")
    _check_cuda_inputs(q, pk_all, pv_all, li, table, lengths)
    b, nh, hd = q.shape
    n_layers, nb, bs, kvd = pk_all.shape
    kv, w = kvd // hd, table.shape[1]
    dev = q.device
    tokens, n_splits = split_plan(b, kv, w, bs, _sm_count(_device_index(dev)))
    out = torch.empty((b, nh * hd), dtype=torch.float32, device=dev)
    ws = torch.empty(workspace_floats(b, kv, n_splits, nh // kv, hd),
                     dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    arrivals = _arrival_counters(dev, stream, b * kv)
    lib = _library()
    code = lib.paged_decode_attention_bf16(
        q.data_ptr(), pk_all.data_ptr(), pv_all.data_ptr(), table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        arrivals.data_ptr(), n_layers, nb, li, b, nh, kv, hd, w, bs, tokens,
        n_splits, stream)
    _build.check(lib, code, "paged_decode_attention")
    _count_launch()
    return out


def _count_launch() -> None:
    """One kernel call: a launch, or a node of a graph under capture."""
    global launches, captured_launches
    if torch.cuda.is_current_stream_capturing():
        captured_launches += 1
    else:
        launches += 1


def count_replayed(n: int) -> None:
    """Book the ``n`` kernel launches one replay of a captured graph made."""
    global launches
    launches += n


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _arrival_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters for calls on ``stream``
    of ``dev``, kept between calls: the kernel leaves them zero, so only a
    larger batch allocates (and zeroes) new ones.  Calls on one stream run
    in order, so they never share a counter at once.  Under graph capture
    they must already exist: counters made inside a capture would live in
    the graph's private pool and be zeroed only by its replays."""
    key = (_device_index(dev), stream)
    have = _arrivals.get(key)
    if have is None or have.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_decode_attention: no arrival counters for this stream "
                f"at batch x kv heads = {n}; call the kernel once on the "
                "capture stream before capturing it")
        have = torch.zeros(n, dtype=torch.int32, device=dev)
        _arrivals[key] = have
    return have
