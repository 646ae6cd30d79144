"""Grouped matrix products: hand-written CUDA kernels for Hopper, their
plain PyTorch versions, and the autograd Function that joins them.

Replaces jax's Pallas TPU library kernels ``megablox/gmm.py:gmm`` and
``megablox/gmm.py:tgmm`` and the custom VJP ``megablox/ops.py:gmm`` that
joins them, which ``ray_tpu/models/moe.py:_grouped_matmul`` calls for the
expert products of ``moe_block_ragged``.  The rows of ``lhs`` are grouped
by expert: group g holds rows [off[g], off[g + 1]), off being the exclusive
prefix sum of ``group_sizes`` [E] (int32).

  gmm(lhs [M, K], rhs [E, K, N])          out[rows of g] = lhs[rows of g] @ rhs[g]
      transpose_rhs: rhs [E, N, K]         out[rows of g] = lhs[rows of g] @ rhs[g]^T
  tgmm(lhs_t [K, M], grad [M, N])          out[g] = lhs_t[:, rows of g] @ grad[rows of g]
                                           -> [E, K, N]; a group without rows gives zeros

The port's kernels are ``csrc/grouped_matmul.cu``: wgmma m64n256k16 bf16
products with fp32 accumulation into 128 x 256 output tiles, fed by a TMA
producer warpgroup through a 4-stage ring of 64-deep stages and written
back by TMA stores, in one persistent block per SM that walks a work list
formed on the device from the group offsets, so routing never waits for
the host.  ``gmm``'s items are (group, n-tile, m-tile), a tile straddling
a group boundary visited once per group it touches; ``tgmm``'s are
(group, K tile, N tile), the largest group first, each summing its
group's rows without atomics.

What bounds them on the H100: operations.  At the MoE training shapes
(M = 16384, K = 4096, N = 14336, E = 8) each call is 1.924e12 flops, 1.946
ms at 989 TFLOP/s, against 0.46 ms for its ~1.54 GB at 3.35 TB/s; hence
the tensor cores' own instruction (wgmma), copies that cost the consumers
no instructions (TMA), and blocks that overlap one tile's stores with the
next one's loads.

Rounding points are megablox's: bf16 operands, exact products summed in
fp32, one rounding to bf16 at the output.  The plain versions
(``gmm_reference``, ``tgmm_reference``; also the counterpart of
``lax.ragged_dot``, which the JAX package runs off the TPU) take fp32
products of the same values and round once, so only the summation order
separates them from the kernels.  ``kernel_tolerance`` bounds that, per
output element with products p_i = a_i * b_i summed to s:

    2**-7 * |s|  +  2**-12 * sqrt(sum_i p_i**2)

The first term is one bf16 rounding flip of the output; the second the
spread that two fp32 summation orders of the row's products can reach
(errors of 2**-23 of partial sums near the spread, adding like a random
walk over up to 2**16 terms, times 8).  A row computed with another
group's weights, or one term left out of a sum, breaks it.

fp32 operands (a model computing in fp32, as megablox runs it) launch
the FFMA kernels of ``csrc/grouped_matmul_ffma.cu`` instead: the same
contract, every product an fp32 FMA (no TF32, no bf16 rounding of an
operand), 128 x 256 output tiles of 8 x 16 a thread, 16-deep cp.async
stages (gmm's K-contiguous operands transposed in shared memory), the
group plan formed on the device.  Their tolerance keeps the summation
term and takes one fp32 rounding for the first: 2**-23 |s| + 2**-12
sqrt(sum_i p_i**2).

``gmm`` / ``tgmm`` launch the kernels for CUDA tensors and raise on what
they do not take (``kernel_refusal``: a dtype with no built kernel among
them); they run the plain versions only when their tensors lie on the
CPU.  ``gmm_launches`` and ``tgmm_launches`` count the bf16 kernels'
launches, ``gmm_fp32_launches`` and ``tgmm_fp32_launches`` the fp32 ones'.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

# kernel launches since import (or since a caller last reset them); CPU
# calls of the plain versions do not count
gmm_launches = 0
tgmm_launches = 0
gmm_fp32_launches = 0
tgmm_fp32_launches = 0

# operand dtype -> the library holding its kernels and their entries' suffix
KERNEL_DTYPES = {torch.bfloat16: ("grouped_matmul", "bf16"),
                 torch.float32: ("grouped_matmul_ffma", "fp32")}

MAX_GROUPS = 64  # each kernel block forms the work list of at most this many

_libs: dict = {}


def _spans(group_sizes: torch.Tensor, m: int) -> List[Tuple[int, int]]:
    """Each group's rows [start, end) on the host, clamped to [0, m] as the
    kernels clamp them."""
    spans, end = [], 0
    for size in group_sizes.tolist():
        start, end = end, min(end + max(min(int(size), m), 0), m)
        spans.append((start, end))
    return spans


def _gmm_fp32(lhs, rhs, group_sizes, transpose_rhs):
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    spans = _spans(group_sizes, m)
    parts = []
    for g, (start, end) in enumerate(spans):
        if end > start:
            w = rhs[g].float()
            parts.append(lhs[start:end].float() @ (w.T if transpose_rhs else w))
    last = spans[-1][1] if spans else 0
    parts.append(lhs.new_zeros((m - last, n), dtype=torch.float32))  # no group
    return torch.cat(parts)


def _tgmm_fp32(lhs_t, grad, group_sizes):
    return torch.stack([lhs_t[:, start:end].float() @ grad[start:end].float()
                        for start, end in _spans(group_sizes, lhs_t.shape[1])])


def gmm_reference(lhs, rhs, group_sizes, *, transpose_rhs: bool = False):
    """Plain version of the gmm kernel (same signature and result): [M, N]
    in lhs's dtype, fp32 products rounded once.  Rows past the last group
    are zeros.  Reads the group sizes on the host."""
    return _gmm_fp32(lhs, rhs, group_sizes, transpose_rhs).to(lhs.dtype)


def tgmm_reference(lhs_t, grad, group_sizes):
    """Plain version of the tgmm kernel: [E, K, N] in grad's dtype."""
    return _tgmm_fp32(lhs_t, grad, group_sizes).to(grad.dtype)


def kernel_tolerance(op: str, x, y, group_sizes, *,
                     transpose_rhs: bool = False) -> torch.Tensor:
    """Per-element bound on |kernel - plain version| of ``op`` ("gmm":
    x = lhs, y = rhs; "tgmm": x = lhs_t, y = grad), fp32, shaped like the
    output: 2**-7 |s| + 2**-12 sqrt(sum_i p_i**2) for bf16 operands,
    2**-23 |s| + 2**-12 sqrt(sum_i p_i**2) for fp32 (module docstring)."""
    if op == "gmm":
        def product(a, b):
            return _gmm_fp32(a, b, group_sizes, transpose_rhs)
    elif op == "tgmm":
        def product(a, b):
            return _tgmm_fp32(a, b, group_sizes)
    else:
        raise ValueError(f"op must be 'gmm' or 'tgmm' (got {op!r})")
    exact = product(x, y).abs()
    spread = product(x.float().square(), y.float().square()).sqrt()
    rounding = 2.0 ** -23 if x.dtype == torch.float32 else 2.0 ** -7
    return rounding * exact + 2.0 ** -12 * spread + 1e-30


def _library(dtype: torch.dtype):
    """(library, gmm entry, tgmm entry) of ``dtype``'s kernels, built at
    first use."""
    got = _libs.get(dtype)
    if got is None:
        name, suffix = KERNEL_DTYPES[dtype]
        lib = _build.library(name)
        fg = getattr(lib, f"grouped_matmul_gmm_{suffix}")
        fg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fg.restype = ctypes.c_int
        ft = getattr(lib, f"grouped_matmul_tgmm_{suffix}")
        ft.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        ft.restype = ctypes.c_int
        got = _libs[dtype] = (lib, fg, ft)
    return got


def kernel_refusal(op: str, x, y, group_sizes, *,
                   transpose_rhs: bool = False) -> Optional[str]:
    """Why the CUDA kernel of ``op`` cannot take this call, or None when it
    can.  "gmm": x = lhs [M, K], y = rhs [E, K, N] ([E, N, K] with
    ``transpose_rhs``); "tgmm": x = lhs_t [K, M], the transpose of a
    contiguous [M, K] tensor (``lhs.t()``: the kernel reads the forward's
    layout, so the backward copies no activation), y = grad [M, N].  Any M,
    group sizes of 0 included; K and N positive multiples of 8; both
    operands bf16 (the wgmma kernels) or both fp32 (the FFMA kernels)."""
    if op not in ("gmm", "tgmm"):
        raise ValueError(f"op must be 'gmm' or 'tgmm' (got {op!r})")
    if x.dtype != y.dtype or x.dtype not in KERNEL_DTYPES:
        return (f"the kernels take bf16 or fp32 operands of one dtype (got "
                f"{x.dtype} and {y.dtype})")
    if (group_sizes.dtype != torch.int32 or group_sizes.dim() != 1
            or not group_sizes.is_contiguous()):
        return (f"group_sizes must be a contiguous 1-D int32 tensor (got "
                f"{group_sizes.dtype}, shape {tuple(group_sizes.shape)})")
    e = group_sizes.shape[0]
    if not 1 <= e <= MAX_GROUPS:
        return f"the kernels take 1 to {MAX_GROUPS} groups (got {e})"
    if op == "gmm":
        if x.dim() != 2 or y.dim() != 3:
            return (f"gmm takes lhs [M, K] and rhs [E, K, N] (got "
                    f"{tuple(x.shape)}, {tuple(y.shape)})")
        k = x.shape[1]
        k_rhs, n = (y.shape[2], y.shape[1]) if transpose_rhs else y.shape[1:]
        if y.shape[0] != e or k_rhs != k:
            return (f"rhs {tuple(y.shape)} does not match lhs {tuple(x.shape)} "
                    f"and {e} groups (transpose_rhs={transpose_rhs})")
        row_major = (x, y)
    else:
        if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
            return (f"tgmm takes lhs_t [K, M] and grad [M, N] (got "
                    f"{tuple(x.shape)}, {tuple(y.shape)})")
        k, n = x.shape[0], y.shape[1]
        if not x.t().is_contiguous():
            return ("tgmm takes lhs_t as the transpose of a contiguous [M, K] "
                    "tensor (lhs.t())")
        row_major = (x.t(), y)
    if k <= 0 or n <= 0 or k % 8 or n % 8:
        return f"K and N must be positive multiples of 8 (got K={k}, N={n})"
    for t in row_major:
        if not t.is_contiguous():
            return "the kernels take contiguous operands"
        if t.data_ptr() % 16:
            return "the kernels take 16-byte aligned operands"
    dev = x.device
    if dev.type != "cuda":
        return f"the kernels run on CUDA devices only (got {dev})"
    for name, t in (("the second operand", y), ("group_sizes", group_sizes)):
        if t.device != dev:
            return f"{name} is on {t.device}, the first on {dev}"
    return None


def gmm(lhs, rhs, group_sizes, *, transpose_rhs: bool = False):
    """Grouped product [M, N] in lhs's dtype (module docstring).  CUDA
    tensors launch the kernel and raise on anything it does not take; CPU
    tensors run the plain version."""
    global gmm_launches, gmm_fp32_launches
    if lhs.device.type == "cpu":
        return gmm_reference(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs)
    why = kernel_refusal("gmm", lhs, rhs, group_sizes,
                         transpose_rhs=transpose_rhs)
    if why:
        raise ValueError(f"gmm: {why}")
    m, k = lhs.shape
    e = rhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    lib, entry, _ = _library(lhs.dtype)
    code = entry(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        m, k, n, e, int(bool(transpose_rhs)),
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _build.check(lib, code, "gmm")
    if lhs.dtype == torch.float32:
        gmm_fp32_launches += 1
    else:
        gmm_launches += 1
    return out


def tgmm(lhs_t, grad, group_sizes):
    """Transposed grouped product [E, K, N] in grad's dtype: the weight
    gradient of ``gmm``.  CUDA tensors launch the kernel (lhs_t must be
    ``lhs.t()`` of a contiguous lhs) and raise on anything it does not
    take; CPU tensors run the plain version."""
    global tgmm_launches, tgmm_fp32_launches
    if lhs_t.device.type == "cpu":
        return tgmm_reference(lhs_t, grad, group_sizes)
    why = kernel_refusal("tgmm", lhs_t, grad, group_sizes)
    if why:
        raise ValueError(f"tgmm: {why}")
    k, m = lhs_t.shape
    n = grad.shape[1]
    e = group_sizes.shape[0]
    out = torch.empty((e, k, n), dtype=grad.dtype, device=grad.device)
    lib, _, entry = _library(grad.dtype)
    code = entry(
        lhs_t.data_ptr(), grad.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, e,
        torch.cuda.current_stream(grad.device).cuda_stream)
    _build.check(lib, code, "tgmm")
    if grad.dtype == torch.float32:
        tgmm_fp32_launches += 1
    else:
        tgmm_launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """``megablox.ops.gmm``'s custom VJP: the forward is ``gmm``; the
    backward ``gmm(grad, rhs, transpose_rhs=True)`` for dlhs (in lhs's
    dtype) and ``tgmm(lhs^T, grad)`` for drhs (in rhs's dtype)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(grad, rhs, group_sizes, transpose_rhs=True).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs.t(), grad, group_sizes).to(rhs.dtype)
        return dlhs, drhs, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Differentiable ``gmm(lhs, rhs, group_sizes)`` (the port's
    ``megablox.ops.gmm``): lhs [M, K], rhs [E, K, N] -> [M, N]."""
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)
