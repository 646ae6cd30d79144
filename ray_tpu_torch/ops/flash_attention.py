"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper, their plain PyTorch versions, and the autograd Function that joins
them.

Replaces the Pallas TPU kernels ``ray_tpu/ops/flash_attention.py``
``_fwd_kernel`` (through ``_flash_fwd``) and ``_bwd_kernel`` (through
``_flash_bwd`` and the ``_make_flash`` custom VJP).  The port's bf16
kernels are ``csrc/flash_attention.cu`` (head_dim 128) and
``csrc/flash_attention_d256.cu`` (head_dim 256), built for Hopper.  At
head_dim 128 a producer warpgroup feeds TMA loads of 128-byte-swizzled
tiles through a 2-stage mbarrier ring, and two consumer warpgroups run
wgmma products (bf16 in, fp32 accumulate; P and dS stay in registers as
the A operand).  The forward, one block per
(q head, 128-row q tile), streams 128-key tiles up to the causal diagonal
with an fp32 online softmax; the backward is three launches without
atomics -- delta = rowsum(dO * O), dK/dV with one block per (kv head,
128-key tile) looping over the group's q heads and 64-row q tiles, dQ with
one block per (q head, 128-row q tile) over 64-key tiles.  At head_dim
256 the same products on other tiles (a 128-row tile is 64 KB there), in
blocks of two computing warpgroups, one thread of which also issues the
loads (a third warpgroup would leave ptxas 168 registers a thread): the
forward streams 64-key tiles; dK/dV takes 64-key tiles, one warpgroup
forming S^T, the other dP^T, swapped through shared memory, each
accumulating half of dK's and dV's columns; dQ streams 64-key tiles, K in
two stages and V in one.  All outputs are bf16, each one rounding of an
fp32 sum.

What bounds them on the H100: operations.  At the training shapes the
forward's 1.375e11 flops take 0.139 ms at the 989 TFLOP/s bf16 peak and
its bytes 0.06 ms; the backward's five products 0.348 ms against 0.12 ms
of bytes (the dQ kernel recomputes S and dP: seven products run).  At
head_dim 256 (phase 6's [8, 2048], 16 q over 8 kv heads) 0.278 ms against
0.12 ms forward, 0.695 ms against 0.24 ms backward.

Layout, as the JAX wrappers: ``flash_attention`` takes q [B, S, Hq, D] and
k/v [B, S, Hkv, D]; the kernels take q3 [B*Hq, S, D] and k3/v3
[B*Hkv, S, D], the kv head of q head bh being bh // n_rep.  The LSE is
[B*Hq, S] fp32 (the TPU kernel's 128 lane copies are dropped).

``flash_attention_fwd`` / ``flash_attention_bwd`` launch the kernels for
CUDA tensors and raise on anything they do not take; they run the plain
versions only when their tensors lie on the CPU.  ``fwd_launches`` and
``bwd_launches`` count kernel launches (one backward call = one count).  A
forward call made while its stream is being captured into a CUDA graph
(the static engine's prefill programs) launches nothing: it adds to
``captured`` (by instantiation) instead, and whoever replays the graph
books the capture's counts on every replay (``count_replayed``).

The fp32 instantiations the JAX package's gate can ask for -- head_dim
128 and 256 (Llama-3-8B and Mixtral at ``compute_dtype=float32``) --
launch the FFMA kernel family of ``csrc/flash_attention_ffma.cu`` (every
product by FFMA, the same algorithm and rounding points; both directions
on register tiles fed by 16-byte shared-memory loads against 32-row tiles
streamed two stages deep: the forward with 128 (D 128) or 64 (D 256)
query rows resident, the backward with 64 or 32 resident rows, dK/dV per
q head with each group's shares summed in a fourth pass); what bounds them is the 67
TFLOP/s FFMA peak.  ``launches`` counts every instantiation's [forward, backward]
launches by name (``INSTANTIATIONS``); ``fwd_launches``/``bwd_launches``
stay B2/B3's (the head_dim-128 wgmma pair, "bf16_d128").

Under the "attn" remat policy (``keep_outputs_contexts``) a layer's
recompute takes the forward's O and LSE back instead of launching the
forward kernel again.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.ops import _build

# the kernels by (dtype, head_dim): the wgmma pairs (bf16) and the FFMA
# family (fp32, csrc/flash_attention_ffma.cu); the plain versions take any
INSTANTIATIONS = {
    (torch.bfloat16, 128): "bf16_d128",
    (torch.float32, 128): "fp32_d128",
    (torch.float32, 256): "fp32_d256",
    (torch.bfloat16, 256): "bf16_d256",
}
HEAD_DIMS = tuple(sorted({d for _, d in INSTANTIATIONS}))
# the wgmma pairs' sources (csrc/<name>.cu), whose C entries are the same
_WGMMA = {"bf16_d128": "flash_attention", "bf16_d256": "flash_attention_d256"}

# kernel launches since import (or since a caller last reset them); CPU
# calls of the plain versions do not count.  fwd/bwd_launches: B2/B3's
# (bf16_d128); launches: every instantiation's [forward, backward]
fwd_launches = 0
bwd_launches = 0
launches = {name: [0, 0] for name in INSTANTIATIONS.values()}
# forward calls recorded into CUDA graphs, by instantiation (each replay
# launches them again)
captured = {name: 0 for name in INSTANTIATIONS.values()}
SEQ_MULTIPLE = 128  # the kernels' q and key tiles
_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)

_libs: dict = {}  # loaded wgmma libraries by source
_ffma_lib: Optional[ctypes.CDLL] = None


def _scale_log2(scale: float) -> float:
    """softmax scale * log2(e), rounded to fp32 once: the kernels and the
    plain versions scale the scores by the same fp32 number."""
    return float(np.float32(scale) * np.float32(_LOG2E))


def _scores_log2(q3, k3, scale, causal, n_rep):
    """fp32 scores in log2 units [BHq, S, S], masked (k > q) to -inf."""
    kf = k3.float().repeat_interleave(n_rep, 0)
    s2 = torch.matmul(q3.float(), kf.transpose(1, 2)) * _scale_log2(scale)
    if causal:
        s = s2.shape[-1]
        above = torch.ones((s, s), dtype=torch.bool, device=s2.device).triu(1)
        s2 = s2.masked_fill(above, float("-inf"))
    return s2


def flash_attention_fwd_reference(q3, k3, v3, *, scale, causal, n_rep):
    """Plain version of the forward kernel (same signature and result):
    (O [BHq, S, D] in q's dtype, LSE [BHq, S] fp32).

    The kernel's arithmetic: fp32 scores, shifted by the row's max in log2
    units rounded up to an integer; exponentials rounded to v's dtype for
    the PV product (accumulated in fp32) and summed unrounded for the
    normaliser.  The kernel's running shifts differ from this one by exact
    powers of two, so both round the same values; at fp32 every cast is a
    no-op and this is the TPU kernel's softmax."""
    s2 = _scores_log2(q3, k3, scale, causal, n_rep)
    m = torch.ceil(s2.amax(-1, keepdim=True))
    p = torch.exp2(s2 - m)
    del s2
    l = p.sum(-1, keepdim=True)
    vf = v3.float().repeat_interleave(n_rep, 0)
    o = torch.matmul(p.to(v3.dtype).float(), vf) / l
    lse = (m + torch.log2(l))[..., 0] * _LN2
    return o.to(q3.dtype), lse


def _probs(q3, k3, lse, scale, causal, n_rep):
    """P [BHq, S, S] fp32 from the saved LSE (0 where masked)."""
    s2 = _scores_log2(q3, k3, scale, causal, n_rep)
    return torch.exp2(s2 - (lse * _LOG2E)[..., None])


def flash_attention_bwd_reference(q3, k3, v3, o, lse, do, *, scale, causal,
                                  n_rep):
    """Plain version of the backward kernels (same signature and result):
    (dq [BHq, S, D], dk, dv [BHkv, S, D]) in the dtypes of q, k and v.

    The TPU kernel's arithmetic: delta = rowsum(dO * O); P from the saved
    LSE in fp32; dV = P^T dO; dP = dO V^T; dS = P (dP - delta) * scale,
    rounded to the input dtype before dQ = dS K and dK = dS^T Q.  One more
    rounding than the TPU kernel, because the CUDA kernel takes dV's
    product on the tensor cores: P rounded to v's dtype before P^T dO.
    Each gradient is summed in fp32 (dK and dV over the group's q heads)
    and rounded to its input's dtype once at the end, as the kernels write
    them (a no-op at fp32)."""
    bhq, s, d = q3.shape
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    p = _probs(q3, k3, lse, scale, causal, n_rep)
    dv = torch.matmul(p.to(v3.dtype).float().transpose(1, 2), dof)
    vf = v3.float().repeat_interleave(n_rep, 0)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta) * scale
    del p
    kf = k3.float().repeat_interleave(n_rep, 0)
    dq = torch.matmul(ds.to(k3.dtype).float(), kf)
    dk = torch.matmul(ds.to(q3.dtype).float().transpose(1, 2), q3.float())
    bhkv = bhq // n_rep
    return (dq.to(q3.dtype), dk.view(bhkv, n_rep, s, d).sum(1).to(k3.dtype),
            dv.view(bhkv, n_rep, s, d).sum(1).to(v3.dtype))


def _spread(x, y):
    """sqrt(sum_j (x_ij y_jd)^2): [BH, S, S] x [BH, S, D] -> [BH, S, D]."""
    return torch.matmul(x.square(), y.square()).sqrt()


def kernel_tolerance(q3, k3, v3, o, lse, do, *, scale, causal, n_rep):
    """Per-element bounds on |kernel - plain version|: {"o", "lse", "dq",
    "dk", "dv"}, fp32 tensors of the outputs' shapes.  ``o``/``lse`` are
    the plain forward's outputs.  fp32 inputs take ``_fp32_tolerance``;
    bf16 inputs the bounds below.

    Both round the same values to bf16, but fp32 summation order may carry
    one across a rounding boundary; such a flip moves it by at most one
    ulp, 2**-7 of itself, independently of the others.  Where a product
    sums rounded terms r(x_i) y_i, its spread is then 2**-7 *
    sqrt(sum_i (x_i y_i)**2), and the bound is four times that: for O over
    the exponentials (as B1's), for dV over P, for dQ and dK over dS.  O,
    dQ, dK and dV add one ulp of the plain value (their own rounding to
    bf16 may then fall on the other side), dQ and dK 2**-16 of
    the spread of dS's fp32 terms (dP - delta cancels; 4 * 2**-24 * sqrt(D)
    < 2**-16), the LSE 1e-5 relative.  Every bound shrinks with the span
    where a fixed atol would not, so a kernel that drops one key of a
    2048-token row still fails it."""
    if q3.dtype == torch.float32:
        return _fp32_tolerance(q3, k3, v3, o, lse, do, scale=scale,
                               causal=causal, n_rep=n_rep)
    ulp = 2.0 ** -7
    plain = flash_attention_bwd_reference(q3, k3, v3, o, lse, do, scale=scale,
                                          causal=causal, n_rep=n_rep)
    own = {n: ulp * g.float().abs() for n, g in zip(("dq", "dk", "dv"), plain)}
    del plain
    p = _probs(q3, k3, lse, scale, causal, n_rep)
    vf = v3.float().repeat_interleave(n_rep, 0)
    kf = k3.float().repeat_interleave(n_rep, 0)
    dof = do.float()
    tol_o = 4 * ulp * _spread(p, vf) + ulp * o.float().abs() + 1e-6
    tol_dv = 4 * ulp * _spread(p.transpose(1, 2), dof)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(1, 2))
    ds = p * (dp - delta) * scale
    err = p * (dp.abs() + delta.abs()) * abs(scale)
    del p, dp
    tol_dq = (4 * ulp * _spread(ds, kf) + 2.0 ** -16 * _spread(err, kf)
              + own["dq"] + 1e-6)
    dst, errt = ds.transpose(1, 2), err.transpose(1, 2)
    qf = q3.float()
    tol_dk = 4 * ulp * _spread(dst, qf) + 2.0 ** -16 * _spread(errt, qf)
    bhq, s, d = q3.shape
    bhkv = bhq // n_rep

    def group(t):  # squares of independent spreads add over the group
        return t.square().view(bhkv, n_rep, s, d).sum(1).sqrt() + 1e-6

    return {"o": tol_o, "lse": 1e-5 * (1 + lse.abs()), "dq": tol_dq,
            "dk": group(tol_dk) + own["dk"], "dv": group(tol_dv) + own["dv"]}


def _fp32_tolerance(q3, k3, v3, o, lse, do, *, scale, causal, n_rep):
    """``kernel_tolerance`` for fp32 inputs, where nothing is rounded to a
    narrower type and the two differ only in the order of fp32 sums.

    With u = 2**-24: a sum of n terms taken in another order moves by about
    u * sqrt(n) times its terms' absolute sum; four times that is the
    bound for O (over S keys, with the absolute sum P|V| + |O|) and for dV,
    dQ and dK.  A score carries 4u of its terms' absolute sum (|Q| |K|^T in
    log2 units), so each exponential carries a relative r = ln2 * that +
    4u (exp2 itself), which reaches O as (P r) |V| + rowsum(P r) |O| and the
    LSE as rowsum(P r); dP and delta carry 4u of |dO| |V|^T and rowsum|dO
    O|, and dS their sum times P and the scale, plus |dS| r.  Each bound
    grows with an absolute sum, not a fixed atol, so the one key a kernel
    drops at the end of a 2048-token row (1/2048 of O's terms) still
    breaks it."""
    u = 2.0 ** -24
    bhq, s, d = q3.shape
    bhkv = bhq // n_rep
    sl = abs(_scale_log2(scale))
    rs = 4 * u * math.sqrt(s)
    kf = k3.float().repeat_interleave(n_rep, 0)
    vf = v3.float().repeat_interleave(n_rep, 0)
    qf, dof, of = q3.float(), do.float(), o.float()
    p = _probs(q3, k3, lse, scale, causal, n_rep)
    r = _LN2 * 4 * u * sl * torch.matmul(qf.abs(), kf.abs().transpose(1, 2)) + 4 * u
    pr = p * r
    av, ao = vf.abs(), of.abs()
    tol_o = (torch.matmul(pr, av) + pr.sum(-1, keepdim=True) * ao
             + rs * (torch.matmul(p, av) + ao) + 2 * u * ao + 1e-30)
    tol_lse = pr.sum(-1) + rs + 2 * u * lse.abs()
    tol_dv = torch.matmul(pr.transpose(1, 2), dof.abs()) + rs * torch.matmul(
        p.transpose(1, 2), dof.abs())
    del pr
    delta = (dof * of).sum(-1, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(1, 2))
    ds = p * (dp - delta) * scale
    del dp
    e_dp = 4 * u * (torch.matmul(dof.abs(), av.transpose(1, 2))
                    + (dof * of).abs().sum(-1, keepdim=True))
    err = ds.abs() * r + p * e_dp * abs(scale)
    del p, r, e_dp
    ads = ds.abs()
    del ds
    tol_dq = torch.matmul(err, kf.abs()) + rs * torch.matmul(ads, kf.abs())
    tol_dk = (torch.matmul(err.transpose(1, 2), qf.abs())
              + rs * torch.matmul(ads.transpose(1, 2), qf.abs()))

    def group(t):  # the group's q heads add their bounds
        return t.view(bhkv, n_rep, s, d).sum(1) + 1e-30

    return {"o": tol_o, "lse": tol_lse, "dq": tol_dq + 1e-30,
            "dk": group(tol_dk), "dv": group(tol_dv)}


def _library(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = _build.library(source)
        lib.flash_attention_fwd_bf16.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_void_p])
        lib.flash_attention_fwd_bf16.restype = ctypes.c_int
        lib.flash_attention_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
            + [ctypes.c_void_p])
        lib.flash_attention_bwd_bf16.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def _ffma_library() -> ctypes.CDLL:
    global _ffma_lib
    if _ffma_lib is None:
        lib = _build.library("flash_attention_ffma")
        lib.flash_ffma_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float] + [ctypes.c_void_p])
        lib.flash_ffma_fwd.restype = ctypes.c_int
        lib.flash_ffma_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.flash_ffma_bwd.restype = ctypes.c_int
        _ffma_lib = lib
    return _ffma_lib


def instantiation(dtype, head_dim) -> Optional[str]:
    """The kernel that takes (dtype, head_dim), by name, or None."""
    return INSTANTIATIONS.get((dtype, head_dim))


def kernel_refusal(q3, k3, v3, *extra) -> Optional[str]:
    """Why the CUDA kernels cannot take these [BH, S, D] tensors (``extra``:
    more [BHq, S, D] inputs of q's dtype, such as O and dO), or None when
    they can."""
    dev = q3.device
    if dev.type != "cuda":
        return f"the kernels run on CUDA devices only (got {dev})"
    for name, t in (("k", k3), ("v", v3), *((f"input {i + 3}", t)
                                            for i, t in enumerate(extra))):
        if t.device != dev:
            return f"{name} is on {t.device}, q on {dev}"
    if q3.dim() != 3 or k3.dim() != 3 or k3.shape != v3.shape:
        return (f"q3 must be [BHq, S, D] and k3/v3 [BHkv, S, D] of one shape "
                f"(got {tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)})")
    bhq, s, d = q3.shape
    bhkv = k3.shape[0]
    if k3.shape[1:] != q3.shape[1:] or bhkv == 0 or bhq % bhkv:
        return (f"k3/v3 {tuple(k3.shape)} do not match q3 {tuple(q3.shape)} "
                f"(same S and D, BHq a multiple of BHkv)")
    for t in extra:
        if t.shape != q3.shape:
            return f"an input of shape {tuple(t.shape)} is not q3's {tuple(q3.shape)}"
    if d not in HEAD_DIMS or s % SEQ_MULTIPLE or s == 0:
        return (f"no kernel for head_dim {d} and sequence {s} (head_dims "
                f"{HEAD_DIMS}, sequence a multiple of {SEQ_MULTIPLE})")
    if instantiation(q3.dtype, d) is None:
        return (f"no kernel for {q3.dtype} at head_dim {d} (built: "
                f"{sorted(INSTANTIATIONS.values())})")
    for t in (q3, k3, v3, *extra):
        if t.dtype != q3.dtype:
            return f"the kernels take inputs of one dtype (got {t.dtype}, q {q3.dtype})"
        if not t.is_contiguous():
            return "the kernels take contiguous inputs"
        if t.data_ptr() % 16:  # TMA's rule
            return "the kernels take 16-byte aligned inputs"
    return None


def flash_attention_fwd(q3, k3, v3, *, scale, causal, n_rep):
    """Forward kernel: (O [BHq, S, D] in q's dtype, LSE [BHq, S] fp32).
    CUDA tensors launch the kernel and raise on anything it does not take;
    CPU tensors run the plain version."""
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, scale=scale,
                                             causal=causal, n_rep=n_rep)
    why = kernel_refusal(q3, k3, v3)
    if why is None and q3.shape[0] != n_rep * k3.shape[0]:
        why = f"n_rep {n_rep} does not give {q3.shape[0]} q heads"
    if why:
        raise ValueError(f"flash_attention_fwd: {why}")
    bhq, s, d = q3.shape
    name = instantiation(q3.dtype, d)
    o = torch.empty_like(q3)
    lse = torch.empty((bhq, s), dtype=torch.float32, device=q3.device)
    args = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bhq, k3.shape[0], s, d, int(bool(causal)),
            _scale_log2(scale),
            torch.cuda.current_stream(q3.device).cuda_stream)
    if name in _WGMMA:
        lib = _library(_WGMMA[name])
        code = lib.flash_attention_fwd_bf16(*args)
    else:
        lib = _ffma_library()
        code = lib.flash_ffma_fwd(*args)
    _build.check(lib, code, f"flash_attention_fwd ({name})")
    _count_fwd(name)
    return o, lse



def _count_fwd(name: str) -> None:
    """One forward call of instantiation ``name``: a launch, or a call
    recorded into a graph."""
    global fwd_launches
    if torch.cuda.is_current_stream_capturing():
        captured[name] += 1
    else:
        launches[name][0] += 1
        if name == "bf16_d128":
            fwd_launches += 1


def count_replayed(counts: dict) -> None:
    """Book the forward launches one replay of a captured graph made:
    ``counts`` {instantiation: calls captured}."""
    global fwd_launches
    for name, n in counts.items():
        launches[name][0] += n
        if name == "bf16_d128":
            fwd_launches += n


def flash_attention_bwd(q3, k3, v3, o, lse, do, *, scale, causal, n_rep):
    """Backward kernels: (dq [BHq, S, D], dk, dv [BHkv, S, D]) in the
    inputs' dtype.  CUDA tensors launch the kernels (delta, dK/dV, dQ: one count) and raise
    on anything they do not take; CPU tensors run the plain version."""
    global bwd_launches
    if q3.device.type == "cpu":
        return flash_attention_bwd_reference(q3, k3, v3, o, lse, do,
                                             scale=scale, causal=causal,
                                             n_rep=n_rep)
    why = kernel_refusal(q3, k3, v3, o, do)
    if why is None and q3.shape[0] != n_rep * k3.shape[0]:
        why = f"n_rep {n_rep} does not give {q3.shape[0]} q heads"
    if why is None and (lse.dtype != torch.float32 or lse.device != q3.device
                        or tuple(lse.shape) != tuple(q3.shape[:2])
                        or not lse.is_contiguous() or lse.data_ptr() % 16):
        why = ("lse must be a contiguous, 16-byte aligned fp32 [BHq, S] "
               "tensor on q's device")
    if why:
        raise ValueError(f"flash_attention_bwd: {why}")
    bhq, s, d = q3.shape
    dev = q3.device
    name = instantiation(q3.dtype, d)
    scratch = bhq * s  # delta
    if name not in _WGMMA and bhq != k3.shape[0]:
        scratch += 2 * bhq * s * d  # the FFMA dK/dV kernel's per-q-head shares
    delta = torch.empty(scratch, dtype=torch.float32, device=dev)
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    args = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bhq, k3.shape[0], s, d,
            int(bool(causal)), float(scale), _scale_log2(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if name in _WGMMA:
        lib = _library(_WGMMA[name])
        code = lib.flash_attention_bwd_bf16(*args)
    else:
        lib = _ffma_library()
        code = lib.flash_ffma_bwd(*args)
    _build.check(lib, code, f"flash_attention_bwd ({name})")
    launches[name][1] += 1
    if name == "bf16_d128":
        bwd_launches += 1
    return dq, dk, dv


# the "attn" remat policy's store for the calling thread: while a layer's
# forward runs, each forward call's (O, LSE) is kept; while its recompute
# runs, the calls take them back in order and launch nothing
_kept = threading.local()


class _Keep:
    def __init__(self):
        self.outputs = []
        self.cursor = 0

    @contextlib.contextmanager
    def _active(self, replay: bool):
        prev = getattr(_kept, "store", None), getattr(_kept, "replay", False)
        self.cursor = 0
        _kept.store, _kept.replay = self, replay
        try:
            yield
        finally:
            _kept.store, _kept.replay = prev

    def forward_context(self):
        return self._active(False)

    def recompute_context(self):
        return self._active(True)


def keep_outputs_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for the "attn" remat
    policy: (forward context, recompute context).  The checkpointed
    layer's flash forward calls keep their O and LSE; its recompute reuses
    them, so the backward pass launches no forward kernel.  Values are
    those a recompute would give (the forward kernel repeats bit for bit),
    so the gradients equal the "full" policy's."""
    keep = _Keep()
    return keep.forward_context(), keep.recompute_context()


def _forward_or_kept(q3, k3, v3, scale, causal, n_rep):
    keep = getattr(_kept, "store", None)
    if keep is not None and _kept.replay:
        o, lse = keep.outputs[keep.cursor]
        keep.cursor += 1
        return o.detach(), lse
    o, lse = flash_attention_fwd(q3, k3, v3, scale=scale, causal=causal,
                                 n_rep=n_rep)
    if keep is not None:
        keep.outputs.append((o.detach(), lse))
    return o, lse


class _Flash(torch.autograd.Function):
    """The ``_make_flash`` custom VJP: the forward kernel saves (q, k, v,
    O, LSE); the backward kernels return dq/dk/dv in the input dtypes."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal, n_rep):
        o, lse = _forward_or_kept(q3, k3, v3, scale, causal, n_rep)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.args = (scale, causal, n_rep)
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        scale, causal, n_rep = ctx.args
        dq, dk, dv = flash_attention_bwd(q3, k3, v3, o, lse, do.contiguous(),
                                         scale=scale, causal=causal,
                                         n_rep=n_rep)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Flash attention. q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> [B, S, Hq, D].

    Requires S divisible by the block sizes (blocks are clipped to S
    first), as the JAX function does; ``block_q``/``block_k`` are the TPU
    kernel's tiles and are checked, not used: the CUDA kernels tile by 128
    and 64.  Differentiable through the backward kernels."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    if scale is None:
        scale = d ** -0.5
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq len {s} must be divisible by block sizes ({block_q}, {block_k})")
    # [B, S, H, D] -> [B*H, S, D] with heads-major layout, contiguous (at
    # B = 1 a reshape alone would return a strided view)
    q3 = q.transpose(1, 2).contiguous().view(b * hq, s, d)
    k3 = k.transpose(1, 2).contiguous().view(b * hkv, s, d)
    v3 = v.transpose(1, 2).contiguous().view(b * hkv, s, d)
    o = _Flash.apply(q3, k3, v3, float(scale), bool(causal), n_rep)
    return o.view(b, hq, s, d).transpose(1, 2)
