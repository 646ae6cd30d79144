"""Block-quantized int8 gradient codec, and gradient compression inside the
training step (port of ``ray_tpu/util/collective/compression.py``).

Three parts:
  - a copy of the JAX package's numpy codec (``CompressionSpec``,
    ``resolve_spec``, ``pad_to_multiple``, ``quantize_blocks``,
    ``dequantize_blocks``): the port imports nothing of ``ray_tpu``, so it
    keeps its own, and tests/test_torch_grad_compression.py holds it bit
    for bit to the original;
  - the torch codec (``torch_quantize_blocks``/``torch_dequantize_blocks``,
    the twins of ``jnp_quantize_blocks``/``jnp_dequantize_blocks``), bit
    for bit the numpy codec's on either device: scales are maxabs / 127 in
    fp32 (a true division, also on the card), codes round half to even
    (``torch.round``, as ``np.rint``), a zero block has scale 0 and codes 0;
  - ``compress_gradients``, the twin of the optax transform that
    ``make_train_step(grad_compression=...)`` chains before the optimizer.

Quantization is lossy: it models the compressed gradient sync of a
data-parallel step.  The codec is plain PyTorch, which XLA fuses on the
TPU and eager PyTorch runs as separate kernels (a fused pass is ROADMAP
B6).  A CUDA tensor is coded on the card, never on the host.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.parallel.optim import SLICE, EmptyState, flat_slices

SCHEME_NONE = "none"
SCHEME_INT8 = "int8"
_SCHEMES = (SCHEME_NONE, SCHEME_INT8)

DEFAULT_BLOCK_SIZE = 256
# below this the op is latency-bound: int8 would save microseconds of wire
# at the cost of a quantize/dequantize pass and quality — stay flat bf16
DEFAULT_MIN_BYTES = 64 * 1024


# ---------------------------------------------------------------------------
# The numpy codec: a copy of the JAX package's (held to it by a parity test)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """User-facing knob set.

    scheme:         "int8" (block-quantized) or "none" (algorithm-only —
                    e.g. hierarchical routing without quantization).
    block_size:     elements per scale block (EQuARX-style).
    min_bytes:      messages smaller than this stay flat/uncompressed.
    error_feedback: fold this round's quantization error into the next
                    round's input (per group/op/shape residual state).
    hierarchical:   True/False force; None = auto (used when the topology
                    reports >1 slice, or when ``slice_size`` is given).
    slice_size:     members per slice for the hierarchical algorithm
                    (None = infer from topology / don't go hierarchical).
    accum_dtype:    reduction accumulator dtype for the quantized XLA
                    two-phase program ("bfloat16" per EQuARX; "float32"
                    when quality headroom matters more than speed).
    """

    scheme: str = SCHEME_INT8
    block_size: int = DEFAULT_BLOCK_SIZE
    min_bytes: int = DEFAULT_MIN_BYTES
    error_feedback: bool = False
    hierarchical: Optional[bool] = None
    slice_size: Optional[int] = None
    accum_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.scheme not in _SCHEMES:
            raise ValueError(
                f"unknown compression scheme {self.scheme!r}; one of {_SCHEMES}")
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {self.block_size}")
        if self.slice_size is not None and self.slice_size <= 0:
            raise ValueError(f"slice_size must be positive, got {self.slice_size}")


def resolve_spec(compression) -> Optional[CompressionSpec]:
    """Canonicalize the ``compression=`` argument.

    None -> None (disabled / inherit the group default upstream);
    "none" -> a spec that forces the stock path; "int8" -> defaults;
    dict -> CompressionSpec(**dict); CompressionSpec -> itself.
    """
    if compression is None:
        return None
    if isinstance(compression, CompressionSpec):
        return compression
    if isinstance(compression, str):
        if compression == SCHEME_NONE:
            return CompressionSpec(scheme=SCHEME_NONE, hierarchical=False)
        if compression == SCHEME_INT8:
            return CompressionSpec()
        raise ValueError(
            f"unknown compression {compression!r}; use 'int8', 'none', "
            "a dict of CompressionSpec fields, or a CompressionSpec")
    if isinstance(compression, dict):
        return CompressionSpec(**compression)
    raise TypeError(f"cannot interpret compression={compression!r}")


def pad_to_multiple(flat: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad a 1-D array up to a length multiple (codec/shard granule)."""
    rem = flat.size % multiple
    if rem == 0:
        return flat
    return np.concatenate([flat, np.zeros(multiple - rem, dtype=flat.dtype)])


def quantize_blocks(arr: np.ndarray,
                    block_size: int = DEFAULT_BLOCK_SIZE
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Block-wise symmetric int8: returns (codes [ceil(n/bs)*bs] int8,
    scales [nblocks] float32).  Zero blocks quantize to zero codes with a
    zero scale, so dequantization is exact there."""
    flat = np.ascontiguousarray(arr).ravel().astype(np.float32, copy=False)
    padded = pad_to_multiple(flat, block_size)
    blocks = padded.reshape(-1, block_size)
    maxabs = np.max(np.abs(blocks), axis=1)
    scales = (maxabs / 127.0).astype(np.float32)
    safe = np.where(scales > 0.0, scales, 1.0).astype(np.float32)
    codes = np.clip(np.rint(blocks / safe[:, None]), -127, 127).astype(np.int8)
    return codes.reshape(-1), scales


def dequantize_blocks(codes: np.ndarray, scales: np.ndarray, n: int,
                      block_size: int = DEFAULT_BLOCK_SIZE,
                      dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_blocks`; returns the first ``n`` elements."""
    blocks = codes.reshape(-1, block_size).astype(np.float32) * \
        scales[:, None].astype(np.float32)
    return blocks.reshape(-1)[:n].astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# The torch codec (the jnp codec's twin)
# ---------------------------------------------------------------------------


def torch_quantize_blocks(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE):
    """:func:`quantize_blocks` on a tensor, on its own device; ``x`` is
    flat with ``x.numel() % block_size == 0`` (pad first)."""
    blocks = x.reshape(-1, block_size).float()
    maxabs = blocks.abs().amax(dim=1)
    # a true division: PyTorch's CUDA kernels multiply by the reciprocal
    # when the divisor is a Python scalar, which rounds differently
    scales = maxabs / torch.full_like(maxabs, 127.0)
    safe = torch.where(scales > 0.0, scales, torch.ones_like(scales))
    codes = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127)
    return codes.to(torch.int8).reshape(-1), scales


def torch_dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor,
                            block_size: int = DEFAULT_BLOCK_SIZE,
                            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inverse of :func:`torch_quantize_blocks`: fp32 (or ``dtype``), flat."""
    blocks = codes.reshape(-1, block_size).float() * scales[:, None].float()
    out = blocks.reshape(-1)
    return out if dtype is None else out.to(dtype)


def _roundtrip(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """Quantize and dequantize a flat tensor: fp32, its own length (the
    last block zero-padded for the codec)."""
    n = flat.numel()
    padded = torch.nn.functional.pad(flat, (0, (-n) % block_size))
    codes, scales = torch_quantize_blocks(padded, block_size)
    return torch_dequantize_blocks(codes, scales, block_size)[:n]


# ---------------------------------------------------------------------------
# Gradient compression in the training step
# ---------------------------------------------------------------------------


class ResidualState(NamedTuple):
    """The error-feedback state (the JAX transform's ``_State``): an fp32
    residual shaped like the params."""
    residual: Any


@dataclasses.dataclass(frozen=True)
class GradientCompression:
    """``compress_gradients``'s transform as a description: the int8 block
    codec applied to each eligible gradient leaf (floating point, at least
    ``min_bytes``); others pass through."""
    spec: CompressionSpec

    def init(self, params):
        """optax's state: ``EmptyState()``, or ``ResidualState`` of fp32
        zeros with error feedback."""
        if self.spec.scheme == SCHEME_NONE or not self.spec.error_feedback:
            return EmptyState()
        return ResidualState(tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def eligible(self, g: torch.Tensor) -> bool:
        return (g.is_floating_point()
                and g.numel() * g.element_size() >= self.spec.min_bytes)

    @torch.no_grad()
    def update(self, grads: list, state) -> list:
        """The coded gradients (``tree_leaves`` order); the residual is
        updated in place."""
        if self.spec.scheme == SCHEME_NONE:
            return list(grads)
        bs = self.spec.block_size
        # whole blocks at a time: the same codes, the temporaries of one
        # slice alive
        size = max(SLICE // bs, 1) * bs
        residuals = (tree_leaves(state.residual) if self.spec.error_feedback
                     else [None] * len(grads))
        out = []
        for g, r in zip(grads, residuals):
            if not self.eligible(g):
                out.append(g)
                continue
            coded = torch.empty_like(g)
            for gs, cs, rs in zip(flat_slices(g.contiguous(), size),
                                  flat_slices(coded, size),
                                  flat_slices(r, size) if r is not None
                                  else itertools.repeat(None)):
                flat = gs if rs is None else gs.float() + rs
                back = _roundtrip(flat, bs)
                if rs is not None:
                    rs.copy_(flat - back)
                cs.copy_(back)
            out.append(coded)
        return out


def compress_gradients(compression="int8") -> GradientCompression:
    """The transform ``make_train_step(grad_compression=...)`` chains before
    the optimizer: "int8", "none", a dict of ``CompressionSpec`` fields or
    a ``CompressionSpec``."""
    spec = resolve_spec(compression)
    if spec is None:
        raise ValueError("compress_gradients needs a compression spec (got None)")
    return GradientCompression(spec)
