"""Block-quantized int8 gradient codec, and gradient compression inside the
training step (port of ``ray_tpu/util/collective/compression.py``).

Three parts:
  - a copy of the JAX package's numpy side (``CompressionSpec``,
    ``resolve_spec``, the planner's ``Plan`` and ``choose_plan``, the
    numpy codec ``quantize_blocks``/``dequantize_blocks``, wire and error
    accounting, ``ErrorFeedbackStore``/``ef_quantize`` and ``OpStats``):
    the port imports nothing of ``ray_tpu``, so it keeps its own, and
    tests/test_torch_grad_compression.py and
    tests/test_torch_collective_copies.py hold it to the original (the
    collective groups and the tensor channel run it);
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
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.parallel.optim import SLICE, EmptyState, flat_slices

SCHEME_NONE = "none"
SCHEME_INT8 = "int8"
_SCHEMES = (SCHEME_NONE, SCHEME_INT8)

ALG_FLAT = "flat"
ALG_HIERARCHICAL = "hierarchical"
ALG_RING = "ring"            # bandwidth-optimal reduce-scatter + allgather
ALG_TREE = "tree"            # recursive halving-doubling (pow2 worlds)

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


@dataclasses.dataclass(frozen=True)
class Plan:
    """The planner's verdict for ONE collective call."""

    algorithm: str                       # flat | ring | tree | hierarchical
    scheme: str                          # none | int8
    slice_size: int = 1                  # members per slice when hierarchical
    spec: Optional[CompressionSpec] = None
    reason: str = ""                     # why the planner picked this

    @property
    def is_stock(self) -> bool:
        """True when the op should take the exact pre-compression code path."""
        return self.algorithm == ALG_FLAT and self.scheme == SCHEME_NONE


_STOCK_PLAN = Plan(ALG_FLAT, SCHEME_NONE)


def choose_plan(nbytes: int, world_size: int,
                spec: Optional[CompressionSpec], *,
                num_slices: int = 1, topology=None) -> Plan:
    """Message-size + topology selection, delegated to the planner
    (``util/collective/planner.py`` — TACCL-flavored α-β cost model over
    an explicit topology descriptor).

    - no spec, or payload under ``min_bytes``: flat + uncompressed (the
      stock path, byte-identical to compression-off).
    - hierarchical when the spec forces a valid slice_size, or when auto
      and the topology's domains form aligned contiguous blocks; a
      multi-domain topology whose domains CANNOT be slice-aligned refuses
      the hierarchy (reason ``unaligned_slices``) instead of guessing.
    - ring / tree for large lossless payloads per the link-class cost
      model; quantization per the spec's scheme (large SUM payloads only;
      the op check lives in the backend, which falls back for non-SUM).

    ``topology`` is the explicit descriptor backends build from device /
    node metadata; ``num_slices`` remains as the metadata-only fallback
    (contiguous equal slices assumed — exactly what it meant before).
    """
    from ray_tpu_torch.util.collective import planner as _planner

    if topology is None:
        if num_slices > 1 and world_size % num_slices == 0:
            ss = world_size // num_slices
            topology = _planner.Topology.from_slice_ids(
                tuple(r // ss for r in range(world_size)))
        elif num_slices > 1:
            # uneven domain report with no real descriptor: refuse the
            # hierarchy downstream rather than invent a slice boundary
            topology = _planner.Topology.from_slice_ids(
                tuple(min(r, num_slices - 1) for r in range(world_size)))
        else:
            topology = _planner.Topology.flat(world_size)
    return _planner.plan_allreduce(nbytes, topology, spec)


def is_float_dtype(dtype) -> bool:
    """Float check that also recognizes the ml_dtypes extension floats
    (bfloat16, float8_*) numpy reports as kind 'V' — bf16 gradients are
    the codec's primary customer — and foreign dtype objects like
    torch.float32.  None (no dtype metadata, e.g. a plain list) is NOT
    float: np.dtype(None) would default to float64 and lossily quantize
    values the caller never put in an array."""
    if dtype is None:
        return False
    try:
        dt = np.dtype(dtype)
    except TypeError:
        return "float" in str(dtype)  # torch.float32, tf.float32, ...
    if np.issubdtype(dt, np.floating):
        return True
    return "float" in dt.name  # bfloat16, float8_e4m3fn, ... via ml_dtypes


def estimate_wire_bytes(algorithm: str, scheme: str, logical_bytes: int,
                        world_size: int, slice_size: int = 1,
                        block_size: int = DEFAULT_BLOCK_SIZE
                        ) -> Tuple[int, int]:
    """(total_wire, inter_slice) per-rank byte model for an f32 payload —
    the ONE formula the benchmarks and the XLA backend's OpStats share, so
    bench rows and recorded metrics can't drift apart.  int8 payload =
    codes (1 byte/elem) + scales (4 bytes per block); the flat two-phase
    algorithm re-sends its 1/world requantized shard in the allgather;
    hierarchical = full payload intra (reduce-scatter) + globally-reduced
    shard intra (allgather) + the 1/slice shard across the DCN boundary.
    Ignores the codec's tail-padding (exact figures come from
    wire_nbytes on the real arrays where available)."""
    def int8_bytes(nbytes: int) -> int:
        return nbytes // 4 + nbytes // block_size

    if algorithm == ALG_HIERARCHICAL:
        shard = logical_bytes // max(slice_size, 1)
        inter = int8_bytes(shard) if scheme == SCHEME_INT8 else shard
        return logical_bytes + shard + inter, inter
    if algorithm in (ALG_RING, ALG_TREE):
        # reduce-scatter + allgather decompositions (explicit ring, or
        # recursive halving-doubling): each rank moves (n-1)/n·S per
        # phase, twice — lossless, so the scheme never changes the volume
        w = max(world_size, 1)
        return 2 * (w - 1) * logical_bytes // w, 0
    if scheme == SCHEME_INT8:
        one = int8_bytes(logical_bytes)
        return one + one // max(world_size, 1), 0
    return logical_bytes, 0


def dtype_from_name(name: str) -> np.dtype:
    """Inverse of ``np.dtype(...).name`` that also resolves the ml_dtypes
    extension floats (plain ``np.dtype('bfloat16')`` raises unless the
    name is registered)."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))


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


def wire_nbytes(codes: np.ndarray, scales: np.ndarray) -> int:
    """Bytes this quantized payload puts on the wire (codes + scales)."""
    return int(codes.nbytes + scales.nbytes)


def relative_error(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """||x - x'|| / ||x|| (0 for an all-zero input) — the per-op quality
    figure recorded into the quant-error gauge."""
    x = np.asarray(original, dtype=np.float32).ravel()
    r = np.asarray(reconstructed, dtype=np.float32).ravel()
    norm = float(np.linalg.norm(x))
    if norm == 0.0:
        return 0.0
    return float(np.linalg.norm(x - r) / norm)


# ---------------------------------------------------------------------------
# Error feedback: per (group, op, shape, dtype) residual carried between
# rounds.  r_{t} = e_t - deQ(Q(e_t)) where e_t = x_t + r_{t-1}; the SGD-
# with-EF literature (and EQuARX's appendix) shows the accumulated error
# re-enters the average instead of being lost.
# ---------------------------------------------------------------------------


class ErrorFeedbackStore:
    """Process-local residual registry keyed per group/op/shape/dtype."""

    def __init__(self):
        self._residuals: Dict[Tuple, np.ndarray] = {}
        self._lock = threading.Lock()

    @staticmethod
    def key(group_name: str, op: str, arr: np.ndarray) -> Tuple:
        return (group_name, op, tuple(arr.shape), str(arr.dtype))

    def fold(self, key: Tuple, flat: np.ndarray) -> np.ndarray:
        """input + carried residual (float32)."""
        with self._lock:
            r = self._residuals.get(key)
        e = flat.astype(np.float32, copy=True)
        if r is not None and r.shape == e.shape:
            e += r
        return e

    def update(self, key: Tuple, folded: np.ndarray, dequantized: np.ndarray):
        with self._lock:
            self._residuals[key] = (folded - dequantized).astype(np.float32)

    def get(self, key: Tuple) -> Optional[np.ndarray]:
        with self._lock:
            return self._residuals.get(key)

    def clear_group(self, group_name: str):
        with self._lock:
            for k in [k for k in self._residuals if k[0] == group_name]:
                del self._residuals[k]


error_feedback = ErrorFeedbackStore()


def ef_quantize(group_name: str, op: str, arr: np.ndarray,
                spec: CompressionSpec, pad_granule: Optional[int] = None):
    """The one fold-residual → quantize → dequantize → update-residual
    sequence every backend's quantized path runs (flat store, hierarchical
    store DCN phase, flat XLA): returns ``(codes, scales, deq, qerr)``
    where ``deq`` is the local round trip over the first ``arr.size``
    elements and ``qerr`` its relative L2 error.  ``pad_granule`` pads the
    folded payload before encoding (the XLA two-phase program needs rows
    divisible by world*block)."""
    flat = np.ascontiguousarray(arr).ravel()
    key = None
    if spec.error_feedback:
        key = error_feedback.key(group_name, op, arr)
        folded = error_feedback.fold(key, flat)
    else:
        folded = flat.astype(np.float32, copy=False)
    payload = pad_to_multiple(folded, pad_granule) if pad_granule else folded
    codes, scales = quantize_blocks(payload, spec.block_size)
    deq = dequantize_blocks(codes, scales, flat.size, spec.block_size)
    if key is not None:
        error_feedback.update(key, folded, deq)
    return codes, scales, deq, relative_error(folded, deq)


@dataclasses.dataclass
class OpStats:
    logical_bytes: int = 0          # payload at the API boundary
    wire_bytes: int = 0             # what actually crossed the transport
    algorithm: str = ALG_FLAT
    scheme: str = SCHEME_NONE
    quant_error: float = 0.0        # relative L2 of the local round trip
    inter_slice_bytes: int = 0      # DCN-phase share of wire_bytes (hier.)


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
