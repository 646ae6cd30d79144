"""Engine pieces shared by the port's engines, and the engine factory.

Port of the parts of ``ray_tpu/llm/engine.py`` the paged engine uses: the
per-slot sampling (greedy / temperature / top-k decided per row on the
device), the request record, and ``make_engine``.  The static engine
(``JaxLLMEngine``) is ROADMAP A3.

Device rule: an engine runs on ``"cuda"`` unless the caller passes
``device="cpu"``; without a GPU, the default raises instead of moving to
the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig

# stop-token ids travel to the device as a fixed-width padded row per slot
_MAX_STOP_IDS = 8
# top-k sampling cap: the kth threshold comes from a top-64, not a full
# [B, V] sort
_MAX_TOP_K = 64


@dataclasses.dataclass
class _Request:
    request_id: int
    prompt: List[int]
    gen: GenerationConfig
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int = -1
    error: Optional[str] = None


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, and CUDA without a
    GPU raises (the engine never quietly runs on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch engines run on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU explicitly")
    return dev


def _masked_scaled(logits, temps, top_ks):
    """Temperature-scaled, top-k-masked logits [B, V].  temps <= 0 rows
    divide by 1.0 (they are greedy and never read the scaled value)."""
    t = torch.where(temps > 0.0, temps, torch.ones_like(temps))[:, None]
    scaled = logits / t
    kmax = min(_MAX_TOP_K, logits.shape[-1])
    topv = torch.topk(scaled, kmax, dim=-1).values
    idx = (top_ks.long() - 1).clamp(0, kmax - 1)
    kth = torch.gather(topv, 1, idx[:, None])
    drop = (top_ks[:, None] > 0) & (scaled < kth)
    return scaled.masked_fill(drop, -1e30)


def _sample(logits, generator: torch.Generator, temps, top_ks):
    """Sample [B] int32 token ids from [B, V] fp32 logits with per-slot
    sampling params: temps [B] float32 (<= 0 -> greedy), top_ks [B] int32
    (<= 0 -> off).

    Greedy rows are the EXACT argmax of the raw logits (first index on
    ties, as in JAX).  Sampled rows draw by the Gumbel-max trick with
    uniforms from ``generator``, which lives on the logits' device -- no
    host round trip.  The numbers differ from JAX's PRNG: compare sampled
    rows by distribution, never by id."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    masked = _masked_scaled(logits, temps, top_ks)
    u = torch.rand(masked.shape, generator=generator, device=logits.device)
    sampled = (masked - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


def make_engine(config: LLMConfig, params=None, *, device=None,
                generator: Optional[torch.Generator] = None):
    """Engine factory: the paged engine (``kv_cache="paged"``, the
    default).  ``device`` defaults to CUDA; ``params`` None draws random
    weights from ``generator`` (default: seed 0 on ``device``)."""
    if config.kv_cache not in ("paged", "static"):
        raise ValueError(
            f"kv_cache must be 'paged' or 'static' (got {config.kv_cache!r})")
    from ray_tpu_torch.llm.paged import PagedTorchLLMEngine  # checks the rest

    return PagedTorchLLMEngine(config, params, device=device,
                               generator=generator)
