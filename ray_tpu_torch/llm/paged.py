"""Paged-KV LLM engine: block-table cache, chunked prefill, prefix caching.

Port of ``ray_tpu/llm/paged.py`` (``PagedJaxLLMEngine``) to PyTorch:

  - the KV cache is a POOL of fixed-size device blocks shared by every
    request (``models/llama.py init_paged_kv_cache``); a request's memory
    is proportional to its actual length, and admission is memory-based
  - the device sees a padded block TABLE [B, W] per decode chunk, W
    bucketed to the most blocks any active slot uses
  - long prompts prefill in ``prefill_chunk``-token pieces interleaved
    with decode chunks
  - full prompt blocks are chain-hashed and shared across requests
    (refcounted; matches capped at plen-1 so sampling always has a logit)
  - pool exhaustion preempts the youngest running request by RECOMPUTE

The host side (``BlockManager``, ``HostBlockCache``, the prefill planning
functions) is a copy of the JAX package's, kept here because the port
imports nothing of ``ray_tpu``; tests/test_torch_paged_engine.py and
tests/test_torch_paged_tiers.py hold both copies to the same sequences.  A decode chunk is ``decode_chunk`` token steps with stop
and budget handling on the device and no host sync inside, over loop state
the engine owns and updates in place.  On CUDA it runs as one CUDA graph
per table width W (the twin of the JAX engine's one jitted program per
(B, W) bucket; B is always ``max_batch``), captured at the width's first
use or ahead of serving by :meth:`PagedTorchLLMEngine.warmup`, and
replayed; the kernel ``ops/paged_attention`` carries decode attention.  On
the CPU the same function runs eagerly on the same buffers.  A chunk's
emitted ids travel to the host by a non-blocking copy and an event,
collected on the next step, so one chunk stays in flight while the host
books the previous one.  A prefill chunk is one program per pow2 chunk
width (the JAX engine's one jit per width), captured and replayed the
same way over static inputs the engine copies into before each replay:
the tokens [1, C], the fixed-width table, and p0, the sampled position,
temperature and top-k as device scalars, so no host value is frozen into
a graph; the draft's prefill likewise.

Tiered prefix cache: an HBM eviction of a hash-registered block demotes
its KV to ``HostBlockCache`` (host RAM, ``host_kv_cache_bytes``), by a
copy enqueued on the engine's stream behind any in-flight chunk; the host
tier's own LRU evictions spill into the object store
(``plasma_kv_cache_blocks`` blocks, best effort: only with a runtime
initialized).  A later prefix match that runs off the pool's chain
extends it through the host tier, then the store (promoting a store hit
back to host RAM), uploading each hit into a fresh pool block (an
in-place copy on the same stream) and re-registering it.
``export_request`` and ``import_request`` hand a live request's KV and
history to another engine (disaggregated prefill/decode, live
migration); an import into a speculative engine re-seeds the draft over
prompt + history.

With ``config.speculative_config`` set, decode is draft-model
speculative: each step a small draft model proposes k tokens per slot
(k+1 autoregressive single-token steps over its own block pool) and the
target verifies them in one window forward (``decode_window_paged``),
accepting by rejection sampling (``_spec_accept``).  Propose and verify
are two programs per table width, captured and replayed like the decode
chunk; a batch in which no slot speculates runs the plain chunk at k+1
steps.  The draft prefills each prompt beside the target, and draft-pool
exhaustion degrades a request to plain decode (zero drops).

Serving telemetry: assigning ``slo_label`` (the hosting deployment's
name) attaches an ``EngineTelemetry`` and books each request's SLO stages
(``queue_wait`` at first admission, ``prefill`` when its last chunk is
dispatched, ``decode`` from the first token to the last) into the serving
ledger; ``utilization`` then carries the rates, duty cycle and HBM split.
The prefix-cache and speculative metric families are booked on every
engine.  Nothing of it runs inside a captured program, and none of it
waits on the card.  Each CUDA-graph capture reports itself to the compile
watch.

Tensor parallelism (``tensor_parallel_size = N``, or a caller's mesh in
``config.mesh``): one logical engine over N ranks, one process per card
(``llm/tp.py``).  The host side stays one copy, on rank 0: the block
manager, admission, the prefix cache and its tiers, scheduling.  Weights
and pool shard over "tensor" (``models/llama.py inference_param_specs``,
``paged_kv_cache_spec``); before each device operation rank 0 broadcasts
it with its host inputs and every rank runs it on its shard
(:meth:`PagedTorchLLMEngine._spmd`, :meth:`PagedTorchLLMEngine.follow`).
The per-layer reductions take the α-β planner's algorithm per program
kind (decode, prefill, verify), booked per dispatch; the draft model is
replicated on every rank and runs no collective.  Exports gather a
block's shards to full width, imports scatter them: a payload is
canonical, so a tp=2 engine's imports into a tp=1 engine and back.  On
the card the programs are CUDA graphs with the NCCL collectives captured
inside; a group that reduces CUDA tensors through gloo runs eagerly.

Not ported in this slice (ROADMAP.md): tracing spans.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private import (
    device_telemetry,
    flight_recorder,
    runtime_metrics,
)
from ray_tpu_torch._private.prefix_hash import chain_hash, prefix_chain_hashes
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, check_supported
from ray_tpu_torch.llm.engine import (
    _MAX_STOP_IDS,
    build_engine_mesh,
    _copy_in,
    _Programs,
    _decode_chunk,
    _EngineBase,
    _LoopState,
    _Readback,
    _Request,
    _sample,
    _sample_dist,
    resolve_device,
)
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import mesh as _mesh

# most chain hashes one prefix digest carries (the JAX package's
# serve_prefix_digest_max_hashes default; the port reads no JAX config)
PREFIX_DIGEST_MAX_HASHES = 1024


class BlockManager:
    """Host-side allocator + prefix cache over the device block pool.

    ``on_evict(block, chain_hash)`` fires when allocation pressure
    repurposes a hash-registered (cached) block, BEFORE its registration is
    dropped: the tier ladder's demotion hook, which copies the block's KV
    to the host-RAM tier while the pool still holds it."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_caching: bool = True, on_evict=None):
        self.num_blocks = num_blocks
        self.bs = block_size
        self.prefix_caching = prefix_caching
        self.on_evict = on_evict
        # block 0 is the SINK: inactive decode slots' zero-padded table rows
        # make the device scatter land there, so it is never allocated.
        # TWO insertion-ordered free sets: plain (not hash-registered) and
        # cached (freed but revivable by match_prefix).  alloc drains plain
        # first, so prefix-cache entries are evicted only under real
        # pressure, oldest first.
        self.free_plain: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict((i, None) for i in range(1, num_blocks)))
        self.free_cached: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())
        self.ref = [0] * num_blocks
        self.hash_of: Dict[int, int] = {}   # block -> chain hash
        self.by_hash: Dict[int, int] = {}   # chain hash -> block

    def num_free(self) -> int:
        return len(self.free_plain) + len(self.free_cached)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > self.num_free():
            return None
        out = []
        for _ in range(n):
            if self.free_plain:
                b, _ = self.free_plain.popitem(last=False)
            else:
                b, _ = self.free_cached.popitem(last=False)
            h = self.hash_of.pop(b, None)  # repurposed: stale cache entry out
            if h is not None and self.by_hash.get(h) == b:
                if self.on_evict is not None:
                    try:
                        self.on_evict(b, h)  # demote before the data is lost
                    except Exception:  # noqa: BLE001 -- tiering is best-effort
                        pass
                del self.by_hash[h]
            self.ref[b] = 1
            out.append(b)
        return out

    def release(self, blocks: Sequence[int]):
        for b in blocks:
            self.ref[b] -= 1
            if self.ref[b] < 0:
                raise RuntimeError(f"double free of block {b}")
            if self.ref[b] == 0:
                # still hash-registered blocks stay revivable by
                # match_prefix until allocation pressure evicts them
                if b in self.hash_of:
                    self.free_cached[b] = None
                else:
                    self.free_plain[b] = None

    def match_prefix(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest run of cached full blocks covering < len(prompt) tokens
        (the last token is always recomputed so sampling has a logit).
        Matched blocks are ref'd for the caller."""
        if not self.prefix_caching:
            return [], 0
        ids: List[int] = []
        h: Optional[int] = None
        limit = (len(prompt) - 1) // self.bs
        for i in range(limit):
            h = chain_hash(h, prompt[i * self.bs:(i + 1) * self.bs])
            b = self.by_hash.get(h)
            if b is None:
                break
            ids.append(b)
        for b in ids:
            if self.ref[b] == 0:
                self.free_cached.pop(b, None)  # revive a cached-free block
                self.free_plain.pop(b, None)
            self.ref[b] += 1
        return ids, len(ids) * self.bs

    def register(self, prompt: Sequence[int], blocks: Sequence[int]):
        """Register this sequence's full PROMPT blocks for future sharing."""
        if not self.prefix_caching:
            return
        h: Optional[int] = None
        for i in range(len(prompt) // self.bs):
            h = chain_hash(h, prompt[i * self.bs:(i + 1) * self.bs])
            b = blocks[i]
            if h not in self.by_hash and b not in self.hash_of:
                self.by_hash[h] = b
                self.hash_of[b] = h

    def adopt(self, block: int, h: int):
        """Register a chain hash for an already-allocated block (a tier
        revival: the caller just uploaded the cached KV into ``block``)."""
        if not self.prefix_caching:
            return
        if h not in self.by_hash and block not in self.hash_of:
            self.by_hash[h] = block
            self.hash_of[block] = h


# the reference/vLLM name for this role: one object, two names
BlockAllocator = BlockManager


class HostBlockCache:
    """Tiers 2 and 3 of the prefix-cache ladder: a host-RAM LRU of full KV
    blocks keyed by chain hash, capped in bytes, spilling to the object
    store (``ray_tpu_torch.put``), capped in blocks.

    HBM (tier 1) evictions demote here; ``get`` revives through host RAM
    first, then the store, promoting a store hit back into host RAM.
    Entries are whatever the caller stores (the engine: CPU tensors,
    pinned on CUDA; anything with ``nbytes``); store entries are
    ObjectRefs, whose payloads are freed when the ref is dropped.  The
    spill is best effort, as the JAX package's: with no runtime
    initialized, or a put that fails, the evicted block is dropped; a lost
    ref reads as a miss.  Thread-safe: the engine calls under its own lock,
    but a digest reader may call concurrently."""

    def __init__(self, capacity_bytes: int, plasma_blocks: int = 0):
        self._cap = max(0, capacity_bytes)
        self._plasma_cap = max(0, plasma_blocks)
        self._entries: "collections.OrderedDict[int, Tuple]" = (
            collections.OrderedDict())  # hash -> (k, v)
        self._bytes = 0
        self._plasma: "collections.OrderedDict[int, object]" = (
            collections.OrderedDict())  # hash -> ObjectRef of (k, v)
        self._lock = threading.Lock()
        # spills into the store and their seconds (put included)
        self.spilled = 0
        self.spill_s = 0.0

    def __len__(self):
        with self._lock:
            return len(self._entries) + len(self._plasma)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def hashes(self) -> List[int]:
        with self._lock:
            return list(self._plasma) + list(self._entries)

    def put(self, h: int, k, v):
        """Demote one block's KV into the host tier, LRU-evicting entries
        over the byte cap into the store (or dropping them when the store
        tier is off)."""
        if self._cap <= 0:
            return
        nbytes = k.nbytes + v.nbytes
        spill = []
        with self._lock:
            if h in self._entries:
                self._entries.move_to_end(h)
                return
            self._plasma.pop(h, None)  # the promoted copy supersedes a spill
            self._entries[h] = (k, v)
            self._bytes += nbytes
            while self._bytes > self._cap and len(self._entries) > 1:
                eh, (ek, ev) = self._entries.popitem(last=False)
                self._bytes -= ek.nbytes + ev.nbytes
                spill.append((eh, ek, ev))
        for eh, ek, ev in spill:
            runtime_metrics.add_prefix_cache_evictions("host")
            self._spill_to_plasma(eh, ek, ev)

    def _spill_to_plasma(self, h: int, k, v):
        if self._plasma_cap <= 0:
            return
        t0 = time.perf_counter()
        try:
            import ray_tpu_torch

            if not ray_tpu_torch.is_initialized():
                return
            ref = ray_tpu_torch.put((k, v))
        except Exception:  # noqa: BLE001 — tiering is best effort
            return
        with self._lock:
            self._plasma[h] = ref
            self.spilled += 1
            self.spill_s += time.perf_counter() - t0
            while len(self._plasma) > self._plasma_cap:
                self._plasma.popitem(last=False)
                runtime_metrics.add_prefix_cache_evictions("plasma")

    def get(self, h: int):
        """(k, v, tier) for a cached block, or None.  A store hit is
        promoted back into the host tier (it is about to be hot)."""
        with self._lock:
            got = self._entries.get(h)
            if got is not None:
                self._entries.move_to_end(h)
                return got[0], got[1], "host"
            ref = self._plasma.get(h)
        if ref is None:
            return None
        try:
            import ray_tpu_torch

            k, v = ray_tpu_torch.get(ref, timeout=5)
        except Exception:  # noqa: BLE001 — a lost spill reads as a miss
            with self._lock:
                self._plasma.pop(h, None)
            return None
        # owned copies: the promotion drops the ref, and a zero-copy view
        # must not outlive the store's buffer
        k, v = (t.clone() if isinstance(t, torch.Tensor) else np.array(t)
                for t in (k, v))
        self.put(h, k, v)
        return k, v, "plasma"


@dataclasses.dataclass
class _PagedReq(_Request):
    blocks: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0      # prompt tokens already in the pool
    admitted_order: int = 0   # preemption picks the youngest
    # --- speculative decoding (engine._spec is not None) ---
    # draft-pool blocks mirroring this request's KV in the draft's pool;
    # draft_prefill_pos tracks the draft's own chunked prefill (a target
    # prefix-cache hit does not help the draft: it recomputes the region)
    draft_blocks: List[int] = dataclasses.field(default_factory=list)
    draft_prefill_pos: int = 0
    # False: this request decodes without speculation (draft-pool
    # exhaustion) -- zero drops
    spec_enabled: bool = False
    # acceptance bookkeeping
    spec_proposed: int = 0
    spec_accepted: int = 0
    # SLO stage stamps (monotonic; set only under a slo_label)
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_emit: float = 0.0


def _bucket_pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _spec_accept(pdist, qdist, drafted, generator: torch.Generator):
    """Rejection-sampling core of speculative verification, on the device.

    pdist [B, k+1, V]: the target's distributions at each window position;
    qdist [B, k, V]: the draft distributions that generated ``drafted``
    [B, k] (a zeroed row disables speculation for its slot: acceptance is
    forced off and the correction degenerates to the target distribution
    itself).  Returns ``(a [B], corr [B])``: the count of leading accepted
    proposals and the correction token drawn from ``normalize(max(p_a -
    q_a, 0))``, which with q zero-padded at index k is the bonus token's
    draw from p_k on full acceptance.

    Accept d_j iff u * q(d_j) < p(d_j) and q(d_j) > 0, u uniform from
    ``generator``; the correction is a Gumbel-max draw from the same
    generator, with exact-zero residual entries at -inf, so a greedy
    (one-hot) row can never draw a non-argmax token.  The emitted token at
    each position is distributed as the target distribution; greedy rows
    collapse to exact longest-agreeing-prefix verification with argmax
    corrections.  Nothing is read back to the host."""
    b, k = drafted.shape
    v = pdist.shape[-1]
    dev = pdist.device
    u = torch.rand((b, k), generator=generator, device=dev)
    d = drafted.long()[..., None]
    p_d = torch.gather(pdist[:, :k], 2, d)[..., 0]
    q_d = torch.gather(qdist, 2, d)[..., 0]
    # q_d > 0: a token the draft could not have drawn is never accepted (a
    # drafted token always has q_d > 0; a zeroed q row forces a = 0)
    accept = (u * q_d < p_d) & (q_d > 0)
    a = torch.cumprod(accept.to(torch.int32), dim=1).sum(1)  # [B] 0..k
    q_pad = torch.cat([qdist, torch.zeros((b, 1, v), dtype=qdist.dtype,
                                          device=dev)], dim=1)
    at = a[:, None, None].expand(b, 1, v)
    p_a = torch.gather(pdist, 1, at)[:, 0]
    q_a = torch.gather(q_pad, 1, at)[:, 0]
    resid = (p_a - q_a).clamp(min=0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid, p_a)
    # u > 0: a zero uniform would give its token a -inf Gumbel and could
    # leave a one-hot row all -inf
    g = torch.rand((b, v), generator=generator, device=dev).clamp(
        min=torch.finfo(torch.float32).tiny)
    logits = torch.where(resid > 0, torch.log(resid),
                         torch.full((), -math.inf, device=dev))
    corr = (logits - torch.log(-torch.log(g))).argmax(-1).to(torch.int32)
    return a.to(torch.int32), corr


def _prefill_plan(plen: int, matched: int, chunk: int, bs: int):
    """Simulate the chunked-prefill loop: chunk widths are POW2-BUCKETED
    multiples of block_size.  Returns the max block index any chunk's
    table must cover."""
    pos, cover = matched, matched // bs
    while pos < plen:
        rem = plen - pos
        c = min(chunk, _bucket_pow2(_pad_to(rem, bs), lo=bs))
        cover = max(cover, math.ceil((pos + c) / bs))
        pos += min(c, rem)
    return cover


def _prefill_cover_worst(plen: int, chunk: int, bs: int) -> int:
    """Max block index any prefill chunk of a ``plen``-token prompt can
    touch, over every possible prefix-cache offset.  Only the FINAL
    chunk's pow2 bucket overshoots the prompt, and a prefix hit merely
    shifts its start to another block boundary."""
    worst = 0
    lo = max(0, plen - chunk)
    start = ((lo + bs - 1) // bs) * bs
    for pos in range(start, plen, bs):
        c = min(chunk, _bucket_pow2(_pad_to(plen - pos, bs), lo=bs))
        worst = max(worst, math.ceil((pos + c) / bs))
    return worst


def _prefill_table_width(max_seq: int, chunk: int, bs: int) -> int:
    """Worst-case prefill table width: 1 (decode spare, reserved at
    admission) + the max block index any chunk dispatch can touch.  Only
    the last ~2*chunk prompt lengths can attain the max."""
    return 1 + max(
        _prefill_cover_worst(plen, chunk, bs)
        for plen in range(max(1, max_seq - 2 * chunk), max_seq + 1))


def _use_paged_kernel(want, cfg: "llama.LlamaConfig", device,
                      pool_dtype: torch.dtype,
                      block_size: Optional[int] = None) -> bool:
    """The ``paged_attention_kernel`` switch: whether decode runs the CUDA
    kernel, which reads only each row's live pages.

    None runs it on a CUDA device and the table gather on the CPU; False
    forces the gather (the A/B knob).  None or True on a CUDA device, and
    True anywhere, raise when the kernel cannot take the config: the card
    never gives way to the gather unasked."""
    if want not in (None, True, False):
        raise ValueError(
            f"paged_attention_kernel must be None, True or False (got "
            f"{want!r}); the CUDA kernel has no interpret mode")
    if want is False or (want is None and torch.device(device).type != "cuda"):
        return False
    refusal = llama.paged_kernel_refusal(cfg, device, pool_dtype, block_size)
    if refusal:
        raise ValueError(
            f"paged_attention_kernel={want}: {refusal}; pass "
            f"paged_attention_kernel=False for the table gather")
    return True


class PagedTorchLLMEngine(_EngineBase):
    """The paged engine's API (``add_request``, ``step``, ``flush``,
    ``cancel_request``, ``generate``, ``warmup``, ``export_request``,
    ``import_request``, ``prefix_digest``, ``utilization``,
    ``specdec_stats``) over a block pool on ``device``.

    ``device`` defaults to CUDA (raising without a GPU); ``params`` None
    draws random weights from ``generator`` (default: seed 0).  With
    ``config.speculative_config``, ``draft_params`` are the draft model's
    weights (None draws them from a generator seeded 1)."""

    def __init__(self, config: LLMConfig, params=None, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 draft_params=None, _graphs: Optional[bool] = None,
                 _params_sharded: bool = False):
        check_supported(config)
        self.config = config
        cfg = config.model_config
        if cfg is None:
            raise ValueError("LLMConfig.model_config is required")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = config.max_batch_size
        self.max_seq = config.max_seq_len or cfg.max_seq_len
        self.bs = config.block_size
        if config.decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1 (got {config.decode_chunk})")
        if config.prefill_chunk % self.bs:
            raise ValueError(
                f"prefill_chunk ({config.prefill_chunk}) must be a multiple "
                f"of block_size ({self.bs})")
        nb = config.num_blocks
        if nb is None:
            # default pool: half the memory the static cache would have used
            nb = max(4, (self.max_batch * self.max_seq) // (2 * self.bs))
        self.num_blocks = nb
        self.max_blocks_per_seq = math.ceil(self.max_seq / self.bs)
        self._spec = config.speculative_config
        self._spec_k = 0
        # one fixed prefill table width: the simulated worst case over every
        # prompt length and chunk start (see _prefill_table_width)
        self._prefill_w = _prefill_table_width(
            self.max_seq, config.prefill_chunk, self.bs)
        # the tier ladder under the pool's chain-hash cache: evictions
        # demote full prompt blocks to host RAM, and a later prefix match
        # revives them by upload instead of recompute
        self._host_cache: Optional[HostBlockCache] = None
        if config.enable_prefix_caching and config.host_kv_cache_bytes > 0:
            self._host_cache = HostBlockCache(
                config.host_kv_cache_bytes, config.plasma_kv_cache_blocks)
        self.blocks = BlockManager(
            nb, self.bs, config.enable_prefix_caching,
            on_evict=(self._demote_block if self._host_cache is not None
                      else None))
        # prefix-cache counts (booked per successful admission: pool hits,
        # host-tier revivals, misses) and the tier's copies with their host
        # seconds (enqueue time; the copies run on the engine's stream)
        self.prefix_stats = {"hbm_hits": 0, "host_hits": 0, "misses": 0,
                             "demoted": 0, "demote_s": 0.0,
                             "uploaded": 0, "upload_s": 0.0}

        # tensor parallelism: this process is rank 0, the leader that owns
        # the host side, unless a caller's mesh says otherwise.  Without a
        # mesh at tp > 1 the engine starts its other ranks (llm/tp.py)
        tp = config.tensor_parallel_size
        self._ranks = None
        mesh = config.mesh
        if mesh is None and tp > 1:
            build_engine_mesh(cfg, tp, config.pipeline_parallel_size)
            from ray_tpu_torch.llm import tp as _tp

            self._ranks = _tp.RankProcesses(config, self.device)
            self._finalizer = weakref.finalize(self, self._ranks.shutdown)
            mesh = self._ranks.mesh
        self.mesh = build_engine_mesh(cfg, tp, config.pipeline_parallel_size,
                                      mesh=mesh)
        self._leader = self.mesh is None or self.mesh.rank == 0
        # operations are broadcast to the other ranks (none at world 1)
        self._spmd_on = self.mesh is not None and self.mesh.tensor > 1
        self._stopped = False
        # this rank's weights: under a mesh its shard only, so no card
        # holds more than its shard and one full tensor (random weights
        # are drawn tensor by tensor, each rank keeping its slice)
        specs = llama.inference_param_specs(cfg)
        if params is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if self._ranks is not None:
            self._ranks.hand_over(
                params, generator.get_state() if params is None else None,
                draft_params, specs)
        if params is None:
            place = None
            if self.mesh is not None:
                def place(path, t):
                    spec = specs
                    for key in path:
                        spec = spec[key]
                    return _mesh.shard_pytree(t, spec, self.mesh)
            params = llama.init_params(cfg, generator, self.device,
                                       place=place)
        elif self.mesh is not None:
            params = _mesh.shard_pytree(
                params, None if _params_sharded else specs, self.mesh)
        self.params = params
        self._rope = llama.rope_cache(cfg, self.max_seq, self.device)
        self.pool = llama.init_paged_kv_cache(
            cfg, nb, self.bs, self.device,
            shards=self.mesh.tensor if self.mesh is not None else 1)

        # host slot state
        self._slot_req: List[Optional[_PagedReq]] = [None] * self.max_batch
        self._lengths = np.zeros(self.max_batch, np.int32)
        self._next_tok = np.zeros(self.max_batch, np.int32)
        self._slot_temp = np.zeros(self.max_batch, np.float32)
        self._slot_topk = np.zeros(self.max_batch, np.int32)
        # the decode loop's state lives on the device between steps; the
        # host refreshes it (in place) only on slot transitions
        self._dirty = True
        self._state = _LoopState(self.max_batch, self.device)
        # sampling noise stays on the device (the JAX engine's PRNG key)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.vocab_size + 1)
        self._pending: "collections.deque[_PagedReq]" = collections.deque()
        self._requests: Dict[int, _PagedReq] = {}
        self._req_counter = 0
        self._admit_counter = 0
        self._lock = threading.Lock()
        # serving SLO layer: the hosting deployment's name, set through the
        # replica's set_slo_label.  None (direct engine use) books no
        # stages; assigning a name also attaches device telemetry
        # (slo_label is a property) -- the disabled path is _telemetry None
        self._slo_label: Optional[str] = None
        self._telemetry: Optional[device_telemetry.EngineTelemetry] = None
        # chunked-prefill budget spend, tracked per step for telemetry
        self._tel_prefill_budget = (config.prefill_token_budget
                                    or config.prefill_budget_tokens
                                    or config.prefill_chunk)
        self._tel_prefill_spent = 0
        # one decode chunk may stay IN FLIGHT while the host books the
        # previous chunk's tokens: (emitted readback, active slots,
        # speculating slots, acceptance readback or None)
        self._inflight: Optional[Tuple[_Readback, List[int], Tuple[int, ...],
                                       Optional[_Readback]]] = None
        # a finished prefill's first token stays a pending readback until
        # the next drain point: (slot, req, readback)
        self._first_pending: List[Tuple[int, _PagedReq, _Readback]] = []
        # work counters: token steps of decode dispatched, prompt tokens
        # prefilled
        self.decode_steps = 0
        self.prefill_tokens = 0

        self._use_kernel = _use_paged_kernel(
            config.paged_attention_kernel, cfg, self.device,
            self.pool["k"].dtype, self.bs)
        graphs = self.device.type == "cuda" if _graphs is None else _graphs
        if (self.mesh is not None and self.mesh.group is not None
                and not self.mesh.group.capturable(self.device)):
            graphs = False  # gloo on CUDA tensors waits on the host
        self._tp_plan = self._tp_prefill_plan = self._tp_verify_plan = None
        self._tp_collectives = None  # {kind: plan_explain row}
        if (self.mesh is not None and self.mesh.group is not None
                and config.tp_planned_collectives):
            self._init_tp_planning()
        if self._spec is not None:
            self._init_draft(draft_params, graphs)
        # the decode chunk per table width: CUDA graphs on the card (the
        # private ``_graphs=False`` keeps eager dispatch there, for A/Bs).
        # The warm-up run before each capture decodes an idle batch whose
        # zero table sends every write to sink block 0.  With a draft
        # model it serves only batches in which no slot speculates, at
        # k + 1 token steps (the appends a speculative step reserves)
        self._programs = _Programs(
            self._decode_chunk_impl, self._state,
            self._spec_k + 1 if self._spec is not None else config.decode_chunk,
            graphs, self._gen, name="paged.decode")
        # the prefill chunk per pow2 chunk width (the table width is
        # fixed); the warm-up run before each capture prefills zeros into
        # sink block 0
        self._prefill_programs = _Programs(
            self._prefill_program, self._state, 1, graphs, self._gen,
            buffers=lambda c: self._prefill_buffers(c, sample=True),
            name="paged.prefill")
        self._progs_by_name = {p.name: p for p in (
            self._programs, self._prefill_programs,
            *((self._draft_prefill_programs, self._propose_programs,
               self._verify_programs) if self._spec is not None else ()))}

    def _random_draft_params(self):
        return llama.init_params(
            self._spec.draft_model_config,
            torch.Generator(device=self.device).manual_seed(1), self.device)

    def _init_draft(self, draft_params, graphs: bool):
        """The draft model, its block pool and its two programs per table
        width: propose (k+1 draft decode steps) and verify (the target's
        window forward and the acceptance)."""
        dcfg = self._spec.draft_model_config
        if dcfg is None:
            raise ValueError(
                "speculative_config.draft_model_config is required")
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {dcfg.vocab_size} != target "
                f"{self.cfg.vocab_size} — verification compares token ids")
        k = int(self._spec.num_speculative_tokens)
        if k < 1:
            raise ValueError(f"num_speculative_tokens must be >= 1 (got {k})")
        self._spec_k = k
        self._draft_cfg = dcfg
        if draft_params is None:
            draft_params = self._random_draft_params()
        # replicated under TP: every rank runs the small draft itself, with
        # no collective (its messages would be all latency)
        self._draft_params = (_mesh.shard_pytree(draft_params, None, self.mesh)
                              if self.mesh is not None else draft_params)
        self._draft_rope = llama.rope_cache(dcfg, self.max_seq, self.device)
        dnb = self._spec.draft_num_blocks or self.num_blocks
        self._draft_num_blocks = dnb
        # no prefix caching in the draft pool: draft KV is never shared
        # across requests (recompute at draft size is cheap)
        self.draft_blocks = BlockManager(dnb, self.bs, prefix_caching=False)
        self._draft_pool = llama.init_paged_kv_cache(dcfg, dnb, self.bs,
                                                     self.device)
        # the draft's steps follow the target's switch (the JAX program
        # gathers; the function is the same): a draft the kernel cannot
        # take raises on the card as the target does
        self._draft_use_kernel = _use_paged_kernel(
            self.config.paged_attention_kernel, dcfg, self.device,
            self._draft_pool["k"].dtype, self.bs)
        # propose's outputs, verify's inputs: engine-owned, so every
        # width's graphs read and write the same buffers
        b = self.max_batch
        self._drafted = torch.zeros((k, b), dtype=torch.int32,
                                    device=self.device)
        self._qdist = torch.zeros((k, b, self.cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        self._draft_prefill_programs = _Programs(
            self._draft_prefill_program, self._state, 1, graphs, self._gen,
            buffers=lambda c: self._prefill_buffers(c, sample=False),
            name="paged.draft_prefill")
        self._propose_programs = _Programs(
            self._draft_propose_impl, self._state, k, graphs, self._gen,
            buffers=lambda w: {"table": torch.zeros((b, w), **i32)},
            name="paged.propose")
        self._verify_programs = _Programs(
            self._spec_verify_impl, self._state, k + 1, graphs, self._gen,
            buffers=lambda w: {
                "table": torch.zeros((b, w), **i32),
                "emitted": torch.full((k + 1, b), -1, **i32),
                "accepted": torch.zeros(b, **i32)},
            name="paged.verify")
        self.spec_cycles = 0  # propose + verify dispatches
        # engine-lifetime acceptance totals (specdec_stats)
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        # finished requests' (proposed, accepted), bounded
        self._spec_finished: "collections.OrderedDict[int, Tuple[int, int]]" = (
            collections.OrderedDict())

    # -- device programs -------------------------------------------------

    def _decode_chunk_impl(self, state: _LoopState, table, emitted,
                           generator):
        """Multi-step paged decode, all on the device, in place (the host
        guarantees every active slot's table covers lengths + n_steps
        appends): ``emitted.shape[0]`` token steps; emitted gets the ids,
        -1 where a slot is inactive."""
        _decode_chunk(
            lambda tokens, lengths: llama.decode_step_paged(
                self.cfg, self.params, tokens, self.pool, table, lengths,
                self._rope, use_kernel=self._use_kernel, mesh=self.mesh,
                tp_plan=self._tp_plan)[0],
            state, emitted, generator, self.max_seq)

    def _draft_propose_impl(self, state: _LoopState, table, generator):
        """k+1 autoregressive draft steps per slot, in place: step j feeds
        the running token at position lengths + j (clamped at max_seq - 1)
        and samples the next proposal into ``_drafted[j]`` and its
        distribution into ``_qdist[j]``.  Step k only WRITES the last
        proposal's draft KV: on full acceptance the next cycle starts at
        lengths + k + 1, and the draft's span must cover lengths + k.
        ``table`` [B, W]: the draft pool's blocks per slot (zero rows for
        slots that do not speculate: their writes go to sink block 0)."""
        k = self._spec_k
        tok = state.tokens
        for j in range(k + 1):
            cur = (state.lengths + j).clamp(max=self.max_seq - 1)
            logits = llama.decode_step_paged(
                self._draft_cfg, self._draft_params, tok, self._draft_pool,
                table, cur, self._draft_rope,
                use_kernel=self._draft_use_kernel)[0]
            if j == k:
                break
            tok = _sample(logits, generator, state.temps, state.top_ks)
            self._drafted[j] = tok
            self._qdist[j] = _sample_dist(logits, state.temps, state.top_ks)

    def _spec_verify_impl(self, state: _LoopState, table, emitted, accepted,
                          generator):
        """Verify the k drafted tokens per slot in ONE target forward, in
        place.

        The window [t0, d_1..d_k] runs through ``decode_window_paged`` (KV
        written at lengths..lengths+k; rejected positions' KV goes stale
        and is overwritten later, and attention masks by length).  The
        target's distributions come from ``_sample_dist`` at each window
        position; slots with ``state.spec`` 0 get a zeroed draft
        distribution, so their one emission is an exact plain decode
        sample.  Stop-token, budget and max_seq handling follow the plain
        chunk's order over the emission sequence.  Writes ``emitted``
        [k+1, B] (-1 padded), ``accepted`` [B] (the true acceptance
        count, before any stop or budget truncation), and the loop state."""
        k = self._spec_k
        b = state.tokens.shape[0]
        d = self._drafted.T  # [B, k]
        window = torch.cat([state.tokens[:, None], d], dim=1)
        logits = llama.decode_window_paged(
            self.cfg, self.params, window, self.pool, table, state.lengths,
            self._rope, pos_limit=self.max_seq, tp_plan=self._tp_verify_plan,
            mesh=self.mesh)[0]
        v = logits.shape[-1]
        pdist = _sample_dist(logits.reshape(b * (k + 1), v),
                             state.temps.repeat_interleave(k + 1),
                             state.top_ks.repeat_interleave(k + 1)
                             ).view(b, k + 1, v)
        q = self._qdist.transpose(0, 1) * (state.spec > 0)[:, None, None]
        a, corr = _spec_accept(pdist, q, d, generator)
        idx = torch.arange(k + 1, device=a.device)[None, :]
        # candidate emission j: the accepted draft for j < a, the
        # correction at a
        e = torch.where(idx < a[:, None], F.pad(d, (0, 1)), corr[:, None])
        # the plain chunk's stop/budget/max_seq order: emission j means
        # lengths + j + 1 tokens written and remaining - (j + 1) budget;
        # the first done truncates the rest
        base = (idx <= a[:, None]) & (state.active[:, None] > 0)
        hit_stop = (state.stops[:, None, :] == e[..., None]).any(-1)
        done_at = (hit_stop | (state.remaining[:, None] - (idx + 1) <= 0)
                   | (state.lengths[:, None] + idx + 2 >= self.max_seq))
        stopped_before = torch.cumsum(
            F.pad((base & done_at).to(torch.int32), (1, 0))[:, :-1],
            dim=1) > 0
        valid = base & ~stopped_before
        emitted.copy_(torch.where(valid, e, -1).T)
        n_emit = valid.sum(1).to(torch.int32)
        done = (valid & done_at).any(1)
        last = torch.gather(e, 1, (n_emit.long() - 1).clamp(min=0)[:, None])[:, 0]
        state.lengths += n_emit
        state.remaining -= n_emit
        state.active.mul_((~done).to(state.active.dtype))
        state.tokens.copy_(torch.where(state.active > 0, last, state.tokens))
        accepted.copy_(a)

    def _prefill_chunk_impl(self, tokens, table, p0, sample_idx, temp, top_k,
                            generator=None):
        """One chunk; also samples the token at chunk-local position
        ``sample_idx`` (the caller uses it only on the final chunk) from
        ``generator`` (default: the engine's).  ``p0`` and ``sample_idx``:
        host ints or one-element device tensors."""
        logits, _ = llama.prefill_chunk_paged(
            self.cfg, self.params, tokens, self.pool, table, p0, self._rope,
            tp_plan=self._tp_prefill_plan, mesh=self.mesh)
        idx = torch.as_tensor(sample_idx, device=logits.device).reshape(1)
        return _sample(logits.index_select(1, idx.long())[:, 0],
                       generator or self._gen, temp, top_k)

    def _draft_prefill_chunk_impl(self, tokens, table, p0):
        """One draft prefill chunk into the draft pool (its logits unused)."""
        llama.prefill_chunk_paged(self._draft_cfg, self._draft_params, tokens,
                                  self._draft_pool, table, p0,
                                  self._draft_rope)

    def _prefill_buffers(self, c: int, sample: bool) -> Dict[str, torch.Tensor]:
        """A prefill program's static inputs at chunk width ``c`` (the
        target's add the sampling inputs and the sampled id)."""
        i32 = dict(dtype=torch.int32, device=self.device)
        out = {"tokens": torch.zeros((1, c), **i32),
               "table": torch.zeros((1, self._prefill_w), **i32),
               "p0": torch.zeros(1, **i32)}
        if sample:
            out.update(sample_idx=torch.zeros(1, **i32),
                       temp=torch.zeros(1, dtype=torch.float32,
                                        device=self.device),
                       top_k=torch.zeros(1, **i32),
                       emitted=torch.zeros(1, **i32))
        return out

    def _prefill_program(self, state, tokens, table, p0, sample_idx, temp,
                         top_k, emitted, generator):
        """The target's prefill program in place (``state`` unused)."""
        emitted.copy_(self._prefill_chunk_impl(tokens, table, p0, sample_idx,
                                               temp, top_k, generator))

    def _draft_prefill_program(self, state, tokens, table, p0, generator):
        """The draft's prefill program in place (nothing sampled)."""
        self._draft_prefill_chunk_impl(tokens, table, p0)

    def _run_prefill(self, progs: _Programs, seq: Sequence[int],
                     blocks: Sequence[int], p0: int, c: int, **scalars):
        """Dispatch one prefill chunk of ``seq`` at [p0, p0 + c) through
        ``progs``' program of width ``c``: the host checks, then the copies
        into its inputs (stream-ordered behind any program still reading
        them), then the run.  Returns the program's sampled id buffer (None
        for the draft's), which the next run of that width overwrites."""
        llama.check_prefill_chunk(p0, c, self.bs, self._prefill_w)
        take = min(c, len(seq) - p0)
        tokens = np.zeros((1, c), np.int32)
        tokens[0, :take] = seq[p0:p0 + take]
        table = np.zeros((1, self._prefill_w), np.int32)
        table[0, :len(blocks)] = blocks
        if self._tp_collectives is not None and progs is self._prefill_programs:
            self._book_tp_collectives("prefill", nbytes_each=c * self.cfg.dim
                                      * self.pool["k"].element_size())
        return self._spmd("dispatch", progs.name, c, dict(
            tokens=tokens, table=table, p0=np.array([p0], np.int32),
            **scalars))

    # -- operations on every rank ----------------------------------------

    def _spmd(self, op: str, *args):
        """Run device operation ``op`` (``_op_<op>``) on every rank: under
        tensor parallelism the leader broadcasts it with its host arguments
        first, so the other ranks' ``follow`` loops run it on their shards
        in the same order.  Returns this rank's result."""
        if self._spmd_on:
            if not self._leader:
                raise RuntimeError("only rank 0 drives a tensor-parallel engine")
            self.mesh.group.broadcast_object((op, args))
        return getattr(self, "_op_" + op)(*args)

    def follow(self) -> None:
        """A follower rank's loop: run the leader's operations until it
        stops the ranks (a None operation)."""
        if self._leader:
            raise RuntimeError("rank 0 drives the engine; follow() is for "
                               "the other ranks")
        with torch.no_grad():
            while True:
                msg = self.mesh.group.broadcast_object(None)
                if msg is None:
                    return
                op, args = msg
                getattr(self, "_op_" + op)(*args)

    def shutdown(self) -> None:
        """Stop a tensor-parallel engine's other ranks (joined when this
        engine started them).  A no-op on one device; idempotent."""
        if self._stopped or not self._leader:
            return
        self._stopped = True
        if self._ranks is not None:
            self._ranks.shutdown()
        elif self._spmd_on:
            self.mesh.group.broadcast_object(None)

    def _op_dispatch(self, name: str, width, inputs: Dict[str, np.ndarray]):
        """Copy host inputs into program ``name``'s buffers at ``width``
        (stream-ordered behind any program still reading them) and run it;
        returns its ``emitted`` buffer."""
        prog = self._progs_by_name[name].get(width)
        for key, value in inputs.items():
            _copy_in(prog.buffers[key], value)
        return prog()

    def _op_warm(self, name: str, width) -> None:
        self._progs_by_name[name].get(width)

    def _op_load(self, arrays: Dict[str, np.ndarray]) -> None:
        self._state.load(**arrays)

    def _op_gather(self, blocks: List[int]):
        """Pool blocks ``blocks`` as fresh [L, n, bs, kv*hd] tensors on this
        rank's device, at full width (the shards gathered in rank order)."""
        idx = torch.as_tensor(blocks, device=self.device)
        k = self.pool["k"].index_select(1, idx)
        v = self.pool["v"].index_select(1, idx)
        if self.mesh is not None and self.mesh.group is not None:
            k = self.mesh.group.all_gather(k, dim=-1)
            v = self.mesh.group.all_gather(v, dim=-1)
        return k, v

    def _op_scatter(self, blocks: List[int], k, v) -> None:
        """Write full-width KV [L, n, bs, kv*hd] (host or device tensors)
        into pool blocks ``blocks``: this rank's head group of it."""
        idx = torch.as_tensor(blocks, device=self.device)
        spec = llama.paged_kv_cache_spec()
        for name, t in (("k", k), ("v", v)):
            if self.mesh is not None:
                t = _mesh.shard_slice(t, spec[name], self.mesh)
            self.pool[name].index_copy_(
                1, idx, t.to(self.device, non_blocking=True).to(
                    self.pool[name].dtype))

    # -- planner-routed TP collectives ----------------------------------

    def _init_tp_planning(self):
        """Plan the per-layer decode, verify and prefill reductions through
        the α-β planner once per program kind (message sizes are fixed:
        every dispatch pads to ``max_batch`` and the chunk geometry is
        set), route each choice into its programs as a ``TPPlan``, and
        book each decision on ``ray_tpu_collective_plan_total`` (rank 0;
        every rank computes the same plans).  The full ``plan_explain``
        rows stay for ``utilization()``."""
        from ray_tpu_torch.util.collective import planner as _planner
        from ray_tpu_torch.util.collective.compression import CompressionSpec

        config, cfg = self.config, self.cfg
        topo = _planner.topology_for_devices(self.mesh.devices)
        # scheme "none": algorithm-only planning; min_bytes 0, as decode's
        # messages are KiB-scale
        spec = CompressionSpec(scheme="none", min_bytes=0)
        allowed = ("flat", "ring", "tree")
        itemsize = torch.tensor([], dtype=cfg.compute_dtype).element_size()
        kinds = {"decode": self.max_batch * cfg.dim * itemsize,
                 "prefill": config.prefill_chunk * cfg.dim * itemsize}
        if self._spec is not None:
            kinds["verify"] = (self.max_batch * (self._spec_k + 1) * cfg.dim
                               * itemsize)
        forced = config.tp_collective_algorithm
        rows, plans = {}, {}
        for kind, nbytes in kinds.items():
            row = _planner.plan_explain(nbytes, topo, spec, allowed=allowed)
            if forced is not None:
                row = dict(row, chosen=forced, reason="forced")
            if self._leader:
                _planner.record_plan(row["chosen"], row["reason"])
            rows[kind] = row
            plans[kind] = llama.TPPlan(mesh=self.mesh, algorithm=row["chosen"])
        self._tp_collectives = rows
        self._tp_plan = plans["decode"]
        self._tp_prefill_plan = plans["prefill"]
        self._tp_verify_plan = plans.get("verify")

    def _book_tp_collectives(self, kind: str, programs: int = 1,
                             nbytes_each: Optional[int] = None):
        """Book one dispatch's planned collectives: 2 reductions per layer
        per program (attention out, FFN down), bytes from the message size
        (``nbytes_each`` for a short prefill chunk), seconds from the α-β
        model (a modelled attribution: timing each collective would fence
        the stream).  An unplanned engine books nothing."""
        rows = self._tp_collectives
        row = rows.get(kind) if rows is not None else None
        if row is None:
            return
        n = 2 * self.cfg.n_layers * programs
        cost = row["modeled_cost_s"].get(row["chosen"]) or 0.0
        runtime_metrics.observe_tp_collective(
            self.slo_label or "engine", row["chosen"], seconds=n * cost,
            nbytes=n * (nbytes_each if nbytes_each is not None
                        else row["nbytes"]))

    # -- request lifecycle ---------------------------------------------

    def add_request(self, prompt: Sequence[int],
                    gen: Optional[GenerationConfig] = None) -> int:
        gen = gen or GenerationConfig()
        self._check_request(prompt, gen)
        worst = math.ceil((len(prompt) + gen.max_new_tokens + 1) / self.bs)
        # admission reserves cover+1 blocks (chunk-bucket overhang included,
        # any prefix offset) — an infeasible reserve must fail HERE, not
        # retry forever in _admit_locked
        worst = max(worst, 1 + _prefill_cover_worst(
            len(prompt), self.config.prefill_chunk, self.bs))
        if worst > self.num_blocks - 1:  # block 0 is the sink
            raise ValueError(
                f"request needs up to {worst} KV blocks but the pool has "
                f"{self.num_blocks} — raise num_blocks or lower max_new_tokens")
        with self._lock:
            self._req_counter += 1
            req = _PagedReq(self._req_counter, [int(t) for t in prompt], gen)
            req.spec_enabled = self._spec is not None
            if self.slo_label is not None:
                req.t_enqueue = time.monotonic()
            self._requests[req.request_id] = req
            self._pending.append(req)
            return req.request_id

    def has_work(self) -> bool:
        with self._lock:
            return (bool(self._pending) or self._inflight is not None
                    or any(r is not None for r in self._slot_req))

    # -- tiered prefix cache --------------------------------------------

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of device tensor ``t``, enqueued on the engine's
        stream without a wait (pinned on CUDA): it follows any in-flight
        program in stream order, and so does every later reader on the
        device.  A host reader synchronizes first."""
        out = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=self.device.type == "cuda")
        out.copy_(t, non_blocking=self.device.type == "cuda")
        return out

    def _demote_block(self, block: int, h: int):
        """BlockManager eviction hook: copy the repurposed cached block's
        KV to the host tier before the pool overwrites it.  The copy is
        enqueued behind any in-flight chunk (free blocks are never written
        by in-flight programs, and the next writer of this block is
        enqueued after the copy), so the host does not wait for it."""
        t0 = time.perf_counter()
        # under a mesh the block's shards are gathered to full width
        k, v = (self._to_host(t[:, 0]) for t in self._spmd("gather", [block]))
        self._host_cache.put(h, k, v)
        runtime_metrics.add_prefix_cache_evictions("hbm")
        self.prefix_stats["demoted"] += 1
        self.prefix_stats["demote_s"] += time.perf_counter() - t0

    def _upload_block(self, block: int, k, v):
        """Write one host-cached block's KV into pool block ``block``, in
        place on the engine's stream (the JAX engine's ``_upload_block``
        program)."""
        t0 = time.perf_counter()
        # under a mesh every rank writes its head group
        self._spmd("scatter", [block], torch.as_tensor(k)[:, None],
                   torch.as_tensor(v)[:, None])
        self.prefix_stats["uploaded"] += 1
        self.prefix_stats["upload_s"] += time.perf_counter() - t0

    def _match_prefix_tiered(self, prompt: Sequence[int]):
        """Pool chain match, then extend the chain through the host tier:
        each hit allocates a pool block, uploads the cached KV and
        re-registers the link, so the revived prefix is an ordinary pool
        match for every later request.

        Returns ``(shared, matched, (hbm_hits, misses, revived_tiers))``.
        Nothing is booked here: the caller books on a SUCCESSFUL admission
        only (a pool-full head-of-line request re-matches every step, and a
        block revived on a failed attempt re-matches as a pool hit on the
        retry), so hits + misses sum to the prompt's blocks per admission."""
        shared, matched = self.blocks.match_prefix(prompt)
        if not self.blocks.prefix_caching:
            return shared, matched, (0, 0, ())
        limit = (len(prompt) - 1) // self.bs
        hbm_hits = len(shared)
        revived = []
        if self._host_cache is not None and len(shared) < limit:
            chain = prefix_chain_hashes(prompt, self.bs, limit=limit)
            i = len(shared)
            while i < limit:
                got = self._host_cache.get(chain[i])
                if got is None:
                    break
                fresh = self.blocks.alloc(1)
                if fresh is None:
                    break  # pool full: revival loses to live requests
                k, v, tier = got
                self._upload_block(fresh[0], k, v)
                self.blocks.adopt(fresh[0], chain[i])
                shared.append(fresh[0])
                revived.append(tier)
                i += 1
        return (shared, len(shared) * self.bs,
                (hbm_hits, limit - len(shared), tuple(revived)))

    def prefix_digest(self, max_hashes: Optional[int] = None) -> Dict:
        """The prefix chains this engine can serve without recompute (pool
        registrations, after the host tier's), newest last, for a
        cache-aware router; the hashes are stable across processes
        (``_private/prefix_hash.py``)."""
        if not self.config.enable_prefix_caching:
            return {"block_size": self.bs, "hashes": []}
        if max_hashes is None:
            max_hashes = PREFIX_DIGEST_MAX_HASHES
        with self._lock:
            hashes = list(self.blocks.by_hash)
        if self._host_cache is not None:
            seen = set(hashes)
            hashes = [h for h in self._host_cache.hashes()
                      if h not in seen] + hashes
        if len(hashes) > max_hashes:
            hashes = hashes[-max_hashes:]
        return {"block_size": self.bs, "hashes": hashes}

    # -- device telemetry ----------------------------------------------

    @property
    def slo_label(self) -> Optional[str]:
        return self._slo_label

    @slo_label.setter
    def slo_label(self, name: Optional[str]) -> None:
        self._slo_label = name
        if name is None:
            self._telemetry = None
            return
        # per-device bytes: a tensor-parallel rank holds its shards as its
        # own tensors (the draft replicated), so tree_nbytes is per device
        kv_bytes = device_telemetry.tree_nbytes(self.pool)
        if self._spec is not None:
            kv_bytes += device_telemetry.tree_nbytes(self._draft_pool)
        self._telemetry = device_telemetry.engine_telemetry_for(
            name, weights_bytes=device_telemetry.tree_nbytes(self.params),
            kv_pool_bytes=kv_bytes)
        if self._telemetry is not None:
            # local-mode / engine-direct utilization surface; serve
            # replicas also publish rows to the GCS KV
            device_telemetry.register_utilization_object(
                f"{name}:{id(self):x}", self)

    def utilization(self) -> dict:
        """Slot and KV-block occupancy and the queue, read under the lock
        (block 0 is the sink: capacity is ``num_blocks - 1``), plus the
        step-derived rates, duty cycle and HBM split when telemetry is
        attached, and under a mesh the ``tp`` row."""
        with self._lock:
            active = sum(1 for r in self._slot_req if r is not None)
            free = self.blocks.num_free()
            pending = len(self._pending)
        total = self.num_blocks - 1
        row = {"engine": "paged",
               "deployment": self._slo_label,
               "slots": {"active": active, "max": self.max_batch,
                         "free": self.max_batch - active},
               "kv_blocks": {"total": total, "free": free,
                             "used": total - free},
               "pending": pending}
        tel = self._telemetry
        if tel is not None:
            rates = tel.rates()
            row["duty_cycle"] = rates["duty_cycle"]
            row["rates"] = rates
            row["hbm"] = tel.hbm_split()
        if self.mesh is not None:
            # the mesh's view: KV and weight bytes per device (the pool's
            # kv-head axis is sharded, the draft replicated) and the
            # planned collectives
            row["tp"] = {
                "degree": self.config.tensor_parallel_size,
                "pipeline": self.config.pipeline_parallel_size,
                "mesh_devices": len(self.mesh.devices),
                "mesh_shape": {k: n for k, n in self.mesh.shape.items()
                               if n > 1},
                "kv_bytes_per_device":
                    device_telemetry.tree_nbytes(self.pool),
                "weights_bytes_per_device":
                    device_telemetry.tree_nbytes(self.params),
                "planned_collectives": self._tp_collectives,
            }
        return row

    # -- admission / prefill -------------------------------------------

    def _admit_locked(self):
        """Memory-based admission: a pending request enters when the pool
        has blocks for its full (chunk-padded) prompt plus one decode block.
        Reserving the prompt up front makes the system livelock-free: a
        mid-prefill request never stalls on allocation."""
        for slot in range(self.max_batch):
            if not self._pending or self._slot_req[slot] is not None:
                continue
            req = self._pending[0]
            shared, matched, hit_miss = self._match_prefix_tiered(req.prompt)
            # reserve every block any (pow2-bucketed) prefill chunk's table
            # must cover; +1 is the first decode write's spare
            cover = _prefill_plan(len(req.prompt), matched,
                                  self.config.prefill_chunk, self.bs)
            need = cover - len(shared) + 1
            fresh = self.blocks.alloc(need)
            if fresh is None:
                self.blocks.release(shared)
                return  # pool full: keep FIFO order, retry next step
            if req.spec_enabled:
                # the draft prefills the WHOLE prompt (no prefix cache in
                # its pool), so it needs the full chunk-padded cover
                dcover = _prefill_plan(len(req.prompt), 0,
                                       self.config.prefill_chunk, self.bs)
                dfresh = self.draft_blocks.alloc(dcover + 1)
                if dfresh is None:
                    # draft-pool exhaustion degrades THIS request to plain
                    # decode; it never blocks admission (zero drops)
                    req.spec_enabled = False
                else:
                    req.draft_blocks = dfresh
                    req.draft_prefill_pos = 0
            if self.blocks.prefix_caching:
                hbm_hits, misses, revived = hit_miss
                self.prefix_stats["hbm_hits"] += hbm_hits
                self.prefix_stats["host_hits"] += len(revived)
                self.prefix_stats["misses"] += misses
                runtime_metrics.add_prefix_cache_hits("hbm", hbm_hits)
                for tier in revived:
                    runtime_metrics.add_prefix_cache_hits(tier)
                runtime_metrics.add_prefix_cache_misses(misses)
            self._pending.popleft()
            req.slot = slot
            req.blocks = shared + fresh
            req.prefill_pos = matched
            self._admit_counter += 1
            req.admitted_order = self._admit_counter
            self._slot_req[slot] = req
            if self.slo_label is not None and req.t_enqueue:
                # first admission only: a preempted request re-queues with
                # t_admit set, and its queue_wait was booked once
                if not req.t_admit:
                    from ray_tpu_torch.serve._private import slo

                    req.t_admit = time.monotonic()
                    slo.record_stage(self.slo_label, "queue_wait",
                                     req.t_admit - req.t_enqueue)
                else:
                    req.t_admit = time.monotonic()

    def _decode_ready(self, req: _PagedReq) -> bool:
        """A slot joins the decode batch once its target prefill -- and,
        when it speculates, its draft prefill -- covers the prompt."""
        plen = len(req.prompt)
        if req.prefill_pos < plen:
            return False
        return not req.spec_enabled or req.draft_prefill_pos >= plen

    def _draft_prefill_chunk_locked(self, req: _PagedReq,
                                    seq: Optional[Sequence[int]] = None):
        """Dispatch one draft prefill chunk: the target's chunk geometry
        and fixed table width (the block size is shared).  ``seq``
        overrides the sequence prefilled (default: the prompt): an import
        mid-decode re-seeds the draft over prompt + generated history, so
        it proposes from the resume position."""
        seq = req.prompt if seq is None else seq
        plen = len(seq)
        remaining = plen - req.draft_prefill_pos
        c = min(self.config.prefill_chunk,
                _bucket_pow2(_pad_to(remaining, self.bs), lo=self.bs))
        p0 = req.draft_prefill_pos
        need = math.ceil((p0 + c) / self.bs)
        if need > len(req.draft_blocks):
            raise RuntimeError(
                f"draft prefill chunk not covered: need {need} blocks, have "
                f"{len(req.draft_blocks)} (draft admission reserve bug)")
        self._run_prefill(self._draft_prefill_programs, seq, req.draft_blocks,
                          p0, c)
        req.draft_prefill_pos = p0 + min(c, remaining)
        if req.draft_prefill_pos >= plen:
            # trim chunk-padding draft blocks down to the prompt's cover
            keep = math.ceil(plen / self.bs)
            if len(req.draft_blocks) > keep:
                self.draft_blocks.release(req.draft_blocks[keep:])
                del req.draft_blocks[keep:]
            self._dirty = True

    def _prefill_step_locked(self):
        """Advance mid-prefill slots, one chunk per slot, round-robin, until
        the step's token budget (default one chunk) is spent.  Prefill
        dispatches do not sync: only a final chunk's sampled token is read
        back, at the next drain.  Blocks were reserved at admission.

        With a draft model, the draft prefills the same prompt into its own
        pool, tracking the target's frontier after each target chunk (draft
        chunks ride outside the token budget, which bounds target work)."""
        budget = (self.config.prefill_token_budget
                  or self.config.prefill_budget_tokens
                  or self.config.prefill_chunk)
        progress = True
        while budget > 0 and progress:
            progress = False
            for slot in range(self.max_batch):
                if budget <= 0:
                    return
                req = self._slot_req[slot]
                if req is None or self._decode_ready(req):
                    continue
                plen = len(req.prompt)
                if req.prefill_pos >= plen:
                    # target done, draft lagging: catch up (the frontier
                    # loop below keeps them in step)
                    while req.draft_prefill_pos < plen:
                        self._draft_prefill_chunk_locked(req)
                    continue
                remaining = plen - req.prefill_pos
                c = min(self.config.prefill_chunk,
                        _bucket_pow2(_pad_to(remaining, self.bs), lo=self.bs))
                need = math.ceil((req.prefill_pos + c) / self.bs)
                if need > len(req.blocks):
                    raise RuntimeError(
                        f"prefill chunk not covered: need {need} blocks, "
                        f"have {len(req.blocks)} (admission reserve bug)")
                p0 = req.prefill_pos
                take = min(c, remaining)
                is_last = p0 + take >= plen
                sample_idx = (plen - 1 - p0) if is_last else 0
                ids = self._run_prefill(
                    self._prefill_programs, req.prompt, req.blocks, p0, c,
                    sample_idx=np.array([sample_idx], np.int32),
                    temp=np.array([req.gen.temperature], np.float32),
                    top_k=np.array([req.gen.top_k], np.int32))
                req.prefill_pos = p0 + take
                self.prefill_tokens += take
                # the draft tracks the target's prefill frontier
                while (req.spec_enabled
                       and req.draft_prefill_pos < min(req.prefill_pos, plen)):
                    self._draft_prefill_chunk_locked(req)
                progress = True
                if is_last:
                    if self.slo_label is not None and req.t_admit:
                        from ray_tpu_torch.serve._private import slo

                        slo.record_stage(self.slo_label, "prefill",
                                         time.monotonic() - req.t_admit)
                    # trim chunk-padding blocks; decode's ensure pass
                    # re-allocates
                    keep = math.ceil(plen / self.bs)
                    if len(req.blocks) > keep:
                        self.blocks.release(req.blocks[keep:])
                        del req.blocks[keep:]
                    self.blocks.register(req.prompt, req.blocks)
                    self._lengths[slot] = plen
                    self._slot_temp[slot] = req.gen.temperature
                    self._slot_topk[slot] = req.gen.top_k
                    self._first_pending.append((slot, req, _Readback(ids)))
                    self._dirty = True
                budget -= take
                self._tel_prefill_spent += take

    def _emit_locked(self, req: _PagedReq, token: int):
        req.out_tokens.append(token)
        if self.slo_label is not None and not req.t_first_emit:
            req.t_first_emit = time.monotonic()
        if (token in req.gen.stop_token_ids
                or len(req.out_tokens) >= req.gen.max_new_tokens
                or self._lengths[req.slot] + 1 >= self.max_seq):
            req.done = True
            if self.slo_label is not None and req.t_first_emit:
                from ray_tpu_torch.serve._private import slo

                slo.record_stage(self.slo_label, "decode",
                                 time.monotonic() - req.t_first_emit)
            if self._spec is not None and req.spec_proposed:
                # per-request acceptance, kept for specdec_request_stats
                self._spec_finished[req.request_id] = (
                    req.spec_proposed, req.spec_accepted)
                while len(self._spec_finished) > 1024:
                    self._spec_finished.popitem(last=False)
            self._free_slot_locked(req)

    def _free_slot_locked(self, req: _PagedReq):
        self.blocks.release(req.blocks)
        req.blocks = []
        if req.draft_blocks:
            self.draft_blocks.release(req.draft_blocks)
            req.draft_blocks = []
        self._slot_req[req.slot] = None
        self._lengths[req.slot] = 0
        req.slot = -1
        self._dirty = True

    def _preempt_locked(self, exclude_slot: int = -1) -> bool:
        """Evict the youngest decode-active request by recompute: free its
        blocks, requeue with prompt+generated as the new prompt.  The OLDEST
        active request is never evicted, so the system makes progress."""
        candidates = [r for r in self._slot_req
                      if r is not None and r.slot != exclude_slot
                      and r.prefill_pos >= len(r.prompt)]
        if len(candidates) < 2:
            return False  # never evict the sole (oldest) runner
        oldest = min(c.admitted_order for c in candidates)
        victim = max((c for c in candidates if c.admitted_order > oldest),
                     key=lambda c: c.admitted_order, default=None)
        if victim is None:
            return False
        victim.prompt = victim.prompt + victim.out_tokens
        victim.prefill_pos = 0
        victim.draft_prefill_pos = 0
        self._free_slot_locked(victim)
        # recompute re-prefills the draft pool too, so a request degraded
        # by draft-pool pressure gets a fresh chance to speculate
        victim.spec_enabled = self._spec is not None
        victim.done = False
        self._pending.appendleft(victim)
        self._dirty = True
        return True

    # -- decode ---------------------------------------------------------

    def _ensure_decode_blocks_locked(self, margin: int) -> List[int]:
        """Every decode-active slot's table must cover lengths + margin
        appends before dispatch. Returns the decode-active slot list."""
        restart = True
        while restart:
            restart = False
            active = []
            for s in range(self.max_batch):
                req = self._slot_req[s]
                if req is None or not self._decode_ready(req):
                    continue
                while True:
                    need = math.ceil(
                        (int(self._lengths[s]) + margin) / self.bs)
                    need = min(need, self.max_blocks_per_seq)
                    deficit = need - len(req.blocks)
                    if deficit <= 0:
                        self._ensure_draft_blocks_locked(req, need)
                        active.append(s)
                        break
                    fresh = self.blocks.alloc(deficit)
                    if fresh is not None:
                        req.blocks.extend(fresh)
                        # the draft's table must cover the same appends (the
                        # JAX engine skips this here: ROADMAP C3)
                        self._ensure_draft_blocks_locked(req, need)
                        active.append(s)
                        break
                    if self._inflight is not None:
                        # the in-flight chunk may still WRITE blocks a
                        # victim owns — never free them under it.  The
                        # drain advances lengths and trims margin blocks,
                        # so restart the whole pass (at most once).
                        self._drain_locked()
                        restart = True
                        break
                    if not self._preempt_locked():
                        # can't evict anyone else; run without this slot
                        # rather than deadlock
                        break
                    if self._slot_req[s] is None:
                        break  # we were the youngest and got evicted
                if restart:
                    break
        return [s for s in active if self._slot_req[s] is not None]

    def _ensure_draft_blocks_locked(self, req: _PagedReq, need: int):
        """Draft-pool coverage for a decode-ready speculating slot.
        Exhaustion never preempts or stalls anyone: the request degrades to
        plain decode (its draft blocks returned), and stays degraded for
        this residency (recompute after preemption re-enables it)."""
        if not req.spec_enabled:
            return
        deficit = need - len(req.draft_blocks)
        if deficit <= 0:
            return
        fresh = self.draft_blocks.alloc(deficit)
        if fresh is not None:
            req.draft_blocks.extend(fresh)
            return
        self.draft_blocks.release(req.draft_blocks)
        req.draft_blocks = []
        req.spec_enabled = False
        self._dirty = True  # the device spec mask must refresh

    def _trim_locked(self, margin: int = 0):
        """Return over-allocated chunk blocks (sequence stopped early).
        ``margin``: appends the device may still make (an in-flight chunk)
        beyond the host's view of lengths — those blocks must be kept."""
        for s in range(self.max_batch):
            req = self._slot_req[s]
            if req is None or req.prefill_pos < len(req.prompt):
                continue
            keep = max(1, math.ceil(
                (int(self._lengths[s]) + margin + 1) / self.bs))
            if len(req.blocks) > keep:
                self.blocks.release(req.blocks[keep:])
                del req.blocks[keep:]
            if req.draft_blocks and len(req.draft_blocks) > keep:
                self.draft_blocks.release(req.draft_blocks[keep:])
                del req.draft_blocks[keep:]

    def _collect_locked(self, em: _Readback, active: List[int], margin: int,
                        spec_slots: Sequence[int] = (),
                        acc: Optional[_Readback] = None):
        """Book one finished decode chunk's tokens into host state.
        ``margin``: appends another still-in-flight chunk may make beyond
        this one.  ``spec_slots``: slots that ran this chunk WITH
        speculation; their acceptance is booked from ``acc`` (the
        verifier's true per-slot counts) before the emit loop, so a request
        finishing here reports its final stats.  Slots with no emission
        book nothing."""
        em = em.numpy()  # waits for this chunk only (a later one runs on)
        if spec_slots:
            acc = acc.numpy()
            proposed = accepted = 0
            k = self._spec_k
            for s in spec_slots:
                req = self._slot_req[s]
                if int((em[:, s] >= 0).sum()) <= 0:
                    continue
                got = min(int(acc[s]), k)
                proposed += k
                accepted += got
                if req is not None:
                    req.spec_proposed += k
                    req.spec_accepted += got
            if proposed:
                self._spec_proposed_total += proposed
                self._spec_accepted_total += accepted
                self._book_specdec(proposed, accepted)
        for t in range(em.shape[0]):
            for s in active:
                req = self._slot_req[s]
                if req is None:
                    continue
                tok = int(em[t, s])
                if tok < 0:
                    continue
                self._lengths[s] += 1
                self._next_tok[s] = tok
                self._emit_locked(req, tok)
        self._trim_locked(margin=margin)

    def _book_specdec(self, proposed: int, accepted: int):
        """Meter drafted/accepted token counts into the runtime-metrics
        families and the serving SLO ledger.  Called only with speculation
        configured: the disabled path books nothing."""
        dep = self.slo_label or "engine"
        runtime_metrics.add_specdec_tokens(dep, proposed, accepted)
        if self.slo_label is not None:
            from ray_tpu_torch.serve._private import slo

            # the ledger's fold (state.serving_slo()); under the process
            # ledger's lock only, never an RPC under step()'s engine lock
            slo.note_specdec(self.slo_label, proposed, accepted)

    def _resolve_first_tokens_locked(self):
        """Book pending first tokens (their programs finished long before
        the drain that calls this)."""
        pending, self._first_pending = self._first_pending, []
        for slot, req, ids in pending:
            if self._slot_req[slot] is not req:
                continue  # preempted before its first token surfaced:
                # recompute will re-sample it (it was never emitted)
            first = int(ids.numpy()[0])
            self._next_tok[slot] = first
            self._emit_locked(req, first)

    def _drain_locked(self):
        """Collect the in-flight decode chunk, if any, and any pending
        first tokens."""
        if self._inflight is not None:
            em, active, spec_slots, acc = self._inflight
            self._inflight = None
            self._collect_locked(em, active, 0, spec_slots, acc)
        self._resolve_first_tokens_locked()

    @torch.no_grad()
    def step(self, decode: bool = True) -> Dict[int, List[int]]:
        """One engine step: admit, prefill chunks, one decode chunk.

        Steady-state decode PIPELINES: the chunk dispatched here is
        collected on the NEXT step, so its device compute overlaps this
        step's host bookkeeping.  Any non-steady event (a finished prefill,
        a finished request, preemption pressure) drains the in-flight chunk
        first.  ``decode=False`` runs admission/prefill only.  With
        telemetry attached, the step books its host seconds over the wall
        since the last step ended: the body waits on the previous chunk's
        tokens, so its time follows the card without a synchronize."""
        now = time.monotonic()
        # device telemetry: one attribute read + None check when disabled
        tel = self._telemetry
        tel_active = tel_free = tel_pending = 0
        with self._lock:
            self._tel_prefill_spent = 0
            before = self._emit_snapshot_locked()
            if self._pending or any(
                    r is not None and not self._decode_ready(r)
                    for r in self._slot_req):
                # admission + prefill run WITHOUT draining the in-flight
                # decode chunk: a new slot's blocks are disjoint from every
                # in-flight table row, and the stream orders the writes
                self._admit_locked()
                self._prefill_step_locked()
            chunk = self.config.decode_chunk
            # device appends per dispatch: a speculative cycle writes up to
            # k+1 positions (k drafted + the bonus), a plain chunk `chunk`
            app = self._spec_k + 1 if self._spec is not None else chunk
            if decode:
                # margin covers this dispatch plus one still in flight
                margin = app + 1 + (app if self._inflight else 0)
                active = self._ensure_decode_blocks_locked(margin)
            else:
                active = []
            if active and self._dirty:
                self._drain_locked()
                self._refresh_mirrors_locked()
                # the drain advanced lengths and trimmed the margin blocks
                # just reserved: re-run coverage (nothing is in flight now)
                active = self._ensure_decode_blocks_locked(app + 1)
                if self._dirty:
                    # the re-run preempted someone: mirrors are stale again
                    self._refresh_mirrors_locked()
                    active = [s for s in active
                              if self._slot_req[s] is not None]
            if active:
                w = _bucket_pow2(max(len(self._slot_req[s].blocks)
                                     for s in active))
                table = np.zeros((self.max_batch, w), np.int32)
                for s in active:
                    blks = self._slot_req[s].blocks
                    table[s, :len(blks)] = blks
                spec_slots: Tuple[int, ...] = ()
                if self._spec is not None:
                    spec_slots = tuple(s for s in active
                                       if self._slot_req[s].spec_enabled)
                if spec_slots:
                    em_dev, acc_dev = self._spec_step_locked(table, spec_slots)
                    inflight = (_Readback(em_dev), active, spec_slots,
                                _Readback(acc_dev))
                else:
                    # the copy into the program's table follows, in stream
                    # order, the in-flight chunk that may still read it
                    em = self._spmd("dispatch", self._programs.name, w,
                                    {"table": table})
                    inflight = (_Readback(em), active, (), None)
                    self.decode_steps += em.shape[0]
                    self._book_tp_collectives("decode", em.shape[0])
                prev, self._inflight = self._inflight, inflight
                if prev is not None:
                    # collect chunk N while chunk N+1 computes; the device
                    # is up to `app` appends ahead of the collected view
                    self._collect_locked(prev[0], prev[1], app, prev[2],
                                         prev[3])
            else:
                self._drain_locked()
            emitted = self._gather_emitted_locked(before)
            if tel is not None:
                # captured under the lock into locals; booked after release
                tel_active = sum(1 for r in self._slot_req if r is not None)
                tel_free = self.blocks.num_free()
                tel_pending = len(self._pending)
        if tel is not None:
            t_end = time.monotonic()
            tel.note_step(
                active_slots=tel_active, max_slots=self.max_batch,
                free_blocks=tel_free, total_blocks=self.num_blocks - 1,
                pending=tel_pending,
                prefill_spent=self._tel_prefill_spent,
                prefill_budget=self._tel_prefill_budget,
                busy_s=t_end - now, now=t_end)
        return emitted

    def _spec_step_locked(self, table: np.ndarray,
                          spec_slots: Tuple[int, ...]):
        """One speculative cycle: the draft proposes k tokens per slot
        (k+1 small steps), the target verifies them all in ONE window
        forward.  Two replays, no host sync; the emitted ids are collected
        on the next step as a plain chunk's are.  Returns (emitted [k+1, B],
        accepted [B]) on the device.

        Slots that do not speculate ride the same verify program with a
        zero spec mask: no acceptance, and one exact plain decode sample
        each.  (A batch with no speculating slot runs the plain chunk at
        k+1 steps instead; ``step`` decides.)  The draft table takes the
        target table's bucketed width: the block counts track each other,
        so one width means one propose program per verify program."""
        dtable = np.zeros_like(table)
        for s in spec_slots:
            blks = self._slot_req[s].draft_blocks
            dtable[s, :len(blks)] = blks
        w = table.shape[1]
        self._spmd("dispatch", self._propose_programs.name, w,
                   {"table": dtable})
        em = self._spmd("dispatch", self._verify_programs.name, w,
                        {"table": table})
        self._book_tp_collectives("verify")
        self.spec_cycles += 1
        return em, self._verify_programs.get(w).buffers["accepted"]

    @torch.no_grad()
    def flush(self) -> Dict[int, List[int]]:
        """Collect any in-flight decode chunk and return its tokens."""
        with self._lock:
            before = self._emit_snapshot_locked()
            self._drain_locked()
            return self._gather_emitted_locked(before)

    def cancel_request(self, request_id: int) -> bool:
        """Abort a live request and return its slot + blocks to the pool
        now.  Safe at any lifecycle point: queued, mid-prefill, or
        decode-active.  Returns False if the request already finished (or
        never existed)."""
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                return False
            del self._requests[request_id]
            if req in self._pending:
                self._pending.remove(req)
            elif req.slot >= 0:
                # the in-flight chunk may still WRITE blocks this request
                # owns — never free them under it
                if self._inflight is not None:
                    self._drain_locked()
                if req.slot >= 0 and self._slot_req[req.slot] is req:
                    self._free_slot_locked(req)
            req.done = True
            flight_recorder.record("request", self.slo_label or "paged",
                                   (request_id, "cancel"))
            return True

    # -- disaggregated prefill/decode handoff and live migration ----------

    def _payload(self, t: torch.Tensor):
        """A handoff array on the host: numpy for fp32 and fp16 pools.  A
        bf16 pool's is numpy too, of ``ml_dtypes.bfloat16`` viewed from the
        tensor's bits, where ``ml_dtypes`` imports (the JAX package's own
        payload form, which its ``import_request`` takes); elsewhere a CPU
        tensor (pinned on CUDA), numpy having no bf16 of its own."""
        out = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=self.device.type == "cuda")
        out.copy_(t)
        if out.dtype != torch.bfloat16:
            return out.numpy()
        try:
            import ml_dtypes
        except ImportError:
            return out
        return out.view(torch.int16).numpy().view(ml_dtypes.bfloat16)

    @torch.no_grad()
    def export_request(self, request_id: int, on_device: bool = False) -> Dict:
        """Export a live request's KV blocks and emitted history and free
        its slot.  Two callers: the prefill stage of a disaggregated
        deployment (right after prefill: the history is the first token)
        and live migration (mid-decode: the in-flight chunk is drained
        first, as ``cancel_request`` drains, and the handoff carries what
        the destination needs to resume at the exact position).  The
        request's registered prompt blocks stay revivable here.

        Returns {prompt, first_token, k, v, block_size, emitted, gen}: k/v
        [L, nblocks, block_size, kv*hd] covering exactly the live positions
        (prompt + generated so far, the last emitted token's KV excepted),
        as numpy arrays (a bf16 pool's: ``ml_dtypes.bfloat16``, or CPU
        tensors where ``ml_dtypes`` does not import); with ``on_device`` they
        stay tensors of the pool's dtype on the engine's device (fresh
        gathers, for a device channel: no host copy); emitted is the
        whole output history, gen the sampling, stop and budget settings.
        Raises if the request is not exportable (unknown, finished, its
        prefill incomplete or its first token unresolved)."""
        with self._lock:
            self._drain_locked()  # resolve the in-flight chunk's tokens
            req = self._requests.get(request_id)
            if req is None or req.done or req.slot < 0:
                raise KeyError(
                    f"request {request_id} is not exportable (finished or "
                    "unknown — use max_new_tokens >= 2 for prefill-stage "
                    "requests)")
            if req.prefill_pos < len(req.prompt):
                raise RuntimeError(
                    f"request {request_id} prefill incomplete "
                    f"({req.prefill_pos}/{len(req.prompt)})")
            if not req.out_tokens:
                raise RuntimeError(
                    f"request {request_id} first token unresolved")
            # the pool covers positions 0..lengths-1; mid-decode the block
            # list may run ahead (the decode margin): export the live cover
            live = int(self._lengths[req.slot])
            nb_live = max(1, math.ceil(live / self.bs))
            # the canonical full-width layout, whatever the mesh
            k, v = self._spmd("gather", req.blocks[:nb_live])
            if not on_device:
                k, v = self._payload(k), self._payload(v)
            g = req.gen
            out = {"prompt": list(req.prompt),
                   "first_token": int(req.out_tokens[0]),
                   "k": k, "v": v, "block_size": self.bs,
                   "emitted": [int(t) for t in req.out_tokens],
                   "gen": {"max_new_tokens": g.max_new_tokens,
                           "temperature": g.temperature,
                           "top_k": g.top_k, "seed": g.seed,
                           "stop_token_ids": list(g.stop_token_ids)}}
            req.done = True
            self._free_slot_locked(req)
            del self._requests[request_id]
            return out

    def _handoff_tensor(self, a, device) -> torch.Tensor:
        """A handoff array (numpy, numpy bf16 by its bits, or a tensor) as
        a tensor of the pool's dtype on ``device``."""
        if isinstance(a, np.ndarray):
            # a copy where numpy's is read-only (JAX's are): torch takes
            # writable arrays only
            a = np.array(a, copy=not a.flags.writeable or None, order="C")
            if a.dtype.name == "bfloat16":  # ml_dtypes' type, from JAX
                a = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
            else:
                a = torch.from_numpy(a)
        return a.to(device, non_blocking=True).to(self.pool["k"].dtype)

    @torch.no_grad()
    def import_request(self, prompt: Sequence[int], first_token: int, k, v,
                       gen: Optional[GenerationConfig] = None,
                       emitted: Optional[Sequence[int]] = None):
        """Admit a request straight into the decode state from handed-off
        KV: allocate pool blocks, write the KV in, register the prompt's
        chain for prefix sharing, and resume decode.  Two callers: the
        decode stage of a disaggregated deployment (``emitted`` omitted:
        ``first_token`` is emitted as the first output token) and live
        migration (``emitted`` is the source's whole output history: decode
        resumes at position prompt + len(emitted) - 1 and the history is
        not emitted again).  With a draft model the draft's KV is
        recomputed over prompt + history (the handoff carries the target's
        only), so the request speculates at once; draft-pool exhaustion
        degrades it to plain decode.

        The ``nb`` blocks are written directly, in place (the JAX program
        pads the scatter to a pow2 block count only to fix its jit shapes).
        ``k``/``v``: numpy arrays (a numpy bf16 array by its bits) or
        tensors, [L, nb, block_size, kv*hd].

        Returns {request_id, emitted, done}, or None when no slot or blocks
        are free now (the caller falls back to ``add_request``, recompute).
        Never queues."""
        gen = gen or GenerationConfig()
        plen = len(prompt)
        if plen == 0:
            raise ValueError("empty prompt")
        if emitted is not None and not emitted:
            raise ValueError("emitted history must hold >= 1 token")
        self._check_request(prompt, gen)
        resume = emitted is not None
        hist = [int(t) for t in emitted] if resume else [int(first_token)]
        # live positions the handoff covers: the prompt and every emitted
        # token but the last, whose KV the NEXT decode step writes
        live = plen + len(hist) - 1
        nb = int(k.shape[1])
        if nb != max(1, math.ceil(live / self.bs)):
            raise ValueError(
                f"handoff covers {nb} blocks but {live} live tokens "
                f"need {max(1, math.ceil(live / self.bs))} at block_size "
                f"{self.bs}")
        want = (self.pool["k"].shape[0], nb, self.bs,
                self.cfg.n_kv_heads * self.cfg.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(
                f"handoff k/v shapes {tuple(k.shape)}, {tuple(v.shape)} are "
                f"not the pool's blocks {want}")
        with self._lock:
            slot = next((s for s in range(self.max_batch)
                         if self._slot_req[s] is None), None)
            if slot is None:
                return None
            blocks = self.blocks.alloc(nb)
            if blocks is None:
                return None
            # ranks take host tensors (broadcast), each writes its heads
            dev = torch.device("cpu") if self._spmd_on else self.device
            self._spmd("scatter", list(blocks), self._handoff_tensor(k, dev),
                       self._handoff_tensor(v, dev))
            self._req_counter += 1
            req = _PagedReq(self._req_counter, [int(t) for t in prompt], gen)
            req.slot = slot
            req.blocks = list(blocks)
            req.prefill_pos = plen
            self._admit_counter += 1
            req.admitted_order = self._admit_counter
            self._requests[req.request_id] = req
            self._slot_req[slot] = req
            self.blocks.register(req.prompt, req.blocks)
            self._lengths[slot] = live
            if self._spec is not None:
                # the draft re-seed: prefill the draft over every live
                # position (prompt + history), chunked as its prefill is
                req.spec_enabled = True
                dseq = req.prompt + hist[:-1]
                dcover = _prefill_plan(len(dseq), 0,
                                       self.config.prefill_chunk, self.bs)
                dfresh = self.draft_blocks.alloc(dcover + 1)
                if dfresh is None:
                    req.spec_enabled = False
                else:
                    req.draft_blocks = dfresh
                    while req.draft_prefill_pos < len(dseq):
                        self._draft_prefill_chunk_locked(req, seq=dseq)
            self._next_tok[slot] = hist[-1]
            self._slot_temp[slot] = gen.temperature
            self._slot_topk[slot] = gen.top_k
            self._dirty = True
            # the source sampled these tokens; they count toward the budget
            # as in the monolithic flow.  The history is seeded without
            # emission; only the last token runs the emit/done transition
            req.out_tokens = hist[:-1]
            self._emit_locked(req, hist[-1])
            return {"request_id": req.request_id,
                    "emitted": [] if resume else [int(first_token)],
                    "done": req.done}

    def _refresh_mirrors_locked(self):
        self._resolve_first_tokens_locked()  # _next_tok must be current
        decode_ready = np.array(
            [0 if (r is None or not self._decode_ready(r)) else 1
             for r in self._slot_req], np.int32)
        remaining = np.zeros(self.max_batch, np.int32)
        stops = np.full((self.max_batch, _MAX_STOP_IDS), -1, np.int32)
        for s, r in enumerate(self._slot_req):
            if r is not None and decode_ready[s]:
                remaining[s] = r.gen.max_new_tokens - len(r.out_tokens)
                for j, sid in enumerate(r.gen.stop_token_ids):
                    stops[s, j] = sid
        spec = {}
        if self._spec is not None:
            spec["spec"] = np.array(
                [1 if (decode_ready[s] and r.spec_enabled) else 0
                 for s, r in enumerate(self._slot_req)], np.int32)
        self._spmd("load", dict(
            tokens=self._next_tok.copy(), lengths=self._lengths.copy(),
            active=decode_ready, temps=self._slot_temp.copy(),
            top_ks=self._slot_topk.copy(), remaining=remaining, stops=stops,
            **spec))
        self._dirty = False

    # -- speculative decoding surfaces -----------------------------------

    def specdec_stats(self) -> Optional[Dict[str, float]]:
        """Engine-lifetime acceptance totals, or None without a draft
        model."""
        if self._spec is None:
            return None
        with self._lock:
            p, a = self._spec_proposed_total, self._spec_accepted_total
        return {"k": self._spec_k, "proposed": p, "accepted": a,
                "acceptance_rate": (a / p) if p else 0.0}

    def specdec_request_stats(self, request_id: int):
        """(proposed, accepted) of a FINISHED request, or None (unknown id,
        no draft model, or the request never speculated)."""
        if self._spec is None:
            return None
        with self._lock:
            return self._spec_finished.get(request_id)

    # -- warmup -------------------------------------------------------

    @torch.no_grad()
    def warmup(self, max_len: Optional[int] = None, decode: bool = True):
        """Make the decode program of every table width serving can
        dispatch, and the prefill program of every reachable chunk width,
        so no capture or first-use cost lands in the serving window.
        ``decode=False`` makes the prefill programs only, for an engine
        that is only ever stepped with ``step(decode=False)`` (the
        disaggregated prefill stage).

        Widths are powers of two up to the per-sequence block cap, or up to
        the blocks covering ``max_len`` plus the pipelining margin, if
        given (the JAX engine's buckets).  On CUDA each program runs once
        on zeroed inputs (an idle scratch state for a decode chunk) and is
        then captured into a CUDA graph.  All-zero tables send every write
        to sink block 0, so engine state is untouched: the block manager,
        the host slot state, the device loop state and every other pool
        block.  The runs sample from a throwaway generator, so warming does
        not move the engine's sampling stream either: greedy and sampled
        outputs are those of an unwarmed engine.  An in-flight chunk stays
        in flight (its work is ordered before the warm-up runs).

        With a draft model, serving dispatches propose and verify at each
        width, and the plain chunk at k+1 steps for a batch in which no
        slot speculates: all three are made per width, and the draft's
        prefill program at every chunk width beside the target's."""
        chunk = self.config.decode_chunk
        w_cap = _bucket_pow2(self.max_blocks_per_seq)
        if max_len is not None:
            need = math.ceil((max_len + 2 * chunk + 1) / self.bs)
            w_cap = min(w_cap,
                        _bucket_pow2(min(need, self.max_blocks_per_seq)))
        with self._lock:
            w = 1
            while decode:
                self._spmd("warm", self._programs.name, w)
                if self._spec is not None:
                    self._spmd("warm", self._propose_programs.name, w)
                    self._spmd("warm", self._verify_programs.name, w)
                if w >= w_cap:
                    break
                w *= 2
            # prefill programs: one per pow2 chunk width (the table width
            # is fixed); serving caps chunks at the bucketed max prompt
            # width and the fixed table's coverage: warm only those
            c_cap = min(self.config.prefill_chunk,
                        self._prefill_w * self.bs,
                        _bucket_pow2(_pad_to(self.max_seq, self.bs),
                                     lo=self.bs))
            c = self.bs
            while True:
                c = min(c, c_cap)
                self._spmd("warm", self._prefill_programs.name, c)
                if self._spec is not None:
                    self._spmd("warm", self._draft_prefill_programs.name, c)
                if c >= c_cap:
                    break
                c *= 2
