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

The host side (``BlockManager``, the prefill planning functions) is a copy
of the JAX package's, kept here because the port imports nothing of
``ray_tpu``; tests/test_torch_paged_engine.py holds both copies to the
same sequences.  The device programs run eagerly: a decode chunk is
``decode_chunk`` token steps with stop and budget handling on the device
and no host sync inside; its emitted ids travel to the host by a
non-blocking copy and an event, collected on the next step, so one chunk
stays in flight while the host books the previous one.  On CUDA the
kernel ``ops/paged_attention`` carries decode attention.

Not ported in this slice (ROADMAP.md): tracing, SLO stamps and device
telemetry, tensor parallelism, the host/plasma prefix tiers, speculative
decoding, export/import of requests, and ``warmup`` (eager PyTorch has
nothing to compile).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.prefix_hash import chain_hash
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, check_supported
from ray_tpu_torch.llm.engine import (
    _MAX_STOP_IDS,
    _MAX_TOP_K,
    _Request,
    _sample,
    resolve_device,
)
from ray_tpu_torch.models import llama


class BlockManager:
    """Host-side allocator + prefix cache over the device block pool.

    The JAX package's ``on_evict`` demotion hook and ``adopt`` serve the
    host/plasma prefix tiers and come back with them (ROADMAP A4 rest)."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_caching: bool = True):
        self.num_blocks = num_blocks
        self.bs = block_size
        self.prefix_caching = prefix_caching
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


@dataclasses.dataclass
class _PagedReq(_Request):
    blocks: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0      # prompt tokens already in the pool
    admitted_order: int = 0   # preemption picks the youngest


def _bucket_pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


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


class _Readback:
    """A device tensor on its way to the host: on CUDA a non-blocking copy
    into pinned memory plus an event, so the host waits only when it reads
    (``numpy()``); on the CPU a plain copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _use_paged_kernel(want, cfg: "llama.LlamaConfig", device,
                      pool_dtype: torch.dtype) -> bool:
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
    refusal = llama.paged_kernel_refusal(cfg, device, pool_dtype)
    if refusal:
        raise ValueError(
            f"paged_attention_kernel={want}: {refusal}; pass "
            f"paged_attention_kernel=False for the table gather")
    return True


class PagedTorchLLMEngine:
    """The paged engine's API (``add_request``, ``step``, ``flush``,
    ``cancel_request``, ``generate``) over a block pool on ``device``.

    ``device`` defaults to CUDA (raising without a GPU); ``params`` None
    draws random weights from ``generator`` (default: seed 0)."""

    def __init__(self, config: LLMConfig, params=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
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
        # one fixed prefill table width: the simulated worst case over every
        # prompt length and chunk start (see _prefill_table_width)
        self._prefill_w = _prefill_table_width(
            self.max_seq, config.prefill_chunk, self.bs)
        self.blocks = BlockManager(nb, self.bs, config.enable_prefix_caching)

        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = llama.init_params(cfg, generator, self.device)
        self.params = params
        self._rope = llama.rope_cache(cfg, self.max_seq, self.device)
        self.pool = llama.init_paged_kv_cache(cfg, nb, self.bs, self.device)

        # host slot state
        self._slot_req: List[Optional[_PagedReq]] = [None] * self.max_batch
        self._lengths = np.zeros(self.max_batch, np.int32)
        self._next_tok = np.zeros(self.max_batch, np.int32)
        self._slot_temp = np.zeros(self.max_batch, np.float32)
        self._slot_topk = np.zeros(self.max_batch, np.int32)
        self._dirty = True
        self._d_next = self._d_lengths = self._d_active = None
        self._d_temp = self._d_topk = None
        self._d_remaining = self._d_stops = None
        # sampling noise stays on the device (the JAX engine's PRNG key)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.vocab_size + 1)
        self._pending: "collections.deque[_PagedReq]" = collections.deque()
        self._requests: Dict[int, _PagedReq] = {}
        self._req_counter = 0
        self._admit_counter = 0
        self._lock = threading.Lock()
        # one decode chunk may stay IN FLIGHT while the host books the
        # previous chunk's tokens: (emitted readback, active slots)
        self._inflight: Optional[Tuple[_Readback, List[int]]] = None
        # a finished prefill's first token stays a pending readback until
        # the next drain point: (slot, req, readback)
        self._first_pending: List[Tuple[int, _PagedReq, _Readback]] = []
        # work counters: token steps of decode dispatched, prompt tokens
        # prefilled
        self.decode_steps = 0
        self.prefill_tokens = 0

        self._use_kernel = _use_paged_kernel(
            config.paged_attention_kernel, cfg, self.device,
            self.pool["k"].dtype)

    # -- device programs -------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream sync (pinned,
        non-blocking), so an in-flight chunk keeps running.  A copy: later
        host edits of ``arr`` never reach the device state."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _decode_chunk_impl(self, tokens, table, lengths, active, remaining,
                           stops, temps, top_ks, n_steps: int):
        """Multi-step paged decode, all on the device (the host guarantees
        every active slot's table covers lengths + n_steps appends).
        Returns (emitted [n_steps, B] (-1 where inactive), tokens, lengths,
        active, remaining)."""
        emitted = []
        for _ in range(n_steps):
            logits, _ = llama.decode_step_paged(
                self.cfg, self.params, tokens, self.pool, table, lengths,
                self._rope, use_kernel=self._use_kernel)
            ids = _sample(logits, self._gen, temps, top_ks)
            emitted.append(torch.where(active > 0, ids, -1))
            lengths = lengths + active
            remaining = remaining - active
            hit_stop = (stops == ids[:, None]).any(-1)
            done = (active > 0) & (hit_stop | (remaining <= 0)
                                   | (lengths + 1 >= self.max_seq))
            active = active * (~done).to(active.dtype)
            tokens = torch.where(active > 0, ids, tokens)
        return torch.stack(emitted), tokens, lengths, active, remaining

    def _prefill_chunk_impl(self, tokens, table, p0: int, sample_idx: int,
                            temp, top_k):
        """One chunk; also samples the token at chunk-local position
        ``sample_idx`` (the caller uses it only on the final chunk)."""
        logits, _ = llama.prefill_chunk_paged(
            self.cfg, self.params, tokens, self.pool, table, p0, self._rope)
        return _sample(logits[:, sample_idx], self._gen, temp, top_k)

    # -- request lifecycle ---------------------------------------------

    def add_request(self, prompt: Sequence[int],
                    gen: Optional[GenerationConfig] = None) -> int:
        gen = gen or GenerationConfig()
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(gen.stop_token_ids) > _MAX_STOP_IDS:
            raise ValueError(
                f"at most {_MAX_STOP_IDS} stop_token_ids supported "
                f"(got {len(gen.stop_token_ids)})")
        if gen.top_k > _MAX_TOP_K:
            raise ValueError(
                f"top_k is capped at {_MAX_TOP_K} (got {gen.top_k}) — the "
                "kth threshold comes from a fixed-width top-k")
        if len(prompt) + gen.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({gen.max_new_tokens})"
                f" exceeds max_seq_len {self.max_seq}")
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
            self._requests[req.request_id] = req
            self._pending.append(req)
            return req.request_id

    def has_work(self) -> bool:
        with self._lock:
            return (bool(self._pending) or self._inflight is not None
                    or any(r is not None for r in self._slot_req))

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
            shared, matched = self.blocks.match_prefix(req.prompt)
            # reserve every block any (pow2-bucketed) prefill chunk's table
            # must cover; +1 is the first decode write's spare
            cover = _prefill_plan(len(req.prompt), matched,
                                  self.config.prefill_chunk, self.bs)
            need = cover - len(shared) + 1
            fresh = self.blocks.alloc(need)
            if fresh is None:
                self.blocks.release(shared)
                return  # pool full: keep FIFO order, retry next step
            self._pending.popleft()
            req.slot = slot
            req.blocks = shared + fresh
            req.prefill_pos = matched
            self._admit_counter += 1
            req.admitted_order = self._admit_counter
            self._slot_req[slot] = req

    def _decode_ready(self, req: _PagedReq) -> bool:
        """A slot joins the decode batch once its prefill covers the prompt."""
        return req.prefill_pos >= len(req.prompt)

    def _prefill_step_locked(self):
        """Advance mid-prefill slots, one chunk per slot, round-robin, until
        the step's token budget (default one chunk) is spent.  Prefill
        dispatches do not sync: only a final chunk's sampled token is read
        back, at the next drain.  Blocks were reserved at admission."""
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
                tokens = np.zeros((1, c), np.int32)
                tokens[0, :take] = req.prompt[p0:p0 + take]
                table = np.zeros((1, self._prefill_w), np.int32)
                table[0, :len(req.blocks)] = req.blocks
                is_last = p0 + take >= plen
                sample_idx = (plen - 1 - p0) if is_last else 0
                ids = self._prefill_chunk_impl(
                    self._upload(tokens), self._upload(table), p0, sample_idx,
                    self._upload(np.array([req.gen.temperature], np.float32)),
                    self._upload(np.array([req.gen.top_k], np.int32)))
                req.prefill_pos = p0 + take
                self.prefill_tokens += take
                progress = True
                if is_last:
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

    def _emit_locked(self, req: _PagedReq, token: int):
        req.out_tokens.append(token)
        if (token in req.gen.stop_token_ids
                or len(req.out_tokens) >= req.gen.max_new_tokens
                or self._lengths[req.slot] + 1 >= self.max_seq):
            req.done = True
            self._free_slot_locked(req)

    def _free_slot_locked(self, req: _PagedReq):
        self.blocks.release(req.blocks)
        req.blocks = []
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
        self._free_slot_locked(victim)
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
                        active.append(s)
                        break
                    fresh = self.blocks.alloc(deficit)
                    if fresh is not None:
                        req.blocks.extend(fresh)
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

    def _collect_locked(self, em: _Readback, active: List[int], margin: int):
        """Book one finished decode chunk's tokens into host state.
        ``margin``: appends another still-in-flight chunk may make beyond
        this one."""
        em = em.numpy()  # waits for this chunk only (a later one runs on)
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
            em, active = self._inflight
            self._inflight = None
            self._collect_locked(em, active, margin=0)
        self._resolve_first_tokens_locked()

    @torch.no_grad()
    def step(self, decode: bool = True) -> Dict[int, List[int]]:
        """One engine step: admit, prefill chunks, one decode chunk.

        Steady-state decode PIPELINES: the chunk dispatched here is
        collected on the NEXT step, so its device compute overlaps this
        step's host bookkeeping.  Any non-steady event (a finished prefill,
        a finished request, preemption pressure) drains the in-flight chunk
        first.  ``decode=False`` runs admission/prefill only."""
        with self._lock:
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
            if decode:
                # margin covers this dispatch plus one still in flight
                margin = chunk + 1 + (chunk if self._inflight else 0)
                active = self._ensure_decode_blocks_locked(margin)
            else:
                active = []
            if active and self._dirty:
                self._drain_locked()
                self._refresh_mirrors_locked()
                # the drain advanced lengths and trimmed the margin blocks
                # just reserved: re-run coverage (nothing is in flight now)
                active = self._ensure_decode_blocks_locked(chunk + 1)
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
                (em_dev, self._d_next, self._d_lengths, self._d_active,
                 self._d_remaining) = self._decode_chunk_impl(
                    self._d_next, self._upload(table), self._d_lengths,
                    self._d_active, self._d_remaining, self._d_stops,
                    self._d_temp, self._d_topk, chunk)
                self.decode_steps += chunk
                prev, self._inflight = self._inflight, (_Readback(em_dev),
                                                        active)
                if prev is not None:
                    # collect chunk N while chunk N+1 computes; the device
                    # is up to `chunk` appends ahead of the collected view
                    self._collect_locked(prev[0], prev[1], margin=chunk)
            else:
                self._drain_locked()
            return self._gather_emitted_locked(before)

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
            return True

    def _emit_snapshot_locked(self) -> Dict[int, int]:
        return {id(r): len(r.out_tokens) for r in self._requests.values()}

    def _gather_emitted_locked(self, before: Dict[int, int]):
        emitted: Dict[int, List[int]] = {}
        for req in list(self._requests.values()):
            n0 = before.get(id(req), 0)
            if len(req.out_tokens) > n0:
                emitted[req.request_id] = req.out_tokens[n0:]
            if req.done:
                del self._requests[req.request_id]
        return emitted

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
        self._d_next = self._upload(self._next_tok)
        self._d_lengths = self._upload(self._lengths)
        self._d_active = self._upload(decode_ready)
        self._d_temp = self._upload(self._slot_temp)
        self._d_topk = self._upload(self._slot_topk)
        self._d_remaining = self._upload(remaining)
        self._d_stops = self._upload(stops)
        self._dirty = False

    # -- sync convenience ----------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 gen: Optional[GenerationConfig] = None) -> List[List[int]]:
        ids = [self.add_request(p, gen) for p in prompts]
        results: Dict[int, List[int]] = {i: [] for i in ids}
        waiting = set(ids)
        while waiting and self.has_work():
            emitted = self.step()
            for rid, toks in emitted.items():
                if rid in results:
                    results[rid].extend(toks)
            with self._lock:
                waiting = {rid for rid in waiting if rid in self._requests}
        # the last booking step may have dispatched one more (all-inactive)
        # chunk: collect it so has_work() is False on a drained engine
        self.flush()
        return [results[i] for i in ids]
