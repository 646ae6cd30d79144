"""The static engine, the pieces both engines share, and the engine factory.

Port of ``ray_tpu/llm/engine.py``: the per-slot sampling (greedy /
temperature / top-k decided per row on the device) and its distribution,
the request record, ``make_engine``, and ``TorchLLMEngine``, the twin of
``JaxLLMEngine`` (a static KV cache of ``max_batch`` slots, each a stripe
of ``max_seq`` positions).

Compiled programs.  The JAX engines run a decode chunk (``decode_chunk``
token steps with stop and budget handling on the device) as ONE jitted
program per shape, and a prefill as one per prompt bucket or chunk width.
Here the twin is a CUDA graph: :class:`_Programs` captures an engine's
``_decode_chunk_impl`` once per shape (per table width for the paged
engine, one for the static cache) over loop state the engine owns and
updates in place, and every later dispatch replays it; the paged
engine's speculative propose and verify programs, its prefill chunk (and
its draft's) per chunk width, and the static engine's prefill per prompt
bucket are captured the same way, over static input buffers the engine
copies into before each replay.
On the CPU, which a caller must ask for, the same function runs eagerly
on the same buffers.

Device rule: an engine runs on ``"cuda"`` unless the caller passes
``device="cpu"``; without a GPU, the default raises instead of moving to
the CPU.

Not ported in this slice (ROADMAP.md): the static engine's mesh wiring
(tensor and pipeline parallelism, A11), ``slo_label``, the telemetry keys
of ``utilization`` and device telemetry (A12), and tracing spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, check_supported
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops.attention import flash_config_refusal

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


def _sample_dist(logits, temps, top_ks):
    """The distribution [B, V] that ``_sample`` draws from: the softmax of
    the temperature-scaled, top-k-masked logits for temps > 0 rows, an
    exact one-hot at the argmax for greedy rows."""
    probs = torch.softmax(_masked_scaled(logits, temps, top_ks), dim=-1)
    one_hot = F.one_hot(logits.argmax(dim=-1), logits.shape[-1]).to(probs.dtype)
    return torch.where(temps[:, None] <= 0.0, one_hot, probs)


# -- the decode loop as compiled programs -------------------------------------


def _copy_in(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Host array -> ``dst`` in place, without a stream sync: on CUDA from a
    fresh pinned copy, non-blocking, so an in-flight chunk keeps running
    (PyTorch's pinned-memory cache does not hand that block out again
    before the copy has run).  Later host edits of ``arr`` never reach
    ``dst``."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dst.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=dst.is_cuda)


class _LoopState:
    """The decode loop's device state, one row per slot: the next tokens,
    lengths, the active mask, token budgets, stop ids, sampling params and
    the speculation mask (the paged engine's, with a draft model).  An
    engine allocates it once; chunks and mirror refreshes update it in
    place, so a captured graph keeps reading the same buffers.  A fresh
    state is idle: every slot inactive at position ``length``."""

    def __init__(self, batch: int, device, length: int = 0):
        i32 = dict(dtype=torch.int32, device=device)
        self.tokens = torch.zeros(batch, **i32)
        self.lengths = torch.full((batch,), length, **i32)
        self.active = torch.zeros(batch, **i32)
        self.remaining = torch.zeros(batch, **i32)
        self.stops = torch.full((batch, _MAX_STOP_IDS), -1, **i32)
        self.temps = torch.zeros(batch, dtype=torch.float32, device=device)
        self.top_ks = torch.zeros(batch, **i32)
        self.spec = torch.zeros(batch, **i32)

    def load(self, **arrays: np.ndarray) -> None:
        """Copy host mirrors in, by field name."""
        for name, arr in arrays.items():
            _copy_in(getattr(self, name), arr)


def _decode_chunk(step: Callable, state: _LoopState, emitted: torch.Tensor,
                  generator: torch.Generator, max_seq: int) -> None:
    """``emitted.shape[0]`` token steps, all on the device, in place:
    ``step(tokens, lengths)`` gives the logits [B, V] of one decode step;
    each step samples, writes its ids into ``emitted`` (-1 where the slot
    is inactive) and advances the state.  A slot deactivates itself on a
    stop id, on an exhausted budget or at the cache's end."""
    for t in range(emitted.shape[0]):
        logits = step(state.tokens, state.lengths)
        ids = _sample(logits, generator, state.temps, state.top_ks)
        live = state.active > 0
        emitted[t] = torch.where(live, ids, -1)
        state.lengths += state.active
        state.remaining -= state.active
        hit_stop = (state.stops == ids[:, None]).any(-1)
        done = live & (hit_stop | (state.remaining <= 0)
                       | (state.lengths + 1 >= max_seq))
        state.active.mul_((~done).to(state.active.dtype))
        state.tokens.copy_(torch.where(state.active > 0, ids, state.tokens))


@contextlib.contextmanager
def _on_stream(stream: Optional[torch.cuda.Stream]):
    """Run the block on ``stream`` (None: where we are), ordered after the
    current stream's work and before its next."""
    if stream is None:
        yield
        return
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        yield
    main.wait_stream(stream)


def _capture_graph(fn: Callable[[], None], pool, stream,
                   generator: torch.Generator) -> "torch.cuda.CUDAGraph":
    """``fn`` captured into a CUDA graph on ``stream`` from memory ``pool``.
    ``generator`` is registered, so each replay draws fresh numbers from it
    and advances it as an eager run would."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        fn()
    return graph


class _Program:
    """One program at one width: its static buffers (``progs.buffers(
    width)``; for a decode chunk the table [B, W], None for the static
    cache, and emitted [n_steps, B]; for a prefill its inputs and the
    sampled id as ``emitted``), and on CUDA the graph captured over them
    and the engine's loop state.

    Construction first runs the program once on an idle scratch state,
    zeroed buffers and a throwaway generator, on the capture stream: every
    write lands where no live query reads (the paged engine's sink block
    0; the static cache's last position), and the engine's sampling stream
    does not move.  That run takes the first-use costs out of the capture
    (the kernel's build, cuBLAS's workspace, the paged kernel's arrival
    counters for the capture stream).  Capture itself launches nothing:
    its paged-kernel calls are counted in ``kernel_launches`` and its
    flash-forward calls in ``flash_launches``, and each replay books that
    many launches (``ops.paged_attention``, ``ops.flash_attention``)."""

    def __init__(self, progs: "_Programs", width: Optional[int]):
        state = progs.state
        b, dev = state.tokens.shape[0], state.tokens.device
        self.buffers = progs.buffers(width)
        self.table = self.buffers.get("table")
        self.emitted = self.buffers.get("emitted")
        self.graph = None
        self.kernel_launches = self.flash_launches = 0
        self._run = functools.partial(progs.run, state,
                                      generator=progs.generator,
                                      **self.buffers)
        with _on_stream(progs.stream):
            progs.run(_LoopState(b, dev, progs.idle_length),
                      generator=torch.Generator(device=dev).manual_seed(0),
                      **{name: None if t is None else torch.zeros_like(t)
                         for name, t in self.buffers.items()})
        if progs.graphs:
            before = pa.captured_launches, fa.captured_fwd_launches
            self.graph = _capture_graph(self._run, progs.pool, progs.stream,
                                        progs.generator)
            self.kernel_launches = pa.captured_launches - before[0]
            self.flash_launches = fa.captured_fwd_launches - before[1]

    def __call__(self) -> Optional[torch.Tensor]:
        """Run the program (a replay on CUDA); returns ``emitted`` (None if
        it has none), which the next run overwrites: read it back before
        then, in stream order."""
        if self.graph is None:
            self._run()
        else:
            self.graph.replay()
            pa.count_replayed(self.kernel_launches)
            fa.count_replayed(self.flash_launches)
        return self.emitted


class _Programs:
    """One of an engine's device programs as compiled programs, one per
    width (a decode chunk's table width, ``None`` for the static cache; a
    prefill's chunk width or prompt bucket): the twin of ``jax.jit`` over
    the JAX engines' ``_decode_chunk_impl`` (and the paged engine's
    speculative ``_draft_propose_impl`` and ``_spec_verify_impl``, and
    both engines' prefill programs) and its cache of compiled shapes.

    ``run(state, generator=, **buffers)`` runs the program in place, where
    ``buffers(width)`` makes a program's static buffers (default, a decode
    chunk of ``n_steps`` token steps: ``table`` and ``emitted``).  A
    width's program is made at its first use, as ``jax.jit`` compiles at
    first call, or ahead of time by the paged engine's ``warmup``.  With
    ``graphs`` every dispatch is a replay; a capture that fails raises,
    and nothing falls back to eager dispatch.  On CUDA all widths' graphs
    share one memory pool: they never run at once, and the state they
    share lives outside it."""

    def __init__(self, run: Callable, state: _LoopState, n_steps: int,
                 graphs: bool, generator: torch.Generator,
                 idle_length: int = 0,
                 buffers: Optional[Callable[[Optional[int]],
                                            Dict[str, torch.Tensor]]] = None):
        self.run = run
        self.state = state
        self.n_steps = n_steps
        self.graphs = graphs
        self.generator = generator
        self.idle_length = idle_length
        self.buffers = buffers or self._chunk_buffers
        self.by_width: Dict[Optional[int], _Program] = {}
        dev = state.tokens.device
        on_card = graphs and dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if on_card else None
        self.stream = torch.cuda.Stream(dev) if on_card else None
        self.build_s = 0.0  # seconds spent making programs (warm-up + capture)

    def _chunk_buffers(self, width: Optional[int]) -> Dict[str, torch.Tensor]:
        b, dev = self.state.tokens.shape[0], self.state.tokens.device
        i32 = dict(dtype=torch.int32, device=dev)
        return {"table": None if width is None else torch.zeros((b, width), **i32),
                "emitted": torch.full((self.n_steps, b), -1, **i32)}

    def get(self, width: Optional[int]) -> _Program:
        prog = self.by_width.get(width)
        if prog is None:
            t0 = time.perf_counter()
            prog = self.by_width[width] = _Program(self, width)
            self.build_s += time.perf_counter() - t0
        return prog


class _Readback:
    """A device tensor on its way to the host: on CUDA a non-blocking copy
    into pinned memory plus an event, enqueued now (before a later program
    overwrites the tensor), so the host waits only when it reads
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


# -- what both engines share ----------------------------------------------------


class _EngineBase:
    """Request checks, emitted-token gathering and ``generate``, shared by
    the static and the paged engine (the JAX package repeats them in
    each)."""

    def _check_request(self, prompt: Sequence[int], gen: GenerationConfig):
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

    def generate(self, prompts: Sequence[Sequence[int]],
                 gen: Optional[GenerationConfig] = None) -> List[List[int]]:
        """Generate for a batch of prompts, driving step() to completion."""
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


def _prompt_bucket(plen: int, max_seq: int) -> int:
    """The static engine's prefill width for a ``plen``-token prompt: a
    power of two of at least 8, capped at ``max_seq``."""
    return min(1 << max(3, math.ceil(math.log2(plen))), max_seq)


class TorchLLMEngine(_EngineBase):
    """The static engine (``JaxLLMEngine``'s twin): params and a static KV
    cache [L, max_batch, max_seq, kv, hd] on ``device``.

    API: ``add_request() -> id``, ``step() -> {id: [new tokens]}``,
    ``flush()``, ``generate()``, ``prefix_digest()``, ``utilization()``.
    Admission prefills a prompt at a power-of-two bucket (through
    ``multi_head_attention``, so on the card the flash forward kernel from
    128 tokens up), samples its first token and writes its K/V into the
    slot's stripe; the prefill is one program per bucket (the JAX engine's
    one jit per prompt shape), with the prompt length a device index, and
    the slot's write follows it outside the program.  Decode runs
    ``decode_chunk`` token steps as one program over every slot, one
    chunk in flight while the host books the previous one.  On CUDA each
    program is a CUDA graph captured at its first use and replayed.

    ``device`` defaults to CUDA (raising without a GPU); ``params`` None
    draws random weights from ``generator`` (default: seed 0)."""

    def __init__(self, config: LLMConfig, params=None, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 _graphs: Optional[bool] = None):
        check_supported(config)
        self.config = config
        cfg = config.model_config
        if cfg is None:
            raise ValueError("LLMConfig.model_config is required")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = config.max_batch_size
        self.max_seq = config.max_seq_len or cfg.max_seq_len
        if config.decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1 (got {config.decode_chunk})")
        refusal = flash_config_refusal(cfg, self.device)
        if refusal:
            raise NotImplementedError(f"TorchLLMEngine: {refusal}")
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = llama.init_params(cfg, generator, self.device)
        self.params = params
        self._rope = llama.rope_cache(cfg, self.max_seq, self.device)
        self.cache = llama.init_kv_cache(cfg, self.max_batch, self.max_seq,
                                         device=self.device)
        # host-side slot state
        self._slot_req: List[Optional[_Request]] = [None] * self.max_batch
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
        self._pending: List[_Request] = []
        self._requests: Dict[int, _Request] = {}
        self._req_counter = 0
        self._lock = threading.Lock()
        # one decode chunk may stay in flight, collected next step:
        # (emitted readback, active slots)
        self._inflight: Optional[Tuple[_Readback, List[int]]] = None
        # work counters: token steps of decode dispatched, prompt tokens
        # prefilled
        self.decode_steps = 0
        self.prefill_tokens = 0
        graphs = self.device.type == "cuda" if _graphs is None else _graphs
        # the warm-up run before capture decodes at the cache's last
        # position, which no live query reads (a slot ends at max_seq - 1)
        self._programs = _Programs(
            self._decode_chunk_impl, self._state, config.decode_chunk,
            graphs, self._gen, idle_length=self.max_seq - 1)
        # the prefill per prompt bucket: its K/V lands in a view of one
        # engine-owned [L, 1, max_seq, kv, hd] pair, outside the graph
        # pool, from which admission writes the slot's stripe
        self._prefill_kv = llama.init_kv_cache(cfg, 1, self.max_seq,
                                               device=self.device)
        self._prefill_programs = _Programs(
            self._prefill_program, self._state, 1, graphs, self._gen,
            buffers=self._prefill_buffers)

    # -- device programs -------------------------------------------------

    def _decode_chunk_impl(self, state: _LoopState, table, emitted,
                           generator):
        """Advance every slot up to ``emitted.shape[0]`` tokens in place
        (``table`` is None: the cache needs none)."""
        _decode_chunk(
            lambda tokens, lengths: llama.decode_step(
                self.cfg, self.params, tokens, self.cache, lengths,
                self._rope)[0],
            state, emitted, generator, self.max_seq)

    def _prefill_impl(self, tokens, plen, temps, top_ks, generator=None):
        """Prefill one prompt at its bucket: (the id sampled at position
        ``plen - 1``, a [1] int tensor read on the device, and the K/V)."""
        logits, kv = llama.prefill(self.cfg, self.params, tokens, self._rope)
        # clamped: the warm-up run before a capture passes plen 0
        last = logits.index_select(1, (plen.long() - 1).clamp(min=0))[:, 0]
        return _sample(last, generator or self._gen, temps, top_ks), kv

    def _prefill_buffers(self, bucket: int) -> Dict[str, torch.Tensor]:
        i32 = dict(dtype=torch.int32, device=self.device)
        return {"tokens": torch.zeros((1, bucket), **i32),
                "plen": torch.zeros(1, **i32),
                "temps": torch.zeros(1, dtype=torch.float32,
                                     device=self.device),
                "top_ks": torch.zeros(1, **i32),
                "emitted": torch.zeros(1, **i32),
                **{name: t[:, :, :bucket]
                   for name, t in self._prefill_kv.items()}}

    def _prefill_program(self, state, tokens, plen, temps, top_ks, emitted,
                         k, v, generator):
        """The prefill program in place (``state`` unused): the sampled id
        into ``emitted``, the K/V into ``k`` and ``v``."""
        ids, kv = self._prefill_impl(tokens, plen, temps, top_ks, generator)
        emitted.copy_(ids)
        k.copy_(kv["k"])
        v.copy_(kv["v"])

    # -- request lifecycle ---------------------------------------------

    def add_request(self, prompt: Sequence[int],
                    gen: Optional[GenerationConfig] = None) -> int:
        gen = gen or GenerationConfig()
        self._check_request(prompt, gen)
        with self._lock:
            self._req_counter += 1
            req = _Request(self._req_counter, [int(t) for t in prompt], gen)
            self._requests[req.request_id] = req
            self._pending.append(req)
            return req.request_id

    def has_work(self) -> bool:
        with self._lock:
            return (bool(self._pending) or self._inflight is not None
                    or any(r is not None for r in self._slot_req))

    def _admit_locked(self):
        """Prefill pending requests into free slots (continuous batching).
        The prefill's cache writes follow any in-flight chunk in stream
        order, and the new slot was inactive in that chunk."""
        for slot in range(self.max_batch):
            if not self._pending or self._slot_req[slot] is not None:
                continue
            req = self._pending.pop(0)
            plen = len(req.prompt)
            prog = self._prefill_programs.get(_prompt_bucket(plen,
                                                             self.max_seq))
            buf = prog.buffers
            tokens = np.zeros(tuple(buf["tokens"].shape), np.int32)
            tokens[0, :plen] = req.prompt
            _copy_in(buf["tokens"], tokens)
            _copy_in(buf["plen"], np.array([plen], np.int32))
            _copy_in(buf["temps"], np.array([req.gen.temperature], np.float32))
            _copy_in(buf["top_ks"], np.array([req.gen.top_k], np.int32))
            ids = prog()
            llama.write_cache_slot(self.cache, buf, slot)
            first = int(ids[0])  # the first-token readback, as in JAX
            self.prefill_tokens += plen
            req.slot = slot
            self._slot_req[slot] = req
            self._lengths[slot] = plen
            self._next_tok[slot] = first
            self._slot_temp[slot] = req.gen.temperature
            self._slot_topk[slot] = req.gen.top_k
            self._dirty = True  # device mirrors stale: new slot joined
            self._emit_locked(req, first)

    def _emit_locked(self, req: _Request, token: int):
        req.out_tokens.append(token)
        if (token in req.gen.stop_token_ids
                or len(req.out_tokens) >= req.gen.max_new_tokens
                or self._lengths[req.slot] + 1 >= self.max_seq):
            req.done = True
            self._slot_req[req.slot] = None
            self._lengths[req.slot] = 0
            req.slot = -1
            self._dirty = True  # device mirrors stale: slot freed

    def _refresh_mirrors_locked(self):
        remaining = np.zeros(self.max_batch, np.int32)
        stops = np.full((self.max_batch, _MAX_STOP_IDS), -1, np.int32)
        for s, r in enumerate(self._slot_req):
            if r is not None:
                remaining[s] = r.gen.max_new_tokens - len(r.out_tokens)
                for j, sid in enumerate(r.gen.stop_token_ids):
                    stops[s, j] = sid
        self._state.load(
            tokens=self._next_tok, lengths=self._lengths,
            active=np.array([0 if r is None else 1 for r in self._slot_req],
                            np.int32),
            temps=self._slot_temp, top_ks=self._slot_topk,
            remaining=remaining, stops=stops)
        self._dirty = False

    @torch.no_grad()
    def step(self, decode: bool = True) -> Dict[int, List[int]]:
        """Admit pending, then advance every active slot by up to
        ``config.decode_chunk`` tokens in one device program.  The chunk
        dispatched here is collected on the NEXT step, its readback riding
        under this dispatch's compute.  ``decode=False`` runs admission
        and prefill only.  Returns {request_id: [tokens emitted]}."""
        with self._lock:
            before = self._emit_snapshot_locked()
            if self._pending:
                self._admit_locked()
            active = [s for s in range(self.max_batch)
                      if self._slot_req[s] is not None]
            if active and decode and self._dirty:
                # slot transition since the last chunk: collect it, then
                # refresh the device state from host truth
                self._collect_inflight_locked()
                active = [s for s in range(self.max_batch)
                          if self._slot_req[s] is not None]
                if self._dirty and active:
                    self._refresh_mirrors_locked()
            if active and decode:
                em = self._programs.get(None)()
                self.decode_steps += self.config.decode_chunk
                prev, self._inflight = self._inflight, (_Readback(em), active)
                if prev is not None:
                    self._book_chunk_locked(*prev)
            else:
                self._collect_inflight_locked()
            return self._gather_emitted_locked(before)

    def _book_chunk_locked(self, em: _Readback, active: List[int]):
        em = em.numpy()  # [chunk, B]: waits for this chunk only
        for t in range(em.shape[0]):
            for s in active:
                req = self._slot_req[s]
                if req is None:
                    continue  # finished earlier in this chunk
                tok = int(em[t, s])
                if tok < 0:
                    continue
                self._lengths[s] += 1
                self._next_tok[s] = tok
                self._emit_locked(req, tok)

    def _collect_inflight_locked(self):
        if self._inflight is not None:
            em, active = self._inflight
            self._inflight = None
            self._book_chunk_locked(em, active)

    @torch.no_grad()
    def flush(self) -> Dict[int, List[int]]:
        """Collect any in-flight decode chunk and return its tokens."""
        with self._lock:
            before = self._emit_snapshot_locked()
            self._collect_inflight_locked()
            return self._gather_emitted_locked(before)

    def prefix_digest(self, max_hashes: Optional[int] = None) -> Dict:
        """The static cache holds no sharable prefix blocks: an empty
        digest (the router treats every prompt as cold)."""
        return {"block_size": 0, "hashes": []}

    def utilization(self) -> dict:
        """Slot occupancy under the lock; KV occupancy is slot occupancy
        (a slot owns its whole stripe).  The telemetry keys (``rates``,
        ``hbm``, ``duty_cycle``) and ``deployment`` come with A12."""
        with self._lock:
            active = sum(1 for r in self._slot_req if r is not None)
            pending = len(self._pending)
        return {"engine": "static",
                "slots": {"active": active, "max": self.max_batch,
                          "free": self.max_batch - active},
                "kv_blocks": {"total": self.max_batch,
                              "free": self.max_batch - active,
                              "used": active},
                "pending": pending}


def make_engine(config: LLMConfig, params=None, *, device=None,
                generator: Optional[torch.Generator] = None,
                draft_params=None):
    """Engine factory: ``config.kv_cache`` picks the paged engine (the
    default) or the static one.  ``device`` defaults to CUDA; ``params``
    None draws random weights from ``generator`` (default: seed 0 on
    ``device``).  ``draft_params``: the weights of
    ``config.speculative_config``'s draft model (None draws them at
    random: right for tests, an acceptance rate near 0 in production)."""
    if config.kv_cache == "paged":
        from ray_tpu_torch.llm.paged import PagedTorchLLMEngine

        return PagedTorchLLMEngine(config, params, device=device,
                                   generator=generator,
                                   draft_params=draft_params)
    if config.kv_cache == "static":
        if config.speculative_config is not None:
            raise ValueError(
                "speculative_config requires kv_cache='paged' (the static "
                "engine has no block pool for the draft KV)")
        return TorchLLMEngine(config, params, device=device,
                              generator=generator)
    raise ValueError(
        f"kv_cache must be 'paged' or 'static' (got {config.kv_cache!r})")
