"""Disaggregated prefill/decode serving in process, with KV-block handoff
(port of ``ray_tpu/llm/disagg.py``'s two stages).

  - ``PrefillServer``: a paged engine that ONLY prefills.  A finished
    prompt's KV blocks are exported (``PagedTorchLLMEngine.export_request``)
    as the handoff; the prompt's chain stays registered in this engine's
    prefix cache, so a repeated prefix keeps hitting here.
  - ``DecodeServer``: an ``LLMServer`` whose requests arrive ALREADY
    prefilled — ``import_request`` scatters the handed-off blocks into its
    pool and the request joins the continuous decode batch with zero
    prompt compute.  A handoff that cannot be admitted now (no slot or
    blocks), that does not fit (another block size), or that carries no
    KV falls back to ordinary ``add_request`` recompute: no request is
    dropped.

A handoff is a plain dict of host arrays, so either stage may be the JAX
package's: a bf16 payload is numpy ``ml_dtypes.bfloat16`` both ways where
``ml_dtypes`` imports.

Not ported (ROADMAP.md): the channel transport (``via_channel``; A10, a
CUDA tensor channel), the handoff and queue-depth metrics and SLO stages
(A12), and ``DisaggLLMServer`` and ``build_disagg_llm_deployment``, which
call serve handles (A8b).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.llm.engine import make_engine
from ray_tpu_torch.llm.serve import LLMServer

_HANDOFF_TIMEOUT_S = 600.0  # covers a first request's captures


def _no_channel():
    return NotImplementedError(
        "KV handoff over a tensor channel is not ported to ray_tpu_torch yet "
        "(ROADMAP A10: the CUDA tensor channel); hand the payload over as "
        "host arrays")


class PrefillServer:
    """Prefill-only stage: drives ``step(decode=False)`` and exports
    finished prompts' KV blocks.  Concurrent callers interleave their
    prefill chunks through the engine's own admission and budget, exactly
    as in the monolithic engine — there is just no decode batch.

    The engine is paged (a static cache has no blocks to hand over) and
    never speculates (the decode stage re-seeds its own draft).  On CUDA
    its prefill programs are captured in the constructor, and every call
    enqueues on the constructing thread's stream."""

    def __init__(self, llm_config: LLMConfig, params=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        if llm_config.kv_cache != "paged":
            raise ValueError("disaggregated serving requires kv_cache='paged'")
        if llm_config.speculative_config is not None:
            # prefill never decodes: a draft pool here would burn memory
            # and every prompt would pay a pointless draft prefill.  The
            # DECODE stage is the speculative consumer — import_request
            # seeds its draft KV by recompute at draft size.
            llm_config = dataclasses.replace(llm_config,
                                             speculative_config=None)
        self._config = llm_config
        self._engine = make_engine(llm_config, params, device=device,
                                   generator=generator)
        dev = self._engine.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        if self._stream is not None:
            self._engine.warmup(decode=False)
        self._inflight = 0
        self._lock = threading.Lock()

    def prefix_digest(self) -> Dict[str, Any]:
        digest = self._engine.prefix_digest()
        digest["models"] = []
        digest["qlen"] = self._inflight
        return digest

    def utilization(self) -> Dict[str, Any]:
        return self._engine.utilization()

    def queue_depth(self) -> int:
        return self._inflight

    def _track(self, delta: int):
        with self._lock:
            self._inflight += delta

    def prefill(self, prompt: Sequence[int], max_new_tokens: int = 64,
                temperature: float = 0.0, top_k: int = 0,
                stop_token_ids: Sequence[int] = (),
                handoff_channel=None) -> Dict[str, Any]:
        """Prefill one prompt and export its KV + first sampled token: the
        handoff descriptor {prompt, first_token, k, v, block_size,
        emitted, gen}, or, where the prompt cannot be exported (its
        budget ends at the first token), the prompt alone with no KV, for
        the decode stage to recompute."""
        if handoff_channel is not None:
            raise _no_channel()
        eng = self._engine
        # the real token budget is enforced by the decode stage; prefill
        # only needs the request alive past its first emit (>= 2), while
        # still respecting the pool's max_seq admission check
        gen = GenerationConfig(
            max_new_tokens=max(2, min(int(max_new_tokens),
                                      eng.max_seq - len(prompt))),
            temperature=temperature, top_k=top_k,
            stop_token_ids=tuple(stop_token_ids))
        self._track(1)
        try:
            with torch.cuda.stream(self._stream):
                rid = eng.add_request(list(prompt), gen)
                deadline = time.monotonic() + _HANDOFF_TIMEOUT_S
                while True:
                    eng.step(decode=False)
                    with eng._lock:
                        req = eng._requests.get(rid)
                        ready = (req is not None and req.slot >= 0
                                 and req.prefill_pos >= len(req.prompt)
                                 and req.out_tokens)
                        gone = req is None
                    if ready:
                        break
                    if gone:
                        raise RuntimeError(
                            "prefill request finished before export (1-token "
                            "budget near max_seq) — decode will recompute")
                    if time.monotonic() > deadline:
                        raise TimeoutError("prefill timed out")
                    if not eng.has_work():
                        time.sleep(0.001)
                handoff = eng.export_request(rid)
        except (RuntimeError, ValueError):
            # graceful degradation: hand off the prompt with no KV — the
            # decode stage recomputes (its prefix cache usually helps; a
            # genuinely invalid request raises the same error there)
            handoff = {"prompt": list(prompt), "first_token": None,
                       "k": None, "v": None,
                       "block_size": self._config.block_size}
        finally:
            self._track(-1)
        return handoff

    def check_health(self) -> bool:
        return True


class DecodeServer(LLMServer):
    """Decode stage: an ``LLMServer`` (engine loop, waiters, LoRA LRU)
    whose requests normally arrive as KV handoffs instead of prompts."""

    def _import_handoff(self, handoff: Dict[str, Any],
                        gen: GenerationConfig):
        """Admit a handoff into the base engine; returns the waiter key.
        Falls back to plain add_request (recompute) when the handoff has
        no KV, does not fit this engine, or cannot be admitted now."""
        if handoff.get("via_channel"):
            raise _no_channel()
        eng = self._engine
        k, v = handoff.get("k"), handoff.get("v")
        res = None
        if k is not None and handoff.get("first_token") is not None:
            try:
                with torch.cuda.stream(self._stream):
                    res = eng.import_request(handoff["prompt"],
                                             handoff["first_token"], k, v,
                                             gen)
            except ValueError:
                # shape mismatch (per-stage configs: another block_size, a
                # smaller decode max_seq): the handoff KV is unusable here
                # — recompute; a request that is genuinely invalid for THIS
                # engine raises the same error from add_request below
                res = None
        if res is None:
            # recompute path: zero drops even when the pool is full or the
            # handoff was degraded — continuous batching absorbs it
            return (None, 0, eng.add_request(list(handoff["prompt"]), gen))
        wkey = (None, 0, res["request_id"])
        # seed the waiter with the prefill-sampled first token: the engine
        # emitted it before the loop's next snapshot, so the loop alone
        # would never deliver it.  PREPENDED, not appended — between
        # import_request releasing the engine lock and this block, the
        # _run loop may already have stepped the engine and buffered token
        # #2 (or finished the request and moved its buffer to _done)
        with self._cv:
            self._active_waiters.add(wkey)
            if res["done"] or wkey in self._done:
                self._done.setdefault(wkey, [])[:0] = res["emitted"]
            else:
                self._waiters.setdefault(wkey, [])[:0] = res["emitted"]
            self._cv.notify_all()
        return wkey

    @staticmethod
    def _gen_of(max_new_tokens, temperature, top_k, stop_token_ids):
        return GenerationConfig(max_new_tokens=max_new_tokens,
                                temperature=temperature, top_k=top_k,
                                stop_token_ids=tuple(stop_token_ids))

    def decode_from_handoff(self, handoff: Dict[str, Any],
                            max_new_tokens: int = 64,
                            temperature: float = 0.0, top_k: int = 0,
                            stop_token_ids: Sequence[int] = ()) -> List[int]:
        wkey = self._import_handoff(
            handoff, self._gen_of(max_new_tokens, temperature, top_k,
                                  stop_token_ids))
        return self._wait_done(wkey)

    def decode_stream_from_handoff(self, handoff: Dict[str, Any],
                                   max_new_tokens: int = 64,
                                   temperature: float = 0.0, top_k: int = 0,
                                   stop_token_ids: Sequence[int] = ()):
        wkey = self._import_handoff(
            handoff, self._gen_of(max_new_tokens, temperature, top_k,
                                  stop_token_ids))
        yield from self._iter_tokens(wkey)
