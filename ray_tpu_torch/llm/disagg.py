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

A handoff rides the calls as a plain dict of host arrays (``transport=
"object"``), so either stage may be the JAX package's: a bf16 payload is
numpy ``ml_dtypes.bfloat16`` both ways where ``ml_dtypes`` imports.  With
a ``handoff_channel`` (``transport="channel"``) the prefill stage exports
k/v as tensors on its device and writes them to a ``CudaTensorChannel``:
between two replicas on one card they move card to card through CUDA IPC
(host tensors, on the CPU, through the store actor), optionally int8
(``handoff_compression="int8"``); the descriptor carries no KV and the
decode stage reads it from the channel.  A lost channel recomputes, as in
the reference; ``DecodeServer.recomputes`` counts every recompute.

``DisaggLLMServer`` is the ingress of the disaggregated deployment
(``build_disagg_llm_deployment``): it sends a prompt to a prefill replica
and its handoff to a decode replica, through serve handles.

Not ported (ROADMAP.md): the handoff and queue-depth metrics and SLO
stages (A12).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import torch

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.llm.engine import make_engine
from ray_tpu_torch.llm.serve import LLMServer

logger = logging.getLogger(__name__)

_HANDOFF_TIMEOUT_S = 600.0  # covers a first request's captures


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
        the decode stage to recompute.  With ``handoff_channel`` the k/v
        tensors go to the channel, never through the host from a card (a
        CUDA IPC write is enqueued in this call and raises here; its
        release, and a write through the store actor, which meets its
        reader, run off-thread), and the descriptor says ``via_channel``."""
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
                handoff = eng.export_request(
                    rid, on_device=handoff_channel is not None)
        except (RuntimeError, ValueError):
            # graceful degradation: hand off the prompt with no KV — the
            # decode stage recomputes (its prefix cache usually helps; a
            # genuinely invalid request raises the same error there)
            handoff = {"prompt": list(prompt), "first_token": None,
                       "k": None, "v": None,
                       "block_size": self._config.block_size}
        finally:
            self._track(-1)
        if handoff_channel is not None and handoff.get("k") is not None:
            self._write_channel(handoff_channel, handoff.pop("k"),
                                handoff.pop("v"))
            handoff["via_channel"] = True
        return handoff

    def _write_channel(self, chan, k, v):
        """k/v to ``chan``, after this stage's stream's work: a CUDA IPC
        write here (it only enqueues the gather; a failure raises in the
        call), a write through the store actor off-thread (it meets its
        reader, who starts once this call returns); the writer's release
        (it waits for the reader's) off-thread either way."""
        def write():
            with torch.cuda.stream(self._stream):
                chan.write((k, v), timeout=_HANDOFF_TIMEOUT_S)

        def finish(do_write: bool):
            try:
                if do_write:
                    write()
            except Exception:  # noqa: BLE001 — a reader gone: drop
                logger.exception("KV handoff write on %s failed", chan.name)
                chan.close()  # the reader fails now and recomputes
            finally:
                chan.release(timeout=_HANDOFF_TIMEOUT_S)

        inline = k.is_cuda and chan.backend == "auto"
        if inline:
            try:
                write()
            except BaseException:
                chan.close()
                chan.release(timeout=0.0)
                raise
        threading.Thread(target=finish, args=(not inline,), daemon=True,
                         name="kv-handoff-write").start()

    def check_health(self) -> bool:
        return True


class DecodeServer(LLMServer):
    """Decode stage: an ``LLMServer`` (engine loop, waiters, LoRA LRU)
    whose requests normally arrive as KV handoffs instead of prompts.
    ``recomputes`` counts the handoffs that fell back to recompute (no KV,
    another shape, no room now, or a lost channel)."""

    recomputes = 0

    def _import_handoff(self, handoff: Dict[str, Any],
                        gen: GenerationConfig):
        """Admit a handoff into the base engine; returns the waiter key.
        Falls back to plain add_request (recompute) when the handoff has
        no KV, does not fit this engine, cannot be admitted now, or its
        channel is lost."""
        eng = self._engine
        k, v = handoff.get("k"), handoff.get("v")
        chan = handoff.get("channel")
        if chan is not None and handoff.get("via_channel"):
            try:
                with torch.cuda.stream(self._stream):
                    k, v = chan.read(timeout=_HANDOFF_TIMEOUT_S)
            except Exception:  # noqa: BLE001 — a lost channel: recompute
                logger.exception("KV handoff read on %s failed; "
                                 "recomputing", chan.name)
                k = v = None
            finally:
                # the writer normally waits for this in its own release; a
                # writer gone must not hold the request for long
                chan.release(timeout=5.0)
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
            self.recomputes += 1
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


class DisaggLLMServer:
    """Ingress of the disaggregated topology: prefill handle (cache-aware
    routed) -> KV handoff -> decode handle.  LoRA requests (``model=``)
    bypass disaggregation and run whole on the decode stage, where the
    adapter engines live.  The handoff rides the calls' payloads
    (``transport="object"``) or a ``CudaTensorChannel`` made per request
    (``transport="channel"``, optionally int8 by ``handoff_compression``),
    which the ingress unlinks when the request ends."""

    def __init__(self, llm_config: LLMConfig, prefill_handle, decode_handle,
                 transport: str = "object", handoff_compression=None):
        if transport not in ("object", "channel"):
            raise ValueError(f"transport must be 'object' or 'channel' "
                             f"(got {transport!r})")
        self._prefill = prefill_handle
        self._decode = decode_handle
        self._transport = transport
        self._compression = handoff_compression

    def _make_channel(self):
        from ray_tpu_torch.experimental.channel.cuda_tensor_channel import (
            CudaTensorChannel,
        )

        return CudaTensorChannel(f"kvh-{uuid.uuid4().hex[:12]}",
                                 compression=self._compression)

    def _run_prefill(self, prompt, gen_kwargs):
        """(handoff, the request's channel or None)."""
        chan = self._make_channel() if self._transport == "channel" else None
        try:
            resp = self._prefill.prefill.remote(
                prompt=list(prompt), handoff_channel=chan, **gen_kwargs)
            handoff = resp.result(timeout_s=_HANDOFF_TIMEOUT_S)
        except BaseException:
            if chan is not None:
                chan.destroy()
            raise
        if chan is not None:
            handoff["channel"] = chan
        return handoff, chan

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k: int = 0,
                 stop_token_ids: Sequence[int] = (),
                 model: Optional[str] = None) -> List[int]:
        gen_kwargs = dict(max_new_tokens=max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          stop_token_ids=tuple(stop_token_ids))
        if model:
            return self._decode.generate.remote(
                prompt=list(prompt), model=model,
                **gen_kwargs).result(timeout_s=_HANDOFF_TIMEOUT_S)
        handoff, chan = self._run_prefill(prompt, gen_kwargs)
        try:
            return self._decode.decode_from_handoff.remote(
                handoff, **gen_kwargs).result(timeout_s=_HANDOFF_TIMEOUT_S)
        finally:
            if chan is not None:
                chan.destroy()

    def generate_stream(self, prompt: Sequence[int],
                        max_new_tokens: int = 64, temperature: float = 0.0,
                        top_k: int = 0, stop_token_ids: Sequence[int] = (),
                        model: Optional[str] = None):
        gen_kwargs = dict(max_new_tokens=max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          stop_token_ids=tuple(stop_token_ids))
        chan = None
        if model:
            gen = self._decode.options(stream=True).generate_stream.remote(
                prompt=list(prompt), model=model, **gen_kwargs)
        else:
            handoff, chan = self._run_prefill(prompt, gen_kwargs)
            gen = self._decode.options(
                stream=True).decode_stream_from_handoff.remote(
                    handoff, **gen_kwargs)
        try:
            yield from gen
        finally:
            if chan is not None:
                chan.destroy()

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Same dict API as ``LLMServer.__call__``."""
        toks = self.generate(
            request["prompt"],
            max_new_tokens=request.get("max_new_tokens", 64),
            temperature=request.get("temperature", 0.0),
            top_k=request.get("top_k", 0),
            stop_token_ids=request.get("stop_token_ids", ()),
            model=request.get("model"),
        )
        return {"tokens": toks}

    def check_health(self) -> bool:
        return True


def build_disagg_llm_deployment(
        llm_config: LLMConfig, params=None, *, name: str = "llm",
        prefill_replicas: int = 1, decode_replicas: int = 1,
        transport: str = "object", handoff_compression=None,
        prefill_config: Optional[LLMConfig] = None,
        decode_config: Optional[LLMConfig] = None,
        prefill_autoscaling: Optional[dict] = None,
        decode_autoscaling: Optional[dict] = None,
        lora_adapters: Optional[Dict[str, Any]] = None,
        draft_params=None, device=None):
    """An Application serving ``llm_config`` as separately scaled prefill
    and decode deployments behind one CPU ingress (the reference's
    signature, plus ``device``, passed through ``bind`` to both stages'
    servers).  ``prefill_config``/``decode_config`` override a stage's
    engine shape; ``*_autoscaling`` are serve autoscaling configs.  With a
    speculative config the decode stage speculates (``draft_params`` feeds
    its draft); the prefill stage never does.  ``transport="channel"``
    hands each request's KV over through a ``CudaTensorChannel`` (card to
    card between stages on one card), ``handoff_compression="int8"``
    quantizes it."""
    from ray_tpu_torch import serve

    pre_cfg = prefill_config or llm_config
    dec_cfg = decode_config or llm_config
    prefill_app = serve.deployment(
        PrefillServer, name=f"{name}-prefill",
        num_replicas=prefill_replicas,
        max_ongoing_requests=max(8, pre_cfg.max_batch_size),
        autoscaling_config=prefill_autoscaling,
        ray_actor_options={"resources": pre_cfg.resources_per_replica(device)},
    ).bind(pre_cfg, params, device=device)
    decode_app = serve.deployment(
        DecodeServer, name=f"{name}-decode",
        num_replicas=decode_replicas,
        max_ongoing_requests=max(8, dec_cfg.max_batch_size),
        autoscaling_config=decode_autoscaling,
        ray_actor_options={"resources": dec_cfg.resources_per_replica(device)},
    ).bind(dec_cfg, params, lora_adapters, draft_params, device=device)
    ingress = serve.deployment(
        DisaggLLMServer, name=name, num_replicas=1,
        max_ongoing_requests=4 * max(8, dec_cfg.max_batch_size),
        ray_actor_options={"resources": {"CPU": 0.1}},
    ).bind(llm_config, prefill_app, decode_app,
           transport=transport, handoff_compression=handoff_compression)
    return ingress
