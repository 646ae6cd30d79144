"""LLM serving in process: ``LLMServer``, continuous batching across callers.

Port of ``ray_tpu/llm/serve.py``.  The server owns an engine
(``make_engine``); concurrent callers enqueue requests and one background
thread drives ``engine.step()``, so every in-flight request shares one
decode batch.  LoRA adapters get engines of their own over merged weights,
built on first use and kept in an LRU; live streams can be exported from
one server and resumed on another (migration).

Threads and the card.  Every engine call of a server, from its loop thread
or a caller's, enqueues on one CUDA stream (the constructing thread's
current stream): work a caller's thread enqueues (an export's copies, a
cancel's drain, an import's scatter) is ordered behind the chunk the loop
launched before it, as the engine orders its own copies.  The base engine
is warmed in the constructor on CUDA, so no capture lands in the serving
window.  An adapter engine is built and warmed in the calling thread,
outside the engines lock, while the loop goes on replaying the other
engines' graphs: the engines capture with ``capture_error_mode=
"thread_local"`` (``llm/engine.py``), under which only the capturing
thread is held to capture's rules, and one process-wide lock keeps two
captures from overlapping.  The base engine's ``add_request`` never waits
for a build.  The loop yields the interpreter between steps, so a caller
blocked on the step or engine lock (an export, a cancel, an import, a
submit) gets it at the next step instead of when the engines go idle.

A live stream's migration runs through ``serve/_private/kv_migration.py``:
``evacuate_streams`` exports each stream, imports it on a destination
(another server in process, or a serve replica), and ``_splice`` relays
the destination's continuation into the client's original waiter.
``build_llm_deployment`` makes the server a serve deployment.

A serve replica labels the server with its deployment's name
(``set_slo_label``): its engines then book their SLO stages and device
telemetry under it, and ``utilization`` is the row the replica publishes.
A finished request's speculative acceptance joins the caller's SLO
tracker row (``_note_specdec``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ray_tpu_torch._private.tree import tree_map
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig
from ray_tpu_torch.llm.engine import make_engine, resolve_device
from ray_tpu_torch.llm.lora import adapter_speculation, merge_lora
from ray_tpu_torch.models import llama


class LLMServer:
    """Continuous batching across callers over one engine, plus one engine
    per LoRA adapter (``lora_adapters``: model id -> the port's adapter
    tree, ``llm/lora.py``) over MERGED weights, built on the adapter's
    first request and driven by the same loop; at most
    ``_MAX_ADAPTER_ENGINES`` idle ones stay (least recently used evicted).

    ``device`` defaults to CUDA (raising without a GPU), as ``make_engine``
    does; ``params`` None draws random weights from ``generator``.
    Call ``shutdown`` when done: it stops and joins the loop thread."""

    _MAX_ADAPTER_ENGINES = 4
    # the hosting deployment's name (set_slo_label); None books nothing
    _slo_label: Optional[str] = None

    def __init__(self, llm_config: LLMConfig, params=None,
                 lora_adapters: Optional[Dict[str, Any]] = None,
                 draft_params=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        self._config = llm_config
        # under tensor parallelism the engine keeps only rank 0's shard
        # (an engine with tensor_parallel_size > 1 starts its own rank
        # processes, on the cards this replica was given), and an adapter
        # merges into the full weights: a sharded server with adapters
        # keeps those on the host, drawn here as the engine would draw
        # them when the caller passes none
        self._base_params = None
        mesh = llm_config.mesh
        sharded = llm_config.tensor_parallel_size > 1 or (
            mesh is not None and mesh.tensor > 1)
        if sharded and lora_adapters:
            if params is None:
                dev = resolve_device(device)
                params = llama.init_params(
                    llm_config.model_config,
                    generator or torch.Generator(device=dev).manual_seed(0),
                    dev, place=lambda path, t: t.cpu())
            self._base_params = tree_map(lambda t: t.cpu(), params)
        self._engine = make_engine(llm_config, params, device=device,
                                   generator=generator,
                                   draft_params=draft_params)
        # the MATERIALIZED draft weights (the engine random-initializes
        # when draft_params is None): per-adapter draft merges apply to
        # what actually runs, not the constructor argument
        self._draft_params = getattr(self._engine, "_draft_params",
                                     draft_params)
        self._device = self._engine.device
        # the one stream every engine call of this server enqueues on (None
        # on the CPU, where ``torch.cuda.stream(None)`` does nothing)
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device.type == "cuda" else None)
        if self._stream is not None and hasattr(self._engine, "warmup"):
            # every decode width and prefill chunk width captured before
            # serving traffic: a capture inside the loop stalls every stream
            self._engine.warmup()
        self._engines: Dict[Optional[str], Any] = {None: self._engine}
        self._engine_gen: Dict[Optional[str], int] = {None: 0}
        self._engine_order: list = []  # adapter LRU (base never evicted)
        self._adapters: Dict[str, Any] = dict(lora_adapters or {})
        self._engines_lock = threading.Lock()
        # one adapter build at a time: a second caller of the same adapter
        # waits for the first build instead of capturing a twin
        self._build_lock = threading.Lock()
        # held by the _run loop across each step + token-apply pair, and
        # by export/cancel across their engine drain + waiter reconcile:
        # a drain landing between a step's gather and its apply would
        # otherwise double-deliver the step's delta (see _reap_drained)
        self._step_lock = threading.Lock()
        self._cv = threading.Condition()
        self._done: Dict[Any, List[int]] = {}
        self._waiters: Dict[Any, List[int]] = {}
        # wkeys some caller is still consuming — eviction cleanup must not
        # delete their results out from under them (guarded by _cv's lock)
        self._active_waiters: set = set()
        # wkeys aborted mid-stream (client disconnect): one trailing
        # emission batch may still surface after the engine cancel — it
        # must not recreate the popped waiter entry as a leaked _done row
        # (guarded by _cv's lock; bounded by the clear-cap below)
        self._aborted: set = set()
        # wkeys mid-migration: their engine request is being (or has been)
        # exported away, so the _run loop must neither re-apply their
        # history nor declare them done when the rid leaves the engine
        # (guarded by _cv's lock)
        self._migrating: set = set()
        # mig_id -> import result memo (idempotent migration retries;
        # guarded by _cv's lock, bounded)
        self._mig_imports: Dict[str, Any] = {}
        self._stop = False
        self._error: Optional[BaseException] = None
        self._loop = threading.Thread(target=self._run, daemon=True,
                                      name="llm-engine-loop")
        self._loop.start()

    def lora_model_ids(self) -> List[str]:
        return sorted(self._adapters)

    def set_slo_label(self, name: str) -> None:
        """Serving SLO layer threading (serve/_private/replica.py): label
        this server's engines with the hosting deployment's name, so their
        lifecycle stages (queue_wait, prefill, decode) and device telemetry
        book under it.  Unlabeled servers (direct library use) book
        nothing."""
        self._slo_label = name
        with self._engines_lock:
            engines = list(self._engines.values())
        for eng in engines:
            eng.slo_label = name

    def utilization(self) -> Dict[str, Any]:
        """Device-telemetry utilization row for the hosting replica's
        publish loop and the local-mode fold (``state.utilization()``):
        the base engine's exact bookkeeping (its ``deployment`` the label),
        plus each live adapter engine's row under ``adapters``."""
        row = self._engine.utilization()
        with self._engines_lock:
            extras = [(m, e) for m, e in self._engines.items()
                      if m is not None]
        adapters = {model: eng.utilization() for model, eng in extras}
        if adapters:
            row["adapters"] = adapters
        return row

    def prefix_digest(self) -> Dict[str, Any]:
        """Cache-aware routing surface: the base engine's prefix-chain
        digest plus the adapter ids this server has loaded (LoRA affinity)
        and the live request depth over every engine."""
        digest = self._engine.prefix_digest()
        with self._engines_lock:
            engines = list(self._engines.values())
            models = list(self._engine_order)
        qlen = 0
        for eng in engines:
            with eng._lock:
                qlen += len(eng._requests)
        digest["models"] = models
        digest["qlen"] = qlen
        return digest

    def _wait_done(self, wkey) -> List[int]:
        """Block until ``wkey``'s request finishes; return all its tokens."""
        try:
            with self._cv:
                while wkey not in self._done:
                    if self._error is not None:
                        raise RuntimeError(
                            "LLM engine loop failed") from self._error
                    if self._stop:
                        raise RuntimeError("LLM server shut down")
                    self._cv.wait(timeout=0.1)
                buf = self._done.pop(wkey)
            self._note_specdec(wkey)
            return buf
        finally:
            with self._cv:
                self._active_waiters.discard(wkey)

    def _note_specdec(self, wkey) -> None:
        """Attach a finished request's speculative acceptance (the
        engine's per-request stats) to the active SLO tracker's row.  A
        no-op for engines without speculation, unknown ids, or callers
        with no tracker context (a cluster-mode replica relies on the
        ledger fold and the metric families)."""
        model, gen_id, rid = wkey
        if model is None:
            eng = self._engine
        else:
            with self._engines_lock:
                eng = (self._engines.get(model)
                       if self._engine_gen.get(model, 0) == gen_id
                       else None)
        stats_of = getattr(eng, "specdec_request_stats", None)
        stats = stats_of(rid) if stats_of is not None else None
        if stats:
            from ray_tpu_torch.serve._private import slo

            slo.note_specdec_request(stats[0], stats[1])

    def _iter_tokens(self, wkey):
        """Yield ``wkey``'s token chunks as they decode (generate_stream's
        engine-side loop, shared with the disaggregated decode stage).

        Closing the generator BEFORE exhaustion (the caller went away)
        aborts the engine-side request: its slot and KV blocks return to
        the pool at once instead of decoding to max_new_tokens for
        nobody."""
        sent = 0
        completed = False
        try:
            while True:
                with self._cv:
                    while True:
                        if self._error is not None:
                            raise RuntimeError(
                                "LLM engine loop failed") from self._error
                        if self._stop:
                            raise RuntimeError("LLM server shut down")
                        done = wkey in self._done
                        buf = (self._done[wkey] if done
                               else self._waiters.get(wkey, []))
                        if len(buf) > sent or done:
                            break
                        self._cv.wait(timeout=0.1)
                    chunk = list(buf[sent:])
                    sent += len(chunk)
                    if done:
                        self._done.pop(wkey, None)
                if chunk:
                    yield chunk
                if done:
                    completed = True
                    self._note_specdec(wkey)
                    return
        finally:
            if not completed:
                self._abort_wkey(wkey)
            with self._cv:
                self._active_waiters.discard(wkey)

    def _abort_wkey(self, wkey) -> None:
        """Cancel ``wkey``'s engine request and drop its buffers (stream
        abandoned mid-decode).  Best-effort: a request that finished in
        the race just cleans its unclaimed buffers."""
        model, gen_id, rid = wkey
        if model is None:
            # the cancel's drain resolves the in-flight chunk for EVERY
            # slot — run it atomically vs the loop's step+apply and
            # reconcile bystander buffers after (see _reap_drained)
            with self._step_lock:
                try:
                    with torch.cuda.stream(self._stream):
                        self._engine.cancel_request(rid)
                except Exception:  # noqa: BLE001 — abort must never mask the close
                    pass
                with self._cv:
                    self._waiters.pop(wkey, None)
                    self._done.pop(wkey, None)
                    self._aborted.add(wkey)
                    if len(self._aborted) > 4096:  # backstop
                        self._aborted.clear()
                self._reap_drained()
            return
        try:
            with self._engines_lock:
                eng = (self._engines.get(model)
                       if self._engine_gen.get(model, 0) == gen_id
                       else None)
            if eng is not None:
                with torch.cuda.stream(self._stream):
                    eng.cancel_request(rid)
        except Exception:  # noqa: BLE001 — abort must never mask the close
            pass
        with self._cv:
            self._waiters.pop(wkey, None)
            self._done.pop(wkey, None)
            self._aborted.add(wkey)
            if len(self._aborted) > 4096:  # never-seen-again backstop
                self._aborted.clear()

    def _submit(self, model: Optional[str], prompt, gen):
        """Resolve the engine for ``model`` and enqueue the request under
        ONE _engines_lock critical section, returning the waiter key.

        Invariants this protects:
          - the merge, the engine's build and its captures happen OUTSIDE
            the lock (the _run loop takes it every iteration; building
            under it would freeze every in-flight stream);
          - add_request runs while holding the lock, so the eviction scan
            (which only removes engines with has_work() false, also under
            the lock) can never orphan a just-submitted request;
          - waiter keys carry the engine's BUILD GENERATION: a rebuilt
            engine restarts its request-id counter, and without the gen a
            new request could collide with an abandoned one's buffers."""
        if not model or model not in self._adapters:
            # base engine is never evicted, so its waiters need no registry
            return (None, 0, self._engine.add_request(prompt, gen))
        built = None
        while True:
            with self._engines_lock:
                eng = self._engines.get(model)
                if eng is None and built is not None:
                    self._engine_gen[model] = self._engine_gen.get(model, 0) + 1
                    if self._slo_label is not None:
                        built.slo_label = self._slo_label
                    self._engines[model] = eng = built
                if eng is not None:
                    rid = eng.add_request(prompt, gen)
                    wkey = (model, self._engine_gen[model], rid)
                    with self._cv:
                        self._active_waiters.add(wkey)
                    if model in self._engine_order:
                        self._engine_order.remove(model)
                    self._engine_order.append(model)
                    self._evict_idle_locked(keep=model)
                    return wkey
            built = self._build_engine(model)

    def _build_engine(self, model: str):
        """An engine over ``model``'s merged weights, with the adapter's
        speculative choice (``SpeculativeConfig.per_adapter``: opt out,
        its own k, or a LoRA merged into the draft), warmed on CUDA in
        this thread.  None when another caller's build of ``model`` landed
        while this one waited for the build lock."""
        # per-adapter draft choice: an adapter may opt out, override k, or
        # carry its own draft-model LoRA so the draft tracks the tuned
        # target
        spec_cfg, draft_adapter = adapter_speculation(
            self._config.speculative_config, model)
        cfg = self._config
        if spec_cfg is not self._config.speculative_config:
            cfg = dataclasses.replace(cfg, speculative_config=spec_cfg)
        with self._build_lock:
            with self._engines_lock:
                if model in self._engines:
                    return None
            dparams = self._draft_params
            with torch.cuda.stream(self._stream):
                if spec_cfg is not None and draft_adapter is not None:
                    dparams = merge_lora(self._draft_params, draft_adapter)
                base = (self._base_params if self._base_params is not None
                        else self._engine.params)
                eng = make_engine(
                    cfg, merge_lora(base, self._adapters[model]),
                    device=self._device, draft_params=dparams)
                if self._stream is not None and hasattr(eng, "warmup"):
                    eng.warmup()
            return eng

    def _evict_idle_locked(self, keep):
        extra = len(self._engine_order) - self._MAX_ADAPTER_ENGINES
        for name in list(self._engine_order):
            if extra <= 0:
                break
            if name != keep and not self._engines[name].has_work():
                del self._engines[name]
                self._engine_order.remove(name)
                extra -= 1
                # drop the evicted engine's ABANDONED result buffers only:
                # a finished-but-unclaimed result may still have a live
                # caller between cv polls — never delete under a waiter
                with self._cv:
                    for wkey in [k for k in self._done
                                 if k[0] == name and k not in self._active_waiters]:
                        del self._done[wkey]
                    for wkey in [k for k in self._waiters
                                 if k[0] == name and k not in self._active_waiters]:
                        del self._waiters[wkey]

    def _run(self):
        with torch.cuda.stream(self._stream):
            while not self._stop:
                with self._engines_lock:
                    # an adapter engine still draining its in-flight chunk
                    # when a newer one was built (so _engine_for could not
                    # evict it) goes once it idles: the LRU cap holds
                    # whatever order the loop and the callers run in
                    self._evict_idle_locked(keep=None)
                    engines = list(self._engines.items())
                worked = False
                for key, engine in engines:
                    if not engine.has_work():
                        continue
                    worked = True
                    gen_id = self._engine_gen.get(key, 0)
                    # step + apply are one atomic unit vs export/cancel
                    # drains: a drain between the step's snapshot-delta
                    # gather and this apply would reconcile the buffer to
                    # full history and then have the stale delta re-appended
                    with self._step_lock:
                        try:
                            emitted = engine.step()
                        except Exception as e:  # noqa: BLE001 — fail waiters, not hang
                            with self._cv:
                                self._error = e
                                self._cv.notify_all()
                            return
                        if emitted:
                            self._apply_locked(key, gen_id, engine, emitted)
                    # yield between steps: a caller woken by the release
                    # (an export, a cancel, an import, add_request) takes
                    # the step or engine lock before the loop takes it
                    # again, instead of waiting until the engines idle
                    time.sleep(0)
                if not worked:
                    time.sleep(0.002)

    def _apply_locked(self, key, gen_id, engine, emitted) -> None:
        """Append one step's tokens to their waiter buffers and move the
        requests that left ``engine`` to done (step lock held)."""
        with self._cv:
            for rid, toks in emitted.items():
                wk = (key, gen_id, rid)
                if wk in self._migrating:
                    # an export is reconciling this stream's history into
                    # its buffer — these tokens are already in the handoff
                    continue
                if wk in self._aborted:
                    self._aborted.discard(wk)
                    continue
                self._waiters.setdefault(wk, []).extend(toks)
            with engine._lock:
                live = set(engine._requests)
            for wkey in list(self._waiters):
                if (wkey[0] == key and wkey[1] == gen_id
                        and wkey[2] not in live
                        and wkey not in self._migrating):
                    buf = self._waiters.pop(wkey)
                    if wkey in self._aborted:
                        self._aborted.discard(wkey)
                    else:
                        self._done[wkey] = buf
            self._cv.notify_all()

    # -- live KV migration ------------------------------------------------
    #
    # A live stream moves between decode servers in phases: the SOURCE
    # exports the engine request (export_stream — the slot and KV blocks
    # free immediately), the handoff travels to the DESTINATION
    # (import_migration — scatter + draft re-seed, or recompute), and the
    # destination's continuation stream (resume_stream) yields the tokens
    # decoded after the handoff.

    def migratable_streams(self) -> List[int]:
        """Base-engine request ids currently in the exportable state
        (prefill complete, >= 1 token emitted).  Adapter streams are not
        listed — they carry no base-pool KV and resume on a destination
        by recompute."""
        eng = self._engine
        if not hasattr(eng, "export_request"):
            return []
        out: List[int] = []
        with eng._lock:
            for rid, req in eng._requests.items():
                if (not req.done and req.slot >= 0
                        and req.prefill_pos >= len(req.prompt)
                        and req.out_tokens):
                    out.append(rid)
        return out

    def export_stream(self, rid: int) -> Dict[str, Any]:
        """Source-side migration export: drain + export ``rid`` from the
        base engine and reconcile the waiter buffer with the handoff's
        authoritative token history (the export's drain may resolve
        tokens the _run loop never gathered).  The wkey is marked migrating
        under the step lock, so the reconcile is race-free against the
        loop: a step the loop took before the export has been applied in
        full, the stream's last tokens and its end included, when the
        request finished in it (marked before the lock, that step's apply
        would skip both and the export then find no request: the stream
        would hang short of its end).  On ANY failure the stream is healed
        back to normal operation — tokens re-synced from the engine,
        migration mark dropped — and the error re-raised."""
        wkey = (None, 0, rid)
        with self._step_lock:
            with self._cv:
                self._migrating.add(wkey)
            try:
                with torch.cuda.stream(self._stream):
                    h = self._engine.export_request(rid)
            except BaseException:
                # export refused/died: the request may still be live in
                # the engine.  Re-sync the waiter buffer from engine
                # truth (the loop skipped emissions while the wkey was
                # marked) and hand the stream back to the normal path.
                with self._cv:
                    self._migrating.discard(wkey)
                    if wkey not in self._aborted:
                        with self._engine._lock:
                            req = self._engine._requests.get(rid)
                            hist = (list(req.out_tokens)
                                    if req is not None and not req.done
                                    else None)
                        if hist is not None:
                            buf = self._waiters.setdefault(wkey, [])
                            if len(hist) > len(buf):
                                buf.extend(hist[len(buf):])
                        self._cv.notify_all()
                self._reap_drained()  # rid, if the drain completed it
                raise
            h["model"] = None
            with self._cv:
                if wkey in self._aborted:
                    # client vanished during the export — nothing to resume
                    self._migrating.discard(wkey)
                else:
                    buf = self._waiters.setdefault(wkey, [])
                    if len(h["emitted"]) > len(buf):
                        buf.extend(h["emitted"][len(buf):])
                        self._cv.notify_all()
            # OTHER streams: the drain resolved their in-flight chunk
            # (and may have completed some) — reconcile before the loop
            # resumes stepping
            self._reap_drained()
        return h

    def _reap_drained(self) -> None:
        """Reconcile waiter buffers after an export/cancel drain.  The
        drain resolves the in-flight decode chunk for EVERY slot, and
        ``step()`` reports tokens as a snapshot delta taken at step
        entry — tokens a drain appended to ``out_tokens`` are invisible
        to all future deltas, so without this sync bystander streams
        silently lose one chunk.  A waiter buffer is always a prefix of
        its request's ``out_tokens`` (both are append-only, the loop
        extends from snapshot diffs), so topping up is bit-exact.
        Requests the drain COMPLETED are also moved to done here: once
        every slot is free ``has_work`` goes false and the loop would
        never gather them, hanging their consumers.  Mid-migration wkeys
        are skipped; aborted wkeys just clear their mark."""
        with self._cv:
            with self._engine._lock:
                dead, live = [], []
                for rid, req in list(self._engine._requests.items()):
                    wk = (None, 0, rid)
                    if wk in self._migrating:
                        continue
                    if req.done:
                        dead.append((wk, list(req.out_tokens)))
                        del self._engine._requests[rid]
                    elif req.out_tokens:
                        live.append((wk, list(req.out_tokens)))
            for wk, hist in live:
                if wk in self._aborted:
                    continue
                buf = self._waiters.setdefault(wk, [])
                if len(hist) > len(buf):
                    buf.extend(hist[len(buf):])
            for wk, hist in dead:
                if wk in self._aborted:
                    self._aborted.discard(wk)
                    self._waiters.pop(wk, None)
                    continue
                buf = self._waiters.setdefault(wk, [])
                if len(hist) > len(buf):
                    buf.extend(hist[len(buf):])
                self._done[wk] = self._waiters.pop(wk)
            if dead or live:
                self._cv.notify_all()

    @staticmethod
    def _handoff_gen(handoff: Dict[str, Any],
                     max_new_tokens: Optional[int] = None):
        g = handoff["gen"]
        return GenerationConfig(
            max_new_tokens=(g["max_new_tokens"] if max_new_tokens is None
                            else max_new_tokens),
            temperature=g["temperature"], top_k=g["top_k"],
            seed=g.get("seed", 0),
            stop_token_ids=tuple(g["stop_token_ids"]))

    def import_migration(self, handoff: Dict[str, Any],
                         allow_recompute: bool = False):
        """Destination-side migration import.  Tries the exact-resume KV
        import first (zero recompute); ``allow_recompute`` falls back to
        re-prefilling prompt + history as a fresh request with the
        remaining token budget (greedy tokens equal either way; emitted
        history is never re-emitted).  Returns {wkey, done, mode} or None
        when this server can't take the stream right now (no slot / no
        blocks) and recompute is not allowed.

        Idempotent under retry: the handoff's ``mig_id`` keys a bounded
        result memo, so a retry after a lost reply gets the FIRST import's
        stream back instead of forking a duplicate."""
        mig_id = handoff.get("mig_id")
        if mig_id is not None:
            with self._cv:
                prev = self._mig_imports.get(mig_id)
            if prev is not None:
                return prev
        model = handoff.get("model")
        emitted = [int(t) for t in handoff["emitted"]]
        res = None
        if (not model and handoff.get("k") is not None
                and hasattr(self._engine, "import_request")):
            try:
                with torch.cuda.stream(self._stream):
                    res = self._engine.import_request(
                        handoff["prompt"], handoff["first_token"],
                        handoff["k"], handoff["v"],
                        self._handoff_gen(handoff), emitted=emitted)
            except ValueError:
                # geometry mismatch (block size / max_seq) — recompute
                # is the only road
                res = None
        if res is not None:
            wkey = (None, 0, res["request_id"])
            out = {"wkey": list(wkey), "done": bool(res["done"]),
                   "mode": "import"}
            with self._cv:
                self._active_waiters.add(wkey)
                if res["done"]:
                    # budget/stop boundary hit exactly at the handoff:
                    # the continuation stream is empty but must exist
                    self._done[wkey] = []
                    self._cv.notify_all()
                self._memo_import_locked(mig_id, out)
            return out
        if not allow_recompute:
            return None
        out = self._recompute_resume(model, handoff)
        if out is not None:
            with self._cv:
                self._memo_import_locked(mig_id, out)
        return out

    def _memo_import_locked(self, mig_id, result) -> None:
        if mig_id is None:
            return
        self._mig_imports[mig_id] = result
        while len(self._mig_imports) > 1024:  # bounded retry memo
            self._mig_imports.pop(next(iter(self._mig_imports)))

    def _recompute_resume(self, model: Optional[str],
                          handoff: Dict[str, Any]):
        """Resume a migrated stream WITHOUT its KV: re-prefill
        prompt + emitted history as a fresh request whose budget is the
        remaining tokens (the prefix cache usually absorbs most of the
        re-prefill).  History is the new prompt's tail, so nothing is
        ever re-emitted."""
        hist = [int(t) for t in handoff["emitted"]]
        g = handoff["gen"]
        remaining = int(g["max_new_tokens"]) - len(hist)
        if remaining <= 0 or (hist and hist[-1] in g["stop_token_ids"]):
            return {"wkey": None, "done": True, "mode": "recompute"}
        gen = self._handoff_gen(handoff, max_new_tokens=remaining)
        wkey = self._submit(model, list(handoff["prompt"]) + hist, gen)
        with self._cv:
            self._active_waiters.add(wkey)
        return {"wkey": list(wkey), "done": False, "mode": "recompute"}

    def resume_stream(self, wkey):
        """Destination-side continuation stream for a migrated-in
        request: yields only tokens decoded AFTER the handoff point
        (the source already streamed the history)."""
        yield from self._iter_tokens(tuple(wkey))

    def cancel_stream(self, wkey) -> None:
        """Abort a migrated-in stream."""
        self._abort_wkey(tuple(wkey))

    def _splice(self, rid: int, pull, cancel_remote,
                handoff: Dict[str, Any]) -> threading.Thread:
        """Install the relay for an exported stream: a thread feeds the
        client's ORIGINAL waiter buffer (old wkey) from ``pull``, an
        iterator of continuation chunks from the destination (or a local
        restore).  If the destination dies mid-relay, the stream degrades
        once to local recompute from prompt + delivered history on this
        server: no token the client sees is dropped, at re-prefill cost.
        A client that went away meanwhile (its wkey aborted) closes the
        pull and cancels the destination's copy."""
        wkey = (None, 0, rid)
        hist = [int(t) for t in handoff["emitted"]]
        g = dict(handoff["gen"])

        def run():
            from ray_tpu_torch._private import runtime_metrics

            it = pull
            fell_back = False
            while True:
                try:
                    for chunk in it:
                        toks = [int(t) for t in chunk]
                        with self._cv:
                            if wkey in self._aborted:
                                for fn in (getattr(it, "close", None),
                                           cancel_remote):
                                    try:
                                        if fn is not None:
                                            fn()
                                    except Exception:  # noqa: BLE001 — abort cleanup is best-effort
                                        pass
                                self._migrating.discard(wkey)
                                return
                            hist.extend(toks)
                            self._waiters.setdefault(wkey, []).extend(toks)
                            self._cv.notify_all()
                    break  # the destination's stream completed
                except Exception:  # noqa: BLE001 — dest died mid-relay: degrade, don't drop
                    if fell_back:
                        break  # the local fallback failed too: end below
                    fell_back = True
                    runtime_metrics.record_kv_migration(
                        handoff.get("reason", "manual"), "fallback")
                    runtime_metrics.maybe_push(0.0)  # see evacuate_streams
                    remaining = int(g["max_new_tokens"]) - len(hist)
                    if remaining <= 0:
                        break
                    try:
                        new_wkey = self._submit(
                            None, list(handoff["prompt"]) + hist,
                            self._handoff_gen(handoff,
                                              max_new_tokens=remaining))
                    except Exception:  # noqa: BLE001 — even local admission failed
                        break
                    it = self._iter_tokens(new_wkey)
            with self._cv:
                self._migrating.discard(wkey)
                if wkey not in self._aborted:
                    self._done[wkey] = self._waiters.pop(wkey, [])
                    self._cv.notify_all()

        t = threading.Thread(target=run, daemon=True,
                             name="kv-migration-splice")
        t.start()
        return t

    def _finish_migrated(self, rid: int) -> None:
        """End an exported stream whose continuation is EMPTY (the budget
        or a stop token landed exactly on the handoff): its waiter buffer
        already holds the whole history."""
        wkey = (None, 0, rid)
        with self._cv:
            self._migrating.discard(wkey)
            if wkey not in self._aborted:
                self._done[wkey] = self._waiters.pop(wkey, [])
                self._cv.notify_all()

    def evacuate_streams(self, dests=None, reason: str = "drain",
                         max_streams: Optional[int] = None,
                         dest_servers=None) -> Dict[str, int]:
        """Migrate this server's live base-engine streams to ``dests``
        (serve replicas' actor-id hexes) or ``dest_servers`` (servers in
        this process): the controller's entry point for a draining
        replica and for rebalancing.  Returns the outcome counts
        {migrated, fallback, skipped}; every stream survives, in the worst
        case restored into this server's own engine.

        The outcomes are pushed to the cluster's metrics at once: a
        draining replica is killed as soon as its relayed streams end,
        which may come before its next periodic push."""
        from ray_tpu_torch._private import runtime_metrics
        from ray_tpu_torch.serve._private import kv_migration

        out = kv_migration.evacuate(self, dests or [], reason=reason,
                                    max_streams=max_streams,
                                    dest_servers=dest_servers)
        runtime_metrics.maybe_push(0.0)
        return out

    def shutdown(self) -> None:
        """Stop the loop thread and wait for it; then, on CUDA, wait for
        the server's stream, so no chunk is still running when the caller
        frees the engines.  Callers still waiting raise."""
        self._stop = True
        if self._loop is not threading.current_thread():
            self._loop.join()
        if self._stream is not None:
            self._stream.synchronize()
        # a tensor-parallel engine's rank processes stop with the server
        for eng in list(self._engines.values()):
            stop = getattr(eng, "shutdown", None)
            if stop is not None:
                stop()

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, stop_token_ids: Sequence[int] = (),
                 model: Optional[str] = None) -> List[int]:
        """Generate completion token ids for one prompt (sync; batching with
        concurrent callers happens inside the engine). ``model`` selects a
        registered LoRA adapter (None/base id -> base weights)."""
        gen = GenerationConfig(max_new_tokens=max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               stop_token_ids=tuple(stop_token_ids))
        wkey = self._submit(model, list(prompt), gen)
        return self._wait_done(wkey)

    def generate_stream(self, prompt: Sequence[int],
                        max_new_tokens: int = 64, temperature: float = 0.0,
                        top_k: int = 0, stop_token_ids: Sequence[int] = (),
                        model: Optional[str] = None):
        """Yield token chunks as they decode; closing the generator early
        aborts the request."""
        gen = GenerationConfig(max_new_tokens=max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               stop_token_ids=tuple(stop_token_ids))
        wkey = self._submit(model, list(prompt), gen)
        yield from self._iter_tokens(wkey)

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """HTTP-style entry: {"prompt": [ids], "max_new_tokens": n, ...}."""
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
        return self._loop.is_alive()


def build_llm_deployment(llm_config: LLMConfig, params=None, *,
                         name: str = "llm",
                         lora_adapters: Optional[Dict[str, Any]] = None,
                         draft_params=None, device=None):
    """An Application serving ``llm_config`` through ``LLMServer``
    replicas (the reference's signature, plus ``device``, passed through
    ``bind`` to every replica's server: None is the card, "cpu" what the
    CPU tests ask for).

    Replicas are sized by ``llm_config.resources_per_replica(device)``.
    ``params`` travel in the deployment's record and are unpickled at each
    replica start: pass None at full size, and every replica draws seed-0
    weights on its own card.  ``draft_params``: the weights of
    ``llm_config.speculative_config``'s draft (ignored without one)."""
    from ray_tpu_torch import serve

    deployment = serve.deployment(
        LLMServer,
        name=name,
        num_replicas=llm_config.num_replicas,
        # concurrent callers share the engine's decode batch
        max_ongoing_requests=max(8, llm_config.max_batch_size),
        ray_actor_options={
            "resources": llm_config.resources_per_replica(device)},
    )
    return deployment.bind(llm_config, params, lora_adapters, draft_params,
                           device=device)
