"""OpenAI-compatible serving surface in process (port of
``ray_tpu/llm/openai_api.py``).

``OpenAICompatServer`` is an ``LLMServer`` that speaks the OpenAI
completion, chat-completion and model-listing schemas.  The engine speaks
token ids, so the server carries a tokenizer: any object with
``encode(str) -> List[int]`` / ``decode(List[int]) -> str`` (a transformers
tokenizer qualifies); ``ByteTokenizer`` is a vocab-free one that needs no
files (a copy of the JAX package's; tests/test_torch_openai.py holds it to
the original).

``build_openai_app`` makes the server a serve deployment.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Sequence

from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.serve import LLMServer


def _longest_stop_prefix(text: str, stops: List[str]) -> int:
    """Length of the longest suffix of ``text`` that is a proper prefix of
    any stop string (must be withheld until disambiguated)."""
    best = 0
    for s in stops:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                best = max(best, k)
                break
    return best


class ByteTokenizer:
    """Vocab-free reversible tokenizer: one token per utf-8 byte, plus bos.

    Adequate for tests and smoke serving; swap in a transformers tokenizer
    for real models (same duck type)."""

    vocab_size = 257
    bos_id = 256

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")


class OpenAICompatServer(LLMServer):
    """LLMServer speaking the OpenAI request/response schemas. LoRA
    adapters appear as additional model ids."""

    def __init__(self, llm_config: LLMConfig, params=None, tokenizer=None,
                 model_id: str = "ray-tpu-llm", lora_adapters=None, *,
                 device=None, generator=None):
        super().__init__(llm_config, params, lora_adapters, device=device,
                         generator=generator)
        self._tok = tokenizer or ByteTokenizer()
        self._model_id = model_id

    def _adapter_of(self, req: Dict[str, Any]):
        model = req.get("model")
        return model if model in self.lora_model_ids() else None

    # -- shared ---------------------------------------------------------

    def _complete_text(self, text: str, req: Dict[str, Any]) -> Dict[str, Any]:
        prompt_ids = self._tok.encode(text)
        max_tokens = int(req.get("max_tokens", 16))
        out_ids = self.generate(
            prompt_ids,
            max_new_tokens=max_tokens,
            temperature=float(req.get("temperature", 0.0)),
            top_k=int(req.get("top_k", 0)),
            stop_token_ids=req.get("stop_token_ids", ()),
            model=self._adapter_of(req),
        )
        out_text = self._tok.decode(out_ids)
        finish = "stop" if len(out_ids) < max_tokens else "length"
        # OpenAI "stop" strings: truncate at the first occurrence
        stops = req.get("stop") or []
        if isinstance(stops, str):
            stops = [stops]
        cut = min((out_text.find(s) for s in stops
                   if s and out_text.find(s) != -1), default=-1)
        if cut != -1:
            out_text = out_text[:cut]
            finish = "stop"
        return {
            "text": out_text,
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": len(out_ids),
            "finish_reason": finish,
        }

    def _render_chat(self, messages: List[Dict[str, Any]]) -> str:
        """ONE chat template for streaming and non-streaming: the
        tokenizer's own (transformers) when it has one, else a minimal
        role-tagged fallback."""
        if hasattr(self._tok, "apply_chat_template"):
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        return "".join(f"<{m.get('role', 'user')}>{m.get('content', '')}\n"
                       for m in messages) + "<assistant>"

    def _usage(self, gens: List[Dict[str, Any]]) -> Dict[str, int]:
        pt = sum(g["prompt_tokens"] for g in gens)
        ct = sum(g["completion_tokens"] for g in gens)
        return {"prompt_tokens": pt, "completion_tokens": ct,
                "total_tokens": pt + ct}

    # -- endpoints ------------------------------------------------------

    def completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """POST /v1/completions."""
        prompts = request.get("prompt", "")
        if isinstance(prompts, str):
            prompts = [prompts]
        choices, gens = [], []
        for i, p in enumerate(prompts):
            gen = self._complete_text(p, request)
            gens.append(gen)
            choices.append({"index": i, "text": gen["text"],
                            "finish_reason": gen["finish_reason"],
                            "logprobs": None})
        usage = self._usage(gens)
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": request.get("model", self._model_id),
            "choices": choices,
            "usage": usage,
        }

    def chat_completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """POST /v1/chat/completions — messages rendered with
        ``_render_chat``."""
        gen = self._complete_text(self._render_chat(request.get("messages", [])),
                                  request)
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": request.get("model", self._model_id),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": gen["text"]},
                "finish_reason": gen["finish_reason"],
            }],
            "usage": self._usage([gen]),
        }

    def _stream_chunks(self, request: Dict[str, Any], chat: bool):
        """Generator of OpenAI SSE chunk objects (dicts).  Multi-prompt
        completion requests stream each prompt in turn with its own choice
        index."""
        if chat:
            texts = [self._render_chat(request.get("messages", []))]
            rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
            obj = "chat.completion.chunk"
        else:
            prompts = request.get("prompt", "")
            texts = prompts if isinstance(prompts, list) else [prompts]
            rid = f"cmpl-{uuid.uuid4().hex[:24]}"
            obj = "text_completion"
        created = int(time.time())
        model = request.get("model", self._model_id)
        head = {"id": rid, "object": obj, "created": created, "model": model}
        stops = request.get("stop") or []
        if isinstance(stops, str):
            stops = [stops]
        max_tokens = int(request.get("max_tokens", 16))
        for index, text in enumerate(texts):
            emitted_tokens = 0
            all_ids: List[int] = []
            sent_chars = 0
            finish = None
            for chunk in self.generate_stream(
                    self._tok.encode(text),
                    max_new_tokens=max_tokens,
                    temperature=float(request.get("temperature", 0.0)),
                    top_k=int(request.get("top_k", 0)),
                    stop_token_ids=request.get("stop_token_ids", ()),
                    model=self._adapter_of(request)):
                emitted_tokens += len(chunk)
                all_ids.extend(chunk)
                # incremental detokenization: decode the cumulative ids and
                # emit only the stable delta — a multi-byte character split
                # across chunks must not surface as replacement chars
                full = self._tok.decode(all_ids)
                stable = len(full) - (1 if full.endswith("�") else 0)
                cut = min((full.find(s) for s in stops
                           if s and full.find(s) != -1), default=-1)
                if cut != -1:
                    stable, finish = cut, "stop"
                else:
                    # hold back any tail that could still grow into a stop
                    # string (emitting "...E" then finding "END" next chunk
                    # would leak text the non-streaming path truncates)
                    stable -= _longest_stop_prefix(full[:stable], stops)
                piece = full[sent_chars:stable]
                sent_chars = max(sent_chars, stable)
                if piece:
                    choice = ({"index": index, "delta": {"content": piece},
                               "finish_reason": None} if chat else
                              {"index": index, "text": piece,
                               "finish_reason": None})
                    yield {**head, "choices": [choice]}
                if finish == "stop":
                    break
            if finish is None:
                # flush text held back as a potential stop-string prefix —
                # generation ended, so it can no longer grow into one
                full = self._tok.decode(all_ids)
                tail = full[sent_chars:len(full)
                            - (1 if full.endswith("�") else 0)]
                if tail:
                    choice = ({"index": index, "delta": {"content": tail},
                               "finish_reason": None} if chat else
                              {"index": index, "text": tail,
                               "finish_reason": None})
                    yield {**head, "choices": [choice]}
                finish = "stop" if emitted_tokens < max_tokens else "length"
            final = ({"index": index, "delta": {}, "finish_reason": finish}
                     if chat else
                     {"index": index, "text": "", "finish_reason": finish})
            yield {**head, "choices": [final]}

    def models(self, _request=None) -> Dict[str, Any]:
        """GET /v1/models."""
        return {"object": "list",
                "data": [{"id": self._model_id, "object": "model",
                          "owned_by": "ray_tpu"}] + [
                    {"id": mid, "object": "model", "owned_by": "ray_tpu",
                     "parent": self._model_id}
                    for mid in self.lora_model_ids()]}

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Dispatch on the payload's shape: "stream" -> SSE chunks,
        "messages" -> chat completion, "prompt" -> completion, empty body
        -> model listing."""
        if request and request.get("stream"):
            return self._stream_chunks(request, chat="messages" in request)
        if request and "messages" in request:
            return self.chat_completions(request)
        if request and "prompt" in request:
            return self.completions(request)
        return self.models(request)


def build_openai_app(llm_config: LLMConfig, params=None, *, tokenizer=None,
                     model_id: str = "ray-tpu-llm", name: str = "openai-llm",
                     lora_adapters=None, device=None):
    """An Application serving the OpenAI schemas through
    ``OpenAICompatServer`` replicas (the reference's signature, plus
    ``device``, passed through ``bind`` to every replica's server)."""
    from ray_tpu_torch import serve

    deployment = serve.deployment(
        OpenAICompatServer,
        name=name,
        num_replicas=llm_config.num_replicas,
        max_ongoing_requests=max(8, llm_config.max_batch_size),
        ray_actor_options={
            "resources": llm_config.resources_per_replica(device)},
    )
    return deployment.bind(llm_config, params, tokenizer, model_id,
                           lora_adapters, device=device)
