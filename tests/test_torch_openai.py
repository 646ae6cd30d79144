"""The port's ``OpenAICompatServer`` (``ray_tpu_torch.llm.openai_api``)
against ``ray_tpu.llm.openai_api.OpenAICompatServer`` on the CPU: every
response equals JAX's key for key but ``id`` and ``created`` —
completions (one prompt and several, stop strings and stop ids), chat
completions, streamed chunks of both (the held-back stop-string prefix
through ``_longest_stop_prefix``), a LoRA adapter by model id, and the
model listing.  ``ByteTokenizer`` and ``_longest_stop_prefix`` are copies,
held to the originals.

The fp32 micro model's vocabulary covers the byte tokenizer's 257 ids;
weights come from ``convert.params_from_jax``/``lora_from_jax``.  Both
servers are shut down in a ``finally``.
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import lora as jlora
from ray_tpu.llm import openai_api as jopenai
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm import openai_api as topenai
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

_CFG_KW = dict(vocab_size=264, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=128, max_seq_len=128)
_ENGINE_KW = dict(max_batch_size=4, max_seq_len=128, block_size=8,
                  prefill_chunk=32, decode_chunk=4)
_MSGS = [{"role": "system", "content": "be brief"},
         {"role": "user", "content": "hi there"}]


@pytest.fixture(scope="module")
def servers():
    """(the port's server, JAX's) over the same weights, model id
    "tiny-llama", adapter "tuned" (wq and wv, nonzero B) on both."""
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    ad = jlora.init_lora(jcfg, jlora.LoRAConfig(rank=4, alpha=8.0),
                         jax.random.PRNGKey(4))
    for i, name in enumerate(("wq", "wv")):
        ad["layers"][name]["B"] = jax.random.normal(
            jax.random.PRNGKey(40 + i), ad["layers"][name]["B"].shape) * 0.5
    tcfg = tl.LlamaConfig.tiny(**_CFG_KW)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    tad = convert.lora_from_jax(jax.tree.map(np.asarray, ad), device="cpu")
    made = []
    try:
        made.append(topenai.OpenAICompatServer(
            LLMConfig(model_config=tcfg, **_ENGINE_KW), tp,
            model_id="tiny-llama", lora_adapters={"tuned": tad},
            device="cpu"))
        made.append(jopenai.OpenAICompatServer(
            JLLMConfig(model_config=jcfg, **_ENGINE_KW), jp,
            model_id="tiny-llama", lora_adapters={"tuned": ad}))
        yield tuple(made)
    finally:
        for s in made:
            s.shutdown()


def _strip(resp):
    assert resp["id"].startswith(("cmpl-", "chatcmpl-"))
    assert isinstance(resp["created"], int)
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _both(servers, fn):
    port, ref = servers
    return fn(port), fn(ref)


def test_byte_tokenizer_and_stop_prefix_are_the_originals():
    tok, ref = topenai.ByteTokenizer(), jopenai.ByteTokenizer()
    assert (tok.vocab_size, tok.bos_id) == (ref.vocab_size, ref.bos_id)
    for text in ("", "hello", "héllo wörld ✓", "\n<user>x"):
        assert tok.encode(text) == ref.encode(text)
        assert tok.decode(tok.encode(text)) == ref.decode(ref.encode(text))
    ids = [256, 104, 195, 300, -1, 105, 226, 156]  # bos, out of range, split
    assert tok.decode(ids) == ref.decode(ids)
    for text, stops in (("abcE", ["END"]), ("abcEN", ["END", "N!"]),
                        ("xyz", ["END"]), ("a", ["ab", "a"]), ("", ["x"]),
                        ("ENDE", ["END"])):
        assert (topenai._longest_stop_prefix(text, stops)
                == jopenai._longest_stop_prefix(text, stops))


@pytest.mark.timeout(240)
def test_completions_equal_jax(servers):
    port, ref = _both(servers, lambda s: s.completions(
        {"model": "tiny-llama", "prompt": "hello", "max_tokens": 12}))
    assert _strip(port) == _strip(ref)
    assert port["object"] == "text_completion"
    usage, choice = port["usage"], port["choices"][0]
    assert usage["prompt_tokens"] == len("hello") + 1  # bos
    assert usage["completion_tokens"] == 12 and choice["finish_reason"] == "length"
    assert usage["total_tokens"] == 6 + 12
    # several prompts: one choice each, usage summed
    req = {"prompt": ["a", "bb", "hello"], "max_tokens": 6}
    port, ref = _both(servers, lambda s: s.completions(req))
    assert _strip(port) == _strip(ref)
    assert [c["index"] for c in port["choices"]] == [0, 1, 2]
    assert port["usage"]["prompt_tokens"] == 2 + 3 + 6


@pytest.mark.timeout(240)
def test_stop_strings_and_stop_ids_equal_jax(servers):
    """A stop string cut from the unstopped text (so it occurs) truncates
    there with finish "stop"; a stop id ends generation early."""
    port_srv = servers[0]
    full = port_srv.completions({"prompt": "stop me", "max_tokens": 16})
    text = full["choices"][0]["text"]
    ids = port_srv.generate(port_srv._tok.encode("stop me"), max_new_tokens=16)
    # two ASCII characters of the text (a replacement character could
    # match a split multi-byte tail mid-stream)
    stop = next(text[i:i + 2] for i in range(2, len(text) - 1)
                if text[i:i + 2].isascii())
    for req in ({"prompt": "stop me", "max_tokens": 16, "stop": stop},
                {"prompt": "stop me", "max_tokens": 16, "stop": [stop, "zz"]},
                {"prompt": "stop me", "max_tokens": 16,
                 "stop_token_ids": [ids[4]]}):
        port, ref = _both(servers, lambda s: s.completions(req))
        assert _strip(port) == _strip(ref)
        assert port["choices"][0]["finish_reason"] == "stop"
        assert len(port["choices"][0]["text"]) < len(text) or not text
    stream_req = {"prompt": "stop me", "max_tokens": 16, "stop": stop,
                  "stream": True}

    def stream(srv):  # one engine step per chunk, whatever the host's load
        with _one_chunk_per_step(srv):
            return [_strip(c) for c in srv(stream_req)]

    port, ref = _both(servers, stream)
    assert port == ref
    streamed = "".join(c["choices"][0]["text"] for c in port)
    assert streamed == text[:text.find(stop)]
    assert port[-1]["choices"][0]["finish_reason"] == "stop"


@pytest.mark.timeout(240)
def test_chat_completions_equal_jax(servers):
    req = {"messages": _MSGS, "max_tokens": 10}
    port, ref = _both(servers, lambda s: s(req))
    assert _strip(port) == _strip(ref)
    assert port["object"] == "chat.completion"
    msg = port["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    rendered = servers[0]._render_chat(_MSGS)
    assert rendered == "<system>be brief\n<user>hi there\n<assistant>"
    assert port["usage"] == {"prompt_tokens": len(rendered) + 1,
                             "completion_tokens": 10,
                             "total_tokens": len(rendered) + 11}


@contextlib.contextmanager
def _one_chunk_per_step(srv):
    """A stream's chunks are what its engine emitted since the consumer
    last took some: one engine step's tokens when the consumer keeps up,
    several merged when the loop runs ahead (a loaded host).  So while
    this is entered, the server's loop steps its base engine again only
    after the consumer took the last emitting step's tokens: each chunk is
    then one step's, in both packages, whatever the host's load."""
    taken = threading.Event()
    taken.set()
    engine, iter_tokens = srv._engine, srv._iter_tokens

    def step():
        taken.wait(timeout=60)
        emitted = type(engine).step(engine)
        if emitted:
            taken.clear()
        return emitted

    def gated(wkey):
        for chunk in iter_tokens(wkey):
            yield chunk
            taken.set()  # the consumer asks for the next chunk

    engine.step, srv._iter_tokens = step, gated
    try:
        yield
    finally:
        del engine.step, srv._iter_tokens
        taken.set()


@pytest.mark.timeout(240)
def test_streamed_chunks_equal_jax(servers):
    """SSE-shaped chunks for a chat and a two-prompt completion: the same
    chunks as JAX's, and joined they give the non-streamed text."""

    def stream(srv, req):
        with _one_chunk_per_step(srv):
            return [_strip(c) for c in srv(req)]

    for req in ({"messages": _MSGS, "max_tokens": 10, "stream": True},
                {"prompt": ["x", "hello"], "max_tokens": 7, "stream": True}):
        port, ref = _both(servers, lambda s: stream(s, req))
        assert port == ref
        chat = "messages" in req
        assert {c["object"] for c in port} == (
            {"chat.completion.chunk"} if chat else {"text_completion"})
        whole = servers[0]({k: v for k, v in req.items() if k != "stream"})
        for choice in whole["choices"]:
            pieces = [c["choices"][0] for c in port
                      if c["choices"][0]["index"] == choice["index"]]
            text = "".join(p["delta"].get("content", "") if chat else p["text"]
                           for p in pieces)
            want = choice["message"]["content"] if chat else choice["text"]
            # a stream never ends on the replacement character of a split
            # multi-byte tail (both packages)
            assert text == want[:len(want) - want.endswith("\ufffd")]
            assert pieces[-1]["finish_reason"] == choice["finish_reason"]


@pytest.mark.timeout(240)
def test_adapter_model_id_and_listing_equal_jax(servers):
    req = {"model": "tuned", "prompt": "hello", "max_tokens": 10}
    port, ref = _both(servers, lambda s: s.completions(req))
    assert _strip(port) == _strip(ref)
    assert port["model"] == "tuned"
    base = servers[0].completions(dict(req, model="tiny-llama"))
    assert base["choices"][0]["text"] != port["choices"][0]["text"]
    port, ref = _both(servers, lambda s: s({}))
    assert port == ref == servers[0].models()
    assert [m["id"] for m in port["data"]] == ["tiny-llama", "tuned"]
    assert port["data"][1]["parent"] == "tiny-llama"
