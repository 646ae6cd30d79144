"""The port's deployment builders, run by ``serve.run`` on the port's
runtime on the CPU, against the JAX package's serving classes in process.

One set of weights (``LlamaConfig.tiny()``'s shape at the byte tokenizer's
vocabulary, fp32, from ``convert.params_from_jax``) serves three apps of
one module cluster, each through the handle and through the HTTP proxy:

- ``build_llm_deployment``: greedy tokens equal JAX's ``LLMServer``'s
  (JAX's ``OpenAICompatServer`` is one), a stream joins to them, and so do
  an HTTP request's and an SSE request's;
- ``build_openai_app``: completion and chat responses equal JAX's but
  ``id`` and ``created``; a streamed chat joins to the chat's text;
- ``build_disagg_llm_deployment`` (prefill, decode and ingress replicas),
  with the object transport and with ``transport="channel"`` (the KV
  through a ``CudaTensorChannel`` per request; host tensors here, so
  through the store actor): the same greedy tokens (the counterpart of
  the JAX package's ``test_disagg_channel_transport_cluster``).
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.llm import openai_api as jopenai
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert, serve
from ray_tpu_torch.llm import (
    DisaggLLMServer,
    LLMConfig,
    build_disagg_llm_deployment,
    build_llm_deployment,
    build_openai_app,
)
from ray_tpu_torch.models import llama as tl

pytestmark = pytest.mark.timeout(240)

_CFG_KW = dict(vocab_size=264, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=128, max_seq_len=128)
_ENGINE_KW = dict(max_batch_size=4, max_seq_len=128, block_size=8,
                  prefill_chunk=32, decode_chunk=4, num_blocks=64)
_MSGS = [{"role": "system", "content": "be brief"},
         {"role": "user", "content": "hi there"}]
_NEW = 12


@pytest.fixture(scope="module")
def apps():
    """(JAX's OpenAICompatServer, {app: handle}, the proxy's address)."""
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(5))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                 tl.LlamaConfig.tiny(**_CFG_KW), device="cpu")
    conf = LLMConfig(model_config=tl.LlamaConfig.tiny(**_CFG_KW),
                     **_ENGINE_KW)
    ref = jopenai.OpenAICompatServer(
        JLLMConfig(model_config=jcfg, **_ENGINE_KW), jp, model_id="tiny")
    # one torch thread in each replica at these shapes (the lane runs six
    # workers); replicas inherit the variable from this process
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    rt.init(num_cpus=4)
    try:
        handles = {
            "llm": serve.run(build_llm_deployment(conf, tp, device="cpu"),
                             name="llm", route_prefix="/llm"),
            "openai": serve.run(
                build_openai_app(conf, tp, model_id="tiny", device="cpu"),
                name="openai", route_prefix="/v1"),
            "disagg": serve.run(
                build_disagg_llm_deployment(conf, tp, name="pd",
                                            device="cpu"),
                name="disagg", route_prefix="/pd"),
            "disagg_channel": serve.run(
                build_disagg_llm_deployment(conf, tp, name="pdc",
                                            transport="channel",
                                            device="cpu"),
                name="disagg_channel", route_prefix="/pdc"),
        }
        yield ref, handles, serve.start_http_proxy(port=0)
    finally:
        serve.shutdown()
        rt.shutdown()
        ref.shutdown()
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 255, n)]


def _post(proxy, path, payload, raw=False):
    host, port = proxy
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = resp.read()
    return body if raw else json.loads(body)


def _sse(body: bytes):
    """The JSON items of an SSE body, up to ``[DONE]``."""
    frames = [f[len(b"data: "):] for f in body.split(b"\n\n")
              if f.startswith(b"data: ")]
    assert frames[-1] == b"[DONE]", body[-200:]
    return [json.loads(f) for f in frames[:-1]]


def _strip(resp):
    assert resp["id"].startswith(("cmpl-", "chatcmpl-"))
    assert isinstance(resp["created"], int)
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


@pytest.mark.parametrize("app", ["llm", "disagg", "disagg_channel"])
def test_greedy_tokens_equal_jax(apps, app):
    ref, handles, _ = apps
    h = handles[app]
    prompts = [_prompt(s, n) for s, n in ((1, 5), (2, 17), (3, 30))]
    want = [ref.generate(p, max_new_tokens=_NEW) for p in prompts]
    assert all(len(w) == _NEW for w in want)
    got = [h.generate.remote(p, max_new_tokens=_NEW).result(timeout_s=120)
           for p in prompts]
    assert got == want
    together = [h.generate.remote(p, max_new_tokens=_NEW) for p in prompts]
    assert [r.result(timeout_s=120) for r in together] == want
    chunks = list(h.options(stream=True).generate_stream.remote(
        prompts[1], max_new_tokens=_NEW))
    assert len(chunks) > 1 and sum(chunks, []) == want[1]


@pytest.mark.parametrize("path", ["/llm", "/pd", "/pdc"])
def test_http_tokens_equal_jax(apps, path):
    ref, _, proxy = apps
    prompt = _prompt(4, 21)
    want = ref.generate(prompt, max_new_tokens=_NEW)
    req = {"prompt": prompt, "max_new_tokens": _NEW}
    assert _post(proxy, path, req) == {"tokens": want}
    items = _sse(_post(proxy, path, {**req, "stream": True}, raw=True))
    assert sum((i["tokens"] for i in items), []) == want


@pytest.mark.parametrize("req", [
    {"model": "tiny", "prompt": "hello", "max_tokens": 10},
    {"prompt": ["a", "bb"], "max_tokens": 6},
    {"messages": _MSGS, "max_tokens": 10},
])
def test_openai_app_equals_jax(apps, req):
    ref, handles, proxy = apps
    want = _strip(ref(req))
    assert _strip(handles["openai"].remote(req).result(timeout_s=120)) == want
    assert _strip(_post(proxy, "/v1", req)) == want


def _joined(chunks):
    return "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)


def test_openai_app_streamed_chat_joins(apps):
    """Joined, the SSE chunks give JAX's streamed text (a multi-byte
    character split at the budget's end is withheld in both)."""
    ref, _, proxy = apps
    req = {"messages": _MSGS, "max_tokens": 10, "stream": True}
    items = _sse(_post(proxy, "/v1", req, raw=True))
    assert all(i["object"] == "chat.completion.chunk" for i in items)
    assert _joined(items) == _joined(list(ref(req)))
    assert items[-1]["choices"][0]["finish_reason"] == "length"


def test_channel_transport_names_a10():
    """The channel transport (ROADMAP A10, which has landed) is taken by
    the builder and the ingress, with its compression; any other
    transport is refused."""
    conf = LLMConfig(model_config=tl.LlamaConfig.tiny(**_CFG_KW))
    app = build_disagg_llm_deployment(conf, transport="channel",
                                      handoff_compression="int8",
                                      device="cpu")
    assert app.init_kwargs == {"transport": "channel",
                               "handoff_compression": "int8"}
    srv = DisaggLLMServer(conf, None, None, transport="channel")
    chan = srv._make_channel()
    try:
        assert chan.backend == "auto" and chan._compression is None
    finally:
        chan.destroy()
    with pytest.raises(ValueError):
        DisaggLLMServer(conf, None, None, transport="nccl")
