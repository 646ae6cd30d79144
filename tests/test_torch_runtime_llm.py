"""The port's ``LLMServer`` served from an actor of the port's runtime, on
the CPU, against the JAX package's ``LLMServer`` in process.

An actor hosts ``LLMServer`` over ``LlamaConfig.tiny()`` with weights from
``convert.params_from_jax`` (sent to the actor through the object store as
CPU tensors); its greedy tokens for prompts sent one at a time and from
three threads at once equal JAX's, and its ``generate_stream`` chunks,
through the runtime's streaming returns, join to the same tokens.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.llm import serve as jserve
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.models import llama as tl

_ENGINE_KW = dict(max_batch_size=4, max_seq_len=128, block_size=8,
                  prefill_chunk=16, decode_chunk=4, num_blocks=64)
_NEW = 12


@rt.remote(max_concurrency=4)
class _Hosted:
    """An LLMServer inside an actor (the shape of a serve replica)."""

    def __init__(self, llm_config, params):
        from ray_tpu_torch.llm.serve import LLMServer

        torch.set_num_threads(1)  # tiny shapes; the lane runs six workers
        self.srv = LLMServer(llm_config, params, device="cpu")

    def generate(self, prompt, max_new_tokens):
        return self.srv.generate(prompt, max_new_tokens=max_new_tokens)

    def generate_stream(self, prompt, max_new_tokens):
        yield from self.srv.generate_stream(prompt,
                                            max_new_tokens=max_new_tokens)

    def shutdown(self):
        self.srv.shutdown()


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 255, n)]


@pytest.fixture(scope="module")
def hosted():
    """(the actor, JAX's LLMServer) over the same weights."""
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                 tl.LlamaConfig.tiny(), device="cpu")
    ref = jserve.LLMServer(JLLMConfig(model_config=jcfg, **_ENGINE_KW), jp)
    rt.init(num_cpus=2)
    try:
        actor = _Hosted.remote(
            LLMConfig(model_config=tl.LlamaConfig.tiny(), **_ENGINE_KW), tp)
        yield actor, ref
        rt.get(actor.shutdown.remote(), timeout=60)
    finally:
        rt.shutdown()
        ref.shutdown()


@pytest.mark.timeout(240)
def test_actor_greedy_tokens_equal_jax(hosted):
    actor, ref = hosted
    prompts = [_prompt(s, n) for s, n in zip(range(4), (5, 17, 30, 9))]
    one_by_one = [rt.get(actor.generate.remote(p, _NEW), timeout=120)
                  for p in prompts[:2]]
    together = [None] * 3

    def call(i):
        together[i] = rt.get(actor.generate.remote(prompts[1 + i], _NEW),
                             timeout=120)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
    assert not any(t.is_alive() for t in threads)
    want = [ref.generate(p, max_new_tokens=_NEW) for p in prompts]
    assert all(len(w) == _NEW for w in want)
    assert one_by_one == want[:2]
    assert together == want[1:]


@pytest.mark.timeout(240)
def test_actor_stream_joins_to_jax_tokens(hosted):
    actor, ref = hosted
    prompt = _prompt(7, 21)
    gen = actor.generate_stream.options(num_returns="streaming").remote(
        prompt, _NEW)
    chunks = [rt.get(r, timeout=120) for r in gen]
    assert len(chunks) > 1  # decode_chunk 4: the stream comes in pieces
    assert [t for c in chunks for t in c] == ref.generate(
        prompt, max_new_tokens=_NEW)
