"""The port's disaggregated stages (``ray_tpu_torch.llm.disagg``) against
``ray_tpu.llm.disagg`` on the CPU.

- ``PrefillServer`` -> ``DecodeServer`` gives the monolithic
  ``LLMServer``'s greedy tokens, and JAX's, for prompts from several
  threads, streamed or not; the prefill stage keeps the prompt's chain and
  drops speculation;
- a handoff of another block size, and one with no KV, fall back to
  recompute (JAX's ``test_mismatched_stage_configs_fall_back_to_recompute``
  and ``test_disagg_recompute_fallback_zero_drop``); the first token is
  prepended before a token the loop raced in;
- a speculative ``DecodeServer`` seeds its draft from the handoff
  (acceptance of the target as its own draft);
- across the packages, at fp32 and bf16: a port ``PrefillServer`` feeds a
  JAX ``DecodeServer`` and a JAX ``PrefillServer`` a port
  ``DecodeServer``, each giving the destination package's monolithic
  tokens;
- a handoff through a ``CudaTensorChannel`` (``handoff_channel=``, the
  prefill stage in an actor of the port's runtime: the channel's host
  leaves ride the store actor between two processes) gives the object
  transport's tokens, the monolithic server's and the JAX package's
  disaggregated stages'; an int8 channel carries the codec's wire bytes
  and keeps the greedy tokens; a lost channel recomputes and is counted.

The fp32 micro model is tests/test_torch_kv_handoff.py's.  Every server
is shut down in a ``finally``; every test running a JAX engine carries a
240 s watchdog.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import disagg as jdisagg
from ray_tpu.llm import serve as jserve
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SpeculativeConfig as JSpec
from ray_tpu.models import llama as jl
import ray_tpu_torch as rt
from ray_tpu_torch import convert
from ray_tpu_torch.experimental.channel import CudaTensorChannel
from ray_tpu_torch.llm import disagg as tdisagg
from ray_tpu_torch.llm import serve as tserve
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

_CFG_KW = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=128, max_seq_len=96)
_ENGINE_KW = dict(max_batch_size=4, max_seq_len=96, block_size=8,
                  prefill_chunk=16, decode_chunk=4, num_blocks=48)
_PKG = {"jax": (JLLMConfig, JSpec, jserve.LLMServer, jdisagg),
        "torch": (LLMConfig, SpeculativeConfig, tserve.LLMServer, tdisagg)}


def _weights(dtype):
    """{pkg: (cfg, params)} at ``dtype`` ("fp32" or "bf16": the JAX
    params cast to bf16, the port's converted from them)."""
    bf16 = dtype == "bf16"
    jcfg = jl.LlamaConfig.tiny(
        **_CFG_KW, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    if bf16:
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tcfg = tl.LlamaConfig.tiny(
        **_CFG_KW, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return {"jax": (jcfg, jp), "torch": (tcfg, tp)}


@pytest.fixture(scope="module")
def fp32():
    return _weights("fp32")


@pytest.fixture(scope="module")
def bf16():
    return _weights("bf16")


def _conf(weights, pkg, spec_k=None, **kw):
    conf, scls, _, _ = _PKG[pkg]
    cfg = weights[pkg][0]
    sc = (None if spec_k is None
          else scls(draft_model_config=cfg, num_speculative_tokens=spec_k))
    return conf(model_config=cfg, speculative_config=sc,
                **{**_ENGINE_KW, **kw})


def _extra(pkg):
    return {} if pkg == "jax" else {"device": "cpu"}


def _prefill_server(weights, pkg, **kw):
    return _PKG[pkg][3].PrefillServer(_conf(weights, pkg, **kw),
                                      weights[pkg][1], **_extra(pkg))


def _decode_server(weights, pkg, spec_k=None, **kw):
    dparams = None if spec_k is None else weights[pkg][1]
    return _PKG[pkg][3].DecodeServer(
        _conf(weights, pkg, spec_k=spec_k, **kw), weights[pkg][1],
        draft_params=dparams, **_extra(pkg))


def _monolithic(weights, pkg, prompts, max_new_tokens):
    srv = _PKG[pkg][2](_conf(weights, pkg), weights[pkg][1], **_extra(pkg))
    try:
        return [srv.generate(p, max_new_tokens=max_new_tokens)
                for p in prompts]
    finally:
        srv.shutdown()


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 63, n)]


def _disagg(pre, dec, prompts, max_new_tokens, stream=False):
    """Each prompt through ``pre.prefill`` then ``dec``, one thread per
    prompt, all at once."""
    out, errs = [None] * len(prompts), []

    def run(i):
        try:
            h = pre.prefill(prompts[i], max_new_tokens=max_new_tokens)
            if stream:
                out[i] = [t for c in dec.decode_stream_from_handoff(
                    h, max_new_tokens=max_new_tokens) for t in c]
            else:
                out[i] = dec.decode_from_handoff(
                    h, max_new_tokens=max_new_tokens)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    return out


@pytest.mark.timeout(240)
def test_prefill_to_decode_gives_the_monolithic_tokens(fp32):
    prompts = [_prompt(s, n) for s, n in zip(range(5), (7, 21, 33, 16, 40))]
    want = _monolithic(fp32, "torch", prompts, 10)
    assert want == _monolithic(fp32, "jax", prompts, 10)
    pre = _prefill_server(fp32, "torch")
    dec = _decode_server(fp32, "torch")
    try:
        assert _disagg(pre, dec, prompts, 10) == want
        assert _disagg(pre, dec, prompts[:2], 10, stream=True) == want[:2]
        assert pre.queue_depth() == 0
        d = pre.prefix_digest()
        assert d["block_size"] == 8 and len(d["hashes"]) >= 10
        assert d["qlen"] == 0 and d["models"] == []
        assert pre.utilization()["slots"]["active"] == 0
        assert pre.check_health() and dec.check_health()
    finally:
        dec.shutdown()


def test_prefill_server_refuses_a_static_cache_and_drops_speculation(fp32):
    with pytest.raises(ValueError, match="paged"):
        _prefill_server(fp32, "torch", kv_cache="static")
    pre = _prefill_server(fp32, "torch", spec_k=2)
    assert pre._engine._spec is None and pre._config.speculative_config is None


@pytest.mark.timeout(240)
def test_mismatched_block_size_and_no_kv_fall_back_to_recompute(fp32):
    prompt = _prompt(21, 21)
    want = _monolithic(fp32, "torch", [prompt], 5)[0]
    pre = _prefill_server(fp32, "torch")  # block size 8
    dec = _decode_server(fp32, "torch", block_size=16)
    try:
        h = pre.prefill(prompt, max_new_tokens=5)
        assert h["k"] is not None and h["block_size"] == 8
        assert dec.decode_from_handoff(h, max_new_tokens=5) == want
        with dec._engine._lock:
            assert dec._engine.prefill_tokens == len(prompt)  # recomputed
        degraded = {"prompt": prompt, "first_token": None, "k": None,
                    "v": None, "block_size": 8}
        assert dec.decode_from_handoff(degraded, max_new_tokens=5) == want
    finally:
        dec.shutdown()


@pytest.mark.timeout(240)
def test_first_token_is_prepended_before_a_raced_loop_token(fp32):
    pre = _prefill_server(fp32, "torch")
    dec = _decode_server(fp32, "torch")
    try:
        h = pre.prefill(_prompt(11, 21), max_new_tokens=4)
        wkey_next = (None, 0, dec._engine._req_counter + 1)
        with dec._cv:
            dec._waiters[wkey_next] = [999]
        wkey = dec._import_handoff(h, GenerationConfig(max_new_tokens=4))
        assert wkey == wkey_next
        assert dec._wait_done(wkey)[:2] == [h["first_token"], 999]
    finally:
        dec.shutdown()


@pytest.mark.timeout(240)
def test_speculative_decode_server_seeds_its_draft(fp32):
    """k = 3 with the target as its own draft: the import re-seeds the
    draft over the prompt, so the greedy tokens are the monolithic ones
    and most drafts are accepted."""
    prompt = _prompt(33, 21)
    want = _monolithic(fp32, "torch", [prompt], 8)[0]
    pre = _prefill_server(fp32, "torch", spec_k=3)
    dec = _decode_server(fp32, "torch", spec_k=3)
    try:
        h = pre.prefill(prompt, max_new_tokens=8)
        assert dec.decode_from_handoff(h, max_new_tokens=8) == want
        stats = dec._engine.specdec_stats()
        assert stats["proposed"] > 0 and stats["acceptance_rate"] > 0.5, stats
    finally:
        dec.shutdown()


@pytest.mark.timeout(240)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_handoff_across_packages(fp32, bf16, dtype, direction):
    """One package's PrefillServer feeds the other's DecodeServer: the
    destination's monolithic tokens, at fp32 and at bf16 (a numpy
    ``ml_dtypes.bfloat16`` payload both ways)."""
    weights = fp32 if dtype == "fp32" else bf16
    src, dst = direction.split("_to_")
    prompts = [_prompt(s, n) for s, n in zip((41, 42), (19, 30))]
    want = _monolithic(weights, dst, prompts, 8)
    pre = _prefill_server(weights, src)
    dec = _decode_server(weights, dst)
    try:
        h = pre.prefill(prompts[0], max_new_tokens=8)
        assert isinstance(h["k"], np.ndarray)
        assert h["k"].dtype.name == ("bfloat16" if dtype == "bf16"
                                     else "float32")
        assert _disagg(pre, dec, prompts, 8) == want
    finally:
        dec.shutdown()


@pytest.fixture(scope="module")
def remote_prefill(fp32):
    """A port ``PrefillServer`` in an actor (a channel's two ends are two
    processes), on the port's runtime."""
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    rt.init(num_cpus=2)
    try:
        cls = rt.remote(tdisagg.PrefillServer).options(num_cpus=0)
        yield cls.remote(_conf(fp32, "torch"), fp32["torch"][1],
                         device="cpu")
    finally:
        rt.shutdown()
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads


def _via_channel(pre, dec, prompt, max_new_tokens, lose=False, **kw):
    """One prompt: prefill in the actor with a fresh channel, decode here;
    returns (tokens, the channel's wire bytes as the reader saw them)."""
    chan = CudaTensorChannel(f"kvh-test-{prompt[0]}-{len(prompt)}", **kw)
    try:
        h = rt.get(pre.prefill.remote(prompt, max_new_tokens=max_new_tokens,
                                      handoff_channel=chan), timeout=120)
        assert h["via_channel"] and "k" not in h and "v" not in h
        h["channel"] = chan
        if lose:  # its shared memory gone before the decode stage reads
            chan.destroy()
        toks = dec.decode_from_handoff(h, max_new_tokens=max_new_tokens)
        return toks, chan.last_read_nbytes
    finally:
        if not lose:
            chan.destroy()


@pytest.mark.timeout(240)
def test_channel_handoff_gives_the_object_and_monolithic_tokens(
        fp32, remote_prefill):
    prompts = [_prompt(s, n) for s, n in zip((61, 62, 63), (9, 24, 37))]
    want = _monolithic(fp32, "torch", prompts, 10)
    jpre = _prefill_server(fp32, "jax")
    jdec = _decode_server(fp32, "jax")
    try:
        assert _disagg(jpre, jdec, prompts, 10) == want
    finally:
        jdec.shutdown()
    pre = _prefill_server(fp32, "torch")
    dec = _decode_server(fp32, "torch")
    try:
        assert _disagg(pre, dec, prompts, 10) == want
        for p, w in zip(prompts, want):
            toks, nbytes = _via_channel(remote_prefill, dec, p, 10)
            assert toks == w
            # k and v, [L, nb, bs, kv*hd] fp32, over the live blocks
            nb = -(-len(p) // 8)
            assert nbytes == 2 * 2 * nb * 8 * 64 * 4
        assert dec.recomputes == 0
    finally:
        dec.shutdown()


@pytest.mark.timeout(240)
def test_int8_channel_handoff_sends_codes_and_scales(fp32, remote_prefill):
    prompts = [_prompt(s, n) for s, n in zip((71, 72), (30, 44))]
    want = _monolithic(fp32, "torch", prompts, 8)
    dec = _decode_server(fp32, "torch")
    try:
        for p, w in zip(prompts, want):
            toks, nbytes = _via_channel(
                remote_prefill, dec, p, 8,
                compression={"scheme": "int8", "min_bytes": 1024})
            assert toks == w
            nb = -(-len(p) // 8)
            n = 2 * nb * 8 * 64  # one of k, v: fp32 elements
            # int8 codes + fp32 scales per 256-element block, k and v
            assert nbytes == 2 * (n + 4 * (-(-n // 256)))
        assert dec.recomputes == 0
    finally:
        dec.shutdown()


@pytest.mark.timeout(240)
def test_a_lost_channel_recomputes_and_is_counted(fp32, remote_prefill):
    prompt = _prompt(81, 26)
    want = _monolithic(fp32, "torch", [prompt], 8)[0]
    dec = _decode_server(fp32, "torch")
    try:
        toks, _ = _via_channel(remote_prefill, dec, prompt, 8, lose=True)
        assert toks == want
        assert dec.recomputes == 1
    finally:
        dec.shutdown()


class _Stage:
    """A stand-in for a stage's serve handle: ``<method>.remote(...)``
    answers at once (the prefill stage with a handoff that carries no KV,
    the decode stage with three tokens)."""

    class _Call:
        def __init__(self, value):
            self._value = value

        def result(self, timeout_s=None):
            return self._value

    class _Method:
        def __init__(self, fn):
            self._fn = fn

        def remote(self, *a, **kw):
            return _Stage._Call(self._fn(*a, **kw))

    def __init__(self):
        self.prefill = self._Method(
            lambda prompt, handoff_channel=None, **kw: {
                "prompt": list(prompt), "first_token": None, "k": None,
                "v": None})
        self.decode_from_handoff = self._Method(lambda h, **kw: [1, 2, 3])


def _recording(server):
    """The names of the shared-memory segments of each channel ``server``
    makes (other tests' channels may come and go meanwhile)."""
    names, make = [], server._make_channel

    def made():
        chan = make()
        names.extend(c.name for c in (chan._meta, getattr(chan, "_ack", None))
                     if c is not None)
        return chan

    server._make_channel = made
    return names


def _alive(names):
    return [n for n in names if os.path.exists(os.path.join("/dev/shm", n))]


def test_the_ingress_unlinks_each_request_channel():
    """ROADMAP C9: the JAX package's ingress makes a channel (a shared
    memory segment) per request and never unlinks it, so a running
    ingress leaks one segment a request; the port's unlinks its channels'
    segments when the request ends."""
    stage = _Stage()
    port = tdisagg.DisaggLLMServer(None, stage, stage, transport="channel")
    ours = _recording(port)
    ref = jdisagg.DisaggLLMServer(None, stage, stage, transport="channel")
    theirs = _recording(ref)
    for i in range(3):
        assert port.generate(_prompt(90 + i, 5), max_new_tokens=3) == [1, 2, 3]
        assert ref.generate(_prompt(90 + i, 5), max_new_tokens=3) == [1, 2, 3]
    leaked = _alive(theirs)
    try:
        assert len(ours) == 6 and _alive(ours) == []
        assert len(theirs) == 3 and len(leaked) == 3
    finally:
        for name in leaked:
            os.unlink(os.path.join("/dev/shm", name))
