"""The port's ``LLMServer`` (``ray_tpu_torch.llm.serve``) against
``ray_tpu.llm.serve.LLMServer`` on the CPU.

- six greedy prompts from six threads at once give each prompt JAX's
  tokens; ``generate_stream``'s chunks joined, ``generate`` and
  ``__call__`` agree;
- a stream closed early gives its slot and blocks back while another
  stream finishes;
- two LoRA adapters (``model=``) give JAX's tokens per adapter; the
  adapter LRU evicts an idle engine and rebuilds it under a new build
  generation; ``SpeculativeConfig.per_adapter`` is honoured per adapter
  with JAX's tokens;
- ``export_stream`` -> ``import_migration`` -> ``resume_stream`` stitches
  to the unmigrated stream; a retried ``mig_id`` returns the memo; a
  handoff of another block size is refused, or recomputed with
  ``allow_recompute``; an export gets the step lock while the loop keeps
  stepping;
- ``utilization``, ``prefix_digest``, ``check_health``, and ``shutdown``
  (the loop joined, waiters raise).

The fp32 micro model is tests/test_torch_kv_handoff.py's; weights come
from ``convert.params_from_jax``/``lora_from_jax``.  Every server is shut
down in a ``finally``; every test running a JAX engine carries a 240 s
watchdog.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import lora as jlora
from ray_tpu.llm import serve as jserve
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SpeculativeConfig as JSpec
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm import serve as tserve
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.llm.engine import make_engine
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

_CFG_KW = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=128, max_seq_len=96)
_ENGINE_KW = dict(max_batch_size=4, max_seq_len=96, block_size=8,
                  prefill_chunk=16, decode_chunk=4, num_blocks=48)


def _jax_adapter(jcfg, seed):
    """A JAX adapter on wq and wv with nonzero B, so it moves the tokens."""
    ad = jlora.init_lora(jcfg, jlora.LoRAConfig(rank=4, alpha=8.0),
                         jax.random.PRNGKey(seed))
    for i, name in enumerate(("wq", "wv")):
        b = ad["layers"][name]["B"]
        ad["layers"][name]["B"] = jax.random.normal(
            jax.random.PRNGKey(100 * seed + i), b.shape) * 0.5
    return ad


@pytest.fixture(scope="module")
def micro():
    """JAX's (cfg, params, adapters, draft cfg, draft params) and the
    port's, adapters "a" and "b" on both sides."""
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.float32)
    jdcfg = jl.LlamaConfig.tiny(**{**_CFG_KW, "n_layers": 1},
                                compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    jdp = jl.init_params(jdcfg, jax.random.PRNGKey(1))
    jads = {"a": _jax_adapter(jcfg, 1), "b": _jax_adapter(jcfg, 2)}
    tcfg = tl.LlamaConfig.tiny(**_CFG_KW)
    tdcfg = tl.LlamaConfig.tiny(**{**_CFG_KW, "n_layers": 1})

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    tp = convert.params_from_jax(np_tree(jp), tcfg, device="cpu")
    tdp = convert.params_from_jax(np_tree(jdp), tdcfg, device="cpu")
    tads = {m: convert.lora_from_jax(np_tree(ad), device="cpu")
            for m, ad in jads.items()}
    return {"jax": (jcfg, jp, jads, jdcfg, jdp),
            "torch": (tcfg, tp, tads, tdcfg, tdp)}


def _server(micro, pkg, spec=None, adapters=True, **kw):
    """An LLMServer of package ``pkg``; ``spec``: the SpeculativeConfig
    fields beside the 1-layer draft."""
    cfg, params, ads, dcfg, dparams = micro[pkg]
    conf, scls, srv = ((JLLMConfig, JSpec, jserve.LLMServer) if pkg == "jax"
                       else (LLMConfig, SpeculativeConfig, tserve.LLMServer))
    sc = None if spec is None else scls(draft_model_config=dcfg, **spec)
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return srv(conf(model_config=cfg, speculative_config=sc,
                    **{**_ENGINE_KW, **kw}), params,
               lora_adapters=ads if adapters else None,
               draft_params=None if spec is None else dparams, **extra)


@pytest.fixture(scope="module")
def servers(micro):
    """(the port's LLMServer, JAX's), adapters "a" and "b" registered."""
    made = []
    try:
        made.append(_server(micro, "torch"))
        made.append(_server(micro, "jax"))
        yield tuple(made)
    finally:
        for s in made:
            s.shutdown()


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 63, n)]


def _in_threads(fn, args):
    """``fn(*a)`` for each ``a`` in ``args``, all threads started at once;
    the results in order."""
    out, errs = [None] * len(args), []

    def run(i):
        try:
            out[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), "a caller never returned"
    assert not errs, errs
    return out


def _wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


@pytest.mark.timeout(240)
def test_concurrent_callers_get_jax_tokens(servers):
    """Six prompts (5-30 tokens: several span more than one prefill
    chunk) from six threads at once on 4 slots: each gets JAX's tokens."""
    prompts = [_prompt(s, n) for s, n in
               zip(range(6), (5, 12, 17, 23, 30, 9))]
    got = {}
    for srv in servers:
        got[type(srv).__module__] = _in_threads(
            lambda p: srv.generate(p, max_new_tokens=12),
            [(p,) for p in prompts])
    port, ref = got["ray_tpu_torch.llm.serve"], got["ray_tpu.llm.serve"]
    assert all(len(t) == 12 for t in port)
    assert port == ref


@pytest.mark.timeout(240)
def test_stream_chunks_generate_and_call_agree_with_jax(servers):
    port, ref = servers
    prompt = _prompt(7, 21)
    chunks = list(port.generate_stream(prompt, max_new_tokens=14))
    assert len(chunks) > 1  # decode_chunk 4: the stream comes in pieces
    joined = [t for c in chunks for t in c]
    assert joined == port.generate(prompt, max_new_tokens=14)
    assert port({"prompt": prompt, "max_new_tokens": 14}) == {"tokens": joined}
    assert joined == ref.generate(prompt, max_new_tokens=14)


@pytest.mark.timeout(240)
def test_closing_a_stream_early_frees_its_blocks(servers):
    """A stream closed after its second chunk: its request is cancelled,
    every block is back in the pool, and a concurrent stream finishes
    with its full tokens."""
    port, ref = servers
    free0 = port.utilization()["kv_blocks"]["free"]
    other = _prompt(9, 13)
    want = ref.generate(other, max_new_tokens=30)
    with_other = []
    t = threading.Thread(target=lambda: with_other.extend(
        port.generate(other, max_new_tokens=30)))
    stream = port.generate_stream(_prompt(8, 19), max_new_tokens=60)
    got = [next(stream), next(stream)]
    t.start()
    stream.close()
    assert 2 <= sum(map(len, got)) < 60
    t.join(120)
    assert with_other == want
    _wait_until(lambda: port.utilization()["slots"]["active"] == 0)
    u = port.utilization()
    assert u["kv_blocks"]["free"] == free0 == u["kv_blocks"]["total"]
    assert not port._waiters and not port._done


@pytest.mark.timeout(240)
def test_adapters_give_jax_tokens_per_adapter(servers):
    port, ref = servers
    assert port.lora_model_ids() == ["a", "b"] == ref.lora_model_ids()
    prompt = _prompt(5, 18)
    base = port.generate(prompt, max_new_tokens=10)
    jobs = [(prompt, m) for m in ("a", "b", None, "a")]
    got = _in_threads(lambda p, m: port.generate(p, max_new_tokens=10,
                                                 model=m), jobs)
    want = [ref.generate(p, max_new_tokens=10, model=m) for p, m in jobs]
    assert got == want
    assert got[2] == base and got[0] == got[3]
    assert got[0] != base and got[1] != base  # the adapters move the tokens
    u = port.utilization()
    assert sorted(u["adapters"]) == ["a", "b"]
    assert u["adapters"]["a"]["engine"] == "paged"
    digest = port.prefix_digest()
    assert sorted(digest["models"]) == ["a", "b"] and digest["qlen"] == 0
    assert digest["block_size"] == 8 and digest["hashes"]


@pytest.mark.timeout(240)
def test_adapter_lru_evicts_idle_engines_and_rebuilds(micro):
    """``_MAX_ADAPTER_ENGINES`` = 1 on the instance: serving "b" evicts
    idle "a"; serving "a" again rebuilds it under build generation 2,
    with the same tokens."""
    srv = _server(micro, "torch")
    srv._MAX_ADAPTER_ENGINES = 1
    try:
        prompt = _prompt(4, 15)
        first = srv.generate(prompt, max_new_tokens=8, model="a")
        assert list(srv._engines) == [None, "a"]
        engine_a = srv._engines["a"]
        srv.generate(prompt, max_new_tokens=8, model="b")
        assert list(srv._engines) == [None, "b"]
        assert srv._engine_order == ["b"]
        assert srv.generate(prompt, max_new_tokens=8, model="a") == first
        assert list(srv._engines) == [None, "a"]
        assert srv._engines["a"] is not engine_a
        assert srv._engine_gen == {None: 0, "a": 2, "b": 1}
    finally:
        srv.shutdown()


@pytest.mark.timeout(240)
def test_per_adapter_speculation_is_honoured_with_jax_tokens(micro):
    """A speculative server (k = 3, the 1-layer draft) whose per_adapter
    gives "a" k = 2 and opts "b" out: each adapter engine is built with
    its own choice, and every model id gives JAX's greedy tokens."""
    spec = dict(num_speculative_tokens=3,
                per_adapter={"a": {"num_speculative_tokens": 2},
                             "b": {"enabled": False}})
    made = []
    try:
        made.append(_server(micro, "torch", spec=spec))
        made.append(_server(micro, "jax", spec=spec))
        port, ref = made
        prompt = _prompt(12, 17)
        for model in (None, "a", "b"):
            assert (port.generate(prompt, max_new_tokens=12, model=model)
                    == ref.generate(prompt, max_new_tokens=12, model=model))
        assert port._engine._spec_k == 3
        assert port._engines["a"]._spec_k == 2
        assert port._engines["b"]._spec is None
        assert port._engines["a"].specdec_stats()["proposed"] > 0
    finally:
        for s in made:
            s.shutdown()


class _slow_steps:
    """Throttle a server's base-engine step, so the test catches a stream
    mid-decode (a micro engine steps in about a millisecond)."""

    def __init__(self, server, delay=0.03):
        self._eng, self._delay = server._engine, delay

    def __enter__(self):
        orig = type(self._eng).step
        eng, delay = self._eng, self._delay

        def slow(decode=True):
            time.sleep(delay)
            return orig(eng, decode)

        eng.step = slow
        return self

    def __exit__(self, *exc):
        del self._eng.step


@pytest.mark.timeout(240)
def test_migration_export_import_resume_stitches_to_the_unmigrated_stream(
        micro):
    """A stream exported mid-decode from one server (its loop frozen by
    holding the engines lock) and imported into another resumes there:
    history + continuation equal the unmigrated stream.  The source's
    slot and blocks are free; a retry under the same mig_id returns the
    first import; a third server at block size 16 refuses the handoff,
    and with ``allow_recompute`` re-prefills prompt + history to the same
    tokens."""
    prompt = _prompt(21, 19)
    want = make_engine(
        LLMConfig(model_config=micro["torch"][0], **_ENGINE_KW),
        micro["torch"][1], device="cpu").generate(
            [prompt], GenerationConfig(max_new_tokens=24))[0]
    made = []
    try:
        src, dst = _server(micro, "torch"), _server(micro, "torch")
        made += [src, dst]
        wide = _server(micro, "torch", block_size=16)
        made.append(wide)
        with _slow_steps(src):
            wkey = src._submit(None, prompt,
                               GenerationConfig(max_new_tokens=24))
            _wait_until(lambda: len(src._waiters.get(wkey, [])) >= 3)
            with src._engines_lock:  # the loop parks at its next turn
                rids = src.migratable_streams()
                assert rids == [wkey[2]]
                h = src.export_stream(rids[0])
        assert 3 <= len(h["emitted"]) < 24
        assert src._waiters[wkey] == h["emitted"]  # reconciled history
        assert src.utilization()["slots"]["active"] == 0
        assert src.migratable_streams() == []
        h["mig_id"] = "m-1"
        r1 = dst.import_migration(dict(h))
        assert r1["mode"] == "import" and not r1["done"]
        assert dst.import_migration(dict(h)) == r1  # the retry: the memo
        cont = [t for c in dst.resume_stream(r1["wkey"]) for t in c]
        assert h["emitted"] + cont == want
        assert wide.import_migration(dict(h, mig_id=None)) is None
        r2 = wide.import_migration(dict(h, mig_id=None), allow_recompute=True)
        assert r2["mode"] == "recompute"
        cont = [t for c in wide.resume_stream(r2["wkey"]) for t in c]
        assert h["emitted"] + cont == want
    finally:
        for s in made:
            s.shutdown()


def test_shutdown_joins_the_loop_and_fails_waiters(micro):
    srv = _server(micro, "torch", adapters=False)
    try:
        assert srv.check_health()
        assert srv.lora_model_ids() == []
        assert "adapters" not in srv.utilization()
        assert len(srv.generate(_prompt(3, 9), max_new_tokens=5)) == 5
    finally:
        srv.shutdown()
    assert not srv._loop.is_alive() and not srv.check_health()
    with pytest.raises(RuntimeError, match="shut down"):
        srv.generate(_prompt(3, 9), max_new_tokens=5)


def test_the_server_runs_on_cuda_unless_asked_for_the_cpu(micro):
    """The default device is CUDA, as ``make_engine``'s: without a GPU the
    constructor raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default would serve on it")
    cfg, params = micro["torch"][:2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.LLMServer(LLMConfig(model_config=cfg, **_ENGINE_KW), params)


@pytest.mark.timeout(240)
def test_export_while_the_loop_steps_takes_its_turn(micro):
    """The loop is not parked: each step holds the step lock for 10 ms
    (``_slow_steps``) and the loop takes it again right after releasing
    it, yet an export from another thread gets its turn mid-decode, and
    the stitched stream equals the unmigrated one."""
    prompt = _prompt(31, 14)
    want = make_engine(
        LLMConfig(model_config=micro["torch"][0], **_ENGINE_KW),
        micro["torch"][1], device="cpu").generate(
            [prompt], GenerationConfig(max_new_tokens=60))[0]
    made = []
    try:
        src, dst = _server(micro, "torch"), _server(micro, "torch")
        made += [src, dst]
        with _slow_steps(src, delay=0.01):
            wkey = src._submit(None, prompt,
                               GenerationConfig(max_new_tokens=60))
            _wait_until(lambda: len(src._waiters.get(wkey, [])) >= 4)
            h = src.export_stream(wkey[2])
        assert 4 <= len(h["emitted"]) < 40
        res = dst.import_migration(h)
        cont = [t for c in dst.resume_stream(res["wkey"]) for t in c]
        assert h["emitted"] + cont == want
    finally:
        for s in made:
            s.shutdown()
