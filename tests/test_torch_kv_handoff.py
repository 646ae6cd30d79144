"""Export and import of live requests, the port's against
``ray_tpu.llm.paged``'s, and across the two packages.

- ``export_request`` gives JAX's payload on the same request: the same
  keys, prompt, first token, block size, history and ``gen``, k/v within
  1e-5 (fp32 programs of two frameworks);
- a mid-decode export -> import continues bit-equal to the uninterrupted
  run (tests/test_kv_migration.py's engine contract), and the errors of a
  bad export or import are JAX's;
- handoff across packages, both ways, after prefill (disaggregated
  serving) and mid-decode (migration): the continuation equals the source
  package's uninterrupted greedy run; at bf16 a JAX payload (ml_dtypes'
  bfloat16) enters the port's pool bit for bit;
- an import into a speculative engine re-seeds the draft over prompt +
  history: tokens and acceptance counts equal JAX's, and a draft pool too
  small for the re-seed degrades the request to plain decode.

The fp32 micro model is tests/test_kv_migration.py's.  Every test that
runs a JAX engine carries a 240 s watchdog.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import paged as jpaged
from ray_tpu.llm.config import GenerationConfig as JGen
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SpeculativeConfig as JSpec
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm import paged as tpaged
from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig, SpeculativeConfig
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

_CFG_KW = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=128, max_seq_len=96)
_ENGINE_KW = dict(max_batch_size=4, max_seq_len=96, block_size=8,
                  prefill_chunk=16, decode_chunk=4)


@pytest.fixture(scope="module")
def micro():
    """(jax cfg, params, jax 1-layer draft cfg, params) and the port's."""
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.float32)
    jdcfg = jl.LlamaConfig.tiny(**{**_CFG_KW, "n_layers": 1},
                                compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    jdp = jl.init_params(jdcfg, jax.random.PRNGKey(1))
    tcfg = tl.LlamaConfig.tiny(**_CFG_KW)
    tdcfg = tl.LlamaConfig.tiny(**{**_CFG_KW, "n_layers": 1})
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    tdp = convert.params_from_jax(jax.tree.map(np.asarray, jdp), tdcfg,
                                  device="cpu")
    return {"jax": (jcfg, jp, jdcfg, jdp), "torch": (tcfg, tp, tdcfg, tdp)}


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 63, n)]


def _engine(micro, pkg, spec=None, **kw):
    """A paged engine of package ``pkg``; ``spec``: (k, draft blocks)."""
    cfg, params, dcfg, dparams = micro[pkg]
    conf, scls, ecls = ((JLLMConfig, JSpec, jpaged.PagedJaxLLMEngine)
                        if pkg == "jax" else
                        (LLMConfig, SpeculativeConfig,
                         tpaged.PagedTorchLLMEngine))
    sc = None if spec is None else scls(
        draft_model_config=dcfg, num_speculative_tokens=spec[0],
        draft_num_blocks=spec[1])
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return ecls(conf(model_config=cfg, speculative_config=sc,
                     **{**_ENGINE_KW, **kw}), params=params,
                draft_params=None if spec is None else dparams, **extra)


def _gen(pkg, **kw):
    return (JGen if pkg == "jax" else GenerationConfig)(**kw)


def _decode_until(eng, rid, n):
    """Step until request ``rid`` has emitted at least ``n`` tokens."""
    out = []
    while len(out) < n:
        out.extend(eng.step().get(rid, []))
    return out


def _finish(eng, rid, toks):
    while eng.has_work():
        toks.extend(eng.step().get(rid, []))
    toks.extend(eng.flush().get(rid, []))
    return toks


def _import(eng, h, pkg, resume=True):
    return eng.import_request(h["prompt"], h["first_token"], h["k"], h["v"],
                              _gen(pkg, **h["gen"]),
                              emitted=h["emitted"] if resume else None)


@pytest.mark.timeout(240)
def test_export_payload_equals_jax(micro):
    prompt = _prompt(11, 21)
    hs = {}
    for pkg in ("jax", "torch"):
        eng = _engine(micro, pkg)
        rid = eng.add_request(prompt, _gen(pkg, max_new_tokens=12, top_k=5,
                                           stop_token_ids=(3,)))
        _decode_until(eng, rid, 5)
        hs[pkg] = eng.export_request(rid)
        with eng._lock:
            assert rid not in eng._requests
            assert all(r is None for r in eng._slot_req)
        assert eng.blocks.num_free() == eng.num_blocks - 1
    j, t = hs["jax"], hs["torch"]
    assert sorted(t) == sorted(j)
    for key in ("prompt", "first_token", "block_size", "emitted", "gen"):
        assert t[key] == j[key], key
    live = len(prompt) + len(t["emitted"]) - 1
    assert t["k"].shape == j["k"].shape == (2, -(-live // 8), 8, 64)
    assert isinstance(t["k"], np.ndarray) and t["k"].dtype == np.float32
    for name in ("k", "v"):
        np.testing.assert_allclose(t[name], np.asarray(j[name]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.timeout(240)
def test_middecode_export_import_bit_equal(micro):
    """The port's engine contract of tests/test_kv_migration.py:175: the
    export frees the source's slot and blocks, covers exactly the live
    blocks, and the import resumes at the exact position without emitting
    the history again; the stitched stream is the uninterrupted one (and
    JAX's)."""
    prompt = _prompt(11, 21)
    want = _engine(micro, "torch").generate(
        [prompt], GenerationConfig(max_new_tokens=12))[0]
    assert want == _engine(micro, "jax").generate(
        [prompt], JGen(max_new_tokens=12))[0]
    src = _engine(micro, "torch")
    rid = src.add_request(prompt, GenerationConfig(max_new_tokens=12))
    emitted = _decode_until(src, rid, 5)
    h = src.export_request(rid)
    assert h["emitted"][:len(emitted)] == emitted
    dst = _engine(micro, "torch")
    res = _import(dst, h, "torch")
    assert res is not None and res["emitted"] == [] and not res["done"]
    # the imported KV is the payload, block for block
    req = dst._requests[res["request_id"]]
    for name in ("k", "v"):
        assert torch.equal(dst.pool[name][:, req.blocks],
                           torch.from_numpy(h[name]))
    toks = _finish(dst, res["request_id"], list(h["emitted"]))
    assert toks == want
    assert not any(dst.blocks.ref)


def _raises_same(fn_j, fn_t, exc):
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("fault", ["short_cover", "empty_prompt",
                                   "empty_history", "past_max_seq"])
def test_import_validation_errors_equal_jax(micro, fault):
    """tests/test_kv_migration.py:222's refusal of a handoff whose KV does
    not cover the live positions, and the other refusals, with JAX's
    messages."""
    prompt = _prompt(12, 17)
    hs = {}
    for pkg in ("jax", "torch"):
        eng = _engine(micro, pkg)
        rid = eng.add_request(prompt, _gen(pkg, max_new_tokens=16))
        _decode_until(eng, rid, 4)
        hs[pkg] = eng.export_request(rid)

    def call(pkg):
        h = dict(hs[pkg])
        eng = _engine(micro, pkg)
        gen = _gen(pkg, max_new_tokens=16)
        emitted = h["emitted"]
        if fault == "short_cover":
            h["k"], h["v"] = h["k"][:, :1], h["v"][:, :1]
        elif fault == "empty_prompt":
            h["prompt"] = []
        elif fault == "empty_history":
            emitted = []
        else:
            gen = _gen(pkg, max_new_tokens=96)
        return lambda: eng.import_request(h["prompt"], h["first_token"],
                                          h["k"], h["v"], gen,
                                          emitted=emitted)

    _raises_same(call("jax"), call("torch"), ValueError)


@pytest.mark.timeout(240)
def test_export_errors_equal_jax(micro):
    """Unknown or finished requests raise KeyError, a request mid-prefill
    RuntimeError, with JAX's messages."""
    engines = {pkg: _engine(micro, pkg) for pkg in ("jax", "torch")}
    _raises_same(lambda: engines["jax"].export_request(99),
                 lambda: engines["torch"].export_request(99), KeyError)
    long_prompt = _prompt(13, 70)
    rids = {}
    for pkg, eng in engines.items():
        rids[pkg] = eng.add_request(long_prompt, _gen(pkg, max_new_tokens=4))
        eng.step(decode=False)  # one 16-token chunk of 70
    _raises_same(lambda: engines["jax"].export_request(rids["jax"]),
                 lambda: engines["torch"].export_request(rids["torch"]),
                 RuntimeError)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("mode", ["after_prefill", "mid_decode"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_package_handoff(micro, direction, mode):
    """Export from one package, import into the other: the continuation
    equals the source package's uninterrupted greedy run.  After prefill
    the payload's first token is emitted by the importer (disaggregated
    serving); mid-decode the history is not (migration)."""
    src_pkg, dst_pkg = direction.split("_to_")
    prompt = _prompt(21, 19)
    want = _engine(micro, src_pkg).generate(
        [prompt], _gen(src_pkg, max_new_tokens=14))[0]
    src = _engine(micro, src_pkg)
    rid = src.add_request(prompt, _gen(src_pkg, max_new_tokens=14))
    if mode == "after_prefill":
        while True:  # tests/test_llm_disagg.py's _drive_prefill
            src.step(decode=False)
            with src._lock:
                req = src._requests[rid]
                if req.prefill_pos >= len(prompt) and req.out_tokens:
                    break
    else:
        _decode_until(src, rid, 6)
    h = src.export_request(rid)
    if mode == "after_prefill":
        assert h["emitted"] == [want[0]]
    dst = _engine(micro, dst_pkg)
    res = _import(dst, h, dst_pkg, resume=mode == "mid_decode")
    assert res is not None
    toks = list(h["emitted"]) if mode == "mid_decode" else list(res["emitted"])
    assert _finish(dst, res["request_id"], toks) == want


@pytest.mark.timeout(240)
def test_bf16_handoff_takes_jax_payload_bits(micro):
    """A bf16 pool exports CPU bf16 tensors (numpy has no bf16); the port
    imports JAX's ml_dtypes bfloat16 arrays by their bits and its own
    tensors unchanged."""
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.bfloat16)
    tcfg = tl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=torch.bfloat16)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), micro["jax"][1])
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    prompt = _prompt(31, 20)
    je = jpaged.PagedJaxLLMEngine(JLLMConfig(model_config=jcfg, **_ENGINE_KW),
                                  params=jp)
    rid = je.add_request(prompt, JGen(max_new_tokens=32))
    _decode_until(je, rid, 3)
    h = je.export_request(rid)
    assert h["k"].dtype.name == "bfloat16"
    te = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **_ENGINE_KW),
                                    params=tp, device="cpu")
    assert te.pool["k"].dtype == torch.bfloat16
    res = _import(te, h, "torch")
    req = te._requests[res["request_id"]]
    for name in ("k", "v"):
        bits = torch.from_numpy(np.array(h[name]).view(np.uint16))
        assert torch.equal(te.pool[name][:, req.blocks].view(torch.int16),
                           bits.view(torch.int16))
    _decode_until(te, res["request_id"], 2)
    out = te.export_request(res["request_id"])
    assert isinstance(out["k"], torch.Tensor)
    assert out["k"].dtype == torch.bfloat16 and out["k"].device.type == "cpu"
    again = tpaged.PagedTorchLLMEngine(
        LLMConfig(model_config=tcfg, **_ENGINE_KW), params=tp, device="cpu")
    res = _import(again, out, "torch")
    req = again._requests[res["request_id"]]
    for name in ("k", "v"):
        assert torch.equal(again.pool[name][:, req.blocks], out[name])


@pytest.mark.timeout(240)
@pytest.mark.parametrize("draft_blocks", [None, 3])
def test_speculative_import_reseeds_the_draft_as_jax(micro, draft_blocks):
    """A plain engine's mid-decode export imported into a speculative one
    (k = 2, the 1-layer draft): the draft is re-seeded over prompt +
    history, so the request speculates at once; tokens and acceptance
    counts equal JAX's.  A 2-block draft pool cannot hold the re-seed:
    the request decodes plainly, with the same tokens."""
    prompt = _prompt(41, 23)
    h = {}
    for pkg in ("jax", "torch"):
        src = _engine(micro, pkg)
        rid = src.add_request(prompt, _gen(pkg, max_new_tokens=20))
        _decode_until(src, rid, 5)
        h[pkg] = src.export_request(rid)
    assert h["torch"]["emitted"] == h["jax"]["emitted"]
    got = {}
    for pkg in ("jax", "torch"):
        dst = _engine(micro, pkg, spec=(2, draft_blocks))
        res = _import(dst, h[pkg], pkg)
        rid = res["request_id"]
        req = dst._requests[rid]
        assert req.spec_enabled == (draft_blocks is None)
        if draft_blocks is None:
            live = len(prompt) + len(h[pkg]["emitted"]) - 1
            assert req.draft_prefill_pos == live
            assert len(req.draft_blocks) == -(-live // 8)
        toks = _finish(dst, rid, list(h[pkg]["emitted"]))
        got[pkg] = (toks, dst.specdec_stats(), dst.specdec_request_stats(rid))
    assert got["torch"] == got["jax"]
    if draft_blocks is None:
        assert got["torch"][1]["proposed"] > 0
    else:
        assert got["torch"][1]["proposed"] == 0
