"""The port's LoRA adapters (``ray_tpu_torch.llm.lora``) against
``ray_tpu.llm.lora``.

- ``merge_lora`` gives JAX's merged weights exactly at fp32, and at bf16
  storage JAX's merged weight as its programs use it (cast to bf16) when
  the base weights are representable in bf16; the merged model's logits
  match JAX's;
- a zero-initialised adapter is the identity and copies nothing it does
  not target; ``LoRAManager`` keeps an LRU of merged params;
- ``adapter_speculation`` resolves every per-adapter case as JAX's does;
- ``init_lora``'s shapes and config, ``lora_from_jax``, ``trainable_mask``,
  and ``lora_param_specs`` refusing (sharding, ROADMAP A11).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.llm import lora as jlora
from ray_tpu.llm.config import SpeculativeConfig as JSpec
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm import lora as tlora
from ray_tpu_torch.llm.config import SpeculativeConfig
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

_ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def base():
    jcfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp


def _adapter(jcfg, targets=_ALL, rank=4, alpha=32.0, seed=1):
    """A JAX adapter with nonzero B, so the merge moves every target."""
    ad = jlora.init_lora(jcfg, jlora.LoRAConfig(rank=rank, alpha=alpha,
                                                targets=targets),
                         jax.random.PRNGKey(seed))
    for i, name in enumerate(targets):
        b = ad["layers"][name]["B"]
        ad["layers"][name]["B"] = jax.random.normal(
            jax.random.PRNGKey(100 + i), b.shape) * 0.5
    return ad


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_merge_matches_jax_exactly_at_fp32(base):
    jcfg, jp = base
    ad = _adapter(jcfg)
    want = jlora.merge_lora(jp, ad)
    tcfg = tl.LlamaConfig.tiny()
    tp = convert.params_from_jax(_np(jp), tcfg, device="cpu")
    got = tlora.merge_lora(tp, convert.lora_from_jax(_np(ad), device="cpu"))
    for name in _ALL:
        assert got["layers"][name].dtype == torch.float32
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      np.asarray(want["layers"][name]),
                                      err_msg=name)
        assert not torch.equal(got["layers"][name], tp["layers"][name])
    # the merged model: logits as JAX's
    tokens = np.arange(12, dtype=np.int32)[None, :] % jcfg.vocab_size
    jlog = np.asarray(jl.forward(jcfg, want, jnp.asarray(tokens)))
    tlog = tl.forward(dataclasses.replace(tcfg, remat=False), got,
                      torch.from_numpy(tokens))
    np.testing.assert_allclose(tlog.detach().numpy(), jlog, rtol=1e-5,
                               atol=1e-5)
    base_log = np.asarray(jl.forward(jcfg, jp, jnp.asarray(tokens)))
    assert np.abs(jlog - base_log).max() > 1e-3


def test_merge_rounds_once_at_bf16(base):
    """bf16 storage, base weights representable in bf16: the port's merged
    weight is JAX's fp32 merge cast to bf16, as JAX's programs cast it at
    every use.  The control: rounding the delta to bf16 before the add (a
    second rounding) misses it somewhere."""
    jcfg, jp = base
    jp16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16).astype(jnp.float32),
                        jp)
    ad = _adapter(jcfg, targets=("wq", "w_down"), alpha=8.0)
    want = jlora.merge_lora(jp16, ad)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.bfloat16)
    tp = convert.params_from_jax(_np(jp16), tcfg, device="cpu")
    tad = convert.lora_from_jax(_np(ad), device="cpu")
    got = tlora.merge_lora(tp, tad)
    for name in ("wq", "w_down"):
        assert got["layers"][name].dtype == torch.bfloat16
        want16 = np.asarray(want["layers"][name]).astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(
            got["layers"][name].view(torch.uint16).numpy(),
            want16.view(np.uint16), err_msg=name)
        ab = tad["layers"][name]
        delta = torch.einsum("lor,lri->lio", ab["B"], ab["A"]) * 2.0
        twice = tp["layers"][name] + delta.to(torch.bfloat16)
        assert not torch.equal(twice, got["layers"][name])


def test_zero_adapter_is_the_identity(base):
    jcfg, jp = base
    tcfg = tl.LlamaConfig.tiny()
    tp = convert.params_from_jax(_np(jp), tcfg, device="cpu")
    ad = tlora.init_lora(tcfg, tlora.LoRAConfig(rank=4),
                         torch.Generator().manual_seed(1))
    merged = tlora.merge_lora(tp, ad)
    for name in ("wq", "wv"):
        assert torch.equal(merged["layers"][name], tp["layers"][name])
    assert merged["layers"]["wo"] is tp["layers"]["wo"]
    assert merged["embed"] is tp["embed"]


def test_init_lora_shapes_and_config_follow_jax(base):
    jcfg, _ = base
    lcfg = dict(rank=3, alpha=6.0, targets=_ALL)
    want = jlora.init_lora(jcfg, jlora.LoRAConfig(**lcfg),
                           jax.random.PRNGKey(0))
    got = tlora.init_lora(tl.LlamaConfig.tiny(), tlora.LoRAConfig(**lcfg),
                          torch.Generator().manual_seed(0))
    assert got["config"] == want["config"]
    for name in _ALL:
        for part in ("A", "B"):
            t, j = got["layers"][name][part], want["layers"][name][part]
            assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert not got["layers"][name]["B"].any()
        assert 0.015 < float(got["layers"][name]["A"].std()) < 0.025
    with pytest.raises(ValueError, match="unknown LoRA target"):
        tlora.init_lora(tl.LlamaConfig.tiny(),
                        tlora.LoRAConfig(targets=("wx",)),
                        torch.Generator().manual_seed(0))
    assert tlora.LoRAConfig(rank=4, alpha=16.0).scale == 4.0


def test_lora_from_jax_copies_every_leaf(base):
    jcfg, _ = base
    ad = _adapter(jcfg, targets=("wk", "w_up"))
    got = convert.lora_from_jax(_np(ad), device="cpu")
    assert got["config"] == dict(ad["config"], targets=("wk", "w_up"))
    for name in ("wk", "w_up"):
        for part in ("A", "B"):
            np.testing.assert_array_equal(got["layers"][name][part].numpy(),
                                          np.asarray(ad["layers"][name][part]))


def test_manager_lru_and_routing(base):
    _, jp = base
    tcfg = tl.LlamaConfig.tiny()
    params = convert.params_from_jax(_np(jp), tcfg, device="cpu")
    mgr = tlora.LoRAManager(params, max_merged=2)
    for i in range(3):
        mgr.register(f"ad{i}", tlora.init_lora(
            tcfg, tlora.LoRAConfig(rank=2), torch.Generator().manual_seed(i)))
    assert mgr.adapter_names() == ["ad0", "ad1", "ad2"]
    assert mgr.params_for(None) is params
    assert mgr.params_for("unknown") is params
    p0 = mgr.params_for("ad0")
    p1 = mgr.params_for("ad1")
    assert mgr.params_for("ad0") is p0  # cached, and now the most recent
    mgr.params_for("ad2")  # evicts ad1, the least recently used
    assert sorted(mgr._merged) == ["ad0", "ad2"] and p1 is not None
    assert mgr.params_for("ad1") is not p1  # merged again
    mgr.register("ad0", tlora.init_lora(tcfg, tlora.LoRAConfig(rank=2),
                                        torch.Generator().manual_seed(9)))
    assert "ad0" not in mgr._merged  # re-registering drops the stale merge


@pytest.mark.parametrize("model_id,over", [
    (None, {"a": {"num_speculative_tokens": 2}}),
    ("a", None),
    ("unknown", {"a": {"enabled": False}}),
    ("a", {"a": {}}),
    ("a", {"a": {"enabled": False}}),
    ("a", {"a": {"num_speculative_tokens": 2}}),
    ("a", {"a": {"num_speculative_tokens": 0}}),
    ("a", {"a": {"enabled": True, "draft_adapter": "draft-tree"}}),
    ("a", {"a": {"num_speculative_tokens": 6, "draft_adapter": "draft-tree"}}),
])
def test_adapter_speculation_cases_follow_jax(model_id, over):
    def resolve(mod, spec_cls):
        spec = spec_cls(draft_model_config="cfg", num_speculative_tokens=3,
                        per_adapter=over)
        eff, adapter = mod.adapter_speculation(spec, model_id)
        return (None if eff is None else
                (eff.num_speculative_tokens, eff.draft_model_config,
                 eff is spec), adapter)

    assert resolve(tlora, SpeculativeConfig) == resolve(jlora, JSpec)
    assert tlora.adapter_speculation(None, model_id) == (None, None)


def test_trainable_mask_and_sharding(base):
    _, jp = base
    tcfg = tl.LlamaConfig.tiny()
    tp = convert.params_from_jax(_np(jp), tcfg, device="cpu")
    ad = tlora.init_lora(tcfg, tlora.LoRAConfig(rank=2),
                         torch.Generator().manual_seed(0))
    amask, bmask = tlora.trainable_mask(tp, ad)
    assert amask["config"] is False
    assert amask["layers"] == {n: {"A": True, "B": True} for n in ("wq", "wv")}
    assert bmask["layers"]["wq"] is False and bmask["embed"] is False
    assert set(bmask) == set(tp)
    # the adapter's partition specs (ported with the meshes): the
    # reference's, dim for dim
    for targets in (("wq", "wv"), tlora.TARGETS):
        want = jlora.lora_param_specs(jl.LlamaConfig.tiny(),
                                      jlora.LoRAConfig(targets=targets))
        got = tlora.lora_param_specs(tcfg, tlora.LoRAConfig(targets=targets))
        assert got["config"] is None and set(got) == set(want)
        assert {n: {k: tuple(v) for k, v in ab.items()}
                for n, ab in want["layers"].items()} == got["layers"]
