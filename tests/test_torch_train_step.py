"""The port's training step against the JAX package's, on the same state.

``LlamaConfig.tiny`` and ``MoEConfig.tiny`` in fp32: JAX's
``make_train_step`` state carried over by ``convert.train_state_from_jax``,
then the same token batch through both.  Tolerances: logits and loss 1e-5, grad norm 1e-5 relative; after
three AdamW steps params and moments 1e-5 absolute (the same fp32
arithmetic in another summation order).  Through the flash path's plain
version attention's gradients are summed in another order than JAX's
reference, and Adam's first steps divide each gradient by its own size:
an element whose gradient is near its own fp32 noise moves by up to lr
(3e-4) per step.  Params are held to 1e-4 there (measured 1.1e-5).  The
MoE step routes every token to the same experts as JAX's does (the router
is fp32 in both) and is held to the same tolerances, through the grouped
matmul's plain version and through the kernels' autograd Function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import moe as jm
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.parallel import TrainState, adamw, make_train_step
from ray_tpu_torch.parallel.optim import find_adam_state
from ray_tpu_torch.parallel.train_step import tree_leaves

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

B, S = 2, 64


def _tokens(seed=4):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _jax_state(tie=False):
    cfg = jl.LlamaConfig.tiny(tie_embeddings=tie)
    init_fn, step_fn = jax_make_train_step(cfg)
    return cfg, init_fn(jax.random.PRNGKey(0)), step_fn


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("tie", [False, True])
def test_forward_and_loss_match_jax(tie):
    jcfg, jstate, _ = _jax_state(tie)
    tcfg = tl.LlamaConfig.tiny(tie_embeddings=tie)
    params = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu").params
    tokens = _tokens()
    want = jl.forward(jcfg, jstate.params, jnp.asarray(tokens))
    got = tl.forward(tcfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    mask = np.random.default_rng(5).integers(0, 2, (B, S)).astype(np.int32)
    for lm in (None, mask):
        want = jl.loss_fn(jcfg, jstate.params, jnp.asarray(tokens),
                          loss_mask=None if lm is None else jnp.asarray(lm))
        got = tl.loss_fn(tcfg, params, torch.from_numpy(tokens),
                         loss_mask=None if lm is None else torch.from_numpy(lm))
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_flash", [None, True])
def test_three_adamw_steps_match_jax(use_flash, monkeypatch):
    # None: multi_head_attention's gate (the reference on the CPU); True:
    # the flash path, whose autograd Function runs the plain versions here
    monkeypatch.setattr(tl, "multi_head_attention", functools.partial(
        tl.multi_head_attention, use_flash=use_flash))
    _, jstate, jstep = _jax_state()
    tcfg = tl.LlamaConfig.tiny()
    state = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu")
    _, step_fn = make_train_step(tcfg, device="cpu")
    tokens = _tokens()
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step_fn(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
        assert int(m["step"]) == int(jm["step"]) == i + 1
    want = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu")
    adam, wadam = find_adam_state(state.opt_state), find_adam_state(want.opt_state)
    assert int(state.step) == 3 and int(adam.count) == 3
    for name, got, ref, atol in (
            ("params", state.params, want.params, 1e-4 if use_flash else 1e-5),
            ("mu", adam.mu, wadam.mu, 1e-5),
            ("nu", adam.nu, wadam.nu, 1e-5)):
        for g, w in zip(tree_leaves(got), tree_leaves(ref)):
            torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=name)


def test_remat_on_and_off_give_the_same_grads():
    _, jstate, _ = _jax_state()
    tokens = torch.from_numpy(_tokens())
    grads = []
    for remat in (True, False):
        cfg = tl.LlamaConfig.tiny(remat=remat)
        params = convert.train_state_from_jax(_np(jstate), cfg, device="cpu").params
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads.append(torch.autograd.grad(tl.loss_fn(cfg, params, tokens), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_init_fn_builds_fp32_training_state_and_default_device_needs_cuda():
    cfg = tl.LlamaConfig.tiny(compute_dtype=torch.bfloat16)
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    assert isinstance(state, TrainState) and int(state.step) == 0
    # training keeps fp32 master weights; only the products run in bf16
    assert {p.dtype for p in tree_leaves(state.params)} == {torch.float32}
    assert {m.dtype for m in tree_leaves(state.opt_state[0].mu)} == {torch.float32}
    wq = state.params["layers"]["wq"]
    state, m = step_fn(state, torch.from_numpy(_tokens()))
    assert state.params["layers"]["wq"] is wq  # updated in place
    assert np.isfinite(float(m["loss"])) and int(m["step"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(cfg)


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "A11"),
    ({"context_parallel": True}, "A11"),
    ({"pipeline_microbatches": 2}, "A11"),
    ({"loss": tl.loss_fn}, "A11"),
    # the id keeps the test's name from before the collectives landed
    pytest.param({"overlap_grad_sync": True}, "A11", id="kw4-A10"),
])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        make_train_step(tl.LlamaConfig.tiny(), device="cpu", **kw)


@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_remat_policies_are_taken_and_others_refused(policy):
    # what "attn" and "dots" compute is held in tests/test_torch_remat.py
    cfg = tl.LlamaConfig.tiny(remat_policy=policy)
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state, m = step_fn(init_fn(torch.Generator().manual_seed(0)),
                       torch.from_numpy(_tokens()))
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="remat_policy"):
        tl.forward(tl.LlamaConfig.tiny(remat_policy="most"), {},
                   torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="A11"):
        tl.loss_fn(tl.LlamaConfig.tiny(), {}, torch.zeros((1, 4), dtype=torch.int32),
                   context_parallel=True)


def test_train_state_from_jax_round_trips_a_state_after_one_step():
    _, jstate, jstep = _jax_state()
    jstate, _ = jstep(jstate, jnp.asarray(_tokens()))
    ref = _np(jstate)
    state = convert.train_state_from_jax(ref, tl.LlamaConfig.tiny(), device="cpu")
    adam, got_adam = ref.opt_state[0], state.opt_state[0]
    assert int(state.step) == 1 and int(got_adam.count) == 1
    for got, want in ((state.params, ref.params), (got_adam.mu, adam.mu),
                      (got_adam.nu, adam.nu)):
        assert sorted(got) == sorted(want)
        for k in want:
            if k != "layers":
                np.testing.assert_array_equal(got[k].numpy(), want[k])
        for k in want["layers"]:
            np.testing.assert_array_equal(got["layers"][k].numpy(),
                                          want["layers"][k])
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        convert.train_state_from_jax((ref.step, ref.params, ()),
                                     tl.LlamaConfig.tiny(), device="cpu")


def _jax_moe_state():
    init_fn, step_fn = jax_make_train_step(jm.MoEConfig.tiny())
    return init_fn(jax.random.PRNGKey(0)), step_fn


@pytest.mark.parametrize("kernels", [False, True])
def test_moe_three_adamw_steps_match_jax(kernels, monkeypatch):
    # False: the grouped matmul's plain version under autograd (JAX's
    # lax.ragged_dot off the TPU); True: the kernels' autograd Function,
    # whose wrappers run the plain versions on the CPU
    if kernels:
        monkeypatch.setattr(tm, "_gmm_supported", lambda device, mesh: True)
    jstate, jstep = _jax_moe_state()
    tcfg = tm.MoEConfig.tiny()
    state = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu")
    _, step_fn = make_train_step(tcfg, device="cpu")
    tokens = _tokens()
    for i in range(3):
        jstate, jm_ = jstep(jstate, jnp.asarray(tokens))
        state, m = step_fn(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-5)
        assert int(m["step"]) == i + 1
    want = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu")
    adam, wadam = state.opt_state[0], want.opt_state[0]
    for name, got, ref in (("params", state.params, want.params),
                           ("mu", adam.mu, wadam.mu),
                           ("nu", adam.nu, wadam.nu)):
        for g, w in zip(tree_leaves(got), tree_leaves(ref)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=name)


def test_moe_train_state_from_jax_round_trips_a_state_after_one_step():
    jstate, jstep = _jax_moe_state()
    jstate, _ = jstep(jstate, jnp.asarray(_tokens()))
    ref = _np(jstate)
    state = convert.train_state_from_jax(ref, tm.MoEConfig.tiny(), device="cpu")
    adam, got_adam = ref.opt_state[0], state.opt_state[0]
    assert int(state.step) == 1 and int(got_adam.count) == 1
    for got, want in ((state.params, ref.params), (got_adam.mu, adam.mu),
                      (got_adam.nu, adam.nu)):
        assert sorted(got["layers"]) == sorted(want["layers"])
        assert got["layers"]["w_gate"].shape == (2, 4, 64, 128)
        assert got["layers"]["router"].dtype == torch.float32
        for k in want["layers"]:
            np.testing.assert_array_equal(got["layers"][k].numpy(),
                                          want["layers"][k])
        for k in ("embed", "lm_head", "final_norm"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(ref.params, tm.MoEConfig.tiny(n_experts=8),
                                device="cpu")


def test_moe_init_fn_and_unported_options():
    cfg = tm.MoEConfig.tiny(compute_dtype=torch.bfloat16)
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    assert {p.dtype for p in tree_leaves(state.params)} == {torch.float32}
    w_up = state.params["layers"]["w_up"]
    state, m = step_fn(state, torch.from_numpy(_tokens()))
    assert state.params["layers"]["w_up"] is w_up  # updated in place
    assert np.isfinite(float(m["loss"])) and int(m["step"]) == 1
    with pytest.raises(NotImplementedError, match="A11"):
        make_train_step(cfg, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="optim.adamw"):
        make_train_step(cfg, device="cpu", optimizer=object())
    for policy in ("attn", "dots"):  # tests/test_torch_remat.py holds them
        make_train_step(tm.MoEConfig.tiny(remat_policy=policy), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        make_train_step(tm.MoEConfig.tiny(remat_policy="most"), device="cpu")
    with pytest.raises(TypeError, match="MoEConfig"):
        make_train_step(object(), device="cpu")


# -- ROADMAP C1 and C2: the flash gate's configs, the JAX keyword set ----------

BF16 = dict(compute_dtype=torch.bfloat16)
# bench.py's headline training config (chip_smoke.py phase 7), bf16 products
LLAMA_1B_TRAIN = dict(vocab_size=32768, dim=2048, n_layers=16, n_heads=16,
                      n_kv_heads=8, ffn_dim=8192, max_seq_len=2048)


@pytest.mark.parametrize("cfg", [
    tl.LlamaConfig.llama3_8b(compute_dtype=torch.float32),
    tl.LlamaConfig.llama3_8b(n_heads=16, n_kv_heads=8, **BF16),  # head_dim 256
    tm.MoEConfig.mixtral_8x7b(compute_dtype=torch.float32),
], ids=["llama-fp32", "llama-hd256", "mixtral-fp32"])
def test_a_config_the_flash_kernels_cannot_take_is_refused_up_front(cfg):
    from ray_tpu_torch.ops.attention import flash_config_refusal

    assert "ROADMAP C1" in flash_config_refusal(cfg, "cuda")
    assert flash_config_refusal(cfg, "cpu") is None
    # before any allocation: no card is needed to be refused
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        make_train_step(cfg, device="cuda")


@pytest.mark.parametrize("cfg", [
    tl.LlamaConfig.llama3_8b(**BF16),
    tm.MoEConfig.mixtral_8x7b(**BF16),
    tl.LlamaConfig(**LLAMA_1B_TRAIN, **BF16),
    tl.LlamaConfig.llama32_1b(compute_dtype=torch.float32),  # head_dim 64
], ids=["llama3-8b", "mixtral-8x7b", "llama-1b-train", "llama32-1b-fp32"])
def test_the_presets_pass_the_flash_config_check(cfg):
    from ray_tpu_torch.ops.attention import flash_config_refusal

    assert flash_config_refusal(cfg, "cuda") is None


def test_make_train_step_takes_the_jax_keywords():
    import inspect

    ours = inspect.signature(make_train_step).parameters
    theirs = inspect.signature(jax_make_train_step).parameters
    assert [k for k in ours if k != "device"] == list(theirs)
    assert ours["bucket_bytes"].default == theirs["bucket_bytes"].default
    init_fn, step_fn = make_train_step(tl.LlamaConfig.tiny(),
                                       bucket_bytes=1 << 20, device="cpu")
    assert callable(init_fn) and callable(step_fn)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        make_train_step(tl.LlamaConfig.tiny(), overlap_grad_sync=True,
                        bucket_bytes=1 << 20, device="cpu")


# -- ROADMAP A0: the torch -> JAX direction ------------------------------------

TO_JAX = {
    "default": ({}, {}, "float32"),
    "int8": ({"grad_compression": "int8"}, {"grad_compression": "int8"},
             "float32"),
    "error_feedback": ({"grad_compression": {"error_feedback": True}},
                       {"grad_compression": {"error_feedback": True}},
                       "float32"),
    "bf16": ({"optimizer": optax.adamw(1e-3, mu_dtype=jnp.bfloat16)},
             {"optimizer": adamw(1e-3, mu_dtype=torch.bfloat16)}, "bfloat16"),
}


@pytest.mark.parametrize("kind", sorted(TO_JAX))
def test_train_state_to_jax_round_trips_through_a_jax_step(kind):
    jkw, tkw, dt = TO_JAX[kind]
    jcfg = jl.LlamaConfig.tiny(param_dtype=getattr(jnp, dt))
    tcfg = tl.LlamaConfig.tiny(param_dtype=getattr(torch, dt))
    init_fn, jstep = jax_make_train_step(jcfg, **jkw)
    jstate, _ = jstep(init_fn(jax.random.PRNGKey(0)), jnp.asarray(_tokens()))
    state = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu")
    _, step_fn = make_train_step(tcfg, device="cpu", **tkw)
    state, _ = step_fn(state, torch.from_numpy(_tokens()))

    out = convert.train_state_to_jax(state)
    # the JAX state's exact structure: key paths, leaf order, dtypes, shapes
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    got = jax.tree_util.tree_flatten_with_path(out)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert isinstance(g, np.ndarray), jax.tree_util.keystr(path)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), jax.tree_util.keystr(path)
    # back into the port bit for bit
    back = convert.train_state_from_jax(out, tcfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a JAX step takes it as it takes its own state
    ours = jstep(jax.tree.map(jnp.asarray, out), jnp.asarray(_tokens()))
    theirs = jstep(jax.tree.map(jnp.asarray, convert.train_state_to_jax(back)),
                   jnp.asarray(_tokens()))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))
    state2 = convert.train_state_from_jax(_np(ours[0]), tcfg, device="cpu")
    assert int(state2.step) == 3
    assert int(find_adam_state(state2.opt_state).count) == 3


def test_params_to_jax_gives_the_jax_storage_dtypes():
    cfg = tl.LlamaConfig.tiny(compute_dtype=torch.bfloat16)
    serving = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert serving["layers"]["wq"].dtype == torch.bfloat16
    out = convert.params_to_jax(serving, cfg)
    want = jl.init_params(jl.LlamaConfig.tiny(compute_dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(out) == jax.tree.structure(_np(want))
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(out))
    np.testing.assert_array_equal(out["layers"]["wq"],
                                  serving["layers"]["wq"].float().numpy())
    mcfg = tm.MoEConfig.tiny(param_dtype=torch.bfloat16)
    mparams = tm.init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    mout = convert.params_to_jax(mparams, mcfg)
    assert mout["layers"]["router"].dtype == np.float32
    assert mout["layers"]["w_up"].dtype.name == "bfloat16"
