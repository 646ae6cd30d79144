"""The port's optimizer descriptions (``ray_tpu_torch.parallel.optim``)
against optax, through each package's ``make_train_step``.

fp32 (``LlamaConfig.tiny`` and ``MoEConfig.tiny``): JAX's state carried
over by ``convert.train_state_from_jax``, three steps on one batch, held as
``test_three_adamw_steps_match_jax`` holds the default: loss 1e-5
absolute, grad norm 1e-5 relative, params and moments 1e-5 absolute (params
1e-4 at lr 1e-3).  Every tolerance has its control: the port at the other
b2 of the two (0.95 and 0.999) breaks it.

bf16 params with bf16 mu (the bench's headline optimizer): XLA on the CPU
runs a bf16 elementwise chain in fp32 and rounds once per fusion, where
PyTorch rounds after every operation, so the states do not match bit for
bit.  Measured after three steps: at most 1.63% of the elements of any of
params, mu and nu differ from JAX's (mu of the Llama run at
``adamw(1e-3)``; 0.02-1.2% elsewhere), the loss by at most 3.4e-6 and the
grad norm by at most 2.3e-3 relative.  Held to: at most 5% of each
differing, loss 1e-5, grad norm 5e-3 relative.  The control, the port at
b2 = 0.999 where JAX runs 0.95 (and the other way round), makes 94-96% of
nu and 8.9-30% of params differ.
"""

import inspect

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
from ray_tpu_torch.parallel import adamw, make_train_step
from ray_tpu_torch.parallel.optim import AdamState, EmptyState, find_adam_state
from ray_tpu_torch.parallel.train_step import tree_leaves

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

B, S = 2, 64
FAMILIES = {"llama": (jl.LlamaConfig, tl.LlamaConfig),
            "moe": (jm.MoEConfig, tm.MoEConfig)}
# optax.adamw(1e-3)'s defaults, and bench.py's headline hyperparameters
HYPERS = {"adamw(1e-3)": dict(learning_rate=1e-3),
          "headline": dict(learning_rate=3e-4, b1=0.9, b2=0.95,
                           weight_decay=0.1)}
BF16_SHARE = 0.05  # at most this share of a state tensor may differ (bf16)


def _tokens(seed=4):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(family, hyper, dtype, port_hyper=None):
    """Three steps of both packages from JAX's initial state; returns the
    per-step (loss, grad norm) pairs and both final states (port's)."""
    jcfg_cls, tcfg_cls = FAMILIES[family]
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg, tcfg = jcfg_cls.tiny(param_dtype=jdt), tcfg_cls.tiny(param_dtype=tdt)
    init_fn, jstep = jax_make_train_step(
        jcfg, optimizer=optax.adamw(**hyper, mu_dtype=jdt))
    jstate = init_fn(jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu")
    _, step_fn = make_train_step(
        tcfg, optimizer=adamw(**(port_hyper or hyper), mu_dtype=tdt),
        device="cpu")
    tokens = _tokens()
    metrics = []
    for _ in range(3):
        jstate, jmet = jstep(jstate, jnp.asarray(tokens))
        state, m = step_fn(state, torch.from_numpy(tokens))
        metrics.append((float(m["loss"]), float(jmet["loss"]),
                        float(m["grad_norm"]), float(jmet["grad_norm"])))
    want = convert.train_state_from_jax(_np(jstate), tcfg, device="cpu")
    return metrics, state, want


def _tensors(state):
    adam = find_adam_state(state.opt_state)
    return {"params": state.params, "mu": adam.mu, "nu": adam.nu}


def _swapped_b2(hyper):
    """The control: the port at b2 = 0.999 where JAX runs 0.95, and the
    other way round."""
    return dict(hyper, b2=0.999 if hyper.get("b2", 0.999) == 0.95 else 0.95)


def _fp32_gaps(metrics, state, want):
    """{what: largest absolute gap} over the three steps' losses and the
    final params, mu and nu; and the largest grad-norm relative gap."""
    gaps = {"loss": max(abs(a - b) for a, b, _, _ in metrics)}
    got, ref = _tensors(state), _tensors(want)
    for name in got:
        pairs = list(zip(tree_leaves(got[name]), tree_leaves(ref[name])))
        assert all(g.dtype == w.dtype == torch.float32 for g, w in pairs), name
        gaps[name] = max(float((g - w).abs().max()) for g, w in pairs)
    return gaps, max(abs(a / b - 1) for _, _, a, b in metrics)


@pytest.mark.parametrize("hyper", sorted(HYPERS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_fp32_steps_match_optax(family, hyper):
    # params: 1e-5 at the headline's lr (measured 5.1e-6), 1e-4 at lr 1e-3
    # (measured 1.7e-5: one element whose gradient is near its fp32 noise,
    # which Adam's first steps scale up to the lr); moments and loss 1e-5
    tol = {"loss": 1e-5, "mu": 1e-5, "nu": 1e-5,
           "params": 1e-4 if hyper == "adamw(1e-3)" else 1e-5}
    gaps, dnorm = _fp32_gaps(*_run(family, HYPERS[hyper], "fp32"))
    assert dnorm <= 1e-5 and all(gaps[k] <= tol[k] for k in tol), gaps
    # measured: nu 3.2e-4 to 3.9e-4 off, the third loss 2.2e-5 to 2.7e-4
    gaps, _ = _fp32_gaps(*_run(family, HYPERS[hyper], "fp32",
                               port_hyper=_swapped_b2(HYPERS[hyper])))
    assert any(gaps[k] > tol[k] for k in tol), gaps


def _bf16_gap(metrics, state, want):
    """(largest |d loss|, largest grad-norm relative gap, largest share of
    differing elements among params, mu and nu)."""
    dloss = max(abs(a - b) for a, b, _, _ in metrics)
    dnorm = max(abs(a / b - 1) for _, _, a, b in metrics)
    got, ref = _tensors(state), _tensors(want)
    share = 0.0
    for name in got:
        pairs = list(zip(tree_leaves(got[name]), tree_leaves(ref[name])))
        # bf16 but for the MoE router, which stays fp32 (its nu too)
        assert all(g.dtype == w.dtype for g, w in pairs), name
        share = max(share, sum(int((g != w).sum()) for g, w in pairs)
                    / sum(g.numel() for g, _ in pairs))
    return dloss, dnorm, share


@pytest.mark.parametrize("hyper", sorted(HYPERS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_bf16_steps_match_optax_and_the_b2_control_breaks(family, hyper):
    dloss, dnorm, share = _bf16_gap(*_run(family, HYPERS[hyper], "bf16"))
    assert dloss <= 1e-5 and dnorm <= 5e-3 and share <= BF16_SHARE, \
        (dloss, dnorm, share)
    dloss, dnorm, share = _bf16_gap(*_run(family, HYPERS[hyper], "bf16",
                                          port_hyper=_swapped_b2(HYPERS[hyper])))
    assert share > 2 * BF16_SHARE, share


def test_adamw_takes_optax_signature_and_defaults():
    ours = inspect.signature(adamw).parameters
    theirs = inspect.signature(optax.adamw).parameters
    assert list(ours) == [k for k in theirs if k not in ("mask", "nesterov")]
    for k in ours:
        if k != "learning_rate":
            assert ours[k].default == theirs[k].default, k
    with pytest.raises(TypeError, match="schedules"):
        adamw(lambda count: 1e-3)


@pytest.mark.parametrize("mu_dtype,param_dtype,want_mu", [
    (None, torch.float32, torch.float32),
    (None, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32),
])
def test_adam_state_keeps_optax_dtypes(mu_dtype, param_dtype, want_mu):
    # optax: mu in mu_dtype (None: the params'), nu in the params' dtype,
    # and the chain's two stateless transforms as EmptyState
    cfg = tl.LlamaConfig.tiny(param_dtype=param_dtype)
    init_fn, step_fn = make_train_step(
        cfg, optimizer=adamw(1e-3, mu_dtype=mu_dtype), device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    adam, *rest = state.opt_state
    assert isinstance(adam, AdamState) and rest == [EmptyState(), EmptyState()]
    state, _ = step_fn(state, torch.from_numpy(_tokens()))
    assert {p.dtype for p in tree_leaves(state.params)} == {param_dtype}
    assert {m.dtype for m in tree_leaves(adam.mu)} == {want_mu}
    assert {v.dtype for v in tree_leaves(adam.nu)} == {param_dtype}
    assert int(adam.count) == 1


def test_a_foreign_optimizer_is_a_type_error():
    with pytest.raises(TypeError, match="optim.adamw"):
        make_train_step(tl.LlamaConfig.tiny(), optimizer=object(), device="cpu")
    with pytest.raises(TypeError, match="optim.adamw"):
        make_train_step(tm.MoEConfig.tiny(), optimizer=optax.adamw(1e-3),
                        device="cpu")
