"""The remat policies "attn" and "dots" (``models.llama.run_layers``) in the
port, against its own "full" policy and against the JAX package's same
policy, both families.

``LlamaConfig.tiny`` and ``MoEConfig.tiny`` in fp32, JAX's weights carried
over by ``convert``: the port's gradients under every policy must be bit
for bit its "full" gradients (a recompute repeats the forward exactly), on
the reference attention and on the flash path (whose autograd Function
runs the plain versions on the CPU), and within 1e-5 of JAX's gradients
under the same policy (measured: at most 1.2e-8).  The control: "attn" fed the first layer's kept
attention output in every layer's recompute breaks both (for MoE the
rerouted recompute is refused by ``torch.utils.checkpoint`` itself).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointError

from ray_tpu.models import llama as jl
from ray_tpu.models import moe as jm
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel.train_step import tree_leaves

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

FAMILIES = {"llama": (jl, tl, jl.LlamaConfig, tl.LlamaConfig),
            "moe": (jm, tm, jm.MoEConfig, tm.MoEConfig)}
JAX_ATOL = 1e-5


def _tokens():
    return np.random.default_rng(4).integers(0, 256, (2, 128)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_state(family):
    _, _, jcfg_cls, _ = FAMILIES[family]
    init_fn, _ = jax_make_train_step(jcfg_cls.tiny())
    return jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0)))


def _jax_grads(family, policy):
    jmod, _, jcfg_cls, _ = FAMILIES[family]
    cfg = jcfg_cls.tiny(remat_policy=policy)
    params = jax.tree.map(jnp.asarray, _jax_state(family).params)
    grads = jax.grad(lambda p: jmod.loss_fn(cfg, p, jnp.asarray(_tokens())))(params)
    return [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_grads(family, policy):
    _, tmod, _, tcfg_cls = FAMILIES[family]
    cfg = tcfg_cls.tiny(remat_policy=policy)
    params = convert.train_state_from_jax(_jax_state(family), cfg,
                                          device="cpu").params
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tmod.loss_fn(cfg, params, torch.from_numpy(_tokens()))
    return torch.autograd.grad(loss, leaves)


@pytest.fixture(params=[None, True], ids=["reference", "flash"])
def attention(request, monkeypatch):
    """None: ``multi_head_attention``'s gate (the reference on the CPU);
    True: the flash path, whose autograd Function runs the plain versions
    here (and keeps O and LSE under "attn")."""
    monkeypatch.setattr(tl, "multi_head_attention", functools.partial(
        tl.multi_head_attention, use_flash=request.param))
    return request.param


@pytest.mark.parametrize("policy", ["attn", "dots"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_policy_gradients_equal_full_and_match_jax(family, policy, attention):
    full = _port_grads(family, "full")
    got = _port_grads(family, policy)
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    want = _jax_grads(family, policy)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_attn_recompute_launches_no_forward_and_a_wrong_keep_breaks(
        family, monkeypatch):
    monkeypatch.setattr(tl, "multi_head_attention", functools.partial(
        tl.multi_head_attention, use_flash=True))
    calls = []
    fwd = fa.flash_attention_fwd
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    n_layers = FAMILIES[family][3].tiny().n_layers
    full = _port_grads(family, "full")
    assert len(calls) == 2 * n_layers  # forward, and again in the recompute
    calls.clear()
    _port_grads(family, "attn")
    assert len(calls) == n_layers  # the recompute took the kept O and LSE

    # the control: every layer's recompute fed the first layer's output
    orig = fa._Keep.recompute_context
    first = []

    def wrong(self):
        first.append(self)
        self.outputs = first[0].outputs if len(first) > 1 else self.outputs
        return orig(self)

    monkeypatch.setattr(fa._Keep, "recompute_context", wrong)
    try:
        got = _port_grads(family, "attn")
    except CheckpointError:
        # MoE: the wrong output reroutes tokens, so the recompute saves
        # tensors of other shapes than the forward did, which checkpoint
        # refuses: the fault is caught as surely
        assert family == "moe"
        return
    finally:
        monkeypatch.setattr(fa._Keep, "recompute_context", orig)
    assert not all(torch.equal(a, b) for a, b in zip(got, full))
    want = _jax_grads(family, "attn")
    assert max(float(np.abs(g.numpy() - w).max())
               for g, w in zip(got, want)) > JAX_ATOL


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_keeps_every_weight_product():
    # a Llama layer's seven weight products (q, k, v, o, gate, up, down):
    # the backward pass runs two products for each (and two for the head);
    # "full" reruns six of them first (the recompute stops after the last
    # tensor the backward needs, before the down product), "dots" none
    counts = {}
    for policy in ("full", "dots"):
        cfg = tl.LlamaConfig.tiny(remat_policy=policy)
        params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                tl.train_param_dtypes(cfg))
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = tl.loss_fn(cfg, params, torch.from_numpy(_tokens()))
        with _CountMM() as mm:
            torch.autograd.grad(loss, leaves)
        counts[policy] = mm.n
    L = cfg.n_layers
    assert counts == {"dots": 2 + 14 * L, "full": 2 + 14 * L + 6 * L}
