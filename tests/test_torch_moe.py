"""The port's MoE model against the JAX package's, on the same params.

``MoEConfig.tiny`` in fp32 (dim 64, 4 experts, top-2, 2 layers): JAX's
params carried over by ``convert.params_from_jax``, inputs seeded numpy.
The router's expert choices are equal and its weights and aux loss agree
to 1e-6; the counting sort gives the order of a stable argsort and the
group sizes of a bincount; the ragged, sorted-capacity and dense blocks,
``forward`` and ``loss_fn`` agree to 1e-5 (the same fp32 arithmetic in
another summation order).  On the CPU the ragged block runs the grouped
matmul's plain version; forced through the kernels' autograd Function
(whose wrappers run the plain versions here), it gives the same output and
gradients to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jm
from ray_tpu_torch import convert
from ray_tpu_torch.models import moe as tm

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

ATOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jm.MoEConfig.tiny(), jax.random.PRNGKey(0))


def _layer0(jparams):
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tm.MoEConfig.tiny(), device="cpu")
    return jlp, {k: v[0] for k, v in tparams["layers"].items()}, tparams


def _x(b=2, s=16, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)


def _np(a):
    return np.asarray(a)


def test_router_matches_jax(jparams):
    jlp, tlp, _ = _layer0(jparams)
    x = _x().reshape(-1, 64)
    jw, jidx, jaux = jm._router(jm.MoEConfig.tiny(), jnp.asarray(x), jlp)
    tw, tidx, taux = tm._router(tm.MoEConfig.tiny(), torch.from_numpy(x), tlp)
    np.testing.assert_array_equal(tidx.numpy(), _np(jidx))
    np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


def test_counting_sort_is_a_stable_argsort(jparams):
    _, tlp, _ = _layer0(jparams)
    _, idx, _ = tm._router(tm.MoEConfig.tiny(), torch.from_numpy(_x().reshape(-1, 64)),
                           tlp)
    skewed = torch.tensor([3, 0, 3, 3, 0, 2, 3, 0], dtype=torch.int64)  # no 1s
    for flat in (idx.reshape(-1), skewed):
        order, sizes = tm._sorted_order(flat, 4)
        assert order.dtype == sizes.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(),
                                      np.argsort(flat.numpy(), kind="stable"))
        np.testing.assert_array_equal(sizes.numpy(),
                                      np.bincount(flat.numpy(), minlength=4))


def _blocks(cfg_kw, s):
    jcfg = jm.MoEConfig.tiny(**cfg_kw)
    tcfg = tm.MoEConfig.tiny(**cfg_kw)
    return jcfg, tcfg, _x(s=s)


@pytest.mark.parametrize("name,kw,s", [
    ("ragged", {"dispatch": "ragged"}, 16),
    ("sorted_capacity", {"dispatch": "sorted_capacity"}, 128),
    # capacity 128 of ~128 pairs per expert: some pairs drop
    ("sorted_capacity", {"dispatch": "sorted_capacity", "capacity_factor": 0.5}, 128),
    ("dense", {"dispatch": "dense"}, 16),
    ("dense", {"dispatch": "dense", "capacity_factor": 0.5}, 16),
])
def test_moe_blocks_match_jax(jparams, name, kw, s):
    jlp, tlp, _ = _layer0(jparams)
    jcfg, tcfg, x = _blocks(kw, s)
    jy, jaux = jm.moe_block(jcfg, jnp.asarray(x), jlp, None)
    ty, taux = tm.moe_block(tcfg, torch.from_numpy(x), tlp)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    if name != "ragged":
        return
    jy2, _ = jm.moe_block_ragged(jcfg, jnp.asarray(x), jlp)
    ty2, _ = tm.moe_block_ragged(tcfg, torch.from_numpy(x), tlp)
    np.testing.assert_allclose(ty2.numpy(), _np(jy2), rtol=0, atol=ATOL)


def test_sorted_capacity_equals_ragged_when_nothing_drops(jparams):
    # capacity_factor = n_experts gives cap = T: no pair can drop, so the
    # padded batched products compute the ragged block's function
    _, tlp, _ = _layer0(jparams)
    cfg = tm.MoEConfig.tiny()
    x = torch.from_numpy(_x(s=128))
    y_r, aux_r = tm.moe_block_ragged(cfg, x, tlp)
    cap = dataclasses.replace(cfg, dispatch="sorted_capacity",
                              capacity_factor=float(cfg.n_experts))
    y_c, aux_c = tm.moe_block(cap, x, tlp)
    torch.testing.assert_close(y_c, y_r, rtol=0, atol=1e-6)
    assert float(aux_c) == float(aux_r)


def test_ragged_block_through_the_kernels_function(jparams, monkeypatch):
    _, tlp, _ = _layer0(jparams)
    cfg = tm.MoEConfig.tiny()
    x = torch.from_numpy(_x())
    ct = torch.from_numpy(_x(seed=2))

    def run():
        leaves = {k: v.clone().requires_grad_(True) for k, v in tlp.items()}
        y, aux = tm.moe_block_ragged(cfg, x, leaves)
        names = ("w_gate", "w_up", "w_down", "router")
        grads = torch.autograd.grad((y * ct).sum() + aux, [leaves[n] for n in names])
        return y.detach(), grads

    y0, g0 = run()
    monkeypatch.setattr(tm, "_gmm_supported", lambda device, mesh: True)
    y1, g1 = run()
    torch.testing.assert_close(y1, y0, rtol=0, atol=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_forward_and_loss_match_jax(jparams):
    _, _, tparams = _layer0(jparams)
    jcfg, tcfg = jm.MoEConfig.tiny(), tm.MoEConfig.tiny()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (2, 32)).astype(np.int32)
    jl, jaux = jm.forward(jcfg, jparams, jnp.asarray(tokens))
    tl, taux = tm.forward(tcfg, tparams, torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and tl.shape == (2, 32, 256)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    mask = rng.integers(0, 2, (2, 32)).astype(np.int32)
    for lm in (None, mask):
        want = jm.loss_fn(jcfg, jparams, jnp.asarray(tokens),
                          loss_mask=None if lm is None else jnp.asarray(lm))
        got = tm.loss_fn(tcfg, tparams, torch.from_numpy(tokens),
                         loss_mask=None if lm is None else torch.from_numpy(lm))
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)


def test_config_counts_and_what_is_not_ported():
    cfg = tm.MoEConfig.mixtral_8x7b(n_layers=2, max_seq_len=2048)
    jcfg = jm.MoEConfig.mixtral_8x7b(n_layers=2, max_seq_len=2048)
    assert cfg.num_params == jcfg.num_params == 3_164_688_384
    assert cfg.num_active_params == jcfg.num_active_params == 1_050_759_168
    assert tm.flops_per_token(cfg, 2048) == jm.flops_per_token(jcfg, 2048)
    with pytest.raises(ValueError, match="dispatch"):
        tm.MoEConfig.tiny(dispatch="sparse")
    with pytest.raises(NotImplementedError, match="A11"):
        tm.param_specs(cfg)
    with pytest.raises(NotImplementedError, match="A11"):
        tm.forward(tm.MoEConfig.tiny(), {}, torch.zeros((1, 4), dtype=torch.int32),
                   mesh=object())
    # "attn" and "dots" are ported (tests/test_torch_remat.py); others raise
    with pytest.raises(ValueError, match="remat_policy"):
        tm.forward(tm.MoEConfig.tiny(remat_policy="most"), {},
                   torch.zeros((1, 4), dtype=torch.int32))
    params = tm.init_params(tm.MoEConfig.tiny(), torch.Generator().manual_seed(0), "cpu")
    assert params["layers"]["w_gate"].shape == (2, 4, 64, 128)
    assert params["layers"]["w_down"].shape == (2, 4, 128, 64)
    assert params["layers"]["router"].dtype == torch.float32
