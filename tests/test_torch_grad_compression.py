"""The int8 block codec and gradient compression of the port
(``ray_tpu_torch.util.collective.compression``) against the JAX package's
(``ray_tpu/util/collective/compression.py``).

- The port's numpy codec is a copy: bitwise equal to the original on the
  same inputs, with the same spec parsing.
- The torch codec is bitwise equal to the numpy codec (codes and scales):
  padding of the last block, zero blocks (scale 0, codes 0), ties (round
  half to even, as ``np.rint``), bf16 input through fp32.
- The transform on identical gradients gives bitwise the JAX transform's
  coded gradients and residuals.
- Three compressed steps (with and without error feedback) against JAX's
  ``make_train_step(grad_compression=...)``.  The gradients of the two
  packages differ in fp32 rounding, and where that moves a value across a
  code boundary the coded gradient moves by a whole block scale (max |g| /
  127 of its block) and the residual with it.  Measured after three steps
  (``tiny()``, both families): params 3.7e-5, mu 2.0e-5, nu 1.4e-7 and
  residuals 2.0e-4 apart.  Held to params 1e-4, mu 3e-5, nu 5e-7,
  residuals 5e-4, loss 1e-5, grad norm 1e-5 relative.  The control, the
  port at block size 128 where JAX codes blocks of 256, puts params
  6.6e-4 to 9.0e-4 and nu 8.0e-7 to 1.3e-6 apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import moe as jm
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu.util.collective import compression as jc
from ray_tpu_torch import convert
from ray_tpu_torch._private.host_arrays import from_numpy
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.parallel import make_train_step
from ray_tpu_torch.parallel.optim import EmptyState, find_adam_state
from ray_tpu_torch.parallel.train_step import tree_leaves
from ray_tpu_torch.util.collective import compression as tc

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py


def _cases():
    """name -> (fp32 array, block size)."""
    rng = np.random.default_rng(0)
    ties = np.zeros(256, np.float32)
    ties[0] = 127.0  # scale exactly 1: the rest sit on half-way points
    ties[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    zeros = rng.standard_normal(1000).astype(np.float32)
    zeros[256:512] = 0.0  # one whole zero block
    return {
        "padded": (rng.standard_normal(1000).astype(np.float32) * 3, 256),
        "block 64": (rng.standard_normal(777).astype(np.float32), 64),
        "zero block": (zeros, 256),
        "ties": (ties, 256),
        "tiny and huge": (np.concatenate([
            rng.standard_normal(300).astype(np.float32) * 1e-30,
            rng.standard_normal(300).astype(np.float32) * 1e30]), 128),
        "all zero": (np.zeros(300, np.float32), 256),
    }


CASES = _cases()


def test_spec_and_its_parsing_are_the_originals():
    ours = [(f.name, f.default) for f in dataclasses.fields(tc.CompressionSpec)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jc.CompressionSpec)]
    assert ours == theirs
    assert (tc.DEFAULT_BLOCK_SIZE, tc.DEFAULT_MIN_BYTES) == \
        (jc.DEFAULT_BLOCK_SIZE, jc.DEFAULT_MIN_BYTES)
    for arg in (None, "int8", "none", {"error_feedback": True, "block_size": 64}):
        want = jc.resolve_spec(arg)
        got = tc.resolve_spec(arg)
        assert (got is None and want is None) or \
            dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad, err in (("fp8", ValueError), (3, TypeError),
                     ({"scheme": "fp8"}, ValueError),
                     ({"block_size": 0}, ValueError)):
        with pytest.raises(err):
            jc.resolve_spec(bad)
        with pytest.raises(err):
            tc.resolve_spec(bad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_codec_is_the_originals_bit_for_bit(case):
    x, bs = CASES[case]
    for arr in (x, x.astype(ml_dtypes.bfloat16)):
        codes, scales = tc.quantize_blocks(arr, bs)
        want_codes, want_scales = jc.quantize_blocks(arr, bs)
        np.testing.assert_array_equal(codes, want_codes)
        np.testing.assert_array_equal(scales.view(np.uint32),
                                      want_scales.view(np.uint32))
        np.testing.assert_array_equal(
            tc.dequantize_blocks(codes, scales, x.size, bs).view(np.uint32),
            jc.dequantize_blocks(codes, scales, x.size, bs).view(np.uint32))
    np.testing.assert_array_equal(tc.pad_to_multiple(x, bs),
                                  jc.pad_to_multiple(x, bs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_codec_equals_the_numpy_codec(case):
    x, bs = CASES[case]
    for t, arr in ((torch.from_numpy(x), x),
                   (torch.from_numpy(x).bfloat16(),
                    x.astype(ml_dtypes.bfloat16))):
        want_codes, want_scales = tc.quantize_blocks(arr, bs)
        padded = torch.nn.functional.pad(t, (0, (-t.numel()) % bs))
        codes, scales = tc.torch_quantize_blocks(padded, bs)
        assert codes.dtype == torch.int8 and scales.dtype == torch.float32
        np.testing.assert_array_equal(codes.numpy(), want_codes)
        np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                      want_scales.view(np.uint32))
        back = tc.torch_dequantize_blocks(codes, scales, bs)[:x.size]
        np.testing.assert_array_equal(
            back.numpy().view(np.uint32),
            tc.dequantize_blocks(want_codes, want_scales, x.size, bs)
            .view(np.uint32))
    if case == "ties":  # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        assert codes[1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


def _grads():
    """fp32 and bf16 gradient-like leaves, some under min_bytes, and an
    int leaf that must pass through."""
    rng = np.random.default_rng(1)
    shapes = {"big": (300, 70), "small": (10,), "bf16": (64, 64)}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g["bf16"] = g["bf16"].astype(ml_dtypes.bfloat16)
    g["ids"] = np.arange(12, dtype=np.int32)
    return g


@pytest.mark.parametrize("error_feedback", [False, True])
def test_transform_equals_jax_on_the_same_gradients(error_feedback):
    spec = {"error_feedback": error_feedback, "min_bytes": 1024}
    grads = _grads()
    jt = jc.compress_gradients(spec)
    jstate = jt.init(jax.tree.map(jnp.asarray, grads))
    ours = tc.compress_gradients(spec)
    tparams = {k: from_numpy(v, "cpu", None) for k, v in grads.items()}
    state = ours.init(tparams)
    assert (state == EmptyState()) == (not error_feedback)
    for step in range(2):  # the second round reads the first's residual
        scaled = jax.tree.map(lambda a: (np.asarray(a) * (step + 1)).astype(a.dtype),
                              grads)
        want, jstate = jt.update(jax.tree.map(jnp.asarray, scaled), jstate)
        got = ours.update([from_numpy(scaled[k], "cpu", None)
                           for k in sorted(scaled)], state)
        for k, g in zip(sorted(scaled), got):
            w = np.asarray(want[k])
            assert g.dtype == from_numpy(w, "cpu", None).dtype, k
            np.testing.assert_array_equal(
                g.view(torch.int16 if g.dtype == torch.bfloat16 else g.dtype)
                .numpy(), w.view(np.int16) if w.dtype == ml_dtypes.bfloat16 else w)
        assert torch.equal(got[sorted(scaled).index("ids")],
                           torch.from_numpy(scaled["ids"]))
        if error_feedback:
            for k in sorted(scaled):
                np.testing.assert_array_equal(
                    state.residual[k].numpy(), np.asarray(jstate.residual[k]))


FAMILIES = {"llama": (jl.LlamaConfig, tl.LlamaConfig),
            "moe": (jm.MoEConfig, tm.MoEConfig)}
TOL = {"params": 1e-4, "mu": 3e-5, "nu": 5e-7, "residual": 5e-4}


def _steps(family, spec, port_spec=None):
    jcfg_cls, tcfg_cls = FAMILIES[family]
    init_fn, jstep = jax_make_train_step(jcfg_cls.tiny(), grad_compression=spec)
    jstate = init_fn(jax.random.PRNGKey(0))
    cfg = tcfg_cls.tiny()
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                         device="cpu")
    _, step_fn = make_train_step(cfg, grad_compression=port_spec or spec,
                                 device="cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (2, 64)).astype(np.int32)
    metrics = []
    for _ in range(3):
        jstate, jmet = jstep(jstate, jnp.asarray(tokens))
        state, m = step_fn(state, torch.from_numpy(tokens))
        metrics.append((float(m["loss"]) - float(jmet["loss"]),
                        float(m["grad_norm"]) / float(jmet["grad_norm"]) - 1))
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                        device="cpu")
    gaps = {}
    adam, wadam = find_adam_state(state.opt_state), find_adam_state(want.opt_state)
    pairs = {"params": (state.params, want.params), "mu": (adam.mu, wadam.mu),
             "nu": (adam.nu, wadam.nu)}
    if hasattr(state.opt_state[0], "residual"):
        pairs["residual"] = (state.opt_state[0].residual,
                             want.opt_state[0].residual)
    for name, (a, b) in pairs.items():
        gaps[name] = max(float((x - y).abs().max())
                         for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return metrics, gaps, state


@pytest.mark.parametrize("spec", ["int8", {"error_feedback": True}],
                         ids=["int8", "error_feedback"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_compressed_steps_match_jax(family, spec):
    metrics, gaps, state = _steps(family, spec)
    assert all(abs(dl) <= 1e-5 and abs(dn) <= 1e-5 for dl, dn in metrics), metrics
    assert all(gaps[k] <= TOL[k] for k in gaps), gaps
    ef = isinstance(spec, dict)
    assert ("residual" in gaps) == ef
    assert isinstance(state.opt_state[0], EmptyState) != ef
    control = dict(spec if ef else {}, block_size=128)
    _, gaps, _ = _steps(family, spec, port_spec=control)
    assert any(gaps[k] > TOL[k] for k in gaps), gaps
