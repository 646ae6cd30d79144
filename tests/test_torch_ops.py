"""The port's plain ops against the JAX package's, on the same inputs.

Inputs come from seeded numpy.  Tolerances: fp32 atol 1e-6 (same formula,
another summation order at most); bf16 atol 1e-2 (both round the fp32
result to bf16, one ulp near 1 is 2**-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rope as trope

# tiny shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores that timing-sensitive tests share
torch.set_num_threads(1)

_DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-6),
           "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _both(x: np.ndarray, name: str):
    jdt, tdt, _ = _DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("scaling", [None, {
    "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    "original_max_position": 64}])
def test_rope_frequencies_equal(scaling):
    jc, js = jrope.rope_frequencies(64, 256, 500000.0, scaling)
    tc, ts = trope.rope_frequencies(64, 256, 500000.0, scaling)
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(js, ts)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("per_batch", [False, True])
def test_apply_rope_matches(per_batch, dtype):
    rng = np.random.default_rng(0)
    b, s, h, d = 3, 5, 4, 32
    cos, sin = jrope.rope_frequencies(d, 64)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    jx, tx = _both(x, dtype)
    if per_batch:
        pos = rng.integers(0, 64, size=(b, s)).astype(np.int32)
        want = jrope.apply_rope(jx, jnp.asarray(cos), jnp.asarray(sin),
                                positions=jnp.asarray(pos))
        got = trope.apply_rope(tx, torch.from_numpy(cos),
                               torch.from_numpy(sin),
                               positions=torch.from_numpy(pos).long())
    else:
        want = jrope.apply_rope(jx, jnp.asarray(cos), jnp.asarray(sin))
        got = trope.apply_rope(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    assert got.dtype == _DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((4, 7, 96))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    jx, tx = _both(x, dtype)
    want = jnorms.rms_norm(jx, jnp.asarray(w), 1e-5)
    got = tnorms.rms_norm(tx, torch.from_numpy(w), 1e-5)
    assert got.dtype == _DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_DTYPES[dtype][2])
