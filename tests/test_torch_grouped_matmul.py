"""The port's grouped matmuls against jax's megablox kernels.

The plain versions of the port's CUDA kernels (``gmm_reference`` with and
without ``transpose_rhs``, ``tgmm_reference``) run against megablox's
``gmm`` and ``tgmm`` in interpret mode on the same seeded numpy inputs:
M=512, K=256, N=384, tiling (128, 128, 128), four groups of 100, 0, 290
and 122 rows (an empty group; boundaries inside tiles).  At fp32 they agree
to 1e-5 of the output's largest magnitude; at bf16 both round fp32 sums
of the same exact products once, so they agree within
``kernel_tolerance``.  The autograd Function matches ``jax.vjp`` through
``megablox.ops.gmm`` (the custom VJP), and an empty group's weight
gradient is exactly zero.

Then an emulation of the CUDA kernels' blocked summation (128-row tiles,
each group a tile touches run separately; the earlier kernels' 32-deep
steps and the TMA kernels' 64-deep ones, whose last tgmm step loads a
full 64 rows and zeroes those of the next group) stays within
``kernel_tolerance`` of the plain versions, and both negative controls
break it: a row moved across a group boundary (gmm), and one row of a
group left out (tgmm).  An inf in the next group's rows stays out of a
group's tgmm sum only when that tail is zeroed in both operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox import ops as mops

from ray_tpu_torch.ops import grouped_matmul as gm

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

mgmm = mops.backend  # the kernels' module (the package's `gmm` is ops.gmm)

M, K, N = 512, 256, 384
SIZES = np.array([100, 0, 290, 122], np.int32)
TILING = (128, 128, 128)
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(shape, seed, dtype):
    """(torch, jax) copies of the same seeded normal values in ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _sizes():
    return torch.from_numpy(SIZES.copy()), jnp.asarray(SIZES)


def _close(got, want, dtype, tol=None):
    got = got.float()
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if dtype == "fp32":
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    else:
        assert ((got - want).abs() <= tol).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_plain_gmm_matches_megablox(dtype, transpose_rhs):
    lhs, jlhs = _pair((M, K), 0, dtype)
    rhs, jrhs = _pair((4, N, K) if transpose_rhs else (4, K, N), 1, dtype)
    sizes, jsizes = _sizes()
    want = mgmm.gmm(jlhs, jrhs, jsizes, DTYPES[dtype][1], TILING,
                    transpose_rhs=transpose_rhs, interpret=True)
    got = gm.gmm_reference(lhs, rhs, sizes, transpose_rhs=transpose_rhs)
    assert got.dtype == lhs.dtype and got.shape == (M, N)
    tol = gm.kernel_tolerance("gmm", lhs, rhs, sizes, transpose_rhs=transpose_rhs)
    _close(got, want, dtype, tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_tgmm_matches_megablox(dtype):
    lhs, jlhs = _pair((M, K), 2, dtype)
    grad, jgrad = _pair((M, N), 3, dtype)
    sizes, jsizes = _sizes()
    want = mgmm.tgmm(jlhs.T, jgrad, jsizes, DTYPES[dtype][1], TILING,
                     interpret=True)
    got = gm.tgmm_reference(lhs.t(), grad, sizes)
    assert got.shape == (4, K, N)
    assert not got[1].any()  # the empty group
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, sizes)
    _close(got, want, dtype, tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_autograd_function_matches_the_megablox_vjp(dtype):
    lhs, jlhs = _pair((M, K), 4, dtype)
    rhs, jrhs = _pair((4, K, N), 5, dtype)
    ct, jct = _pair((M, N), 6, dtype)
    sizes, jsizes = _sizes()
    jdt = DTYPES[dtype][1]
    want, vjp = jax.vjp(lambda a, b: mops.gmm(a, b, jsizes, jdt, TILING, None,
                                              None, False, True), jlhs, jrhs)
    want_dlhs, want_drhs = vjp(jct)
    lhs.requires_grad_(True)
    rhs.requires_grad_(True)
    out = gm.grouped_matmul(lhs, rhs, sizes)
    dlhs, drhs = torch.autograd.grad(out, (lhs, rhs), ct)
    assert dlhs.dtype == lhs.dtype and drhs.dtype == rhs.dtype
    assert torch.equal(drhs[1], torch.zeros_like(drhs[1]))  # the empty group
    assert not np.asarray(want_drhs[1]).any()
    lhs, rhs = lhs.detach(), rhs.detach()
    _close(out.detach(), want, dtype, gm.kernel_tolerance("gmm", lhs, rhs, sizes))
    _close(dlhs, want_dlhs, dtype, gm.kernel_tolerance(
        "gmm", ct, rhs, sizes, transpose_rhs=True))
    _close(drhs, want_drhs, dtype, gm.kernel_tolerance("tgmm", lhs.t(), ct, sizes))


def _spans(sizes, m):
    ends = np.minimum(np.cumsum(np.maximum(sizes, 0)), m)
    return list(zip(np.concatenate([[0], ends[:-1]]), ends))


def _blocked_gmm(lhs, rhs, sizes, transpose_rhs=False, bm=128, bk=32):
    """The CUDA gmm kernel's arithmetic: per 128-row tile, each group it
    touches summed over K in ``bk``-deep fp32 steps, that group's rows
    kept, one rounding at the end."""
    m, k = lhs.shape
    out = torch.zeros((m, rhs.shape[1] if transpose_rhs else rhs.shape[2]))
    for m0 in range(0, m, bm):
        for g, (a, b) in enumerate(_spans(sizes, m)):
            lo, hi = max(a, m0), min(b, m0 + bm)
            if lo >= hi:
                continue
            w = rhs[g].float().T if transpose_rhs else rhs[g].float()
            acc = torch.zeros((min(bm, m - m0), out.shape[1]))
            for k0 in range(0, k, bk):
                acc += lhs[m0:m0 + bm, k0:k0 + bk].float() @ w[k0:k0 + bk]
            out[lo:hi] = acc[lo - m0:hi - m0]
    return out.to(lhs.dtype)


def _blocked_tgmm(lhs_t, grad, sizes, bm=32, zeroed=None):
    """The CUDA tgmm kernel's arithmetic: each group's rows in ``bm``-row
    fp32 steps from its first row, one rounding at the end; a group without
    rows gives zeros.  ``zeroed`` None: the last step holds the group's
    rows alone (the cp.async kernel's zero-filled copies).  Else the last
    step holds a full ``bm`` rows (up to M), and those at or past the
    group's end, the next group's, are zeroed in the operands ``zeroed``
    names ("lhs", "grad"), as the TMA kernel zeroes them in shared
    memory."""
    m = lhs_t.shape[1]
    out = []
    for a, b in _spans(sizes, m):
        acc = torch.zeros((lhs_t.shape[0], grad.shape[1]))
        for r in range(a, b, bm):
            e = min(r + bm, b if zeroed is None else m)
            x, y = lhs_t[:, r:e].float(), grad[r:e].float()
            if zeroed is not None:
                mine = torch.arange(r, e) < b
                if "lhs" in zeroed:
                    x = torch.where(mine[None, :], x, 0.0)
                if "grad" in zeroed:
                    y = torch.where(mine[:, None], y, 0.0)
            acc += x @ y
        out.append(acc)
    return torch.stack(out).to(grad.dtype)


def _ratio(got, want, tol):
    return ((got.float() - want.float()).abs() / tol).max().item()


# the earlier cp.async kernels' 32-deep stages and the TMA kernels' 64-deep
# ones
STAGES = pytest.mark.parametrize("bk", [32, 64])
BOTH = ("lhs", "grad")


@STAGES
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_blocked_gmm_within_tolerance_and_a_moved_row_breaks_it(transpose_rhs, bk):
    lhs, _ = _pair((M, K), 7, "bf16")
    rhs, _ = _pair((4, N, K) if transpose_rhs else (4, K, N), 8, "bf16")
    sizes, _ = _sizes()
    ref = gm.gmm_reference(lhs, rhs, sizes, transpose_rhs=transpose_rhs)
    tol = gm.kernel_tolerance("gmm", lhs, rhs, sizes, transpose_rhs=transpose_rhs)
    assert _ratio(_blocked_gmm(lhs, rhs, SIZES, transpose_rhs, bk=bk), ref, tol) <= 1
    # control: row 390, the first of group 3, computed with group 2's rhs
    moved = SIZES.copy()
    moved[2] += 1
    moved[3] -= 1
    row = int(SIZES[:3].sum())
    cut = _blocked_gmm(lhs, rhs, moved, transpose_rhs, bk=bk)
    assert _ratio(cut[row], ref[row], tol[row]) > 1
    keep = torch.ones(M, dtype=torch.bool)
    keep[row] = False
    assert _ratio(cut[keep], ref[keep], tol[keep]) <= 1


@pytest.mark.parametrize("bm,zeroed", [(32, None), (64, BOTH)],
                         ids=["32-deep", "64-deep-zeroed-tail"])
def test_blocked_tgmm_within_tolerance_and_a_dropped_row_breaks_it(bm, zeroed):
    lhs, _ = _pair((M, K), 9, "bf16")
    grad, _ = _pair((M, N), 10, "bf16")
    sizes, _ = _sizes()
    ref = gm.tgmm_reference(lhs.t(), grad, sizes)
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, sizes)
    assert _ratio(_blocked_tgmm(lhs.t(), grad, SIZES, bm, zeroed), ref, tol) <= 1
    # control: the last row of group 2 left out of its sum
    cut_grad = grad.clone()
    cut_grad[int(SIZES[:3].sum()) - 1] = 0
    cut = _blocked_tgmm(lhs.t(), cut_grad, SIZES, bm, zeroed)
    assert _ratio(cut[2], ref[2], tol[2]) > 1
    assert _ratio(cut[[0, 1, 3]], ref[[0, 1, 3]], tol[[0, 1, 3]]) <= 1


@pytest.mark.parametrize("zeroed", [BOTH, ("lhs",), ("grad",)])
def test_blocked_tgmm_tail_zeroes_both_operands_of_the_next_group(zeroed):
    # group 2's rows (100..389) hold inf in both operands; group 0 (rows
    # 0..99) ends inside a 64-row step, whose tail holds rows 100..127 of
    # group 2 (group 1 is empty).  Zeroed in both operands, the tail leaves
    # groups 0, 1 and 3 exact; zeroed in one, the other's inf meets the
    # zero as 0 * inf = nan
    sizes = np.array([100, 0, 290, 122], np.int32)
    lhs, _ = _pair((M, K), 16, "bf16")
    grad, _ = _pair((M, N), 17, "bf16")
    ref = gm.tgmm_reference(lhs.t(), grad, torch.from_numpy(sizes))
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, torch.from_numpy(sizes))
    lhs[100:390] = float("inf")
    grad[100:390] = float("inf")
    got = _blocked_tgmm(lhs.t(), grad, sizes, 64, zeroed)
    if zeroed == BOTH:
        assert torch.isfinite(got[[0, 1, 3]]).all()
        assert _ratio(got[[0, 1, 3]], ref[[0, 1, 3]], tol[[0, 1, 3]]) <= 1
    else:
        assert got[0].isnan().any()


def test_cpu_wrappers_run_the_plain_versions_without_a_launch():
    lhs, _ = _pair((M, K), 11, "bf16")
    rhs, _ = _pair((4, K, N), 12, "bf16")
    sizes, _ = _sizes()
    before = gm.gmm_launches, gm.tgmm_launches
    assert torch.equal(gm.gmm(lhs, rhs, sizes), gm.gmm_reference(lhs, rhs, sizes))
    grad = gm.gmm(lhs, rhs, sizes)
    assert torch.equal(gm.tgmm(lhs.t(), grad, sizes),
                       gm.tgmm_reference(lhs.t(), grad, sizes))
    assert (gm.gmm_launches, gm.tgmm_launches) == before
    # rows past the last group come out as zeros
    short = sizes.clone()
    short[3] -= 22
    assert not gm.gmm(lhs, rhs, short)[-22:].any()


def test_kernel_refusal_names_what_the_kernels_do_not_take():
    lhs, _ = _pair((M, K), 13, "bf16")
    rhs, _ = _pair((4, K, N), 14, "bf16")
    grad, _ = _pair((M, N), 15, "bf16")
    sizes, _ = _sizes()
    ok = [("gmm", lhs, rhs, sizes, {}), ("tgmm", lhs.t(), grad, sizes, {})]
    for op, x, y, s, kw in ok:  # everything but the device is right
        assert "CUDA" in gm.kernel_refusal(op, x, y, s, **kw)
    cases = [
        ("gmm", lhs.float(), rhs, sizes, {}, "bf16"),
        ("gmm", lhs, rhs, sizes.long(), {}, "int32"),
        ("gmm", lhs, rhs, sizes[:3], {}, "does not match"),
        ("gmm", lhs, rhs, sizes, {"transpose_rhs": True}, "does not match"),
        ("gmm", lhs[:, :250], rhs[:, :250], sizes, {}, "multiples of 8"),
        ("gmm", lhs[:, ::2], rhs[:, ::2], sizes, {}, "contiguous"),
        ("gmm", lhs, torch.zeros((65, K, N), dtype=torch.bfloat16),
         torch.zeros(65, dtype=torch.int32), {}, "1 to 64 groups"),
        ("tgmm", lhs.t().contiguous(), grad, sizes, {}, "transpose of a contiguous"),
        ("tgmm", lhs.t(), grad[:-1], sizes, {}, "grad"),
    ]
    for op, x, y, s, kw, match in cases:
        why = gm.kernel_refusal(op, x, y, s, **kw)
        assert why is not None and match in why, (match, why)
    with pytest.raises(ValueError, match="op"):
        gm.kernel_refusal("bmm", lhs, rhs, sizes)
