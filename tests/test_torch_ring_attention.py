"""The port's ring attention (``ray_tpu_torch.ops.ring_attention``) against
the JAX package's (``ray_tpu/ops/ring_attention.py`` under ``shard_map``
over four virtual CPU devices, as ``tests/test_ops.py`` runs it).

Four ranks over gloo (rank 0 here, three spawned once per module), each
holding a quarter of the sequence of q [2, 64, 4, 16] and k, v
[2, 64, 2, 16] (GQA group 2, fp32): every rank's output shard, and its
q/k/v gradients of sum(out**2) over the whole ring (the K/V gradients
travel back around the ring through ppermute's inverse), within 1e-5 of
JAX's (measured 2.4e-6 on gradients up to ~10), causal and not.  One
shard (no group) is plain attention: within 1e-5 of
``reference_attention``.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ray_tpu.ops.ring_attention import ring_attention as jax_ring
from ray_tpu.util.jax_compat import shard_map
from ray_tpu_torch.ops.attention import reference_attention
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.mesh import MeshSpec

torch.set_num_threads(1)

CP = 4
ATOL = 1e-5  # outputs up to ~3, gradients up to ~10 (fp32)


def _qkv():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((2, 64, h, 16)).astype(np.float32)
            for h in (4, 2, 2)]


def _rank_run(rank, port, qkv):
    """{causal: (output shard, [dq, dk, dv] shards)} on this rank."""
    # rank 0 serves the store at the address, the others connect
    mesh = MeshSpec(context=CP).build(rank=rank, address=f"127.0.0.1:{port}",
                                      name="ring")
    out = {}
    try:
        for causal in (True, False):
            q, k, v = (torch.from_numpy(a).chunk(CP, dim=1)[rank].clone()
                       .requires_grad_(True) for a in qkv)
            o = ring_attention(q, k, v, mesh.axis_group("context"),
                               causal=causal)
            grads = torch.autograd.grad((o ** 2).sum(), [q, k, v])
            out[causal] = (o.detach().numpy(), [g.numpy() for g in grads])
    finally:
        mesh.destroy()
    return out


def _spawned(rank, port, qkv, queue):
    torch.set_num_threads(1)
    try:
        queue.put((rank, _rank_run(rank, port, qkv)))
    except BaseException as e:
        queue.put((rank, e))
        raise


@pytest.fixture(scope="module")
def ranks():
    qkv = _qkv()
    ctx = torch.multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_spawned, args=(r, port, qkv, queue),
                         daemon=True) for r in range(1, CP)]
    for p in procs:
        p.start()
    try:
        res = {0: _rank_run(0, port, qkv)}
        for _ in procs:
            r, got = queue.get()
            if isinstance(got, BaseException):
                raise RuntimeError(f"rank {r} failed") from got
            res[r] = got
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
    return qkv, res


def _jax_ring(qkv, causal):
    mesh = Mesh(np.array(jax.devices()[:CP]), ("context",))
    fn = shard_map(
        lambda q, k, v: jax_ring(q, k, v, "context", causal=causal),
        mesh=mesh, in_specs=(P(None, "context"),) * 3,
        out_specs=P(None, "context"))
    q, k, v = (jnp.asarray(a) for a in qkv)
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: (fn(*a) ** 2).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.timeout(240)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax_forward_and_grads(ranks, causal):
    qkv, res = ranks
    want_o, want_g = _jax_ring(qkv, causal)
    for r in range(CP):
        got_o, got_g = res[r][causal]
        np.testing.assert_allclose(got_o, np.split(want_o, CP, axis=1)[r],
                                   rtol=0, atol=ATOL, err_msg=f"out {r}")
        for name, g, w in zip("qkv", got_g, want_g):
            np.testing.assert_allclose(g, np.split(w, CP, axis=1)[r], rtol=0,
                                       atol=ATOL, err_msg=f"d{name} {r}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_one_shard_is_plain_attention(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    got = ring_attention(q, k, v, None, causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
