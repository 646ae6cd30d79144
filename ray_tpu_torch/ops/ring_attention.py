"""Ring attention: exact attention over a context-parallel mesh axis.

Port of ``ray_tpu/ops/ring_attention.py``.  Each rank of the ``context``
group holds a sequence shard of Q, K and V; the K/V shards rotate around
the ring (``parallel.functional.ppermute``, rank i sending to i + 1), and
the partial outputs merge by the online-softmax rule.  The ppermute's
backward is the inverse permutation, so autograd gives the reversed ring
for the gradients, as ``lax.ppermute``'s transpose does in the JAX
function.

The JAX function is plain jnp (no Pallas kernel), and so is this one:
plain torch products at JAX's rounding points -- scores from the input
dtype's operands accumulated and kept in fp32, probabilities cast to v's
dtype before the PV product, accumulated in fp32.  Offsets are the global
sequence positions of each shard's first element.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.parallel import functional as _fn

_NEG_INF = -1e30


def _repeat_heads(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D] (each kv head n_rep times)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _chunk_attention(q, k, v, q_offset: int, k_offset: int, causal: bool,
                     scale: float):
    """Partial attention of a Q shard against one K/V shard.

    q: [B, Sq, H, D]; k, v: [B, Sk, Hkv, D].  Returns (o_unnorm, m, l):
    o_unnorm [B, Sq, H, D] fp32 (the sum of exp(s - m) @ v), m and l
    [B, Sq, H, 1] fp32."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_heads(k, n_rep)
    v = _repeat_heads(v, n_rep)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    s = (qh.float() @ kh.float().transpose(-1, -2)) * scale  # [B, H, Sq, Sk]
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        mask = qpos >= kpos
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
        m = s.amax(-1, keepdim=True)
        # a fully masked row gets p == 0, not exp(0)
        p = torch.where(mask, torch.exp(s - m),
                        torch.zeros((), device=q.device))
    else:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = p.to(v.dtype).float() @ vh.float()  # [B, H, Sq, D]
    return o.transpose(1, 2), m.transpose(1, 2), l.transpose(1, 2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over sequence shards held by ``group``'s members
    (a ``parallel.mesh.TensorGroup``; None: one shard, plain attention).

    q, k, v: this rank's shards [B, S_local, H(kv), D]; the global sequence
    is the shards concatenated in member order.  Returns this rank's output
    shard [B, S_local, H, D] in q's dtype."""
    n = group.size if group is not None else 1
    idx = group.rank if group is not None else 0
    b, s_local, hq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    q_offset = idx * s_local
    dev = q.device
    o = torch.zeros((b, s_local, hq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, s_local, hq, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, s_local, hq, 1), dtype=torch.float32, device=dev)
    kv = (k, v)
    perm = _fn.ring_perm(n)
    for step in range(n):
        src = (idx - step) % n  # whose K/V shard this rank holds now
        o_p, m_p, l_p = _chunk_attention(q, kv[0], kv[1], q_offset,
                                         src * s_local, causal, scale)
        m_new = torch.maximum(m, m_p)
        alpha = torch.exp(m - m_new)
        alpha_p = torch.exp(m_p - m_new)
        o = o * alpha + o_p * alpha_p
        l = l * alpha + l_p * alpha_p
        m = m_new
        if step != n - 1:
            kv = _fn.ppermute(kv, group, perm)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)
