"""Optimizers as descriptions: what ``make_train_step(optimizer=...)`` takes.

The JAX package hands ``make_train_step`` an optax ``GradientTransformation``.
The port takes a description of one instead: a frozen dataclass holding the
hyperparameters and dtypes, with ``init(params)`` and ``update(params,
grads, state)`` written as tensor arithmetic.  ``adamw`` has optax's
signature and defaults (``mask`` and ``nesterov`` are not ported).

``AdamW`` is optax's ``chain(scale_by_adam, add_decayed_weights,
scale_by_learning_rate)``, with optax's order of operations and rounding
points.  Every operation rounds to its result dtype, which follows JAX's
promotion: a Python scalar takes the dtype of the tensor it meets, so each
scalar is rounded to that dtype first (``_scalar``).

    mu  = (1 - b1) * g + b1 * mu                  # dtype: g's and mu's, promoted
    nu  = (1 - b2) * g**2 + b2 * nu               # the params' dtype
    u   = (mu / bc1) / (sqrt(nu / bc2 + eps_root) + eps)
    u   = u + weight_decay * p                    # add_decayed_weights
    u   = -learning_rate * u                      # scale_by_learning_rate
    p   = (p + u).to(p.dtype)                     # optax.apply_updates

with ``bc = 1 - b**count`` in fp32, cast to each moment's dtype before the
division.  mu is stored in ``mu_dtype`` after the update has used it (None
keeps the params' dtype, as optax does); nu in the params' dtype.

Its state nests as optax's chain: ``(AdamState(count, mu, nu),
EmptyState(), EmptyState())``, so a JAX state carries over leaf for leaf
(``convert``) and a snapshot's keys are the JAX package's
(``opt_state/0/mu/...``).  The state is updated IN PLACE (JAX donates it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: count (int32 scalar), mu and nu shaped
    like the params (mu in ``mu_dtype``, nu in the params' dtype)."""
    count: torch.Tensor
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax ``EmptyState``: the state of a stateless transform."""


def _scalar(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX uses it against a ``dtype`` tensor: rounded
    to that dtype first (weak typing)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


SLICE = 1 << 24  # elements a slice of an elementwise update works on


def flat_slices(t: torch.Tensor, size: int = SLICE):
    """Views of ``t``'s elements in runs of ``size`` (``t`` contiguous):
    writing into them writes into ``t``."""
    flat = t.view(-1)
    return [flat[i:i + size] for i in range(0, max(flat.numel(), 1), size)]


def find_adam_state(opt_state) -> Optional[AdamState]:
    """The ``AdamState`` inside an optimizer state's chain nesting (the
    first node with count, mu and nu), or None."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = find_adam_state(s)
            if found is not None:
                return found
    return None


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax ``adamw`` as a description (built by :func:`adamw`)."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    mu_dtype: Optional[torch.dtype] = None
    weight_decay: float = 1e-4

    def init(self, params) -> tuple:
        """optax's chain state: (AdamState, EmptyState, EmptyState)."""
        dev = tree_leaves(params)[0].device
        adam = AdamState(
            torch.zeros((), dtype=torch.int32, device=dev),
            tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype),
                     params),
            tree_map(torch.zeros_like, params))
        return (adam, EmptyState(), EmptyState())

    @torch.no_grad()
    def update(self, params, grads, state: tuple) -> None:
        """One step, in place on ``params`` and ``state``; ``grads`` in
        ``tree_leaves`` order."""
        adam = state[0]
        adam.count.add_(1)
        t = adam.count.float()
        bc1 = 1 - self.b1 ** t  # fp32 on the device: no host sync
        bc2 = 1 - self.b2 ** t
        for p, g, mu, nu in zip(tree_leaves(params), grads,
                                tree_leaves(adam.mu), tree_leaves(adam.nu)):
            # elementwise, so a leaf goes in slices: the same numbers, with
            # the temporaries of one slice alive (a Mixtral expert stack is
            # 3.8 GB a temporary in fp32)
            for slices in zip(flat_slices(p), flat_slices(g.contiguous()),
                              flat_slices(mu), flat_slices(nu)):
                self._update_slice(*slices, bc1, bc2)

    def _update_slice(self, p, g, mu, nu, bc1, bc2) -> None:
        m = self._moment(g, mu, self.b1)
        v = self._moment(g * g, nu, self.b2)  # nu's dtype: written in place
        m_hat = m / bc1.to(m.dtype)
        v_hat = v / bc2.to(v.dtype)
        if self.eps_root:
            v_hat = v_hat + _scalar(self.eps_root, v_hat.dtype)
        u = m_hat / (torch.sqrt(v_hat) + _scalar(self.eps, v_hat.dtype))
        u = u + p * _scalar(self.weight_decay, p.dtype)
        u = u * _scalar(-self.learning_rate, u.dtype)
        p.add_(u)  # the promoted sum, rounded once to p's dtype
        if m is not mu:
            mu.copy_(m)  # cast to mu_dtype after the update used m

    @staticmethod
    def _moment(g, moment, decay: float):
        """optax ``update_moment``: (1 - decay) * g + decay * moment, each
        product in its operand's dtype, the sum promoted; written into
        ``moment`` when that is the sum's dtype."""
        a = g * _scalar(1 - decay, g.dtype)
        b = moment * _scalar(decay, moment.dtype)
        if torch.promote_types(a.dtype, b.dtype) == moment.dtype:
            return torch.add(a, b, out=moment)
        return a + b


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None,
          weight_decay: float = 1e-4) -> AdamW:
    """optax ``adamw`` (same signature and defaults, without ``mask`` and
    ``nesterov``) as a description for ``make_train_step(optimizer=...)``.
    ``learning_rate`` is a number: schedules are not ported."""
    if callable(learning_rate) or not isinstance(learning_rate, (int, float)):
        raise TypeError(f"adamw takes a number for learning_rate (got "
                        f"{type(learning_rate).__name__}): schedules are not "
                        f"ported")
    return AdamW(float(learning_rate), b1, b2, eps, eps_root, mu_dtype,
                 weight_decay)
