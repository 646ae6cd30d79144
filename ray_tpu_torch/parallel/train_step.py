"""Training-step builder for the Llama and MoE families.

Port of ``ray_tpu/parallel/train_step.py:make_train_step``:
``init_fn(generator) -> TrainState`` and ``step_fn(state, tokens) ->
(state, metrics)``.  The optimizer is a description (``parallel.optim``):
``optim.adamw(...)`` with optax's signature, by default the JAX builder's
``adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=float32)``.
``grad_compression`` chains the int8 block codec
(``util.collective.compression.compress_gradients``) before it, as the JAX
builder chains its optax transform; ``grad_norm`` stays the norm of the
uncompressed gradients.  Over a mesh that shards the params each rank
codes its shard as the JAX codec codes the logical leaf (``ShardLayout``:
the blocks of the leaf's flattened form, a block's scale from its
largest element on any rank).

The optimizer state nests as optax's chain: ``(AdamState, EmptyState,
EmptyState)``, under compression ``(EmptyState or ResidualState, (AdamState,
EmptyState, EmptyState))``.  So a JAX state carries across leaf for leaf
(``convert``), and a snapshot's keys are the JAX package's.  JAX donates the
state to the jitted step; here ``step_fn`` updates it IN PLACE and returns
the same tensors.

Over a mesh: the JAX step is one SPMD program whose collectives GSPMD
inserts from ``param_specs``; here every rank runs ``step_fn`` on its own
shards (``parallel.mesh``: one process per rank) and the collectives are
written out.  Inside the loss: fsdp's per-layer weight gathers, the tensor
axis's Megatron sums, ring attention over "context", the pipeline's
handoffs, MoE's token exchange over "expert" (``parallel.functional``,
each with its transpose).  After the backward, each gradient leaf is
summed over the axes its computation was split over and it is not sharded
on: the batch axes ("data" and "fsdp", and for MoE "expert", each one the
leaf is not sharded on; an fsdp-sharded leaf got its fsdp sum from its
gather's reduce-scatter), "context" under ``context_parallel`` (Llama),
and "pipeline" for the leaves every stage holds.  ``grad_norm`` is the
norm of the global gradient: each leaf's square sum reduced over the axes
it is sharded on only.  ``overlap_grad_sync`` starts each ``partition_buckets``
bucket's batch-axes reduction (asynchronously, from the leaves' gradient
hooks) as soon as the backward has produced the bucket, last layer first,
and waits for all of them before the optimizer; the sums are the fused
sync's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.llm.engine import resolve_device
from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.ops.attention import flash_config_refusal
from ray_tpu_torch.parallel.optim import AdamW, adamw


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: Any
    opt_state: Any


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square."""
    return torch.sqrt(sum(torch.sum(t.float().square()) for t in tensors))


def _model_module(cfg):
    """Model-family dispatch: each module exposes init_params /
    train_param_dtypes / loss_fn / flops_per_token."""
    if isinstance(cfg, moe.MoEConfig):
        return moe
    if isinstance(cfg, llama.LlamaConfig):
        return llama
    raise TypeError(f"make_train_step takes a LlamaConfig or an MoEConfig "
                    f"(got {type(cfg).__name__})")


def _train_specs(cfg, mesh):
    """The params' partition specs on ``mesh`` (None without one)."""
    if mesh is None:
        return None
    if isinstance(cfg, moe.MoEConfig):
        moe._refuse_pipeline(mesh)
        return moe.param_specs(cfg)
    if mesh.shape["pipeline"] > 1:
        from ray_tpu_torch.parallel.pipeline import pipeline_param_specs

        return pipeline_param_specs(cfg)
    return llama.param_specs(cfg)


def _spec_leaves(specs) -> list:
    """The specs of a params tree in ``tree_leaves`` order (a spec is a
    tuple, which the tree functions would walk into)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def _leaf_plan(specs, mesh, context_parallel: bool, batch_axes) -> list:
    """Per params leaf (``tree_leaves`` order): (sharded axes, the batch
    group its gradient sums over -- the ``batch_axes`` it is not sharded
    on -- or None, the further groups it sums over after the backward)."""
    from ray_tpu_torch.parallel.mesh import sharded_axes

    plan = []
    for spec in _spec_leaves(specs):
        axes = sharded_axes(spec)
        key = tuple(a for a in batch_axes if a not in axes)
        batch = mesh.axis_group(key[0] if len(key) == 1 else key)
        rest = []
        if context_parallel and mesh.axis_group("context") is not None:
            rest.append(mesh.axis_group("context"))
        if "pipeline" not in axes and mesh.axis_group("pipeline") is not None:
            rest.append(mesh.axis_group("pipeline"))
        plan.append((axes, batch, rest))
    return plan


def _sharded_norm(grads, plan, mesh, masks: dict) -> torch.Tensor:
    """The global gradient's norm from this rank's shards: each leaf's
    square sum, summed over the axes the leaf is sharded on (a leaf
    replicated over an axis is counted once), then the leaves' sums added
    in leaf order, as ``global_norm`` adds them.  ``masks`` caches each
    axis's leaf mask on the device (made once: a host copy waits)."""
    sq = torch.stack([torch.sum(g.float().square()) for g in grads])
    for axis in ("pipeline", "fsdp", "expert", "tensor"):
        group = mesh.axis_group(axis)
        if group is None:
            continue
        if axis not in masks:
            masks[axis] = torch.tensor([axis in axes for axes, _, _ in plan],
                                       device=sq.device)
        mask = masks[axis]
        part = group.allreduce_(torch.where(mask, sq, 0.0))
        sq = torch.where(mask, part, sq)
    total = sq[0]
    for x in sq[1:]:
        total = total + x
    return torch.sqrt(total)


class _Overlap:
    """Bucketed batch-axes gradient sync, started from gradient hooks: a
    bucket's leaves flattened per group (``bucketing.flatten_bucket``) and
    all-reduced asynchronously once the backward has produced all of them
    and every bucket before it has started (buckets start in
    ``partition_buckets`` order, so every rank issues the same sequence,
    as DDP does).  ``launched`` records the order."""

    def __init__(self, buckets, plan):
        self.buckets, self.plan = buckets, plan
        self.where = {i: k for k, b in enumerate(buckets) for i in b}

    def start(self, leaves):
        for h in getattr(self, "handles", ()):  # a step that raised
            h.remove()
        self.grads, self.works, self.launched = {}, [], []
        self.left = [len(b) for b in self.buckets]
        self.handles = [p.register_hook(self._hook(i))
                        for i, p in enumerate(leaves)]

    def _hook(self, i):
        def hook(g):
            self.grads[i] = g
            self.left[self.where[i]] -= 1
            self._launch_ready()
            return g
        return hook

    def _launch_ready(self):
        from ray_tpu_torch.parallel.bucketing import flatten_bucket

        while (len(self.launched) < len(self.buckets)
               and self.left[len(self.launched)] == 0):
            k = len(self.launched)
            self.launched.append(k)
            by_group = {}
            for i in self.buckets[k]:
                group = self.plan[i][1]
                if group is not None:
                    by_group.setdefault(id(group), (group, []))[1].append(i)
            for group, idx in by_group.values():
                flat, splits = flatten_bucket(self.grads, tuple(idx))
                flat = flat.contiguous()
                self.works.append((group.allreduce_async_(flat), flat,
                                   tuple(idx), splits))

    def finish(self, grads: list) -> list:
        """The reduced gradients; buckets the hooks did not complete (a
        leaf this rank's loss does not read) start now, in order."""
        from ray_tpu_torch.parallel.bucketing import unflatten_bucket

        for h in self.handles:
            h.remove()
        for i, g in enumerate(grads):
            if i not in self.grads:
                self.grads[i] = g
                self.left[self.where[i]] -= 1
        self._launch_ready()
        out = list(grads)
        for work, flat, idx, splits in self.works:
            work.wait()
            for i, g in unflatten_bucket(flat, idx, splits, grads).items():
                out[i] = g
        return out


def make_train_step(cfg, mesh=None, *, optimizer=None,
                    learning_rate: float = 3e-4, context_parallel: bool = False,
                    loss: Optional[Callable] = None,
                    pipeline_microbatches: Optional[int] = None,
                    grad_compression=None, overlap_grad_sync: bool = False,
                    bucket_bytes: int = 4 << 20, device=None) -> tuple:
    """Returns (init_fn, step_fn) for a ``LlamaConfig`` or an ``MoEConfig``.

    init_fn(generator) -> TrainState: random params (the family's
    ``init_params``, stored as its ``train_param_dtypes`` say: fp32 master
    weights by default, ``cfg.param_dtype`` throughout) and the optimizer's
    zero state, on ``device`` (default CUDA; without a GPU that raises --
    pass ``device="cpu"``).
    step_fn(state, tokens) -> (TrainState, metrics dict): metrics "loss",
    "grad_norm" (of the grads before compression and the update) and
    "step", as 0-dim tensors on the device.  The state is updated in place.

    ``optimizer`` is None (the JAX builder's default AdamW, at
    ``learning_rate``) or an ``optim.adamw(...)`` description, which
    carries its own learning rate.  ``grad_compression`` ('int8', 'none',
    a dict of ``CompressionSpec`` fields or a spec) codes each gradient
    leaf before the optimizer.  ``loss`` takes the JAX signature ``(cfg,
    params, tokens, *, mesh, context_parallel, rope_cache)``.  A config
    whose attention would reach a flash kernel that is not built
    (``ops.attention.flash_config_refusal``) raises before any step.

    With ``mesh`` (this rank's ``parallel.mesh.Mesh``): ``init_fn`` draws
    the same full params on every rank, tensor by tensor, and keeps this
    rank's shards (the family's ``param_specs``, or
    ``pipeline.pipeline_param_specs`` on a pipeline axis), the optimizer
    state shaped like them; ``step_fn`` takes the GLOBAL [B, S] batch, as
    the JAX step does, and returns the global loss and ``grad_norm`` on
    every rank.  A pipeline axis above one takes
    ``make_pipeline_loss(pipeline_microbatches or 2 * pp)`` unless
    ``loss`` is given (Llama; MoE refuses it, as the JAX builder does).
    MoE splits the batch over "data", "fsdp" and "expert" and ignores
    ``context_parallel``, as the JAX model does.  Without a mesh
    ``overlap_grad_sync`` has nothing to sync (the JAX stage is an
    identity) and ``pipeline_microbatches`` is unread, as in the JAX
    builder."""
    model = _model_module(cfg)
    if mesh is not None:
        from ray_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"make_train_step takes a parallel.mesh.Mesh "
                            f"(got {type(mesh).__name__})")
    if optimizer is None:
        optimizer = adamw(learning_rate, b1=0.9, b2=0.95, weight_decay=0.1,
                          mu_dtype=torch.float32)
    if not isinstance(optimizer, AdamW):
        raise TypeError(
            f"make_train_step takes optimizer=None or an optimizer description "
            f"from ray_tpu_torch.parallel.optim.adamw (got "
            f"{type(optimizer).__name__})")
    pp = mesh.shape["pipeline"] if mesh is not None else 1
    if model is moe:
        moe._refuse_pipeline(mesh)
        context_parallel = False  # the model ignores it: no "context" sum
    if pp > 1 and loss is None:
        from ray_tpu_torch.parallel.pipeline import make_pipeline_loss

        loss = make_pipeline_loss(pipeline_microbatches or 2 * pp)
    specs = _train_specs(cfg, mesh)
    compress = None
    if grad_compression is not None:
        from ray_tpu_torch.util.collective.compression import compress_gradients

        compress = compress_gradients(grad_compression)
    llama._check_training(cfg)  # remat policy, early
    # groups present, early
    if model is llama:
        llama.shard_context(mesh, context_parallel)
    else:
        moe.shard_context(mesh)
    refusal = flash_config_refusal(cfg, "cuda" if device is None else device)
    if refusal:
        raise NotImplementedError(f"make_train_step: {refusal}")
    dev = resolve_device(device)
    rope = llama.rope_cache(cfg, cfg.max_seq_len, dev)
    from ray_tpu_torch.parallel.mesh import BATCH_AXES, MOE_BATCH_AXES

    batch_axes = MOE_BATCH_AXES if model is moe else BATCH_AXES
    plan = (_leaf_plan(specs, mesh, context_parallel, batch_axes) if mesh
            else None)
    masks = {}
    overlap = layouts = None
    if mesh is not None and (overlap_grad_sync or compress is not None):
        # the full (logical) shapes, as the JAX builder's eval_shape
        shapes = model.init_params(cfg, None, "meta",
                                   model.train_param_dtypes(cfg))
    if overlap_grad_sync and mesh is not None:
        from ray_tpu_torch.parallel.bucketing import partition_buckets

        # every rank derives the same partition
        overlap = _Overlap(partition_buckets(shapes, bucket_bytes), plan)
    if compress is not None and mesh is not None:
        from ray_tpu_torch.util.collective.compression import shard_layout

        layouts = [shard_layout(tuple(t.shape), spec, mesh)
                   for t, spec in zip(tree_leaves(shapes),
                                      _spec_leaves(specs))]

    def init_fn(generator: torch.Generator) -> TrainState:
        kw = {}
        if mesh is not None:
            from ray_tpu_torch.parallel.mesh import shard_slice

            def place(path, t):
                spec = specs
                for k in path:
                    spec = spec[k]
                part = shard_slice(t, spec, mesh)
                return t if part is t else part.clone(
                    memory_format=torch.contiguous_format)

            kw["place"] = place
        params = model.init_params(cfg, generator, dev,
                                   model.train_param_dtypes(cfg), **kw)
        opt_state = optimizer.init(params)
        if compress is not None:
            opt_state = (compress.init(params), opt_state)
        return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                          params, opt_state)

    def grads_of(params, tokens):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if overlap is not None:
                overlap.start(leaves)
            loss_val = (loss or model.loss_fn)(
                cfg, params, tokens, mesh=mesh,
                context_parallel=context_parallel, rope_cache=rope)
            grads = torch.autograd.grad(loss_val, leaves,
                                        allow_unused=mesh is not None)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if mesh is None:
            return loss_val, list(grads), global_norm(grads)
        # a leaf this rank's loss does not read (the embedding off the
        # first pipeline stage) has a zero gradient here
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if overlap is not None:
            grads = overlap.finish(grads)
        for i, (_, batch, rest) in enumerate(plan):
            groups = ([] if overlap is not None else [batch]) + rest
            for group in groups:
                if group is not None:
                    grads[i] = group.allreduce_(grads[i].contiguous())
        return loss_val, grads, _sharded_norm(grads, plan, mesh, masks)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        if mesh is not None:
            tokens = tokens.to(dev)
        loss_val, grads, grad_norm = grads_of(state.params, tokens)
        opt_state = state.opt_state
        if compress is not None:
            grads = compress.update(grads, opt_state[0], layouts)
            opt_state = opt_state[1]
        optimizer.update(state.params, grads, opt_state)
        state.step.add_(1)
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss_val.detach(), "grad_norm": grad_norm,
            "step": state.step.clone()}
        return state, metrics

    # the bucketed sync (None without it): its ``launched`` bucket order
    step_fn.overlap = overlap
    return init_fn, step_fn
