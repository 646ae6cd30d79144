"""Pipeline parallelism: layer stages over the ``pipeline`` mesh axis.

Port of ``ray_tpu/parallel/pipeline.py``, one process per rank:

  - the stacked layer params [L, ...] shard their leading dim over
    ``pipeline`` (``pipeline_param_specs``): stage p owns layers
    [p*L/pp, (p+1)*L/pp);
  - the GPipe schedule is the JAX function's tick loop: M + pp - 1 ticks,
    on each every stage applies its layer block (checkpointed per tick:
    only the activations between ticks live across the forward) and hands
    its output to the next stage with ``functional.ppermute`` (ring
    i -> i + 1);
  - the BACKWARD schedule comes from autograd: ppermute's backward is the
    inverse permutation, so the reversed pipeline needs no hand-written
    1F1B state machine.  A process's autograd sees only its own graph, so
    every tick's ppermute output enters each rank's loss with weight 0:
    every rank then runs every ppermute's backward, in the same (reversed)
    order, as every device runs the JAX program's transpose;
  - stage 0 embeds microbatch t at tick t; the last stage scores the
    microbatch leaving it (entered at t - (pp - 1)) with the head and the
    cross-entropy; the loss and its count are summed over the stages.
    Within a stage the data, fsdp and tensor axes run as
    ``models.llama``'s forward runs them.

Where the JAX program computes the embedding and the head on every stage
and masks them, a rank here computes them only where its stage reads them
(stage 0, and the last stage at its scored ticks): the same values and
gradients, without the masked work.  The embedding, final norm and head
are replicated over ``pipeline``; their gradients are summed over the
stages by the train step.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import functional as _fn


def pipeline_param_specs(cfg) -> dict:
    """llama param_specs with the stacked-layer dim sharded by stage."""
    specs = llama.param_specs(cfg)
    specs["layers"] = {k: ("pipeline",) + tuple(s)[1:]
                       for k, s in specs["layers"].items()}
    return specs


def make_pipeline_loss(num_microbatches: int):
    """A drop-in ``loss`` for ``make_train_step`` running the GPipe
    schedule.

    Signature matches ``llama.loss_fn``: (cfg, params, tokens, *, mesh,
    context_parallel, rope_cache, loss_mask) -> scalar, the same on every
    rank.  ``tokens`` is the GLOBAL batch; it is split into
    ``num_microbatches`` along dim 0, and each microbatch over the batch
    axes.  ``params`` are this rank's shards by ``pipeline_param_specs``."""

    def loss(cfg, params, tokens, *, mesh, context_parallel=False,
             rope_cache=None, loss_mask=None):
        if context_parallel:
            raise NotImplementedError(
                "context parallelism inside pipeline stages is not wired yet "
                "(use context= on a pipeline=1 mesh)")
        if loss_mask is not None:
            raise NotImplementedError("loss_mask with pipeline parallelism")
        pp = mesh.shape["pipeline"]
        m = num_microbatches
        b, s = tokens.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        if cfg.n_layers % pp:
            raise ValueError(
                f"n_layers={cfg.n_layers} not divisible by pipeline={pp}")
        mesh.check_groups(["pipeline"])
        sh = llama.shard_context(mesh)
        group = mesh.axis_group("pipeline")
        stage = mesh.coords["pipeline"]
        if rope_cache is None:
            rope_cache = llama.rope_cache(cfg, cfg.max_seq_len, tokens.device)
        cos, sin = rope_cache[0][:s], rope_cache[1][:s]
        mb = b // m
        if mb % sh.nb:
            raise ValueError(
                f"microbatch {mb} does not divide over {sh.nb} batch ranks")
        rows = mb // sh.nb
        # microbatch t's rows on this rank: its block over the batch axes
        tokens_mb = tokens.reshape(m, mb, s)[
            :, sh.b_rank * rows:(sh.b_rank + 1) * rows]
        names = sorted(params["layers"])
        leaves = [params["layers"][k] for k in names]

        def stage_block(x, *stacked):
            for layer in zip(*(t.unbind(0) for t in stacked)):
                x = llama._layer(cfg, x, dict(zip(names, layer)), cos, sin, sh)
            return x

        perm = _fn.ring_perm(pp)
        buf = torch.zeros((rows, s, cfg.dim), dtype=cfg.compute_dtype,
                          device=tokens.device)
        nll_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        tie = torch.zeros((), dtype=torch.float32, device=tokens.device)
        # the first stage's embedding rows and the last's head, gathered
        # over fsdp once a step (their gradients reduce-scattered once)
        table = llama.embed_table(params, sh) if stage == 0 else None
        head = (llama.head_weight(cfg, params, sh) if stage == pp - 1
                else None)
        for t in range(m + pp - 1):
            if stage == 0:
                x = llama.embed_tokens(cfg, table, tokens_mb[min(t, m - 1)],
                                       sh)
            else:
                x = buf
            y = checkpoint(stage_block, x, *leaves, use_reentrant=False,
                           preserve_rng_state=False)
            # the microbatch leaving the LAST stage at tick t entered at
            # tick t - (pp - 1)
            mb_id = t - (pp - 1)
            if stage == pp - 1 and 0 <= mb_id < m:
                tok = tokens_mb[mb_id]
                logits = llama.head_logits(cfg, params, y, head, sh)
                nll_sum = nll_sum + llama.token_nll(
                    logits[:, :-1], tok[:, 1:], sh).mean()
            buf = _fn.ppermute(y, group, perm)
            tie = tie + buf.float().sum() * 0.0
        total = _fn.psum(_fn.psum(nll_sum, sh.batch), group)
        return total / (m * sh.nb) + tie

    return loss
