"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) when it fails:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
  2. build: compiles every kernel under ray_tpu_torch/ops/csrc with nvcc
  3. the paged decode kernel: first its design in the built library's
     SASS (TMA loads, mbarriers and mma.sync in the decode path's
     instantiation) and ptxas's registers and spills; then kernel vs plain
     at three shapes with Llama-3-8B's heads in one 4,608-block pool of
     32 layers (NaN in every dead page, in sink block 0 and in the tail of
     every row's last live page): (a) the decode batch, B=8 with ragged
     spans of 1-1,501 tokens, (b) one row at the full 8,192-token context,
     (c) B=32 with spans from the seed in 129-2,048; each within
     ``kernel_tolerance``, which must break (checked) when the last token
     of the longest row is dropped and when the last token of a span
     ending on a split boundary is; repeat calls bit-identical; times
     (one launch per layer in turn, 32 calls captured in a CUDA graph and
     replayed; beside them the kernel's eager time per call and its device
     time per launch): kernel, plain version, SDPA on the pre-gathered
     span, and the bound; then one call under
     torch.cuda.set_sync_debug_mode("error"); then the same checks at the
     speculative draft's shape, (d): Llama-3.2-1B's heads (head_dim 64,
     32 q over 8 kv heads, 16 layers) at (a)'s spans
  4. the paged engine serving Llama-3-8B (full width and depth, random
     bf16 weights from a seeded generator): ``warmup`` captures the decode
     chunk as one CUDA graph per table width (1-128) and the prefill
     chunk as one per chunk width (16-256; the widths, seconds and both
     graph pools' bytes are printed); 10 requests to 64 tokens each, the
     kernel's launches (booked per graph replay) counted against the
     decode token steps; then a measured run for prefill and decode
     tokens/s and each request's time to first token, with the graphs'
     device time per token step (CUDA events around each replay, and
     replays back to back) and the prefill graphs' busy share; then the
     same run through an eager twin sharing the weights: greedy tokens
     identical, both sides printed; prefill's device busy share by
     torch.profiler on both; then a profile of three engine steps
  5. one decode step with the kernel and with the table gather on the
     same engine state (before the measured decode): the logits must agree
 4m. on phase 4's weights: (a) the host-RAM prefix tier at its 64 MiB
     default: a prompt's 480-token prefix is demoted from a 266-block
     pool by eight live prompts and revived for a second prompt; the
     demoted and the revived blocks bit-equal to the pool's, the second
     prompt's tokens within the floor check (below, 4s) beside an engine
     without the tier; demotion and upload ms per block (host and
     device), its time to first token with revival and with recompute;
     (b) live migration: phase 4's 8 measured prompts decode, and at 16
     tokens two are exported into a second engine, (c) two into a
     self-draft speculative engine whose draft is re-seeded on import;
     imported blocks bit-equal to the payload, the 8 stitched streams
     within the floor check, which a payload with K and V swapped must
     break; re-seeded acceptance at least 0.5; payload MB and export and
     import ms
 4s. speculative decoding on phase 4's weights (k = 4), with (a) a
     Llama-3.2-1B-width draft (random, seeded) and (b) the target as its
     own draft: ``warmup`` captures propose, verify and the 5-step plain
     chunk per table width (1-128); phase 4's measured prompts; tokens/s,
     acceptance, device ms per propose and per verify replay (CUDA
     events), idle share, capture seconds and graph pool bytes, beside
     phase 4's rate; B1's launches = 32 x plain token steps + the draft's
     layers x 5 x cycles; self-draft acceptance at least 0.5.  Greedy
     check, teacher-forced on each request's own stream: one flash
     prefill of prompt + emitted tokens gives the target's logits before
     every emitted token, whose gap to the argmax must lie within
     FLOOR_TIMES x the request's noise floor (one element of layer 0's
     attention output per position x (1 + 2**-7)); an eager engine whose
     acceptance takes every draft must exceed twice that limit.  Each
     request's first divergence from phase 4's tokens is printed.  The
     engines go before 4v
 4v. the serving classes on phase 4's weights: (a) ``LLMServer`` over
     phase 4's paged config (a 1,024-block pool) warms in its
     constructor; phase 4's 8 measured prompts from 8 threads at once
     through ``generate_stream``: every token within the floor check
     (phase 4s's accept-everything streams must still break it), tok/s
     and each request's time to first chunk beside phase 4's direct
     rate, B1's launches = 32 x the token steps; (b) a stream closed
     after its second chunk gives its blocks back while two others
     finish; (c) a random LoRA adapter served by ``model=`` while a base
     stream decodes: the adapter engine's build (its graphs captured in
     the caller's thread) seconds and memory, the base stream's longest
     gap between chunks during the build, the adapter's tokens within
     the floor check over ``merge_lora``'s weights; (d)
     ``PrefillServer`` -> ``DecodeServer`` for the 8 prompts from 8
     threads: the floor check, each handoff's export and import ms and
     payload MB, and a block-size-32 handoff falling back to recompute;
     (e) ``OpenAICompatServer`` with ``ByteTokenizer`` over the static
     engine: a completion, a chat completion and a streamed chat, their
     shapes and usage counts, B2's launches = 32 x 3.  Every server is
     shut down and freed before 5b
 5b. the static engine on the same weights (8 slots x 2,048 positions,
     decode_chunk 8): its prefill programs (one CUDA graph per prompt
     bucket, B2 inside) made first, seconds and graph pool bytes printed;
     10 requests of 100-700 tokens, whose prefill replays must launch the
     flash forward kernel 32 times each (every bucket is 128 or more); the flash kernels against their plain versions at the
     prefill's shapes (B=1, 32/8 heads, S 256 and 1,024); the prefill's
     logits with flash against the reference attention, at the 8 rows the
     engine samples from and at every position of a 900-token prompt,
     each within FLOOR_TIMES x a noise floor (one element of layer 0's
     attention output per position nudged by 2**-7), which a causal mask
     shifted by one key must break; a measured run, decoding from one
     graph, and the same run through an eager twin (greedy tokens
     identical; prefill tok/s and time to first token both ways); then
     prefill's busy share and B2's device time per launch inside the
     graphs and eagerly (torch.profiler)
Then the engines are freed, and the training path runs:
  6. the flash kernels: first their design in the built library's SASS
     (per kernel the count of wgmma, TMA-load and mbarrier instructions;
     the forward, dK/dV and dQ kernels must have wgmma and TMA loads);
     then the forward, and the backward from the saved LSE, against their
     plain versions at the training shapes (B=8, S=2048, 16 q / 8 kv
     heads, D=128, bf16, causal; once more non-causal, once at GQA
     group 1 and once at the MoE step's shape, B=4 with 32 q / 8 kv
     heads) within ``kernel_tolerance``, which must break (checked)
     when one key is dropped from O and from dQ, and one query row from
     dK and dV; repeat calls bit-identical; with times: kernels (over
     runs of 10 calls and one call per timing; device time per kernel
     from torch.profiler), plain versions, SDPA forward and backward, and
     the bounds
  7. make_train_step on the repo's Llama-1B training config (bench.py's
     headline: vocab 32768, dim 2048, 16 layers, 16/8 heads, ffn 8192,
     bf16 products) on one fixed [8, 2048] batch, twice: fp32 params and
     moments (the JAX builder's default optimizer), then bench.py's
     headline exactly, bf16 params with adamw(3e-4, b1=0.9, b2=0.95,
     weight_decay=0.1, mu_dtype=bf16); each a warm-up step, then five
     timed steps with 32 forward and 16 backward flash launches each
     (remat recomputes every layer); losses finite and falling; step
     time, tokens/s, MFU and peak memory; then one step profiled
  8. from the fp32 state after them, the step's loss and gradients through the
     flash kernels and through reference_attention: the loss, the grad
     norm and every leaf's gradient must agree within FLOOR_TIMES times a
     noise floor (every attention output nudged by 2**-8; the RMS over
     NOISE_DRAWS independent nudges), and two faults
     a kernel could have (a causal mask shifted by one key; the dK of
     half the q heads dropped) must break that limit
 7r. on the bf16 headline's state, the remat policies: one step's
     gradients under "attn" and "dots" bit for bit "full"'s, with
     REMAT_FLASH's flash launches (attn: 16 forward, 16 backward; dots
     and full: 32 and 16); then per policy three timed steps: step ms,
     launches per step, peak memory
 7c. int8 gradient compression with error feedback on the bf16 headline:
     the torch codec on wq's real gradient (on the card) bit for bit the
     numpy codec's codes and scales; one coding pass's device ms beside
     its bound; three timed compressed steps beside the uncompressed
     step's ms; losses finite
 7s. an async snapshot of the bf16 headline's state (~6.9 GB of params,
     mu and nu) into a temporary directory (its free space printed, the
     directory removed after): save()'s blocking ms against the writer's
     seconds and bytes while three steps update the state in place; the
     snapshot restored into a fresh state runs the same three losses bit
     for bit and holds the pre-save bytes; a second save with no step
     between writes no leaf bytes
Then the Llama state is freed, and the MoE training path runs:
  9. the grouped matmuls gmm and tgmm against their plain versions at the
     MoE step's shapes (Mixtral-8x7B widths: M = 16384 token-expert rows
     of 8192 tokens routed top-2 over 8 experts by a real router, K/N
     4096/14336 both ways round, transpose_rhs for the input gradients,
     tgmm to [8, 4096, 14336] and [8, 14336, 4096]; once more with an
     empty group and one smaller than a tile) within ``kernel_tolerance``,
     which a row moved across a group boundary (gmm) and a row left out
     of a group's sum (tgmm) must break (checked); repeat calls
     bit-identical; times: kernels (and their device time per launch from
     torch.profiler), plain versions, the library's grouped matmul
     (``torch._grouped_mm``, never called by the port) and bounds.  Before
     it, the kernels' SASS (wgmma and TMA loads in gmm, both ways, and in
     tgmm; no mma.sync left) and ptxas's registers and spills
 10. make_train_step on Mixtral-8x7B's width cut to 2 layers (MoEConfig.
     mixtral_8x7b: dim 4096, 32/8 heads, ffn 14336, 8 experts, top-2,
     vocab 32000; fp32 params and AdamW moments, bf16 products) on one
     fixed [4, 2048] batch: a warm-up step, then five timed steps with
     exactly 18 gmm, 6 tgmm, 4 forward and 2 backward flash launches each;
     losses finite and falling; step time, tokens/s and active MFU; then
     one step profiled; then one step under remat "attn" (phase 7r's MoE
     check): 18 gmm, 6 tgmm, 2 forward and 2 backward flash launches, its
     ms and peak memory, and (from the params after it, before phase 11)
     its gradients bit for bit "full"'s
 11. from the state after them, the step's loss and gradients through the
     kernels (dispatch "ragged") and through dispatch "sorted_capacity"
     with capacity_factor = n_experts (nothing drops: the same function
     through batched products): each difference within FLOOR_TIMES times
     a noise floor (every expert output row nudged by 2**-8), and two
     faults (one straddling m-tile's rows computed with the neighbouring
     expert's weights; one expert's weight gradient from half its rows)
     must break that limit
 12. one moe_block_ragged at the step's shapes under
     torch.cuda.set_sync_debug_mode("error"): the MoE block never waits
     for the host
Then one JSON line with every kernel, and last the device line.

Imports torch and ray_tpu_torch only.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 1234
LOGIT_SHARE = 0.05  # kernel vs gather: max|dlogits| <= share * max|logits|
FLOOR_TIMES = 4  # the A/B checks (phases 5b, 8, 11): each difference <= 4 x its floor
NOISE_DRAWS = 4  # phase 8's floor: the RMS over this many independent nudges
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SPEC_K = 4  # drafted tokens per speculative cycle (phase 4s)
SPEC_SELF_ACCEPT = 0.5  # least acceptance of the target as its own draft
BF16_FLOPS_PER_S = 989e12
# jax's Pallas library kernels that B4 and B5 replace
MEGABLOX = "jax/experimental/pallas/ops/tpu/megablox/gmm.py"
# SASS mnemonics: wgmma, TMA tile loads, mbarrier operations
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS")
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_delta_kernel",
                 "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
# the grouped-matmul kernels by their mangled names (tgmm first: its name
# holds gmm's): gmm_kernel<false>, gmm_kernel<true> (transpose_rhs), tgmm
GMM_KERNELS = {"tgmm_kernel": "tgmm", "gmm_kernelILb0E": "gmm",
               "gmm_kernelILb1E": "gmm transpose_rhs"}


def log(*args):
    print(*args, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def graph_ms(fn, calls: int, reps: int = 20) -> float:
    """Median ms per call of ``fn(0) .. fn(calls - 1)`` captured in one CUDA
    graph, over ``reps`` CUDA-event timings of its replay: device time of
    back-to-back launches, without the host's time to issue them.  Warm-up
    and capture share one stream: what a call keeps per stream (the paged
    kernel's arrival counters) exists before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: first-use allocations and builds
        for i in range(calls):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # where the warm-up ran
        for i in range(calls):
            fn(i)
    ms = time_ms(lambda _: graph.replay(), reps=reps) / calls
    del graph
    return ms


def warm_clocks(dev, ms: float = 300.0) -> None:
    """Run bf16 products for about ``ms`` so that the card's clocks are up
    before the first timing (a cold card times its first run slower)."""
    x = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < ms:
        for _ in range(10):
            x @ x
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` calls, per call."""
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(inner):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def paged_shapes(rng):
    """Phase 3's shapes, {name: lengths}: (a) the decode batch of 8 with
    ragged spans (empty, one ending on a split boundary, one of 1,501
    tokens); (b) one user at Llama-3-8B's full 8,192-token context; (c) 32
    rows with spans drawn from the seed in 129-2,048 tokens."""
    return {"a": np.array([0, 255, 1500, 37, 700, 1023, 16, 511], np.int32),
            "b": np.array([8191], np.int32),
            "c": rng.integers(128, 2048, size=32).astype(np.int32)}


def _paged_pool(cfg, dev, nb, shapes, bs, rng, g):
    """A bf16 pool [L, nb, bs, kv*hd] and one table per shape, every live
    page distinct; NaN in every page outside the live spans, in sink block
    0 and in the tail of every row's last live page (TMA loads whole
    pages: the kernel must mask that tail)."""
    kv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    perm = rng.permutation(np.arange(1, nb))
    tables, at = {}, 0
    for name, lens in shapes.items():
        pages = [math.ceil((n + 1) / bs) for n in lens]
        w = 1 << (max(pages) - 1).bit_length()
        table = np.zeros((len(lens), w), np.int32)
        for r, n in enumerate(pages):
            table[r, :n] = perm[at:at + n]
            at += n
        tables[name] = (table, pages)
    dead = perm[at:]
    if not len(dead):
        raise AssertionError(f"a {nb}-block pool cannot hold phase 3's spans")
    pool = [torch.randn((L, nb, bs, kv * hd), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2)]
    nan_pages = torch.as_tensor(np.concatenate([[0], dead]), device=dev)
    for t in pool:
        t[:, nan_pages] = float("nan")
    for name, (table, pages) in tables.items():
        for r, n in enumerate(pages):
            table[r, n:] = rng.choice(dead, size=table.shape[1] - n)
            tail = (int(shapes[name][r]) + 1) % bs
            if tail:
                for t in pool:
                    t[:, int(table[r, n - 1]), tail:] = float("nan")
    return pool, {k: torch.as_tensor(t, device=dev)
                  for k, (t, _) in tables.items()}


def _paged_case(pa, cfg, dev, name, pool_k, pool_v, table, lengths_np, g,
                split_tokens):
    """Kernel vs plain at one shape: tolerance, negative controls, repeat
    bits, and times (kernel, plain, SDPA on the pre-gathered span, bound)."""
    nh, kv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    b, w = table.shape
    bs = pool_k.shape[2]
    q = torch.randn((b, nh, hd), generator=g, device=dev, dtype=torch.bfloat16)
    lengths = torch.as_tensor(lengths_np, device=dev)
    li = L - 1
    out = pa.paged_decode_attention(q, pool_k, pool_v, li, table, lengths)
    ref = pa.paged_decode_attention_reference(q, pool_k, pool_v, li, table,
                                              lengths)
    again = pa.paged_decode_attention(q, pool_k, pool_v, li, table, lengths)
    torch.cuda.synchronize()
    if tuple(out.shape) != (b, nh * hd) or not torch.isfinite(out).all():
        raise AssertionError(f"({name}) kernel output is not finite or misshapen")
    if not torch.equal(out, again):
        raise AssertionError(f"({name}) repeat calls differ")
    # tolerance: the spread of the bf16 roundings of probabilities that
    # summation order may flip (ops/paged_attention.kernel_tolerance)
    tol = pa.kernel_tolerance(q, pool_k, pool_v, li, table, lengths)
    err = (out - ref).abs().max().item()
    ratio = ((out - ref).abs() / tol).max().item()
    log(f"kernel ({name}): B={b}, spans {int(lengths_np.min()) + 1}-"
        f"{int(lengths_np.max()) + 1}, table {w} pages: max|kernel - plain| = "
        f"{err:.3e}, at most {ratio:.3f} of its tolerance (tolerance "
        f"{tol.min().item():.2e} to {tol.max().item():.2e}); repeat calls "
        f"bit-identical")
    if ratio > 1:
        raise AssertionError(f"({name}) kernel disagrees with its plain "
                             f"version: {err}")
    # negative controls: the kernel without the last token of the longest
    # row, and without the last token of a span that ends on a split
    # boundary, must fail the same check
    controls = {int(lengths_np.argmax()): "the longest row"}
    for r in [r for r, n in enumerate(lengths_np)
              if n > 0 and (n + 1) % split_tokens == 0][:1]:
        controls[r] = ", ".join(filter(None, (
            controls.get(r), f"a span ending on a {split_tokens}-token split "
            f"boundary")))
    for r, what in controls.items():
        short = lengths.clone()
        short[r] -= 1
        cut = pa.paged_decode_attention(q, pool_k, pool_v, li, table, short)
        cut_ratio = ((cut - ref).abs() / tol)[r].max().item()
        log(f"kernel ({name}): dropping the last of {lengths_np[r] + 1} "
            f"tokens of row {r} ({what}) reaches {cut_ratio:.3f} of the "
            f"tolerance")
        if cut_ratio <= 1:
            raise AssertionError(f"({name}) the tolerance does not catch a "
                                 f"dropped token of {what}")

    # times: one launch per layer in turn, so each layer's span is cold in
    # L2 as on the decode path; the slower plain and library versions take
    # a few layers in turn.  Each is a run of calls captured in one CUDA
    # graph and replayed, so the host's time to issue a call (the wrapper's
    # Python, ~25 us) is not counted; beside it the kernel's eager time per
    # call and its device time per launch (torch.profiler)
    nl = min(4, L)

    def kernel(i):
        return pa.paged_decode_attention(q, pool_k, pool_v, i % L, table,
                                         lengths)

    ms = graph_ms(kernel, L)
    eager_ms = time_ms(kernel, reps=20, inner=L)
    device_ms = _kernel_device_ms(lambda: [kernel(i) for i in range(L)],
                                  "paged_decode_kernel", calls=1)
    plain_ms = graph_ms(lambda i: pa.paged_decode_attention_reference(
        q, pool_k, pool_v, i % L, table, lengths), nl, reps=5)
    # library yardstick: SDPA on the span gathered beforehand (not timed)
    idx = table.long()
    span = w * bs
    live = torch.arange(span, device=dev)[None, :] <= lengths.long()[:, None]

    def gathered(pool, layer):
        x = pool[layer][idx].view(b, span, kv, hd)
        x = torch.where(live[:, :, None, None], x, torch.zeros((), dtype=x.dtype,
                                                               device=dev))
        return x.permute(0, 2, 1, 3).contiguous()  # [B, kv, S, hd]

    gk = [gathered(pool_k, layer) for layer in range(nl)]
    gv = [gathered(pool_v, layer) for layer in range(nl)]
    mask = live[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q4, gk[0], gv[0], attn_mask=mask, enable_gqa=True)
    lib_err = (lib_out.float().reshape(b, nh * hd)
               - pa.paged_decode_attention_reference(
                   q, pool_k, pool_v, 0, table, lengths)).abs().max().item()
    library_ms = graph_ms(lambda i: sdpa(q4, gk[i % nl], gv[i % nl],
                                         attn_mask=mask, enable_gqa=True), nl)
    del gk, gv
    nvalid = lengths_np.astype(np.int64) + 1
    nbytes = (q.numel() * 2 + 2 * int(nvalid.sum()) * kv * hd * 2
              + table.numel() * 4 + lengths.numel() * 4 + b * nh * hd * 4)
    flops = 4 * nh * hd * int(nvalid.sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kernel ({name}): {ms:.4f} ms (eager {eager_ms:.4f} ms per call; "
        f"device {device_ms if device_ms is None else round(device_ms, 5)} ms "
        f"per launch)  plain: {plain_ms:.4f} ms  library (SDPA on the "
        f"pre-gathered span, gather not timed, max err {lib_err:.2e}): "
        f"{library_ms:.4f} ms")
    log(f"kernel ({name}): bound {bound_ms:.5f} ms ({nbytes} bytes at 3.35 "
        f"TB/s; {flops} flops) -> {100 * bound_ms / ms:.1f}% of bound; "
        f"{library_ms / ms:.2f}x faster than SDPA")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}, (q, lengths)


def phase_kernel(pa, cfg, dev, nb=4608, shapes=None):
    """Kernel vs plain version at three decode shapes (``paged_shapes``) in
    one pool of ``nb`` blocks of 16 tokens; then one call under
    ``set_sync_debug_mode("error")``.  Returns {shape: result}; shape (a)'s
    result is the kernels line's."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    shapes = paged_shapes(rng) if shapes is None else shapes
    bs = 16
    (pool_k, pool_v), tables = _paged_pool(cfg, dev, nb, shapes, bs, rng, g)
    log(f"kernel: pool [{cfg.n_layers}, {nb}, {bs}, "
        f"{cfg.n_kv_heads * cfg.head_dim}] bf16 x 2 "
        f"({2 * pool_k.numel() * 2 / 1e9:.2f} GB); NaN in dead pages, sink "
        f"block 0 and every last live page's tail")
    results, inputs = {}, {}
    warm_clocks(dev)
    for name, lens in shapes.items():
        split_tokens, _ = pa.split_plan(len(lens), cfg.n_kv_heads,
                                        tables[name].shape[1], bs, _sm_count(dev))
        results[name], inputs[name] = _paged_case(
            pa, cfg, dev, name, pool_k, pool_v, tables[name], lens, g,
            split_tokens)
    # no host sync: the split plan comes from shapes, never from lengths
    first = next(iter(shapes))
    q, lengths = inputs[first]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pa.paged_decode_attention(q, pool_k, pool_v, 0, tables[first], lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("kernel: one call under set_sync_debug_mode('error'): no host sync")
    return results


def _sm_count(dev) -> int:
    if dev.type != "cuda":
        return 132  # the CPU rehearsal: an H100's count
    return torch.cuda.get_device_properties(dev).multi_processor_count


def phase_paged_sass(library, build_log):
    """B1's design as compiled: TMA loads (UTMALDG), mbarriers (SYNCS) and
    mma.sync (HMMA) in the decode path's instantiation (head_dim 128,
    group 4); with ptxas's registers and spills for every instantiation."""
    for line in build_log.splitlines():
        if "paged_decode_kernel" in line or "registers" in line or "spill" in line:
            log(f"  ptxas paged_attention: {line.strip()}")
    ops = SASS_OPS + ("HMMA",)
    name = "paged_decode_kernelILi128ELi4E"
    c = sass_counts(library, (name,), ops).get(name, dict.fromkeys(ops, 0))
    log("sass paged_decode_kernel<128, 4>: "
        + ", ".join(f"{op} {c[op]}" for op in ops))
    if not (c["UTMALDG"] and c["SYNCS"] and c["HMMA"]):
        raise AssertionError(f"the paged decode kernel has no TMA load "
                             f"(UTMALDG), mbarrier (SYNCS) or mma.sync (HMMA) "
                             f"in its SASS: {c}")
    return c


def drive(eng, gens_prompts):
    """add_request each (prompt, gen), step until done, flush."""
    ids = [eng.add_request(p, g) for p, g in gens_prompts]
    out = {i: [] for i in ids}
    while eng.has_work():
        for rid, toks in eng.step().items():
            out[rid].extend(toks)
    for rid, toks in eng.flush().items():
        out[rid].extend(toks)
    return [out[i] for i in ids]


def graph_pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the CUDA graph memory pool
    ``pool`` (0 where its snapshot does not name segments' pools)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class ReplayTimer:
    """CUDA events around every replay of one set of an engine's programs
    (``eng._programs``, or the speculative propose or verify programs):
    the device time of each replay, host gaps excluded."""

    def __init__(self, programs):
        self.pairs = []
        self.graphs = [p.graph for p in programs.by_width.values()]
        for g in self.graphs:
            g.replay = functools.partial(self._timed, g.replay)

    def _timed(self, replay):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replay()
        end.record()
        self.pairs.append((start, end))

    def ms(self) -> float:
        torch.cuda.synchronize()
        for g in self.graphs:
            del g.replay
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def back_to_back_ms(eng, width, tensors) -> float:
    """Device ms per token step of ``width``'s decode graph replayed back
    to back (CUDA events; no host gap), on the engine's state as it is;
    ``tensors`` (the KV store) are restored after, since replays write."""
    saved = [t.clone() for t in tensors]
    graph = eng._programs.by_width[width].graph
    ms = time_ms(lambda _: graph.replay(), reps=10) / eng.config.decode_chunk
    for t, s in zip(tensors, saved):
        t.copy_(s)
    del saved
    torch.cuda.empty_cache()
    return ms


def measured_run(eng, prompts, gen, after_prefill=None):
    """Prefill ``prompts`` (step(decode=False) until every slot decodes),
    then decode them to the end, timing both on the host clock, the prefill
    and decode graphs' replays by CUDA events, and each request's time to
    first token (all arrive at once: the burst's queueing included).
    Returns (tokens per prompt, dict of the numbers)."""
    ids = [eng.add_request(p, gen) for p in prompts]
    got = {i: [] for i in ids}
    ttft = {}
    pf0 = eng.prefill_tokens
    pf_timer = (ReplayTimer(eng._prefill_programs)
                if eng._programs.graphs else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the static engine prefills whole prompts at admission
    ready = getattr(eng, "_decode_ready", lambda r: True)
    while eng._pending or any(r is not None and not ready(r)
                              for r in eng._slot_req):
        for rid, toks in eng.step(decode=False).items():
            got[rid].extend(toks)
            ttft.setdefault(rid, time.perf_counter() - t0)
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    pf_tokens = eng.prefill_tokens - pf0
    for rid, toks in eng.flush().items():  # first tokens into the mirrors
        got[rid].extend(toks)
        ttft.setdefault(rid, time.perf_counter() - t0)
    if after_prefill is not None:
        after_prefill()
    widths = []
    get = eng._programs.get
    eng._programs.get = lambda w: widths.append(w) or get(w)
    timer = ReplayTimer(eng._programs) if eng._programs.graphs else None
    steps0 = eng.decode_steps
    t0 = time.perf_counter()
    while eng.has_work():
        for rid, toks in eng.step().items():
            got[rid].extend(toks)
    for rid, toks in eng.flush().items():
        got[rid].extend(toks)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    del eng._programs.get
    steps = eng.decode_steps - steps0
    dec_tokens = sum(len(got[i]) - 1 for i in ids)  # first tokens: prefill
    out = {"prefill_tok_s": pf_tokens / t_pf, "prefill_tokens": pf_tokens,
           "prefill_s": t_pf,
           "ttft_mean_ms": 1e3 * statistics.mean(ttft.values()),
           "ttft_max_ms": 1e3 * max(ttft.values()),
           "decode_tok_s": dec_tokens / t_dec,
           "decode_tokens": dec_tokens, "decode_s": t_dec, "steps": steps,
           "wall_ms_per_step": t_dec * 1e3 / steps, "last_width": widths[-1]}
    if timer is not None:
        dev_ms = timer.ms() / steps
        out.update(device_ms_per_step=dev_ms,
                   idle_share=1 - dev_ms / out["wall_ms_per_step"])
    if pf_timer is not None:
        out["prefill_busy_share"] = pf_timer.ms() / (t_pf * 1e3)
    return [got[i] for i in ids], out


def _log_run(label, card_line, r):
    dev = (f"; graphs' device time {r['device_ms_per_step']:.3f} ms per token "
           f"step (CUDA events around each replay), idle share "
           f"{r['idle_share']:.3f}" if "device_ms_per_step" in r else "")
    busy = (f", prefill graphs busy {r['prefill_busy_share']:.3f} of it (CUDA "
            f"events around each replay)" if "prefill_busy_share" in r else "")
    log(f"{label} [{card_line}]: prefill {r['prefill_tok_s']:.1f} tok/s "
        f"({r['prefill_tokens']} tokens in {r['prefill_s']:.3f} s{busy}; time "
        f"to first token {r['ttft_mean_ms']:.1f} ms mean, "
        f"{r['ttft_max_ms']:.1f} ms max over the burst); decode "
        f"{r['decode_tok_s']:.1f} tok/s at batch 8 ({r['decode_tokens']} "
        f"tokens in {r['decode_s']:.3f} s, {r['steps']} token steps, "
        f"{r['wall_ms_per_step']:.3f} ms per token step){dev}")


def phase_engine(pa, llama, llm, cfg, card_line, dev):
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    eng = llm.make_engine(
        llm.LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=2048,
                      block_size=16, prefill_chunk=256, decode_chunk=8),
        device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"engine: Llama-3-8B built in {time.perf_counter() - t0:.1f} s "
        f"({cfg.num_params / 1e9:.2f} B params, bf16), kernel on: "
        f"{eng._use_kernel}, decode graphs: {eng._programs.graphs}")
    if on_card and not (eng._use_kernel and eng._programs.graphs):
        raise AssertionError("the engine did not pick the CUDA kernel and "
                             "CUDA graphs")
    t0 = time.perf_counter()
    eng.warmup(max_len=eng.max_seq)
    torch.cuda.synchronize()
    widths = sorted(eng._programs.by_width)
    pf_widths = sorted(eng._prefill_programs.by_width)
    pool_bytes = graph_pool_bytes(eng._programs.pool) if on_card else 0
    pf_pool = graph_pool_bytes(eng._prefill_programs.pool) if on_card else 0
    log(f"warmup [{card_line}]: {time.perf_counter() - t0:.2f} s; decode "
        f"graphs for table widths {widths} made in "
        f"{eng._programs.build_s:.2f} s (warm-up run and capture), graph "
        f"pool {pool_bytes / 2**20:.1f} MiB; prefill graphs for chunk "
        f"widths {pf_widths} in {eng._prefill_programs.build_s:.2f} s, "
        f"graph pool {pf_pool / 2**20:.1f} MiB"
        f"{' (not found in the allocator snapshot)' if not pool_bytes else ''}")
    if widths != [1 << i for i in range(8)]:
        raise AssertionError(f"warmup made widths {widths}, not 1..128")
    if pf_widths != [16 << i for i in range(5)] or (on_card and any(
            p.graph is None for p in eng._prefill_programs.by_width.values())):
        raise AssertionError(f"warmup made prefill widths {pf_widths}, not "
                             f"16..256 as CUDA graphs")
    v = cfg.vocab_size
    rng = np.random.default_rng(SEED)
    warm = eng.generate([rng.integers(0, v, 64).tolist()],
                        llm.GenerationConfig(max_new_tokens=4))
    if len(warm[0]) != 4:
        raise AssertionError(f"warm-up returned {len(warm[0])} tokens")

    # main path: 10 requests on 8 slots; two share a 256-token prefix
    # (the second is admitted after the first registers it), several span
    # more than one prefill chunk, one samples at temperature 0.8 / top-k 40
    lens = rng.integers(100, 701, size=10)
    lens[0], lens[9] = 600, max(lens[9], 300)
    prompts = [rng.integers(0, v, int(n)).tolist() for n in lens]
    prompts[9] = prompts[0][:256] + prompts[9][256:]
    greedy = llm.GenerationConfig(max_new_tokens=64)
    hot = llm.GenerationConfig(max_new_tokens=64, temperature=0.8, top_k=40)
    jobs = [(p, hot if i == 3 else greedy) for i, p in enumerate(prompts)]
    plens = [len(p) for p in prompts]
    steps0, pf0 = eng.decode_steps, eng.prefill_tokens
    pa.launches = 0
    t0 = time.perf_counter()
    outs = drive(eng, jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    steps = eng.decode_steps - steps0
    prefilled = eng.prefill_tokens - pf0
    log(f"engine: prompts {plens}, {prefilled} of {sum(plens)} prompt "
        f"tokens prefilled (prefix hit saves the rest)")
    for i, o in enumerate(outs):
        if len(o) != 64 or not all(0 <= t < v for t in o):
            raise AssertionError(f"request {i}: {len(o)} tokens, {o[:8]}...")
    if prefilled >= sum(plens):
        raise AssertionError("the shared 256-token prefix was not hit")
    if max(plens) <= 256:
        raise AssertionError("no prompt spans more than one prefill chunk")
    log(f"engine: 10 requests x 64 tokens in {wall:.2f} s wall; "
        f"{steps} decode token steps, {launches} kernel launches booked "
        f"by graph replays (want {cfg.n_layers} x {steps})")
    if on_card and (launches != cfg.n_layers * steps or launches == 0):
        raise AssertionError("the decode path did not run the kernel on "
                             "every layer of every step")
    if (sorted(eng._programs.by_width) != widths
            or sorted(eng._prefill_programs.by_width) != pf_widths):
        raise AssertionError("serving captured a width warmup had not")

    # measured run: 8 ragged prompts, prefill first, then decode; then the
    # same prompts through an eager twin sharing the weights (the A/B of
    # graphs against eager dispatch): identical greedy tokens
    mlens = [512, 300, 700, 450, 256, 640, 380, 600]
    mprompts = [rng.integers(0, v, n).tolist() for n in mlens]
    ab = {}

    def kernel_vs_gather():  # on this state: 8 prefilled slots
        ab.update(phase_ab(eng, llama))
        pa.launches = 0

    got, run = measured_run(eng, mprompts, greedy, kernel_vs_gather)
    if any(len(t) != 64 for t in got):
        raise AssertionError("measured run: a request fell short of 64 tokens")
    if on_card and pa.launches != cfg.n_layers * run["steps"]:
        raise AssertionError("measured run: kernel launches != 32 x steps")
    _log_run("engine, CUDA graphs" if eng._programs.graphs else "engine",
             card_line, run)
    if on_card:
        b2b = back_to_back_ms(eng, run["last_width"],
                              list(eng.pool.values()))
        log(f"engine: width {run['last_width']}'s decode graph replayed "
            f"back to back: {b2b:.3f} ms of device time per token step "
            f"[{card_line}]")
        run["back_to_back_ms_per_step"] = b2b
    eager = llm.PagedTorchLLMEngine(eng.config, params=eng.params,
                                    device=dev, _graphs=False)
    got_eager, run_eager = measured_run(eager, mprompts, greedy)
    _log_run("engine, eager dispatch", card_line, run_eager)
    same = sum(a == b for a, b in zip(got, got_eager))
    log(f"engine: graphs vs eager greedy tokens identical in {same} of 8 "
        f"requests; decode {run['decode_tok_s'] / run_eager['decode_tok_s']:.2f}x "
        f"the eager rate, prefill "
        f"{run['prefill_tok_s'] / run_eager['prefill_tok_s']:.2f}x, time to "
        f"first token {run['ttft_mean_ms'] / run_eager['ttft_mean_ms']:.2f}x")
    if same != len(got):
        raise AssertionError("graph replays and eager chunks gave different "
                             "greedy tokens")
    if on_card:
        # fresh prompts of the measured lengths: the measured ones would hit
        # the prefix cache and prefill one block each
        for label, e in (("engine, CUDA graphs", eng),
                         ("engine, eager dispatch", eager)):
            prefill_busy(e, [rng.integers(0, v, n).tolist() for n in mlens[:4]],
                         label, card_line, llm.GenerationConfig(max_new_tokens=2))
            prefill_chunk_time(e, label, card_line, v)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    phase_profile(eng, llm, rng, v, card_line)
    return {"launches": launches, "ab": ab, "params": eng.params,
            "prompts": mprompts, "tokens": got, "run": run}


def prefill_busy(eng, prompts, label, card_line, gen):
    """torch.profiler over the prefill of ``prompts`` (step(decode=False)
    until every slot decodes; then decoded to the end, not profiled): the
    device busy share (the CUDA kernels' summed time over the window) and
    the flash forward kernel's device time per launch.  Returns the
    profiler's {kernel: (ms, launches)}."""
    ids = [eng.add_request(p, gen) for p in prompts]
    ready = getattr(eng, "_decode_ready", lambda r: True)

    def prefill():
        while eng._pending or any(r is not None and not ready(r)
                                  for r in eng._slot_req):
            eng.step(decode=False)

    by_name, wall_ms = device_ms_by_kernel(prefill)
    while eng.has_work():
        eng.step()
    eng.flush()
    if any(i in eng._requests for i in ids):
        raise AssertionError(f"{label}: profiled requests did not finish")
    if not by_name:
        log(f"prefill profile, {label}: the profiler saw no CUDA kernels; "
            f"busy share not measured")
        return by_name
    busy = sum(ms for ms, _ in by_name.values())
    flash = [(ms, n) for name, (ms, n) in by_name.items()
             if "flash_fwd_kernel" in name]
    fl = (f"; flash forward {sum(m for m, _ in flash) / sum(n for _, n in flash) * 1e3:.1f} "
          f"us per launch over {sum(n for _, n in flash)}" if flash else "")
    log(f"prefill profile, {label} [{card_line}]: {sum(len(p) for p in prompts)} "
        f"prompt tokens in a {wall_ms:.1f} ms window, device busy {busy:.1f} "
        f"ms in {sum(n for _, n in by_name.values())} launches (busy share "
        f"{busy / wall_ms:.3f}, profiler on){fl}")
    return by_name


def prefill_chunk_time(eng, label, card_line, v):
    """One 256-token prefill chunk at p0 = 256 (a long prompt's second
    chunk) on an idle engine, into 48 blocks taken from its block manager
    and given back after: CUDA events over 10 back-to-back runs, then
    torch.profiler over three, with its top kernels."""
    rng = np.random.default_rng(SEED + 5)
    seq = rng.integers(0, v, 700).tolist()
    kw = dict(sample_idx=np.array([3], np.int32),
              temp=np.array([0.0], np.float32), top_k=np.array([0], np.int32))
    with eng._lock:
        blocks = eng.blocks.alloc(48)
    if eng.has_work() or blocks is None:
        raise AssertionError("the chunk timing needs an idle engine")

    def run(_):
        eng._run_prefill(eng._prefill_programs, seq, blocks, 256, 256, **kw)

    ms = time_ms(run, reps=10)
    by_name, wall = device_ms_by_kernel(lambda: [run(i) for i in range(3)])
    busy = sum(m for m, _ in by_name.values())
    log(f"prefill chunk, {label} [{card_line}]: one 256-token chunk at p0 = "
        f"256, table width {eng._prefill_w} blocks: {ms:.3f} ms (CUDA events "
        f"over 10 runs); profiler {busy / 3:.3f} ms busy per chunk in "
        f"{sum(n for _, n in by_name.values()) / 3:.0f} launches")
    for name, (m, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {m / 3:8.3f} ms/chunk  {n / 3:6.1f} launches  {name[:100]}")
    with eng._lock:
        eng.blocks.release(blocks)


def phase_profile(eng, llm, rng, v, card_line):
    """Where a steady decode token step's time goes: torch.profiler over
    three engine steps of a full batch; device busy time is the sum of the
    CUDA kernels it saw, per token step the kernel of row 1 ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ids = [eng.add_request(rng.integers(0, v, 300).tolist(),
                           llm.GenerationConfig(max_new_tokens=64))
           for _ in range(8)]
    while eng._pending or any(r is not None and not eng._decode_ready(r)
                              for r in eng._slot_req):
        eng.step(decode=False)
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    while eng.has_work():
        eng.step()
    eng.flush()
    if any(i in eng._requests for i in ids):
        raise AssertionError("profiled requests did not finish")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    attn = sum(n for name, (_, n) in by_name.items()
               if "paged_decode_kernel" in name)
    if not by_name or not attn:
        log("profile: the profiler saw no CUDA kernels; device time per "
            "token step not measured")
        return
    steps = attn / eng.cfg.n_layers
    busy = sum(ms for ms, _ in by_name.values())
    log(f"profile [{card_line}]: {steps:g} decode token steps in a "
        f"{wall_ms:.1f} ms profiled window: device busy {busy / steps:.3f} ms "
        f"per token step, window {wall_ms / steps:.3f} ms per token step "
        f"(idle share {1 - busy / wall_ms:.3f}, profiler on)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms / steps:8.3f} ms/step  {n / steps:6.1f} launches/step  "
            f"{name[:90]}")
    attn_ms = sum(ms for name, (ms, _) in by_name.items()
                  if "paged_decode_kernel" in name)
    log(f"profile: the paged decode kernel {attn_ms / steps:.3f} ms/step in "
        f"{attn / steps:g} launches/step ({attn_ms / attn * 1e3:.2f} us each)")
    gemm_ms = sum(ms for name, (ms, _) in by_name.items()
                  if "nvjet" in name or "gemm" in name.lower())
    n_all = sum(n for _, n in by_name.values())
    log(f"profile: {n_all / steps:.1f} device launches per token step: cuBLAS "
        f"GEMMs {gemm_ms / steps:.3f} ms, the paged kernel "
        f"{attn_ms / steps:.3f} ms, the rest (elementwise, copies, "
        f"reductions, sampling) {(busy - gemm_ms - attn_ms) / steps:.3f} ms")


def phase_ab(eng, llama):
    """One decode step with the kernel and with the gather, same state."""
    with eng._lock:
        # the engine's own coverage pass: each table row must hold the block
        # of the position this step writes (else it lands in sink block 0)
        active = eng._ensure_decode_blocks_locked(1)
    w = 1 << (max(len(eng._slot_req[s].blocks) for s in active) - 1).bit_length()
    table_np = np.zeros((eng.max_batch, w), np.int32)
    for s in active:
        blks = eng._slot_req[s].blocks
        table_np[s, :len(blks)] = blks
    dev = eng.device
    table = torch.as_tensor(table_np, device=dev)
    lengths = torch.as_tensor(eng._lengths, device=dev)
    tokens = torch.as_tensor(eng._next_tok, device=dev)
    saved = {k: t.clone() for k, t in eng.pool.items()}

    def step(use_kernel):
        for k, t in eng.pool.items():
            t.copy_(saved[k])
        with torch.no_grad():
            logits, _ = llama.decode_step_paged(
                eng.cfg, eng.params, tokens, eng.pool, table, lengths,
                eng._rope, use_kernel=use_kernel)
        return logits[active]

    a, b = step(True), step(False)
    # noise floor of this comparison: the same kernel step with one element
    # of layer 0's attention output changed by 2**-7 (about one bf16 ulp)
    kernel = llama.paged_decode_attention

    def nudged(q, pk, pv, li, tab, lens):
        out = kernel(q, pk, pv, li, tab, lens)
        if li == 0:
            out[active[0], 0] *= 1 + 2 ** -7
        return out

    llama.paged_decode_attention = nudged
    try:
        floor = (step(True) - a).abs().max().item()
    finally:
        llama.paged_decode_attention = kernel
    for k, t in eng.pool.items():
        t.copy_(saved[k])
    del saved
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("decode logits are not finite")
    diff = (a - b).abs().max().item()
    scale = a.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"kernel vs gather in decode_step_paged: max|dlogits| {diff:.4e}, "
        f"max|logits| {scale:.4e} (limit {LOGIT_SHARE} x), greedy agreement "
        f"{agree:.3f} over {len(active)} rows, lengths "
        f"{[int(eng._lengths[s]) for s in active]}; noise floor: one "
        f"element of layer 0's attention x (1 + 2**-7) moves logits by "
        f"{floor:.4e}")
    if diff > LOGIT_SHARE * scale:
        raise AssertionError("kernel and gather logits disagree")
    return {"max_dlogits": diff, "max_logits": scale, "agreement": agree,
            "noise_floor": floor}


def spec_measured_run(eng, prompts, gen):
    """Prefill ``prompts``, then decode them to the end through the
    speculative engine, timing decode on the host clock and every propose,
    verify and (k+1)-step plain replay by CUDA events.  Returns (tokens per
    prompt, dict of the numbers)."""
    ids = [eng.add_request(p, gen) for p in prompts]
    got = {i: [] for i in ids}
    while eng._pending or any(r is not None and not eng._decode_ready(r)
                              for r in eng._slot_req):
        for rid, toks in eng.step(decode=False).items():
            got[rid].extend(toks)
    for rid, toks in eng.flush().items():
        got[rid].extend(toks)
    sets = {"propose": eng._propose_programs, "verify": eng._verify_programs,
            "plain": eng._programs}
    timers = ({name: ReplayTimer(progs) for name, progs in sets.items()}
              if eng._programs.graphs else {})
    stats0 = eng.specdec_stats()
    cycles0, steps0 = eng.spec_cycles, eng.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        for rid, toks in eng.step().items():
            got[rid].extend(toks)
    for rid, toks in eng.flush().items():
        got[rid].extend(toks)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    stats = eng.specdec_stats()
    proposed = stats["proposed"] - stats0["proposed"]
    accepted = stats["accepted"] - stats0["accepted"]
    dec_tokens = sum(len(got[i]) - 1 for i in ids)  # first tokens: prefill
    out = {"decode_tok_s": dec_tokens / t_dec, "decode_tokens": dec_tokens,
           "decode_s": t_dec, "cycles": eng.spec_cycles - cycles0,
           "plain_steps": eng.decode_steps - steps0, "proposed": proposed,
           "accepted": accepted,
           "acceptance": accepted / proposed if proposed else 0.0}
    if timers:
        dev_ms = {name: t.ms() for name, t in timers.items()}
        counts = {name: len(t.pairs) for name, t in timers.items()}
        out.update(
            propose_ms=dev_ms["propose"] / max(counts["propose"], 1),
            verify_ms=dev_ms["verify"] / max(counts["verify"], 1),
            plain_replays=counts["plain"],
            idle_share=1 - sum(dev_ms.values()) / (t_dec * 1e3))
    return [got[i] for i in ids], out


def profile_spec(eng, llm, prompts, card_line):
    """Where a speculative cycle's device time goes: torch.profiler over
    three engine steps of a full batch (one cycle each), the CUDA kernels'
    time per cycle by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.add_request(p, llm.GenerationConfig(max_new_tokens=64))
    while eng._pending or any(r is not None and not eng._decode_ready(r)
                              for r in eng._slot_req):
        eng.step(decode=False)
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    cycles0 = eng.spec_cycles
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cycles = eng.spec_cycles - cycles0
    while eng.has_work():
        eng.step()
    eng.flush()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name or not cycles:
        log("spec profile: the profiler saw no CUDA kernels; not measured")
        return
    busy = sum(ms for ms, _ in by_name.values())
    log(f"spec profile [{card_line}]: {cycles} cycles in a {wall_ms:.1f} ms "
        f"window: device busy {busy / cycles:.3f} ms per cycle in "
        f"{sum(n for _, n in by_name.values()) / cycles:.0f} launches "
        f"(idle share {1 - busy / wall_ms:.3f}, profiler on)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {ms / cycles:8.3f} ms/cycle  {n / cycles:6.1f} launches/cycle  "
            f"{name[:200]}")


def target_logits(llama, cfg, params, rope, tokens, rows, nudge=False):
    """The target's logits [len(rows), V] at positions ``rows`` of
    ``tokens`` (a causal prefill through the flash kernels at the static
    engine's power-of-two bucket); ``nudge``: one element of layer 0's
    attention output per position x (1 + 2**-7), about one bf16 ulp, as
    phases 5 and 5b measure their noise floors."""
    from ray_tpu_torch.llm.engine import _prompt_bucket

    n = len(tokens)
    t = torch.zeros((1, _prompt_bucket(n, rope[0].shape[0])),
                    dtype=torch.int32, device=rope[0].device)
    t[0, :n] = torch.as_tensor(tokens)
    mha = llama.multi_head_attention
    calls = []

    def attend(q, k, v, **kw):
        out = mha(q, k, v, **kw)
        if nudge and not calls:
            out[:, :, 0, 0] *= 1 + 2 ** -7
        calls.append(1)
        return out

    llama.multi_head_attention = attend
    try:
        with torch.no_grad():
            return llama.prefill(cfg, params, t, rope)[0][0, rows].clone()
    finally:
        llama.multi_head_attention = mha


def teacher_forced_gaps(llama, cfg, params, rope, prompt, got):
    """The target's verdict on every token of one request's stream, read
    on that stream itself: one flash prefill of ``prompt + got`` gives the
    logits before each ``got[j]``, and the gap logit[argmax] -
    logit[got[j]] (0 where got[j] is the argmax).  Returns (gaps [len(got)],
    the request's noise floor: the largest logit change over those rows
    when layer 0's attention output is nudged by about one bf16 ulp)."""
    seq = prompt + got[:-1]
    rows = slice(len(prompt) - 1, len(prompt) - 1 + len(got))
    plain = target_logits(llama, cfg, params, rope, seq, rows)
    nudged = target_logits(llama, cfg, params, rope, seq, rows, nudge=True)
    idx = torch.as_tensor(got, device=plain.device)[:, None]
    gaps = plain.max(-1).values - plain.gather(-1, idx)[:, 0]
    return gaps.tolist(), (nudged - plain).abs().max().item()


def first_divergence(want, got):
    """Per request, the first position where ``got`` leaves ``want``
    (None where they agree)."""
    return [next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
            for w, g in zip(want, got)]


def phase_spec(pa, llama, llm, paged, cfg, main, card_line, dev,
               dcfg_a=None):
    """Speculative decoding at Llama-3-8B on phase 4's weights, with two
    drafts: (a) a Llama-3.2-1B-width model with random weights, (b) the
    target itself.  Each: ``warmup`` (propose, verify and the (k+1)-step
    chunk captured per table width), then phase 4's measured prompts;
    tokens/s, acceptance, device ms per propose and per verify replay, the
    idle share, capture seconds and graph pool bytes, beside phase 4's
    non-speculative rate.  Greedy check: every emitted token, teacher-forced
    on the request's own stream, must be the target's argmax or within
    FLOOR_TIMES x the request's noise floor of it; an engine that accepts
    every draft (the control) must break it by a wide margin.  Self-draft
    acceptance must reach SPEC_SELF_ACCEPT.  Returns B1's launches on this
    path (counter zeroed before each draft's run, read after)."""
    k = SPEC_K
    params, prompts, want = main["params"], main["prompts"], main["tokens"]
    plain = main["run"]
    dcfg_a = dcfg_a or llama.LlamaConfig.llama32_1b(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    greedy = llm.GenerationConfig(max_new_tokens=64)

    def conf(dcfg):
        return llm.LLMConfig(
            model_config=cfg, max_batch_size=8, max_seq_len=2048,
            block_size=16, prefill_chunk=256, decode_chunk=8,
            speculative_config=llm.SpeculativeConfig(
                draft_model_config=dcfg, num_speculative_tokens=k))

    dparams_a = llama.init_params(
        dcfg_a, torch.Generator(device=dev).manual_seed(SEED + 2), dev)
    launches, rows, rope = 0, {}, None
    for name, dcfg, dparams in (("(a) Llama-3.2-1B-width draft", dcfg_a,
                                 dparams_a),
                                ("(b) self-draft", cfg, params)):
        t0 = time.perf_counter()
        eng = llm.make_engine(conf(dcfg), params=params, device=dev,
                              draft_params=dparams)
        if dev.type == "cuda" and not (eng._draft_use_kernel
                                       and eng._programs.graphs):
            raise AssertionError(f"{name}: the draft does not take the paged "
                                 f"kernel, or the engine no CUDA graphs")
        eng.warmup(max_len=eng.max_seq)
        torch.cuda.synchronize()
        sets = (eng._propose_programs, eng._verify_programs, eng._programs)
        widths = [sorted(s.by_width) for s in sets]
        build_s = sum(s.build_s for s in sets)
        pool_bytes = (sum(graph_pool_bytes(s.pool) for s in sets)
                      if dev.type == "cuda" else 0)
        log(f"spec {name}: engine and warmup in "
            f"{time.perf_counter() - t0:.2f} s; propose, verify and the "
            f"{k + 1}-step chunk at widths {widths[0]}: {build_s:.2f} s of "
            f"warm-up runs and captures, graph pools {pool_bytes / 2**20:.1f} "
            f"MiB; draft kernel on: {eng._draft_use_kernel}")
        if not widths[0] == widths[1] == widths[2] == [1 << i for i in range(8)]:
            raise AssertionError(f"spec warmup made widths {widths}")
        pa.launches = 0
        got, run = spec_measured_run(eng, prompts, greedy)
        launches += pa.launches
        want_launches = (cfg.n_layers * run["plain_steps"]
                         + dcfg.n_layers * (k + 1) * run["cycles"])
        if any(len(t) != 64 for t in got):
            raise AssertionError(f"spec {name}: a request fell short of 64")
        if dev.type == "cuda" and (pa.launches != want_launches
                                   or not run["cycles"]):
            raise AssertionError(f"spec {name}: {pa.launches} kernel launches, "
                                 f"want {want_launches}")
        dev_part = (f"; device {run['propose_ms']:.3f} ms per propose replay, "
                    f"{run['verify_ms']:.3f} ms per verify replay (CUDA "
                    f"events), idle share {run['idle_share']:.3f}"
                    if "propose_ms" in run else "")
        log(f"spec {name} [{card_line}]: decode {run['decode_tok_s']:.1f} "
            f"tok/s at batch 8 ({run['decode_tokens']} tokens in "
            f"{run['decode_s']:.3f} s, {run['cycles']} cycles, "
            f"{run['plain_steps']} plain token steps); acceptance "
            f"{run['acceptance']:.4f} ({run['accepted']} of "
            f"{run['proposed']}){dev_part}; {pa.launches} B1 launches; "
            f"non-speculative (phase 4, same call): "
            f"{plain['decode_tok_s']:.1f} tok/s")
        if name.startswith("(a)") and dev.type == "cuda":
            profile_spec(eng, llm, prompts, card_line)
        rope = eng._rope
        rows[name] = (got, run)
        if name.startswith("(b)") and run["acceptance"] < SPEC_SELF_ACCEPT:
            raise AssertionError(f"self-draft acceptance {run['acceptance']} "
                                 f"< {SPEC_SELF_ACCEPT}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # the control: every draft accepted (corrections from the last window
    # position), an eager engine on draft (a), 8 tokens per request
    real = paged._spec_accept

    def accept_all(pdist, qdist, drafted, generator):
        n = drafted.shape[1]
        a = torch.full((drafted.shape[0],), n, dtype=torch.int32,
                       device=drafted.device)
        return a, pdist[:, n].argmax(-1).to(torch.int32)

    paged._spec_accept = accept_all
    try:
        ctl = llm.PagedTorchLLMEngine(conf(dcfg_a), params=params,
                                      draft_params=dparams_a, device=dev,
                                      _graphs=False)
        got_ctl = drive(ctl, [(p, llm.GenerationConfig(max_new_tokens=8))
                              for p in prompts])
        del ctl
    finally:
        paged._spec_accept = real
    gc.collect()
    torch.cuda.empty_cache()

    # every emitted token, teacher-forced on the engine's own stream: its
    # gap to the target's argmax within FLOOR_TIMES x the request's floor
    streams = {name: got for name, (got, _) in rows.items()}
    streams["control"] = got_ctl
    worst = {}
    for name, got in streams.items():
        ratios = []
        for p, g in zip(prompts, got):
            gaps, floor = teacher_forced_gaps(llama, cfg, params, rope, p, g)
            ratios.append((max(gaps) / floor, sum(x > 0 for x in gaps),
                           max(gaps), floor))
        worst[name] = max(r for r, *_ in ratios)
        firsts = (f"; first divergence from phase 4's tokens at "
                  f"{first_divergence(want, got)}" if name != "control"
                  else "")
        log(f"spec greedy check {name}: {sum(len(g) for g in got)} tokens "
            f"teacher-forced, {sum(n for _, n, *_ in ratios)} not the "
            f"target's argmax; per request the largest gap / its floor "
            f"{[round(r, 3) for r, *_ in ratios]} (gaps "
            f"{[f'{x:.3e}' for _, _, x, _ in ratios]}, floors "
            f"{[f'{f:.3e}' for *_, f in ratios]}); limit {FLOOR_TIMES} x"
            f"{'; the control must exceed 2 x the limit' if name == 'control' else ''}"
            f"{firsts}")
    for name, r in worst.items():
        if name != "control" and r > FLOOR_TIMES:
            raise AssertionError(f"spec {name}: an emitted token is no "
                                 f"near-tie of the target's argmax "
                                 f"({r:.3f} x its floor)")
    if worst["control"] <= 2 * FLOOR_TIMES:
        raise AssertionError("the greedy check does not catch an engine that "
                             "accepts every draft")
    return launches, {name: run for name, (_, run) in rows.items()}, got_ctl


def ttft_ms(eng, prompt, gen):
    """Host ms from ``add_request`` to the first token of one request on an
    idle engine (synchronised), then the request decoded to its end.
    Returns (ms, its tokens)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = eng.add_request(prompt, gen)
    out = []
    while not out:
        out.extend(eng.step(decode=False).get(rid, []))
    ms = (time.perf_counter() - t0) * 1e3
    while eng.has_work():
        out.extend(eng.step().get(rid, []))
    out.extend(eng.flush().get(rid, []))
    return ms, out


def floor_check(llama, cfg, params, rope, label, prompts, streams):
    """PR 9's greedy check: every token of each stream, teacher-forced on
    the stream itself, within FLOOR_TIMES x the request's noise floor of
    the target's argmax.  Returns the worst ratio."""
    ratios = []
    for p, g in zip(prompts, streams):
        gaps, floor = teacher_forced_gaps(llama, cfg, params, rope, p, g)
        ratios.append((max(gaps) / floor, sum(x > 0 for x in gaps), floor))
    log(f"{label}: {sum(len(g) for g in streams)} tokens teacher-forced, "
        f"{sum(n for _, n, _ in ratios)} not the target's argmax; per request "
        f"the largest gap / its floor {[round(r, 3) for r, _, _ in ratios]} "
        f"(floors {[f'{f:.3e}' for *_, f in ratios]}); limit {FLOOR_TIMES} x")
    return max(r for r, _, _ in ratios)


TIER_PREFIX = 480  # phase 4m (a): the shared prefix, 30 blocks of 16


def phase_tier(llama, llm, cfg, params, card_line, dev):
    """Phase 4m (a): the host-RAM prefix tier at Llama-3-8B on phase 4's
    weights, its default 64 MiB (32 blocks of 2 MiB).  Prompt A (a
    480-token prefix and 32 more tokens) is served; then eight identical
    512-token prompts, admitted at once, need every block of the pool but
    one of A's, so the pool's eviction demotes A's first 31 blocks while
    the eight are live (only the first of them registers its blocks, so
    the tier is not refilled after); then A2, the same prefix and another
    32 tokens, revives 30 blocks from the tier.  Checks: the demoted bytes
    and the revived pool blocks equal A's blocks bit for bit; A2's tokens
    pass the floor check, beside an engine without the tier.  Prints the
    demotion and upload cost per block and A2's time to first token with
    revival and with recompute."""
    from ray_tpu_torch._private.prefix_hash import prefix_chain_hashes

    on_card = dev.type == "cuda"
    v = cfg.vocab_size
    rng = np.random.default_rng(SEED + 4)
    prefix = rng.integers(0, v, TIER_PREFIX).tolist()
    a = prefix + rng.integers(0, v, 32).tolist()
    a2 = prefix + rng.integers(0, v, 32).tolist()
    b = rng.integers(0, v, 512).tolist()
    gen = llm.GenerationConfig(max_new_tokens=16)
    # two tokens: the eight finish at their first decode chunk, before the
    # full pool would preempt (and re-admit) any of them
    gen_b = llm.GenerationConfig(max_new_tokens=2)
    # 8 x 33 blocks reserved by the eight = every usable block but one of
    # A's 32 cached ones: 233 plain + 31 of A's
    kw = dict(model_config=cfg, max_batch_size=8, max_seq_len=2048,
              block_size=16, prefill_chunk=256, decode_chunk=8, num_blocks=266)
    eng = llm.PagedTorchLLMEngine(llm.LLMConfig(**kw), params=params,
                                  device=dev)
    cap = eng.config.host_kv_cache_bytes
    block_bytes = 2 * eng.pool["k"][:, 0].numel() * eng.pool["k"].element_size()
    if eng._host_cache is None or cap != 64 * 2**20:
        raise AssertionError("the engine has no 64 MiB host tier")
    # the prefill widths first, so no capture lands in a time to first
    # token (the one decode width these runs use is made by A's run)
    for c in (16, 32, 64, 128, 256):
        eng._prefill_programs.get(c)
    drive(eng, [(a, gen)])
    chain = prefix_chain_hashes(a, 16)
    n = TIER_PREFIX // 16
    with eng._lock:
        orig = [(eng.pool["k"][:, eng.blocks.by_hash[h]].clone(),
                 eng.pool["v"][:, eng.blocks.by_hash[h]].clone())
                for h in chain[:n]]
    st = dict(eng.prefix_stats)
    drive(eng, [(b, gen_b)] * 8)
    torch.cuda.synchronize()
    demoted = eng.prefix_stats["demoted"] - st["demoted"]
    demote_ms = 1e3 * (eng.prefix_stats["demote_s"] - st["demote_s"]) / demoted
    if any(h in eng.blocks.by_hash for h in chain[:n]):
        raise AssertionError("the prefix was not evicted from the pool")
    for h, (k0, v0) in zip(chain[:n], orig):
        got = eng._host_cache.get(h)
        if got is None:
            raise AssertionError("a prefix block is missing from the host tier")
        if not (torch.equal(got[0], k0.cpu()) and torch.equal(got[1], v0.cpu())):
            raise AssertionError("a demoted block differs from the pool's")
    uploads = []
    upload = eng._upload_block
    eng._upload_block = lambda blk, k, vv: (uploads.append(blk),
                                            upload(blk, k, vv))[1]
    st = dict(eng.prefix_stats)
    ttft_tier, toks_tier = ttft_ms(eng, a2, gen)
    del eng._upload_block
    revived = eng.prefix_stats["host_hits"] - st["host_hits"]
    upload_ms = 1e3 * (eng.prefix_stats["upload_s"] - st["upload_s"]) / max(
        revived, 1)
    if revived != n or len(uploads) != n:
        raise AssertionError(f"A2 revived {revived} blocks, not {n}")
    same = all(torch.equal(eng.pool["k"][:, blk], k0)
               and torch.equal(eng.pool["v"][:, blk], v0)
               for blk, (k0, v0) in zip(uploads, orig))
    if not same:
        raise AssertionError("a revived pool block differs from the demoted "
                             "bytes")
    # device time of the tier's two copies per block: K and V to pinned
    # host memory, and back into sink block 0 (garbage by design)
    hk, hv = eng._to_host(eng.pool["k"][:, 1]), eng._to_host(eng.pool["v"][:, 1])
    if on_card:
        down = time_ms(lambda _: (eng._to_host(eng.pool["k"][:, 1]),
                                  eng._to_host(eng.pool["v"][:, 1])))
        up = time_ms(lambda _: [eng.pool[nm][:, 0].copy_(t, non_blocking=True)
                                for nm, t in (("k", hk), ("v", hv))])
    else:
        down = up = float("nan")
    plain = llm.PagedTorchLLMEngine(
        llm.LLMConfig(host_kv_cache_bytes=0, **kw), params=params, device=dev)
    plain._prefill_programs.get(256)
    ttft_plain, toks_plain = ttft_ms(plain, a2, gen)
    rope = eng._rope
    log(f"tier (a) [{card_line}]: host tier {cap / 2**20:.0f} MiB = "
        f"{cap // block_bytes} blocks of {block_bytes / 2**20:.0f} MiB; "
        f"{demoted} demotions under the eight, the {n} prefix blocks "
        f"bit-equal in the tier; A2 revived {revived} of them, bit-equal in "
        f"the pool; per block: demotion {demote_ms:.3f} ms of host time "
        f"(enqueued, no wait), {down:.3f} ms of device time (K and V to "
        f"pinned host memory, CUDA events); upload {upload_ms:.3f} ms of "
        f"host time, {up:.3f} ms of device time; A2's time to first token "
        f"{ttft_tier:.1f} ms with revival, {ttft_plain:.1f} ms with "
        f"recompute (no tier); tokens first differ at "
        f"{first_divergence([toks_plain], [toks_tier])[0]}")
    del eng, plain, orig
    gc.collect()
    torch.cuda.empty_cache()
    worst = floor_check(llama, cfg, params, rope, "tier (a) greedy check, "
                        "A2 with revival and with recompute", [a2, a2],
                        [toks_tier, toks_plain])
    if worst > FLOOR_TIMES:
        raise AssertionError(f"tier: a token is no near-tie of the target's "
                             f"argmax ({worst:.3f} x its floor)")
    return {"demote_ms": demote_ms, "demote_dev_ms": down,
            "upload_ms": upload_ms, "upload_dev_ms": up,
            "ttft_revival_ms": ttft_tier, "ttft_recompute_ms": ttft_plain}


def payload_tensor(a) -> torch.Tensor:
    """A handoff array as a CPU tensor: numpy (``ml_dtypes.bfloat16`` by
    its bits, where ``ml_dtypes`` imports) or a tensor already."""
    if isinstance(a, torch.Tensor):
        return a
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def phase_migration(llama, llm, cfg, params, main, card_line, dev):
    """Phase 4m (b) and (c): live requests move between engines sharing
    phase 4's weights.  Phase 4's 8 measured prompts decode greedily on a
    source engine; at 16 tokens each, two are exported and imported into a
    second engine (b), two into a self-draft speculative engine (phase
    4s's setting (b)), whose draft is re-seeded over prompt + history (c).
    Checks: every importing pool's blocks bit-equal to the payload; every
    emitted token of the 8 stitched streams within the floor check, which
    a payload with its K and V swapped (the control, a third import) must
    break; the re-seeded requests' acceptance at least
    SPEC_SELF_ACCEPT.  Prints payload MB and export and import ms."""
    prompts, want = main["prompts"], main["tokens"]
    kw = dict(model_config=cfg, max_batch_size=8, max_seq_len=2048,
              block_size=16, prefill_chunk=256, decode_chunk=8)
    greedy = llm.GenerationConfig(max_new_tokens=64)
    src = llm.PagedTorchLLMEngine(llm.LLMConfig(**kw), params=params,
                                  device=dev)
    dst = llm.PagedTorchLLMEngine(llm.LLMConfig(**kw), params=params,
                                  device=dev)
    spec = llm.PagedTorchLLMEngine(
        llm.LLMConfig(speculative_config=llm.SpeculativeConfig(
            draft_model_config=cfg, num_speculative_tokens=SPEC_K), **kw),
        params=params, draft_params=params, device=dev)
    # the re-seed's draft prefill widths, made before the timed imports
    c = 16
    while c <= 256:
        spec._draft_prefill_programs.get(c)
        c *= 2
    ids = [src.add_request(p, greedy) for p in prompts]
    got = {i: [] for i in ids}
    while src._pending or any(r is not None and not src._decode_ready(r)
                              for r in src._slot_req):
        for rid, toks in src.step(decode=False).items():
            got[rid].extend(toks)
    while min(len(got[i]) for i in ids) < 16:
        for rid, toks in src.step().items():
            got[rid].extend(toks)
    for rid, toks in src.flush().items():  # nothing in flight at the exports
        got[rid].extend(toks)
    moves = {ids[1]: dst, ids[5]: dst, ids[2]: spec, ids[6]: spec}
    where, rows = {}, []
    for rid, target in moves.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = src.export_request(rid)
        t_exp = time.perf_counter() - t0
        if h["emitted"] != got[rid]:
            raise AssertionError("the export's history is not the stream's")
        t0 = time.perf_counter()
        res = target.import_request(h["prompt"], h["first_token"], h["k"],
                                    h["v"], llm.GenerationConfig(**h["gen"]),
                                    emitted=h["emitted"])
        torch.cuda.synchronize()
        t_imp = time.perf_counter() - t0
        if res is None or res["emitted"]:
            raise AssertionError("an import was refused or re-emitted history")
        req = target._requests[res["request_id"]]
        for name in ("k", "v"):
            if not torch.equal(target.pool[name][:, req.blocks].cpu(),
                               payload_tensor(h[name])):
                raise AssertionError("an imported block differs from the "
                                     "payload")
        if target is spec and not (req.spec_enabled and req.draft_prefill_pos
                                   == len(h["prompt"]) + len(h["emitted"]) - 1):
            raise AssertionError("the import did not re-seed the draft")
        where[rid] = (target, res["request_id"])
        rows.append((target is spec, (h["k"].nbytes + h["v"].nbytes) / 1e6,
                     t_exp * 1e3, t_imp * 1e3, len(h["emitted"])))
        if rid == ids[1]:  # the control: the payload's K and V swapped
            ctl = dst.import_request(h["prompt"], h["first_token"],
                                     h["v"], h["k"],
                                     llm.GenerationConfig(**h["gen"]),
                                     emitted=h["emitted"])
            ctl_stream = (list(h["emitted"]), ctl["request_id"])
    cont = {}
    for eng in (src, dst, spec):
        while eng.has_work():
            for rid, toks in eng.step().items():
                cont.setdefault((id(eng), rid), []).extend(toks)
        for rid, toks in eng.flush().items():
            cont.setdefault((id(eng), rid), []).extend(toks)
    streams = []
    for rid in ids:
        eng, erid = where.get(rid, (src, rid))
        streams.append(got[rid] + cont.get((id(eng), erid), []))
    control = ctl_stream[0] + cont.get((id(dst), ctl_stream[1]), [])
    if any(len(t) != 64 for t in streams + [control]):
        raise AssertionError("a migrated stream fell short of 64 tokens")
    stats = spec.specdec_stats()
    for label, is_spec in (("(b) import", False), ("(c) import + re-seed",
                                                   True)):
        r = [x for x in rows if x[0] == is_spec]
        log(f"migration {label} [{card_line}]: at {[x[4] for x in r]} "
            f"emitted tokens, payloads {[round(x[1], 3) for x in r]} MB; "
            f"export {[round(x[2], 2) for x in r]} ms, import "
            f"{[round(x[3], 2) for x in r]} ms (host clock, synchronised)")
    log(f"migration (c): the re-seeded self-draft accepted "
        f"{stats['accepted']} of {stats['proposed']} "
        f"({stats['acceptance_rate']:.4f}; at least {SPEC_SELF_ACCEPT}); "
        f"first divergences from phase 4's streams "
        f"{first_divergence(want, streams)}")
    rope = src._rope
    del src, dst, spec
    gc.collect()
    torch.cuda.empty_cache()
    worst = floor_check(llama, cfg, params, rope, "migration greedy check, "
                        "8 stitched streams", prompts, streams)
    ctl_worst = floor_check(llama, cfg, params, rope, "migration control, a "
                            "payload with K and V swapped (must exceed "
                            f"{2 * FLOOR_TIMES} x)", [prompts[1]], [control])
    if worst > FLOOR_TIMES:
        raise AssertionError(f"migration: a token is no near-tie of the "
                             f"target's argmax ({worst:.3f} x its floor)")
    if ctl_worst <= 2 * FLOOR_TIMES:
        raise AssertionError("the greedy check does not catch a corrupted "
                             "payload")
    if stats["acceptance_rate"] < SPEC_SELF_ACCEPT:
        raise AssertionError(f"re-seeded self-draft acceptance "
                             f"{stats['acceptance_rate']} < {SPEC_SELF_ACCEPT}")
    return rows, stats


SERVE_BLOCKS = 1024  # phase 4v: each server's pool, 2 GiB at Llama-3-8B


def _stream_in_thread(srv, prompt, t0, max_new_tokens=64, **kw):
    """Consume ``srv.generate_stream`` in a thread; returns (thread, record
    {tokens, chunk arrival times on the host clock, first: seconds from
    ``t0`` to the first chunk, error})."""
    rec = {"tokens": [], "times": [], "first": None, "error": None,
           "stop": threading.Event()}

    def run():
        try:
            gen = srv.generate_stream(prompt, max_new_tokens=max_new_tokens,
                                      **kw)
            for chunk in gen:
                now = time.perf_counter()
                if rec["first"] is None:
                    rec["first"] = now - t0
                rec["times"].append(now)
                rec["tokens"].extend(chunk)
                if rec["stop"].is_set():
                    break
            gen.close()
        except Exception as e:  # noqa: BLE001 — reported by the caller
            rec["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, rec


def _joined(threads, recs, what):
    for t in threads:
        t.join(300)
    bad = [r["error"] for r in recs if r["error"] is not None]
    if any(t.is_alive() for t in threads) or bad:
        raise AssertionError(f"{what}: a stream failed or hung: {bad}")


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} never happened")
        time.sleep(0.002)


def _timed(obj, name, rows):
    """Wrap ``obj.name`` (an instance attribute shadowing the method) so
    each call appends (host ms, result or the exception) to ``rows``."""
    orig = getattr(obj, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        try:
            out = orig(*a, **kw)
        except Exception as e:
            rows.append(((time.perf_counter() - t0) * 1e3, e))
            raise
        rows.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    setattr(obj, name, call)


def serve_adapter(lora, cfg, dev):
    """A random LoRA adapter on wq and wv (rank 8, alpha 16) with B drawn
    too (``init_lora``'s zero B is the identity), so it moves the tokens."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    ad = lora.init_lora(cfg, lora.LoRAConfig(rank=8, alpha=16.0), g,
                        dtype=torch.bfloat16)
    for ab in ad["layers"].values():
        ab["B"].normal_(0.0, 0.05, generator=g)
    return ad


def phase_serve(pa, fa, llama, llm, cfg, main, control, card_line, dev):
    """Phase 4v: the serving classes over phase 4's weights (shared, no
    copy).  (a) ``LLMServer`` over phase 4's paged config (its pool sized
    to SERVE_BLOCKS): the constructor's warm-up; phase 4's 8 measured
    prompts from 8 threads at once through ``generate_stream``, every
    token within the floor check (phase 4s's accept-everything streams,
    ``control``, must still break it), tok/s and each request's time to
    first chunk beside phase 4's direct rate, B1's launches = 32 x the
    token steps.  (b) A stream closed after its second chunk: its blocks
    back in the pool while two others finish.  (c) A random LoRA adapter
    served by ``model=`` while a base stream decodes: the adapter
    engine's build seconds and memory, the base stream's longest gap
    between chunks during the build, the adapter's tokens within the
    floor check over ``merge_lora``'s weights.  (d) ``PrefillServer`` ->
    ``DecodeServer`` for the 8 prompts from 8 threads: the floor check,
    each handoff's export and import ms and payload MB; one handoff from
    a block-size-32 prefill stage falls back to recompute.  (e)
    ``OpenAICompatServer`` with ``ByteTokenizer`` over the static engine
    (B2 in its prefill graphs): a completion, a chat completion and a
    streamed chat, their shapes and usage counts.  Every server is shut
    down and freed.  Returns (B1's, B2's launches on these runs)."""
    from ray_tpu_torch.llm import lora
    from ray_tpu_torch.llm.engine import _prompt_bucket

    on_card = dev.type == "cuda"
    params, prompts, want = main["params"], main["prompts"], main["tokens"]
    kw = dict(model_config=cfg, max_batch_size=8, max_seq_len=2048,
              block_size=16, prefill_chunk=256, decode_chunk=8,
              num_blocks=SERVE_BLOCKS)
    rope = llama.rope_cache(cfg, 2048, dev)
    adapter = serve_adapter(lora, cfg, dev)
    b1 = b2 = 0

    # (a) continuous batching across 8 callers
    t0 = time.perf_counter()
    srv = llm.LLMServer(llm.LLMConfig(**kw), params,
                        lora_adapters={"tuned": adapter}, device=dev)
    torch.cuda.synchronize()
    eng = srv._engine
    log(f"serve (a) [{card_line}]: LLMServer built and warmed in "
        f"{time.perf_counter() - t0:.2f} s (decode graphs at widths "
        f"{sorted(eng._programs.by_width)}, prefill graphs at "
        f"{sorted(eng._prefill_programs.by_width)}; pool {SERVE_BLOCKS} "
        f"blocks, {2 * eng.pool['k'].numel() * 2 / 2**30:.2f} GiB)")
    if on_card and (not eng._use_kernel or any(
            p.graph is None for p in eng._programs.by_width.values())):
        raise AssertionError("the server's engine is not warmed on the kernel")
    steps0, pa.launches = eng.decode_steps, 0
    t0 = time.perf_counter()
    runs = [_stream_in_thread(srv, p, t0) for p in prompts]
    _joined([t for t, _ in runs], [r for _, r in runs], "serve (a)")
    wall = max(r["times"][-1] for _, r in runs) - t0
    streams = [r["tokens"] for _, r in runs]
    steps = eng.decode_steps - steps0
    b1 += pa.launches
    if any(len(s) != 64 for s in streams):
        raise AssertionError("serve (a): a stream fell short of 64 tokens")
    log(f"serve (a) [{card_line}]: 8 streams from 8 threads, "
        f"{sum(map(len, streams))} tokens in {wall:.3f} s: "
        f"{sum(map(len, streams)) / wall:.1f} tok/s through the server "
        f"(prefill and decode together; phase 4's direct engine, same call: "
        f"prefill {main['run']['prefill_tok_s']:.1f} tok/s then decode "
        f"{main['run']['decode_tok_s']:.1f} tok/s, 512 tokens in "
        f"{main['run']['prefill_s'] + main['run']['decode_s']:.3f} s); time "
        f"to first chunk {[round(r['first'] * 1e3, 1) for _, r in runs]} ms; "
        f"{steps} decode token steps, {pa.launches} B1 launches booked by "
        f"replays (want {cfg.n_layers} x {steps}); first divergence from "
        f"phase 4's tokens {first_divergence(want, streams)}")
    if on_card and (pa.launches != cfg.n_layers * steps or not steps):
        raise AssertionError("serve (a): B1 did not run on every layer of "
                             "every token step")
    worst = floor_check(llama, cfg, params, rope, "serve (a) greedy check, "
                        "8 streams from 8 threads", prompts, streams)
    ctl = floor_check(llama, cfg, params, rope, "serve (a) control, phase "
                      f"4s's accept-everything streams (must exceed "
                      f"{2 * FLOOR_TIMES} x)", prompts, control)
    if worst > FLOOR_TIMES:
        raise AssertionError(f"serve (a): a token is no near-tie of the "
                             f"target's argmax ({worst:.3f} x its floor)")
    if ctl <= 2 * FLOOR_TIMES:
        raise AssertionError("serve (a): the greedy check no longer catches "
                             "an engine that accepts every draft")

    # (b) a stream closed after its second chunk
    total = srv.utilization()["kv_blocks"]["total"]
    t0 = time.perf_counter()
    others = [_stream_in_thread(srv, p, t0) for p in prompts[:2]]
    gen = srv.generate_stream(prompts[2], max_new_tokens=64)
    got = next(gen) + next(gen)
    gen.close()
    _joined([t for t, _ in others], [r for _, r in others], "serve (b)")
    _wait(lambda: srv.utilization()["slots"]["active"] == 0,
          "serve (b): the slots' release")
    u = srv.utilization()
    log(f"serve (b): a stream closed after {len(got)} tokens (2 chunks); "
        f"the other two gave {[len(r['tokens']) for _, r in others]} tokens; "
        f"blocks free {u['kv_blocks']['free']} of {total}")
    if (u["kv_blocks"]["free"] != total or len(got) >= 64
            or any(len(r["tokens"]) != 64 for _, r in others)):
        raise AssertionError("serve (b): the closed stream kept its blocks, "
                             "or a stream beside it fell short")

    # (c) an adapter engine built while a base stream decodes
    builds = []
    build = srv._build_engine

    def timed_build(model):
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t = time.perf_counter()
        out = build(model)
        builds.append((t, time.perf_counter(),
                       torch.cuda.memory_allocated() - mem[0],
                       torch.cuda.memory_reserved() - mem[1]))
        return out

    srv._build_engine = timed_build
    t0 = time.perf_counter()
    base_t, base = _stream_in_thread(srv, prompts[4], t0,
                                     max_new_tokens=2048 - len(prompts[4]))
    _wait(lambda: len(base["tokens"]) >= 16, "serve (c): the base stream")
    tuned = srv.generate(prompts[5], max_new_tokens=64, model="tuned")
    base["stop"].set()
    _joined([base_t], [base], "serve (c) base stream")
    (b0, b1_, mem_alloc, mem_res), = builds
    times = base["times"]
    gaps = [(b - a) for a, b in zip(times, times[1:]) if b >= b0 and a <= b1_]
    calm = [(b - a) for a, b in zip(times, times[1:]) if b < b0 or a > b1_]
    teng = srv._engines["tuned"]
    log(f"serve (c) [{card_line}]: adapter engine built and warmed in "
        f"{b1_ - b0:.2f} s in the caller's thread ({len(teng._programs.by_width)} "
        f"decode and {len(teng._prefill_programs.by_width)} prefill graphs; "
        f"{mem_alloc / 2**30:.2f} GiB allocated, {mem_res / 2**30:.2f} GiB "
        f"reserved by the build: merged wq and wv, the pool, the graph pools) "
        f"while the base stream decoded: its longest gap between chunks "
        f"during the build {max(gaps, default=0) * 1e3:.1f} ms over "
        f"{len(gaps)} gaps (median outside the build "
        f"{statistics.median(calm) * 1e3 if calm else 0:.1f} ms); base stream "
        f"{len(base['tokens'])} tokens before it was closed; adapter's first "
        f"divergence from phase 4's base tokens "
        f"{first_divergence([want[5]], [tuned])}")
    if (on_card and len(gaps) < 2) or len(tuned) != 64:
        raise AssertionError("serve (c): the base stream stood still during "
                             "the build, or the adapter fell short")
    if first_divergence([want[5]], [tuned]) == [None]:
        raise AssertionError("serve (c): the adapter did not move the tokens")
    merged = lora.merge_lora(params, adapter)
    if floor_check(llama, cfg, merged, rope, "serve (c) adapter greedy check "
                   "over merge_lora's weights", [prompts[5]],
                   [tuned]) > FLOOR_TIMES:
        raise AssertionError("serve (c): an adapter token is no near-tie of "
                             "the merged model's argmax")
    del merged
    srv.shutdown()
    del srv, eng, teng
    gc.collect()
    torch.cuda.empty_cache()

    # (d) prefill stage -> decode stage
    t0 = time.perf_counter()
    pre = llm.PrefillServer(llm.LLMConfig(**kw), params, device=dev)
    pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = llm.DecodeServer(llm.LLMConfig(**kw), params, device=dev)
    dec_s = time.perf_counter() - t0
    exports, imports = [], []
    _timed(pre._engine, "export_request", exports)
    _timed(dec._engine, "import_request", imports)
    steps0, pa.launches = dec._engine.decode_steps, 0
    out, errs = [None] * len(prompts), []

    def handoff(i):
        try:
            h = pre.prefill(prompts[i], max_new_tokens=64)
            out[i] = dec.decode_from_handoff(h, max_new_tokens=64)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=handoff, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve (d): a handoff failed or hung: {errs}")
    steps = dec._engine.decode_steps - steps0
    b1 += pa.launches
    mb = [(h["k"].nbytes + h["v"].nbytes) / 1e6 for _, h in exports]
    log(f"serve (d) [{card_line}]: PrefillServer warmed (prefill graphs "
        f"{sorted(pre._engine._prefill_programs.by_width)}, no decode graph) "
        f"in {pre_s:.2f} s, DecodeServer in {dec_s:.2f} s; 8 prompts from 8 "
        f"threads, prefill -> handoff -> decode, {sum(map(len, out))} tokens "
        f"in {wall:.3f} s; payloads {[round(x, 2) for x in mb]} MB; export "
        f"{[round(ms, 2) for ms, _ in exports]} ms (host clock, waits "
        f"for the other prompts' chunks queued on the stream and the "
        f"engine lock included), import "
        f"{[round(ms, 2) for ms, _ in imports]} ms (host clock, the engine "
        f"lock's wait included); {pa.launches} B1 launches "
        f"(want {cfg.n_layers} x {steps})")
    if (len(exports) != 8 or any(isinstance(r, Exception) for _, r in imports)
            or any(len(s) != 64 for s in out)):
        raise AssertionError("serve (d): a handoff was not exported and "
                             "imported, or a stream fell short")
    if on_card and (pa.launches != cfg.n_layers * steps or not steps):
        raise AssertionError("serve (d): B1 did not run on every token step")
    # one more handoff on idle stages (the prompt's blocks cached in the
    # prefill stage): its export and import with nothing queued before
    # them on the stream or the locks
    n_exp, n_imp = len(exports), len(imports)
    torch.cuda.synchronize()
    solo = dec.decode_from_handoff(pre.prefill(prompts[2], max_new_tokens=64),
                                   max_new_tokens=64)
    (exp_ms, h), = exports[n_exp:]
    (imp_ms, _), = imports[n_imp:]
    log(f"serve (d) [{card_line}]: one handoff on idle stages, "
        f"{(h['k'].nbytes + h['v'].nbytes) / 1e6:.2f} MB: export "
        f"{exp_ms:.2f} ms, import {imp_ms:.2f} ms (host clock)")
    if floor_check(llama, cfg, params, rope, "serve (d) greedy check, 8 "
                   "disaggregated streams and the idle one",
                   prompts + [prompts[2]], out + [solo]) > FLOOR_TIMES:
        raise AssertionError("serve (d): a token is no near-tie of the "
                             "target's argmax")
    pre32 = llm.PrefillServer(llm.LLMConfig(**{**kw, "block_size": 32}),
                              params, device=dev)
    fresh = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, 300).tolist()
    h = pre32.prefill(fresh, max_new_tokens=32)
    pf0 = dec._engine.prefill_tokens
    n_imports = len(imports)
    toks = dec.decode_from_handoff(h, max_new_tokens=32)
    refused = imports[n_imports:]
    log(f"serve (d): a block-size-32 handoff ({h['k'].shape[1]} blocks) into "
        f"the block-size-16 decode stage: import "
        f"{[type(r).__name__ for _, r in refused]}, then "
        f"{dec._engine.prefill_tokens - pf0} prompt tokens recomputed, "
        f"{len(toks)} tokens")
    if (len(refused) != 1 or not isinstance(refused[0][1], ValueError)
            or dec._engine.prefill_tokens - pf0 != len(fresh)
            or len(toks) != 32):
        raise AssertionError("serve (d): the mismatched handoff did not fall "
                             "back to recompute")
    if floor_check(llama, cfg, params, rope, "serve (d) recomputed stream",
                   [fresh], [toks]) > FLOOR_TIMES:
        raise AssertionError("serve (d): a recomputed token is no near-tie")
    dec.shutdown()
    del pre, pre32, dec, h
    gc.collect()
    torch.cuda.empty_cache()

    # (e) OpenAI schemas over the static engine
    oa = llm.OpenAICompatServer(
        llm.LLMConfig(model_config=cfg, kv_cache="static", max_batch_size=8,
                      max_seq_len=2048, decode_chunk=8),
        params, model_id="llama-3-8b-random", device=dev)
    tok = llm.ByteTokenizer()
    text = ("The port serves Llama-3-8B from CUDA graphs on one card; "
            "this completion request is long enough to be prefilled "
            "through the flash forward kernel. ") * 2
    msgs = [{"role": "system", "content": "Answer briefly. " * 4},
            {"role": "user", "content": text}]
    rendered = oa._render_chat(msgs)
    lens = [len(tok.encode(text)), len(tok.encode(rendered))]
    for b in sorted({_prompt_bucket(n, 2048) for n in lens}):
        oa._engine._prefill_programs.get(b)  # made before the count
    fa.fwd_launches = 0
    t0 = time.perf_counter()
    comp = oa({"prompt": text, "max_tokens": 16})
    chat = oa({"messages": msgs, "max_tokens": 16})
    chunks = list(oa({"messages": msgs, "max_tokens": 16, "stream": True}))
    wall = time.perf_counter() - t0
    b2 += fa.fwd_launches
    streamed = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
    content = chat["choices"][0]["message"]["content"]
    log(f"serve (e) [{card_line}]: OpenAICompatServer over the static "
        f"engine, a completion, a chat completion and a streamed chat in "
        f"{wall:.2f} s (its decode graph made at first use, in the loop "
        f"thread, in {oa._engine._programs.build_s:.2f} s; its prefill "
        f"graph before the count, in "
        f"{oa._engine._prefill_programs.build_s:.2f} s); prompts {lens} "
        f"tokens at buckets "
        f"{[_prompt_bucket(n, 2048) for n in lens]}; usage "
        f"{comp['usage']} and {chat['usage']}; {len(chunks)} stream chunks; "
        f"{fa.fwd_launches} B2 launches booked by replays (want "
        f"{cfg.n_layers} x 3)")
    head = {"id", "object", "created", "model", "choices"}
    bad = []
    if not (set(comp) == head | {"usage"} and comp["object"] == "text_completion"
            and comp["usage"] == {"prompt_tokens": lens[0],
                                  "completion_tokens": 16,
                                  "total_tokens": lens[0] + 16}
            and comp["choices"][0]["finish_reason"] == "length"):
        bad.append(f"completion {comp}")
    if not (set(chat) == head | {"usage"} and chat["object"] == "chat.completion"
            and chat["usage"] == {"prompt_tokens": lens[1],
                                  "completion_tokens": 16,
                                  "total_tokens": lens[1] + 16}
            and chat["choices"][0]["message"]["role"] == "assistant"):
        bad.append(f"chat {chat}")
    if not (all(set(c) == head and c["object"] == "chat.completion.chunk"
                for c in chunks)
            and chunks[-1]["choices"][0]["finish_reason"]
            == chat["choices"][0]["finish_reason"]
            and streamed == content[:len(content)
                                    - content.endswith("\ufffd")]):
        bad.append(f"stream {chunks}")
    if on_card and fa.fwd_launches != 3 * cfg.n_layers:
        bad.append(f"{fa.fwd_launches} B2 launches")
    oa.shutdown()
    del oa
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"serve (e): {bad}")
    return b1, b2


def phase_static(fa, llama, llm, cfg, params, card_line, dev):
    """The static engine at Llama-3-8B on phase 4's weights: prefill
    through the flash forward kernel (B2), one CUDA graph per prompt
    bucket; decode from one CUDA graph.  Returns (the measured run's
    numbers, B2's launches on the main path: booked by graph replays)."""
    from ray_tpu_torch.llm.engine import _prompt_bucket

    on_card = dev.type == "cuda"
    conf = llm.LLMConfig(model_config=cfg, kv_cache="static",
                         max_batch_size=8, max_seq_len=2048, decode_chunk=8)
    eng = llm.make_engine(conf, params=params, device=dev)
    nbytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
    v = cfg.vocab_size
    rng = np.random.default_rng(SEED + 1)
    eng.generate([rng.integers(0, v, 64).tolist()],
                 llm.GenerationConfig(max_new_tokens=4))  # captures
    prog = eng._programs.by_width[None]
    if on_card and prog.graph is None:
        raise AssertionError("the static engine's decode chunk is no graph")

    # main path: 10 requests of 100-700 tokens on 8 slots, one sampled
    lens = rng.integers(100, 701, size=10)
    prompts = [rng.integers(0, v, int(n)).tolist() for n in lens]
    greedy = llm.GenerationConfig(max_new_tokens=64)
    hot = llm.GenerationConfig(max_new_tokens=64, temperature=0.8, top_k=40)
    jobs = [(p, hot if i == 3 else greedy) for i, p in enumerate(prompts)]
    buckets = [_prompt_bucket(int(n), eng.max_seq) for n in lens]
    mlens = [512, 300, 700, 450, 256, 640, 380, 600]
    # a bucket's program is made at its first admission (warm-up run, then
    # capture); made here first, so the runs below launch B2 by replays only
    for b in sorted(set(buckets) | {_prompt_bucket(n, eng.max_seq)
                                    for n in mlens}):
        eng._prefill_programs.get(b)
    if on_card and any(p.graph is None
                       for p in eng._prefill_programs.by_width.values()):
        raise AssertionError("a static prefill program is no graph")
    pool_bytes = graph_pool_bytes(eng._programs.pool) if on_card else 0
    pf_pool = graph_pool_bytes(eng._prefill_programs.pool) if on_card else 0
    log(f"static engine [{card_line}]: cache {nbytes / 1e9:.3f} GB "
        f"({conf.max_batch_size} slots x {conf.max_seq_len}), decode graph "
        f"made in {eng._programs.build_s:.2f} s, graph pool "
        f"{pool_bytes / 2**20:.1f} MiB; prefill graphs for buckets "
        f"{sorted(eng._prefill_programs.by_width)} in "
        f"{eng._prefill_programs.build_s:.2f} s, graph pool "
        f"{pf_pool / 2**20:.1f} MiB (B2 in each bucket from 128: "
        f"{[p.flash_launches for _, p in sorted(eng._prefill_programs.by_width.items())]} "
        f"launches a replay)")
    fa.fwd_launches = 0
    t0 = time.perf_counter()
    outs = drive(eng, jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = cfg.n_layers * sum(b >= 128 for b in buckets)
    log(f"static engine: prompts {lens.tolist()} at buckets {buckets}; 10 "
        f"requests x 64 tokens in {wall:.2f} s wall; {fa.fwd_launches} flash "
        f"forward launches (want {cfg.n_layers} x "
        f"{sum(b >= 128 for b in buckets)})")
    for i, o in enumerate(outs):
        if len(o) != 64 or not all(0 <= t < v for t in o):
            raise AssertionError(f"static request {i}: {len(o)} tokens")
    if on_card and fa.fwd_launches != want:
        raise AssertionError("the static prefill did not run the flash "
                             "forward kernel on every layer of every prompt")
    static_launches = fa.fwd_launches

    # B2 at the prefill's shapes: batch 1, 32 q / 8 kv heads
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for s in (256, 1024):
        q3, k3, v3, do = _flash_inputs(dev, gen, 1, s, 32, 8, 128)
        kw = dict(scale=128 ** -0.5, causal=True, n_rep=4)
        _flash_check(fa, q3, k3, v3, do, kw, f"static prefill, B=1, S={s}")
        if on_card:
            ms = time_ms(lambda _: fa.flash_attention_fwd(q3, k3, v3, **kw),
                         reps=10, inner=10)
            log(f"flash fwd at B=1, 32/8 heads, S={s}: {ms:.4f} ms "
                f"[{card_line}]")
    del q3, k3, v3, do

    # the prefill's logits with flash against the reference attention, at
    # the 8 rows the engine samples from (each prompt's last position) and
    # at every position of a 900-token prompt: each difference within
    # FLOOR_TIMES x its noise floor (the flash prefill with one element of
    # layer 0's attention output at each position x (1 + 2**-7), about one
    # bf16 ulp), which a causal mask shifted by one key must break
    mha = llama.multi_head_attention

    def shift(t):  # key j moves to position j + 1; a zero key at 0
        return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], 1)

    def prefill_logits(tokens, mode):
        calls = []

        def attend(q, k, vv, **kw):
            if mode == "reference":
                return mha(q, k, vv, use_flash=False, **kw)
            if mode == "shifted":
                k, vv = shift(k), shift(vv)
            out = mha(q, k, vv, use_flash=True, **kw)
            if mode == "nudged" and not calls:
                out[:, :, 0, 0] *= 1 + 2 ** -7
            calls.append(1)
            return out

        llama.multi_head_attention = attend
        try:
            with torch.no_grad():
                return llama.prefill(cfg, eng.params, tokens, eng._rope)[0][0]
        finally:
            llama.multi_head_attention = mha

    modes = ("flash", "reference", "nudged", "shifted")
    rows = {m: [] for m in modes}
    for n in (512, 300, 700, 450, 256, 640, 380, 600):
        t = torch.as_tensor(rng.integers(0, v, (1, _prompt_bucket(n, 2048))),
                            device=dev)
        for m in modes:
            rows[m].append(prefill_logits(t, m)[n - 1])
    tokens = torch.as_tensor(rng.integers(0, v, (1, 1024)), device=dev)
    plen = 900
    sets = {"the 8 sampled rows": {m: torch.stack(r) for m, r in rows.items()},
            f"all {plen} positions of one prompt": {
                m: prefill_logits(tokens, m)[:plen] for m in modes}}
    ok = True
    for label, out in sets.items():
        if not all(torch.isfinite(x).all() for x in out.values()):
            raise AssertionError("static prefill logits are not finite")
        fl = out["flash"]
        d = {m: (out[m] - fl).abs().max().item() for m in modes[1:]}
        scale = fl.abs().max().item()
        agree = (fl.argmax(-1) == out["reference"].argmax(-1)).float().mean()
        log(f"static prefill, flash vs reference attention at {label}: "
            f"max|dlogits| {d['reference']:.4e} = {d['reference'] / scale:.4f} "
            f"of max|logits| {scale:.4e}, {d['reference'] / d['nudged']:.3f} "
            f"of the noise floor {d['nudged']:.4e} (limit {FLOOR_TIMES} x); "
            f"greedy agreement {agree.item():.3f}; control, causal mask "
            f"shifted by one key: {d['shifted'] / d['nudged']:.3f} x the "
            f"floor (must exceed {FLOOR_TIMES})")
        ok &= (d["reference"] <= FLOOR_TIMES * d["nudged"]
               < d["shifted"])
    del sets, rows
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("static prefill: flash and reference disagree, "
                             "or the limit misses the shifted mask")

    mprompts = [rng.integers(0, v, n).tolist() for n in mlens]
    got, run = measured_run(eng, mprompts, greedy)
    if any(len(t) != 64 for t in got):
        raise AssertionError("static measured run: a request fell short")
    _log_run("static engine, CUDA graphs" if eng._programs.graphs
             else "static engine", card_line, run)
    if on_card:
        b2b = back_to_back_ms(eng, None, list(eng.cache.values()))
        log(f"static engine: decode graph replayed back to back: {b2b:.3f} "
            f"ms of device time per token step [{card_line}]")
    # the eager twin (prefill and decode dispatched op by op) on the same
    # weights and prompts, 8 tokens each (its decode rate is phase 4's
    # eager twin's business): the same greedy tokens; then B2's device
    # time per launch inside the prefill graphs and eagerly
    eager = llm.TorchLLMEngine(conf, params=params, device=dev, _graphs=False)
    got_eager, run_eager = measured_run(eager, mprompts,
                                        llm.GenerationConfig(max_new_tokens=8))
    _log_run("static engine, eager dispatch (8 tokens a request)", card_line,
             run_eager)
    same = sum(a[:8] == b for a, b in zip(got, got_eager))
    log(f"static engine: graphs vs eager greedy tokens identical in {same} of "
        f"8 requests; prefill {run['prefill_tok_s'] / run_eager['prefill_tok_s']:.2f}x "
        f"the eager rate, time to first token "
        f"{run['ttft_mean_ms'] / run_eager['ttft_mean_ms']:.2f}x")
    if same != len(got):
        raise AssertionError("static engine: graph replays and eager dispatch "
                             "gave different greedy tokens")
    if on_card:
        for label, e in (("static engine, CUDA graphs", eng),
                         ("static engine, eager dispatch", eager)):
            prefill_busy(e, mprompts, label, card_line,
                         llm.GenerationConfig(max_new_tokens=2))
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return run, static_launches


def _flash_inputs(dev, gen, b, s, hq, hkv, d):
    def randn(h):
        return torch.randn((b * h, s, d), generator=gen, device=dev,
                           dtype=torch.bfloat16)

    return randn(hq), randn(hkv), randn(hkv), randn(hq)


def _flash_check(fa, q3, k3, v3, do, kw, label):
    """Kernels vs plain versions on one input; returns (max abs errors,
    the plain versions' outputs by name, tolerances)."""
    o, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    # both backwards take the plain forward's O and LSE: the same inputs
    got = dict(zip(("dq", "dk", "dv"),
                   fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)))
    want = dict(zip(("dq", "dk", "dv"),
                    fa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse, do,
                                                      **kw)))
    got.update(o=o, lse=lse)
    want.update(o=ro, lse=rlse)
    torch.cuda.synchronize()
    tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    ratio, err = {}, {}
    for name in ("o", "lse", "dq", "dk", "dv"):
        diff = (got[name].float() - want[name].float()).abs()
        if not torch.isfinite(got[name]).all():
            raise AssertionError(f"flash {label}: {name} is not finite")
        ratio[name] = (diff / tol[name]).max().item()
        err[name] = diff.max().item()
    log(f"flash {label}: max|kernel - plain| " + ", ".join(
        f"{n} {err[n]:.3e} ({ratio[n]:.3f} of tol)" for n in err))
    if max(ratio.values()) > 1:
        raise AssertionError(f"flash {label}: a kernel disagrees with its "
                             f"plain version: {ratio}")
    return err, want, tol


def sass_counts(library, kernels, ops=SASS_OPS):
    """{kernel: {mnemonic: count}} over ``cuobjdump -sass`` of a built
    library, for each function whose name holds one of ``kernels`` (the
    first that it holds)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((k for k in kernels if k in m.group(1)), None)
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
        elif cur:
            for op in ops:
                counts[cur][op] += op in line
    return counts


def phase_flash_sass(library):
    """The flash kernels' design as compiled: wgmma and TMA loads in the
    forward, dK/dV and dQ kernels (delta is a plain 16-byte-load pass)."""
    counts = sass_counts(library, FLASH_KERNELS)
    for k in FLASH_KERNELS:
        c = counts.get(k, dict.fromkeys(SASS_OPS, 0))
        log(f"sass {k}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
        if k != "flash_bwd_delta_kernel" and not (c["HGMMA"] and c["UTMALDG"]):
            raise AssertionError(f"{k} has no wgmma (HGMMA) or no TMA load "
                                 f"(UTMALDG) in its SASS: {c}")
    return counts


def phase_gmm_sass(library, build_log):
    """The grouped-matmul kernels' design as compiled: wgmma (HGMMA) and
    TMA loads (UTMALDG) in gmm (both instantiations) and tgmm, and no
    mma.sync (HMMA) left; with ptxas's registers and spills."""
    for line in build_log.splitlines():
        if "gmm_kernel" in line or "registers" in line or "spill" in line:
            log(f"  ptxas grouped_matmul: {line.strip()}")
    ops = SASS_OPS + ("HMMA",)
    counts = sass_counts(library, tuple(GMM_KERNELS), ops)
    for k, label in GMM_KERNELS.items():
        c = counts.get(k, dict.fromkeys(ops, 0))
        log(f"sass {label} kernel: " + ", ".join(f"{op} {c[op]}" for op in ops))
        if not (c["HGMMA"] and c["UTMALDG"]) or c["HMMA"]:
            raise AssertionError(f"the {label} kernel has no wgmma (HGMMA) or "
                                 f"no TMA load (UTMALDG), or mma.sync (HMMA) "
                                 f"in its SASS: {c}")
    return counts


def phase_flash(fa, dev, shape=(8, 2048, 16, 8, 128)):
    """Flash kernels vs plain versions at the training path's shapes:
    shape = (B, S, Hq, Hkv, D)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, s, hq, hkv, d = shape
    kw = dict(scale=d ** -0.5, causal=True, n_rep=hq // hkv)
    q3, k3, v3, do = _flash_inputs(dev, gen, b, s, hq, hkv, d)
    err, want, tol = _flash_check(fa, q3, k3, v3, do, kw, "causal, group 2")
    ro, rlse = want["o"], want["lse"]
    # no atomics: repeat calls give the same bits
    if not (torch.equal(fa.flash_attention_fwd(q3, k3, v3, **kw)[0],
                        fa.flash_attention_fwd(q3, k3, v3, **kw)[0])
            and all(torch.equal(a, b) for a, b in zip(
                fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw),
                fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)))):
        raise AssertionError("flash: repeat calls differ")

    # negative controls: the last key feeds only the last query row, and
    # only the last query row feeds the last key.  The kernels run without
    # the last key's V (O misses one of that row's terms), without its K
    # (dQ misses one of that row's terms) and without the last dO row
    # (dK and dV miss the last key's only term) must break the tolerance
    def cut(name, got):
        return ((got[:, -1].float() - want[name][:, -1].float()).abs()
                / tol[name][:, -1]).max().item()

    def zero_last(t):
        t = t.clone()
        t[:, -1] = 0
        return t

    cuts = {"o": cut("o", fa.flash_attention_fwd(q3, k3, zero_last(v3), **kw)[0]),
            "dq": cut("dq", fa.flash_attention_bwd(q3, zero_last(k3), v3, ro,
                                                   rlse, do, **kw)[0])}
    _, dk_cut, dv_cut = fa.flash_attention_bwd(q3, k3, v3, ro, rlse,
                                               zero_last(do), **kw)
    cuts.update(dk=cut("dk", dk_cut), dv=cut("dv", dv_cut))
    log(f"flash: without the last of {s} keys, O reaches {cuts['o']:.3f} of "
        f"its tolerance at the last row and dQ {cuts['dq']:.3f}; without the "
        f"last dO row, dK reaches {cuts['dk']:.3f} and dV {cuts['dv']:.3f} at "
        f"the last key")
    if min(cuts.values()) <= 1:
        raise AssertionError(f"the flash tolerance misses a dropped term: {cuts}")
    del dk_cut, dv_cut, tol
    torch.cuda.empty_cache()
    _flash_check(fa, q3, k3, v3, do, dict(kw, causal=False),
                 "non-causal, group 2")
    g1 = _flash_inputs(dev, gen, b, s, hq, hq, d)
    _flash_check(fa, *g1, dict(kw, n_rep=1), "causal, group 1")
    del g1
    # the MoE step's own shape (phase 10: Mixtral heads, [4, 2048])
    g4 = _flash_inputs(dev, gen, 4, s, 32, 8, d)
    _flash_check(fa, *g4, dict(kw, n_rep=4), "causal, group 4 (MoE)")
    del g4
    gc.collect()
    torch.cuda.empty_cache()

    # times at the training shapes (each input 34-67 MB: beyond L2 between
    # launches only in part), per call over runs of 10 back-to-back calls,
    # so the host's launch path (tensor maps, allocation) overlaps the card;
    # and one call per timing, as the earlier mma.sync kernels were timed,
    # which adds that path
    del want
    def fwd(_):
        return fa.flash_attention_fwd(q3, k3, v3, **kw)

    def bwd(_):
        return fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)

    fwd_ms = time_ms(fwd, reps=10, inner=10)
    bwd_ms = time_ms(bwd, reps=10, inner=10)
    fwd_one_ms, bwd_one_ms = time_ms(fwd), time_ms(bwd)
    # device time per kernel: the mean over the launches the profiler saw
    # in five forward and backward calls (it may miss its first few)
    by_kernel, _ = device_ms_by_kernel(
        lambda: [(fwd(0), bwd(0)) for _ in range(5)])
    per_kernel = {}
    for name, (ms, n) in by_kernel.items():
        m = re.search(r"flash_\w+", name)
        if m:
            per_kernel[m.group(0)] = (ms / n, n)
    log("flash: device ms per launch by kernel (torch.profiler over five "
        "forward and backward calls): " + ", ".join(
            f"{k} {ms:.4f} ({n} seen)" for k, (ms, n) in sorted(per_kernel.items())))
    plain_fwd_ms = time_ms(lambda i: fa.flash_attention_fwd_reference(
        q3, k3, v3, **kw), reps=5)
    plain_bwd_ms = time_ms(lambda i: fa.flash_attention_bwd_reference(
        q3, k3, v3, ro, rlse, do, **kw), reps=5)
    # library yardstick (never called by the port): SDPA in [B, H, S, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.enable_grad():
        q4, k4, v4 = (t.view(b, -1, s, d).detach().requires_grad_()
                      for t in (q3, k3, v3))
        def lib_fwd(_):
            return sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)

        lib_fwd_ms = time_ms(lib_fwd, reps=10, inner=10)
        out4 = lib_fwd(0)
        do4 = do.view(b, hq, s, d)

        def lib_bwd(_):
            return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                       retain_graph=True)

        lib_bwd_ms = time_ms(lib_bwd, reps=10, inner=10)
        lib_fwd_one_ms, lib_bwd_one_ms = time_ms(lib_fwd), time_ms(lib_bwd)
    lib_err = (out4.detach().reshape(b * hq, s, d).float()
               - ro.float()).abs().max().item()
    del out4, q4, k4, v4

    pairs = s * (s + 1) // 2  # causal (query, key) pairs per head
    fwd_flops = 4 * b * hq * d * pairs  # QK^T and PV
    bwd_flops = 10 * b * hq * d * pairs  # S again, dV, dP, dQ, dK
    qb, kb = q3.numel() * 2, k3.numel() * 2
    fwd_bytes = qb + 2 * kb + qb + b * hq * s * 4  # q, k, v in; O, LSE out
    bwd_bytes = (qb + 2 * kb + 2 * qb + b * hq * s * 4  # q, k, v, O, dO, LSE
                 + qb + 2 * kb)  # dq, dk, dv in bf16
    rows = {}
    for name, ms, one, plain, lib, lib_one, flops, nbytes, e in (
            ("fwd", fwd_ms, fwd_one_ms, plain_fwd_ms, lib_fwd_ms,
             lib_fwd_one_ms, fwd_flops, fwd_bytes, err["o"]),
            ("bwd", bwd_ms, bwd_one_ms, plain_bwd_ms, lib_bwd_ms,
             lib_bwd_one_ms, bwd_flops, bwd_bytes,
             max(err["dq"], err["dk"], err["dv"]))):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        log(f"flash {name}: kernel {ms:.4f} ms (one call per timing: "
            f"{one:.4f})  plain {plain:.4f} ms  SDPA {lib:.4f} ms (one call "
            f"per timing: {lib_one:.4f}); bound {bound:.4f} ms ({flops:.4g} "
            f"flops at 989 TFLOP/s: {ops_ms:.4f} ms; {nbytes} bytes at 3.35 "
            f"TB/s: {bytes_ms:.4f} ms) -> {100 * bound / ms:.1f}% of bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        rows[name] = {"max_abs_err": e, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound,
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                      "library_ms": lib}
    log(f"flash: SDPA's own max err vs the plain forward {lib_err:.2e} "
        f"(its bf16 output rounding)")
    return rows


def headline_config(llama, param_dtype=torch.float32):
    """bench.py's headline training config (bf16 compute; bench.py stores
    its params in bf16, phase 7 runs fp32 beside it)."""
    return llama.LlamaConfig(vocab_size=32768, dim=2048, n_layers=16,
                             n_heads=16, n_kv_heads=8, ffn_dim=8192,
                             max_seq_len=2048, param_dtype=param_dtype)


def headline_optimizer(parallel):
    """bench.py's headline optimizer: optax.adamw(3e-4, b1=0.9, b2=0.95,
    weight_decay=0.1, mu_dtype=bf16), as the port's description."""
    return parallel.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1,
                          mu_dtype=torch.bfloat16)


def _state_line(cfg, parallel, state) -> str:
    adam = parallel.optim.find_adam_state(state.opt_state)
    mu = next(iter(parallel.train_step.tree_leaves(adam.mu))).dtype
    return (f"{cfg.param_dtype} params and nu, {mu} mu, {cfg.compute_dtype} "
            f"products")


def timed_steps(step_fn, state, tokens, steps):
    """``steps`` steps back to back: (metrics list, seconds per step)."""
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, tokens)
        metrics.append(m)
    torch.cuda.synchronize()
    return metrics, (time.perf_counter() - t0) / steps


def phase_train(fa, llama, parallel, card_line, dev, cfg=None, b=8, s=2048,
                optimizer=None, label="train", profile=True):
    """Five timed AdamW steps of ``cfg`` (default: the headline config) on
    a [b, s] batch after a warm-up step; returns a dict with the config,
    state, tokens, step_fn, the run's (forward, backward) flash launch
    counts and its step ms, tokens/s, MFU and peak memory."""
    on_card = dev.type == "cuda"
    cfg = cfg or headline_config(llama)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_fn, step_fn = parallel.make_train_step(cfg, device=dev,
                                                optimizer=optimizer)
    state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    state, warm = step_fn(state, tokens)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.num_params / 1e9:.3f} B params "
        f"({_state_line(cfg, parallel, state)}), built and warmed up in "
        f"{time.perf_counter() - t0:.1f} s")
    steps = 5
    fa.fwd_launches = fa.bwd_launches = 0
    metrics, step_s = timed_steps(step_fn, state, tokens, steps)
    launches = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(warm["loss"])] + [float(m["loss"]) for m in metrics]
    norms = [float(warm["grad_norm"])] + [float(m["grad_norm"]) for m in metrics]
    log(f"{label}: losses {[round(x, 5) for x in losses]}, grad norms "
        f"{[round(x, 5) for x in norms]}")
    log(f"{label}: {steps} steps, {launches[0]} forward and {launches[1]} "
        f"backward flash launches (want {2 * cfg.n_layers * steps} and "
        f"{cfg.n_layers * steps})")
    if on_card and launches != (2 * cfg.n_layers * steps, cfg.n_layers * steps):
        raise AssertionError("the training step did not run the flash kernels "
                             "on every layer (forward, recompute, backward)")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on a repeated batch")
    tok_s = b * s / step_s
    fpt = llama.flops_per_token(cfg, s)
    # the step's own work: causal attention (half of flops_per_token's
    # 12 L d s) and no product for the embedding gather (unless tied)
    fpt_step = (fpt - 6 * cfg.n_layers * cfg.dim * s
                - (0 if cfg.tie_embeddings else 6 * cfg.vocab_size * cfg.dim))
    mfu = fpt * tok_s / BF16_FLOPS_PER_S
    log(f"{label} [{card_line}]: {step_s * 1e3:.1f} ms per step, "
        f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} "
        f"(flops_per_token {fpt:.4g} at 989 TFLOP/s: the JAX package's "
        f"count, full attention and the embedding table included); "
        f"{fpt_step * tok_s / BF16_FLOPS_PER_S:.4f} at {fpt_step:.4g} flops "
        f"per token (causal attention, no embedding gather); peak "
        f"{peak:.2f} GiB allocated")
    if profile:
        profile_train_step(step_fn, state, tokens, card_line)
    return {"cfg": cfg, "state": state, "tokens": tokens, "step_fn": step_fn,
            "optimizer": optimizer, "launches": launches,
            "step_ms": step_s * 1e3, "tok_s": tok_s, "mfu": mfu,
            "peak_gib": peak, "losses": losses}


def device_ms_by_kernel(fn):
    """torch.profiler over one call of ``fn``: ({kernel name: (device ms,
    launches)}, wall ms of the profiled window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name, wall_ms


def profile_train_step(step_fn, state, tokens, card_line):
    """Where one training step's time goes: torch.profiler over one step;
    device busy time is the sum of the CUDA kernels it saw."""
    by_name, wall_ms = device_ms_by_kernel(lambda: step_fn(state, tokens))
    if not by_name:
        log("profile: the profiler saw no CUDA kernels; step breakdown not "
            "measured")
        return
    busy = sum(ms for ms, _ in by_name.values())
    log(f"profile [{card_line}]: one training step, {wall_ms:.1f} ms "
        f"profiled window, device busy {busy:.1f} ms (busy share "
        f"{busy / wall_ms:.3f}, profiler on), {sum(n for _, n in by_name.values())} "
        f"kernel launches")
    kinds = {}
    for name, (ms, n) in by_name.items():
        low = name.lower()
        kind = ("flash attention kernels" if "flash_" in low else
                "grouped matmul kernels (gmm, tgmm)" if "gmm_kernel" in low else
                "cuBLAS GEMMs" if any(w in low for w in ("nvjet", "gemm",
                                                          "cutlass")) else
                "all other kernels (elementwise, copies, reductions)")
        kms, kn = kinds.get(kind, (0.0, 0))
        kinds[kind] = (kms + ms, kn + n)
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:9.3f} ms  {ms / busy:6.3f} of busy  {n:6d} launches  {kind}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:9.3f} ms  {ms / busy:6.3f} of busy  {n:6d} launches  "
            f"{name[:90]}")


def _named_leaves(tree, prefix=""):
    """(name, tensor) pairs in ``tree_leaves``' sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _over(a: float, b: float) -> float:
    return a / b if b else (0.0 if a == 0 else math.inf)


def phase_train_ab(llama, parallel, cfg, state, tokens):
    """The training step's loss and gradients (what step_fn computes before
    its AdamW update) from one state, through the flash kernels and through
    reference_attention.

    Each difference from the flash run -- the loss, the grad norm, and per
    parameter leaf the L2 norm of the gradient difference -- must stay
    within FLOOR_TIMES times the same difference of the noise floor: the
    flash run with every attention output nudged by 2**-8 of itself (about
    half of them then round one bf16 ulp away), as a root mean square over
    NOISE_DRAWS independent nudges.  Two faults of the kind a
    kernel could have must break that limit: a causal mask shifted by one
    key (each query sees a zero key and the keys before it, not its own),
    and the dK of every second q head of a GQA group dropped (as if the
    dK/dV kernel's loop over the group stopped after its first head)."""
    dev = tokens.device
    rope = llama.rope_cache(cfg, cfg.max_seq_len, dev)
    names, leaves = zip(*_named_leaves(state.params))
    mha = llama.multi_head_attention
    flash = functools.partial(mha, use_flash=True)

    def run(attn):
        llama.multi_head_attention = attn
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = llama.loss_fn(cfg, state.params, tokens, rope_cache=rope)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            llama.multi_head_attention = mha
            for p in leaves:
                p.requires_grad_(False)
        return (float(loss.detach()),
                float(parallel.train_step.global_norm(grads)), grads)

    loss0, norm0, grads0 = run(flash)
    values = {}

    def diffs(label, attn):
        loss, norm, grads = run(attn)
        values[label] = (loss, norm)
        d = {"loss": abs(loss - loss0), "grad norm": abs(norm - norm0)}
        for n, g, g0 in zip(names, grads, grads0):
            d[n] = float((g - g0).norm())
        return d

    ref = diffs("reference_attention", functools.partial(mha, use_flash=False))
    shape = (tokens.shape[0], tokens.shape[1], cfg.n_heads, cfg.head_dim)

    def nudged_by(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        nudge = 1 + 2.0 ** -8 * (torch.randint(0, 2, shape, generator=gen,
                                               device=dev) * 2 - 1)

        def nudged(*args, **kw):  # the same nudge in the forward and its recompute
            out = flash(*args, **kw)
            return (out.float() * nudge).to(out.dtype)
        return nudged

    def shifted(q, k, v, **kw):
        def shift(t):  # key j moves to position j + 1; a zero key at 0
            return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], 1)
        return flash(q, shift(k), shift(v), **kw)

    def half_dk(q, k, v, **kw):
        b, s, hkv, d = k.shape
        groups = q.reshape(b, s, hkv, -1, d)  # q head h = kv head * n_rep + r
        outs = [flash(groups[:, :, :, r], k if r == 0 else k.detach(), v, **kw)
                for r in range(groups.shape[3])]
        return torch.stack(outs, 3).reshape(q.shape)

    # one nudge's change of the loss is a sum of terms of random sign and
    # can cancel to almost nothing (7.6e-6 where another run on nearly the
    # same state drew 2.7e-4): each row's floor is the root mean square
    # over NOISE_DRAWS independent nudges
    draws = [diffs(f"noise floor {i}", nudged_by(SEED + 2 + i))
             for i in range(NOISE_DRAWS)]
    floor = {k: math.sqrt(sum(d[k] ** 2 for d in draws) / len(draws))
             for k in draws[0]}
    controls = {"causal mask shifted by one key": diffs("shifted mask", shifted),
                "dK of every second q head dropped": diffs("half dK", half_dk)}
    del grads0
    if not all(math.isfinite(x) for d in (ref, floor, *controls.values())
               for x in d.values()) or not math.isfinite(loss0 + norm0):
        raise AssertionError("a training-step loss or gradient is not finite")
    log(f"flash vs reference_attention step: loss {loss0:.6f} vs "
        f"{values['reference_attention'][0]:.6f}, grad norm {norm0:.6f} vs "
        f"{values['reference_attention'][1]:.6f}; each |d| against the noise "
        f"floor's (every attention output x (1 +- 2**-8), the RMS over "
        f"{NOISE_DRAWS} nudges), limit {FLOOR_TIMES} x the floor:")
    for k in ref:
        log(f"  {k:20s} |d| {ref[k]:.4e}  floor {floor[k]:.4e} (draws "
            f"{' '.join(f'{d[k]:.2e}' for d in draws)})  "
            f"{_over(ref[k], floor[k]):.3f} of the floor")
    worst = max(_over(ref[k], floor[k]) for k in ref)
    for label, d in controls.items():
        k = max(d, key=lambda k: _over(d[k], floor[k]))
        log(f"control, {label}: loss |d| {d['loss']:.4e}, grad norm |d| "
            f"{d['grad norm']:.4e}; largest {k}, {_over(d[k], floor[k]):.1f} x "
            f"the floor")
        if _over(d[k], floor[k]) <= FLOOR_TIMES:
            raise AssertionError(f"the step comparison misses a {label}")
    if worst > FLOOR_TIMES:
        raise AssertionError("the flash and reference training steps disagree")
    return {"worst_share_of_floor": worst}


def loss_and_grads(model, cfg, params, tokens, rope):
    """What step_fn computes before its update: (loss, grads in
    ``tree_leaves`` order)."""
    from ray_tpu_torch.parallel.train_step import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss_fn(cfg, params, tokens, rope_cache=rope)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


# flash launches per Llama step under each remat policy, per layer:
# (forward, backward).  "full" and "dots" run the forward kernel again in
# the recompute; "attn" keeps its O and LSE
REMAT_FLASH = {"full": (2, 1), "attn": (1, 1), "dots": (2, 1)}


def phase_remat(fa, llama, parallel, card_line, run, steps=3):
    """Phase 7r: the remat policies on the bf16 headline's state.  One
    step's gradients (the loss and grads before the update) under "attn"
    and "dots" must be bit for bit "full"'s, with the flash launches of
    REMAT_FLASH; then per policy a warm-up and ``steps`` timed steps: step
    ms, the launches per step, peak memory.  Returns {policy: row} and the
    flash launches of the timed steps."""
    cfg0, state, tokens = run["cfg"], run["state"], run["tokens"]
    on_card = tokens.device.type == "cuda"
    rope = llama.rope_cache(cfg0, cfg0.max_seq_len, tokens.device)
    L = cfg0.n_layers
    grads, rows = {}, {}
    for policy in ("full", "attn", "dots"):
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        fa.fwd_launches = fa.bwd_launches = 0
        loss, grads[policy] = loss_and_grads(llama, cfg, state.params, tokens,
                                             rope)
        got = (fa.fwd_launches, fa.bwd_launches)
        want = tuple(n * L for n in REMAT_FLASH[policy])
        same = all(torch.equal(a, b) for a, b in zip(grads[policy],
                                                     grads["full"]))
        log(f"remat {policy}: loss {float(loss):.6f}, flash launches "
            f"{got} (want {want}), gradients bit-identical to full's: {same}")
        if on_card and got != want:
            raise AssertionError(f"remat {policy!r}: flash launches {got}, "
                                 f"want {want}")
        if not same:
            raise AssertionError(f"remat {policy!r}: gradients differ from "
                                 f"the 'full' policy's")
    del grads
    launches = [0, 0]
    for policy in ("attn", "dots"):
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        _, step_fn = parallel.make_train_step(cfg, device=tokens.device,
                                              optimizer=run["optimizer"])
        step_fn(state, tokens)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.bwd_launches = 0
        metrics, step_s = timed_steps(step_fn, state, tokens, steps)
        got = (fa.fwd_launches // steps, fa.bwd_launches // steps)
        launches[0] += fa.fwd_launches
        launches[1] += fa.bwd_launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["loss"]) for m in metrics]
        want = tuple(n * L for n in REMAT_FLASH[policy])
        log(f"remat {policy} [{card_line}]: {step_s * 1e3:.1f} ms per step "
            f"(full: {run['step_ms']:.1f}), {got[0]} forward and {got[1]} "
            f"backward flash launches per step (want {want}), peak "
            f"{peak:.2f} GiB allocated (full: {run['peak_gib']:.2f}); losses "
            f"{[round(x, 5) for x in losses]}")
        if on_card and got != want:
            raise AssertionError(f"remat {policy!r}: {got} flash launches "
                                 f"per step, want {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"remat {policy!r}: a loss is not finite")
        rows[policy] = {"step_ms": step_s * 1e3, "launches": got,
                        "peak_gib": peak}
    return rows, tuple(launches)


def _codec_bound_ms(grads) -> float:
    """The least time of one error-feedback coding pass: each gradient
    read and its coded copy written, each fp32 residual read and written
    (12 bytes a bf16 parameter), at the HBM rate."""
    n = sum(g.numel() * (2 * g.element_size() + 8) for g in grads)
    return n / HBM_BYTES_PER_S * 1e3


def phase_compressed(fa, llama, parallel, card_line, run, steps=3):
    """Phase 7c: int8 gradient compression with error feedback on the bf16
    headline (the residual chained before AdamW, as optax's chain nests
    it).  The torch codec on one real gradient leaf (wq's, on the card)
    against the numpy codec (host), codes and scales bit for bit; the
    coding pass's device ms (CUDA events) beside its bound; then a warm-up
    and ``steps`` timed compressed steps beside the uncompressed step's
    ms.  Returns the row and the flash launches of the timed steps."""
    from ray_tpu_torch.parallel.train_step import TrainState
    from ray_tpu_torch.util.collective import compression as comp

    cfg, state, tokens = run["cfg"], run["state"], run["tokens"]
    dev = tokens.device
    rope = llama.rope_cache(cfg, cfg.max_seq_len, dev)
    _, grads = loss_and_grads(llama, cfg, state.params, tokens, rope)
    names = [n for n, _ in _named_leaves(state.params)]
    g = grads[names.index("layers/wq")]
    flat = torch.nn.functional.pad(g.reshape(-1),
                                   (0, (-g.numel()) % comp.DEFAULT_BLOCK_SIZE))
    codes, scales = comp.torch_quantize_blocks(flat)
    want_codes, want_scales = comp.quantize_blocks(
        g.float().cpu().numpy())
    same = (np.array_equal(codes.cpu().numpy(), want_codes)
            and np.array_equal(scales.cpu().numpy().view(np.uint32),
                               want_scales.view(np.uint32)))
    log(f"codec: wq's gradient {tuple(g.shape)} {g.dtype} on "
        f"{codes.device}: {want_codes.size:,} codes, {want_scales.size:,} "
        f"scales, bit-identical to the numpy codec's: {same}")
    if not same:
        raise AssertionError("the torch codec disagrees with the numpy codec")
    spec = {"error_feedback": True}
    coder = comp.compress_gradients(spec)
    residual = coder.init(state.params)
    coder.update(grads, residual)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    coder.update(grads, residual)
    end.record()
    torch.cuda.synchronize()
    codec_ms = start.elapsed_time(end)
    bound_ms = _codec_bound_ms(grads)
    log(f"codec [{card_line}]: one error-feedback coding pass over every "
        f"gradient leaf {codec_ms:.2f} ms of device time, bound "
        f"{bound_ms:.2f} ms (12 bytes a parameter at 3.35 TB/s)")
    del grads, residual
    _, step_fn = parallel.make_train_step(cfg, device=dev,
                                          optimizer=run["optimizer"],
                                          grad_compression=spec)
    cstate = TrainState(state.step, state.params,
                        (coder.init(state.params), state.opt_state))
    step_fn(cstate, tokens)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.bwd_launches = 0
    metrics, step_s = timed_steps(step_fn, cstate, tokens, steps)
    launches = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    log(f"compressed [{card_line}]: {step_s * 1e3:.1f} ms per step "
        f"(uncompressed: {run['step_ms']:.1f}), peak {peak:.2f} GiB "
        f"allocated (with the fp32 residual), losses "
        f"{[round(x, 5) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a compressed step's loss is not finite")
    return {"step_ms": step_s * 1e3, "codec_ms": codec_ms,
            "codec_bound_ms": bound_ms, "peak_gib": peak}, launches


def phase_snapshot(fa, parallel, card_line, run, steps=3):
    """Phase 7s: an async snapshot of the bf16 headline's state (params,
    mu and nu, ~6.9 GB) into a temporary directory.  save()'s blocking ms
    (the stall) against the persist seconds and bytes; the state updated
    in place (``steps`` steps) right after save(); the snapshot restored
    into a fresh state, which must run the same ``steps`` losses bit for
    bit; a second save of that fresh state (no step since the first) must
    write no leaf bytes.  Returns the row and the flash launches."""
    import tempfile

    from ray_tpu_torch.parallel.train_step import tree_leaves
    from ray_tpu_torch.train._internal import snapshot as snap

    state, tokens, step_fn = run["state"], run["tokens"], run["step_fn"]
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snapshot_")
    usage = shutil.disk_usage(tmp)
    log(f"snapshot: {tmp}: {usage.free / 1e9:.1f} GB free of "
        f"{usage.total / 1e9:.1f}; the state is {nbytes / 1e9:.3f} GB in "
        f"{len(tree_leaves(state))} leaves")
    launches = [0, 0]
    mgr = snap.SnapshotManager(tmp)
    try:
        torch.cuda.synchronize()
        embed0 = state.params["embed"].clone()
        fa.fwd_launches = fa.bwd_launches = 0
        mgr.save(state)
        stall_ms = mgr.stall_seconds * 1e3
        through = [float(step_fn(state, tokens)[1]["loss"])
                   for _ in range(steps)]
        torch.cuda.synchronize()
        if not mgr.wait(600):
            raise AssertionError("the snapshot did not commit in 600 s")
        persist_s, written = mgr.persist_seconds, mgr.bytes_written["full"]
        if mgr.last_error is not None:
            raise AssertionError(f"the snapshot failed: {mgr.last_error!r}")
        log(f"snapshot [{card_line}]: save() blocked {stall_ms:.1f} ms; the "
            f"writer took {persist_s:.2f} s for {written / 1e9:.3f} GB "
            f"({written / persist_s / 1e9:.2f} GB/s, fsync on), while "
            f"{steps} steps ran")
        t0 = time.perf_counter()
        fresh = snap.restore_snapshot(
            os.path.join(tmp, snap.snapshot_dir_name(1)), target=state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not torch.equal(fresh.params["embed"], embed0):
            raise AssertionError("the snapshot holds bytes written after "
                                 "save() (the in-place steps leaked)")
        del embed0
        mgr.save(fresh)  # the state at the first save: nothing changed
        stall2_ms = mgr.stall_seconds * 1e3 - stall_ms
        if not mgr.wait(600) or mgr.last_error is not None:
            raise AssertionError(f"the second snapshot failed: "
                                 f"{mgr.last_error!r}")
        delta = mgr.bytes_written["delta"]
        resumed = [float(step_fn(fresh, tokens)[1]["loss"])
                   for _ in range(steps)]
        torch.cuda.synchronize()
        launches = [fa.fwd_launches, fa.bwd_launches]
        log(f"snapshot: restored into a fresh state in {restore_s:.2f} s; a "
            f"second save (no step since) blocked {stall2_ms:.1f} ms, took "
            f"{mgr.persist_seconds - persist_s:.2f} s (hashing) and wrote "
            f"{delta} leaf bytes; losses from the live state "
            f"{through}, from the restored state {resumed}")
        if delta:
            raise AssertionError(f"a save with no step between wrote {delta} "
                                 f"leaf bytes")
        if resumed != through or not all(math.isfinite(x) for x in through):
            raise AssertionError("the restored state's steps differ from the "
                                 "live state's")
        del fresh
    finally:
        mgr.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"stall_ms": stall_ms, "persist_s": persist_s, "bytes": written,
            "restore_s": restore_s}, tuple(launches)


# the step's grouped matmuls at Mixtral-8x7B's widths (d, f) per layer:
# (label, K, N, transpose_rhs, launches per layer)
GMM_VARIANTS = (("gate/up", 0, 1, False, 4),   # forward and recompute
                ("down", 1, 0, False, 2),
                ("dlhs of gate/up", 1, 0, True, 2),
                ("dlhs of down", 0, 1, True, 1))
TGMM_VARIANTS = (("drhs of gate/up", 0, 1, 2), ("drhs of down", 1, 0, 1))


def _gmm_ratio(got, want, tol):
    return ((got.float() - want.float()).abs() / tol).max().item()


def _library_gmm(gm, lhs, rhs, gs, transpose_rhs=False):
    """The library's grouped matmul for a gmm call: torch._grouped_mm where
    this torch has it and takes the case, else one torch.mm per group over
    host-side offsets.  Returns (a function of no arguments, its name)."""
    b = rhs.transpose(-2, -1) if transpose_rhs else rhs
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        out = torch._grouped_mm(lhs, b, offs=offs)
        want = gm.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose_rhs)
        if ((out.float() - want.float()).abs()
                <= gm.kernel_tolerance("gmm", lhs, rhs, gs,
                                       transpose_rhs=transpose_rhs)).all():
            return (lambda: torch._grouped_mm(lhs, b, offs=offs)), "torch._grouped_mm"
    except (AttributeError, RuntimeError):
        pass
    spans = gm._spans(gs, lhs.shape[0])
    out = torch.empty((lhs.shape[0], b.shape[-1]), dtype=lhs.dtype,
                      device=lhs.device)

    def loop():
        for g, (a, e) in enumerate(spans):
            torch.mm(lhs[a:e], b[g], out=out[a:e])
        return out
    return loop, "torch.mm per group"


def _library_tgmm(gm, lhs_t, grad, gs):
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        out = torch._grouped_mm(lhs_t, grad, offs=offs)
        if ((out.float() - gm.tgmm_reference(lhs_t, grad, gs).float()).abs()
                <= gm.kernel_tolerance("tgmm", lhs_t, grad, gs)).all():
            return (lambda: torch._grouped_mm(lhs_t, grad, offs=offs)), "torch._grouped_mm"
    except (AttributeError, RuntimeError):
        pass
    spans = gm._spans(gs, grad.shape[0])
    out = torch.empty((len(spans), lhs_t.shape[0], grad.shape[1]),
                      dtype=grad.dtype, device=grad.device)

    def loop():
        for g, (a, e) in enumerate(spans):
            torch.mm(lhs_t[:, a:e], grad[a:e], out=out[g])
        return out
    return loop, "torch.mm per group"


def _kernel_device_ms(fn, name, calls=5):
    """Mean device ms per launch of the kernels whose name holds ``name``
    (and not "t" + name), from torch.profiler over ``calls`` calls of
    ``fn``; None when the profiler saw none."""
    by_kernel, _ = device_ms_by_kernel(lambda: [fn() for _ in range(calls)])
    hits = [(ms, n) for k, (ms, n) in by_kernel.items()
            if name in k and "t" + name not in k]
    n = sum(n for _, n in hits)
    return sum(ms for ms, _ in hits) / n if n else None


def _straddled(ends):
    """The first group g whose end lies inside a 128-row tile and whose
    next group has rows (group ends ``ends``)."""
    return next(g for g in range(len(ends) - 1)
                if ends[g] % 128 and ends[g + 1] > ends[g])


def _gmm_bound(nbytes, flops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_grouped_matmul(gm, moe, dev, cfg=None, tokens=8192):
    """gmm and tgmm vs their plain versions at the MoE step's shapes, with
    negative controls, repeat-call identity and times.  Returns the two
    kernels' JSON rows (times: launch-weighted means over the step's
    variants)."""
    cfg = cfg or mixtral_config(moe)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    e, dims = cfg.n_experts, (cfg.dim, cfg.ffn_dim)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16) * std

    # group sizes from a real routing: random tokens' hidden states through
    # a router drawn as init_params draws it
    router = torch.randn((cfg.dim, e), generator=gen, device=dev) * 0.02
    _, idx, _ = moe._router(cfg, randn(tokens, cfg.dim), {"router": router})
    _, routed = moe._sorted_order(idx.reshape(-1), e)
    m = tokens * cfg.experts_per_token
    cut = [3000, 0, 77, 4000, 2307, 3000, 2000, 2000]  # empty; under a tile
    special = torch.tensor(cut[:e - 1] + [m - sum(cut[:e - 1])],
                           dtype=torch.int32, device=dev)
    log(f"gmm: routed group sizes {routed.tolist()} (M = {m}); special case "
        f"{special.tolist()}")
    err = {"gmm": 0.0, "tgmm": 0.0}

    def check(op, got, x, y, gs, label, **kw):
        ref = (gm.gmm_reference(x, y, gs, **kw) if op == "gmm"
               else gm.tgmm_reference(x, y, gs))
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{op} {label}: not finite")
        tol = gm.kernel_tolerance(op, x, y, gs, **kw)
        ratio = _gmm_ratio(got, ref, tol)
        e_abs = (got.float() - ref.float()).abs().max().item()
        err[op] = max(err[op], e_abs)
        log(f"{op} {label}: max|kernel - plain| {e_abs:.3e}, {ratio:.3f} of "
            f"kernel_tolerance")
        if ratio > 1:
            raise AssertionError(f"{op} {label}: kernel disagrees with its "
                                 f"plain version ({ratio:.3f} of tolerance)")
        return ref, tol

    lhs = {0: randn(m, dims[0]), 1: randn(m, dims[1])}  # [M, d], [M, f]
    rows, gmm_rows, tgmm_rows, dev_ms = [], {}, {}, {}
    for label, ki, ni, trans, per_layer in GMM_VARIANTS:
        k, n = dims[ki], dims[ni]
        rhs = randn(e, n, k) if trans else randn(e, k, n)
        x = lhs[ki]
        out = gm.gmm(x, rhs, routed, transpose_rhs=trans)
        ref, tol = check("gmm", out, x, rhs, routed, label, transpose_rhs=trans)
        if not torch.equal(out, gm.gmm(x, rhs, routed, transpose_rhs=trans)):
            raise AssertionError(f"gmm {label}: repeat calls differ")
        if label == "gate/up":
            check("gmm", gm.gmm(x, rhs, special), x, rhs, special,
                  "gate/up, empty and sub-tile groups")
            # control: the first row of the group after the first boundary
            # inside a tile, computed with the group before it
            ends = torch.cumsum(routed, 0).tolist()
            g = _straddled(ends)
            moved = routed.clone()
            moved[g] += 1
            moved[g + 1] -= 1
            row = ends[g]
            bad = gm.gmm(x, rhs, moved)
            hit = _gmm_ratio(bad[row], ref[row], tol[row])
            log(f"gmm control: row {row} moved from group {g + 1} to {g} "
                f"reaches {hit:.1f} x the tolerance")
            if hit <= 1:
                raise AssertionError("the gmm tolerance misses a moved row")
        del ref, tol
        run, lib_name = _library_gmm(gm, x, rhs, routed, trans)
        ms = time_ms(lambda i: gm.gmm(x, rhs, routed, transpose_rhs=trans))
        dev_ms[label] = _kernel_device_ms(
            lambda: gm.gmm(x, rhs, routed, transpose_rhs=trans), "gmm_kernel")
        plain = time_ms(lambda i: gm.gmm_reference(x, rhs, routed,
                                                   transpose_rhs=trans), reps=3)
        lib = time_ms(lambda i: run())
        nbytes = x.numel() * 2 + rhs.numel() * 2 + e * 4 + m * n * 2
        bound, by = _gmm_bound(nbytes, 2 * m * k * n)
        log(f"gmm {label} (K {k}, N {n}): kernel {ms:.4f} ms  plain {plain:.4f} "
            f"ms  library ({lib_name}) {lib:.4f} ms; bound {bound:.4f} ms "
            f"({by}) -> {100 * bound / ms:.1f}% of bound, "
            f"{2 * m * k * n / ms / 1e9:.1f} TFLOP/s")
        gmm_rows[label] = (per_layer, ms, plain, lib, bound, by)
        del rhs, out, run
        gc.collect()
        torch.cuda.empty_cache()

    for label, ki, ni, per_layer in TGMM_VARIANTS:
        x, grad = lhs[ki], randn(m, dims[ni])
        out = gm.tgmm(x.t(), grad, routed)
        ref, tol = check("tgmm", out, x.t(), grad, routed, label)
        if not torch.equal(out, gm.tgmm(x.t(), grad, routed)):
            raise AssertionError(f"tgmm {label}: repeat calls differ")
        if ki == 0:
            check("tgmm", gm.tgmm(x.t(), grad, special), x.t(), grad, special,
                  f"{label}, empty and sub-tile groups")
            # control: the last row of group 1 left out of its sum
            last = int(routed[:2].sum()) - 1
            cut_grad = grad.clone()
            cut_grad[last] = 0
            hit = _gmm_ratio(gm.tgmm(x.t(), cut_grad, routed)[1], ref[1], tol[1])
            log(f"tgmm control: row {last} (the last of group 1) left out "
                f"reaches {hit:.1f} x the tolerance")
            if hit <= 1:
                raise AssertionError("the tgmm tolerance misses a dropped row")
            del cut_grad
        del ref, tol
        run, lib_name = _library_tgmm(gm, x.t(), grad, routed)
        ms = time_ms(lambda i: gm.tgmm(x.t(), grad, routed))
        dev_ms[label] = _kernel_device_ms(
            lambda: gm.tgmm(x.t(), grad, routed), "tgmm_kernel")
        plain = time_ms(lambda i: gm.tgmm_reference(x.t(), grad, routed), reps=3)
        lib = time_ms(lambda i: run())
        k, n = x.shape[1], grad.shape[1]
        nbytes = x.numel() * 2 + grad.numel() * 2 + e * 4 + e * k * n * 2
        bound, by = _gmm_bound(nbytes, 2 * m * k * n)
        log(f"tgmm {label} (K {k}, N {n}): kernel {ms:.4f} ms  plain "
            f"{plain:.4f} ms  library ({lib_name}) {lib:.4f} ms; bound "
            f"{bound:.4f} ms ({by}) -> {100 * bound / ms:.1f}% of bound, "
            f"{2 * m * k * n / ms / 1e9:.1f} TFLOP/s")
        tgmm_rows[label] = (per_layer, ms, plain, lib, bound, by)
        del grad, out, run
        gc.collect()
        torch.cuda.empty_cache()

    for op, table in (("gmm", gmm_rows), ("tgmm", tgmm_rows)):
        w = sum(r[0] for r in table.values())

        def mean(i):
            return sum(r[0] * r[i] for r in table.values()) / w

        rows.append({"max_abs_err": err[op], "ms": mean(1), "plain_ms": mean(2),
                     "bound_ms": mean(4),
                     "bound_by": table[next(iter(table))][5],
                     "library_ms": mean(3)})
        log(f"{op}: per launch on the step, weighted by launches per layer "
            f"{[r[0] for r in table.values()]}: kernel {mean(1):.4f} ms, "
            f"plain {mean(2):.4f}, library {mean(3):.4f}, bound {mean(4):.4f}")
        if all(dev_ms[k] is not None for k in table):
            log(f"{op}: device ms per launch (torch.profiler, 5 calls a "
                f"variant), launch-weighted "
                f"{sum(r[0] * dev_ms[k] for k, r in table.items()) / w:.4f}: "
                + ", ".join(f"{k} {dev_ms[k]:.4f}" for k in table))
        else:
            log(f"{op}: device ms per launch not measured: the profiler saw "
                f"no {op} kernel in some variant's calls")
    return rows


def mixtral_config(moe):
    """Mixtral-8x7B's published width (the repo's preset), 2 layers deep."""
    return moe.MoEConfig.mixtral_8x7b(n_layers=2, max_seq_len=2048)


def phase_moe_train(fa, gm, moe, parallel, card_line, dev, cfg=None, b=4,
                    s=2048):
    """Five timed AdamW steps of ``cfg`` (default: Mixtral-8x7B width, 2
    layers) on a [b, s] batch; returns the config, state, tokens and the
    main run's (gmm, tgmm) launch counts."""
    on_card = dev.type == "cuda"
    cfg = cfg or mixtral_config(moe)
    t0 = time.perf_counter()
    init_fn, step_fn = parallel.make_train_step(cfg, device=dev)
    state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    state, warm = step_fn(state, tokens)
    torch.cuda.synchronize()
    log(f"moe train: {cfg.num_params:,} params ({cfg.num_active_params:,} "
        f"active per token), {cfg.n_layers} layers of dim {cfg.dim}, ffn "
        f"{cfg.ffn_dim}, {cfg.n_experts} experts top-{cfg.experts_per_token}; "
        f"fp32 params and AdamW moments, {cfg.compute_dtype} products; built "
        f"and warmed up in {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    steps = 5
    gm.gmm_launches = gm.tgmm_launches = fa.fwd_launches = fa.bwd_launches = 0
    metrics = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, tokens)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (gm.gmm_launches, gm.tgmm_launches, fa.fwd_launches, fa.bwd_launches)
    L = cfg.n_layers
    want = (9 * L * steps, 3 * L * steps, 2 * L * steps, L * steps)
    losses = [float(warm["loss"])] + [float(m["loss"]) for m in metrics]
    norms = [float(warm["grad_norm"])] + [float(m["grad_norm"]) for m in metrics]
    log(f"moe train: losses {[round(x, 5) for x in losses]}, grad norms "
        f"{[round(x, 5) for x in norms]}")
    log(f"moe train: {steps} steps, launches gmm {got[0]}, tgmm {got[1]}, "
        f"flash forward {got[2]}, flash backward {got[3]} (want {want})")
    if on_card and got != want:
        raise AssertionError("the MoE step did not run the grouped matmul and "
                             "flash kernels on every layer")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on a repeated batch")
    step_s = wall / steps
    tok_s = b * s / step_s
    fpt = moe.flops_per_token(cfg, s)
    log(f"moe train [{card_line}]: {step_s * 1e3:.1f} ms per step, "
        f"{tok_s:.1f} tokens/s, active MFU {fpt * tok_s / BF16_FLOPS_PER_S:.4f} "
        f"(flops_per_token {fpt:.4g} at 989 TFLOP/s: 6 x active params + "
        f"full attention); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB allocated")
    profile_train_step(step_fn, state, tokens, card_line)
    # phase 7r's MoE step: one "attn" step on the same state
    _, attn_step = parallel.make_train_step(
        dataclasses.replace(cfg, remat_policy="attn"), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gm.gmm_launches = gm.tgmm_launches = fa.fwd_launches = fa.bwd_launches = 0
    metrics, attn_s = timed_steps(attn_step, state, tokens, 1)
    attn = (gm.gmm_launches, gm.tgmm_launches, fa.fwd_launches, fa.bwd_launches)
    want = (9 * L, 3 * L, L, L)
    log(f"moe remat attn [{card_line}]: one step {attn_s * 1e3:.1f} ms "
        f"(full: {step_s * 1e3:.1f}, its first call: no warm-up), launches "
        f"gmm, tgmm, flash forward, flash backward {attn} (want {want}), "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"allocated, loss {float(metrics[0]['loss']):.5f}")
    if on_card and attn != want:
        raise AssertionError("the MoE 'attn' step's launches are not "
                             f"{want}")
    if not math.isfinite(float(metrics[0]["loss"])):
        raise AssertionError("the MoE 'attn' step's loss is not finite")
    return cfg, state, tokens, (got[0] + attn[0], got[1] + attn[1])


def phase_moe_remat_grads(moe, cfg, params, tokens):
    """Phase 7r's MoE check: one step's gradients under "attn" bit for bit
    the "full" policy's (the grouped matmuls and the flash kernels repeat
    bit for bit; the scatter-add adds two terms to zero)."""
    rope = moe.llama.rope_cache(cfg, cfg.max_seq_len, tokens.device)
    _, full = loss_and_grads(moe, cfg, params, tokens, rope)
    _, attn = loss_and_grads(moe, dataclasses.replace(cfg, remat_policy="attn"),
                             params, tokens, rope)
    same = all(torch.equal(a, b) for a, b in zip(attn, full))
    log(f"moe remat attn: gradients bit-identical to full's: {same}")
    if not same:
        raise AssertionError("the MoE 'attn' gradients differ from 'full'")


def phase_moe_ab(gm, moe, parallel, cfg, params, tokens):
    """The MoE step's loss and gradients from one set of params through the
    grouped-matmul kernels (dispatch "ragged") and through
    "sorted_capacity" with capacity_factor = n_experts (cap = T: nothing
    drops, the same function through batched products).

    Each difference -- the loss, the grad norm, and per leaf the L2 norm of
    the gradient difference -- must stay within FLOOR_TIMES times the same
    difference of the noise floor: the kernel run with every expert output
    row (the down projection's) nudged by 2**-8 of itself, up or down.  Two
    faults must break that limit: the rows of one m-tile that straddles a
    group boundary computed with the neighbouring expert's weights (every
    projection, forward and recompute), and one expert's weight gradient
    taken from the first half of its rows.  The expert leaves [L, E, ...]
    are compared per expert as well: an ulp-sized nudge flips some routing
    decisions of the next layer, which spreads the floor over every
    expert, where a fault in one expert lands in its slice alone."""
    dev = tokens.device
    rope = moe.llama.rope_cache(cfg, cfg.max_seq_len, dev)
    names, leaves = zip(*_named_leaves(params))
    ragged = dataclasses.replace(cfg, dispatch="ragged")
    orig = moe._grouped_matmul

    def run(run_cfg, gmm_fn=orig):
        moe._grouped_matmul = gmm_fn
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = moe.loss_fn(run_cfg, params, tokens, rope_cache=rope)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            moe._grouped_matmul = orig
            for p in leaves:
                p.requires_grad_(False)
        return (float(loss.detach()),
                float(parallel.train_step.global_norm(grads)), grads)

    before = gm.gmm_launches, gm.tgmm_launches
    loss0, norm0, grads0 = run(ragged)
    launched = (gm.gmm_launches - before[0], gm.tgmm_launches - before[1])
    log(f"moe A/B: the kernel run launched gmm {launched[0]} and tgmm "
        f"{launched[1]} times (want {9 * cfg.n_layers} and {3 * cfg.n_layers})")
    if dev.type == "cuda" and launched != (9 * cfg.n_layers, 3 * cfg.n_layers):
        raise AssertionError("the A/B's kernel run did not run the kernels")
    values = {}

    def diffs(label, run_cfg, gmm_fn=orig):
        loss, norm, grads = run(run_cfg, gmm_fn)
        values[label] = (loss, norm)
        d = {"loss": abs(loss - loss0), "grad norm": abs(norm - norm0)}
        for n, g, g0 in zip(names, grads, grads0):
            d[n] = float((g - g0).norm())
            if n.split("/")[-1] in ("w_gate", "w_up", "w_down"):
                for e in range(g.shape[1]):  # [L, E, ...]: each expert too
                    d[f"{n}[{e}]"] = float((g[:, e] - g0[:, e]).norm())
        return d

    capacity = dataclasses.replace(cfg, dispatch="sorted_capacity",
                                   capacity_factor=float(cfg.n_experts))
    before = gm.gmm_launches + gm.tgmm_launches
    ref = diffs("sorted_capacity", capacity)
    if gm.gmm_launches + gm.tgmm_launches != before:
        raise AssertionError("the sorted_capacity run launched a grouped matmul")
    n_rows = tokens.numel() * cfg.experts_per_token
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    nudge = 1 + 2.0 ** -8 * (torch.randint(0, 2, (n_rows, 1), generator=gen,
                                           device=dev) * 2 - 1)

    def nudged(c, use_gmm, a, b, gs):  # the same nudge in forward and recompute
        out = orig(c, use_gmm, a, b, gs)
        if b.shape[-1] == c.dim:  # the down projection: the expert outputs
            out = (out.float() * nudge).to(out.dtype)
        return out

    def neighbour(c, use_gmm, a, b, gs):
        out = orig(c, use_gmm, a, b, gs)
        ends = torch.cumsum(gs, 0).tolist()
        g = _straddled(ends)
        r0, r1 = ends[g], min(ends[g + 1], (ends[g] // 128 + 1) * 128)
        wrong = (a[r0:r1].float() @ b[g].float()).to(out.dtype)  # group g's
        return torch.cat([out[:r0], wrong, out[r1:]])

    class HalfRows(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b, gs):
            ctx.save_for_backward(a, b, gs)
            return gm.gmm(a, b, gs)

        @staticmethod
        def backward(ctx, grad):
            a, b, gs = ctx.saved_tensors
            grad = grad.contiguous()
            start, size = int(gs[:1].sum()), int(gs[1])
            half = grad.clone()
            half[start + size // 2:start + size] = 0  # expert 1's second half
            return (gm.gmm(grad, b, gs, transpose_rhs=True),
                    gm.tgmm(a.t(), half, gs), None)

    def half_rows(c, use_gmm, a, b, gs):
        return HalfRows.apply(a, b, gs)

    floor = diffs("noise floor", ragged, nudged)
    controls = {
        "straddling tile with the neighbouring expert's weights":
            diffs("neighbour", ragged, neighbour),
        "one expert's weight gradient from half its rows":
            diffs("half rows", ragged, half_rows)}
    del grads0
    if not all(math.isfinite(x) for d in (ref, floor, *controls.values())
               for x in d.values()) or not math.isfinite(loss0 + norm0):
        raise AssertionError("an MoE loss or gradient is not finite")
    log(f"ragged (kernels) vs sorted_capacity (batched torch.matmul, no "
        f"grouped-matmul launch) step: loss {loss0:.6f} vs "
        f"{values['sorted_capacity'][0]:.6f}, grad norm {norm0:.6f} vs "
        f"{values['sorted_capacity'][1]:.6f}; each |d| against the noise "
        f"floor's (every expert output row x (1 +- 2**-8)), limit "
        f"{FLOOR_TIMES} x the floor:")
    for k in ref:
        log(f"  {k:20s} |d| {ref[k]:.4e}  floor {floor[k]:.4e}  "
            f"{_over(ref[k], floor[k]):.3f} of the floor")
    worst = max(_over(ref[k], floor[k]) for k in ref)
    for label, d in controls.items():
        k = max(d, key=lambda k: _over(d[k], floor[k]))
        log(f"control, {label}: loss |d| {d['loss']:.4e}, grad norm |d| "
            f"{d['grad norm']:.4e}; largest {k}, {_over(d[k], floor[k]):.1f} x "
            f"the floor")
        if _over(d[k], floor[k]) <= FLOOR_TIMES:
            raise AssertionError(f"the MoE step comparison misses: {label}")
    if worst > FLOOR_TIMES:
        raise AssertionError("the ragged and sorted_capacity steps disagree")
    return {"worst_share_of_floor": worst}


def phase_moe_no_sync(gm, moe, cfg, params, tokens):
    """One moe_block_ragged at the step's shapes under
    torch.cuda.set_sync_debug_mode("error"): no host sync in the block."""
    dev = tokens.device
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn((*tokens.shape, cfg.dim), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 5),
                    dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    before = gm.gmm_launches
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_block_ragged(cfg, x, lp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = gm.gmm_launches - before
    if (dev.type == "cuda" and launched != 3) or not torch.isfinite(y).all():
        raise AssertionError("moe_block_ragged did not run its three gmm "
                             "launches to a finite result")
    log(f"moe_block_ragged at [{tokens.shape[0]}, {tokens.shape[1]}, "
        f"{cfg.dim}] ran under sync debug mode 'error': no host sync, "
        f"{launched} gmm launches, aux {float(aux):.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import ray_tpu_torch.llm as llm
    import ray_tpu_torch.llm.paged as paged
    import ray_tpu_torch.parallel as parallel
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import grouped_matmul as gm
    from ray_tpu_torch.ops import paged_attention as pa

    card_line = card()
    log(card_line)
    t_start = time.perf_counter()

    def lap(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, text) in libs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = llama.LlamaConfig.llama3_8b(param_dtype=torch.bfloat16,
                                      compute_dtype=torch.bfloat16)
    dev = torch.device("cuda")
    phase_paged_sass(*libs["paged_attention"])
    with torch.no_grad():
        kern = phase_kernel(pa, cfg, dev)["a"]
        # the speculative draft's shape (Llama-3.2-1B: head_dim 64, 32 q
        # over 8 kv heads, 16 layers) at the decode batch's spans
        phase_kernel(pa, llama.LlamaConfig.llama32_1b(
            param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16), dev,
            nb=1024, shapes={"d": paged_shapes(np.random.default_rng(SEED))["a"]})
    gc.collect()  # phase 3's 9.7 GB pool goes before the engine
    torch.cuda.empty_cache()
    lap("phases 1-3")
    main_run = phase_engine(pa, llama, llm, cfg, card_line, dev)
    lap("phase 4")
    launches, params = main_run["launches"], main_run["params"]
    gc.collect()  # the paged engine goes; its weights serve the others
    torch.cuda.empty_cache()
    pa.launches = 0
    phase_tier(llama, llm, cfg, params, card_line, dev)
    lap("phase 4m (a)")
    phase_migration(llama, llm, cfg, params, main_run, card_line, dev)
    lap("phase 4m (b, c)")
    log(f"phase 4m: {pa.launches} B1 launches (warm-up runs before each "
        f"capture included)")
    launches += pa.launches
    gc.collect()
    torch.cuda.empty_cache()
    spec_launches, _, control = phase_spec(pa, llama, llm, paged, cfg,
                                           main_run, card_line, dev)
    launches += spec_launches
    lap("phase 4s")
    gc.collect()  # the speculative engines and the 1B draft go
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_b1, serve_b2 = phase_serve(pa, fa, llama, llm, cfg, main_run,
                                     control, card_line, dev)
    launches += serve_b1
    log(f"phase 4v: {serve_b1} B1 and {serve_b2} B2 launches; "
        f"{time.perf_counter() - t0:.1f} s of the run")
    lap("phase 4v")
    del main_run
    gc.collect()  # every server is shut down; their engines go
    torch.cuda.empty_cache()
    _, static_fwd = phase_static(fa, llama, llm, cfg, params, card_line, dev)
    static_fwd += serve_b2
    lap("phase 5b")
    del params
    gc.collect()  # the static engine and the 8B weights go before training
    torch.cuda.empty_cache()

    phase_flash_sass(libs["flash_attention"][0])
    phase_gmm_sass(*libs["grouped_matmul"])
    with torch.no_grad():
        flash = phase_flash(fa, dev)
    gc.collect()
    torch.cuda.empty_cache()
    fp32 = phase_train(fa, llama, parallel, card_line, dev, label="train fp32")
    fwd_n, bwd_n = fp32["launches"]
    phase_train_ab(llama, parallel, fp32["cfg"], fp32["state"], fp32["tokens"])
    lap("phases 6-8")
    del fp32
    gc.collect()
    torch.cuda.empty_cache()
    # bench.py's headline exactly: bf16 params, bf16 moments
    bf16 = phase_train(fa, llama, parallel, card_line, dev,
                       cfg=headline_config(llama, torch.bfloat16),
                       optimizer=headline_optimizer(parallel),
                       label="train bf16")
    fwd_n += bf16["launches"][0]
    bwd_n += bf16["launches"][1]
    lap("phase 7 (bf16)")
    _, (f, b) = phase_remat(fa, llama, parallel, card_line, bf16)
    fwd_n, bwd_n = fwd_n + f, bwd_n + b
    lap("phase 7r")
    _, (f, b) = phase_compressed(fa, llama, parallel, card_line, bf16)
    fwd_n, bwd_n = fwd_n + f, bwd_n + b
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 7c")
    _, (f, b) = phase_snapshot(fa, parallel, card_line, bf16)
    fwd_n, bwd_n = fwd_n + f, bwd_n + b
    lap("phase 7s")
    del bf16
    gc.collect()
    torch.cuda.empty_cache()

    with torch.no_grad():
        gmm_row, tgmm_row = phase_grouped_matmul(gm, moe, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mcfg, state, tokens, (gmm_n, tgmm_n) = phase_moe_train(
        fa, gm, moe, parallel, card_line, dev)
    params = state.params
    del state  # the A/B needs the params only: the AdamW moments go
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_remat_grads(moe, mcfg, params, tokens)
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_ab(gm, moe, parallel, mcfg, params, tokens)
    phase_moe_no_sync(gm, moe, mcfg, params, tokens)
    lap("phases 9-12")
    del params

    src = "ray_tpu_torch/ops/csrc/flash_attention.cu"
    log(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:36",
        "launches": launches,
        **kern,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": src,
        "replaces": "ray_tpu/ops/flash_attention.py:32",
        "launches": fwd_n + static_fwd,
        **flash["fwd"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": src,
        "replaces": "ray_tpu/ops/flash_attention.py:76",
        "launches": bwd_n,
        **flash["bwd"],
    }, {
        "name": "grouped_matmul_gmm",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/grouped_matmul.cu",
        "replaces": MEGABLOX + ":314",
        "launches": gmm_n,
        **gmm_row,
    }, {
        "name": "grouped_matmul_tgmm",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/grouped_matmul.cu",
        "replaces": MEGABLOX + ":573",
        "launches": tgmm_n,
        **tgmm_row,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
