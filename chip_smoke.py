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
 4m (d). the object store's prefix tier on ``ray_tpu_torch.init``: 4m
     (a)'s sequence with a 4-block host tier and a 64-block store tier;
     the host tier's evictions spill A's prefix into the store, A2
     revives all 30 prefix blocks (most from the store) bit for bit the
     evicted ones, and its tokens equal 4m (a)'s revival run exactly; the
     spill's ms per block and A2's time to first token beside 4m (a)'s
 4tp. the tensor-parallel engine at world size 1 through NCCL: phase 4's
     weights and configuration over a one-rank ``NCCLGroup`` mesh (its
     reductions captured in the CUDA graphs): phase 4's 8 measured prompts
     give phase 4's greedy tokens bit for bit; B1 = 32 x the token steps;
     the group's last backend nccl; the ``utilization()["tp"]`` row and
     the plans booked on ``ray_tpu_collective_plan_total``
 4tp (b). tp = 2 on the one card: a spawned second rank, each rank half of
     phase 4's weights and pool, a mesh whose group reduces CUDA tensors
     through gloo (NCCL refuses two ranks on one card), eager programs;
     two of phase 4's prompts: every token within the floor check (a
     moved token must break it), first divergence from 4tp's printed
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
     shut down and freed before 4r
 4r. the runtime core with the card as the ``GPU`` resource:
     ``ray_tpu_torch.init(num_gpus=1)`` gives ``cluster_resources()["GPU"]
     == 1``; a ``num_gpus=1`` actor (forked by the zygote, which never
     touches CUDA) sees ``CUDA_VISIBLE_DEVICES == "0"`` and
     ``get_gpu_ids() == [0]`` and builds ``LLMServer`` over phase 4's
     seeded weights (its own copy; the driver still holds phase 4's) while
     the driver builds its own; three new prompts served one at a time
     give the same 64 tokens on both; phase 4's 8 prompts from 8 threads
     through the actor handle within the floor check (4s's control must
     break it), tok/s beside 4v (a)'s; one request through the runtime's
     streaming returns joins to generate's tokens for the same prompt
     after it (the same prefix-cache state); B1's launches = 32 x the
     token steps in both processes; the actor's time to ready (spawn,
     imports, CUDA init, weights, warmup), 200 empty actor calls' median
     round trip, a 1 GiB CPU and a 1 GiB CUDA tensor driver -> actor ->
     driver bit for bit with each step's GB/s, the zygote's fallbacks and
     which store ran.  Everything is shut down, and phase 4's weights
     freed (5b draws them again from the seed, checksums checked)
 4c. collectives and device objects on ``init(num_gpus=1)``: (a) an NCCL
     group at world size 1 in a ``num_gpus=1`` actor, every op (allreduce
     sum and max, reduce, broadcast, allgather, reducescatter, barrier,
     ``allreduce_pytree``) on CUDA tensors, each result checked and the
     process group that ran it printed (NCCL refuses two ranks on one
     card: the multi-GPU path is unverified); (b) ``device_put`` in one
     half-card actor, ``device_get`` in another, bit for bit, its path
     printed; (c) one Llama-3-8B handoff's KV for a 700-token prompt (k and
     v, [32, 44, 16, 1024] bf16, 92 MB) through a ``CudaTensorChannel``
     between the two half-card actors 20 times: bit for bit, through CUDA
     IPC (no collective group on either side; only metadata through
     shared memory), the writer's allocated memory back where it was after
     the release; the median write -> read ms and GB/s beside the bound
     and the same payload through the object store
 4d. Llama-3-8B as serve deployments on ``init(num_gpus=1)``, through the
     handle and the HTTP proxy; every replica draws seed-0 weights on its
     own card, the driver's reference server the same (checksums equal):
     (a) ``serve.run(build_llm_deployment(...))``, one replica holding
     ``GPU`` 1 (``get_gpu_ids() == [0]``): new prompts one at a time
     through the handle and ``POST /llm`` give the reference's 64 tokens;
     phase 4's 8 prompts from 8 threads through ``generate_stream``, 8
     new ones of their lengths through HTTP, within the floor check, tok/s
     beside 4r's and 4v (a)'s;
     an SSE request joins to ``generate``'s tokens; the proxy's added ms
     per request on an empty deployment (200 calls, medians); (b)
     ``build_openai_app`` over the static engine: 4v (e)'s three requests
     over HTTP, their shapes and usage, B2 = 32 x 3 in the replica; (c)
     ``build_disagg_llm_deployment`` at half a card per stage: the 8
     prompts through the CPU ingress within the floor check, each
     handoff's export and import ms beside 4v (d)'s; then ``serve.run`` of
     the same application with ``transport="channel"`` (only the ingress
     restarts: whether the stages did is printed): 8 new prompts of phase
     4's lengths within the floor check, k/v on the card at every export,
     every handoff read through CUDA IPC, no recompute; export, write and
     intake ms and the bytes moved, tok/s beside the object transport's;
     three new prompts one at a time give the reference server's tokens
     exactly; then once more with ``handoff_compression="int8"``: the wire
     bytes (codes + scales) at their ratio, the floor check; (d) two
     replicas at half a card, four
     long streams, then ``serve.run`` at one replica: the controller's
     drain migrates the second replica's streams to the first, every
     stream within the floor check, outcomes only migrated or fallback;
     the drain's seconds and each stream's longest pause.  B1 = 32 x the
     token steps in every replica's own process.  All shut down before 5b
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
     the bounds; then the head_dim-256 wgmma pair (csrc/flash_attention_
     d256.cu: SASS with wgmma and TMA loads, ptxas's registers and spills)
     the same way at D=256 (causal and non-causal, the controls, repeat
     bits, times); then the fp32 FFMA kernels (ROADMAP C1)
 6 (B1 TP). B1 at the per-rank shapes of tensor parallelism (Llama-3-8B
     at tp 2, 4, 8: 16/4, 8/2, 4/1 q/kv heads; Llama-3-70B at tp 4, 8:
     16/2, 8/1), phase 3's decode batch (a) each: kernel vs plain with
     its controls, times, and the split grid's blocks against 132 SMs
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
 7m. sharded training at world size 1 through NCCL: on a copy of the bf16
     headline's state, three steps of ``make_train_step(cfg, mesh)`` over
     a one-rank mesh with a one-rank NCCL group on every axis (each
     collective of the sharded step runs on the card) beside three of the
     mesh-free step from another copy: losses, grad norms and the params'
     bits equal; step ms; 3 x (32 forward, 16 backward) flash launches
 7m (b). two ranks on the one card (this process and a spawned one), their
     groups' CUDA tensors through gloo (NCCL refuses two ranks on one
     card): Llama-3-8B's width cut to 2 layers (fp32 params and moments,
     bf16 products), batch [4, 2048]; first the world-1 step, and the floor
     check's tolerance (``mesh_tolerance``: FLOOR_TIMES x the RMS over
     MESH_NOISE_DRAWS draws of how far the loss, the grad norm and the
     norm leaves' first moments move when every bf16 sum a collective
     would compute and every attention output is nudged by +-2**-8, the
     fp32 sums exact; a control, the last layer nudged by +-2**-4, must
     break it); then one step on each of fsdp=2, data=2, tensor=2,
     context=2 (ring attention), pipeline=2 (two microbatches) and data=2
     with the overlapped sync: each within the tolerance, its synced
     norm-leaf gradients within SYNC_TOL of the fp32 sum of the ranks' own
     (``sync_ratio``; a control, data=2 syncing in bf16, must break that),
     both ranks equal, the overlapped step the fused data=2 step's bit for
     bit; step seconds and each rank's peak memory (gloo stages every
     collective through the host: recorded, not judged); then B2 and B3 at
     the ranks' shapes (tensor=2: [4, 2048] at 16/4 heads; the batch axes:
     [2, 2048] at 32/8) against their plain versions, with times
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
 9 (fp32), 10f. ROADMAP C11: the FFMA grouped matmuls (csrc/grouped_
     matmul_ffma.cu) -- ptxas's registers (no spills) and their SASS
     (FFMA, LDS/LDS.128, STS, LDGSTS; no HMMA, HGMMA or local memory)
     beside the first FFMA kernels', then phase 9's checks and times at
     fp32 (bound at the 67 TFLOP/s fp32 peak; the first kernels' ms
     beside);
     after phase 12, make_train_step on Mixtral-8x7B's width at 2 layers
     with fp32 products: three steps through the fp32 kernels (18 gmm and
     6 tgmm launches a step), and the same three from the same state
     through their plain versions, every loss within 1e-4 relative
Then one JSON line with every kernel, and last the device line.

``python3 chip_smoke.py --train-cards N`` (N cards on one host) runs only
the sharded training cells that need them, through NCCL across the cards:
the point-to-point orders the program posts (the serving tree's swaps,
rings of N and of two; each message must arrive whole); the 2-layer cut
at fsdp=N and, at even N, at tensor=2, context=2 (ring attention) and
pipeline=2, each against the world-1 step on card 0 by phase 7m (b)'s
floor check; then Llama-3-8B at full depth over fsdp=N, [4, 2048], fp32
params and moments (~128 GB, ~32 GB a card at N = 4): step ms, tokens/s,
MFU and each rank's peak memory after a warm-up step.

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
import types

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
FP32_FLOPS_PER_S = 67e12  # fp32 outside the tensor cores (FFMA), H100 SXM
# jax's Pallas library kernels that B4 and B5 replace
MEGABLOX = "jax/experimental/pallas/ops/tpu/megablox/gmm.py"
# SASS mnemonics: wgmma, TMA tile loads, mbarrier operations
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS")
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_delta_kernel",
                 "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
FLASH_D256_KERNELS = ("flash_d256_fwd_kernel", "flash_bwd_delta_kernel",
                      "flash_d256_dkdv_kernel", "flash_d256_dq_kernel")
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
            "ttft_revival_ms": ttft_tier, "ttft_recompute_ms": ttft_plain,
            "tokens_revival": toks_tier}


STORE_TIER_HOST_BLOCKS = 4  # phase 4m (d)'s host tier: 8 MiB at Llama-3-8B


def phase_store_tier(llm, cfg, params, tier_a, card_line, dev):
    """Phase 4m (d): the object store's prefix tier.  Phase 4m (a)'s
    sequence (A, the eight, A2) on an engine whose host tier holds
    ``STORE_TIER_HOST_BLOCKS`` blocks and whose store tier 64
    (``plasma_kv_cache_blocks``), on ``ray_tpu_torch.init``: the host
    tier's evictions spill A's prefix into the store (a put of each
    block's pinned K and V), and A2 revives all 30 prefix blocks, most
    from the store (promoted back through host RAM).  Checks: the revived
    pool blocks equal A's blocks bit for bit, and A2's tokens equal 4m
    (a)'s revival run exactly (the same prefix bytes, the same 32-token
    prefill).  Prints the spill's cost per block, the hits per tier and
    A2's time to first token beside 4m (a)'s."""
    import ray_tpu_torch
    from ray_tpu_torch._private import runtime_metrics
    from ray_tpu_torch._private.prefix_hash import prefix_chain_hashes

    v = cfg.vocab_size
    rng = np.random.default_rng(SEED + 4)  # 4m (a)'s prompts
    prefix = rng.integers(0, v, TIER_PREFIX).tolist()
    a = prefix + rng.integers(0, v, 32).tolist()
    a2 = prefix + rng.integers(0, v, 32).tolist()
    b = rng.integers(0, v, 512).tolist()
    gen = llm.GenerationConfig(max_new_tokens=16)
    gen_b = llm.GenerationConfig(max_new_tokens=2)
    os.environ.setdefault("RAY_TPU_NUM_CHIPS", "0")
    os.environ.setdefault("RAY_TPU_DISABLE_METADATA_SERVER", "1")
    ray_tpu_torch.init(num_cpus=1)
    try:
        block_bytes = 2 * cfg.n_layers * 16 * cfg.n_kv_heads * cfg.head_dim * 2
        kw = dict(model_config=cfg, max_batch_size=8, max_seq_len=2048,
                  block_size=16, prefill_chunk=256, decode_chunk=8,
                  num_blocks=266,
                  host_kv_cache_bytes=STORE_TIER_HOST_BLOCKS * block_bytes,
                  plasma_kv_cache_blocks=64)
        eng = llm.PagedTorchLLMEngine(llm.LLMConfig(**kw), params=params,
                                      device=dev)
        for c in (16, 32, 64, 128, 256):
            eng._prefill_programs.get(c)
        drive(eng, [(a, gen)])
        chain = prefix_chain_hashes(a, 16)
        n = TIER_PREFIX // 16
        with eng._lock:
            orig = [(eng.pool["k"][:, eng.blocks.by_hash[h]].clone(),
                     eng.pool["v"][:, eng.blocks.by_hash[h]].clone())
                    for h in chain[:n]]
        drive(eng, [(b, gen_b)] * 8)
        torch.cuda.synchronize()
        cache = eng._host_cache
        in_store = sum(h in cache._plasma for h in chain[:n])
        spilled, spill_ms = cache.spilled, 1e3 * cache.spill_s / max(
            cache.spilled, 1)
        if in_store < n - STORE_TIER_HOST_BLOCKS:
            raise AssertionError(f"only {in_store} of the {n} prefix blocks "
                                 f"reached the store")
        uploads = []
        upload = eng._upload_block
        eng._upload_block = lambda blk, k, vv: (uploads.append(blk),
                                                upload(blk, k, vv))[1]
        hits0 = runtime_metrics.prefix_cache_snapshot()["hits"]
        ttft, toks = ttft_ms(eng, a2, gen)
        del eng._upload_block
        hits1 = runtime_metrics.prefix_cache_snapshot()["hits"]
        tiers = {t: int(hits1.get(t, 0) - hits0.get(t, 0))
                 for t in ("host", "plasma")}
        if len(uploads) != n or tiers["plasma"] + tiers["host"] != n:
            raise AssertionError(f"A2 revived {len(uploads)} blocks ({tiers}), "
                                 f"not {n}")
        if tiers["plasma"] < n - STORE_TIER_HOST_BLOCKS:
            raise AssertionError(f"A2 revived {tiers['plasma']} blocks from "
                                 f"the store")
        same = all(torch.equal(eng.pool["k"][:, blk], k0)
                   and torch.equal(eng.pool["v"][:, blk], v0)
                   for blk, (k0, v0) in zip(uploads, orig))
        if not same:
            raise AssertionError("a block revived from the store differs from "
                                 "the evicted bytes")
        log(f"tier (d) [{card_line}]: host tier {STORE_TIER_HOST_BLOCKS} "
            f"blocks of {block_bytes / 2**20:.0f} MiB, store tier 64 blocks; "
            f"{spilled} spills into the store, {spill_ms:.3f} ms per block "
            f"(host time of the put of K and V, "
            f"{block_bytes / 2**20:.0f} MiB; under the engine "
            f"lock); A2 revived {n} blocks ({tiers['plasma']} from the store, "
            f"{tiers['host']} from host RAM), bit-equal to the evicted ones; "
            f"A2's time to first token {ttft:.1f} ms (4m (a): "
            f"{tier_a['ttft_revival_ms']:.1f} ms from host RAM, "
            f"{tier_a['ttft_recompute_ms']:.1f} ms recomputed); tokens equal "
            f"4m (a)'s revival run: {toks == tier_a['tokens_revival']}")
        if toks != tier_a["tokens_revival"]:
            raise AssertionError("A2's tokens from the store tier differ from "
                                 "4m (a)'s from host RAM")
    finally:
        eng = cache = upload = orig = None  # nothing holds the store's views
        gc.collect()
        ray_tpu_torch.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return {"spill_ms": spill_ms, "ttft_store_ms": ttft, "tiers": tiers}


def _tp_engine_config(llm, cfg, **kw):
    """Phase 4's engine configuration."""
    return llm.LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=2048,
                         block_size=16, prefill_chunk=256, decode_chunk=8,
                         **kw)


def phase_tp_world1(pa, llm, cfg, main, card_line, dev):
    """Phase 4tp: the tensor-parallel engine at world size 1, its group an
    ``NCCLGroup`` of one rank: phase 4's weights and configuration, a
    ``Mesh`` at tensor 1, so every program's reductions (the embedding's,
    two per layer, the logits' gather) run through NCCL, captured in the
    CUDA graphs.  Phase 4's 8 measured prompts: greedy tokens bit for bit
    phase 4's; B1's launches = 32 x the token steps; the group's last
    backend is nccl; the ``utilization()["tp"]`` row and the plans booked
    on ``ray_tpu_collective_plan_total`` are printed."""
    from ray_tpu_torch._private import runtime_metrics
    from ray_tpu_torch.parallel.mesh import Mesh, TensorGroup
    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    group = NCCLGroup(1, 0, "smoke-tp1")
    mesh = Mesh({"tensor": 1}, rank=0, group=TensorGroup(group), device=dev)
    plans0 = runtime_metrics.plan_snapshot()
    t0 = time.perf_counter()
    eng = llm.PagedTorchLLMEngine(_tp_engine_config(llm, cfg, mesh=mesh),
                                  params=main["params"], device=dev)
    eng.warmup(max_len=eng.max_seq)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    plans = {k: v - plans0.get(k, 0.0)
             for k, v in runtime_metrics.plan_snapshot().items()
             if v != plans0.get(k, 0.0)}
    greedy = llm.GenerationConfig(max_new_tokens=64)
    steps0 = eng.decode_steps
    launches0 = pa.launches
    t0 = time.perf_counter()
    got = drive(eng, [(p, greedy) for p in main["prompts"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = eng.decode_steps - steps0
    launches = pa.launches - launches0
    row = eng.utilization()["tp"]
    same = sum(x == y for x, y in zip(got, main["tokens"]))
    log(f"tp world 1 [{card_line}]: engine over a one-rank NCCL mesh built "
        f"and warmed in {built:.1f} s (graphs {eng._programs.graphs}); "
        f"{len(got)} prompts x 64 tokens in {wall:.2f} s; greedy tokens "
        f"equal phase 4's in {same} of {len(got)}; B1 launches {launches} "
        f"for {steps} token steps; the group's last backend "
        f"{group.last_backend}; plans booked {plans}")
    log(f"tp world 1: utilization tp row: degree {row['degree']}, mesh "
        f"{row['mesh_shape']}, kv {row['kv_bytes_per_device'] / 2**30:.2f} "
        f"GiB and weights {row['weights_bytes_per_device'] / 2**30:.2f} GiB "
        f"per device; planned " + ", ".join(
            f"{k} {r['chosen']} ({r['reason']}, {r['nbytes']} bytes)"
            for k, r in row["planned_collectives"].items()))
    if same != len(got):
        raise AssertionError("the one-rank tensor-parallel engine's greedy "
                             "tokens differ from phase 4's")
    on_card = dev.type == "cuda"
    if on_card and group.last_backend != "nccl":
        raise AssertionError(f"the mesh's collectives ran through "
                             f"{group.last_backend}, not nccl")
    if on_card and (launches != cfg.n_layers * steps
                    or not eng._programs.graphs):
        raise AssertionError("phase 4tp: B1 launches != 32 x token steps, or "
                             "no CUDA graphs")
    if sum(plans.values()) < 2:
        raise AssertionError(f"phase 4tp booked no plan: {plans}")
    eng.shutdown()
    del eng
    group.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    return got, launches


def _tp_gloo_rank(port, cfg, conf):
    """Rank 1 of phase 4tp (b): phase 4's weights drawn again from the
    seed by the engine, which keeps its half of each tensor as it is drawn
    (no CUDA IPC: a block the parent shares stays held until every
    consumer lets it go), with its half of the pool on the same card, the
    group's CUDA reductions through gloo."""
    import datetime

    import ray_tpu_torch.llm as llm
    from ray_tpu_torch.parallel.mesh import Mesh, TensorGroup
    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else "cpu"
    store = torch.distributed.TCPStore(
        "127.0.0.1", port, 2, False, timeout=datetime.timedelta(seconds=300))
    group = NCCLGroup(2, 1, "smoke-tp2-gloo", store=store)
    mesh = Mesh({"tensor": 2}, rank=1,
                group=TensorGroup(group, device_backend="gloo"), device=dev,
                devices=[str(dev)] * 2)
    try:
        eng = llm.PagedTorchLLMEngine(
            dataclasses.replace(conf, mesh=mesh), device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        eng.follow()
    finally:
        group.destroy()


def phase_tp_gloo(llama, llm, cfg, main, tp1_tokens, card_line, dev,
                  n_prompts=2, max_new=32):
    """Phase 4tp (b), an attempt at tp = 2 on the one card: two rank
    processes (this one and one spawned), each holding half of phase 4's
    weights and pool on the card, with a mesh whose group reduces CUDA
    tensors through gloo's process group (built here, not the engine's
    NCCL default: NCCL refuses two ranks on one card).  Gloo stages CUDA
    tensors through the host, so the programs run eagerly.  The first
    ``n_prompts`` of phase 4's prompts, greedy: each stream within the
    teacher-forced floor check (the partial sums' bf16 rounding moves
    near-ties), and its first divergence from 4tp's tokens printed."""
    import datetime

    from ray_tpu_torch.parallel.mesh import Mesh, TensorGroup
    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    conf = _tp_engine_config(llm, cfg, tensor_parallel_size=2, num_blocks=512)
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, 2, True, timeout=datetime.timedelta(seconds=300),
        wait_for_workers=False)
    ctx = torch.multiprocessing.get_context("spawn")
    proc = ctx.Process(target=_tp_gloo_rank, daemon=True,
                       args=(store.port, cfg, conf))
    t0 = time.perf_counter()
    proc.start()
    group = NCCLGroup(2, 0, "smoke-tp2-gloo", store=store)
    mesh = Mesh({"tensor": 2}, rank=0,
                group=TensorGroup(group, device_backend="gloo"), device=dev,
                devices=[str(dev)] * 2)
    eng = None
    try:
        eng = llm.PagedTorchLLMEngine(dataclasses.replace(conf, mesh=mesh),
                                      params=main["params"], device=dev)
        built = time.perf_counter() - t0
        prompts = main["prompts"][:n_prompts]
        greedy = llm.GenerationConfig(max_new_tokens=max_new)
        t0 = time.perf_counter()
        got = drive(eng, [(p, greedy) for p in prompts])
        wall = time.perf_counter() - t0
        want = [t[:max_new] for t in tp1_tokens[:n_prompts]]
        div = first_divergence(want, got)
        log(f"tp gloo [{card_line}]: tp = 2 on one card through gloo (rank "
            f"shards {eng.pool['k'].shape[-1]} of {cfg.n_kv_heads * cfg.head_dim} "
            f"pool columns, graphs {eng._programs.graphs}), built in "
            f"{built:.1f} s; {n_prompts} prompts x {max_new} tokens in "
            f"{wall:.1f} s; the group's last backend {group.last_backend}; "
            f"first divergence from 4tp's tokens per request {div}")
    finally:
        if eng is not None:
            eng.shutdown()
        proc.join(120)
        if proc.is_alive():
            proc.terminate()
        group.destroy()
    if proc.exitcode not in (0, None):
        raise AssertionError(f"phase 4tp (b): rank 1 exited {proc.exitcode}")
    rope = llama.rope_cache(cfg, 2048, dev)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"tp gloo: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"in this process after the phase (phase 4's weights included)")
    worst = floor_check(llama, cfg, main["params"], rope,
                        "tp gloo greedy check, tp = 2 streams", prompts, got)
    # control: one token of the first stream moved off its argmax
    bad = list(got[0])
    bad[5] = (bad[5] + 1) % cfg.vocab_size
    broken = floor_check(llama, cfg, main["params"], rope,
                         "tp gloo control, a token moved", prompts[:1], [bad])
    if worst > FLOOR_TIMES or broken <= FLOOR_TIMES:
        raise AssertionError(f"tp gloo: a token is no near-tie of the target's "
                             f"argmax ({worst:.3f} x its floor), or the control "
                             f"passed ({broken:.3f})")
    return got


def _card_used_gib(n: int) -> list:
    """Memory in use on cards 0..n-1 (every process's), GiB, as
    ``nvidia-smi`` reads it (no CUDA context made on the other cards)."""
    mib = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()
    return [round(int(m) / 1024, 2) for m in mib[:n]]


def phase_tp_cards(pa, llama, llm, cfg, card_line, dev, size, n_prompts=8,
                   max_new=64):
    """Phase 4tp (c), run alone by ``--tp-cards N`` on a host with N cards:
    the engine's own tensor-parallel path at Llama-3-8B's full width, as a
    user starts it (``tensor_parallel_size=N``, no mesh, no weights): rank
    0 here on card 0 spawns ranks 1..N-1 on cards 1..N-1, each drawing its
    shard of the seeded weights tensor by tensor, NCCL across the cards,
    the all-reduces captured in every rank's CUDA graphs.  ``n_prompts``
    prompts of 100-700 tokens, greedy, through a tp=1 engine on card 0
    from the same seed and then the tp=N one: every tp=N token within the
    floor check (a moved token must break it), first divergences printed;
    B1's launches on rank 0 = 32 x the token steps; the group's last
    backend nccl; each card's memory in use after the build (the leader's
    card holds its shard and the tp=1 weights kept for the check); both
    runs' wall time and decode tokens/s."""
    from ray_tpu_torch._private import device_telemetry

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(100, 701, n_prompts)]
    greedy = llm.GenerationConfig(max_new_tokens=max_new)
    on_card = dev.type == "cuda"

    def run(conf):
        t0 = time.perf_counter()
        eng = llm.PagedTorchLLMEngine(
            conf, device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        if on_card:
            torch.cuda.synchronize()
        built = time.perf_counter() - t0
        used = _card_used_gib(size) if on_card else []
        t0 = time.perf_counter()
        eng.warmup(max_len=eng.max_seq)
        warm = time.perf_counter() - t0
        steps0, launches0 = eng.decode_steps, pa.launches
        t0 = time.perf_counter()
        got = drive(eng, [(p, greedy) for p in prompts])
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(built_s=built, warm_s=warm, wall_s=wall,
                     steps=eng.decode_steps - steps0,
                     launches=pa.launches - launches0, used_gib=used,
                     weights_gib=device_telemetry.tree_nbytes(eng.params)
                     / 2**30, graphs=eng._programs.graphs,
                     tok_s=sum(map(len, got)) / wall)
        return eng, got, stats

    one, want, s1 = run(_tp_engine_config(llm, cfg))
    params = one.params  # kept for the floor check
    del one
    gc.collect()
    torch.cuda.empty_cache()
    eng, got, sn = run(_tp_engine_config(llm, cfg, tensor_parallel_size=size))
    ranks = eng._ranks
    backend = eng.mesh.group.group.last_backend
    row = eng.utilization()["tp"]
    eng.shutdown()
    alive = [p.name for p in ranks.procs if p.is_alive()]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    div = first_divergence(want, got)
    for label, s in (("tp 1", s1), (f"tp {size}", sn)):
        log(f"tp cards [{card_line}] x {size}: {label}: built in "
            f"{s['built_s']:.1f} s (cards in use after: {s['used_gib']} "
            f"GiB; this rank's weights {s['weights_gib']:.2f} GiB), warmed "
            f"in {s['warm_s']:.1f} s (graphs {s['graphs']}); {n_prompts} "
            f"prompts x {max_new} tokens in {s['wall_s']:.2f} s with "
            f"prefill, {s['tok_s']:.1f} tok/s; B1 launches on rank 0 "
            f"{s['launches']} for {s['steps']} token steps")
    log(f"tp cards: tp {size}'s last backend {backend}; planned " + ", ".join(
        f"{k} {r['chosen']} ({r['reason']}, {r['nbytes']} bytes)"
        for k, r in row["planned_collectives"].items())
        + f"; first divergence from tp 1 per request {div}; ranks alive "
        f"after shutdown {alive}")
    rope = llama.rope_cache(cfg, 2048, dev)
    worst = floor_check(llama, cfg, params, rope,
                        f"tp cards greedy check, tp = {size} streams",
                        prompts, got)
    bad = list(got[0])
    bad[5] = (bad[5] + 1) % cfg.vocab_size
    broken = floor_check(llama, cfg, params, rope,
                         "tp cards control, a token moved", prompts[:1],
                         [bad])
    if worst > FLOOR_TIMES or broken <= FLOOR_TIMES:
        raise AssertionError(f"tp cards: a token is no near-tie of the "
                             f"target's argmax ({worst:.3f} x its floor), or "
                             f"the control passed ({broken:.3f})")
    if alive:
        raise AssertionError(f"tp cards: ranks alive after shutdown {alive}")
    if on_card and (backend != "nccl" or sn["launches"] != cfg.n_layers
                    * sn["steps"] or not sn["graphs"]):
        raise AssertionError("tp cards: not nccl, B1 launches != 32 x token "
                             "steps, or no CUDA graphs")
    return dict(size=size, divergence=div, worst_floor=worst,
                tok_s={1: s1["tok_s"], size: sn["tok_s"]},
                used_gib=sn["used_gib"], weights_gib=sn["weights_gib"])


def tp_cards_main(size: int) -> int:
    """``--tp-cards N``: phase 4tp (c) alone (see ``phase_tp_cards``)."""
    import ray_tpu_torch.llm as llm
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import paged_attention as pa

    card_line = card()
    log(card_line)
    if torch.cuda.device_count() < size:
        log(f"--tp-cards {size} needs {size} cards; "
            f"{torch.cuda.device_count()} visible")
        return 1
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    cfg = llama.LlamaConfig.llama3_8b(param_dtype=torch.bfloat16,
                                      compute_dtype=torch.bfloat16)
    with torch.no_grad():
        out = phase_tp_cards(pa, llama, llm, cfg, card_line,
                             torch.device("cuda"), size)
    log(json.dumps({"tp_cards": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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


def _timed(obj, name, rows, summary=None):
    """Wrap ``obj.name`` (an instance attribute shadowing the method) so
    each call appends (host ms, result or the exception) to ``rows`` —
    ``summary(args, result)`` in place of the result when given (a
    result that holds card memory must not be kept)."""
    orig = getattr(obj, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        try:
            out = orig(*a, **kw)
        except Exception as e:
            rows.append(((time.perf_counter() - t0) * 1e3, e))
            raise
        rows.append(((time.perf_counter() - t0) * 1e3,
                     out if summary is None else summary(a, out)))
        return out

    setattr(obj, name, call)


def _kv_summary(_args, out):
    """An export's k/v: where they lie and their bytes."""
    k, v = out["k"], out["v"]
    if k is None:
        return {"on_card": False, "nbytes": 0}
    return {"on_card": isinstance(k, torch.Tensor) and k.is_cuda,
            "nbytes": int(k.nbytes + v.nbytes)}


def _import_summary(args, _out):
    """A handoff's bytes as the decode stage took them: the channel's wire
    bytes (codes + scales when int8) and its path, or the payload's."""
    handoff = args[0]
    chan = handoff.get("channel")
    if chan is not None:
        return {"nbytes": chan.last_read_nbytes,
                "path": chan.last_read_path}
    k, v = handoff.get("k"), handoff.get("v")
    return {"nbytes": 0 if k is None else int(k.nbytes + v.nbytes),
            "path": "object"}


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
    down and freed.  Returns (B1's, B2's launches on these runs, (a)'s
    tok/s, (d)'s export and import ms)."""
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
    tok_s = sum(map(len, streams)) / wall
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
    handoff = {"export": [round(ms, 2) for ms, _ in exports],
               "import": [round(ms, 2) for ms, _ in imports]}
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
    text, msgs = OPENAI_TEXT, OPENAI_MSGS
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
    bad = openai_shapes(comp, chat, chunks, lens)
    if on_card and fa.fwd_launches != 3 * cfg.n_layers:
        bad.append(f"{fa.fwd_launches} B2 launches")
    oa.shutdown()
    del oa
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"serve (e): {bad}")
    return b1, b2, tok_s, handoff


# phase 4v (e) and 4d (b): the OpenAI requests, long enough to be
# prefilled through the flash forward kernel (every bucket 128 or more)
OPENAI_TEXT = ("The port serves Llama-3-8B from CUDA graphs on one card; "
               "this completion request is long enough to be prefilled "
               "through the flash forward kernel. ") * 2
OPENAI_MSGS = [{"role": "system", "content": "Answer briefly. " * 4},
               {"role": "user", "content": OPENAI_TEXT}]


def openai_shapes(comp, chat, chunks, lens):
    """What is wrong with a completion, a chat completion and a streamed
    chat of 16 tokens each for prompts of ``lens`` tokens: their keys,
    objects, usage counts, and the stream joining to the chat's text (a
    multi-byte character split at the budget's end withheld)."""
    head = {"id", "object", "created", "model", "choices"}
    streamed = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
    content = chat["choices"][0]["message"]["content"]
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
    return bad


RUNTIME_BYTES = 1 << 28  # phase 4r: each tensor moved through the store
RUNTIME_ONE_BY_ONE = 2  # phase 4r: prompts served one at a time on both sides


def _replica_class():
    """Phase 4r's actor: ``LLMServer`` over phase 4's seeded weights on
    the card its lease binds, with the hooks the phase reads (its times
    to ready, B1's launches, a store round trip)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_gpus=1, num_cpus=0, max_concurrency=16)
    class Replica:
        def __init__(self, conf, seed, device_type, created):
            entered = time.time()
            # this process's start (its fork off the zygote), from its
            # clock ticks since boot and the seconds since boot
            with open("/proc/self/stat") as f:
                ticks = int(f.read().rsplit(")", 1)[1].split()[19])
            with open("/proc/uptime") as f:
                up = float(f.read().split()[0])
            forked = entered - (up - ticks / os.sysconf("SC_CLK_TCK"))
            import torch

            import ray_tpu_torch as rt
            from ray_tpu_torch.llm import LLMServer
            from ray_tpu_torch.models import llama
            from ray_tpu_torch.ops import paged_attention

            self._pa, self._rt = paged_attention, rt
            dev = torch.device(device_type)
            on_card = dev.type == "cuda"
            torch.backends.cuda.matmul.allow_tf32 = False  # as the driver
            torch.backends.cudnn.allow_tf32 = False
            t1 = time.perf_counter()
            if on_card:
                torch.zeros(1, device=dev)
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            params = llama.init_params(
                conf.model_config,
                torch.Generator(device=dev).manual_seed(seed), dev)
            if on_card:
                torch.cuda.synchronize()
            t3 = time.perf_counter()
            self.srv = LLMServer(conf, params, device=dev)
            if on_card:
                torch.cuda.synchronize()
            t4 = time.perf_counter()
            self._steps0 = 0
            self._ready = {
                "fork_s": forked - created, "load_s": entered - forked,
                "cuda_s": t2 - t1, "weights_s": t3 - t2, "warmup_s": t4 - t3,
                "visible": (os.environ.get("CUDA_VISIBLE_DEVICES"),
                            rt.get_gpu_ids(),
                            torch.cuda.device_count() if on_card else 0),
                "kernel": bool(self.srv._engine._use_kernel)}

        def ready(self):
            return self._ready

        def ping(self):
            return None

        def generate(self, prompt, max_new_tokens):
            return self.srv.generate(prompt, max_new_tokens=max_new_tokens)

        def generate_stream(self, prompt, max_new_tokens):
            yield from self.srv.generate_stream(
                prompt, max_new_tokens=max_new_tokens)

        def zero_counts(self):
            self._pa.launches = 0
            self._steps0 = self.srv._engine.decode_steps

        def counts(self):
            return (self._pa.launches,
                    self.srv._engine.decode_steps - self._steps0)

        def round_trip(self, refs):
            """get the tensor behind ``refs[0]`` (onto this card when it
            was a CUDA tensor), put it back; returns ([the new ref], get
            seconds, put seconds, where it landed)."""
            import torch

            t0 = time.perf_counter()
            x = self._rt.get(refs[0])
            if x.is_cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = self._rt.put(x)
            t2 = time.perf_counter()
            return [out], t1 - t0, t2 - t1, str(x.device)

        def shutdown(self):
            self.srv.shutdown()

    return Replica


def _store_round_trip(replica, x, label, card_line):
    """``x`` from the driver to the replica through put/get and back;
    bit for bit, with each step's GB/s."""
    import ray_tpu_torch
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    gb = x.numel() * x.element_size() / 1e9
    sync()
    t0 = time.perf_counter()
    ref = ray_tpu_torch.put(x)
    t_put = time.perf_counter() - t0
    (back_ref,), t_get_a, t_put_a, where = ray_tpu_torch.get(
        replica.round_trip.remote([ref]), timeout=300)
    t0 = time.perf_counter()
    back = ray_tpu_torch.get(back_ref, timeout=300)
    sync()
    t_get = time.perf_counter() - t0
    same = (back.dtype == x.dtype and back.shape == x.shape
            and back.device.type == x.device.type
            and torch.equal(back.view(torch.int32), x.view(torch.int32)))
    log(f"runtime store [{card_line}] {label}: {gb:.3f} GB driver put "
        f"{gb / t_put:.2f} GB/s, replica get {gb / t_get_a:.2f} GB/s (onto "
        f"{where}), replica put {gb / t_put_a:.2f} GB/s, driver get "
        f"{gb / t_get:.2f} GB/s (onto {back.device}); bit for bit: {same}")
    if not same:
        raise AssertionError(f"runtime store: the {label} tensor came back "
                             "changed")


def phase_runtime(pa, llama, llm, cfg, main, control, serve_tok_s, card_line,
                  dev, nbytes=RUNTIME_BYTES):
    """Phase 4r: the runtime core with the card as the ``GPU`` resource.
    ``init(num_gpus=1)``; a ``num_gpus=1`` actor builds ``LLMServer`` over
    phase 4's seeded weights (its own copy, on the card its lease binds)
    while the driver builds its own over phase 4's; each of
    RUNTIME_ONE_BY_ONE new prompts served alone must give the same tokens
    on both; phase 4's 8 prompts from 8 threads through the actor handle
    within the floor check (phase 4s's accept-everything streams must still
    break it), tok/s beside phase 4v (a)'s in-process rate; one request
    through the runtime's streaming returns, equal to ``generate``'s
    tokens for the same prompt after it; B1's launches in both
    processes; 200 empty actor calls; a 1 GiB CPU and a 1 GiB CUDA tensor
    driver -> actor -> driver through the store, bit for bit, GB/s per
    step; the zygote's fallbacks and which store ran.  ``nbytes``: each
    tensor's size.  Returns B1's launches (the driver's and the actor's)
    and (2)'s tok/s."""
    import ray_tpu_torch
    from ray_tpu_torch._private.accelerators.nvidia_gpu import (
        NvidiaGPUAcceleratorManager,
    )
    from ray_tpu_torch.util.metrics import collect_local

    on_card = dev.type == "cuda"
    # no TPU probing on this host (the TPU manager would ask the GCE
    # metadata server for a slice's name); worker logs stay in their files
    os.environ["RAY_TPU_NUM_CHIPS"] = "0"
    os.environ["RAY_TPU_DISABLE_METADATA_SERVER"] = "1"
    os.environ.setdefault("RAY_TPU_WORKER_QUIET", "1")
    params, prompts = main["params"], main["prompts"]
    conf = llm.LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=2048,
                         block_size=16, prefill_chunk=256, decode_chunk=8,
                         num_blocks=SERVE_BLOCKS)
    detected = NvidiaGPUAcceleratorManager.get_current_node_num_accelerators()
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, object_store_memory=6 * nbytes)
    node = ray_tpu_torch._local_node
    mine = replica = None
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU")
        zygote = node.raylet._zygote
        deadline = time.monotonic() + 60
        while (zygote is not None and zygote._proc is None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        log(f"runtime [{card_line}]: init(num_gpus=1) in "
            f"{time.perf_counter() - t0:.2f} s (zygote ready, pid "
            f"{zygote._proc.pid if zygote and zygote._proc else None}); "
            f"cluster GPU {gpus}, the node's own detection "
            f"{detected} card(s) (NVML, /proc or nvidia-smi -L, no CUDA "
            f"call)")
        if gpus != 1 or (on_card and detected < 1):
            raise AssertionError(f"runtime: GPU resource {gpus}, detected "
                                 f"{detected}")
        created = time.time()
        replica = _replica_class().remote(conf, SEED, dev.type, created)
        t0 = time.perf_counter()
        mine = llm.LLMServer(conf, params, device=dev)  # the driver's own
        torch.cuda.synchronize()
        mine_s = time.perf_counter() - t0
        ready = ray_tpu_torch.get(replica.ready.remote(), timeout=600)
        ready_s = time.time() - created
        log(f"runtime replica [{card_line}]: ready {ready_s:.2f} s after "
            f".remote(): spawn {ready['fork_s'] + ready['load_s']:.2f} s "
            f"(the lease and the zygote's fork {ready['fork_s']:.2f} s, then "
            f"the child's registration and loading the class and its "
            f"arguments, which imports torch and the model, "
            f"{ready['load_s']:.2f} s), CUDA init {ready['cuda_s']:.2f} s, "
            f"weights {ready['weights_s']:.2f} s, LLMServer build and warmup "
            f"{ready['warmup_s']:.2f} s (the driver's own, built meanwhile: "
            f"{mine_s:.2f} s); CUDA_VISIBLE_DEVICES, get_gpu_ids(), "
            f"device_count: {ready['visible']}; kernel on: {ready['kernel']}")
        if on_card and (ready["visible"] != ("0", [0], 1)
                        or not ready["kernel"]):
            raise AssertionError(f"runtime: the replica sees {ready}")

        ray_tpu_torch.get(replica.zero_counts.remote())
        steps0, pa.launches = mine._engine.decode_steps, 0
        # (1) one prompt at a time: the replica's tokens are the driver's.
        # Prompts neither server has seen: a cached prefix changes the
        # prefill's arithmetic, so both sides must start from empty caches
        rng = np.random.default_rng(SEED + 4)
        fresh = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                 for n in rng.integers(100, 701, RUNTIME_ONE_BY_ONE)]
        theirs, ours = [], []
        for p in fresh:
            theirs.append(ray_tpu_torch.get(replica.generate.remote(p, 64),
                                            timeout=300))
            ours.append(mine.generate(p, max_new_tokens=64))
        log(f"runtime (1): {RUNTIME_ONE_BY_ONE} new prompts of "
            f"{[len(p) for p in fresh]} tokens one at "
            f"a time: the replica's 64 tokens equal the driver's server's: "
            f"{[a == b for a, b in zip(theirs, ours)]}; first divergence "
            f"{first_divergence(ours, theirs)}")
        if theirs != ours:
            raise AssertionError("runtime (1): the replica's greedy tokens "
                                 "differ from the driver's")
        mine_launches = pa.launches
        mine_steps = mine._engine.decode_steps - steps0
        mine.shutdown()
        mine = None
        gc.collect()
        torch.cuda.empty_cache()

        # (2) 8 callers at once through the handle
        got = [None] * len(prompts)

        def call(i):
            got[i] = ray_tpu_torch.get(replica.generate.remote(prompts[i], 64),
                                       timeout=300)

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(g is None for g in got):
            raise AssertionError("runtime (2): a caller failed or hung")
        if any(len(g) != 64 for g in got):
            raise AssertionError("runtime (2): a request fell short of 64 "
                                 "tokens")
        n_tok = sum(map(len, got))
        log(f"runtime (2) [{card_line}]: 8 callers at once through the "
            f"actor handle, {n_tok} tokens in {wall:.3f} s: "
            f"{n_tok / wall:.1f} tok/s (phase 4v (a), LLMServer in process, "
            f"same call: {serve_tok_s:.1f} tok/s); first divergence from "
            f"phase 4's tokens {first_divergence(main['tokens'], got)}")
        rope = llama.rope_cache(cfg, 2048, dev)
        worst = floor_check(llama, cfg, params, rope, "runtime (2) greedy "
                            "check, 8 callers through the handle", prompts,
                            got)
        ctl = floor_check(llama, cfg, params, rope, "runtime (2) control, "
                          f"phase 4s's accept-everything streams (must "
                          f"exceed {2 * FLOOR_TIMES} x)", prompts, control)
        if worst > FLOOR_TIMES:
            raise AssertionError(f"runtime (2): a token is no near-tie of the "
                                 f"target's argmax ({worst:.3f} x its floor)")
        if ctl <= 2 * FLOOR_TIMES:
            raise AssertionError("runtime (2): the greedy check no longer "
                                 "catches an engine that accepts every draft")

        # (3) one request through the runtime's streaming returns; then the
        # same prompt through generate, from the same prefix-cache state
        t0 = time.perf_counter()
        gen = replica.generate_stream.options(
            num_returns="streaming").remote(fresh[0], 64)
        chunks, first = [], None
        for r in gen:
            chunks.append(ray_tpu_torch.get(r, timeout=300))
            first = first if first is not None else time.perf_counter() - t0
        stream_s = time.perf_counter() - t0
        joined = [t for c in chunks for t in c]
        again = ray_tpu_torch.get(replica.generate.remote(fresh[0], 64),
                                  timeout=300)
        log(f"runtime (3): generate_stream through num_returns='streaming': "
            f"{len(chunks)} chunks, first after {first * 1e3:.1f} ms, "
            f"{len(joined)} tokens in {stream_s:.3f} s; joined equal "
            f"generate's tokens for the prompt after it: {joined == again} "
            f"(and (1)'s, computed without the cached prefix: "
            f"{joined == theirs[0]})")
        if joined != again or len(chunks) < 2:
            raise AssertionError("runtime (3): the stream's chunks do not "
                                 "join to the request's tokens")
        launches, steps = ray_tpu_torch.get(replica.counts.remote())
        log(f"runtime B1: the replica {launches} launches over {steps} "
            f"decode token steps (want {cfg.n_layers} x {steps}); the "
            f"driver's server {mine_launches} over {mine_steps}")
        if on_card and (launches != cfg.n_layers * steps or not steps
                        or mine_launches != cfg.n_layers * mine_steps):
            raise AssertionError("runtime: B1 did not run on every layer of "
                                 "every token step")

        # (4) 200 empty actor calls
        rtt = []
        for _ in range(200):
            t0 = time.perf_counter()
            ray_tpu_torch.get(replica.ping.remote())
            rtt.append(time.perf_counter() - t0)
        log(f"runtime (4) [{card_line}]: 200 empty actor calls, round trip "
            f"median {statistics.median(rtt) * 1e3:.3f} ms (p10 "
            f"{sorted(rtt)[19] * 1e3:.3f}, p90 {sorted(rtt)[179] * 1e3:.3f})")

        # (5) a 1 GiB CPU and a 1 GiB CUDA tensor through the store
        n = nbytes // 4
        x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(SEED)
                          ).view(torch.float32)
        # the host's own copy rate: a put's one memcpy cannot beat it
        src = x.numpy()
        t0 = time.perf_counter()
        dst = np.empty_like(src)
        np.copyto(dst, src)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.copyto(dst, src)
        warm = time.perf_counter() - t0
        del dst, src
        log(f"runtime store [{card_line}]: the host copies {nbytes / 1e9:.3f} "
            f"GB into fresh memory at {nbytes / 1e9 / cold:.2f} GB/s, into "
            f"the same memory again at {nbytes / 1e9 / warm:.2f} GB/s")
        _store_round_trip(replica, x, "CPU fp32", card_line)
        del x
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                          device=dev, generator=g).view(torch.float32)
        _store_round_trip(replica, x,
                          "CUDA fp32" if on_card else "(no card) fp32",
                          card_line)
        del x

        spawns = {m["tags"].get("method"): m["value"] for m in collect_local()
                  if m["name"] == "ray_tpu_raylet_worker_spawns_total"}
        fallbacks = sum(m["value"] for m in collect_local()
                        if m["name"] == "ray_tpu_raylet_zygote_fallback_total")
        store = ("the native plasma arena (_native/plasma_store.cc, built "
                 "with g++ into ray_tpu_torch/_build)"
                 if node.raylet.store._native is not None else
                 "the Python shared-memory segments (no g++ build)")
        log(f"runtime [{card_line}]: worker spawns by method {spawns}, zygote "
            f"fallbacks {int(fallbacks)}; the store that ran: {store}")
        ray_tpu_torch.get(replica.shutdown.remote(), timeout=60)
        return mine_launches + launches, n_tok / wall
    finally:
        if mine is not None:
            mine.shutdown()
        ray_tpu_torch.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


DEPLOY_DRAIN_TOKENS = 512  # phase 4d (d): each stream's budget, long enough
# that the drain finds all four streams mid-decode
DEPLOY_RTT_CALLS = 50  # phase 4d: calls behind the proxy's median overhead


CHANNEL_REPS = 10  # phase 4c: timed transfers per path (medians)
# phase 4c's payload: one handoff of Llama-3-8B's KV for a 700-token
# prompt, k and v each [32 layers, 44 blocks of 16, 8 kv heads x 128] bf16
HANDOFF_SHAPE = (32, 44, 16, 1024)


def _collective_actors():
    """Phase 4c's actors (defined here, so they travel by value): one
    holding the card for the NCCL group, and the two ends of a channel
    at half a card each."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_gpus=1, num_cpus=0)
    class Solo:
        def ops(self, device_type):
            """Every op of an NCCL group at world size 1 on CUDA tensors:
            {op: (right, the process group that ran it)}."""
            from ray_tpu_torch.util import collective as col

            dev = torch.device(device_type)
            g = col.init_collective_group(1, 0, backend="nccl",
                                          group_name="solo")
            x = torch.arange(4096.0, device=dev).reshape(64, 64)
            out = {}

            def run(op, fn, want):
                got = fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                out[op] = (bool(want(got)), g.last_backend)

            run("allreduce", lambda: col.allreduce(x, "solo"),
                lambda y: torch.equal(y, x))
            run("allreduce max", lambda: col.allreduce(
                x, "solo", op=col.ReduceOp.MAX), lambda y: torch.equal(y, x))
            run("reduce", lambda: col.reduce(x, 0, "solo"),
                lambda y: torch.equal(y, x))
            run("broadcast", lambda: col.broadcast(x, 0, "solo"),
                lambda y: torch.equal(y, x))
            run("allgather", lambda: col.allgather(x, "solo"),
                lambda ys: len(ys) == 1 and torch.equal(ys[0], x))
            run("reducescatter", lambda: col.reducescatter(x, "solo"),
                lambda y: torch.equal(y, x))
            run("barrier", lambda: col.barrier("solo"), lambda _: True)
            tree = {"w": x, "b": [x[0].to(torch.bfloat16)]}
            run("allreduce_pytree", lambda: col.allreduce_pytree(
                tree, "solo", bucket_bytes=1 << 12),
                lambda y: torch.equal(y["w"], x)
                and torch.equal(y["b"][0], tree["b"][0]) and y["w"].is_cuda
                == (dev.type == "cuda"))
            col.destroy_collective_group("solo")
            return out

    @ray_tpu_torch.remote(num_gpus=0.5, num_cpus=0, max_concurrency=4)
    class Half:
        def __init__(self, device_type, shape):
            self.dev = torch.device(device_type)
            self.shape = shape
            self._ref = None

        def payload(self, seed):
            g = torch.Generator(device=self.dev).manual_seed(seed)
            return tuple(torch.randn(self.shape, generator=g,
                                     device=self.dev).to(torch.bfloat16)
                         for _ in range(2))

        def sync(self):
            if self.dev.type == "cuda":
                torch.cuda.synchronize()

        def same(self, got, seed):
            return all(a.device.type == self.dev.type and torch.equal(a, b)
                       for a, b in zip(got, self.payload(seed)))

        def put_device(self, seed):
            from ray_tpu_torch.experimental import device_objects

            self._ref = device_objects.device_put(self.payload(seed)[0])
            self.sync()
            return self._ref

        def get_device(self, ref, seed):
            from ray_tpu_torch.experimental import device_objects

            t0 = time.perf_counter()
            got = device_objects.device_get(ref)
            self.sync()
            ms = (time.perf_counter() - t0) * 1e3
            return (bool(torch.equal(got, self.payload(seed)[0])),
                    device_objects.last_fetch_path, str(got.device), ms)

        def write(self, chan, seed, reps):
            """``reps`` writes of one payload; the host clock before each
            (the previous write's acknowledgement awaited first)."""
            kv = self.payload(seed)
            self.sync()
            mem0 = (torch.cuda.memory_allocated() if self.dev.type == "cuda"
                    else 0)
            starts = []
            for _ in range(reps):
                if chan._unacked:
                    chan._await_ack("read", 300)
                    chan._unacked = 0
                starts.append(time.time())
                chan.write(kv, timeout=300)
            staging = (chan._staging.numel() if chan._staging is not None
                       else 0)
            chan.release(timeout=300)
            self.sync()
            mem1 = (torch.cuda.memory_allocated() if self.dev.type == "cuda"
                    else 0)
            return starts, staging, chan._comm is None, mem1 - mem0

        def read(self, chan, seed, reps):
            """``reps`` reads; the host clock after each (its copies
            complete); the first and the last checked bit for bit."""
            from ray_tpu_torch.experimental.channel import (
                shared_memory_channel,
            )

            ends, checks = [], []
            for i in range(reps):
                got = chan.read(timeout=300)
                ends.append(time.time())
                if i in (0, reps - 1):
                    checks.append(self.same(got, seed))
                del got
            meta_bytes = chan._meta._u64(shared_memory_channel._DATA_LEN)
            out = (ends, checks, chan.last_read_path, chan.last_read_nbytes,
                   chan._comm is None, meta_bytes)
            chan.release(timeout=300)
            return out

        def put_store(self, seed):
            import ray_tpu_torch as rt

            kv = self.payload(seed)
            self.sync()
            t0 = time.time()
            return [rt.put(kv)], t0

        def get_store(self, refs, seed):
            import ray_tpu_torch as rt

            got = rt.get(refs[0])
            self.sync()
            t1 = time.time()
            return t1, self.same(got, seed)

    return Solo, Half


def phase_collectives(card_line, dev, shape=HANDOFF_SHAPE, reps=CHANNEL_REPS):
    """Phase 4c: collectives and device objects on the card, on
    ``init(num_gpus=1)``.  (a) In a ``num_gpus=1`` actor, an NCCL group at
    world size 1: every op on CUDA tensors, its result checked and the
    process group that ran it printed (NCCL refuses two ranks on one card;
    the multi-GPU path is unverified).  (b) ``device_put`` in one half-card
    actor, ``device_get`` in another: bit for bit, its path printed.  (c)
    One Llama-3-8B handoff's KV for a 700-token prompt (two bf16 tensors,
    92 MB) through a ``CudaTensorChannel`` between the two half-card
    actors, ``reps`` times: bit for bit, through CUDA IPC (no collective
    group on either side, only metadata through shared memory), the
    writer's memory back where it was after the release; write -> read ms
    and GB/s (medians) beside its bound and the same payload through the
    object store.  Returns the channel's and the store's median ms."""
    import ray_tpu_torch

    on_card = dev.type == "cuda"
    os.environ["RAY_TPU_NUM_CHIPS"] = "0"
    os.environ["RAY_TPU_DISABLE_METADATA_SERVER"] = "1"
    os.environ.setdefault("RAY_TPU_WORKER_QUIET", "1")
    from ray_tpu_torch.experimental.channel import CudaTensorChannel

    nbytes = 2 * math.prod(shape) * 2
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        Solo, Half = _collective_actors()
        solo = Solo.remote()
        ops = ray_tpu_torch.get(solo.ops.remote(dev.type), timeout=300)
        ray_tpu_torch.kill(solo)
        log(f"collectives (a) [{card_line}]: NCCL group at world size 1 in a "
            f"num_gpus=1 actor, each op on CUDA tensors: {ops}")
        want = "nccl" if on_card else "gloo"
        if not all(ok and pg == want for ok, pg in ops.values()):
            raise AssertionError(f"collectives (a): {ops}")
        _wait(lambda: ray_tpu_torch.available_resources().get("GPU", 0)
              >= 1.0, "collectives: the solo actor's GPU back", timeout=60)
        a, b = (Half.remote(dev.type, shape) for _ in range(2))
        ray_tpu_torch.get([a.sync.remote(), b.sync.remote()], timeout=300)
        ref = ray_tpu_torch.get(a.put_device.remote(SEED), timeout=300)
        same, path, where, ms = ray_tpu_torch.get(
            b.get_device.remote(ref, SEED), timeout=300)
        log(f"collectives (b) [{card_line}]: device_put of a "
            f"{math.prod(shape) * 2 / 1e6:.1f} MB bf16 tensor in one "
            f"half-card actor, device_get in another: bit for bit {same}, "
            f"path {path} (the two share no collective group: NCCL refuses "
            f"two ranks on one card), onto {where}, {ms:.1f} ms")
        if not same or path != "host":
            raise AssertionError(f"collectives (b): {same}, {path}")

        chan = CudaTensorChannel("collectives-kv")
        try:
            w = a.write.remote(chan, SEED + 1, reps)
            r = b.read.remote(chan, SEED + 1, reps)
            starts, staging, w_no_group, mem = ray_tpu_torch.get(
                w, timeout=600)
            ends, checks, rpath, rbytes, r_no_group, meta_bytes = \
                ray_tpu_torch.get(r, timeout=600)
        finally:
            chan.destroy()
        chan_ms = [(e - s) * 1e3 for s, e in zip(starts, ends)]
        store_ms, store_same = [], []
        for i in range(reps):
            refs, t0 = ray_tpu_torch.get(a.put_store.remote(SEED + 1),
                                         timeout=300)
            t1, ok = ray_tpu_torch.get(b.get_store.remote(refs, SEED + 1),
                                       timeout=300)
            store_ms.append((t1 - t0) * 1e3)
            store_same.append(ok)
            del refs
        med_c, med_s = statistics.median(chan_ms), statistics.median(store_ms)
        bound_once = nbytes * 2 / HBM_BYTES_PER_S * 1e3
        log(f"collectives (c) [{card_line}]: {nbytes / 1e6:.1f} MB (k and v "
            f"{list(shape)} bf16) through a CudaTensorChannel between two "
            f"half-card actors, {reps} times: write -> read median "
            f"{med_c:.3f} ms ({nbytes / med_c / 1e6:.2f} GB/s; min "
            f"{min(chan_ms):.3f}, max {max(chan_ms):.3f}) by path {rpath}; "
            f"bit for bit (first, last) {checks}; {rbytes} bytes read, "
            f"{meta_bytes} bytes of metadata through shared memory, no "
            f"collective group on either side: {w_no_group and r_no_group}; "
            f"staging buffer {staging} bytes, the writer's allocated memory "
            f"after the release {mem:+d} bytes; bound (read and write each "
            f"byte once at 3.35 TB/s) {bound_once:.4f} ms, this design's "
            f"two copies (gather, copy out) {2 * bound_once:.4f} ms.  The "
            f"same payload through the object store (put in one actor, get "
            f"onto the other's card): median {med_s:.1f} ms "
            f"({nbytes / med_s / 1e6:.2f} GB/s), bit for bit {all(store_same)}")
        if (checks != [True, True] or not all(store_same)
                or (on_card and (rpath != "ipc" or not w_no_group
                                 or not r_no_group or mem != 0))
                or rbytes != nbytes or meta_bytes > 64 << 10):
            raise AssertionError(
                f"collectives (c): checks {checks}, path {rpath}, groups "
                f"{w_no_group} {r_no_group}, memory {mem}, bytes {rbytes}, "
                f"metadata {meta_bytes}, store {store_same}")
        return {"channel_ms": med_c, "store_ms": med_s}
    finally:
        ray_tpu_torch.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


def _probed(cls):
    """``cls`` (a serving class) with the read-only hooks phase 4d calls in
    a replica's own process: its card and counts, its constructor's
    seconds, checksums of its weights, the static engine's prefill graphs
    made ahead of a count, and its handoffs' export and import ms."""

    class Probed(cls):
        def __init__(self, *args, **kwargs):
            t0 = time.time()
            super().__init__(*args, **kwargs)
            self._init = (t0, time.time())
            self._steps0 = 0
            self._handoff_ms = {"export": [], "import": [], "write": [],
                                "take": []}
            eng = self._engine
            if hasattr(eng, "export_request"):
                _timed(eng, "export_request", self._handoff_ms["export"],
                       _kv_summary)
            if hasattr(eng, "import_request"):
                _timed(eng, "import_request", self._handoff_ms["import"],
                       lambda a, out: None)
            # the channel's legs: the prefill stage's write (its gather
            # enqueued), the decode stage's whole intake (read + import)
            if hasattr(self, "_write_channel"):
                _timed(self, "_write_channel", self._handoff_ms["write"],
                       lambda a, out: None)
            if hasattr(self, "_import_handoff"):
                _timed(self, "_import_handoff", self._handoff_ms["take"],
                       _import_summary)

        def probe(self):
            import ray_tpu_torch as rt
            from ray_tpu_torch.ops import flash_attention, paged_attention

            eng = self._engine
            on_card = torch.cuda.is_available()
            return {
                "pid": os.getpid(),
                "visible": (os.environ.get("CUDA_VISIBLE_DEVICES"),
                            rt.get_gpu_ids(),
                            torch.cuda.device_count() if on_card else 0),
                "kernel": bool(getattr(eng, "_use_kernel", False)),
                "init": self._init,
                "b1": paged_attention.launches,
                "b2": flash_attention.fwd_launches,
                "steps": getattr(eng, "decode_steps", 0) - self._steps0,
                "handoff_ms": {k: [round(ms, 2) for ms, _ in v]
                               for k, v in self._handoff_ms.items()},
                "handoffs": {k: [s for _, s in v]
                             for k, v in self._handoff_ms.items()},
                "recomputes": getattr(self, "recomputes", 0),
                "peak_gib": (torch.cuda.max_memory_reserved() / 2**30
                             if on_card else 0.0)}

        def zero_counts(self):
            from ray_tpu_torch._private import runtime_metrics
            from ray_tpu_torch.ops import flash_attention, paged_attention

            paged_attention.launches = flash_attention.fwd_launches = 0
            stages = runtime_metrics.SERVE_STAGE_SECONDS
            with stages._lock:  # this process's SLO stages from here on
                stages._sketches.clear()
            self._steps0 = getattr(self._engine, "decode_steps", 0)
            for rows in self._handoff_ms.values():
                rows.clear()
            if hasattr(self, "recomputes"):
                self.recomputes = 0

        def checksums(self, names):
            return _checksums(self._engine.params, names)

        def telemetry(self):
            """The engine's own books (read under its lock), its
            utilization row, the bytes of its weights and pool summed over
            the tensors, and the step telemetry's duty cycle and steps."""
            eng = self._engine

            def nbytes(tree):
                if isinstance(tree, dict):
                    return sum(nbytes(v) for v in tree.values())
                return tree.numel() * tree.element_size()

            with eng._lock:
                active = sum(1 for r in eng._slot_req if r is not None)
                free = eng.blocks.num_free()
                pending = len(eng._pending)
            tel = eng._telemetry
            return {"books": {"slots": {"active": active,
                                        "max": eng.max_batch,
                                        "free": eng.max_batch - active},
                              "kv_blocks": {"total": eng.num_blocks - 1,
                                            "free": free,
                                            "used": eng.num_blocks - 1 - free},
                              "pending": pending},
                    "row": self.utilization(),
                    "weights_bytes": nbytes(eng.params),
                    "pool_bytes": nbytes(eng.pool),
                    "duty": None if tel is None else tel.duty_cycle,
                    "steps": 0 if tel is None else tel.steps}

        def publish_slo(self):
            from ray_tpu_torch.serve._private import slo

            return slo.get_ledger().maybe_publish(force=True)

        def prepare_prefill(self, lengths):
            from ray_tpu_torch.llm.engine import _prompt_bucket

            eng = self._engine
            with torch.cuda.stream(self._stream):
                for b in sorted({_prompt_bucket(n, eng.max_seq)
                                 for n in lengths}):
                    eng._prefill_programs.get(b)

    Probed.__name__ = Probed.__qualname__ = cls.__name__
    return Probed


def _checksums(params, names):
    """{leaf: (the sum of its elements' bit patterns, their sum weighted by
    position mod 7 + 1)} for the named weight leaves: exact integers, so
    equal only for equal bits whatever the reduction's order."""
    out = {}
    for name in names:
        leaf = params
        for k in name.split("."):
            leaf = leaf[k]
        bits = leaf.reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[leaf.element_size()])
        total = weighted = 0
        for i, part in enumerate(bits.split(1 << 24)):
            x = part.to(torch.int64)
            w = (torch.arange(x.numel(), device=x.device) + (i << 24)) % 7 + 1
            total += int(x.sum())
            weighted += int((x * w).sum())
        out[name] = (total, weighted)
    return out


def _probe_app(app):
    """Give every serving deployment of ``app`` (the ingress and the
    applications bound into it) its probed class."""
    from ray_tpu_torch.llm import LLMServer, PrefillServer
    from ray_tpu_torch.serve import Application

    for a in [app] + [x for x in list(app.init_args)
                      + list(app.init_kwargs.values())
                      if isinstance(x, Application)]:
        if issubclass(a.deployment._target, (LLMServer, PrefillServer)):
            a.deployment._target = _probed(a.deployment._target)
    return app


def _replicas(app_name, dep):
    """The replica actors of ``dep`` in ``app_name``, in the controller's
    order (the last is the one a scale-down drains)."""
    import ray_tpu_torch
    from ray_tpu_torch.actor import ActorHandle
    from ray_tpu_torch._private.ids import ActorID
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    ids = ray_tpu_torch.get(get_or_create_controller()
                            .get_replica_actor_ids.remote(app_name, dep))
    return [ActorHandle(ActorID(h)) for h in ids]


def _replica_ids(app_name, dep):
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    return ray_tpu_torch.get(get_or_create_controller()
                             .get_replica_actor_ids.remote(app_name, dep))


def _call(replica, method, *args, timeout=300):
    import ray_tpu_torch

    return ray_tpu_torch.get(
        replica.handle_request.remote(method, args, {}), timeout=timeout)


def _post(url, payload, timeout=300):
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _sse(body: bytes):
    frames = [f[len(b"data: "):] for f in body.split(b"\n\n")
              if f.startswith(b"data: ")]
    if not frames or frames[-1] != b"[DONE]":
        raise AssertionError(f"deploy: an SSE body ends without [DONE]: "
                             f"{body[-200:]!r}")
    return [json.loads(f) for f in frames[:-1]]


def _migration_outcomes():
    from ray_tpu_torch.util.metrics import collect_cluster

    out = {}
    for m in collect_cluster():
        if m["name"] == "ray_tpu_serve_kv_migrations_total":
            key = (m["tags"].get("reason"), m["tags"].get("outcome"))
            out[key] = out.get(key, 0.0) + m["value"]
    return out


def _card_memory() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _check_b1(what, probes, n_layers, on_card):
    """Each replica's B1 launches = n_layers x its decode token steps,
    read in its own process; returns their sum."""
    for p in probes:
        log(f"deploy {what}: replica pid {p['pid']} {p['b1']} B1 launches "
            f"over {p['steps']} decode token steps (want {n_layers} x "
            f"{p['steps']}); its peak reserved {p['peak_gib']:.2f} GiB")
        if on_card and p["b1"] != n_layers * p["steps"]:
            raise AssertionError(f"deploy {what}: B1 did not run on every "
                                 f"layer of every token step in pid "
                                 f"{p['pid']}")
    return sum(p["b1"] for p in probes)


def _deploy_telemetry(rep, n_requests, generate, qs, card_line, on_card):
    """Phase 4d (a)'s device telemetry and state API, on the replica
    serving Llama-3-8B (``n_requests`` served since its counts were
    zeroed): ``state.serving_slo`` books queue_wait, prefill and decode for
    every request; the replica's published ``state.utilization`` row
    equals the engine's books (slots, KV blocks, queue), its HBM split
    names the weights' and the pool's bytes as the tensors sum them, with
    transient >= 0 and a duty cycle in (0, 1]; the pool autoscaler's
    headroom source reads a float; ``timeline()`` gives one execute slice
    per task the state API lists; and ``state.profile(mode="torch")`` on
    the replica, taken while it serves two requests, names B1's kernel.
    The profile's device-busy share (over the kernels' span) is printed
    beside the duty cycle: a reading, not a gate."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.serve._private.pool_autoscaler import (
        utilization_headroom,
    )
    from ray_tpu_torch.util import state

    _call(rep, "publish_slo")
    stages = state.serving_slo("llm")["deployments"].get("llm", {}).get(
        "stages", {})
    counts = {k: stages.get(k, {}).get("count", 0)
              for k in ("queue_wait", "prefill", "decode")}
    log(f"deploy (a) telemetry [{card_line}]: state.serving_slo('llm') over "
        f"{n_requests} requests: " + "; ".join(
            f"{k} count {counts[k]}, p50 {stages[k]['p50'] * 1e3:.2f} ms, "
            f"p99 {stages[k]['p99'] * 1e3:.2f} ms" for k in counts
            if counts[k]))
    if any(c != n_requests for c in counts.values()):
        raise AssertionError(f"deploy (a): SLO stages {counts} for "
                             f"{n_requests} requests")
    deadline = time.monotonic() + 30
    while True:
        tel = _call(rep, "telemetry")
        dep = state.utilization("llm")["deployments"].get("llm") or {}
        rows = [r for r in dep.get("replicas", ())
                if r.get("source") != "local"]
        if rows and all(rows[0][k] == tel["books"][k]
                        for k in ("slots", "kv_blocks", "pending")):
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"deploy (a): the published utilization "
                                 f"rows {rows} never met the books "
                                 f"{tel['books']}")
        time.sleep(0.5)
    row, headroom = rows[0], utilization_headroom("llm")
    hbm = row["hbm"]
    log(f"deploy (a) telemetry [{card_line}]: the published row equals the "
        f"engine's books {tel['books']}; HBM split from torch.cuda: weights "
        f"{hbm['weights_bytes'] / 1e9:.3f} GB (the param tensors "
        f"{tel['weights_bytes'] / 1e9:.3f} GB), KV pool "
        f"{hbm['kv_pool_bytes'] / 1e9:.3f} GB (the pool's tensors "
        f"{tel['pool_bytes'] / 1e9:.3f} GB), transient "
        f"{hbm['transient_bytes'] / 1e9:.3f} GB of "
        f"{hbm['device_used_bytes'] / 1e9:.3f} GB allocated in the "
        f"replica; duty cycle {row['duty_cycle']}, {row['rates']['steps']} "
        f"steps; utilization_headroom('llm') {headroom}")
    if (hbm["weights_bytes"] != tel["weights_bytes"]
            or hbm["kv_pool_bytes"] != tel["pool_bytes"]
            or hbm["transient_bytes"] < 0
            or not 0 < row["duty_cycle"] <= 1
            or not isinstance(headroom, float)):
        raise AssertionError(f"deploy (a): utilization row {row}, headroom "
                             f"{headroom}")

    # the timeline: an execute slice for every task the state API lists
    path = os.path.join(tempfile.gettempdir(),
                        f"chip_smoke_timeline_{os.getpid()}.json")
    ran = {(t["task_id"], t.get("attempt", 0))
           for t in state.list_tasks(limit=100000)
           if t.get("start_time") is not None}
    events = ray_tpu_torch.timeline(path)
    tasks = state.list_tasks(limit=100000)
    sliced = {(e["args"]["task_id"], e["args"]["attempt"]) for e in events
              if e["ph"] == "X" and e["cat"] in ("task", "actor_task")}
    ran_after = {(t["task_id"], t.get("attempt", 0)) for t in tasks
                 if t.get("start_time") is not None}
    calls = sum(1 for t in tasks if "handle_request" in str(t.get("name")))
    with open(path) as f:
        written = len(json.load(f))
    log(f"deploy (a) timeline: {len(events)} Chrome trace events written "
        f"({written} in the file), {len(sliced)} execute slices for "
        f"{len(ran)}-{len(ran_after)} tasks the state API lists as run, "
        f"{calls} replica calls (handle_request*) for {n_requests} requests")
    if not ran <= sliced <= ran_after or calls < n_requests \
            or written != len(events):
        raise AssertionError("deploy (a): the timeline's slices do not "
                             "match the tasks")

    # a torch.profiler capture of the replica while it serves.  Its
    # tracer is started (a first capture, ~8 s) and every capture enabled
    # and stopped while the replica is idle: a capture started or stopped
    # while the engine loop replays its graphs has stalled the loop for
    # minutes.  Two requests of 16 tokens run inside a 2 s capture
    pid = _call(rep, "probe")["pid"]
    state.profile(pid, duration_s=0.1, mode="torch")
    out = {}

    def load():
        time.sleep(0.5)
        threads = [threading.Thread(target=lambda q=q: out.setdefault(
            "r", []).append(generate(q, 16)), daemon=True) for q in qs[:2]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        out["during"] = _call(rep, "telemetry")

    runner = threading.Thread(target=load, daemon=True)
    runner.start()
    prof = state.profile(pid, duration_s=2.0, mode="torch")
    runner.join(120)
    during = out.get("during", {})
    with open(prof["artifact"]) as f:
        trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", ())
               if e.get("cat") == "kernel" and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # the union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    names = sorted({e["name"] for e in kernels})
    b1 = [n for n in names if "paged_decode_kernel" in n]
    cats = {}
    for e in trace.get("traceEvents", ()):
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    log(f"deploy (a) profile [{card_line}]: state.profile(pid {pid}, "
        f"duration 2 s, mode='torch') around two requests of 16 tokens, "
        f"events by category {cats}: {prof['artifact']}, "
        f"{len(kernels)} kernel events of {len(names)} names, B1 named "
        f"{b1[:1]}; device busy {busy / 1e3:.1f} ms of the kernels' "
        f"{window / 1e3:.1f} ms window (share "
        f"{busy / window if window else 0.0:.3f}) beside the engine's duty "
        f"cycle {during.get('duty')} after them")
    if (on_card and not b1) or len(out.get("r", ())) != 2 or any(
            len(r) != 16 for r in out["r"]):
        raise AssertionError("deploy (a): the replica's torch profile names "
                             "no B1 kernel, or the streams failed")


def _disagg_stages(pre, dec, n, tok_s, label, card_line):
    """The SLO stages of a disaggregated run of ``n`` requests: queue_wait
    and prefill under the prefill deployment, handoff and decode under the
    decode deployment, each booked once a request ({stage: summary})."""
    from ray_tpu_torch.util import state

    for r in (pre, dec):
        _call(r, "publish_slo")
    deps = state.serving_slo()["deployments"]
    got = {}
    for dep, names in (("pd-prefill", ("queue_wait", "prefill")),
                       ("pd-decode", ("handoff", "decode"))):
        for name in names:
            got[name] = deps.get(dep, {}).get("stages", {}).get(name, {})
    counts = {k: v.get("count", 0) for k, v in got.items()}
    if any(c != n for c in counts.values()):
        raise AssertionError(f"deploy (c) {label}: SLO stages {counts} for "
                             f"{n} requests")
    return {"tok_s": tok_s, "stages": got}


def _stage_table(runs, card_line):
    """4d (c)'s per-stage p50 and p99 by transport, and the stage with the
    largest share of a request's time."""
    log(f"deploy (c) stages [{card_line}]: p50 / p99 ms of each request's "
        f"stage, 8 requests from 8 threads per transport")
    for label, run in runs.items():
        st = run["stages"]
        total = sum(v["p50"] for v in st.values())
        top = max(st, key=lambda k: st[k]["p50"])
        log(f"  {label:8s} {run['tok_s']:7.1f} tok/s  " + "  ".join(
            f"{k} {v['p50'] * 1e3:.1f} / {v['p99'] * 1e3:.1f}"
            for k, v in st.items())
            + f"  (largest p50: {top}, {st[top]['p50'] / total:.2f} of the "
              f"stages' p50 sum)")


def phase_deploy(llama, llm, cfg, prompts, control, rates, handoff_4v,
                 card_line, dev):
    """Phase 4d: Llama-3-8B served as serve deployments of the port's
    control plane on ``init(num_gpus=1)``, through the handle and the HTTP
    proxy.  Replicas draw seed-0 weights on their own card (``params=None``
    through ``bind``); the driver's reference ``LLMServer`` draws the same,
    checked by checksums first.  (a) ``build_llm_deployment``: one replica
    holding ``GPU`` 1 (``get_gpu_ids() == [0]``, nothing of the card left
    in the scheduler); three new prompts one at a time through the handle
    and three through ``POST /llm`` give the reference's 64 tokens; phase
    4's 8 prompts from 8 threads through ``generate_stream``, and 8 new
    ones of their lengths through HTTP, within the floor check (4s's control, drawn on other weights, must
    break it), tok/s beside 4r's actor and 4v (a)'s server; an SSE
    request joins to ``generate``'s tokens; the proxy's added ms per
    request on an empty deployment.  (b) ``build_openai_app`` over the
    static engine: a completion, a chat and a streamed chat over HTTP,
    4v (e)'s requests, their shapes and usage; B2 = 32 x 3 prefills in
    the replica.  (c) ``build_disagg_llm_deployment`` (object transport)
    at half a card per stage: the 8 prompts from 8 threads through the
    ingress within the floor check, each handoff's export and import ms
    beside 4v (d)'s; then the same application with
    ``transport="channel"`` (the stages kept: only the ingress's arguments
    change), 8 new prompts: k/v on the card at export, read through CUDA
    IPC, no recompute, within the floor check, three more one at a time
    equal to the reference's; then with ``handoff_compression="int8"``:
    its wire bytes, the floor check.  (d) two
    replicas at half a card, four streams, then ``serve.run`` at one
    replica: every stream completes within the floor check, the drain
    books only migrated or fallback outcomes, none lost; the drain's
    seconds and each moved stream's longest pause.  B1's launches = 32 x
    the token steps in every replica's process.  Returns (B1's launches
    in the replicas, B2's in (b)'s replica)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    on_card = dev.type == "cuda"
    dev_arg = None if on_card else "cpu"  # the builders' device keyword
    os.environ["RAY_TPU_NUM_CHIPS"] = "0"
    os.environ["RAY_TPU_DISABLE_METADATA_SERVER"] = "1"
    os.environ.setdefault("RAY_TPU_WORKER_QUIET", "1")
    paged = dict(model_config=cfg, max_batch_size=8, max_seq_len=2048,
                 block_size=16, prefill_chunk=256, decode_chunk=8,
                 num_blocks=SERVE_BLOCKS)
    conf = llm.LLMConfig(**paged)
    half = llm.LLMConfig(**paged, chips_per_replica=0.5)
    rope = llama.rope_cache(cfg, 2048, dev)
    leaves = ["embed", "layers.wq", "layers.w_down", "final_norm"]
    b1 = b2 = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    ref = None
    try:
        t0 = time.perf_counter()
        ref = llm.LLMServer(conf, device=dev)  # seed-0 weights, as replicas'
        ref_s = time.perf_counter() - t0
        ref_params = ref._engine.params
        want_sums = _checksums(ref_params, leaves)

        # (a) build_llm_deployment
        t0, wall0 = time.perf_counter(), time.time()
        handle = serve.run(_probe_app(llm.build_llm_deployment(
            conf, device=dev_arg)), name="llm", route_prefix="/llm")
        ready_s = time.perf_counter() - t0
        host, port = serve.start_http_proxy(port=0)
        url = f"http://{host}:{port}"
        (rep,) = _replicas("llm", "llm")
        p = _call(rep, "probe")
        if on_card:  # a replica built for the CPU holds no GPU
            _wait(lambda: not ray_tpu_torch.available_resources().get("GPU"),
                  "deploy (a): the replica's GPU held", timeout=30)
        status = serve.status()["llm"]
        sums = _call(rep, "checksums", leaves)
        log(f"deploy (a) [{card_line}]: serve.run(build_llm_deployment) "
            f"ready in {ready_s:.2f} s: the replica's constructor began "
            f"{p['init'][0] - wall0:.2f} s after the call (the controller's "
            f"start, the lease, the fork, imports and unpickling the "
            f"arguments), ran {p['init'][1] - p['init'][0]:.2f} s (warmup "
            f"included; the driver's reference server {ref_s:.2f} s), and "
            f"the health gate and the router's wait took the last "
            f"{wall0 + ready_s - p['init'][1]:.2f} s; status {status}; the "
            f"scheduler's GPU left "
            f"{ray_tpu_torch.available_resources().get('GPU', 0)}; "
            f"CUDA_VISIBLE_DEVICES, get_gpu_ids(), device_count in the "
            f"replica {p['visible']}; kernel on {p['kernel']}; weight "
            f"checksums equal the reference's: {sums == want_sums}")
        if len(status["replicas"]) != 1 or sums != want_sums:
            raise AssertionError(f"deploy (a): replicas {status}, checksums "
                                 f"{sums} vs {want_sums}")
        if on_card and (p["visible"] != ("0", [0], 1) or not p["kernel"]):
            raise AssertionError(f"deploy (a): the replica sees {p}")
        _call(rep, "zero_counts")
        # one prompt at a time, through the handle and through HTTP, on
        # prompts neither server has seen
        rng = np.random.default_rng(SEED + 9)
        fresh = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                 for n in rng.integers(100, 701, 2 * RUNTIME_ONE_BY_ONE)]
        via_handle = [handle.generate.remote(q, max_new_tokens=64).result(
            timeout_s=300) for q in fresh[:RUNTIME_ONE_BY_ONE]]
        via_http = [json.loads(_post(f"{url}/llm", {
            "prompt": q, "max_new_tokens": 64}))["tokens"]
            for q in fresh[RUNTIME_ONE_BY_ONE:]]
        ours = [ref.generate(q, max_new_tokens=64) for q in fresh]
        log(f"deploy (a): {2 * RUNTIME_ONE_BY_ONE} new prompts of "
            f"{[len(q) for q in fresh]} tokens one at a time, "
            f"{RUNTIME_ONE_BY_ONE} through the handle and "
            f"{RUNTIME_ONE_BY_ONE} through POST /llm: the replica's 64 "
            f"tokens equal the reference's: "
            f"{[a == b for a, b in zip(via_handle + via_http, ours)]}; "
            f"first divergence {first_divergence(ours, via_handle + via_http)}")
        if via_handle + via_http != ours:
            raise AssertionError("deploy (a): the replica's greedy tokens "
                                 "differ from the reference's")

        def eight(call, qs=prompts):
            got, errs = [None] * len(qs), []

            def run(i):
                try:
                    got[i] = call(qs[i])
                except Exception as e:  # noqa: BLE001 — reported below
                    errs.append(e)

            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(len(qs))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            wall = time.perf_counter() - t0
            if errs or any(t.is_alive() for t in threads) or any(
                    g is None or len(g) != 64 for g in got):
                raise AssertionError(f"deploy: a caller failed, hung or "
                                     f"fell short: {errs}")
            return got, sum(map(len, got)) / wall

        streamed, tok_handle = eight(lambda q: sum(
            handle.options(stream=True).generate_stream.remote(
                q, max_new_tokens=64), []))
        # HTTP on new prompts of the same lengths: phase 4's are cached now
        other = [rng.integers(0, cfg.vocab_size, len(q)).tolist()
                 for q in prompts]
        posted, tok_http = eight(lambda q: json.loads(_post(
            f"{url}/llm", {"prompt": q, "max_new_tokens": 64}))["tokens"],
            other)
        log(f"deploy (a) [{card_line}]: 8 callers at once, "
            f"{tok_handle:.1f} tok/s through handle.options(stream=True)"
            f".generate_stream, {tok_http:.1f} tok/s through POST /llm "
            f"(new prompts of the same lengths; same call: 4r's actor "
            f"{rates['actor']:.1f}, 4v (a)'s server "
            f"in process {rates['server']:.1f})")
        worst = floor_check(llama, cfg, ref_params, rope, "deploy (a) greedy "
                            "check, 8 streams through the handle and 8 "
                            "requests through HTTP", prompts + other,
                            streamed + posted)
        ctl = floor_check(llama, cfg, ref_params, rope, "deploy (a) control, "
                          "phase 4s's accept-everything streams (drawn on "
                          f"phase 4's weights; must exceed {2 * FLOOR_TIMES}"
                          " x)", prompts, control)
        if worst > FLOOR_TIMES or ctl <= 2 * FLOOR_TIMES:
            raise AssertionError(f"deploy (a): floor check {worst:.3f}, "
                                 f"control {ctl:.3f}")
        items = _sse(_post(f"{url}/llm", {"prompt": fresh[0],
                                          "max_new_tokens": 64,
                                          "stream": True}))
        joined = [t for it in items for t in it["tokens"]]
        again = handle.generate.remote(fresh[0], max_new_tokens=64).result(
            timeout_s=300)
        log(f"deploy (a): POST /llm with stream true: {len(items)} SSE "
            f"frame(s), {len(joined)} tokens, equal to generate's for the "
            f"prompt after it: {joined == again}")
        if joined != again:
            raise AssertionError("deploy (a): the SSE stream does not join "
                                 "to generate's tokens")
        b1 += _check_b1("(a)", [_call(rep, "probe")], cfg.n_layers, on_card)
        # device telemetry and the state API over the requests since
        # zero_counts: the one-by-one, the 8 + 8 callers, the SSE and the
        # generate after it
        _deploy_telemetry(rep, 2 * RUNTIME_ONE_BY_ONE + 2 * len(prompts) + 2,
                          lambda q, n: handle.generate.remote(
                              q, max_new_tokens=n).result(timeout_s=300),
                          [rng.integers(0, cfg.vocab_size, len(q)).tolist()
                           for q in prompts], card_line, on_card)

        @serve.deployment
        def noop(x):
            return x

        noop_h = serve.run(noop.bind(), name="noop", route_prefix="/noop")
        rtt = {"handle": [], "http": []}
        for _ in range(DEPLOY_RTT_CALLS):
            t0 = time.perf_counter()
            noop_h.remote(1).result(timeout_s=60)
            rtt["handle"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            _post(f"{url}/noop", 1, timeout=60)
            rtt["http"].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) * 1e3 for k, v in rtt.items()}
        log(f"deploy (a) [{card_line}]: {DEPLOY_RTT_CALLS} calls to an empty "
            f"deployment, median round trip {med['handle']:.3f} ms through "
            f"the handle, {med['http']:.3f} ms through POST (a new "
            f"connection each): the proxy adds "
            f"{med['http'] - med['handle']:.3f} ms a request")
        serve.delete("noop")
        serve.delete("llm")

        # (b) build_openai_app over the static engine
        static = llm.LLMConfig(model_config=cfg, kv_cache="static",
                               max_batch_size=8, max_seq_len=2048,
                               decode_chunk=8)
        t0 = time.perf_counter()
        serve.run(_probe_app(llm.build_openai_app(
            static, tokenizer=llm.ByteTokenizer(),
            model_id="llama-3-8b-random", device=dev_arg)),
            name="openai", route_prefix="/v1")
        oa_s = time.perf_counter() - t0
        (rep,) = _replicas("openai", "openai-llm")
        tok = llm.ByteTokenizer()
        rendered = llm.OpenAICompatServer._render_chat(
            types.SimpleNamespace(_tok=tok), OPENAI_MSGS)
        lens = [len(tok.encode(OPENAI_TEXT)), len(tok.encode(rendered))]
        _call(rep, "prepare_prefill", lens)
        _call(rep, "zero_counts")
        t0 = time.perf_counter()
        comp = json.loads(_post(f"{url}/v1", {"prompt": OPENAI_TEXT,
                                              "max_tokens": 16}))
        chat = json.loads(_post(f"{url}/v1", {"messages": OPENAI_MSGS,
                                              "max_tokens": 16}))
        chunks = _sse(_post(f"{url}/v1", {"messages": OPENAI_MSGS,
                                          "max_tokens": 16, "stream": True}))
        wall = time.perf_counter() - t0
        p = _call(rep, "probe")
        bad = openai_shapes(comp, chat, chunks, lens)
        log(f"deploy (b) [{card_line}]: serve.run(build_openai_app) over the "
            f"static engine ready in {oa_s:.2f} s; over HTTP a completion, a "
            f"chat completion and a streamed chat in {wall:.2f} s; prompts "
            f"{lens} tokens; usage {comp['usage']} and {chat['usage']} (4v "
            f"(e)'s in process on the same requests: prompt tokens {lens}, "
            f"16 completion tokens each); {len(chunks)} SSE chunks; {p['b2']} "
            f"B2 launches in the replica (want {cfg.n_layers} x 3)")
        if on_card and p["b2"] != 3 * cfg.n_layers:
            bad.append(f"{p['b2']} B2 launches")
        if bad:
            raise AssertionError(f"deploy (b): {bad}")
        b2 += p["b2"]
        serve.delete("openai")

        # (c) the disaggregated deployment, half a card per stage: the
        # object transport, then the same stages behind a channel ingress
        stages = ("prefill", "decode")
        pd_app = _probe_app(llm.build_disagg_llm_deployment(
            half, name="pd", device=dev_arg))
        t0 = time.perf_counter()
        pd = serve.run(pd_app, name="pd", route_prefix="/pd")
        ingress_s = time.perf_counter() - t0
        # serve.run waits for the ingress; the stages start beside it
        _wait(lambda: all(len(_replicas("pd", f"pd-{stage}")) == 1
                          for stage in stages),
              "deploy (c): the stages' replicas", timeout=300)
        pd_s = time.perf_counter() - t0
        (pre,), (dec,) = _replicas("pd", "pd-prefill"), _replicas(
            "pd", "pd-decode")
        for r in (pre, dec):
            _call(r, "zero_counts")
        out, tok_pd = eight(lambda q: pd.generate.remote(
            q, max_new_tokens=64).result(timeout_s=300))
        pp, dp = _call(pre, "probe"), _call(dec, "probe")
        obj_mb = [round(s["nbytes"] / 1e6, 1)
                  for s in pp["handoffs"]["export"]]
        log(f"deploy (c) [{card_line}]: serve.run(build_disagg_llm_"
            f"deployment): the CPU ingress ready in {ingress_s:.2f} s, the "
            f"prefill and decode replicas (GPU 0.5 each) in {pd_s:.2f} s; "
            f"8 prompts from 8 "
            f"threads through the ingress, {tok_pd:.1f} tok/s; export ms "
            f"{pp['handoff_ms']['export']} and import ms "
            f"{dp['handoff_ms']['import']} in the replicas (the decode "
            f"stage's whole intake {dp['handoff_ms']['take']} ms; host "
            f"clock; 4v (d)'s in process: export {handoff_4v['export']}, "
            f"import {handoff_4v['import']}); payload MB {obj_mb} through "
            f"the store")
        if len(pp["handoff_ms"]["export"]) != 8 or len(
                dp["handoff_ms"]["import"]) != 8:
            raise AssertionError("deploy (c): not every prompt was handed "
                                 "off as KV")
        if floor_check(llama, cfg, ref_params, rope, "deploy (c) greedy "
                       "check, 8 disaggregated streams", prompts,
                       out) > FLOOR_TIMES:
            raise AssertionError("deploy (c): a token is no near-tie")
        b1 += _check_b1("(c)", [pp, dp], cfg.n_layers, on_card)
        pd_stages = {"store": _disagg_stages(pre, dec, len(prompts), tok_pd,
                                             "store", card_line)}
        stage_ids = {s: _replica_ids("pd", f"pd-{s}") for s in stages}

        def channel_run(label, **kw):
            """``serve.run`` of the same application with a channel
            ingress: the stages' arguments (and classes) are unchanged, so
            only the ingress should restart; 8 new prompts of phase 4's
            lengths from 8 threads."""
            app = llm.build_disagg_llm_deployment(
                half, name="pd", transport="channel", device=dev_arg, **kw)
            for a in app.init_args:  # the object run's probed stages
                if isinstance(a, type(pd_app)):
                    a.deployment._target = next(
                        b.deployment._target for b in pd_app.init_args
                        if isinstance(b, type(pd_app))
                        and b.deployment.name == a.deployment.name)
            ingress0 = _replica_ids("pd", "pd")
            t0 = time.perf_counter()
            h = serve.run(app, name="pd", route_prefix="/pd")
            # the old ingress drains; the new one is the only replica
            _wait(lambda: (lambda ids: len(ids) == 1 and ids != ingress0)(
                _replica_ids("pd", "pd")) and all(
                len(_replicas("pd", f"pd-{s}")) == 1 for s in stages),
                f"deploy (c) {label}: the new ingress", timeout=300)
            run_s = time.perf_counter() - t0
            restarted = {s: _replica_ids("pd", f"pd-{s}") != stage_ids[s]
                         for s in stages}
            (pre,), (dec,) = _replicas("pd", "pd-prefill"), _replicas(
                "pd", "pd-decode")
            for r in (pre, dec):
                _call(r, "zero_counts")
            qs = [rng.integers(0, cfg.vocab_size, len(q)).tolist()
                  for q in prompts]
            got, tok = eight(lambda q: h.generate.remote(
                q, max_new_tokens=64).result(timeout_s=300), qs)
            pp, dp = _call(pre, "probe"), _call(dec, "probe")
            exports, takes = pp["handoffs"]["export"], dp["handoffs"]["take"]
            log(f"deploy (c) {label} [{card_line}]: serve.run with "
                f"transport='channel'{kw or ''} in {run_s:.2f} s; the stages "
                f"restarted: {restarted} (their arguments are unchanged); 8 "
                f"new prompts of phase 4's lengths from 8 threads, "
                f"{tok:.1f} tok/s (the object transport's {tok_pd:.1f} in "
                f"this call, 4v (a)'s server in process "
                f"{rates['server']:.1f}); export ms "
                f"{pp['handoff_ms']['export']} and the channel write "
                f"{pp['handoff_ms']['write']} in the prefill replica, k/v on "
                f"the card at export {[s['on_card'] for s in exports]}; the "
                f"decode stage's intake (read + import) ms "
                f"{dp['handoff_ms']['take']}, of it import_request "
                f"{dp['handoff_ms']['import']}; MB exported "
                f"{[round(s['nbytes'] / 1e6, 1) for s in exports]}, MB read "
                f"{[round(s['nbytes'] / 1e6, 1) for s in takes]} by path "
                f"{sorted({s['path'] for s in takes})}; recomputes "
                f"{dp['recomputes']}")
            if (len(exports) != 8 or len(takes) != 8
                    or dp["recomputes"] != 0
                    or (on_card and not all(s["on_card"] for s in exports))
                    or any(s["path"] != ("ipc" if on_card else "comm")
                           for s in takes)):
                raise AssertionError(
                    f"deploy (c) {label}: exports {exports}, reads {takes}, "
                    f"recomputes {dp['recomputes']}")
            if floor_check(llama, cfg, ref_params, rope,
                           f"deploy (c) {label} greedy check, 8 streams "
                           "through the channel", qs, got) > FLOOR_TIMES:
                raise AssertionError(f"deploy (c) {label}: a token is no "
                                     "near-tie")
            pd_stages[label] = _disagg_stages(pre, dec, len(qs), tok, label,
                                              card_line)
            return h, pp, dp, exports, takes

        h, pp, dp, exports, takes = channel_run("channel")
        # new prompts one at a time: the reference server's tokens exactly
        qs = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
              for n in rng.integers(100, 701, RUNTIME_ONE_BY_ONE)]
        via = [h.generate.remote(q, max_new_tokens=64).result(timeout_s=300)
               for q in qs]
        ours = [ref.generate(q, max_new_tokens=64) for q in qs]
        log(f"deploy (c) channel: {RUNTIME_ONE_BY_ONE} new prompts of "
            f"{[len(q) for q in qs]} tokens one at a time: the reference "
            f"server's 64 tokens: {[a == b for a, b in zip(via, ours)]}; "
            f"first divergence {first_divergence(ours, via)}")
        if via != ours:
            raise AssertionError("deploy (c) channel: the greedy tokens "
                                 "differ from the reference server's")
        b1 += _check_b1("(c) channel", [_call(r, "probe") for r in (
            _replicas("pd", "pd-prefill")[0], _replicas("pd", "pd-decode")[0])],
            cfg.n_layers, on_card)
        _, pp8, dp8, exports8, takes8 = channel_run(
            "int8", handoff_compression="int8")
        # the stages' lists come in their own orders: pair them by size
        wire = sorted(s["nbytes"] for s in takes8)
        logical = sorted(s["nbytes"] for s in exports8)
        size = torch.empty((), dtype=cfg.compute_dtype).element_size()
        want = (1 + 4 / 256) / size  # int8 codes, an fp32 scale per 256
        log(f"deploy (c) int8: wire bytes (codes + scales) "
            f"{[round(w / 1e6, 2) for w in wire]} MB for "
            f"{[round(n / 1e6, 1) for n in logical]} MB of "
            f"{cfg.compute_dtype} KV (ratio "
            f"{sum(wire) / max(sum(logical), 1):.4f}; int8 codes and an "
            f"fp32 scale per 256 elements: {want:.4f})")
        if any(abs(w / n - want) > 1e-3 for w, n in zip(wire, logical)):
            raise AssertionError(f"deploy (c) int8: wire {wire} for "
                                 f"{logical}")
        b1 += _check_b1("(c) int8", [pp8, dp8], cfg.n_layers, on_card)
        _stage_table(pd_stages, card_line)
        serve.delete("pd")

        # (d) a drain that migrates: two replicas, then one
        app = _probe_app(llm.build_llm_deployment(
            llm.LLMConfig(**paged, num_replicas=2, chips_per_replica=0.5),
            device=dev_arg))
        t0 = time.perf_counter()
        dh = serve.run(app, name="drain")
        two_s = time.perf_counter() - t0
        _wait(lambda: len(_replicas("drain", "llm")) == 2,
              "deploy (d): two replicas", timeout=300)
        reps = _replicas("drain", "llm")
        ready = [_call(r, "probe") for r in reps]
        for r in reps:
            _call(r, "zero_counts")
        memory = _card_memory()
        recs = []

        def stream(q):
            rec = {"tokens": [], "times": []}
            for chunk in dh.options(stream=True).generate_stream.remote(
                    q, max_new_tokens=DEPLOY_DRAIN_TOKENS):
                rec["times"].append(time.perf_counter())
                rec["tokens"].extend(chunk)
                if len(rec["times"]) == 1:
                    recs.append((q, rec))

        threads = []
        for q in prompts[:4]:
            threads.append(threading.Thread(target=stream, args=(q,),
                                            daemon=True))
            threads[-1].start()
            # the stream is counted on its replica once its first chunk
            # came; past the router's probe TTL, pow-2 then spreads them
            _wait(lambda: len(recs) == len(threads),
                  "deploy (d): a stream's first chunk", timeout=120)
            time.sleep(0.3)
        busy = [r["ongoing"] for r in serve.status()["drain"]["replicas"]]
        victim, survivor = reps[-1], reps[0]
        before = _migration_outcomes()
        t_drain = time.perf_counter()
        serve.run(app.deployment.options(num_replicas=1).bind(
            *app.init_args, **app.init_kwargs), name="drain")
        _wait(lambda: _migration_outcomes() != before,
              "deploy (d): the drain's migrations booked", timeout=120)
        victim_probe = _call(victim, "probe", timeout=30)
        for t in threads:
            t.join(300)
        _wait(lambda: len(_replicas("drain", "llm")) == 1
              and len(serve.status()["drain"]["replicas"]) == 1,
              "deploy (d): the drain", timeout=120)
        drain_s = time.perf_counter() - t_drain
        after = _migration_outcomes()
        moved = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after}
        moved = {f"{r}/{o}": v for (r, o), v in moved.items() if v}
        pauses = [max((b - a) * 1e3 for a, b in zip(
            rec["times"], rec["times"][1:]) if b > t_drain)
            for _, rec in recs if rec["times"][-1] > t_drain]
        log(f"deploy (d) [{card_line}]: two replicas at GPU 0.5 ready in "
            f"{two_s:.2f} s (constructors "
            f"{[round(p['init'][1] - p['init'][0], 2) for p in ready]} s; "
            f"CUDA_VISIBLE_DEVICES, get_gpu_ids() "
            f"{[p['visible'][:2] for p in ready]}); card memory with the "
            f"reference and both replicas {memory}; 4 streams of "
            f"{DEPLOY_DRAIN_TOKENS} tokens, {busy} on the replicas; "
            f"serve.run at one replica drained the second in {drain_s:.2f} s; "
            f"migration outcomes {moved}; each stream's longest pause after "
            f"the drain began {[round(x, 1) for x in pauses]} ms")
        if (len(recs) != 4 or any(len(r["tokens"]) != DEPLOY_DRAIN_TOKENS
                                  for _, r in recs)):
            raise AssertionError("deploy (d): a stream was lost or fell short")
        if (not moved or any(k not in ("drain/migrated", "drain/fallback")
                             for k in moved)
                or sum(moved.values()) > busy[-1]):
            raise AssertionError(f"deploy (d): outcomes {moved} with "
                                 f"{busy[-1]} streams on the drained replica")
        if floor_check(llama, cfg, ref_params, rope, "deploy (d) greedy "
                       "check, 4 streams across the drain",
                       [q for q, _ in recs],
                       [r["tokens"] for _, r in recs]) > FLOOR_TIMES:
            raise AssertionError("deploy (d): a token is no near-tie")
        b1 += _check_b1("(d)", [victim_probe, _call(survivor, "probe")],
                        cfg.n_layers, on_card)
        serve.delete("drain")
        peak = (torch.cuda.max_memory_reserved() / 2**30 if on_card else 0.0)
        log(f"deploy [{card_line}]: the driver's peak reserved {peak:.2f} GiB "
            f"(its reference server, and phase 4's weights freed before "
            f"4d); {time.perf_counter() - t_phase:.1f} s")
        return b1, b2
    finally:
        serve.shutdown()
        if ref is not None:
            ref.shutdown()
        ray_tpu_torch.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


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


def _flash_inputs(dev, gen, b, s, hq, hkv, d, dtype=torch.bfloat16):
    def randn(h):
        return torch.randn((b * h, s, d), generator=gen, device=dev,
                           dtype=dtype)

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
    """{kernel: {op: count}} over ``cuobjdump -sass`` of a built library,
    for each function whose name holds one of ``kernels`` (the first that
    it holds), counting instructions by opcode: "LDS" counts every LDS
    (LDS.128 among them, not LDSM), "LDS.128" those with the .128 suffix;
    LDGSTS is not an STS."""
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
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if cur and m:
            base, *suffixes = m.group(1).split(".")
            for op in ops:
                want, *width = op.split(".")
                counts[cur][op] += base == want and all(
                    w in suffixes for w in width)
    return counts


def phase_flash_sass(libs):
    """The wgmma flash kernels' design as compiled, at head_dim 128
    (flash_attention) and 256 (flash_attention_d256): wgmma and TMA loads
    in the forward, dK/dV and dQ kernels (delta is a plain 16-byte-load
    pass); the head_dim-256 kernels' registers and spills from ptxas.
    ``libs``: the build's {source: (library, compiler output)}."""
    counts = {}
    for source, kernels in (("flash_attention", FLASH_KERNELS),
                            ("flash_attention_d256", FLASH_D256_KERNELS)):
        library, build_log = libs[source]
        if source == "flash_attention_d256":
            for line in build_log.splitlines():
                if ("flash_d256" in line or "registers" in line
                        or "spill" in line or "C75" in line):
                    log(f"  ptxas {source}: {line.strip()}")
        found = sass_counts(library, kernels)
        for k in kernels:
            c = found.get(k, dict.fromkeys(SASS_OPS, 0))
            log(f"sass {source} {k}: " + ", ".join(
                f"{op} {c[op]}" for op in SASS_OPS))
            if k != "flash_bwd_delta_kernel" and not (c["HGMMA"]
                                                       and c["UTMALDG"]):
                raise AssertionError(f"{k} has no wgmma (HGMMA) or no TMA "
                                     f"load (UTMALDG) in its SASS: {c}")
        counts[source] = found
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


def phase_flash(fa, dev, shape=(8, 2048, 16, 8, 128), name="", groups=True):
    """Flash kernels vs plain versions at the training path's shapes:
    shape = (B, S, Hq, Hkv, D); ``name``: the instantiation, in the log
    lines (B2/B3's unnamed); ``groups``: also at GQA group 1 and at the MoE
    step's heads."""
    tag = f"{name} " if name else ""
    label = f"flash {name}".strip()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, s, hq, hkv, d = shape
    kw = dict(scale=d ** -0.5, causal=True, n_rep=hq // hkv)
    q3, k3, v3, do = _flash_inputs(dev, gen, b, s, hq, hkv, d)
    err, want, tol = _flash_check(fa, q3, k3, v3, do, kw,
                                  f"{tag}causal, group {hq // hkv}")
    ro, rlse = want["o"], want["lse"]
    # no atomics: repeat calls give the same bits
    if not (torch.equal(fa.flash_attention_fwd(q3, k3, v3, **kw)[0],
                        fa.flash_attention_fwd(q3, k3, v3, **kw)[0])
            and all(torch.equal(a, b) for a, b in zip(
                fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw),
                fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)))):
        raise AssertionError(f"{label}: repeat calls differ")

    # negative controls: the last key feeds only the last query row, and
    # only the last query row feeds the last key.  The kernels run without
    # the last key's V (O misses one of that row's terms), without its K
    # (dQ misses one of that row's terms) and without the last dO row
    # (dK and dV miss the last key's only term) must break the tolerance
    def cut(key, got):
        return ((got[:, -1].float() - want[key][:, -1].float()).abs()
                / tol[key][:, -1]).max().item()

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
    log(f"{label}: without the last of {s} keys, O reaches {cuts['o']:.3f} of "
        f"its tolerance at the last row and dQ {cuts['dq']:.3f}; without the "
        f"last dO row, dK reaches {cuts['dk']:.3f} and dV {cuts['dv']:.3f} at "
        f"the last key")
    if min(cuts.values()) <= 1:
        raise AssertionError(f"the {label} tolerance misses a dropped term: "
                             f"{cuts}")
    del dk_cut, dv_cut, tol
    torch.cuda.empty_cache()
    _flash_check(fa, q3, k3, v3, do, dict(kw, causal=False),
                 f"{tag}non-causal, group {hq // hkv}")
    if groups:
        g1 = _flash_inputs(dev, gen, b, s, hq, hq, d)
        _flash_check(fa, *g1, dict(kw, n_rep=1), "causal, group 1")
        del g1
        # the MoE step's own shape (phase 10: Mixtral heads, [4, 2048])
        g4 = _flash_inputs(dev, gen, 4, s, 32, 8, d)
        _flash_check(fa, *g4, dict(kw, n_rep=4), "causal, group 4 (MoE)")
        del g4
    gc.collect()
    torch.cuda.empty_cache()

    del want
    return _flash_times(fa, q3, k3, v3, do, ro, rlse, kw, err, label,
                        shape)


def _flash_times(fa, q3, k3, v3, do, ro, rlse, kw, err, label, shape):
    """Times of B2 and B3 on one causal input of ``shape`` (B, S, Hq, Hkv,
    D) (kernels over runs of 10 calls and one call per timing, their
    device ms per launch by torch.profiler, the plain versions, SDPA, the
    bound); returns the kernels line's rows."""
    b, s, hq, _, d = shape
    # times at the training shapes (each input 34-67 MB: beyond L2 between
    # launches only in part), per call over runs of 10 back-to-back calls,
    # so the host's launch path (tensor maps, allocation) overlaps the card;
    # and one call per timing, as the earlier mma.sync kernels were timed,
    # which adds that path
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
    log(f"{label}: device ms per launch by kernel (torch.profiler over five "
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
        log(f"{label} {name}: kernel {ms:.4f} ms (one call per timing: "
            f"{one:.4f})  plain {plain:.4f} ms  SDPA {lib:.4f} ms (one call "
            f"per timing: {lib_one:.4f}); bound {bound:.4f} ms ({flops:.4g} "
            f"flops at 989 TFLOP/s: {ops_ms:.4f} ms; {nbytes} bytes at 3.35 "
            f"TB/s: {bytes_ms:.4f} ms) -> {100 * bound / ms:.1f}% of bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        rows[name] = {"max_abs_err": e, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound,
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                      "library_ms": lib}
    log(f"{label}: SDPA's own max err vs the plain forward {lib_err:.2e} "
        f"(its bf16 output rounding)")
    return rows


# the fp32 flash kernels by mangled name (csrc/flash_attention_ffma.cu)
FFMA_FLASH_KERNELS = {
    "ffma_fwd_kernelILi128E": "fwd d128", "ffma_fwd_kernelILi256E": "fwd d256",
    "ffma_delta_kernelILi128E": "delta d128",
    "ffma_delta_kernelILi256E": "delta d256",
    "ffma_bwd_kernelILi128ELb1E": "dK/dV d128",
    "ffma_bwd_kernelILi128ELb0E": "dQ d128",
    "ffma_bwd_kernelILi256ELb1E": "dK/dV d256",
    "ffma_bwd_kernelILi256ELb0E": "dQ d256",
    "ffma_group_sum_kernel": "group sum"}
FFMA_SASS_OPS = ("FFMA", "LDS", "LDS.128", "SHFL", "HMMA", "HGMMA", "STL", "LDL")
# the first FFMA backward and forward (64 x 32 tiles, 4-byte loads), which
# the ones in csrc/flash_attention_ffma.cu replaced: ms per call at phase
# 6's shape (q3 [128, 2048, D], causal; NVIDIA H100 80GB HBM3, 700 W)
FFMA_BWD_FIRST_MS = {"fp32_d128": 29.469, "fp32_d256": 68.830}
FFMA_FWD_FIRST_MS = {"fp32_d128": 5.169, "fp32_d256": 17.474}


def ptxas_report(build_log):
    """{mangled kernel name: (registers, stack bytes, spill store bytes,
    spill load bytes)} from nvcc's ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [0, 0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur][1:] = [int(x) for x in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_flash_ffma_sass(library, build_log):
    """The fp32 flash kernels as compiled (csrc/flash_attention_ffma.cu):
    per kernel, ptxas's registers, stack and spills, and the SASS counts of
    FFMA, shared-memory loads (LDS, of them LDS.128), shuffles and local
    memory; no tensor-core instruction (HMMA, HGMMA: no TF32 or bf16
    product).  Fails on a spill, or on a forward or backward kernel with
    no FFMA or with a tensor-core instruction."""
    report = ptxas_report(build_log)
    counts = sass_counts(library, tuple(FFMA_FLASH_KERNELS), FFMA_SASS_OPS)
    for key, label in FFMA_FLASH_KERNELS.items():
        regs = next((v for k, v in report.items() if key in k), None)
        c = counts.get(key, dict.fromkeys(FFMA_SASS_OPS, 0))
        ptx = ("ptxas report not available (library built earlier)"
               if regs is None else
               f"{regs[0]} registers, {regs[1]} bytes stack, spills "
               f"{regs[2]} bytes stored and {regs[3]} loaded")
        log(f"sass flash_attention_ffma {label}: {ptx}; " + ", ".join(
            f"{op} {c[op]}" for op in FFMA_SASS_OPS))
        if regs is not None and (regs[2] or regs[3]):
            raise AssertionError(f"{label}: ptxas spilled registers: {regs}")
        if c["HMMA"] or c["HGMMA"] or (("bwd" in key or "fwd" in key)
                                       and not c["FFMA"]):
            raise AssertionError(f"the {label} kernel has no FFMA, or a "
                                 f"tensor-core product, in its SASS: {c}")
    return counts


def _ffma_bwd_device_ms(fa, q3, k3, v3, ro, rlse, do, kw, calls=3):
    """Device ms per launch of the fp32 backward's kernels (delta, dK/dV,
    the group sum, dQ) by torch.profiler over ``calls`` backward calls."""
    by_kernel, _ = device_ms_by_kernel(lambda: [fa.flash_attention_bwd(
        q3, k3, v3, ro, rlse, do, **kw) for _ in range(calls)])
    names = {"ffma_delta_kernel": "delta", "ffma_group_sum_kernel": "group sum",
             "ffma_bwd_kernel": "dQ", "ffma_bwd_kernel+": "dK/dV"}
    per = {}
    for name, (ms, n) in by_kernel.items():
        m = re.search(r"(ffma_\w+_kernel)(<\d+, (true|false)>)?", name)
        if m:
            key = names[m.group(1) + ("+" if m.group(3) == "true" else "")]
            t, c = per.get(key, (0.0, 0))
            per[key] = (t + ms, c + n)
    return {k: (ms / n, n) for k, (ms, n) in per.items()}


def _ffma_fwd_device_ms(fa, q3, k3, v3, kw, calls=3):
    """(device ms per launch, launches seen) of the fp32 forward kernel by
    torch.profiler over ``calls`` forward calls; (None, 0) if it saw none."""
    by_kernel, _ = device_ms_by_kernel(lambda: [fa.flash_attention_fwd(
        q3, k3, v3, **kw) for _ in range(calls)])
    seen = [(ms, n) for name, (ms, n) in by_kernel.items()
            if "ffma_fwd_kernel" in name]
    n = sum(c for _, c in seen)
    return (sum(ms for ms, _ in seen) / n if n else None), n


def phase_flash_ffma(fa, dev, b=8, s=2048, hq=16, hkv=8, reps=2, bwd_reps=10):
    """Phase 6 (ROADMAP C1): the FFMA flash kernels (csrc/flash_attention_
    ffma.cu) at [b, s, hq, hkv, D] for each instantiation -- fp32 at D 128
    and 256 -- causal and not, forward and backward, each held to its
    plain version by ``kernel_tolerance`` (its fp32 form), with the
    dropped-key controls at the causal shape; then, causal, the kernels'
    ms, the plain versions', SDPA's on the same inputs, and the bound
    (operations at the 67 TFLOP/s FFMA peak; bytes at 3.35 TB/s), the
    backward and SDPA's over ``bwd_reps`` timings, beside the first FFMA
    kernels' (``FFMA_FWD_FIRST_MS``, ``FFMA_BWD_FIRST_MS``), and the
    device ms per launch of the forward and of the backward's kernels.
    Returns {"fwd_<name>": row, "bwd_<name>": row}."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = {}
    for (dtype, d), name in fa.INSTANTIATIONS.items():
        if dtype != torch.float32:
            continue  # the wgmma pairs: phase 6 above
        q3, k3, v3, do = _flash_inputs(dev, gen, b, s, hq, hkv, d, dtype)
        kw = dict(scale=d ** -0.5, causal=True, n_rep=hq // hkv)
        err, want, tol = _flash_check(fa, q3, k3, v3, do, kw,
                                      f"{name} causal")
        ro, rlse = want["o"], want["lse"]

        def cut(key, got):
            return ((got[:, -1].float() - want[key][:, -1].float()).abs()
                    / tol[key][:, -1]).max().item()

        def zero_last(t):
            t = t.clone()
            t[:, -1] = 0
            return t

        cuts = {"o": cut("o", fa.flash_attention_fwd(q3, k3, zero_last(v3),
                                                     **kw)[0]),
                "dq": cut("dq", fa.flash_attention_bwd(
                    q3, zero_last(k3), v3, ro, rlse, do, **kw)[0])}
        _, dk_cut, dv_cut = fa.flash_attention_bwd(q3, k3, v3, ro, rlse,
                                                   zero_last(do), **kw)
        cuts.update(dk=cut("dk", dk_cut), dv=cut("dv", dv_cut))
        log(f"flash {name}: without the last of {s} keys O reaches "
            f"{cuts['o']:.3f} of its tolerance at the last row and dQ "
            f"{cuts['dq']:.3f}; without the last dO row dK {cuts['dk']:.3f} "
            f"and dV {cuts['dv']:.3f} at the last key")
        if min(cuts.values()) <= 1:
            raise AssertionError(f"the {name} tolerance misses a dropped "
                                 f"term: {cuts}")
        del dk_cut, dv_cut, tol
        torch.cuda.empty_cache()
        _flash_check(fa, q3, k3, v3, do, dict(kw, causal=False),
                     f"{name} non-causal")
        torch.cuda.empty_cache()

        def fwd(_):
            return fa.flash_attention_fwd(q3, k3, v3, **kw)

        def bwd(_):
            return fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)

        ms = {"fwd": time_ms(fwd, reps=reps), "bwd": time_ms(bwd, reps=bwd_reps)}
        nc = dict(kw, causal=False)
        ms_nc = (time_ms(lambda _: fa.flash_attention_fwd(q3, k3, v3, **nc),
                         reps=reps),
                 time_ms(lambda _: fa.flash_attention_bwd(
                     q3, k3, v3, ro, rlse, do, **nc), reps=reps))
        plain = {"fwd": time_ms(lambda _: fa.flash_attention_fwd_reference(
                     q3, k3, v3, **kw), reps=reps),
                 "bwd": time_ms(lambda _: fa.flash_attention_bwd_reference(
                     q3, k3, v3, ro, rlse, do, **kw), reps=reps)}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.enable_grad():
            q4, k4, v4 = (t.view(b, -1, s, d).detach().requires_grad_()
                          for t in (q3, k3, v3))
            lib = {"fwd": time_ms(lambda _: sdpa(q4, k4, v4, is_causal=True,
                                                 enable_gqa=True), reps=reps)}
            out4 = sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
            do4 = do.view(b, hq, s, d)
            lib["bwd"] = time_ms(lambda _: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True), reps=bwd_reps)
        del out4, q4, k4, v4
        per = _ffma_bwd_device_ms(fa, q3, k3, v3, ro, rlse, do, kw)
        log(f"flash {name} bwd: device ms per launch by kernel (torch.profiler "
            f"over three calls): " + (", ".join(
                f"{k} {t:.4f} ({n} seen)" for k, (t, n) in per.items())
                or "not measured: the profiler saw none"))
        fwd_dev, fwd_seen = _ffma_fwd_device_ms(fa, q3, k3, v3, kw)
        log(f"flash {name} fwd: device ms per launch (torch.profiler over "
            f"three calls): " + (f"{fwd_dev:.4f} ({fwd_seen} seen)"
                                 if fwd_seen else
                                 "not measured: the profiler saw none"))
        pairs = s * (s + 1) // 2
        flops = {"fwd": 4 * b * hq * d * pairs, "bwd": 10 * b * hq * d * pairs}
        size = q3.element_size()
        qb, kb = q3.numel() * size, k3.numel() * size
        nbytes = {"fwd": 2 * qb + 2 * kb + b * hq * s * 4,
                  "bwd": 3 * qb + 2 * kb + b * hq * s * 4 + qb + 2 * kb}
        peak = FP32_FLOPS_PER_S
        errs = {"fwd": err["o"], "bwd": max(err["dq"], err["dk"], err["dv"])}
        for leg in ("fwd", "bwd"):
            ops_ms = flops[leg] / peak * 1e3
            bytes_ms = nbytes[leg] / HBM_BYTES_PER_S * 1e3
            bound = max(ops_ms, bytes_ms)
            log(f"flash {name} {leg}: kernel {ms[leg]:.3f} ms  plain "
                f"{plain[leg]:.3f} ms  SDPA {lib[leg]:.3f} ms; bound "
                f"{bound:.4f} ms ({flops[leg]:.4g} flops at "
                f"{peak / 1e12:g} TFLOP/s: {ops_ms:.4f} ms; {nbytes[leg]} "
                f"bytes at 3.35 TB/s: {bytes_ms:.4f} ms) -> "
                f"{100 * bound / ms[leg]:.1f}% of bound, "
                f"{flops[leg] / ms[leg] / 1e9:.1f} TFLOP/s")
            old = (FFMA_BWD_FIRST_MS if leg == "bwd" else FFMA_FWD_FIRST_MS)[name]
            what = "backward" if leg == "bwd" else "forward"
            log(f"flash {name} {leg}: {ms[leg]:.3f} ms against the first "
                f"FFMA {what}'s {old:.3f} ({old / ms[leg]:.2f}x) and "
                f"SDPA's {lib[leg]:.3f} in this call "
                f"({lib[leg] / ms[leg]:.2f}x)")
            rows[f"{leg}_{name}"] = {
                "max_abs_err": errs[leg], "ms": ms[leg],
                "plain_ms": plain[leg], "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib[leg]}
        log(f"flash {name} non-causal: kernel fwd {ms_nc[0]:.3f} ms, bwd "
            f"{ms_nc[1]:.3f} ms")
        del q3, k3, v3, do, want, ro, rlse
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def fp32_step_configs(llama):
    """Phase 7f's configs, at Llama-3-8B's width and 2 layers: the preset
    at fp32 compute (head_dim 128), and its head_dim-256 variant (16 q
    heads over 8 kv heads) at fp32 and at bf16 compute."""
    cut = dict(n_layers=2, param_dtype=torch.float32)
    return {
        "fp32_d128": llama.LlamaConfig.llama3_8b(
            compute_dtype=torch.float32, **cut),
        "fp32_d256": llama.LlamaConfig.llama3_8b(
            compute_dtype=torch.float32, n_heads=16, n_kv_heads=8, **cut),
        "bf16_d256": llama.LlamaConfig.llama3_8b(
            compute_dtype=torch.bfloat16, n_heads=16, n_kv_heads=8, **cut),
    }


# phase 7f's head_dim-256 bf16 step on the FFMA kernels it replaced (PR 16's
# run, NVIDIA H100 80GB HBM3, 700 W): ms per step at [1, 2048]
D256_FFMA_STEP_MS = 149.1


def phase_train_fp32(fa, llama, parallel, card_line, dev, b=1, s=2048,
                     steps=3, configs=None):
    """Phase 7f (ROADMAP C1): the training step on the flash instantiations
    beside B2/B3 -- the FFMA kernels at fp32 compute, the head_dim-256
    wgmma pair at bf16.  Per config of ``fp32_step_configs``:
    ``make_train_step``, three steps on one [b, s] batch: finite losses
    that fall, each step's flash launches of its instantiation (forward
    and recompute, backward: 2 and 1 per layer), the step's ms; for the
    preset at fp32 compute, the step's loss and gradients through the
    kernels against the plain attention's within phase 8's floor check;
    for the head_dim-256 bf16 config, the step's ms beside the FFMA
    pair's and one step profiled (the flash kernels' share).  Returns
    {instantiation: (forward, backward) launches of these runs}."""
    launches = {}
    for name, cfg in (configs or fp32_step_configs(llama)).items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        init_fn, step_fn = parallel.make_train_step(cfg, device=dev)
        state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
        tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(SEED + 1))
        built = time.perf_counter() - t0
        before = list(fa.launches[name])
        metrics, step_s = timed_steps(step_fn, state, tokens, steps)
        got = (fa.launches[name][0] - before[0],
               fa.launches[name][1] - before[1])
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        want = (2 * cfg.n_layers * steps, cfg.n_layers * steps)
        log(f"train {name} [{card_line}]: Llama-3-8B width "
            f"({cfg.dim}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
            f"{cfg.head_dim}), {cfg.n_layers} layers, {cfg.compute_dtype} "
            f"products, {cfg.num_params / 1e9:.3f} B params, built in "
            f"{built:.1f} s; {steps} steps on [{b}, {s}]: "
            f"{step_s * 1e3:.1f} ms per step, losses "
            f"{[round(x, 5) for x in losses]}, grad norms "
            f"{[round(x, 5) for x in norms]}; {got[0]} forward and {got[1]} "
            f"backward {name} launches (want {want[0]} and {want[1]}); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
        if dev.type == "cuda" and got != want:
            raise AssertionError(f"train {name}: the step did not run the "
                                 f"{name} kernels on every layer")
        if not all(math.isfinite(x) for x in losses + norms) or not (
                losses[-1] < losses[0]):
            raise AssertionError(f"train {name}: losses {losses}")
        launches[name] = got
        if name == "fp32_d128":
            phase_train_ab(llama, parallel, cfg, state, tokens)
        if name == "bf16_d256":
            log(f"train {name} [{card_line}]: {step_s * 1e3:.1f} ms per step "
                f"on the wgmma pair; {D256_FFMA_STEP_MS} on the FFMA pair it "
                f"replaced (PR 16's run)")
            if dev.type == "cuda":
                profile_train_step(step_fn, state, tokens, card_line)
        del state, step_fn, init_fn
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_telemetry_cost(llama, llm, card_line, n=200_000):
    """Device telemetry's cost on this host: ``EngineTelemetry.note_step``
    per call (the reference's budget: under 10 us), and the disabled path
    (``device_telemetry_enabled = false``): an engine labelled for a
    deployment attaches no recorder, and its steps book no telemetry
    point.  The engine is a tiny one on the host (the cost is host time)."""
    from ray_tpu_torch._private import device_telemetry as dt
    from ray_tpu_torch._private import runtime_metrics
    from ray_tpu_torch._private.config import global_config

    tel = dt.EngineTelemetry("cost", weights_bytes=1, kv_pool_bytes=1)
    t0 = time.perf_counter()
    for i in range(n):
        tel.note_step(active_slots=3, max_slots=8, free_blocks=20,
                      total_blocks=31, pending=1, prefill_spent=64,
                      prefill_budget=256, busy_s=1e-3,
                      now=time.monotonic())
    per_us = (time.perf_counter() - t0) / n * 1e6
    cfg = global_config()
    saved = cfg.device_telemetry_enabled
    cfg.device_telemetry_enabled = False
    try:
        before = json.dumps(runtime_metrics.device_telemetry_snapshot(),
                            sort_keys=True)
        eng = llm.make_engine(llm.LLMConfig(
            model_config=llama.LlamaConfig.tiny(), max_batch_size=2,
            max_seq_len=64, block_size=8, prefill_chunk=16, decode_chunk=4),
            device="cpu")
        eng.slo_label = "telemetry-off"
        eng.generate([[1, 2, 3, 4, 5]], llm.GenerationConfig(max_new_tokens=8))
        after = json.dumps(runtime_metrics.device_telemetry_snapshot(),
                           sort_keys=True)
    finally:
        cfg.device_telemetry_enabled = saved
    log(f"telemetry [{card_line}]: note_step {per_us:.3f} us per call over "
        f"{n} calls on this host (budget < 10 us); disabled: the labelled "
        f"engine attached {eng._telemetry} and its steps booked "
        f"{'nothing' if before == after else 'a point'}")
    if per_us >= 10 or eng._telemetry is not None or before != after:
        raise AssertionError("device telemetry: note_step over budget or the "
                             "disabled path booked something")
    return per_us


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


PROFILE_HEAD = 8192  # tiny launches ahead of a profiled call, inside the window


def device_ms_by_kernel(fn):
    """torch.profiler over one call of ``fn``: ({kernel name: (device ms,
    launches)}, wall ms of the call), from the profiler's raw device events
    that start inside the call's span.  Once a process has profiled CUDA
    graph replays, every later window loses its first device events, more
    of them as the run goes on: late in this script windows of a few
    hundred launches came back empty.  So each window opens with
    PROFILE_HEAD tiny launches ahead of the call, and a line says how many
    of those were lost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    head = torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_HEAD):
            head.add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("chip_smoke_window"):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.profiler.kineto_results.events()
    span = next(((e.start_ns(), e.end_ns()) for e in events
                 if e.name() == "chip_smoke_window"
                 and e.device_type() == DeviceType.CPU), None)
    by_name, before = {}, 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() == "chip_smoke_window":
            continue
        if span and e.start_ns() < span[0]:
            before += 1
        elif span is None or e.start_ns() <= span[1]:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    if before < PROFILE_HEAD:
        log(f"profiler: {PROFILE_HEAD - before} of the {PROFILE_HEAD} head "
            f"launches' device events were lost"
            + ("" if by_name else "; none of the call's was seen"))
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
                "NCCL collectives" if "nccl" in low else
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


# -- phases 7m and 7m (b), and --train-cards: sharded training ---------------

# phase 7m (b): (name, mesh axes, make_train_step keywords), two ranks
# The meshes that shard the params run the int8 codec over their shards
# (each codes as the JAX codec codes the logical leaf): every number the
# checks read -- the loss, the grad norm (before the codec), the norm
# leaves' moments (under min_bytes: never coded) -- is the uncompressed
# step's, so the codec costs these meshes no check.
TRAIN_MESHES = (
    ("fsdp2-int8", dict(fsdp=2), dict(grad_compression="int8")),
    ("data2", dict(data=2), {}),
    ("tensor2-int8", dict(tensor=2), dict(grad_compression="int8")),
    ("context2", dict(context=2), dict(context_parallel=True)),
    ("pipeline2-int8", dict(pipeline=2),
     dict(pipeline_microbatches=2, grad_compression="int8")),
    ("data2-overlap", dict(data=2), dict(overlap_grad_sync=True)),
    # the sync check's control: data=2 with its gradient sums in bf16
    ("data2-bf16sync", dict(data=2), {}),
)
# phase 10m (b): (name, mesh axes, MoEConfig fields, make_train_step
# keywords), two ranks of the one card at Mixtral-8x7B's width cut to one
# layer; each held to the world-1 step of its dispatch
MOE_MESHES = (
    ("expert2-dense", dict(expert=2), dict(dispatch="dense"), {}),
    ("expert2-ragged", dict(expert=2), dict(dispatch="ragged"), {}),
    ("expert2-int8", dict(expert=2), dict(dispatch="dense"),
     dict(grad_compression="int8")),
)
NUDGE_FLOOR = 2.0 ** -8  # each bf16 sum's and attention output's nudge: the floor
# the sync check: the norm leaves' synced gradients within this relative
# distance of the fp32 sum of the ranks' own (2**8 above an fp32 rounding,
# 2**7 below a bf16 one)
SYNC_TOL = 2.0 ** -16
NUDGE_CONTROL = 2.0 ** -4  # the last layer's weights: the first control
MESH_NOISE_DRAWS = 8  # the mesh floor: the RMS over this many nudged steps
# the leaves whose gradients the mesh check compares (their first moments
# after one step): fp32 sums over every token, so a sync in bf16 shows
NORM_LEAVES = ("attn_norm", "mlp_norm", "final_norm")
# B2/B3's per-rank shapes in 7m (b) at Llama-3-8B's heads, [4, 2048]:
# tensor = 2 halves the heads; the batch axes (and pipeline=2's two
# microbatches) halve the batch; context=2 runs ring attention instead;
# "ep2" is 10m (b)'s MoE rank (Mixtral's heads, the batch over expert=2)
RANK_SHAPES = {"tp2": (4, 2048, 16, 4, 128), "dp2": (2, 2048, 32, 8, 128),
               "ep2": (2, 2048, 32, 8, 128)}
MESH_SHAPE = {"tensor2-int8": "tp2", "fsdp2-int8": "dp2", "data2": "dp2",
              "pipeline2-int8": "dp2", "data2-overlap": "dp2",
              "expert2-dense": "ep2", "expert2-ragged": "ep2",
              "expert2-int8": "ep2"}
# B4/B5 at 10m (b)'s expert rank: expert=2 holds 4 of Mixtral's 8
# experts and takes its expert group's 2 x 4096 tokens' pairs (the other
# experts' pairs past its last group)
EP_RANK = {"experts": 4, "tokens": 8192}


def mesh_cut_config(llama, n_layers=2):
    """Llama-3-8B's width (Meta's config: vocab 128256, dim 4096, 32/8
    heads, ffn 14336) cut to ``n_layers`` of 32 (phase 7f's cut); fp32
    params and moments, bf16 products."""
    return llama.LlamaConfig.llama3_8b(n_layers=n_layers, max_seq_len=2048)


def _train_batch(cfg, b, s, dev):
    """The seed's [b, s] token batch, drawn on ``dev`` (every rank draws
    the same one: the step takes the global batch)."""
    return torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED + 1))


def _bits_checksum(tensors) -> int:
    """An exact checksum of tensors' bit patterns (each element read as an
    integer of its width and summed in int64)."""
    ints = {4: torch.int32, 2: torch.int16}
    return sum(int(t.detach().contiguous().view(ints[t.element_size()]).sum(
        dtype=torch.int64)) for t in tensors)


def _nudge(llama, params, layers, eps):
    """Each matrix weight of ``layers`` times (1 + eps * a random sign)."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(SEED + 7)
    for name in llama._MATMUL_WEIGHTS:
        for li in layers:
            w = params["layers"][name][li]
            sign = torch.randint(0, 2, w.shape, generator=gen,
                                 device=w.device, dtype=w.dtype) * 2 - 1
            w.mul_(1 + eps * sign)


def _nudged(t, eps, gen):
    """``t`` times (1 + eps * a random sign per element), computed in fp32
    and rounded to t's dtype, in place."""
    sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device,
                         dtype=torch.float32) * 2 - 1
    return t.copy_(t.float() * (1 + eps * sign))


class _NudgeGroup:
    """A one-member stand-in for a mesh axis's group that runs the world-1
    step through the mesh path and nudges every sum a collective would
    compute in bf16 (the tensor axis's forward partial sums and its
    backward activation-gradient sums) by a random +-eps: the rounding a
    sum over ranks adds.  Sums in fp32 (the gradient reduce-scatters and
    all-reduces, the loss) stay exact, as do gathers, permutations and
    all-to-alls, which move values."""

    rank, size = 0, 1

    def __init__(self, eps, gen):
        self.eps, self.gen = eps, gen

    def _sum(self, t):
        return t if t.dtype == torch.float32 else _nudged(t, self.eps,
                                                          self.gen)

    def allreduce_(self, t):
        return self._sum(t)

    def all_gather(self, t, dim=-1):
        return t.clone()

    def reduce_scatter(self, t, dim=-1):
        return self._sum(t.clone())

    def permute(self, t, dst, src):
        return t.clone()

    def all_to_all(self, t):
        return t.clone()


class _Bf16Sync:
    """The sync check's control: a mesh group whose fp32 sums run in bf16
    (each member's tensor rounded to bf16, summed in bf16, widened back in
    place), as a gradient sync in bf16 would; everything else is the
    wrapped group's."""

    def __init__(self, group):
        self._g = group

    def __getattr__(self, name):
        return getattr(self._g, name)

    def allreduce_async_(self, t):
        if t.dtype != torch.float32:
            return self._g.allreduce_async_(t)
        low = t.to(torch.bfloat16)
        return _Widened(self._g.allreduce_async_(low), t, low)

    def allreduce_(self, t):
        self.allreduce_async_(t).wait()
        return t

    def reduce_scatter(self, t, dim=-1):
        if t.dtype != torch.float32:
            return self._g.reduce_scatter(t, dim)
        return self._g.reduce_scatter(t.to(torch.bfloat16), dim).float()


class _Widened:
    def __init__(self, work, t, low):
        self.work, self.t, self.low = work, t, low

    def wait(self):
        self.work.wait()
        self.t.copy_(self.low)
        return True


def _norm_moments(state) -> dict:
    """{leaf: its first moment (an fp32 numpy array: a rank process puts it
    on a queue)} for NORM_LEAVES: after one AdamW step from zeros, (1 - b1)
    x the synced gradient."""
    from ray_tpu_torch.parallel.optim import find_adam_state

    mu = find_adam_state(state.opt_state).mu
    return {k: (mu[k] if k == "final_norm" else mu["layers"][k]).float().cpu()
            .numpy() for k in NORM_LEAVES}


def _norms_vector(ranks) -> torch.Tensor:
    """The whole model's NORM_LEAVES moments from the ranks' results: the
    layer leaves' stages (a pipeline axis shards them) in stage order."""
    by_stage = {}
    for r in ranks:
        by_stage.setdefault(r["stage"], r["norm_mu"])
    parts = [by_stage[k] for k in sorted(by_stage)]
    return torch.from_numpy(np.concatenate(
        [np.concatenate([p[k] for p in parts]).ravel()
         for k in NORM_LEAVES[:2]] + [parts[-1]["final_norm"]]))


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).norm() / ref.norm())


def _world1_step(llama, parallel, cfg, b, s, dev, nudge=None, noise=None):
    """(loss, grad_norm, NORM_LEAVES' moments as one vector) of one world-1
    step from the seed's weights, the state freed after.  ``nudge`` =
    (layers, eps): those layers' weights nudged first (the control).
    ``noise`` = a seed: the step runs the mesh path over a one-rank mesh of
    ``_NudgeGroup``s, every attention output nudged too (the floor)."""
    mesh, mha = None, llama.multi_head_attention
    if noise is not None:
        gen = torch.Generator(device=dev).manual_seed(noise)
        group = _NudgeGroup(NUDGE_FLOOR, gen)
        mesh = parallel.mesh.Mesh({}, device=dev, groups={
            (a if len(a) > 1 else a[0]): group
            for a in parallel.mesh.GROUP_KEYS if a != ("pipeline",)})
        llama.multi_head_attention = lambda *a, **k: _nudged(
            mha(*a, **k), NUDGE_FLOOR, gen)
    try:
        init_fn, step_fn = parallel.make_train_step(cfg, mesh, device=dev)
        state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
        if nudge is not None:
            _nudge(llama, state.params, *nudge)
        state, m = step_fn(state, _train_batch(cfg, b, s, dev))
        out = (float(m["loss"]), float(m["grad_norm"]),
               _norms_vector([{"stage": 0, "norm_mu": _norm_moments(state)}]))
    finally:
        llama.multi_head_attention = mha
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_ratio(got, ref, tol) -> float:
    """How far a step's (loss, grad_norm, norm moments) lie from the
    world-1 step's, as the largest share of its tolerance."""
    return max(abs(got[0] - ref[0]) / tol[0], abs(got[1] - ref[1]) / tol[1],
               _rel(got[2], ref[2]) / tol[2])


def mesh_tolerance(llama, parallel, cfg, b, s, dev, label, card_line):
    """The world-1 step's (loss, grad_norm, norm moments) and the floor
    check's tolerance for a mesh's: FLOOR_TIMES x the RMS over
    MESH_NOISE_DRAWS draws of how far they move (the moments by their
    relative distance) when every bf16 sum a mesh's collectives would
    compute and every attention output is nudged by a random +-2**-8 (the
    roundings a tensor axis's other summation order and ring attention's
    other algorithm add; the fp32 sums stay exact); a control (the last
    layer's weights nudged by +-2**-4) must break it.  A sync in bf16 is
    not this check's to see (each rank's own bf16 products move the
    gradients as much): ``sync_ratio`` holds it."""
    t0 = time.perf_counter()
    ref = _world1_step(llama, parallel, cfg, b, s, dev)
    draws = [_world1_step(llama, parallel, cfg, b, s, dev, noise=SEED + 10 + i)
             for i in range(MESH_NOISE_DRAWS)]
    moved = [(d[0] - ref[0], d[1] - ref[1], _rel(d[2], ref[2]))
             for d in draws]
    tol = [max(FLOOR_TIMES * math.sqrt(statistics.mean(m[k] ** 2
                                                       for m in moved)), 1e-12)
           for k in range(3)]
    ctrl = _world1_step(llama, parallel, cfg, b, s, dev,
                        ((cfg.n_layers - 1,), NUDGE_CONTROL))
    ratio = mesh_ratio(ctrl, ref, tol)
    log(f"{label} [{card_line}]: world-1 step loss {ref[0]:.6f}, grad_norm "
        f"{ref[1]:.6f}; tolerance ({FLOOR_TIMES} x the RMS of "
        f"{MESH_NOISE_DRAWS} draws, every bf16 collective sum and attention "
        f"output +-2**-8, fp32 sums exact): loss {tol[0]:.3e}, grad_norm "
        f"{tol[1]:.3e}, norm moments {tol[2]:.3e} relative; the draws at "
        f"most {max(mesh_ratio(d, ref, tol) for d in draws):.3f} of it; the "
        f"control (last layer +-2**-4) {ratio:.2f} x it; "
        f"{time.perf_counter() - t0:.1f} s")
    if ratio <= 1:
        raise AssertionError(f"{label}: the control passed the floor check "
                             f"({ratio:.3f})")
    return ref, tol


def _sync_axes(leaf: str, kw: dict, batch: tuple) -> tuple:
    """The mesh axes a norm leaf's gradient is summed over by the step:
    the ``batch`` axes, "context" under ``context_parallel``, and
    "pipeline" for the final norm (the layers' norms are sharded over
    it)."""
    return (batch + (("context",) if kw.get("context_parallel") else ())
            + (("pipeline",) if leaf == "final_norm" else ()))


def sync_ratio(ranks, axes: dict, kw: dict,
               batch: tuple = ("data", "fsdp")) -> float:
    """The sync check: every rank's NORM_LEAVES first moments after one
    step against (1 - b1) x the fp64 sum of the gradients the ranks of
    each leaf's sum group computed themselves (captured before the sync),
    as the largest relative distance over the ranks, in units of
    SYNC_TOL."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, group_members

    shape = MeshSpec(**axes).shape
    by_rank = {r["rank"]: r for r in ranks}
    worst = 0.0
    for r in ranks:
        num = den = 0.0
        for k in NORM_LEAVES:
            members = group_members(shape, r["rank"], _sync_axes(k, kw,
                                                                   batch))
            want = (1 - 0.9) * sum(by_rank[m]["partial"][k].astype(np.float64)
                                   for m in members)
            num += float(((r["norm_mu"][k] - want) ** 2).sum())
            den += float((want ** 2).sum())
        worst = max(worst, math.sqrt(num / den))
    return worst / SYNC_TOL


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_device(index: int) -> torch.device:
    """Card ``index`` (the CPU only where torch has no CUDA at all: a
    rehearsal of these phases; ``main`` refuses to run without a card)."""
    return (torch.device("cuda", index) if torch.cuda.is_available()
            else torch.device("cpu"))


P2P_ELEMS = 1 << 24  # fp32 elements a message in the p2p check: 64 MiB
P2P_LIMIT_S = 180  # a rank still in the p2p check after this exits


def _p2p_check(rank, store, dev, backend, size):
    """The point-to-point orders the program posts, across the cards:
    ``TensorGroup.exchange`` in the serving tree's order (rank ^ 1, then
    rank ^ 2, ...) and ``functional.ppermute`` rings both ways over a
    group of every rank, then two-member rings (ring attention's and the
    pipeline's handoffs at context=2 and pipeline=2) on a context=2 x
    pipeline=size/2 mesh; 64 MiB messages, past what NCCL buffers, so a
    send waits for its receive.  Each received tensor must hold its
    sender's rank.  A rank not done within P2P_LIMIT_S exits at once (a
    deadlock would otherwise hold every card until the call's limit)."""
    import ray_tpu_torch.parallel as parallel
    from ray_tpu_torch.parallel import functional as fn

    timer = threading.Timer(P2P_LIMIT_S, os._exit, args=(17,))
    timer.daemon = True
    timer.start()
    cases, meshes = [], []
    try:
        mesh = parallel.MeshSpec(tensor=size).build(
            rank=rank, store=store, name="smoke-p2p", device=dev,
            device_backend=backend)
        meshes.append(mesh)
        group, mine = mesh.group, torch.full((P2P_ELEMS,), float(rank),
                                             device=dev)
        m = 1
        while m < size:
            cases.append((f"swap ^{m}", group.exchange(mine, rank ^ m),
                          rank ^ m))
            m *= 2
        for label, perm in (("ring", fn.ring_perm(size)),
                            ("ring back", [(d, s_) for s_, d
                                           in fn.ring_perm(size)])):
            src = [s_ for s_, d in perm if d == rank][0]
            cases.append((label, fn.ppermute(mine, group, perm), src))
        if size % 2 == 0:
            two = parallel.MeshSpec(context=2, pipeline=size // 2).build(
                rank=rank, store=store, name="smoke-p2p2", device=dev,
                device_backend=backend)
            meshes.append(two)
            for axis in ("context", "pipeline"):
                g = two.axis_group(axis)
                if g is None:
                    continue
                members = parallel.mesh.group_members(two.shape, rank, (axis,))
                perm = fn.ring_perm(g.size)
                src = [s_ for s_, d in perm if d == g.rank][0]
                cases.append((f"{axis} ring of {g.size}",
                              fn.ppermute(mine, g, perm), members[src]))
        _sync(dev)
        out = [(label, bool(torch.all(got == float(src))))
               for label, got, src in cases]
        backends = sorted({g.group.last_backend for mh in meshes
                           for g in mh.groups.values() if g is not None
                           and g.group.last_backend})
    finally:
        timer.cancel()
        for mh in meshes:
            mh.destroy()
    return {"name": "p2p", "rank": rank, "cases": out, "backends": backends}


EXCHANGE_REPS = 10  # the exchange timing: calls per collective (medians)


def _exchange_check(rank, store, dev, backend, size, tokens=4096, dim=4096):
    """The MoE expert exchange over an expert group of every rank, at the
    MoE run's shape (a rank's ``tokens`` x ``dim`` bf16 activations): the
    step's equal-split ``all_to_all`` of the tokens repeated once per
    member (and of the outputs back, the same size), beside an all-gather
    of the tokens and a reduce-scatter of the outputs, which move the same
    bytes; each exact on known data, host-clock medians of EXCHANGE_REPS
    calls, synchronised."""
    import ray_tpu_torch.parallel as parallel

    mesh = parallel.MeshSpec(expert=size).build(
        rank=rank, store=store, name="smoke-exchange", device=dev,
        device_backend=backend)
    try:
        group = mesh.axis_group("expert")
        x = torch.full((tokens, dim), float(rank + 1), dtype=torch.bfloat16,
                       device=dev)
        y = torch.ones((size * tokens, dim), dtype=torch.bfloat16, device=dev)
        gathered = group.all_gather(x, 0)[::tokens, 0].float().cpu()
        ok = (bool(torch.equal(gathered, torch.arange(1, size + 1).float()))
              and bool(torch.all(group.reduce_scatter(y, 0) == size))
              and bool(torch.equal(group.all_to_all(
                  torch.arange(size, device=dev).repeat_interleave(
                      tokens)[:, None].expand(-1, dim).to(torch.bfloat16)
                  .contiguous())[::tokens, 0].float().cpu(),
                  torch.full((size,), float(rank)))))
        times = {}
        for name, fn in (("all_gather", lambda: group.all_gather(x, 0)),
                         ("reduce_scatter", lambda: group.reduce_scatter(y, 0)),
                         ("all_to_all", lambda: group.all_to_all(y))):
            ts = []
            for _ in range(EXCHANGE_REPS + 1):
                _sync(dev)
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                ts.append(time.perf_counter() - t0)
            times[name] = statistics.median(ts[1:]) * 1e3
        backends = sorted({g.group.last_backend for g in mesh.groups.values()
                           if g is not None and g.group.last_backend})
    finally:
        mesh.destroy()
    return {"name": "exchange", "rank": rank, "ok": ok, "ms": times,
            "backends": backends}


def _mesh_job(rank, store, dev, backend, job):
    """One rank's part of one mesh job: the mesh over ``store``, the
    seed's weights drawn tensor by tensor keeping this rank's shards, then
    ``steps`` steps on the global batch.  Returns the rank's numbers.  The
    job named "p2p" is ``_p2p_check``."""
    import ray_tpu_torch.parallel as parallel
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import grouped_matmul as gm

    name, axes, kw, cfg, b, s, steps, profile = job
    if name == "p2p":
        return _p2p_check(rank, store, dev, backend, math.prod(axes.values()))
    if name == "exchange":
        return _exchange_check(rank, store, dev, backend,
                               math.prod(axes.values()))
    mesh = parallel.MeshSpec(**axes).build(
        rank=rank, store=store, name=f"smoke-{name}", device=dev,
        device_backend=backend)
    if name.endswith("-bf16sync"):  # one wrapper for a group two axes share
        wrapped = {}
        for key in ("data", "fsdp", ("data", "fsdp")):
            g = mesh.groups.get(key)
            if g is not None:
                mesh.groups[key] = wrapped.setdefault(id(g), _Bf16Sync(g))
    state, hooks = None, []
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        init_fn, step_fn = parallel.make_train_step(cfg, mesh, device=dev,
                                                    **kw)
        state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
        tokens = _train_batch(cfg, b, s, dev)
        # the norm leaves' gradients as this rank's backward leaves them,
        # before the step sums them (zeros where its loss does not read one)
        partial = {}
        for k in NORM_LEAVES:
            leaf = (state.params[k] if k == "final_norm"
                    else state.params["layers"][k])
            partial[k] = np.zeros(tuple(leaf.shape), np.float32)
            leaf.requires_grad_(True)
            hooks.append(leaf.register_hook(
                lambda g, k=k: partial.__setitem__(
                    k, g.detach().float().cpu().numpy().copy())))
            leaf.requires_grad_(False)
        fa.fwd_launches = fa.bwd_launches = 0
        gm.gmm_launches = gm.tgmm_launches = 0
        losses, norms, secs = [], [], []
        for i in range(steps):
            if i == 1:
                for h in hooks:
                    h.remove()
                hooks = []
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, tokens)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        launches = (fa.fwd_launches, fa.bwd_launches)
        gmm_launches = (gm.gmm_launches, gm.tgmm_launches)
        norm_mu = _norm_moments(state)
        if profile:  # one more step on every rank, rank 0's profiled
            if rank == 0:
                profile_train_step(step_fn, state, tokens,
                                   f"{card().splitlines()[0]}; rank 0 of "
                                   f"{mesh.size}")
            else:
                step_fn(state, tokens)
            _sync(dev)
        return {"name": name, "rank": rank, "losses": losses, "norms": norms,
                "step_s": secs, "norm_mu": norm_mu, "partial": partial,
                "stage": mesh.coords["pipeline"],
                "launches": launches, "gmm_launches": gmm_launches,
                "checksum": _bits_checksum(
                    parallel.train_step.tree_leaves(state.params)),
                "backends": sorted({g.group.last_backend for g in
                                    mesh.groups.values() if g is not None
                                    and g.group.last_backend}),
                "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                             if dev.type == "cuda" else 0.0)}
    finally:
        for h in hooks:
            h.remove()
        del state
        mesh.destroy()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _mesh_rank(rank, size, port, device_index, backend, jobs, queue):
    """A spawned rank of phase 7m (b) or --train-cards: every job's
    ``_mesh_job`` in turn, each result (or the failure) put on ``queue``."""
    import datetime

    dev = _rank_device(device_index)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = torch.distributed.TCPStore(
        "127.0.0.1", port, size, False, timeout=datetime.timedelta(seconds=600))
    try:
        for job in jobs:
            queue.put(("job", rank, _mesh_job(rank, store, dev, backend, job)))
    except BaseException as e:
        queue.put(("error", rank, repr(e)))
        raise


def run_mesh_world(size, jobs, backend, devices, before=None):
    """``jobs`` on ``size`` ranks: rank 0 here on ``devices[0]``, the
    others spawned (rank r on ``devices[r]``), sharing one TCPStore;
    ``before()`` runs here first, while the spawned ranks start (they wait
    for rank 0 at the first job's groups).  Returns {job name: [each
    rank's result]}."""
    import datetime

    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, size, True, timeout=datetime.timedelta(seconds=600),
        wait_for_workers=False)
    ctx = torch.multiprocessing.get_context("spawn")
    # a Queue (its feeder thread buffers): a rank's results never wait on
    # this process, which reads them after its own jobs
    queue = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, daemon=True,
                         args=(r, size, store.port, devices[r], backend, jobs,
                               queue)) for r in range(1, size)]
    for p in procs:
        p.start()
    out = {job[0]: [None] * size for job in jobs}
    try:
        if before is not None:
            before()
        dev = _rank_device(devices[0])
        for job in jobs:
            out[job[0]][0] = _mesh_job(0, store, dev, backend, job)
        for _ in range((size - 1) * len(jobs)):
            kind, rank, got = queue.get()
            if kind == "error":
                raise AssertionError(f"rank {rank} failed: {got}")
            out[got["name"]][rank] = got
    finally:
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.terminate()
    bad = [p.exitcode for p in procs if p.exitcode not in (0, None)]
    if bad:
        raise AssertionError(f"a rank process exited {bad}")
    return out


def phase_train_mesh_world1(fa, llama, parallel, card_line, run, steps=3):
    """Phase 7m: ``make_train_step(cfg, mesh)`` at world size 1 through
    NCCL on the bf16 headline's state and batch: ``MeshSpec()`` with a
    one-rank NCCL group on every axis, so each collective of the sharded
    step runs on the card.  Three steps from a copy of the state beside
    three of phase 7's mesh-free step from another copy: losses, grad
    norms and every param's bits (a checksum) equal.  Returns the mesh
    steps' (forward, backward) flash launches."""
    from ray_tpu_torch._private.tree import tree_map

    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    cfg, tokens, opt = run["cfg"], run["tokens"], run["optimizer"]
    dev = tokens.device
    axes = [(a,) for a in parallel.mesh.MESH_AXES] + [parallel.mesh.BATCH_AXES]
    mesh = parallel.mesh.Mesh({}, device=dev, groups={
        (a if len(a) > 1 else a[0]): parallel.mesh.TensorGroup(NCCLGroup(
            1, 0, f"smoke-7m/{'+'.join(a)}", store=torch.distributed.HashStore()))
        for a in axes})
    runs = {}
    try:
        for name, m in (("mesh-free", None), ("mesh", mesh)):
            state = tree_map(torch.clone, run["state"])
            _, step_fn = parallel.make_train_step(cfg, m, device=dev,
                                                  optimizer=opt)
            fa.fwd_launches = fa.bwd_launches = 0
            metrics, step_s = timed_steps(step_fn, state, tokens, steps)
            runs[name] = ([float(x["loss"]) for x in metrics],
                          [float(x["grad_norm"]) for x in metrics],
                          _bits_checksum(parallel.train_step.tree_leaves(
                              state.params)), step_s,
                          (fa.fwd_launches, fa.bwd_launches))
            if m is not None:  # where the mesh step's extra time goes
                profile_train_step(step_fn, state, tokens, card_line)
            del state, metrics
            gc.collect()
            torch.cuda.empty_cache()
        backends = sorted({g.group.last_backend for g in mesh.groups.values()
                           if g.group.last_backend})
    finally:
        mesh.destroy()
    (l0, n0, c0, s0, _), (l1, n1, c1, s1, launches) = (runs["mesh-free"],
                                                         runs["mesh"])
    log(f"train mesh w1 [{card_line}]: {steps} steps at world size 1 over "
        f"{len(mesh.groups)} one-rank groups (backends {backends}): losses "
        f"{l1}, grad norms {n1}, params checksum {c1}; the mesh-free step "
        f"{l0}, {n0}, {c0}; {s1 * 1e3:.1f} ms per step (mesh-free "
        f"{s0 * 1e3:.1f}); {launches[0]} forward and {launches[1]} backward "
        f"flash launches")
    if backends != ["nccl"]:
        raise AssertionError(f"phase 7m: the collectives ran on {backends}")
    if (l0, n0, c0) != (l1, n1, c1):
        raise AssertionError("phase 7m: the world-1 mesh step differs from "
                             "the mesh-free step")
    if launches != (2 * cfg.n_layers * steps, cfg.n_layers * steps):
        raise AssertionError(f"phase 7m: flash launches {launches}")
    return launches


def check_mesh_run(label, card_line, ranks, axes, kw, ref, tol,
                   batch=("data", "fsdp")) -> tuple:
    """Log one mesh step's numbers beside the world-1 step's; raise if its
    ranks disagree.  ``batch``: the axes the model splits its batch over
    (MoE's add "expert").  Returns (its floor-check ratio, its sync
    ratio)."""
    c = ranks[0]
    moments = _norms_vector(ranks)
    ratio = mesh_ratio((c["losses"][0], c["norms"][0], moments), ref, tol)
    sync = sync_ratio(ranks, axes, kw, batch)
    log(f"{label} [{card_line}]: loss {c['losses'][0]:.6f}, grad_norm "
        f"{c['norms'][0]:.6f}, norm moments {_rel(moments, ref[2]):.3e} from "
        f"the world-1 step's: {ratio:.3f} of the floor check's tolerance; "
        f"the synced norm gradients {sync:.3f} x SYNC_TOL from the fp32 sum "
        f"of the ranks' own; step {[round(r['step_s'][0], 3) for r in ranks]}"
        f" s, peak {[round(r['peak_gib'], 2) for r in ranks]} GiB per rank; "
        f"flash launches {[r['launches'] for r in ranks]}"
        + (f", gmm and tgmm launches {[r['gmm_launches'] for r in ranks]}"
           if any(r["gmm_launches"] != (0, 0) for r in ranks) else "")
        + f"; backends {c['backends']}")
    if any((r["losses"], r["norms"]) != (c["losses"], c["norms"])
           for r in ranks):
        raise AssertionError(f"{label}: the ranks disagree")
    return ratio, sync


def moe_cut_config(moe, n_layers=1, **kw):
    """Mixtral-8x7B's width (the repo's preset: vocab 32000, dim 4096,
    32/8 heads, 8 experts of ffn 14336, top-2) cut to ``n_layers`` of 32;
    fp32 params and moments, bf16 products."""
    return moe.MoEConfig.mixtral_8x7b(n_layers=n_layers, max_seq_len=2048,
                                      **kw)


def _check_meshes(phase, card_line, res, meshes, refs, backend, dev,
                  launches, gmm_launches):
    """Each mesh job's ranks within the floor check of its world-1 step
    (``refs``: job name -> (ref, tol, batch axes)) and the sync check, a
    "-bf16sync" control outside the sync check, on ``backend``; flash
    launches (and grouped-matmul ones) added into ``launches`` /
    ``gmm_launches`` by rank shape.  Returns {name: (floor, sync)}."""
    ratios = {}
    for name, axes, kw in meshes:
        ranks = res[name]
        ref, tol, batch = refs[name]
        ratio, sync = check_mesh_run(f"{phase} {name}", card_line, ranks,
                                     axes, kw, ref, tol, batch)
        ratios[name] = (ratio, sync)
        control = name.endswith("-bf16sync")
        if control and sync <= 1:
            raise AssertionError(f"{phase} {name}: the control passed the "
                                 f"sync check ({sync:.3f})")
        if not control and max(ratio, sync) > 1:
            raise AssertionError(f"{phase} {name}: outside the floor check "
                                 f"({ratio:.3f}) or the sync check "
                                 f"({sync:.3f})")
        if ranks[0]["backends"] != [backend]:
            raise AssertionError(f"{phase} {name}: backends "
                                 f"{ranks[0]['backends']}")
        if name in MESH_SHAPE:
            k = MESH_SHAPE[name]
            for r in ranks:
                launches[k] = tuple(a + c for a, c in zip(launches[k],
                                                          r["launches"]))
            if dev.type == "cuda" and min(r["launches"][0] for r in ranks) == 0:
                raise AssertionError(f"{phase} {name}: no flash launch")
        if kw.get("dispatch") == "ragged":
            for r in ranks:
                gmm_launches[name] = tuple(
                    a + c for a, c in zip(gmm_launches.get(name, (0, 0)),
                                          r["gmm_launches"]))
            if dev.type == "cuda" and min(min(r["gmm_launches"])
                                          for r in ranks) == 0:
                raise AssertionError(f"{phase} {name}: a rank launched no "
                                     f"gmm or tgmm")
    return ratios


def _moe_jobs(moe, meshes, b, s, n_layers=1):
    """(mesh list for ``_check_meshes``, ``run_mesh_world`` jobs) of MoE
    mesh entries (name, axes, MoEConfig fields, step keywords); each job's
    config carries its dispatch, the mesh list's keywords too."""
    checks, jobs = [], []
    for name, axes, fields, kw in meshes:
        cfg = moe_cut_config(moe, n_layers, **fields)
        checks.append((name, axes, dict(kw, **fields)))
        jobs.append((name, axes, kw, cfg, b, s, 1, False))
    return checks, jobs


def _moe_refs(moe, llama, parallel, meshes, b, s, dev, label, card_line,
              n_layers=1):
    """{job name: (world-1 ref, tolerance, MoE batch axes)}: one floor
    check per dispatch the jobs run."""
    by_dispatch = {}
    out = {}
    for name, _, fields, _ in meshes:
        d = fields["dispatch"]
        if d not in by_dispatch:
            by_dispatch[d] = mesh_tolerance(
                llama, parallel, moe_cut_config(moe, n_layers, **fields), b,
                s, dev, f"{label} {d}", card_line)
        out[name] = by_dispatch[d] + (moe.MOE_BATCH_AXES,)
    return out


def phase_train_mesh_gloo(fa, llama, moe, parallel, card_line, dev, b=4,
                          s=2048):
    """Phases 7m (b) and 10m (b), two ranks on the one card (this process
    and a spawned one), their groups' CUDA tensors through gloo (NCCL
    refuses two ranks on one card): one step on each of TRAIN_MESHES
    (Llama-3-8B's width cut to 2 layers; the int8 codec at fsdp=2,
    tensor=2 and pipeline=2) and of MOE_MESHES (Mixtral-8x7B's width cut
    to one layer: the dense and ragged dispatches and the int8 codec over
    expert=2).  Each mesh's loss, grad norm and norm moments lie within
    the floor check of its world-1 step's (run first; ``mesh_tolerance``,
    one per model and dispatch), its gradient sums are the fp32 sums of
    the ranks' own (``sync_ratio``; the bf16-sync control must break
    that), both ranks equal, the overlapped sync's step the fused data=2
    step's bit for bit (params checksum), and the ragged MoE ranks launch
    B4 and B5.  Gloo stages every collective through the host: step
    times are recorded, not judged.  Returns ({rank shape: (forward,
    backward) flash launches on both ranks}, {ragged job: (gmm, tgmm)
    launches on both ranks})."""
    cfg = mesh_cut_config(llama)
    refs = {}

    def floors():  # while the spawned rank starts
        ref, tol = mesh_tolerance(llama, parallel, cfg, b, s, dev,
                                  "train mesh (b)", card_line)
        refs.update({name: (ref, tol, ("data", "fsdp"))
                     for name, _, _ in TRAIN_MESHES})
        refs.update(_moe_refs(moe, llama, parallel, MOE_MESHES, b, s, dev,
                              "moe mesh (b)", card_line))

    moe_checks, moe_jobs = _moe_jobs(moe, MOE_MESHES, b, s)
    jobs = [(name, axes, kw, cfg, b, s, 1, False)
            for name, axes, kw in TRAIN_MESHES] + moe_jobs
    t0 = time.perf_counter()
    res = run_mesh_world(2, jobs, "gloo", [dev.index or 0] * 2, floors)
    launches = {k: (0, 0) for k in RANK_SHAPES}
    gmm_launches = {}
    _check_meshes("phase 7m (b)", card_line, res, TRAIN_MESHES, refs, "gloo",
                  dev, launches, gmm_launches)
    _check_meshes("phase 10m (b)", card_line, res, moe_checks, refs, "gloo",
                  dev, launches, gmm_launches)
    fused, over = res["data2"], res["data2-overlap"]
    same = all((f["losses"], f["norms"], f["checksum"])
               == (o["losses"], o["norms"], o["checksum"])
               for f, o in zip(fused, over))
    log(f"train mesh (b): overlapped sync vs fused at data=2, loss, "
        f"grad_norm and params checksum equal on both ranks: {same}; "
        f"{time.perf_counter() - t0:.1f} s for the floors and the "
        f"{len(jobs)} meshes; "
        f"B4/B5 (gmm, tgmm) launches on the ragged MoE ranks {gmm_launches}")
    if not same:
        raise AssertionError("phase 7m (b): the overlapped sync's step is not "
                             "the fused sync's")
    return launches, gmm_launches


def phase_flash_rank_shapes(fa, dev, shapes=RANK_SHAPES):
    """B2 and B3 at the per-rank shapes of phase 7m (b) (causal, bf16):
    kernels vs plain versions within ``kernel_tolerance``, then times
    (kernels, plain, SDPA, bound).  Returns {shape name: rows}."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for key, shape in shapes.items():
        b, s, hq, hkv, d = shape
        kw = dict(scale=d ** -0.5, causal=True, n_rep=hq // hkv)
        q3, k3, v3, do = _flash_inputs(dev, gen, b, s, hq, hkv, d)
        err, want, _ = _flash_check(fa, q3, k3, v3, do, kw,
                                    f"rank shape {key} {shape}")
        ro, rlse = want["o"], want["lse"]
        del want
        out[key] = _flash_times(fa, q3, k3, v3, do, ro, rlse, kw, err,
                                f"flash rank {key}", shape)
        del q3, k3, v3, do, ro, rlse
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --train-cards N: the 2-layer cut's meshes across the cards (name, mesh
# axes, make_train_step keywords); the last three at even N only
def train_cards_meshes(size: int) -> list:
    meshes = [("cut", dict(fsdp=size), {}),
              ("cut-bf16sync", dict(fsdp=size), {})]  # the sync control
    if size % 2 == 0:
        half = size // 2
        meshes += [
            ("cut-tensor", dict(tensor=2, fsdp=half), {}),
            ("cut-context", dict(context=2, fsdp=half),
             dict(context_parallel=True)),
            ("cut-pipeline", dict(pipeline=2, fsdp=half),
             dict(pipeline_microbatches=2))]
    return meshes


# --train-cards N: the MoE cut's meshes (10m (b)'s: Mixtral-8x7B's width at
# one layer, the dense dispatch) across the cards, at N = 4
MOE_CARD_MESHES = (
    ("moe-expert4", dict(expert=4), dict(dispatch="dense"), {}),
    ("moe-expert2-fsdp2", dict(expert=2, fsdp=2), dict(dispatch="dense"), {}),
    ("moe-expert2-tensor2", dict(expert=2, tensor=2), dict(dispatch="dense"),
     {}),
)
MOE_CARD_LAYERS = 8  # --train-cards 4's Mixtral run: 8 of its 32 layers


def train_cards_main(size: int) -> int:
    """``--train-cards N``: the cells that need N cards, alone, through
    NCCL across the cards.  First the point-to-point orders the program
    posts (``_p2p_check``); then Llama-3-8B's width cut to 2 layers over
    ``train_cards_meshes`` (fsdp=N, and at even N tensor=2, context=2 with
    ring attention and pipeline=2 with two microbatches, fsdp the rest),
    each held to the world-1 step on card 0 by phase 7m (b)'s floor check;
    then Llama-3-8B at full depth over ``fsdp=N``, batch [4, 2048], fp32
    params and moments, bf16 products: a warm-up step and three timed
    (step ms, tokens/s, MFU against the bf16 peak, each rank's peak
    memory), then one more with rank 0's profiled.  At N = 4, MoE too:
    10m (b)'s cut (Mixtral-8x7B's width at one layer) over
    MOE_CARD_MESHES, each held to its world-1 step by the floor check, and
    the expert exchange's collectives timed; then at 8 of its 32 layers over
    expert=4 with the ragged dispatch (B4/B5 on each rank's 2 experts),
    batch [8, 2048], timed as Llama's (active MFU)."""
    import ray_tpu_torch.parallel as parallel
    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.ops import _build

    card_line = card()
    log(card_line)
    if torch.cuda.device_count() < size:
        log(f"--train-cards {size} needs {size} cards; "
            f"{torch.cuda.device_count()} visible")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    dev = _rank_device(0)
    b, s = 4, 2048
    cut = mesh_cut_config(llama)
    full = llama.LlamaConfig.llama3_8b(max_seq_len=2048)
    cuts = train_cards_meshes(size)
    moe_meshes = MOE_CARD_MESHES if size == 4 else ()
    refs = {}

    def floors():  # on card 0, while the other ranks start
        ref, tol = mesh_tolerance(llama, parallel, cut, b, s, dev,
                                  f"train cards cut over {size} cards",
                                  card_line)
        refs.update({name: (ref, tol, ("data", "fsdp"))
                     for name, _, _ in cuts})
        refs.update(_moe_refs(moe, llama, parallel, moe_meshes, b, s, dev,
                              f"train cards moe cut over {size} cards",
                              card_line))

    moe_checks, moe_jobs = _moe_jobs(moe, moe_meshes, b, s)
    moe_full = moe_cut_config(moe, MOE_CARD_LAYERS, dispatch="ragged")
    mb = 8  # the MoE run's global batch [8, 2048]
    jobs = ([("p2p", dict(tensor=size), {}, None, 0, 0, 0, False),
             ("exchange", dict(expert=size), {}, None, 0, 0, 0, False)]
            + [(name, axes, kw, cut, b, s, 1, False)
               for name, axes, kw in cuts]
            + [("full", dict(fsdp=size), {}, full, b, s, 4, True)]
            + moe_jobs
            + ([("moe-full", dict(expert=size), {}, moe_full, mb, s, 4, True)]
               if moe_meshes else []))
    t0 = time.perf_counter()
    res = run_mesh_world(size, jobs, "nccl", list(range(size)), floors)
    p2p = res["p2p"]
    failed = [(r["rank"], label) for r in p2p for label, ok in r["cases"]
              if not ok]
    log(f"train cards p2p [{card_line}]: {len(p2p[0]['cases'])} orders on "
        f"each of {size} ranks ({[c for c, _ in p2p[0]['cases']]}), "
        f"{P2P_ELEMS * 4 >> 20} MiB a message: wrong data at {failed or 'none'}; "
        f"backends {p2p[0]['backends']}")
    ex = res["exchange"]
    ex_ms = {k: statistics.mean(r["ms"][k] for r in ex) for k in ex[0]["ms"]}
    log(f"train cards exchange [{card_line}]: an expert group of {size} at "
        f"4096 x 4096 bf16 a rank, exact on every rank: "
        f"{all(r['ok'] for r in ex)}; ms (mean of the ranks' medians of "
        f"{EXCHANGE_REPS}): all_to_all {ex_ms['all_to_all']:.3f} (the "
        f"step's exchange, once each way) against all_gather "
        f"{ex_ms['all_gather']:.3f} and reduce_scatter "
        f"{ex_ms['reduce_scatter']:.3f} of the same bytes; backends "
        f"{ex[0]['backends']}")
    failed += [(r["rank"], "exchange") for r in ex if not r["ok"]]
    launches, gmm_launches = {k: (0, 0) for k in RANK_SHAPES}, {}
    ratios = _check_meshes("train cards", card_line, res, cuts, refs, "nccl",
                           dev, launches, gmm_launches)
    ratios.update(_check_meshes("train cards", card_line, res, moe_checks,
                                refs, "nccl", dev, launches, gmm_launches))
    ranks = res["full"]
    step_s = statistics.mean(ranks[0]["step_s"][1:])
    tok_s = b * s / step_s
    fpt = llama.flops_per_token(full, s)
    mfu = fpt * tok_s / (size * BF16_FLOPS_PER_S)
    log(f"train cards full [{card_line}]: Llama-3-8B ({full.num_params / 1e9:.3f}"
        f" B params) at fsdp={size}, [{b}, {s}]: losses "
        f"{ranks[0]['losses']}, grad norms {ranks[0]['norms']}; "
        f"{step_s * 1e3:.1f} ms per step (steps 2-4; step 1 "
        f"{ranks[0]['step_s'][0] * 1e3:.1f} ms), {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} of {size} x 989 TFLOP/s (flops_per_token {fpt:.4g}); "
        f"peak GiB per rank {[round(r['peak_gib'], 2) for r in ranks]}; "
        f"flash launches per rank {[r['launches'] for r in ranks]}; "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"size": size, "step_ms": step_s * 1e3, "tok_s": tok_s, "mfu": mfu,
           "peak_gib": [r["peak_gib"] for r in ranks], "cut_ratios": ratios}
    finite = ranks[0]["losses"] + ranks[0]["norms"]
    if moe_meshes:
        mranks = res["moe-full"]
        m_s = statistics.mean(mranks[0]["step_s"][1:])
        m_tok = mb * s / m_s
        m_fpt = moe.flops_per_token(moe_full, s)
        m_mfu = m_fpt * m_tok / (size * BF16_FLOPS_PER_S)
        log(f"train cards moe [{card_line}]: Mixtral-8x7B width at "
            f"{moe_full.n_layers} of 32 layers ({moe_full.num_params / 1e9:.3f}"
            f" B params, {moe_full.num_active_params / 1e9:.3f} B active) at "
            f"expert={size}, dispatch ragged, [{mb}, {s}]: losses "
            f"{mranks[0]['losses']}, grad norms {mranks[0]['norms']}; "
            f"{m_s * 1e3:.1f} ms per step (steps 2-4; step 1 "
            f"{mranks[0]['step_s'][0] * 1e3:.1f} ms), {m_tok:.1f} tokens/s, "
            f"active MFU {m_mfu:.4f} of {size} x 989 TFLOP/s (flops_per_token "
            f"{m_fpt:.4g}); peak GiB per rank "
            f"{[round(r['peak_gib'], 2) for r in mranks]}; flash launches "
            f"per rank {[r['launches'] for r in mranks]}, gmm and tgmm "
            f"{[r['gmm_launches'] for r in mranks]}")
        finite += mranks[0]["losses"] + mranks[0]["norms"]
        out["moe"] = {"step_ms": m_s * 1e3, "tok_s": m_tok, "active_mfu": m_mfu,
                      "peak_gib": [r["peak_gib"] for r in mranks],
                      "gmm_launches": [r["gmm_launches"] for r in mranks]}
        if dev.type == "cuda" and min(min(r["gmm_launches"])
                                      for r in mranks) == 0:
            raise AssertionError("--train-cards: a MoE rank launched no gmm "
                                 "or tgmm")
    bad = [(name, r["rank"]) for name in res for r in res[name]
           if r["backends"] != ["nccl"]]
    if failed or bad or not all(math.isfinite(x) for x in finite):
        raise AssertionError(f"--train-cards: p2p data wrong at {failed}, "
                             f"ranks {bad} ran off NCCL, or a loss is not "
                             f"finite")
    log(json.dumps({"train_cards": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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


def _gmm_bound(nbytes, flops, peak=BF16_FLOPS_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_grouped_matmul(gm, moe, dev, cfg=None, tokens=8192,
                         dtype=torch.bfloat16, reps=20, local=None):
    """gmm and tgmm vs their plain versions at the MoE step's shapes, with
    negative controls, repeat-call identity and times; ``dtype`` bf16
    runs the wgmma kernels, fp32 the FFMA ones (bound at the 67 TFLOP/s
    fp32 peak; the library's time is one fp32 torch.mm per group with TF32
    off where torch._grouped_mm takes no fp32).  ``local``: an expert
    rank's shape, its first ``local`` experts' groups over all the
    ``tokens``' pairs, the other experts' pairs in rows past the last
    group (bytes and flops count the grouped rows).  Returns the two
    kernels' JSON rows (times: launch-weighted means over the step's
    variants)."""
    cfg = cfg or mixtral_config(moe)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    e, dims = local or cfg.n_experts, (cfg.dim, cfg.ffn_dim)
    size = torch.tensor([], dtype=dtype).element_size()
    peak = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    tag = ((" fp32" if dtype == torch.float32 else "")
           + (f" rank of {e} experts" if local else ""))
    kname = "gmm_kernel" if dtype == torch.bfloat16 else "gmm_ffma_kernel"

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype) * std

    # group sizes from a real routing: random tokens' hidden states through
    # a router drawn as init_params draws it
    router = torch.randn((cfg.dim, cfg.n_experts), generator=gen,
                         device=dev) * 0.02
    _, idx, _ = moe._router(cfg, randn(tokens, cfg.dim), {"router": router})
    flat = idx.reshape(-1)
    if local:  # the other experts' pairs go past the last group
        flat = torch.where(flat < e, flat, e)
    routed = moe._sorted_order(flat, e + bool(local))[1][:e].contiguous()
    m = tokens * cfg.experts_per_token
    g_rows = int(routed.sum())  # the rows the groups hold
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
        log(f"{op}{tag} {label}: max|kernel - plain| {e_abs:.3e}, {ratio:.3f} "
            f"of kernel_tolerance")
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
            log(f"gmm{tag} control: row {row} moved from group {g + 1} to "
                f"{g} reaches {hit:.1f} x the tolerance")
            if hit <= 1:
                raise AssertionError("the gmm tolerance misses a moved row")
        del ref, tol
        run, lib_name = _library_gmm(gm, x, rhs, routed, trans)
        ms = time_ms(lambda i: gm.gmm(x, rhs, routed, transpose_rhs=trans),
                     reps=reps)
        dev_ms[label] = _kernel_device_ms(
            lambda: gm.gmm(x, rhs, routed, transpose_rhs=trans), kname)
        plain = time_ms(lambda i: gm.gmm_reference(x, rhs, routed,
                                                   transpose_rhs=trans), reps=3)
        lib = time_ms(lambda i: run(), reps=reps)
        nbytes = (g_rows * k + rhs.numel() + m * n) * size + e * 4
        bound, by = _gmm_bound(nbytes, 2 * g_rows * k * n, peak)
        log(f"gmm{tag} {label} (K {k}, N {n}): kernel {ms:.4f} ms  plain {plain:.4f} "
            f"ms  library ({lib_name}) {lib:.4f} ms; bound {bound:.4f} ms "
            f"({by}) -> {100 * bound / ms:.1f}% of bound, "
            f"{2 * g_rows * k * n / ms / 1e9:.1f} TFLOP/s")
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
            log(f"tgmm{tag} control: row {last} (the last of group 1) left "
                f"out reaches {hit:.1f} x the tolerance")
            if hit <= 1:
                raise AssertionError("the tgmm tolerance misses a dropped row")
            del cut_grad
        del ref, tol
        run, lib_name = _library_tgmm(gm, x.t(), grad, routed)
        ms = time_ms(lambda i: gm.tgmm(x.t(), grad, routed), reps=reps)
        dev_ms[label] = _kernel_device_ms(
            lambda: gm.tgmm(x.t(), grad, routed), "t" + kname)
        plain = time_ms(lambda i: gm.tgmm_reference(x.t(), grad, routed), reps=3)
        lib = time_ms(lambda i: run(), reps=reps)
        k, n = x.shape[1], grad.shape[1]
        nbytes = (g_rows * (k + n) + e * k * n) * size + e * 4
        bound, by = _gmm_bound(nbytes, 2 * g_rows * k * n, peak)
        log(f"tgmm{tag} {label} (K {k}, N {n}): kernel {ms:.4f} ms  plain "
            f"{plain:.4f} ms  library ({lib_name}) {lib:.4f} ms; bound "
            f"{bound:.4f} ms ({by}) -> {100 * bound / ms:.1f}% of bound, "
            f"{2 * g_rows * k * n / ms / 1e9:.1f} TFLOP/s")
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
        first = (f" (the first FFMA kernel: {GMM_FFMA_FIRST_MS[op]} ms)"
                 if dtype == torch.float32 and not local else "")
        log(f"{op}{tag}: per launch on the step, weighted by launches per layer "
            f"{[r[0] for r in table.values()]}: kernel {mean(1):.4f} ms{first}, "
            f"plain {mean(2):.4f}, library {mean(3):.4f}, bound {mean(4):.4f}")
        if all(dev_ms[k] is not None for k in table):
            log(f"{op}{tag}: device ms per launch (torch.profiler, 5 calls a "
                f"variant), launch-weighted "
                f"{sum(r[0] * dev_ms[k] for k, r in table.items()) / w:.4f}: "
                + ", ".join(f"{k} {dev_ms[k]:.4f}" for k in table))
        else:
            log(f"{op}{tag}: device ms per launch not measured: the profiler saw "
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


def phase_moe_mesh_world1(fa, gm, moe, parallel, card_line, dev, b=4,
                          s=2048, steps=3):
    """Phase 10m: the MoE step over a one-rank mesh with a one-rank NCCL
    group on every axis and batch-axis group (``GROUP_KEYS``), so each
    collective of the sharded MoE step runs on the card (the expert
    exchange, the capacity counts, the aux loss's sums), at phase 10's
    config and batch.  Under a mesh "auto" is the dense dispatch: a
    warm-up and three timed steps of it beside as many of the mesh-free
    ``dispatch="dense"`` step, each from the seed's weights: losses, grad
    norms and every param's bits (a checksum) equal.  Returns the mesh
    steps' (forward, backward) flash launches."""
    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    cfg = mixtral_config(moe)
    tokens = _train_batch(cfg, b, s, dev)
    keys = parallel.mesh.GROUP_KEYS
    mesh = parallel.mesh.Mesh({}, device=dev, groups={
        (a if len(a) > 1 else a[0]): parallel.mesh.TensorGroup(NCCLGroup(
            1, 0, f"smoke-10m/{'+'.join(a)}",
            store=torch.distributed.HashStore())) for a in keys})
    runs = {}
    try:
        for name, m, run_cfg in (
                ("mesh-free dense", None,
                 dataclasses.replace(cfg, dispatch="dense")),
                ("mesh", mesh, cfg)):
            init_fn, step_fn = parallel.make_train_step(run_cfg, m,
                                                        device=dev)
            state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.reset_peak_memory_stats()
            fa.fwd_launches = fa.bwd_launches = 0
            gm.gmm_launches = gm.tgmm_launches = 0
            warm = step_fn(state, tokens)[1]  # the first call's costs
            metrics, step_s = timed_steps(step_fn, state, tokens, steps)
            metrics = [warm] + metrics
            runs[name] = ([float(x["loss"]) for x in metrics],
                          [float(x["grad_norm"]) for x in metrics],
                          _bits_checksum(parallel.train_step.tree_leaves(
                              state.params)), step_s,
                          (fa.fwd_launches, fa.bwd_launches),
                          (gm.gmm_launches, gm.tgmm_launches),
                          torch.cuda.max_memory_allocated() / 2**30)
            del state, metrics, step_fn, init_fn
            gc.collect()
            torch.cuda.empty_cache()
        backends = sorted({g.group.last_backend for g in mesh.groups.values()
                           if g.group.last_backend})
    finally:
        mesh.destroy()
    (l0, n0, c0, s0, _, _, p0), (l1, n1, c1, s1, launches, gmm_n, p1) = (
        runs["mesh-free dense"], runs["mesh"])
    log(f"moe mesh w1 [{card_line}]: Mixtral-8x7B width, {cfg.n_layers} "
        f"layers, [{b}, {s}]: {steps} steps at world size 1 over "
        f"{len(keys)} one-rank groups (backends {backends}), dispatch "
        f"'auto' (dense under a mesh): losses {l1}, grad norms {n1}, params "
        f"checksum {c1}; the mesh-free dense step {l0}, {n0}, {c0}; "
        f"{s1 * 1e3:.1f} ms per timed step (mesh-free {s0 * 1e3:.1f}); peak "
        f"{p1:.2f} GiB (mesh-free {p0:.2f}); {launches[0]} forward and "
        f"{launches[1]} backward flash launches, gmm and tgmm {gmm_n}")
    if (l0, n0, c0) != (l1, n1, c1):
        raise AssertionError("phase 10m: the world-1 mesh step differs from "
                             "the mesh-free dense step")
    if backends != ["nccl"]:
        raise AssertionError(f"phase 10m: the collectives ran on {backends}")
    if launches != (2 * cfg.n_layers * (steps + 1),
                    cfg.n_layers * (steps + 1)):
        raise AssertionError(f"phase 10m: flash launches {launches}")
    return launches


# the fp32 grouped matmuls' kernels by mangled name (tgmm first: its name
# holds gmm's), and the SASS mnemonics phase 9 counts in them
GMM_FFMA_KERNELS = {"tgmm_ffma_kernel": "tgmm fp32",
                    "gmm_ffma_kernelILb0E": "gmm fp32",
                    "gmm_ffma_kernelILb1E": "gmm fp32 transpose_rhs"}
GMM_FFMA_SASS_OPS = ("FFMA", "LDS", "LDS.128", "STS", "LDGSTS", "HMMA", "HGMMA",
                     "STL", "LDL")
# the first FFMA grouped matmuls (128 x 128 tiles, 8 x 8 outputs a thread,
# 8-deep stages through registers), which csrc/grouped_matmul_ffma.cu's
# replaced: ptxas's registers and spilled bytes, their SASS counts of
# GMM_FFMA_SASS_OPS, and ms per launch at phase 9's fp32 shapes,
# launch-weighted (NVIDIA H100 80GB HBM3, 700.00 W)
GMM_FFMA_FIRST = {
    "gmm fp32": (128, 48, (512, 35, 32, 25, 0, 0, 0, 6, 6)),
    "gmm fp32 transpose_rhs": (128, 40, (512, 35, 32, 31, 0, 0, 0, 5, 5)),
    "tgmm fp32": (128, 0, (512, 34, 32, 19, 0, 0, 0, 0, 0))}
GMM_FFMA_FIRST_MS = {"gmm": 54.314, "tgmm": 44.386}


def phase_gmm_ffma_sass(library, build_log):
    """The fp32 grouped matmuls' design as compiled (ROADMAP C11): per
    kernel, ptxas's registers and spills and the SASS counts of FFMA,
    shared-memory loads (LDS, of them LDS.128), stores (STS), cp.async
    copies (LDGSTS), tensor-core products (HMMA, HGMMA) and local memory,
    beside the first FFMA kernels' (``GMM_FFMA_FIRST``).  Fails on a
    spill, on a kernel without FFMA or LDGSTS, or on a tensor-core
    instruction (no TF32 or bf16 product)."""
    report = ptxas_report(build_log)
    counts = sass_counts(library, tuple(GMM_FFMA_KERNELS), GMM_FFMA_SASS_OPS)
    for key, label in GMM_FFMA_KERNELS.items():
        regs = next((v for k, v in report.items() if key in k), None)
        c = counts.get(key, dict.fromkeys(GMM_FFMA_SASS_OPS, 0))
        ptx = ("ptxas report not available (library built earlier)"
               if regs is None else
               f"{regs[0]} registers, spills {regs[2]} bytes stored and "
               f"{regs[3]} loaded")
        first_regs, first_spill, first = GMM_FFMA_FIRST[label]
        log(f"sass {label} kernel: {ptx}; " + ", ".join(
            f"{op} {c[op]}" for op in GMM_FFMA_SASS_OPS)
            + f" (the first FFMA kernel: {first_regs} registers, "
            f"{first_spill} bytes spilled; " + ", ".join(
                f"{op} {n}" for op, n in zip(GMM_FFMA_SASS_OPS, first)) + ")")
        if regs is not None and (regs[2] or regs[3]):
            raise AssertionError(f"{label}: ptxas spilled registers: {regs}")
        if (not c["FFMA"] or not c["LDGSTS"] or c["HMMA"] or c["HGMMA"]
                or c["STL"] or c["LDL"]):
            raise AssertionError(f"the {label} kernel has no FFMA or cp.async, "
                                 f"or a tensor-core product or local memory, "
                                 f"in its SASS: {c}")
    return counts


def _routing(moe, pinned=None):
    """A stand-in for ``moe._router`` that computes what it computes, its
    top-k expert ids recorded (``pinned`` None; each call's outputs are
    then held to the real router's, bit for bit) or taken from ``pinned``,
    an earlier run's record, in call order.  Returns (router, ids, flips):
    the ids used, and per call the tokens whose own top-k differs from
    them (tensors)."""
    real = moe._router
    ids, flips = [], []

    def router(cfg, xt, lp, sh=moe.llama.UNSHARDED):
        e, k = cfg.n_experts, cfg.experts_per_token
        probs = torch.softmax(xt.float() @ lp["router"].float(), dim=-1)
        own = torch.topk(probs, k, dim=-1)[1]
        top_idx = own if pinned is None else pinned[len(ids)]
        ids.append(top_idx)
        flips.append((own != top_idx).any(-1).sum())
        top_w = probs.gather(-1, top_idx)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        sums = moe._fn.psum(torch.stack([moe._one_hot(top_idx[:, 0], e)
                                         .float().sum(0), probs.sum(0)]),
                            sh.batch)
        frac_routed, mean_prob = sums / (xt.shape[0] * sh.nb)
        out = (top_w, top_idx, e * torch.sum(frac_routed * mean_prob))
        if pinned is None and not all(map(torch.equal, out,
                                          real(cfg, xt, lp, sh))):
            raise AssertionError("the routing stand-in differs from the "
                                 "MoE router")
        return out

    return router, ids, flips


def phase_moe_train_fp32(gm, moe, parallel, card_line, dev, b=4, s=2048,
                         steps=3):
    """ROADMAP C11: ``make_train_step`` on Mixtral-8x7B's width at 2 layers
    with fp32 products (``compute_dtype=float32``: megablox's fp32 gmm and
    tgmm, here the FFMA kernels), ``steps`` steps on one [b, s] batch:
    18 gmm and 6 tgmm fp32 launches a step, finite losses that fall; then
    the same steps from the same initial state with the grouped matmuls'
    plain versions (cuBLAS fp32, TF32 off) in their place: every loss
    within 1e-4 of the kernels' (relative; fp32 summation order).  The
    plain run routes each token to the experts the kernels' run chose
    (``_routing``): top-k is discontinuous, and a router logit moved by
    fp32 summation order can send a token to another expert, which moves
    the mean loss by far more than summation order does; the line counts
    the tokens whose own top-k differed.  Returns the (gmm, tgmm) fp32
    launches of the kernels' run."""
    cfg = moe.MoEConfig.mixtral_8x7b(n_layers=2, max_seq_len=2048,
                                     compute_dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    runs = {}
    for name in ("kernels", "plain"):
        init_fn, step_fn = parallel.make_train_step(cfg, device=dev)
        state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
        saved = gm.gmm, gm.tgmm, moe._router
        router, ids, flips = _routing(
            moe, None if name == "kernels" else runs["kernels"][3])
        moe._router = router
        if name == "plain":
            gm.gmm, gm.tgmm = gm.gmm_reference, gm.tgmm_reference
        before = gm.gmm_fp32_launches, gm.tgmm_fp32_launches
        try:
            metrics, step_s = timed_steps(step_fn, state, tokens, steps)
        finally:
            gm.gmm, gm.tgmm, moe._router = saved
        launches = (gm.gmm_fp32_launches - before[0],
                    gm.tgmm_fp32_launches - before[1])
        runs[name] = ([float(m["loss"]) for m in metrics], step_s, launches,
                      ids, [int(f) for f in flips])
        del state, step_fn, init_fn
        gc.collect()
        torch.cuda.empty_cache()
    losses, step_s, launches, _, _ = runs["kernels"]
    plain, plain_s, _, _, flips = runs["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    L = cfg.n_layers
    want = (9 * L * steps, 3 * L * steps)
    log(f"moe train fp32 [{card_line}]: Mixtral-8x7B width, {L} layers, fp32 "
        f"products; {steps} steps on [{b}, {s}]: {step_s * 1e3:.1f} ms per "
        f"step through the FFMA grouped matmuls ({launches[0]} gmm and "
        f"{launches[1]} tgmm fp32 launches, want {want}), "
        f"{plain_s * 1e3:.1f} ms through their plain versions; losses "
        f"{[round(x, 6) for x in losses]} against {[round(x, 6) for x in plain]} "
        f"(largest relative difference {rel:.2e}, limit 1e-4); tokens whose "
        f"own top-k in the plain run differs from the kernels' routing, per "
        f"router call: {flips}")
    if dev.type == "cuda" and launches != want:
        raise AssertionError("the fp32 MoE step did not run the FFMA grouped "
                             "matmuls on every layer")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe train fp32: losses {losses}")
    if rel > 1e-4:
        raise AssertionError(f"moe train fp32: the kernels' losses leave the "
                             f"plain versions' by {rel:.2e}")
    return launches


TP_RANK_SHAPES = {  # B1 per rank: (q heads, kv heads, layers)
    "8b-tp2": (16, 4, 32), "8b-tp4": (8, 2, 32), "8b-tp8": (4, 1, 32),
    "70b-tp4": (16, 2, 80), "70b-tp8": (8, 1, 80)}


def phase_kernel_tp_shapes(pa, llama, dev, nb=1024):
    """B1 at the per-rank shapes tensor parallelism gives it (the GQA group
    unchanged, n_kv / tp kv heads a rank; Llama-3-8B at tp 2, 4, 8 and
    Llama-3-70B at tp 4 and 8): phase 3's decode batch (a) through
    ``phase_kernel`` per shape, held to the plain version with its
    controls and timed, and the split grid's blocks against the 132 SMs.
    Returns {shape: result}."""
    spans = paged_shapes(np.random.default_rng(SEED))["a"]
    out = {}
    for name, (nh, kv, layers) in TP_RANK_SHAPES.items():
        cfg = llama.LlamaConfig(dim=nh * 128, n_heads=nh, n_kv_heads=kv,
                                n_layers=layers)
        w = 1 << (max(math.ceil((int(n) + 1) / 16) for n in spans) - 1).bit_length()
        tokens, splits = pa.split_plan(len(spans), kv, w, 16, _sm_count(dev))
        log(f"kernel tp {name}: {nh} q over {kv} kv heads a rank, {layers} "
            f"layers; split grid {len(spans)} rows x {kv} kv heads x {splits} "
            f"splits of {tokens} tokens = {len(spans) * kv * splits} blocks "
            f"for {_sm_count(dev)} SMs")
        out[name] = phase_kernel(pa, cfg, dev, nb=nb, shapes={name: spans})[name]
        gc.collect()
        torch.cuda.empty_cache()
    return out


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
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-cards":
        return tp_cards_main(int(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--train-cards":
        return train_cards_main(int(sys.argv[2]))
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--tp-cards N | --train-cards N]",
              file=sys.stderr)
        return 2
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
    tier_a = phase_tier(llama, llm, cfg, params, card_line, dev)
    lap("phase 4m (a)")
    phase_store_tier(llm, cfg, params, tier_a, card_line, dev)
    lap("phase 4m (d)")
    phase_migration(llama, llm, cfg, params, main_run, card_line, dev)
    lap("phase 4m (b, c)")
    log(f"phase 4m: {pa.launches} B1 launches (warm-up runs before each "
        f"capture included)")
    launches += pa.launches
    gc.collect()
    torch.cuda.empty_cache()
    tp1_tokens, tp1_launches = phase_tp_world1(pa, llm, cfg, main_run,
                                               card_line, dev)
    launches += tp1_launches
    lap("phase 4tp")
    pa.launches = 0
    phase_tp_gloo(llama, llm, cfg, main_run, tp1_tokens, card_line, dev)
    launches += pa.launches
    lap("phase 4tp (b)")
    gc.collect()
    torch.cuda.empty_cache()
    spec_launches, _, control = phase_spec(pa, llama, llm, paged, cfg,
                                           main_run, card_line, dev)
    launches += spec_launches
    lap("phase 4s")
    gc.collect()  # the speculative engines and the 1B draft go
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_b1, serve_b2, serve_tok_s, handoff_4v = phase_serve(
        pa, fa, llama, llm, cfg, main_run, control, card_line, dev)
    launches += serve_b1
    log(f"phase 4v: {serve_b1} B1 and {serve_b2} B2 launches; "
        f"{time.perf_counter() - t0:.1f} s of the run")
    lap("phase 4v")
    gc.collect()  # every server of 4v is shut down; their engines go
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runtime_b1, actor_tok_s = phase_runtime(pa, llama, llm, cfg, main_run,
                                            control, serve_tok_s, card_line,
                                            dev)
    launches += runtime_b1
    log(f"phase 4r: {runtime_b1} B1 launches (the driver's server and the "
        f"replica's); {time.perf_counter() - t0:.1f} s of the run")
    lap("phase 4r")
    # phase 4's weights go while 4d's replicas hold the card; 5b draws them
    # again from the same seed, checked against these checksums
    leaves = ["embed", "layers.wq", "layers.w_down", "final_norm"]
    sums = _checksums(params, leaves)
    prompts = main_run["prompts"]
    del main_run, params
    gc.collect()  # every server is shut down; their engines go
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_collectives(card_line, dev)
    log(f"phase 4c: {time.perf_counter() - t0:.1f} s of the run")
    lap("phase 4c")
    t0 = time.perf_counter()
    deploy_b1, deploy_b2 = phase_deploy(
        llama, llm, cfg, prompts, control,
        {"actor": actor_tok_s, "server": serve_tok_s}, handoff_4v, card_line,
        dev)
    launches += deploy_b1
    log(f"phase 4d: {deploy_b1} B1 launches and {deploy_b2} B2 launches in "
        f"the replicas' processes; {time.perf_counter() - t0:.1f} s of the "
        f"run")
    lap("phase 4d")
    phase_telemetry_cost(llama, llm, card_line)
    lap("phase 4t")
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    if _checksums(params, leaves) != sums:
        raise AssertionError("phase 4's weights drawn again differ")
    _, static_fwd = phase_static(fa, llama, llm, cfg, params, card_line, dev)
    static_fwd += serve_b2 + deploy_b2
    lap("phase 5b")
    del params
    gc.collect()  # the static engine and the 8B weights go before training
    torch.cuda.empty_cache()

    phase_flash_sass(libs)
    phase_gmm_sass(*libs["grouped_matmul"])
    with torch.no_grad():
        flash = phase_flash(fa, dev)
        gc.collect()
        torch.cuda.empty_cache()
        # the head_dim-256 pair at phase 6's batch and heads
        d256 = phase_flash(fa, dev, shape=(8, 2048, 16, 8, 256),
                           name="bf16_d256", groups=False)
        gc.collect()
        torch.cuda.empty_cache()
        phase_flash_ffma_sass(*libs["flash_attention_ffma"])
        ffma = phase_flash_ffma(fa, dev)
        lap("phase 6 (FFMA)")
        gc.collect()
        torch.cuda.empty_cache()
        phase_kernel_tp_shapes(pa, llama, dev)
    lap("phase 6 (B1 at the TP rank shapes)")
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
    f, b = phase_train_mesh_world1(fa, llama, parallel, card_line, bf16)
    fwd_n, bwd_n = fwd_n + f, bwd_n + b
    lap("phase 7m")
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, moe_gmm = phase_train_mesh_gloo(fa, llama, moe, parallel,
                                                   card_line, dev)
    lap("phases 7m (b) and 10m (b)")
    with torch.no_grad():
        rank_rows = phase_flash_rank_shapes(fa, dev)
    lap("phase 7m (B2/B3 at the rank shapes)")
    gc.collect()
    torch.cuda.empty_cache()
    step_launches = phase_train_fp32(fa, llama, parallel, card_line, dev)
    lap("phase 7f")

    with torch.no_grad():
        gmm_row, tgmm_row = phase_grouped_matmul(gm, moe, dev, reps=10)
        gc.collect()
        torch.cuda.empty_cache()
        phase_gmm_ffma_sass(*libs["grouped_matmul_ffma"])
        gmm32_row, tgmm32_row = phase_grouped_matmul(
            gm, moe, dev, dtype=torch.float32, reps=5)
    lap("phase 9 (bf16 and fp32)")
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
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    gmm32_n, tgmm32_n = phase_moe_train_fp32(gm, moe, parallel, card_line, dev)
    lap("phase 10f (MoE at fp32 products)")
    f, b = phase_moe_mesh_world1(fa, gm, moe, parallel, card_line, dev)
    fwd_n, bwd_n = fwd_n + f, bwd_n + b
    lap("phase 10m")
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        gmm_ep, tgmm_ep = phase_grouped_matmul(
            gm, moe, dev, tokens=EP_RANK["tokens"], local=EP_RANK["experts"],
            reps=5)
    ep_n = [sum(v[i] for v in moe_gmm.values()) for i in (0, 1)]
    lap("phase 10m (b) B4/B5 at the expert rank's shape")

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
    }] + [{
        "name": f"flash_attention_{leg}_{name}",
        "route": "cuda",
        "source": ("ray_tpu_torch/ops/csrc/flash_attention_d256.cu"
                   if name == "bf16_d256" else
                   "ray_tpu_torch/ops/csrc/flash_attention_ffma.cu"),
        "replaces": ("ray_tpu/ops/flash_attention.py:32" if leg == "fwd"
                     else "ray_tpu/ops/flash_attention.py:76"),
        "launches": step_launches[name][leg == "bwd"],
        **(d256[leg] if name == "bf16_d256" else ffma[f"{leg}_{name}"]),
    } for name in step_launches for leg in ("fwd", "bwd")] + [{
        "name": f"flash_attention_{leg}_rank_{key}",
        "route": "cuda",
        "source": src,
        "replaces": ("ray_tpu/ops/flash_attention.py:32" if leg == "fwd"
                     else "ray_tpu/ops/flash_attention.py:76"),
        "launches": mesh_launches[key][leg == "bwd"],
        **rank_rows[key][leg],
    } for key in RANK_SHAPES for leg in ("fwd", "bwd")] + [{
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
    }, {
        "name": "grouped_matmul_gmm_rank_ep2",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/grouped_matmul.cu",
        "replaces": MEGABLOX + ":314",
        "launches": ep_n[0],
        **gmm_ep,
    }, {
        "name": "grouped_matmul_tgmm_rank_ep2",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/grouped_matmul.cu",
        "replaces": MEGABLOX + ":573",
        "launches": ep_n[1],
        **tgmm_ep,
    }, {
        "name": "grouped_matmul_gmm_fp32",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/grouped_matmul_ffma.cu",
        "replaces": MEGABLOX + ":314",
        "launches": gmm32_n,
        **gmm32_row,
    }, {
        "name": "grouped_matmul_tgmm_fp32",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/grouped_matmul_ffma.cu",
        "replaces": MEGABLOX + ":573",
        "launches": tgmm32_n,
        **tgmm32_row,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
