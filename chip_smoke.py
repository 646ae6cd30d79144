"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) when it fails:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
  2. build: compiles every kernel under ray_tpu_torch/ops/csrc with nvcc
  3. kernel vs plain at the main path's shapes (Llama-3-8B heads, B=8,
     a 512-block pool, ragged spans, NaN in every dead page) within a
     tolerance that a dropped token must break (checked), with times:
     kernel, plain version, SDPA on the pre-gathered span, and the bound
  4. the paged engine serving Llama-3-8B (full width and depth, random
     bf16 weights from a seeded generator): 10 requests to 64 tokens each,
     the kernel's launches counted against the decode token steps; then a
     measured run for prefill and decode tokens/s
  5. one decode step with the kernel and with the table gather on the
     same engine state: the logits must agree
Then one JSON line per kernel, and last the device line.

Imports torch and ray_tpu_torch only.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
LOGIT_SHARE = 0.05  # kernel vs gather: max|dlogits| <= share * max|logits|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12


def log(*args):
    print(*args, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def phase_kernel(pa, cfg, dev):
    """Kernel vs plain version at the decode path's shapes."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    nh, kv, hd, bs, nb, L = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16,
                             512, cfg.n_layers)
    # ragged: empty, a span ending on a page boundary, one >= 1000 tokens
    lengths_np = np.array([0, 255, 1500, 37, 700, 1023, 16, 511], np.int32)
    b = len(lengths_np)
    pages = [math.ceil((n + 1) / bs) for n in lengths_np]
    w = 1 << (max(pages) - 1).bit_length()
    perm = rng.permutation(np.arange(1, nb))
    live_pages = perm[:sum(pages)]
    dead_pages = perm[sum(pages):]
    table_np = np.zeros((b, w), np.int32)
    at = 0
    for r, n in enumerate(pages):
        table_np[r, :n] = live_pages[at:at + n]
        table_np[r, n:] = rng.choice(dead_pages, size=w - n)  # NaN pages
        at += n
    pool_k = torch.randn((L, nb, bs, kv * hd), generator=g, device=dev,
                         dtype=torch.bfloat16)
    pool_v = torch.randn((L, nb, bs, kv * hd), generator=g, device=dev,
                         dtype=torch.bfloat16)
    dead = torch.as_tensor(np.concatenate([[0], dead_pages]), device=dev)
    pool_k[:, dead] = float("nan")
    pool_v[:, dead] = float("nan")
    q = torch.randn((b, nh, hd), generator=g, device=dev, dtype=torch.bfloat16)
    table = torch.as_tensor(table_np, device=dev)
    lengths = torch.as_tensor(lengths_np, device=dev)
    li = L - 1

    out = pa.paged_decode_attention(q, pool_k, pool_v, li, table, lengths)
    ref = pa.paged_decode_attention_reference(q, pool_k, pool_v, li, table,
                                              lengths)
    torch.cuda.synchronize()
    if tuple(out.shape) != (b, nh * hd) or not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite or misshapen")
    # tolerance: the spread of the bf16 roundings of probabilities that
    # summation order may flip (ops/paged_attention.kernel_tolerance)
    tol = pa.kernel_tolerance(q, pool_k, pool_v, li, table, lengths)
    err = (out - ref).abs().max().item()
    ratio = ((out - ref).abs() / tol).max().item()
    log(f"kernel: max|kernel - plain| = {err:.3e}, at most {ratio:.3f} of "
        f"its tolerance (tolerance {tol.min().item():.2e} to "
        f"{tol.max().item():.2e})")
    if ratio > 1:
        raise AssertionError(f"kernel disagrees with its plain version: {err}")
    # negative control: the kernel without the last token of the longest
    # row must fail the same check
    longest = int(lengths_np.argmax())
    short = lengths.clone()
    short[longest] -= 1
    cut = pa.paged_decode_attention(q, pool_k, pool_v, li, table, short)
    cut_ratio = ((cut - ref).abs() / tol)[longest].max().item()
    log(f"kernel: dropping the last of {lengths_np[longest] + 1} tokens of "
        f"row {longest} reaches {cut_ratio:.3f} of the tolerance")
    if cut_ratio <= 1:
        raise AssertionError("the tolerance does not catch a dropped token")

    # times: one launch per layer in turn, so each layer's span is cold in
    # L2 as on the decode path (one layer's span fits the 50 MB L2); the
    # slower plain and library versions take a few layers in turn
    nl = min(4, L)
    ms = time_ms(lambda i: pa.paged_decode_attention(
        q, pool_k, pool_v, i % L, table, lengths), reps=20, inner=L)
    plain_ms = time_ms(lambda i: pa.paged_decode_attention_reference(
        q, pool_k, pool_v, i % L, table, lengths), reps=20, inner=nl)
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
    library_ms = time_ms(lambda i: sdpa(q4, gk[i % nl], gv[i % nl],
                                        attn_mask=mask, enable_gqa=True),
                         reps=20, inner=nl)
    nvalid = lengths_np.astype(np.int64) + 1
    nbytes = (q.numel() * 2 + 2 * int(nvalid.sum()) * kv * hd * 2
              + table.numel() * 4 + lengths.numel() * 4 + b * nh * hd * 4)
    flops = 4 * nh * hd * int(nvalid.sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kernel: {ms:.4f} ms  plain: {plain_ms:.4f} ms  "
        f"library (SDPA on the pre-gathered span, gather not timed, "
        f"max err {lib_err:.2e}): {library_ms:.4f} ms")
    log(f"kernel: bound {bound_ms:.5f} ms ({nbytes} bytes at 3.35 TB/s; "
        f"{flops} flops) -> {100 * bound_ms / ms:.1f}% of bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


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
        f"{eng._use_kernel}")
    if on_card and not eng._use_kernel:
        raise AssertionError("the engine did not pick the CUDA kernel")
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
        f"{steps} decode token steps, {launches} kernel launches "
        f"(want {cfg.n_layers} x {steps})")
    if on_card and (launches != cfg.n_layers * steps or launches == 0):
        raise AssertionError("the decode path did not run the kernel on "
                             "every layer of every step")

    # measured run: 8 ragged prompts, prefill first, then decode
    mlens = [512, 300, 700, 450, 256, 640, 380, 600]
    mprompts = [rng.integers(0, v, n).tolist() for n in mlens]
    ids = [eng.add_request(p, greedy) for p in mprompts]
    got = {i: [] for i in ids}
    pf0 = eng.prefill_tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng._pending or any(r is not None and not eng._decode_ready(r)
                              for r in eng._slot_req):
        for rid, toks in eng.step(decode=False).items():
            got[rid].extend(toks)
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    pf_tokens = eng.prefill_tokens - pf0

    for rid, toks in eng.flush().items():  # first tokens into the mirrors
        got[rid].extend(toks)
    ab = phase_ab(eng, llama)  # on this state: 8 prefilled slots

    pa.launches = 0
    steps0 = eng.decode_steps
    t0 = time.perf_counter()
    while eng.has_work():
        for rid, toks in eng.step().items():
            got[rid].extend(toks)
    for rid, toks in eng.flush().items():
        got[rid].extend(toks)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    if any(len(got[i]) != 64 for i in ids):
        raise AssertionError("measured run: a request fell short of 64 tokens")
    msteps = eng.decode_steps - steps0
    if on_card and pa.launches != cfg.n_layers * msteps:
        raise AssertionError("measured run: kernel launches != 32 x steps")
    dec_tokens = 8 * 63  # the first token of each came from prefill
    log(f"engine [{card_line}]: prefill {pf_tokens / t_pf:.1f} tok/s "
        f"({pf_tokens} tokens in {t_pf:.3f} s); decode {dec_tokens / t_dec:.1f} "
        f"tok/s at batch 8 ({dec_tokens} tokens in {t_dec:.3f} s, {msteps} "
        f"token steps); main run wall {wall:.2f} s")
    phase_profile(eng, llm, rng, v, card_line)
    return launches, ab


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import ray_tpu_torch.llm as llm
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import paged_attention as pa

    card_line = card()
    log(card_line)
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
    with torch.no_grad():
        kern = phase_kernel(pa, cfg, dev)
    torch.cuda.empty_cache()
    launches, _ = phase_engine(pa, llama, llm, cfg, card_line, dev)

    log(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:36",
        "launches": launches,
        **kern,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
