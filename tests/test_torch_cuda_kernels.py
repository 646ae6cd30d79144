"""The port's CUDA kernels on the card, each against its plain version:
paged decode attention, flash attention forward and backward, and the
grouped matmuls gmm and tgmm.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch and ray_tpu_torch, so it also runs where
JAX is not installed; tests/conftest.py imports JAX, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import grouped_matmul as gm
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _paged_inputs(dev, hd, group, kv=2, bs=16, seed=0,
                  lengths=(0, 15, 31, 100, 257, 64)):
    """q, pool, table and lengths with NaN wherever the kernel must not
    look: every page outside the live spans, sink block 0, and the tail of
    each row's last live page past lengths + 1 (TMA loads whole pages)."""
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths, np.int32)
    pages = [max(int(n) + 1, 1) // bs + (max(int(n) + 1, 1) % bs > 0)
             for n in lengths]
    w = 1 << (max(pages) - 1).bit_length()
    nb = sum(pages) + 8
    perm = rng.permutation(np.arange(1, nb))
    table = np.zeros((len(lengths), w), np.int32)
    at = 0
    for r, n in enumerate(pages):
        table[r, :n] = perm[at:at + n]
        at += n
    dead = torch.as_tensor(np.concatenate([[0], perm[at:]]), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (3, nb, bs, kv * hd)
    pk = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    pv = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    for t in (pk, pv):
        t[:, dead] = float("nan")  # pages outside every live span
        for r, n in enumerate(lengths):
            tail = (max(int(n) + 1, 0)) % bs
            if tail:
                t[:, int(table[r, pages[r] - 1]), tail:] = float("nan")
    q = torch.randn((len(lengths), kv * group, hd), generator=g, device=dev,
                    dtype=torch.bfloat16)
    return (q, pk, pv, torch.as_tensor(table, device=dev),
            torch.as_tensor(lengths, device=dev))


def _check_paged(q, pk, pv, li, table, lengths, out=None):
    """The kernel (or ``out``) within kernel_tolerance of the plain version;
    returns (ratio to the tolerance, plain output, tolerance)."""
    if out is None:
        out = pa.paged_decode_attention(q, pk, pv, li, table, lengths)
    ref = pa.paged_decode_attention_reference(q, pk, pv, li, table, lengths)
    tol = pa.kernel_tolerance(q, pk, pv, li, table, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ratio = ((out - ref).abs() / tol).max().item()
    assert ratio <= 1, ratio
    return ratio, ref, tol


@pytest.mark.parametrize("hd,group", [(128, 4), (128, 1), (64, 8), (64, 2)])
def test_paged_attention_kernel_matches_plain(cuda, hd, group):
    q, pk, pv, table, lengths = _paged_inputs(cuda, hd, group)
    before = pa.launches
    out = pa.paged_decode_attention(q, pk, pv, 2, table, lengths)
    assert pa.launches == before + 1
    # both round the same exponentials to bf16; fp32 summation order may
    # carry one across a rounding boundary, within kernel_tolerance (NaN in
    # dead pages, sink block 0 and last-page tails stays out)
    _check_paged(q, pk, pv, 2, table, lengths, out)
    # deterministic: fixed-order reductions
    assert torch.equal(out, pa.paged_decode_attention(q, pk, pv, 2, table,
                                                      lengths))


def test_paged_attention_kernel_takes_any_span(cuda):
    # 20,000 tokens at GQA group 8: nothing in the kernel grows with the span
    q, pk, pv, table, lengths = _paged_inputs(cuda, 128, 8,
                                              lengths=(19999, 3, 8191))
    out = pa.paged_decode_attention(q, pk, pv, 1, table, lengths)
    ref = pa.paged_decode_attention_reference(q, pk, pv, 1, table, lengths)
    tol = pa.kernel_tolerance(q, pk, pv, 1, table, lengths)
    assert ((out - ref).abs() <= tol).all()


# B1 at the per-rank shapes tensor parallelism gives it: the GQA group
# unchanged, n_kv / tp kv heads a rank.  Llama-3-8B (32 q over 8 kv):
# tp 2, 4, 8; Llama-3-70B (64 q over 8 kv): tp 4, 8
TP_RANK_SHAPES = {"8b-tp2": (4, 4), "8b-tp4": (2, 4), "8b-tp8": (1, 4),
                  "70b-tp4": (2, 8), "70b-tp8": (1, 8)}


@pytest.mark.parametrize("kv,group", list(TP_RANK_SHAPES.values()),
                         ids=list(TP_RANK_SHAPES))
def test_paged_attention_kernel_at_the_tensor_parallel_rank_shapes(cuda, kv,
                                                                   group):
    q, pk, pv, table, lengths = _paged_inputs(
        cuda, 128, group, kv=kv, lengths=(0, 15, 100, 1500, 257, 64, 2047, 9))
    before = pa.launches
    out = pa.paged_decode_attention(q, pk, pv, 1, table, lengths)
    assert pa.launches == before + 1
    assert out.shape == (8, kv * group * 128)
    _check_paged(q, pk, pv, 1, table, lengths, out)


@pytest.mark.parametrize("lengths", [(8191,), tuple(range(100, 2020, 60))],
                         ids=["B1-span8192", "B32"])
def test_paged_attention_kernel_at_one_long_row_and_a_wide_batch(cuda, lengths):
    q, pk, pv, table, lens = _paged_inputs(cuda, 128, 4, kv=8, lengths=lengths)
    assert len(lengths) in (1, 32)
    _check_paged(q, pk, pv, 0, table, lens)


def test_paged_attention_kernel_breaks_tolerance_without_a_split_edge_token(cuda):
    # a 64-page table at B=4, kv=2 plans 128-token splits; spans ending on
    # a split boundary (256) and just past one (129), and an empty one: the
    # last token of the first dropped, and the first token of split 1 of
    # the second, each break the tolerance
    q, pk, pv, table, lengths = _paged_inputs(cuda, 128, 4,
                                              lengths=(255, 128, -1, 700))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa.split_plan(4, 2, table.shape[1], 16, sms)[0] == 128
    _, ref, tol = _check_paged(q, pk, pv, 1, table, lengths)
    assert (pa.paged_decode_attention(q, pk, pv, 1, table, lengths)[2] == 0).all()
    short = lengths.clone()
    short[0] -= 1
    short[1] -= 1
    cut = pa.paged_decode_attention(q, pk, pv, 1, table, short)
    assert ((cut - ref).abs() > tol)[0].any()
    assert ((cut - ref).abs() > tol)[1].any()


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
def test_paged_attention_kernel_at_every_block_size_it_takes(cuda, bs):
    q, pk, pv, table, lengths = _paged_inputs(
        cuda, 128, 4, bs=bs, lengths=(0, 7, 63, 64, 200, 511))
    _check_paged(q, pk, pv, 1, table, lengths)


def test_paged_attention_kernel_reuses_its_ring_on_a_long_split(cuda):
    # at 8 kv heads this table plans 512-token splits: eight stages each
    # through the three-stage ring
    q, pk, pv, table, lengths = _paged_inputs(cuda, 128, 4, kv=8,
                                              lengths=(1000, 255, 40))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa.split_plan(3, 8, table.shape[1], 16, sms)[0] == 512
    _check_paged(q, pk, pv, 1, table, lengths)


def test_paged_attention_kernel_makes_no_host_sync(cuda):
    q, pk, pv, table, lengths = _paged_inputs(cuda, 128, 4)
    pa.paged_decode_attention(q, pk, pv, 0, table, lengths)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pa.paged_decode_attention(q, pk, pv, 0, table, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check_paged(q, pk, pv, 0, table, lengths, out)


def test_paged_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, pk, pv, table, lengths = _paged_inputs(cuda, 128, 4)
    with pytest.raises(ValueError, match="bf16"):
        pa.paged_decode_attention(q.float(), pk, pv, 0, table, lengths)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_decode_attention(q, pk, pv, 0, table.long(), lengths)
    with pytest.raises(ValueError, match="layer"):
        pa.paged_decode_attention(q, pk, pv, 3, table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                                  pk, pv, 0, table, lengths)
    q32, pk32, pv32, t32, l32 = _paged_inputs(cuda, 32, 2)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_decode_attention(q32, pk32, pv32, 0, t32, l32)
    q24, pk24, pv24, t24, l24 = _paged_inputs(cuda, 128, 4, bs=24)
    with pytest.raises(ValueError, match="block size 24"):
        pa.paged_decode_attention(q24, pk24, pv24, 0, t24, l24)


def test_engine_decodes_through_the_kernel(cuda):
    from ray_tpu_torch.llm import GenerationConfig, LLMConfig, make_engine
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=512,
                           param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
    assert cfg.head_dim == 128
    eng = make_engine(LLMConfig(model_config=cfg, max_batch_size=4,
                                max_seq_len=128, block_size=16,
                                prefill_chunk=32, decode_chunk=4),
                      generator=torch.Generator(device=cuda).manual_seed(0))
    assert eng._use_kernel
    # capture every table width first: a width's first use runs its chunk
    # once, for real, before capturing it
    eng.warmup()
    pa.launches = 0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 70, 17, 33)]
    out = eng.generate(prompts, GenerationConfig(max_new_tokens=12))
    assert [len(o) for o in out] == [12] * 5
    assert pa.launches == cfg.n_layers * eng.decode_steps > 0
    assert math.isfinite(float(eng.pool["k"].float().abs().sum()))


def _engine_cfg(**kw):
    from ray_tpu_torch.models.llama import LlamaConfig

    kw = {"n_heads": 4, "n_kv_heads": 2, "dim": 512, **kw}  # head_dim 128
    return LlamaConfig.tiny(param_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, **kw)


def test_engine_graph_replays_equal_eager_chunks_and_book_launches(cuda):
    """The paged engine on the card dispatches every decode chunk as a
    replay of its width's graph: greedy tokens identical to an eager twin
    sharing its weights, and B1's launches booked per replay."""
    from ray_tpu_torch.llm import GenerationConfig, LLMConfig, make_engine
    from ray_tpu_torch.llm.paged import PagedTorchLLMEngine

    cfg = _engine_cfg()
    conf = LLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=128,
                     block_size=16, prefill_chunk=32, decode_chunk=4)
    eng = make_engine(conf, generator=torch.Generator(device=cuda).manual_seed(2))
    eager = PagedTorchLLMEngine(conf, params=eng.params, device=cuda,
                                _graphs=False)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 50, 31, 77, 4)]
    gen = GenerationConfig(max_new_tokens=20)
    pa.launches = 0
    pa.captured_launches = 0
    got = eng.generate(prompts, gen)
    progs = eng._programs.by_width
    assert progs and all(p.graph is not None for p in progs.values())
    assert all(p.kernel_launches == cfg.n_layers * 4 for p in progs.values())
    assert pa.captured_launches == cfg.n_layers * 4 * len(progs)
    # replays, plus each width's one real run before its capture
    assert pa.launches == cfg.n_layers * (eng.decode_steps + 4 * len(progs))
    assert got == eager.generate(prompts, gen)
    assert all(p.graph is None for p in eager._programs.by_width.values())


def test_a_sampled_row_draws_new_noise_on_every_replay(cuda):
    """The sampler's generator is registered with the graph: each replay
    draws fresh uniforms (a temperature-1 row over 4,096 equal logits
    repeats one id eight times with chance 4096**-7), a greedy row reads
    none, and the generator advances as eager draws would."""
    from ray_tpu_torch.llm import engine as tengine

    gen = torch.Generator(device=cuda).manual_seed(5)
    logits = torch.zeros((2, 4096), device=cuda)
    temps = torch.tensor([1.0, 0.0], device=cuda)
    top_ks = torch.zeros(2, dtype=torch.int32, device=cuda)
    out = torch.empty(2, dtype=torch.int32, device=cuda)

    def draw():
        out.copy_(tengine._sample(logits, gen, temps, top_ks))

    stream = torch.cuda.Stream()
    with tengine._on_stream(stream):
        draw()
    offset = gen.get_offset()
    graph = tengine._capture_graph(draw, torch.cuda.graph_pool_handle(),
                                   stream, gen)
    assert gen.get_offset() == offset  # capture draws nothing
    ids = []
    for _ in range(8):
        graph.replay()
        ids.append(out.tolist())
    assert len({i[0] for i in ids}) > 1
    assert all(i[1] == 0 for i in ids)
    assert gen.get_offset() > offset


def test_static_engine_prefills_through_flash_and_decodes_from_a_graph(cuda):
    """The static engine's prefill reaches the flash forward kernel at a
    128-token bucket (and not at a 32-token one): once in the bucket
    program's real run before its capture, then once per replay; its
    decode chunk is one captured graph, and its greedy tokens equal an
    eager twin's."""
    from ray_tpu_torch.llm import GenerationConfig, LLMConfig, TorchLLMEngine
    from ray_tpu_torch.llm import make_engine

    cfg = _engine_cfg(max_seq_len=256)
    conf = LLMConfig(model_config=cfg, kv_cache="static", max_batch_size=2,
                     max_seq_len=256, decode_chunk=4)
    eng = make_engine(conf, generator=torch.Generator(device=cuda).manual_seed(4))
    assert isinstance(eng, TorchLLMEngine)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (100, 20, 50)]
    gen = GenerationConfig(max_new_tokens=10)
    fa.fwd_launches = 0
    got = eng.generate(prompts, gen)
    # the 128-token bucket only: its warm-up run, then its one replay
    assert fa.fwd_launches == 2 * cfg.n_layers
    assert eng._prefill_programs.by_width[128].flash_launches == cfg.n_layers
    assert eng._prefill_programs.by_width[32].flash_launches == 0
    assert [len(o) for o in got] == [10] * 3
    assert list(eng._programs.by_width) == [None]
    assert eng._programs.by_width[None].graph is not None
    eager = TorchLLMEngine(conf, params=eng.params, device=cuda, _graphs=False)
    assert eager.generate(prompts, gen) == got


def test_paged_prefill_replays_equal_eager_at_two_p0(cuda):
    """The paged engine's prefill program at one chunk width, replayed at
    p0 = 0 and p0 = 256 (a prefix hit's offset) through its input
    buffers: the pool's blocks and the sampled id bit-equal to an eager
    twin's at each, so no p0 was frozen into the graph."""
    from ray_tpu_torch.llm import LLMConfig, make_engine
    from ray_tpu_torch.llm.paged import PagedTorchLLMEngine

    conf = LLMConfig(model_config=_engine_cfg(max_seq_len=1024),
                     max_batch_size=2, max_seq_len=1024, block_size=16,
                     prefill_chunk=256, decode_chunk=4, num_blocks=64)
    eng = make_engine(conf, generator=torch.Generator(device=cuda).manual_seed(9))
    eager = PagedTorchLLMEngine(conf, params=eng.params, device=cuda,
                                _graphs=False)
    seq = np.random.default_rng(10).integers(0, 256, 600).tolist()
    blocks = list(range(40, 2, -1))[:36]  # scattered, descending
    f32, i32 = np.float32, np.int32
    for p0, idx in ((0, 0), (256, 200)):
        ids = [e._run_prefill(e._prefill_programs, seq, blocks, p0, 256,
                              sample_idx=np.array([idx], i32),
                              temp=np.array([0.0], f32),
                              top_k=np.array([0], i32)).clone()
               for e in (eng, eager)]
        assert eng._prefill_programs.by_width[256].graph is not None
        assert eager._prefill_programs.by_width[256].graph is None
        assert torch.equal(ids[0], ids[1])
        for name in ("k", "v"):
            assert torch.equal(eng.pool[name][:, 1:], eager.pool[name][:, 1:])
    written = eng.pool["k"][:, blocks[16:32]]
    assert written.abs().sum() > 0  # p0 = 256 wrote blocks 16..31


def test_static_prefill_replays_equal_eager_at_two_buckets(cuda):
    """The static engine's prefill programs at the 128- and 256-token
    buckets (B2 inside each graph), each replayed for two prompts of other
    lengths: first tokens and every slot's cache stripe bit-equal to an
    eager twin's."""
    from ray_tpu_torch.llm import GenerationConfig, LLMConfig, TorchLLMEngine
    from ray_tpu_torch.llm import make_engine

    cfg = _engine_cfg(max_seq_len=512)
    conf = LLMConfig(model_config=cfg, kv_cache="static", max_batch_size=4,
                     max_seq_len=512, decode_chunk=4)
    eng = make_engine(conf, generator=torch.Generator(device=cuda).manual_seed(11))
    eager = TorchLLMEngine(conf, params=eng.params, device=cuda, _graphs=False)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 256, n).tolist() for n in (100, 128, 200, 129)]
    gen = GenerationConfig(max_new_tokens=1)
    got = [e.generate(prompts, gen) for e in (eng, eager)]
    assert got[0] == got[1]
    assert sorted(eng._prefill_programs.by_width) == [128, 256]
    assert all(p.graph is not None and p.flash_launches == cfg.n_layers
               for p in eng._prefill_programs.by_width.values())
    for name in ("k", "v"):
        for slot, n in enumerate((100, 128, 200, 129)):
            assert torch.equal(eng.cache[name][:, slot, :n],
                               eager.cache[name][:, slot, :n])


def test_a_failed_prefill_capture_raises_and_nothing_falls_back(cuda):
    """A capture that fails raises out of the engine; the width gets no
    program, and no eager run stands in for it."""
    from ray_tpu_torch.llm import GenerationConfig, LLMConfig, make_engine
    from ray_tpu_torch.models import llama

    eng = make_engine(LLMConfig(model_config=_engine_cfg(), max_batch_size=2,
                                max_seq_len=128, block_size=16,
                                prefill_chunk=32, decode_chunk=4),
                      generator=torch.Generator(device=cuda).manual_seed(13))
    real = llama.prefill_chunk_paged

    def refuse_capture(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("capture refused")
        return real(*a, **kw)

    llama.prefill_chunk_paged = refuse_capture
    try:
        with pytest.raises(RuntimeError, match="capture refused"):
            eng.generate([[1, 2, 3]], GenerationConfig(max_new_tokens=2))
    finally:
        llama.prefill_chunk_paged = real
    assert eng._prefill_programs.by_width == {}
    assert eng.prefill_tokens == 0


def test_tier_and_handoff_on_the_card(cuda):
    """The host tier's copies and a handoff's on the card (bf16 pool):
    demoted blocks reach pinned host memory with the pool's bits and
    revive into other pool blocks unchanged; an exported request's KV
    lands in another engine's pool bit for bit, and the stitched stream is
    the unmigrated one."""
    from ray_tpu_torch._private.prefix_hash import prefix_chain_hashes
    from ray_tpu_torch.llm import GenerationConfig, LLMConfig, make_engine

    conf = LLMConfig(model_config=_engine_cfg(), max_batch_size=2,
                     max_seq_len=128, block_size=16, prefill_chunk=32,
                     decode_chunk=4, num_blocks=13)
    eng = make_engine(conf, generator=torch.Generator(device=cuda).manual_seed(14))
    rng = np.random.default_rng(15)
    first = rng.integers(0, 256, 49).tolist()
    gen = GenerationConfig(max_new_tokens=4)
    eng.generate([first], gen)
    chain = prefix_chain_hashes(first, 16)
    orig = {h: (eng.pool["k"][:, eng.blocks.by_hash[h]].clone(),
                eng.pool["v"][:, eng.blocks.by_hash[h]].clone()) for h in chain}
    for _ in range(6):  # churn the 12-block pool: first's blocks demote
        eng.generate([rng.integers(0, 256, 49).tolist()], gen)
    assert not any(h in eng.blocks.by_hash for h in chain)
    torch.cuda.synchronize()
    for h in chain:
        k, v, _ = eng._host_cache.get(h)
        assert k.is_pinned() and k.dtype == torch.bfloat16
        assert torch.equal(k, orig[h][0].cpu()) and torch.equal(v, orig[h][1].cpu())
    eng.generate([first], gen)
    assert eng.prefix_stats["host_hits"] == len(chain) == 3
    for h in chain:
        b = eng.blocks.by_hash[h]
        assert torch.equal(eng.pool["k"][:, b], orig[h][0])
        assert torch.equal(eng.pool["v"][:, b], orig[h][1])
    ref, src, dst = (make_engine(conf, params=eng.params, device=cuda)
                     for _ in range(3))
    want = ref.generate([first], GenerationConfig(max_new_tokens=24))[0]
    rid = src.add_request(first, GenerationConfig(max_new_tokens=24))
    while len(src._requests[rid].out_tokens) < 6:
        src.step()
    h = src.export_request(rid)
    # the payload's two forms: numpy ml_dtypes.bfloat16 where ml_dtypes
    # imports, else a pinned CPU tensor; in both, pinned host memory
    payload = {n: (h[n] if isinstance(h[n], torch.Tensor) else
                   torch.from_numpy(h[n].view(np.int16)).view(torch.bfloat16))
               for n in ("k", "v")}
    assert payload["k"].is_pinned() and payload["k"].dtype == torch.bfloat16
    res = dst.import_request(h["prompt"], h["first_token"], h["k"], h["v"],
                             GenerationConfig(**h["gen"]), emitted=h["emitted"])
    blocks = dst._requests[res["request_id"]].blocks
    assert torch.equal(dst.pool["k"][:, blocks].cpu(), payload["k"])
    assert torch.equal(dst.pool["v"][:, blocks].cpu(), payload["v"])
    toks = list(h["emitted"])
    while dst.has_work():
        toks.extend(dst.step().get(res["request_id"], []))
    toks.extend(dst.flush().get(res["request_id"], []))
    assert toks == want


def test_a_capture_survives_a_dead_graph_collected_inside_it(cuda):
    """ROADMAP C13's cause: an automatic garbage collection inside a
    capture finalized a dead cycle holding an earlier engine's CUDA graph,
    whose destroy call invalidated the capture.  Here the captured code
    itself drops a graph into a cycle and allocates with the collector's
    thresholds at 1: the capture must hold, and replay."""
    import gc

    from ray_tpu_torch.llm import engine

    x = torch.zeros(8, device=cuda)
    held = [engine._capture_graph(lambda: x.add_(1), torch.cuda.graph_pool_handle(),
                                  torch.cuda.Stream(), torch.Generator(device=cuda))]

    class Cycle:
        pass

    def fn():
        c = Cycle()
        c.graph, c.me = held.pop(), c  # the graph's last reference, in a dead cycle
        del c
        junk = [[] for _ in range(256)]  # each allocation may collect
        del junk
        x.mul_(2)

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graph = engine._capture_graph(fn, torch.cuda.graph_pool_handle(),
                                      torch.cuda.Stream(), torch.Generator(device=cuda))
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()  # the dead graph goes now, outside any capture
    x.fill_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 2))


def test_engine_refuses_a_config_the_kernel_cannot_take(cuda):
    from ray_tpu_torch.llm import LLMConfig, make_engine
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=128,  # head_dim 32
                           param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        make_engine(LLMConfig(model_config=cfg, max_seq_len=64),
                    generator=torch.Generator(device=cuda).manual_seed(0))
    eng = make_engine(LLMConfig(model_config=cfg, max_seq_len=64,
                                paged_attention_kernel=False),
                      generator=torch.Generator(device=cuda).manual_seed(0))
    assert not eng._use_kernel


def test_engine_refuses_a_block_size_the_kernel_cannot_take(cuda):
    from ray_tpu_torch.llm import LLMConfig, make_engine
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=512,  # head_dim 128
                           param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block size 24"):
        make_engine(LLMConfig(model_config=cfg, max_seq_len=96, block_size=24,
                              prefill_chunk=48),
                    generator=torch.Generator(device=cuda).manual_seed(0))


def test_paged_attention_kernel_at_the_draft_shape(cuda):
    """B1 at a Llama-3.2-1B-width draft's shape (head_dim 64, 32 heads over
    8 kv heads: group 4), as the speculative engine's draft steps call it;
    dropping the longest row's last token must break the tolerance."""
    q, pk, pv, table, lengths = _paged_inputs(
        cuda, 64, 4, kv=8, lengths=(0, 15, 31, 100, 257, 64, 700, 1023))
    _, ref, tol = _check_paged(q, pk, pv, 1, table, lengths)
    r = int(lengths.argmax())
    short = lengths.clone()
    short[r] -= 1
    cut = pa.paged_decode_attention(q, pk, pv, 1, table, short)
    assert ((cut - ref).abs() > tol)[r].any()


def _spec_conf(cfg, dcfg, k, **kw):
    from ray_tpu_torch.llm import LLMConfig, SpeculativeConfig

    return LLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=128,
                     block_size=16, prefill_chunk=32, decode_chunk=4,
                     speculative_config=SpeculativeConfig(
                         draft_model_config=dcfg, num_speculative_tokens=k),
                     **kw)


@pytest.mark.parametrize("hd", [64, 128])
def test_spec_engine_graph_replays_equal_its_eager_twin(cuda, hd):
    """The speculative engine on the card: propose, verify and the (k+1)-
    step chunk are graph replays at every width, the draft's steps launch
    B1 (head_dim 64, group 4), and the greedy tokens and acceptance counts
    equal an eager twin's bit for bit.  At head_dim 64 the target is its
    own draft (acceptances and bonus tokens); at 128 the draft is a
    separate 1-layer model."""
    from ray_tpu_torch.llm import GenerationConfig, make_engine
    from ray_tpu_torch.llm.paged import PagedTorchLLMEngine
    from ray_tpu_torch.models import llama

    k = 3
    dcfg = _engine_cfg(dim=256, n_kv_heads=1, n_layers=1)
    cfg = _engine_cfg() if hd == 128 else _engine_cfg(dim=256, n_kv_heads=1)
    assert cfg.head_dim == hd and dcfg.head_dim == 64
    self_draft = hd == 64
    conf = _spec_conf(cfg, cfg if self_draft else dcfg, k)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(6),
                               cuda)
    eng = make_engine(conf, params=params,
                      draft_params=params if self_draft else None)
    assert eng._use_kernel and eng._draft_use_kernel
    eager = PagedTorchLLMEngine(conf, params=eng.params,
                                draft_params=eng._draft_params, device=cuda,
                                _graphs=False)
    eng.warmup()
    pa.launches = 0
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 50, 31, 77, 4)]
    gen = GenerationConfig(max_new_tokens=20)
    got = eng.generate(prompts, gen)
    sets = (eng._programs, eng._propose_programs, eng._verify_programs)
    assert all(p.graph is not None for s in sets for p in s.by_width.values())
    assert eng.spec_cycles > 0
    d_layers = eng._draft_cfg.n_layers
    assert pa.launches == (cfg.n_layers * eng.decode_steps
                           + d_layers * (k + 1) * eng.spec_cycles)
    assert got == eager.generate(prompts, gen)
    assert eng.specdec_stats() == eager.specdec_stats()
    if self_draft:
        assert eng.specdec_stats()["accepted"] > 0
    assert all(p.graph is None for p in eager._verify_programs.by_width.values())


def test_spec_programs_draw_new_noise_on_every_replay(cuda):
    """The engine's generator is registered with the propose and verify
    graphs: on the same inputs, each replay drafts (and corrects) sampled
    rows anew, while greedy rows repeat."""
    from ray_tpu_torch.llm import make_engine

    cfg = _engine_cfg(dim=256, n_kv_heads=1)
    eng = make_engine(_spec_conf(cfg, cfg, 2),
                      generator=torch.Generator(device=cuda).manual_seed(8))
    eng.warmup(max_len=16)
    b = eng.max_batch
    state = dict(tokens=np.arange(1, b + 1, dtype=np.int32),
                 lengths=np.full(b, 3, np.int32),
                 active=np.ones(b, np.int32),
                 temps=np.array([1.0, 1.0, 0.0, 0.0], np.float32),
                 top_ks=np.zeros(b, np.int32),
                 remaining=np.full(b, 50, np.int32),
                 stops=np.full((b, 8), -1, np.int32),
                 spec=np.ones(b, np.int32))
    propose = eng._propose_programs.by_width[1]
    verify = eng._verify_programs.by_width[1]
    assert propose.graph is not None and verify.graph is not None
    # a block of its own per row in both pools (a zero table would send
    # every row to the shared sink block)
    rows = torch.arange(1, b + 1, dtype=torch.int32, device=cuda)[:, None]
    propose.table.copy_(rows)
    verify.table.copy_(rows)
    drafts, emitted = [], []
    for _ in range(8):
        eng._state.load(**state)  # verify advances the state: restart it
        propose()
        drafts.append(eng._drafted.T.tolist())
        emitted.append(verify().T.tolist())
    for rows, kind in ((slice(0, 2), "sampled"), (slice(2, 4), "greedy")):
        d = {str(x[rows]) for x in drafts}
        e = {str(x[rows]) for x in emitted}
        if kind == "sampled":
            assert len(d) > 1 and len(e) > 1
        else:
            assert len(d) == 1 and len(e) == 1


def _flash_inputs(dev, s, group, hkv=2, b=1, d=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(h):
        return torch.randn((b * h, s, d), generator=g, device=dev,
                           dtype=torch.bfloat16)

    return randn(hkv * group), randn(hkv), randn(hkv), randn(hkv * group)


def _ratio(got, want, tol):
    return ((got.float() - want.float()).abs() / tol).max().item()


def _check_flash(q3, k3, v3, do, causal, group):
    s = q3.shape[1]
    kw = dict(scale=128 ** -0.5, causal=causal, n_rep=group)
    f0, b0 = fa.fwd_launches, fa.bwd_launches
    o, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    # the backward kernels and the plain backward take the same O and LSE
    grads = fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)
    ref = fa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (f0 + 1, b0 + 1)
    assert o.dtype == torch.bfloat16 and lse.shape == (q3.shape[0], s)
    tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    assert _ratio(o, ro, tol["o"]) <= 1
    assert _ratio(lse, rlse, tol["lse"]) <= 1
    for name, got, want, inp in zip(("dq", "dk", "dv"), grads, ref, (q3, k3, v3)):
        # written in bf16, one rounding of each fp32 sum
        assert got.dtype == torch.bfloat16 and got.shape == inp.shape, name
        assert torch.isfinite(got).all(), name
        assert _ratio(got, want, tol[name]) <= 1, name
    # no atomics: the same inputs give the same bits
    again = fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert torch.equal(o, fa.flash_attention_fwd(q3, k3, v3, **kw)[0])


@pytest.mark.parametrize("s", [128, 1024, 2048])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(cuda, causal, group, s):
    _check_flash(*_flash_inputs(cuda, s, group), causal, group)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain_at_the_moe_shape(cuda, causal):
    # the MoE step's attention (Mixtral-8x7B heads): 32 q / 8 kv heads, S 2048
    _check_flash(*_flash_inputs(cuda, 2048, 4, hkv=8, b=2), causal, 4)


def test_flash_tolerance_catches_one_dropped_key(cuda):
    # the last key feeds only the last query row, and only the last query
    # row feeds the last key: the kernels run without the last key's V (O
    # misses one of 2048 terms), without its K (dQ misses one of 2048) and
    # without the last dO row (dK and dV miss their only term) must break
    # the tolerance there.  One key's term in a row of 2048 is about one
    # bf16 ulp of dQ, which the gradients are written in, so the check runs
    # over 128 q heads (the smoke's count), as the largest term of them
    s, group = 2048, 4
    q3, k3, v3, do = _flash_inputs(cuda, s, group, b=16)
    kw = dict(scale=128 ** -0.5, causal=True, n_rep=group)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    rdq, rdk, rdv = fa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse, do, **kw)
    v_cut = v3.clone()
    v_cut[:, -1] = 0
    o, _ = fa.flash_attention_fwd(q3, k3, v_cut, **kw)
    assert _ratio(o[:, -1], ro[:, -1], tol["o"][:, -1]) > 1
    k_cut = k3.clone()
    k_cut[:, -1] = 0
    dq, _, _ = fa.flash_attention_bwd(q3, k_cut, v3, ro, rlse, do, **kw)
    assert _ratio(dq[:, -1], rdq[:, -1], tol["dq"][:, -1]) > 1
    do_cut = do.clone()
    do_cut[:, -1] = 0
    _, dk, dv = fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do_cut, **kw)
    assert _ratio(dk[:, -1], rdk[:, -1], tol["dk"][:, -1]) > 1
    assert _ratio(dv[:, -1], rdv[:, -1], tol["dv"][:, -1]) > 1


def test_flash_tolerance_catches_a_dropped_block_of_keys(cuda):
    # at 8 q heads, where one dropped key's term in dQ is about one bf16
    # ulp: the last 16 keys feed only the last 16 query rows.  Without
    # their V (O), their K (dQ) or those rows' dO (dK, dV) the kernels are
    # off by several times the tolerance there (the plain versions, cut
    # the same way on the CPU, reach 13-57 x)
    s, group, n = 2048, 4, 16
    q3, k3, v3, do = _flash_inputs(cuda, s, group)
    kw = dict(scale=128 ** -0.5, causal=True, n_rep=group)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    rdq, rdk, rdv = fa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse, do, **kw)

    def cut(t):
        t = t.clone()
        t[:, -n:] = 0
        return t

    def ratio(got, want, name):
        return _ratio(got[:, -n:], want[:, -n:], tol[name][:, -n:])

    o, _ = fa.flash_attention_fwd(q3, k3, cut(v3), **kw)
    dq, _, _ = fa.flash_attention_bwd(q3, cut(k3), v3, ro, rlse, do, **kw)
    _, dk, dv = fa.flash_attention_bwd(q3, k3, v3, ro, rlse, cut(do), **kw)
    assert ratio(o, ro, "o") > 4
    assert ratio(dq, rdq, "dq") > 4
    assert ratio(dk, rdk, "dk") > 4
    assert ratio(dv, rdv, "dv") > 4


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    q3, k3, v3, do = _flash_inputs(cuda, 128, 2)
    kw = dict(scale=0.1, causal=True, n_rep=2)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention_fwd(q3.float(), k3, v3, **kw)
    with pytest.raises(ValueError, match="no kernel for torch.float16"):
        fa.flash_attention_fwd(q3.half(), k3.half(), v3.half(), **kw)
    for d in (96, 64):  # the kernels are built for head_dim 128 and 256
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(q3[..., :d].contiguous(), k3[..., :d].contiguous(),
                                   v3[..., :d].contiguous(), **kw)
    with pytest.raises(ValueError, match="sequence"):
        fa.flash_attention_fwd(q3[:, :96].contiguous(), k3[:, :96].contiguous(),
                               v3[:, :96].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q3.transpose(1, 2).contiguous().transpose(1, 2),
                               k3, v3, **kw)
    o, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q3, k3, v3, o, lse.double(), do, **kw)


def test_attention_gate_on_the_card(cuda):
    from ray_tpu_torch.ops.attention import multi_head_attention

    g = torch.Generator(device=cuda).manual_seed(0)

    def rand(s, h, d, dtype=torch.bfloat16):
        return torch.randn((2, s, h, d), generator=g, device=cuda, dtype=dtype)

    before = fa.fwd_launches
    out = multi_head_attention(rand(128, 4, 128), rand(128, 2, 128),
                               rand(128, 2, 128))
    assert fa.fwd_launches == before + 1 and out.shape == (2, 128, 4, 128)
    # outside the gate: the reference, no launch
    multi_head_attention(rand(128, 4, 64), rand(128, 2, 64), rand(128, 2, 64))
    assert fa.fwd_launches == before + 1
    # forced onto a call the kernels cannot take: raises, never the reference
    with pytest.raises(ValueError, match="128"):
        multi_head_attention(rand(128, 4, 64), rand(128, 2, 64),
                             rand(128, 2, 64), use_flash=True)
    # fp32 at head_dim 128 reaches the FFMA kernel (ROADMAP C1); fp16
    # reaches none and raises, naming the built set
    f32 = fa.launches["fp32_d128"][0]
    out = multi_head_attention(*(rand(128, h, 128, torch.float32)
                                 for h in (4, 2, 2)))
    assert fa.launches["fp32_d128"][0] == f32 + 1 and out.dtype == torch.float32
    with pytest.raises(ValueError, match="no flash kernel is built"):
        multi_head_attention(*(rand(128, h, 128, torch.float16) for h in (4, 2, 2)),
                             use_flash=True)


# ROADMAP C1: the FFMA family (csrc/flash_attention_ffma.cu) at the fp32
# instantiations; the head_dim-256 wgmma pair (csrc/flash_attention_d256.cu)
# at bf16 and head_dim 256
FFMA = [n for n in fa.INSTANTIATIONS.values() if n.startswith("fp32")]


def _ffma_inputs(dev, name, s, group, hkv=2, b=1, seed=0):
    dtype = torch.float32 if name.startswith("fp32") else torch.bfloat16
    d = int(name.split("_d")[1])
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(h):
        return torch.randn((b * h, s, d), generator=g, device=dev,
                           dtype=dtype)

    return randn(hkv * group), randn(hkv), randn(hkv), randn(hkv * group)


def _check_instantiation(dev, name, causal, group, s):
    """The kernels of instantiation ``name`` against the plain versions:
    within ``kernel_tolerance``, outputs in the inputs' dtype, one launch
    each booked under ``name`` (B2/B3's own counters untouched), and the
    same bits from the same inputs."""
    q3, k3, v3, do = _ffma_inputs(dev, name, s, group)
    d = q3.shape[-1]
    kw = dict(scale=d ** -0.5, causal=causal, n_rep=group)
    f0, b0 = fa.launches[name]
    b2 = (fa.fwd_launches, fa.bwd_launches)
    o, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    grads = fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)
    ref = fa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse, do, **kw)
    torch.cuda.synchronize()
    assert fa.launches[name] == [f0 + 1, b0 + 1]
    assert (fa.fwd_launches, fa.bwd_launches) == b2
    assert o.dtype == q3.dtype and lse.dtype == torch.float32
    tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    assert _ratio(o, ro, tol["o"]) <= 1
    assert _ratio(lse, rlse, tol["lse"]) <= 1
    for key, got, want, inp in zip(("dq", "dk", "dv"), grads, ref,
                                   (q3, k3, v3)):
        assert got.dtype == inp.dtype and got.shape == inp.shape, key
        assert torch.isfinite(got).all(), key
        assert _ratio(got, want, tol[key]) <= 1, key
    # no atomics: the same inputs give the same bits
    again = fa.flash_attention_bwd(q3, k3, v3, ro, rlse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert torch.equal(o, fa.flash_attention_fwd(q3, k3, v3, **kw)[0])


def _check_dropped_block(dev, name):
    # the last 16 keys feed only the last 16 query rows: without their V
    # (O), their K (dQ) or those rows' dO (dK, dV) the kernels break the
    # tolerance there
    s, group, n = 2048, 4, 16
    q3, k3, v3, do = _ffma_inputs(dev, name, s, group)
    kw = dict(scale=q3.shape[-1] ** -0.5, causal=True, n_rep=group)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    rdq, rdk, rdv = fa.flash_attention_bwd_reference(q3, k3, v3, ro, rlse,
                                                     do, **kw)

    def cut(t):
        t = t.clone()
        t[:, -n:] = 0
        return t

    def ratio(got, want, key):
        return _ratio(got[:, -n:], want[:, -n:], tol[key][:, -n:])

    o, _ = fa.flash_attention_fwd(q3, k3, cut(v3), **kw)
    dq, _, _ = fa.flash_attention_bwd(q3, cut(k3), v3, ro, rlse, do, **kw)
    _, dk, dv = fa.flash_attention_bwd(q3, k3, v3, ro, rlse, cut(do), **kw)
    assert ratio(o, ro, "o") > 4
    assert ratio(dq, rdq, "dq") > 4
    assert ratio(dk, rdk, "dk") > 4
    assert ratio(dv, rdv, "dv") > 4


@pytest.mark.parametrize("name", FFMA)
@pytest.mark.parametrize("s", [128, 2048])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ffma_flash_kernels_match_plain(cuda, causal, group, s, name):
    _check_instantiation(cuda, name, causal, group, s)


@pytest.mark.parametrize("name", FFMA)
def test_ffma_flash_tolerance_catches_a_dropped_block_of_keys(cuda, name):
    _check_dropped_block(cuda, name)


@pytest.mark.parametrize("name", FFMA)
@pytest.mark.parametrize("causal", [True, False])
def test_ffma_flash_kernels_at_an_odd_tile_count_and_group_2(cuda, causal,
                                                             name):
    """S = 384: three 128-row tiles (the backward's 64- or 32-row resident
    tiles and 32-row streamed tiles end off a 128 boundary); two q heads a
    kv head, so a fault in the per-q-head dK/dV shares or their group sum
    shows."""
    _check_instantiation(cuda, name, causal, 2, 384)


@pytest.mark.parametrize("name", FFMA)
@pytest.mark.parametrize("causal", [True, False])
def test_ffma_forward_at_an_odd_q_tile_count_and_batch_2(cuda, causal, name):
    """The FFMA forward at S = 384 over two batch rows, four q heads a kv
    head: three 128-row q tiles at D 128 (six 64-row ones at D 256), the
    causal diagonal crossing four 32-key tiles of each; within the
    tolerance, the same bits again, and without the last key's V the last
    query row breaks it."""
    q3, k3, v3, do = _ffma_inputs(cuda, name, 384, 4, b=2, seed=3)
    kw = dict(scale=q3.shape[-1] ** -0.5, causal=causal, n_rep=4)
    o, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, do, **kw)
    assert _ratio(o, ro, tol["o"]) <= 1
    assert _ratio(lse, rlse, tol["lse"]) <= 1
    assert torch.equal(o, fa.flash_attention_fwd(q3, k3, v3, **kw)[0])
    v_cut = v3.clone()
    v_cut[:, -1] = 0
    o_cut, _ = fa.flash_attention_fwd(q3, k3, v_cut, **kw)
    assert _ratio(o_cut[:, -1], ro[:, -1], tol["o"][:, -1]) > 1


@pytest.mark.parametrize("s", [128, 2048])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_d256_flash_kernels_match_plain(cuda, causal, group, s):
    _check_instantiation(cuda, "bf16_d256", causal, group, s)


def test_d256_flash_tolerance_catches_a_dropped_block_of_keys(cuda):
    _check_dropped_block(cuda, "bf16_d256")


def _train_step_runs(dev, name):
    """Three steps of a config whose attention the gate sends to the flash
    kernels of instantiation ``name``: every layer's forward, recompute
    and backward launch them, and the losses are finite and fall."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel import make_train_step

    d = int(name.split("_d")[1])
    dtype = torch.float32 if name.startswith("fp32") else torch.bfloat16
    cfg = LlamaConfig.tiny(dim=4 * d, n_heads=4, n_kv_heads=2,
                           max_seq_len=256, compute_dtype=dtype)
    assert cfg.head_dim == d
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    before = list(fa.launches[name])
    losses = []
    for _ in range(3):
        state, metrics = step_fn(state, tokens)
        losses.append(float(metrics["loss"]))
    assert fa.launches[name] == [before[0] + 3 * 2 * cfg.n_layers,
                                 before[1] + 3 * cfg.n_layers]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["fp32_d128", "fp32_d256"])
def test_fp32_train_step_runs_the_ffma_kernels(cuda, name):
    """ROADMAP C1: make_train_step takes an fp32-compute config whose
    attention the gate sends to the flash kernels, and every layer's
    forward, recompute and backward launch the FFMA kernels."""
    _train_step_runs(cuda, name)


def test_bf16_d256_train_step_runs_the_wgmma_pair(cuda):
    _train_step_runs(cuda, "bf16_d256")


def test_train_step_runs_the_flash_kernels(cuda):
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel import make_train_step

    cfg = LlamaConfig.tiny(dim=512, n_heads=4, n_kv_heads=2, max_seq_len=256,
                           compute_dtype=torch.bfloat16)
    assert cfg.head_dim == 128
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    fa.fwd_launches = fa.bwd_launches = 0
    losses = []
    for _ in range(3):
        state, metrics = step_fn(state, tokens)
        losses.append(float(metrics["loss"]))
    # remat recomputes every layer's forward in the backward pass
    assert fa.fwd_launches == 3 * 2 * cfg.n_layers
    assert fa.bwd_launches == 3 * cfg.n_layers
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert int(metrics["step"]) == 3


# (M, K, N, group sizes): E 4 and 8; empty groups, groups smaller than a
# 128-row tile, boundaries inside tiles; K and N small, not multiples of
# the tiles, and the Mixtral widths 4096 and 14336 both ways round; one
# case whose sizes sum to less than M (the rest of the rows are zeros).
# Then the kernels' edges: a group that starts at an odd row and ends
# inside a 64-row stage (M not a multiple of 128); M smaller than one
# tile; 64 groups, most of them empty; one group holding every row, so
# every work item has the same group.  Last, K 200 and N 264: multiples of
# 8 that end inside the fp32 kernels' 16-deep stage and 256-column tile,
# with groups that end inside a stage (rows 5 and 125) and one of no rows
GMM_CASES = [
    (512, 256, 384, [100, 0, 290, 122]),
    (1000, 136, 200, [0, 7, 500, 3, 0, 300, 190, 0]),
    (300, 64, 72, [100, 150]),
    (2048, 4096, 14336, [300, 0, 1, 700, 47, 500, 200, 300]),
    (2048, 14336, 4096, [300, 0, 1, 700, 47, 500, 200, 300]),
    (777, 192, 320, [33, 45, 600, 99]),
    (50, 64, 264, [17, 0, 33]),
    (1500, 128, 256, [0] * 3 + [500] + [0] * 13 + [1] + [0] * 22 + [700]
     + [0] * 22 + [299]),
    (1000, 256, 512, [1000]),
    (600, 200, 264, [5, 120, 0, 301, 150]),
]


def _gmm_inputs(dev, m, k, n, sizes, transpose_rhs=False, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    e = len(sizes)
    return (randn(m, k), randn(e, n, k) if transpose_rhs else randn(e, k, n),
            randn(m, n), torch.tensor(sizes, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("m,k,n,sizes", GMM_CASES)
def test_gmm_kernel_matches_plain(cuda, m, k, n, sizes, transpose_rhs):
    lhs, rhs, _, gs = _gmm_inputs(cuda, m, k, n, sizes, transpose_rhs)
    before = gm.gmm_launches
    out = gm.gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    assert gm.gmm_launches == before + 1
    ref = gm.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    torch.cuda.synchronize()
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    tol = gm.kernel_tolerance("gmm", lhs, rhs, gs, transpose_rhs=transpose_rhs)
    assert _ratio(out, ref, tol) <= 1
    assert not out[sum(sizes):].any()
    # no atomics: the same inputs give the same bits
    assert torch.equal(out, gm.gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs))


@pytest.mark.parametrize("m,k,n,sizes", GMM_CASES)
def test_tgmm_kernel_matches_plain(cuda, m, k, n, sizes):
    lhs, _, grad, gs = _gmm_inputs(cuda, m, k, n, sizes)
    before = gm.tgmm_launches
    out = gm.tgmm(lhs.t(), grad, gs)
    assert gm.tgmm_launches == before + 1
    ref = gm.tgmm_reference(lhs.t(), grad, gs)
    torch.cuda.synchronize()
    assert out.shape == (len(sizes), k, n)
    for g, size in enumerate(sizes):
        if size == 0:  # an empty group is written, as zeros
            assert not out[g].any()
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, gs)
    assert _ratio(out, ref, tol) <= 1
    assert torch.equal(out, gm.tgmm(lhs.t(), grad, gs))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("op", ["gmm", "tgmm"])
def test_a_neighbouring_groups_inf_stays_out(cuda, op, dtype):
    # group 2's rows hold inf in both operands.  Group 1 ends inside a
    # 64-row (bf16) or 16-row (fp32) stage and inside a 128-row tile, so
    # its last tgmm stage and its last gmm tile load group 2's rows: the
    # tgmm kernels must zero them in both tiles (a zero in one alone still
    # gives 0 * inf = nan), and gmm must keep them to their own rows.
    # Groups 0, 1 and 3 stay exact.
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = [100, 77, 200, 135]
    inputs = _gmm_inputs_fp32 if dtype == "fp32" else _gmm_inputs
    lhs, rhs, grad, gs = inputs(cuda, 512, 192, 320, sizes)
    lhs[177:377] = float("inf")
    grad[177:377] = float("inf")
    if op == "gmm":
        out = gm.gmm(lhs, rhs, gs)
        ref = gm.gmm_reference(lhs, rhs, gs)
        tol = gm.kernel_tolerance("gmm", lhs, rhs, gs)
        keep = torch.ones(512, dtype=torch.bool, device=cuda)
        keep[177:377] = False
    else:
        out = gm.tgmm(lhs.t(), grad, gs)
        ref = gm.tgmm_reference(lhs.t(), grad, gs)
        tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, gs)
        keep = torch.tensor([0, 1, 3], device=cuda)
    torch.cuda.synchronize()
    assert torch.isfinite(out[keep]).all()
    assert _ratio(out[keep], ref[keep], tol[keep]) <= 1


def test_grouped_matmul_tolerance_catches_a_moved_and_a_dropped_row(cuda):
    sizes = [1000, 0, 2500, 596]
    lhs, rhs, grad, gs = _gmm_inputs(cuda, 4096, 4096, 4096, sizes)
    # gmm: row 3500, the first of group 3, computed with group 2's rhs
    ref = gm.gmm_reference(lhs, rhs, gs)
    tol = gm.kernel_tolerance("gmm", lhs, rhs, gs)
    moved = gs.clone()
    moved[2] += 1
    moved[3] -= 1
    cut = gm.gmm(lhs, rhs, moved)
    assert _ratio(cut[3500], ref[3500], tol[3500]) > 1
    keep = torch.ones(4096, dtype=torch.bool, device=cuda)
    keep[3500] = False
    assert _ratio(cut[keep], ref[keep], tol[keep]) <= 1
    # tgmm: the last row of group 2 left out of its sum
    ref = gm.tgmm_reference(lhs.t(), grad, gs)
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, gs)
    cut_grad = grad.clone()
    cut_grad[3499] = 0
    cut = gm.tgmm(lhs.t(), cut_grad, gs)
    assert _ratio(cut[2], ref[2], tol[2]) > 1
    assert _ratio(cut[[0, 1, 3]], ref[[0, 1, 3]], tol[[0, 1, 3]]) <= 1


def test_grouped_matmul_kernels_refuse_what_they_do_not_take(cuda):
    lhs, rhs, grad, gs = _gmm_inputs(cuda, 256, 64, 64, [100, 156])
    # fp16 has no built kernel: a CUDA tensor of it raises, never falls
    # back to the plain version (fp32 launches the FFMA kernels)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        gm.gmm(lhs.half(), rhs.half(), gs)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        gm.tgmm(lhs.half().t(), grad.half(), gs)
    with pytest.raises(ValueError, match="int32"):
        gm.gmm(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="group_sizes is on cpu"):
        gm.gmm(lhs, rhs, gs.cpu())
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.gmm(lhs[:, :60].contiguous(), rhs[:, :60].contiguous(), gs)
    with pytest.raises(ValueError, match="transpose of a contiguous"):
        gm.tgmm(lhs.t().contiguous(), grad, gs)
    with pytest.raises(ValueError, match="1 to 64 groups"):
        gm.gmm(lhs, torch.zeros((65, 64, 64), dtype=torch.bfloat16, device=cuda),
               torch.zeros(65, dtype=torch.int32, device=cuda))


def _gmm_inputs_fp32(dev, m, k, n, sizes, transpose_rhs=False, seed=0):
    return tuple(t.float() if t.is_floating_point() else t
                 for t in _gmm_inputs(dev, m, k, n, sizes, transpose_rhs, seed))


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("m,k,n,sizes", GMM_CASES)
def test_fp32_gmm_kernel_matches_plain(cuda, m, k, n, sizes, transpose_rhs):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32
    lhs, rhs, _, gs = _gmm_inputs_fp32(cuda, m, k, n, sizes, transpose_rhs)
    before = gm.gmm_fp32_launches, gm.gmm_launches
    out = gm.gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    assert (gm.gmm_fp32_launches, gm.gmm_launches) == (before[0] + 1,
                                                        before[1])
    ref = gm.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    torch.cuda.synchronize()
    assert out.shape == (m, n) and out.dtype == torch.float32
    tol = gm.kernel_tolerance("gmm", lhs, rhs, gs, transpose_rhs=transpose_rhs)
    assert _ratio(out, ref, tol) <= 1
    assert not out[sum(sizes):].any()
    assert torch.equal(out, gm.gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs))


@pytest.mark.parametrize("m,k,n,sizes", GMM_CASES)
def test_fp32_tgmm_kernel_matches_plain(cuda, m, k, n, sizes):
    torch.backends.cuda.matmul.allow_tf32 = False
    lhs, _, grad, gs = _gmm_inputs_fp32(cuda, m, k, n, sizes)
    before = gm.tgmm_fp32_launches
    out = gm.tgmm(lhs.t(), grad, gs)
    assert gm.tgmm_fp32_launches == before + 1
    ref = gm.tgmm_reference(lhs.t(), grad, gs)
    torch.cuda.synchronize()
    assert out.shape == (len(sizes), k, n) and out.dtype == torch.float32
    for g, size in enumerate(sizes):
        if size == 0:
            assert not out[g].any()
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, gs)
    assert _ratio(out, ref, tol) <= 1
    assert torch.equal(out, gm.tgmm(lhs.t(), grad, gs))


def test_fp32_grouped_matmul_tolerance_catches_a_moved_and_a_dropped_row(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = [1000, 0, 2500, 596]
    lhs, rhs, grad, gs = _gmm_inputs_fp32(cuda, 4096, 1024, 1024, sizes)
    ref = gm.gmm_reference(lhs, rhs, gs)
    tol = gm.kernel_tolerance("gmm", lhs, rhs, gs)
    moved = gs.clone()
    moved[2] += 1
    moved[3] -= 1
    cut = gm.gmm(lhs, rhs, moved)
    assert _ratio(cut[3500], ref[3500], tol[3500]) > 1
    keep = torch.ones(4096, dtype=torch.bool, device=cuda)
    keep[3500] = False
    assert _ratio(cut[keep], ref[keep], tol[keep]) <= 1
    ref = gm.tgmm_reference(lhs.t(), grad, gs)
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, gs)
    cut_grad = grad.clone()
    cut_grad[3499] = 0
    cut = gm.tgmm(lhs.t(), cut_grad, gs)
    assert _ratio(cut[2], ref[2], tol[2]) > 1
    assert _ratio(cut[[0, 1, 3]], ref[[0, 1, 3]], tol[[0, 1, 3]]) <= 1


def test_fp32_moe_train_step_runs_the_ffma_grouped_matmuls(cuda):
    from ray_tpu_torch.parallel import make_train_step

    cfg = _moe_cfg(compute_dtype=torch.float32)
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    gm.gmm_fp32_launches = gm.tgmm_fp32_launches = gm.gmm_launches = 0
    losses = []
    for _ in range(2):
        state, metrics = step_fn(state, tokens)
        losses.append(float(metrics["loss"]))
    assert all(math.isfinite(x) for x in losses)
    # 3 gmm forward + 3 dlhs gmm and 3 tgmm backward per layer; remat
    # recomputes the forward's 3
    assert gm.gmm_fp32_launches == 2 * cfg.n_layers * 9
    assert gm.tgmm_fp32_launches == 2 * cfg.n_layers * 3
    assert gm.gmm_launches == 0


def _moe_cfg(**kw):
    from ray_tpu_torch.models.moe import MoEConfig

    kw.setdefault("compute_dtype", torch.bfloat16)
    return MoEConfig.tiny(dim=512, n_heads=4, n_kv_heads=2, ffn_dim=1024,
                          n_experts=8, max_seq_len=256, **kw)


def test_moe_train_step_runs_the_grouped_matmul_kernels(cuda):
    from ray_tpu_torch.parallel import make_train_step

    cfg = _moe_cfg()
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    gm.gmm_launches = gm.tgmm_launches = fa.fwd_launches = 0
    losses = []
    for _ in range(3):
        state, metrics = step_fn(state, tokens)
        losses.append(float(metrics["loss"]))
    # per layer: 3 products in the forward, 3 in the recompute, 3 dlhs;
    # 3 weight gradients
    assert gm.gmm_launches == 3 * 9 * cfg.n_layers
    assert gm.tgmm_launches == 3 * 3 * cfg.n_layers
    assert fa.fwd_launches == 3 * 2 * cfg.n_layers
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def test_moe_block_makes_no_host_sync(cuda):
    from ray_tpu_torch.models import moe

    cfg = _moe_cfg()
    lp = {k: v[0] for k, v in moe.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)["layers"].items()}
    x = torch.randn((2, 256, cfg.dim), device=cuda, dtype=torch.bfloat16)
    moe.moe_block_ragged(cfg, x, lp)  # build and load the kernels first
    torch.cuda.synchronize()
    before = gm.gmm_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_block_ragged(cfg, x, lp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert gm.gmm_launches == before + 3
    assert torch.isfinite(y).all() and torch.isfinite(aux)


# -- the training-step slice: the gradient codec, remat, snapshots ------------


def test_codec_on_the_card_equals_the_numpy_codec(cuda):
    from ray_tpu_torch.util.collective import compression as comp

    # 4,096 blocks of magnitudes over 2**-20..2**20, so that a scale or a
    # code rounded another way than the host's shows
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096 * 256 + 77)
         * np.exp2(rng.uniform(-20, 20, 4096 * 256 + 77))).astype(np.float32)
    x[256:512] = 0.0  # a zero block; the last block is padded
    x[0], x[1:5] = 127.0, [0.5, 1.5, 2.5, -2.5]  # scale 1, ties to even
    x[5:256] = rng.uniform(-1, 1, 251).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(x).to(cuda, dtype)
        want_codes, want_scales = comp.quantize_blocks(t.float().cpu().numpy())
        padded = torch.nn.functional.pad(t, (0, (-t.numel()) % 256))
        codes, scales = comp.torch_quantize_blocks(padded)
        assert codes.is_cuda and scales.is_cuda
        np.testing.assert_array_equal(codes.cpu().numpy(), want_codes)
        np.testing.assert_array_equal(scales.cpu().numpy().view(np.uint32),
                                      want_scales.view(np.uint32))
        back = comp.torch_dequantize_blocks(codes, scales)[:x.size]
        np.testing.assert_array_equal(
            back.cpu().numpy().view(np.uint32),
            comp.dequantize_blocks(want_codes, want_scales, x.size)
            .view(np.uint32))
    assert codes[1:5].tolist() == [0, 2, 2, -2]


def test_staging_keeps_the_bytes_of_save_time(cuda, tmp_path):
    from ray_tpu_torch.train._internal import snapshot

    state = {"w": torch.randn((4096, 1024), device=cuda),
             "b": torch.randn((333,), device=cuda, dtype=torch.bfloat16),
             "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    before = {k: v.clone() for k, v in state.items()}
    mgr = snapshot.SnapshotManager(str(tmp_path))
    try:
        mgr.save(state)
        for v in state.values():  # in place, right after save(), same stream
            v.add_(1)
        assert mgr.wait(60)
    finally:
        mgr.close()
    assert mgr.last_error is None
    restored = snapshot.restore_snapshot(
        str(tmp_path / snapshot.snapshot_dir_name(1)), target=state)
    for k, v in restored.items():
        assert v.is_cuda and v.dtype == before[k].dtype
        assert torch.equal(v, before[k]), k


def test_remat_policies_give_the_full_gradients_on_the_card(cuda):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.train_step import tree_leaves

    grads, launches = {}, {}
    for policy in ("full", "attn", "dots"):
        cfg = llama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1,
                                     max_seq_len=256, remat_policy=policy,
                                     compute_dtype=torch.bfloat16)
        params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                                   cuda, llama.train_param_dtypes(cfg))
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(1))
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        fa.fwd_launches = fa.bwd_launches = 0
        grads[policy] = torch.autograd.grad(llama.loss_fn(cfg, params, tokens),
                                            leaves)
        launches[policy] = (fa.fwd_launches, fa.bwd_launches)
    L = cfg.n_layers
    assert launches == {"full": (2 * L, L), "attn": (L, L), "dots": (2 * L, L)}
    for policy in ("attn", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads[policy], grads["full"]))
