"""The port's serving classes on the card, where their threads meet CUDA
graphs: ``LLMServer`` warms its engine in the constructor and serves four
threads, with B1's launches booked per replay; a stream is exported
mid-decode while the loop goes on replaying; an adapter engine is built
and captured in a caller's thread while a base stream decodes.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch, numpy and ray_tpu_torch, so it runs
where JAX is not installed (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_serve.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import (
    GenerationConfig,
    LLMConfig,
    LLMServer,
    LoRAConfig,
    init_lora,
    make_engine,
)
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the server's engines run on it")
    return torch.device("cuda")


def _conf(dtype=torch.bfloat16, **kw):
    """Two layers at head_dim 128, GQA group 2 (B1 takes a bf16 pool)."""
    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=512, max_seq_len=512,
                           param_dtype=dtype, compute_dtype=dtype)
    return LLMConfig(model_config=cfg, **{
        "max_batch_size": 4, "max_seq_len": 512, "block_size": 16,
        "prefill_chunk": 64, "decode_chunk": 4, "num_blocks": 160, **kw})


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, n).tolist() for n in lens]


def _in_threads(fn, args):
    out, errs = [None] * len(args), []

    def run(i):
        try:
            out[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    return out


def test_server_warms_in_its_constructor_and_serves_four_threads(cuda):
    srv = LLMServer(_conf(), generator=torch.Generator(device=cuda).manual_seed(1))
    try:
        eng = srv._engine
        assert eng._use_kernel and eng._programs.graphs
        # warm before any request: every decode width and chunk width
        assert sorted(eng._programs.by_width) == [1, 2, 4, 8, 16, 32]
        assert sorted(eng._prefill_programs.by_width) == [16, 32, 64]
        assert all(p.graph is not None for p in eng._programs.by_width.values())
        steps0, pa.launches = eng.decode_steps, 0
        prompts = _prompts(2, (30, 70, 130, 9))
        got = _in_threads(lambda p: srv.generate(p, max_new_tokens=40),
                          [(p,) for p in prompts])
        assert all(len(t) == 40 and all(0 <= x < 256 for x in t) for t in got)
        steps = eng.decode_steps - steps0
        assert steps > 0 and pa.launches == 2 * steps  # 2 layers a step
        assert sorted(eng._programs.by_width) == [1, 2, 4, 8, 16, 32]
        u = srv.utilization()
        assert u["slots"]["active"] == 0
        assert u["kv_blocks"]["free"] == u["kv_blocks"]["total"]
    finally:
        srv.shutdown()
    assert not srv._loop.is_alive()


def test_export_mid_decode_while_the_loop_replays(cuda):
    """Three streams decode from graphs; one is exported from the main
    thread while the loop keeps stepping (the export's drain and copies
    go on the server's stream behind the in-flight chunk), imported into
    a second server and resumed.  fp32 (the table gather, graphs all the
    same; B1 takes bf16 pools only): every stream, stitched or not,
    equals its tokens from an engine that ran it alone."""
    conf = _conf(dtype=torch.float32, paged_attention_kernel=False)
    g = torch.Generator(device=cuda).manual_seed(3)
    src = LLMServer(conf, generator=g)
    dst = LLMServer(conf, params=src._engine.params)
    try:
        prompts = _prompts(4, (40, 25, 60))
        ref = make_engine(conf, params=src._engine.params)
        want = [ref.generate([p], GenerationConfig(max_new_tokens=80))[0]
                for p in prompts]
        cols = [[] for _ in prompts]

        def consume(i):
            for chunk in src.generate_stream(prompts[i], max_new_tokens=80):
                cols[i].extend(chunk)

        # a micro engine's step takes about a millisecond: 10 ms of host
        # time a step keeps the stream mid-decode while this thread
        # exports it (the loop still steps: it is not parked)
        step = src._engine.step
        src._engine.step = lambda decode=True: (time.sleep(0.01),
                                                step(decode))[1]
        threads = [threading.Thread(target=consume, args=(i,)) for i in (1, 2)]
        for t in threads:
            t.start()
        wkey = src._submit(None, prompts[0], GenerationConfig(max_new_tokens=80))
        deadline = time.monotonic() + 60
        while len(src._waiters.get(wkey, [])) < 8:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert wkey[2] in src.migratable_streams()
        h = src.export_stream(wkey[2])  # the loop is not parked
        assert 8 <= len(h["emitted"]) < 80
        res = dst.import_migration(h)
        assert res["mode"] == "import"
        cont = [t for c in dst.resume_stream(res["wkey"]) for t in c]
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert [h["emitted"] + cont] + cols[1:] == want
        assert src.utilization()["kv_blocks"]["free"] == 159
    finally:
        src.shutdown()
        dst.shutdown()


def test_adapter_build_while_a_base_stream_decodes(cuda):
    """The adapter engine's warm-up (its graphs captured in the calling
    thread) runs while the loop replays the base engine's graphs for a
    400-token stream: no capture error, the base stream gets every token,
    base chunks arrive during the build, and the adapter serves."""
    conf = _conf()
    g = torch.Generator(device=cuda).manual_seed(5)
    cfg = conf.model_config
    adapter = init_lora(cfg, LoRAConfig(rank=4), g)
    for ab in adapter["layers"].values():
        ab["B"].normal_(0.0, 0.02, generator=g)
    srv = LLMServer(conf, lora_adapters={"tuned": adapter}, generator=g)
    try:
        times, toks = [], []

        def base():
            for chunk in srv.generate_stream(_prompts(6, (20,))[0],
                                             max_new_tokens=400):
                times.append(time.perf_counter())
                toks.extend(chunk)

        t = threading.Thread(target=base)
        t.start()
        while len(toks) < 8:
            time.sleep(0.001)
        t0 = time.perf_counter()
        out = srv.generate(_prompts(7, (33,))[0], max_new_tokens=16,
                           model="tuned")
        t1 = time.perf_counter()
        t.join(300)
        assert not t.is_alive() and srv._error is None
        assert len(toks) == 400 and len(out) == 16
        eng = srv._engines["tuned"]
        assert all(p.graph is not None for p in eng._programs.by_width.values())
        assert sorted(eng._programs.by_width) == [1, 2, 4, 8, 16, 32]
        during = [b - a for a, b in zip(times, times[1:]) if t0 <= b <= t1]
        assert during, "no base chunk arrived during the adapter's build"
        print(f"adapter build and first request {t1 - t0:.2f} s; base "
              f"stream's longest gap between chunks meanwhile "
              f"{max(during) * 1e3:.1f} ms over {len(during)} chunks")
    finally:
        srv.shutdown()
