"""Live KV migration through the port's ``LLMServer`` relay (``_splice``,
``_finish_migrated``, ``evacuate_streams``) over the copied
``serve/_private/kv_migration.py``, on the CPU: the server-layer cases of
``tests/test_kv_migration.py``.  Every stream's tokens equal the JAX
package's paged engine's on the same weights.

- a stream migrated mid-decode to another server: its consumer sees no
  interruption, the source's slot and blocks free, every phase booked;
- the export's drain costs a bystander stream no token;
- the chaos fault at each phase falls back with zero drops;
- a full engine of live streams drained with zero drops;
- a destination that dies mid-relay degrades to local recompute;
- an import retried under the same ``mig_id`` returns the first stream;
- an export racing the step that ends its stream leaves the stream whole;
- a recompute whose history ends the budget exactly resumes as done;
- across replica processes: a deployment scaled from two replicas to one
  by ``serve.run``, whose controller drains the extra replica by
  migrating its live streams to the survivor.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.llm import GenerationConfig as JGen
from ray_tpu.llm import LLMConfig as JLLMConfig
from ray_tpu.llm import PagedJaxLLMEngine
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert, serve
from ray_tpu_torch._private import runtime_metrics
from ray_tpu_torch._private.config import global_config
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.serve import LLMServer
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve._private import kv_migration
from ray_tpu_torch.util.metrics import collect_cluster

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

pytestmark = pytest.mark.timeout(240)

# fp32 micro model: resume parity must not hinge on bf16 rounding order
_CFG_KW = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=128, max_seq_len=96)
_ENGINE_KW = dict(max_batch_size=4, max_seq_len=96, block_size=8,
                  prefill_chunk=16, decode_chunk=4)
_NEW = 32
_MANY = 16


def _prompts(lens, seed):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(1, 63, size=n)] for n in lens]


# every prompt a test streams, by name
_PROMPTS = {
    "forced": _prompts([19], 21)[0],
    "bystanders": _prompts([11, 14, 17], 77),
    "chaos": _prompts([15, 16, 17, 18, 19], 31),
    "many": _prompts(range(4, 4 + _MANY), 5),
    "dying": _prompts([13], 41)[0],
    "retry": _prompts([12], 51)[0],
    "race": _prompts([14], 71)[0],
    "drain": _prompts([9, 10, 11, 12], 61),
}


@pytest.fixture(scope="module")
def micro():
    """(the port's weights, {prompt as a tuple: JAX's greedy tokens})."""
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                 tl.LlamaConfig.tiny(**_CFG_KW), device="cpu")
    flat = []
    for v in _PROMPTS.values():
        flat.extend(v if isinstance(v[0], list) else [v])
    ref = PagedJaxLLMEngine(
        JLLMConfig(model_config=jcfg, **{**_ENGINE_KW, "max_batch_size": 8}),
        params=jp)
    want = ref.generate(flat, JGen(max_new_tokens=_NEW))
    return tp, {tuple(p): w for p, w in zip(flat, want)}


def _conf(**kw):
    return LLMConfig(model_config=tl.LlamaConfig.tiny(**_CFG_KW),
                     **{**_ENGINE_KW, **kw})


@pytest.fixture(scope="module")
def servers(micro):
    """A source/destination pair, reused (every test leaves both idle)."""
    made = []
    try:
        made.append(LLMServer(_conf(), micro[0], device="cpu"))
        made.append(LLMServer(_conf(), micro[0], device="cpu"))
        yield tuple(made)
    finally:
        for s in made:
            s.shutdown()


def _outcome_delta(before, after):
    out = {}
    for k, v in after["outcomes"].items():
        d = v - before["outcomes"].get(k, 0.0)
        if d:
            out[k] = d
    return out


def _consume(server, prompt, collected, done):
    """A consumer thread iterating ``generate_stream`` into ``collected``."""
    def run():
        try:
            for chunk in server.generate_stream(prompt, max_new_tokens=_NEW):
                collected.extend(chunk)
        finally:
            done.set()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _wait_tokens(collected, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while len(collected) < n:
        assert time.monotonic() < deadline, (
            f"stream stalled at {len(collected)}/{n} tokens")
        time.sleep(0.005)


class _slow_steps:
    """Throttle the source engine's step so a migration catches its
    streams mid-decode (a micro engine steps in well under a
    millisecond)."""

    def __init__(self, server, delay=0.03):
        self._eng, self._delay = server._engine, delay

    def __enter__(self):
        orig, eng, delay = type(self._eng).step, self._eng, self._delay

        def slow(decode=True):
            time.sleep(delay)
            return orig(eng, decode)

        eng.step = slow
        return self

    def __exit__(self, *exc):
        del self._eng.step


class _frozen_loop:
    """Park the server's loop (it takes the engines lock every iteration):
    at most the in-flight step and the export's drain still resolve
    tokens.  Nothing on the migration path of a base-engine stream takes
    that lock."""

    def __init__(self, server):
        self._server = server

    def __enter__(self):
        self._server._engines_lock.acquire()

    def __exit__(self, *exc):
        self._server._engines_lock.release()


def test_forced_middecode_migration_zero_interruption(servers, micro):
    src, dst = servers
    prompt = _PROMPTS["forced"]
    before = runtime_metrics.kv_migration_snapshot()
    collected, done = [], threading.Event()
    with _slow_steps(src):
        t = _consume(src, prompt, collected, done)
        _wait_tokens(collected, 3)
        with _frozen_loop(src):
            out = src.evacuate_streams(dest_servers=[dst])
    assert out == {"migrated": 1, "fallback": 0, "skipped": 0}
    assert done.wait(120), "the migrated stream never finished"
    t.join(5)
    assert collected == micro[1][tuple(prompt)]
    with src._engine._lock:
        assert not src._engine._requests
        assert all(r is None for r in src._engine._slot_req)
    after = runtime_metrics.kv_migration_snapshot()
    assert _outcome_delta(before, after) == {("drain", "migrated"): 1.0}
    for phase in ("export", "transfer", "import", "splice", "total"):
        assert (after["phases"].get(phase, {}).get("count", 0)
                > before["phases"].get(phase, {}).get("count", 0)), phase


def test_export_drain_keeps_bystander_streams(servers, micro):
    """The export's drain resolves every slot's in-flight chunk; the
    reconcile after it must deliver that chunk to the bystanders too."""
    src, dst = servers
    prompts = _PROMPTS["bystanders"]
    cols = [[] for _ in prompts]
    dones = [threading.Event() for _ in prompts]
    with _slow_steps(src):
        threads = [_consume(src, p, c, d)
                   for p, c, d in zip(prompts, cols, dones)]
        for c in cols:
            _wait_tokens(c, 2)
        with _frozen_loop(src):
            rids = src.migratable_streams()
            assert len(rids) == 3
            out = kv_migration.migrate_stream(
                src, rids[0], [kv_migration.LocalDest(dst)])
    assert out == "migrated"
    for d, t in zip(dones, threads):
        assert d.wait(120), "a stream never finished"
        t.join(5)
    assert cols == [micro[1][tuple(p)] for p in prompts]


@pytest.mark.parametrize("i,fault", enumerate([
    "export:fail", "transfer:fail", "import:fail", "import:refuse",
    "splice:fail"]))
def test_chaos_fault_at_each_phase_falls_back(servers, micro, i, fault):
    """The stream keeps decoding on the source (export) or comes back by
    local restore (every later phase): a fallback, no token dropped."""
    src, dst = servers
    prompt = _PROMPTS["chaos"][i]
    before = runtime_metrics.kv_migration_snapshot()
    collected, done = [], threading.Event()
    cfg = global_config()
    with _slow_steps(src):
        t = _consume(src, prompt, collected, done)
        _wait_tokens(collected, 2)
        cfg.testing_migration_fault = fault
        try:
            with _frozen_loop(src):
                out = src.evacuate_streams(dest_servers=[dst])
        finally:
            cfg.testing_migration_fault = ""
    assert out == {"migrated": 0, "fallback": 1, "skipped": 0}
    assert done.wait(120), f"the stream never finished under {fault}"
    t.join(5)
    assert collected == micro[1][tuple(prompt)], fault
    assert _outcome_delta(before, runtime_metrics.kv_migration_snapshot()
                          ) == {("drain", "fallback"): 1.0}


def test_drain_many_live_streams_zero_drops(micro):
    """A full engine of live streams evacuated: each one migrated, restored
    locally or finished first (skipped), and none lost."""
    src = LLMServer(_conf(max_batch_size=_MANY), micro[0], device="cpu")
    dst = LLMServer(_conf(max_batch_size=_MANY), micro[0], device="cpu")
    try:
        prompts = _PROMPTS["many"]
        cols = [[] for _ in prompts]
        dones = [threading.Event() for _ in prompts]
        with _slow_steps(src, delay=0.01):
            threads = [_consume(src, p, c, d)
                       for p, c, d in zip(prompts, cols, dones)]
            for c in cols:
                _wait_tokens(c, 1, timeout=120)
            with _frozen_loop(src):
                out = src.evacuate_streams(dest_servers=[dst])
        assert set(out) == {"migrated", "fallback", "skipped"}
        assert out["migrated"] + out["fallback"] > 0
        for i, (d, t) in enumerate(zip(dones, threads)):
            assert d.wait(120), f"stream {i} never finished"
            t.join(5)
        assert cols == [micro[1][tuple(p)] for p in prompts]
        with src._engine._lock:
            assert not src._engine._requests, "the drain left source slots"
    finally:
        src.shutdown()
        dst.shutdown()


def test_dest_death_midrelay_degrades_to_local_recompute(servers, micro):
    src, dst = servers
    prompt = _PROMPTS["dying"]
    before = runtime_metrics.kv_migration_snapshot()

    class DyingDest(kv_migration.LocalDest):
        """Imports cleanly; its stream dies after the first chunk."""

        def resume_iter(self, wkey):
            inner = super().resume_iter(wkey)

            def gen():
                yield next(inner)
                inner.close()
                raise RuntimeError("destination replica died mid-relay")
            return gen()

    collected, done = [], threading.Event()
    with _slow_steps(src):
        t = _consume(src, prompt, collected, done)
        _wait_tokens(collected, 2)
        with _frozen_loop(src):
            rids = src.migratable_streams()
            assert len(rids) == 1
            outcome = kv_migration.migrate_stream(src, rids[0],
                                                  [DyingDest(dst)])
    assert outcome == "migrated"  # the phase machine saw a clean splice
    assert done.wait(120), "the stream never finished after the death"
    t.join(5)
    assert collected == micro[1][tuple(prompt)]
    # the clean migration, then the relay's fallback when the dest died
    assert _outcome_delta(before, runtime_metrics.kv_migration_snapshot()
                          ) == {("manual", "migrated"): 1.0,
                                ("manual", "fallback"): 1.0}


def test_import_is_idempotent_under_mig_id(servers, micro):
    src, dst = servers
    prompt = _PROMPTS["retry"]
    collected, done = [], threading.Event()
    with _slow_steps(src):
        t = _consume(src, prompt, collected, done)
        _wait_tokens(collected, 2)
        with _frozen_loop(src):
            rids = src.migratable_streams()
            h = src.export_stream(rids[0])
    h["mig_id"] = "retry-test-1"
    with dst._engine._lock:
        n0 = len(dst._engine._requests)
    r1 = dst.import_migration(dict(h))
    r2 = dst.import_migration(dict(h))  # the retry after a lost reply
    assert r1 is not None and r2 == r1
    with dst._engine._lock:
        assert len(dst._engine._requests) <= n0 + 1, "the retry forked it"
    src._splice(rids[0], dst.resume_stream(r1["wkey"]),
                lambda: dst.cancel_stream(r1["wkey"]), h)
    assert done.wait(120)
    t.join(5)
    assert collected == micro[1][tuple(prompt)]


def test_export_racing_the_last_step_leaves_the_stream_whole(servers,
                                                              micro):
    """An export that waits for the step lock while the loop's step ends
    its stream finds no request (the planner books it skipped), and the
    stream still gets its last tokens and its end.  (Marked migrating
    before taking the lock, as the reference marks it, the loop's apply
    would skip both, and the consumer would wait forever.)"""
    src, _ = servers
    prompt = _PROMPTS["race"]
    eng = src._engine
    ended, go, errors = threading.Event(), threading.Event(), []

    def step(decode=True):
        live = set(eng._requests)
        out = type(eng).step(eng, decode)
        gone = [r for r in live if r not in eng._requests and r in out]
        if gone and not ended.is_set():
            ended.rid = gone[0]
            ended.set()
            go.wait(10)
            time.sleep(0.2)  # the export is waiting for the step lock
        return out

    def export():
        try:
            src.export_stream(ended.rid)
        except KeyError as e:
            errors.append(e)

    collected, done = [], threading.Event()
    eng.step = step
    try:
        t = _consume(src, prompt, collected, done)
        assert ended.wait(60), "the stream never ended"
        exporter = threading.Thread(target=export, daemon=True)
        exporter.start()
        go.set()
        assert done.wait(60), "the stream hung short of its end"
        exporter.join(10)
        t.join(5)
    finally:
        del eng.step
    assert len(errors) == 1  # nothing left to export
    assert collected == micro[1][tuple(prompt)]
    assert not src._migrating


@pytest.mark.parametrize("stop", [False, True])
def test_recompute_at_the_budget_boundary_is_done(servers, stop):
    """A history that already ends the budget (or ends on a stop token)
    resumes as an empty continuation that is done, and the source's
    waiter finishes with the history alone."""
    src, _ = servers
    gen = {"max_new_tokens": 3, "temperature": 0.0, "top_k": 0, "seed": 0,
           "stop_token_ids": []}
    if stop:
        gen.update(max_new_tokens=10, stop_token_ids=[9])
    handoff = {"model": None, "prompt": [1, 2, 3], "first_token": 7,
               "emitted": [7, 8, 9], "mig_id": None, "gen": gen}
    out = src.import_migration(handoff, allow_recompute=True)
    assert out == {"wkey": None, "done": True, "mode": "recompute"}
    wkey = (None, 0, -1)
    with src._cv:
        src._migrating.add(wkey)
        src._waiters[wkey] = [7, 8, 9]
    src._finish_migrated(-1)
    assert list(src._iter_tokens(wkey)) == [[7, 8, 9]]
    assert wkey not in src._migrating


def _migration_outcomes():
    out = {}
    for m in collect_cluster():
        if m["name"] == "ray_tpu_serve_kv_migrations_total":
            key = (m["tags"].get("reason"), m["tags"].get("outcome"))
            out[key] = out.get(key, 0.0) + m["value"]
    return out


def _slow_server_class():
    """LLMServer whose engine steps take 0.1 s, so a drain catches its
    streams mid-decode (defined in a function: pickled by value)."""
    class SlowLLMServer(LLMServer):
        def __init__(self, *args, **kwargs):
            torch.set_num_threads(1)
            super().__init__(*args, **kwargs)
            eng = self._engine
            orig = type(eng).step

            def slow(decode=True):
                time.sleep(0.1)
                return orig(eng, decode)

            eng.step = slow

    return SlowLLMServer


def test_controller_drain_migrates_across_replicas(micro):
    """Two replicas, four streams spread over them, then ``serve.run`` at
    one replica: the controller drains the extra replica by migrating its
    streams to the survivor (not by waiting them out); every stream ends
    with JAX's tokens, and no outcome is ``lost``."""
    rt.init(num_cpus=4)
    try:
        dep = serve.deployment(_slow_server_class(), name="llm",
                               num_replicas=2, max_ongoing_requests=8)
        args = (_conf(decode_chunk=2), micro[0])
        handle = serve.run(dep.bind(*args, device="cpu"), name="mig")
        prompts = _PROMPTS["drain"]
        got = [[] for _ in prompts]

        def run(i):
            for chunk in handle.options(stream=True).generate_stream.remote(
                    prompts[i], max_new_tokens=_NEW):
                got[i].extend(chunk)

        threads = []
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=run, args=(i,),
                                            daemon=True))
            threads[-1].start()
            # the stream is counted on its replica once its first chunk
            # came; past the router's probe TTL, pow-2 then spreads them
            _wait_tokens(got[i], 1)
            time.sleep(0.3)
        busy = [r["ongoing"] for r in serve.status()["mig"]["replicas"]]
        assert busy[1] > 0, f"no stream on the replica to drain: {busy}"
        before = _migration_outcomes()
        # the same bound arguments at one replica: a scale-down, not a
        # new version, so the extra replica drains into the survivor
        serve.run(dep.options(num_replicas=1).bind(*args, device="cpu"),
                  name="mig")
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert got == [micro[1][tuple(p)] for p in prompts]
        deadline = time.monotonic() + 60
        while len(serve.status()["mig"]["replicas"]) != 1:
            assert time.monotonic() < deadline, "the replica never drained"
            time.sleep(0.1)
        after = _migration_outcomes()
        moved = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after}
        moved = {k: v for k, v in moved.items() if v}
        assert moved, "the drain migrated nothing"
        assert set(moved) <= {("drain", "migrated"), ("drain", "fallback")}
        assert 0 < sum(moved.values()) <= busy[1]
    finally:
        serve.shutdown()
        rt.shutdown()
