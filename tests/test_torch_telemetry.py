"""The port's device telemetry against the JAX package's.

Each case of ``tests/test_device_telemetry.py`` that does not read JAX's
devices runs on both modules with the same inputs, and the port must give
the reference's numbers: duty and spend math, the transient clamp, the
exact fold headroom, the weakref prune, the key shape, hand-computed MFU,
the disabled path that books nothing, and the storm report.  Then the
port's own parts: HBM rows that say they come from no card here, the
capture sites as the compile watch's feed, the paged and static engines'
``utilization()`` beside the JAX engines' at the same state (slots, KV
blocks and the queue equal), and a disaggregated local app's fold.
Occupancy is compared exactly: the rows are the autoscaler's input.
"""

import gc
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import device_telemetry as jdt
from ray_tpu._private import runtime_metrics as jrtm
from ray_tpu._private.config import global_config as jglobal_config
from ray_tpu_torch import convert
from ray_tpu_torch._private import device_telemetry as tdt
from ray_tpu_torch._private import runtime_metrics as trtm
from ray_tpu_torch._private.config import global_config as tglobal_config

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

SIDES = {"jax": (jdt, jrtm, jglobal_config),
         "torch": (tdt, trtm, tglobal_config)}


@pytest.fixture
def reset_telemetry():
    for dt, _, _ in SIDES.values():
        dt._reset_for_tests()
    yield
    for dt, _, _ in SIDES.values():
        dt._reset_for_tests()


def _both(case):
    """``case(dt, rtm, global_config)`` on the reference and the port."""
    return {name: case(*mods) for name, mods in SIDES.items()}


# ---------------------------------------------------------------------------
# the copied math, case by case
# ---------------------------------------------------------------------------


def _duty_case(dt, rtm, gc_):
    tel = dt.EngineTelemetry("dep-math", weights_bytes=100, kv_pool_bytes=50,
                             clock=lambda: 100.0, flush_interval_s=1e9)
    out = []
    for kw in (dict(active_slots=3, free_blocks=20, pending=2,
                    prefill_spent=64, prefill_budget=256, busy_s=0.5,
                    now=101.0),
               dict(active_slots=8, free_blocks=0, pending=5,
                    prefill_spent=0, prefill_budget=256, busy_s=5.0,
                    now=102.0),
               dict(active_slots=1, free_blocks=30, pending=0,
                    prefill_spent=0, prefill_budget=0, busy_s=0.1,
                    now=112.0)):
        tel.note_step(max_slots=8, total_blocks=31, **kw)
        out.append((tel.duty_cycle, tel.rates()))
    return out


def test_engine_telemetry_duty_and_spend_math():
    got = _both(_duty_case)
    assert got["torch"] == got["jax"]
    (d0, r0), (d1, r1), (d2, r2) = got["torch"]
    assert d0 == 0.5 and r0["prefill_spend_ratio"] == 0.25
    assert r0["prefill_spent_tokens"] == 64 and r0["steps"] == 1
    assert d1 == 1.0 and r1["prefill_spend_ratio"] == 0.0  # busy > wall
    assert d2 == pytest.approx(0.01)  # an idle gap depresses it exactly
    assert r2["prefill_spend_ratio"] == 0.0  # budget 0: no division


@pytest.mark.parametrize("used", [1000, 100])
def test_hbm_split_transient_clamped(monkeypatch, used):
    def case(dt, rtm, gc_):
        monkeypatch.setattr(dt, "device_used_bytes", lambda: used)
        return dt.EngineTelemetry("dep-hbm", weights_bytes=300,
                                  kv_pool_bytes=200, clock=lambda: 0.0,
                                  flush_interval_s=1e9).hbm_split()

    got = _both(case)
    assert got["torch"] == got["jax"]
    assert got["torch"]["transient_bytes"] == max(0, used - 500)


_FOLD_ROWS = [
    {"deployment": "dep", "replica": "r1", "duty_cycle": 0.25,
     "slots": {"active": 3, "max": 8, "free": 5},
     "kv_blocks": {"total": 31, "free": 20, "used": 11}},
    {"deployment": "dep", "replica": "r2", "duty_cycle": 0.75,
     "slots": {"active": 5, "max": 8, "free": 3},
     "kv_blocks": {"total": 31, "free": 10, "used": 21}},
    {"deployment": "other", "replica": "r3",
     "slots": {"active": 0, "max": 4, "free": 4},
     "kv_blocks": {"total": 15, "free": 15, "used": 0}},
]


def test_fold_utilization_rows_headroom_exact(reset_telemetry):
    got = _both(lambda dt, *_: dt.fold_utilization_rows(_FOLD_ROWS))
    for snap in got.values():
        snap.pop("time")
    assert got["torch"] == got["jax"]
    d = got["torch"]["deployments"]["dep"]
    assert d["free_slots"] == d["total_slots"] - d["active_slots"] == 8
    assert d["free_kv_blocks"] == 30 and d["total_kv_blocks"] == 62
    assert d["mean_duty_cycle"] == pytest.approx(0.5)
    assert got["torch"]["deployments"]["other"]["mean_duty_cycle"] == 0.0


def test_local_provider_registry_weakref_prune(reset_telemetry):
    class FakeEngine:
        def utilization(self):
            return {"deployment": "weak-dep",
                    "slots": {"active": 1, "max": 2, "free": 1},
                    "kv_blocks": {"total": 7, "free": 7, "used": 0}}

    for dt, _, _ in SIDES.values():
        eng = FakeEngine()
        dt.register_utilization_object("weak-dep:0", eng)
        rows = dt.local_utilization_rows()
        assert [(r["replica"], r["source"]) for r in rows] == [
            ("weak-dep:0", "local")]
        del eng
        gc.collect()
        assert dt.local_utilization_rows() == []
        with dt._providers_lock:
            assert "weak-dep:0" not in dt._providers


def test_util_kv_key_shape():
    got = _both(lambda dt, *_: (dt.util_kv_key("app", "dep", "abc123"),
                                dt.UTIL_KV_PREFIX))
    assert got["torch"] == got["jax"] == ("util:app/dep/abc123", "util:")


def test_mfu_matches_hand_computed_flops_over_wall():
    def case(dt, rtm, gc_):
        mfu = dt.note_train_step("mfu-test-run", model_flops=2e9, wall_s=0.5,
                                 peak=1e12)
        booked = rtm.device_telemetry_snapshot()["train_mfu"]["mfu-test-run"]
        return (mfu, booked,
                dt.note_train_step("r", model_flops=0, wall_s=1.0),
                dt.note_train_step("r", model_flops=1e9, wall_s=0.0),
                dt.note_serving_rate("rate-dep", 1000.0, n_chips=4))

    got = _both(case)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == pytest.approx(2e9 / 0.5 / 1e12)
    assert got["torch"][1:] == (pytest.approx(2e9 / 0.5 / 1e12), 0.0, 0.0,
                                250.0)


def test_mfu_needs_the_cards_own_peak(monkeypatch):
    """No TPU figure and no nominal CPU figure: off a known card the port
    reports no MFU and books nothing."""
    assert tdt.peak_flops("cpu") is None
    assert tdt.peak_flops() is None  # no card on this box
    before = json.dumps(trtm.device_telemetry_snapshot(), sort_keys=True)
    assert tdt.note_train_step("no-peak", model_flops=1e12, wall_s=1.0) is None
    assert json.dumps(trtm.device_telemetry_snapshot(),
                      sort_keys=True) == before
    # the H100 by name, and no other card's figure for an unknown one
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tdt.peak_flops("cuda:0") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert tdt.peak_flops("cuda:0") is None


def test_model_flops_counts_the_family_analytically():
    from ray_tpu_torch.models import llama, moe

    cfg = llama.LlamaConfig.tiny()
    assert tdt.model_flops(cfg, 2048, seq_len=128) == 2048 * llama.flops_per_token(
        cfg, 128)
    mcfg = moe.MoEConfig.tiny()
    assert tdt.model_flops(mcfg, 10, seq_len=64, training=False) == pytest.approx(
        10 * moe.flops_per_token(mcfg, 64) / 3)


def test_disabled_path_books_nothing(reset_telemetry):
    def case(dt, rtm, global_config):
        cfg = global_config()
        saved = cfg.device_telemetry_enabled
        cfg.device_telemetry_enabled = False
        try:
            before = json.dumps(rtm.device_telemetry_snapshot(),
                                sort_keys=True)
            assert dt.engine_telemetry_for("some-dep") is None
            dt.record_hbm()
            dt.note_train_step("off-run", model_flops=1e12, wall_s=1.0,
                               peak=1e15)
            dt.note_serving_rate("off-dep", 500.0)
            dt.note_trace("off-program", shape_key=(1,))
            dt._watch.note_compile("off-program", 0.25)
            after = json.dumps(rtm.device_telemetry_snapshot(),
                               sort_keys=True)
            return before == after, dt.trace_count("off-program")
        finally:
            cfg.device_telemetry_enabled = saved

    got = _both(case)
    assert got["torch"] == got["jax"] == (True, 1)
    assert tdt.engine_telemetry_for(None) is None


def test_storm_report_names_churning_program(reset_telemetry):
    def case(dt, rtm, gc_):
        dt.note_trace("tel.test.quiet", shape_key=(2, 64))
        for i in range(6):  # shape churn: a new width every call
            dt.note_trace("tel.test.shape_churn", shape_key=(2, 64 + i))
        dt._watch.note_compile(None, 0.125)
        report = dt.storm_report(threshold=5, window_s=60.0)
        quiet = (dt.storm_report(threshold=7, window_s=60.0),
                 dt.storm_report(threshold=1, window_s=1e-9))
        return report, quiet, dt.compile_snapshot()

    got = _both(case)
    for name in ("jax", "torch"):
        report, quiet, snap = got[name]
        assert [r["program"] for r in report] == ["tel.test.shape_churn"]
        row = report[0]
        assert (row["compiles"], row["total_traces"],
                len(row["shape_keys"])) == (6, 6, 6)
        assert "test_torch_telemetry.py" in row["callers"]
        assert quiet == ([], [])
        assert snap["compiles"] == {"_jax": 1}  # unattributed: the sentinel
    strip = ({k: v for k, v in r.items() if k != "callers"}
             for r in (got["jax"][0][0], got["torch"][0][0]))
    assert next(strip) == next(strip)


def test_heartbeat_pushes_without_step_traffic(monkeypatch):
    pushes = []
    monkeypatch.setattr(tdt, "_heartbeat_push",
                        lambda: pushes.append(time.monotonic()))
    cfg = tglobal_config()
    saved = cfg.device_telemetry_heartbeat_s
    cfg.device_telemetry_heartbeat_s = 0.05
    try:
        tdt._start_heartbeat()
        with tdt._hb_lock:
            t = tdt._hb_thread
        assert t is not None and t.daemon and t.is_alive()
        deadline = time.monotonic() + 8.0
        while len(pushes) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(pushes) >= 3
    finally:
        cfg.device_telemetry_heartbeat_s = saved


# ---------------------------------------------------------------------------
# the port's own: HBM rows, tensor bytes, captures as compiles
# ---------------------------------------------------------------------------


def test_hbm_rows_say_no_card_answered():
    """This box has no CUDA context: one row whose source says so, and no
    device bytes that a dashboard could read as allocator truth."""
    rows = tdt.hbm_snapshot()
    assert rows == [{"device": "cpu", "kind": "cpu", "used_bytes": 0,
                     "limit_bytes": 0, "peak_bytes": 0, "source": "cpu"}]
    assert tdt.device_used_bytes() == 0


def test_hbm_rows_read_this_processs_allocator(monkeypatch):
    """On a card: allocated bytes (not the card's used bytes) and the
    card's total, one row per device, from torch.cuda."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 123, "allocated_bytes.all.peak": 456,
        "reserved_bytes.all.current": 999})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (7, 80))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "H100")
    assert tdt.hbm_snapshot() == [{
        "device": "cuda:0", "kind": "H100", "used_bytes": 123,
        "limit_bytes": 80, "peak_bytes": 456, "source": "torch.cuda"}]
    tel = tdt.EngineTelemetry("d", weights_bytes=100, kv_pool_bytes=20,
                              clock=lambda: 0.0, flush_interval_s=1e9)
    assert tel.hbm_split()["transient_bytes"] == 3


def test_tree_nbytes_sums_tensor_bytes():
    tree = {"a": torch.zeros((4, 8), dtype=torch.bfloat16),
            "b": [torch.zeros(3), (torch.zeros(2, dtype=torch.int64), None)],
            "c": 5}
    assert tdt.tree_nbytes(tree) == 64 + 12 + 16


class _FakeGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_captures_feed_the_compile_watch(monkeypatch, reset_telemetry):
    """A capture is the port's compile: each program width captured once
    books one trace and one compile under the program's name; a replay
    books nothing; enough widths in the window make a storm."""
    from ray_tpu_torch.llm import engine as tengine

    monkeypatch.setattr(tengine, "_capture_graph",
                        lambda fn, pool, stream, gen: _FakeGraph(fn))
    state = tengine._LoopState(2, torch.device("cpu"))
    calls = []
    progs = tengine._Programs(lambda st, **kw: calls.append(kw), state, 1,
                              True, torch.Generator().manual_seed(0),
                              name="test.decode")
    progs.get(8)()
    progs.get(8)()
    assert tdt.trace_count("test.decode") == 1
    snap = tdt.compile_snapshot()
    assert snap["compiles"] == {"test.decode": 1}
    assert snap["compile_seconds"]["test.decode"] >= 0
    for w in (16, 32, 64, 128):
        progs.get(w)
    report = tdt.storm_report(threshold=5, window_s=60.0)
    assert [r["program"] for r in report] == ["test.decode"]
    assert report[0]["shape_keys"] == sorted(
        repr(w) for w in (8, 16, 32, 64, 128))


# ---------------------------------------------------------------------------
# engines: utilization() beside the JAX engines' at the same state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def micro():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl

    kw = dict(vocab_size=48, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
              ffn_dim=64, max_seq_len=48)
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, **kw)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tl.LlamaConfig.tiny(**kw)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def _occupancy(u):
    return u["slots"], u["kv_blocks"], u["pending"]


def test_paged_engine_utilization_matches_the_jax_engines(micro,
                                                          reset_telemetry):
    from ray_tpu.llm import GenerationConfig as JGen
    from ray_tpu.llm import LLMConfig as JLLMConfig
    from ray_tpu.llm import PagedJaxLLMEngine
    from ray_tpu_torch.llm import paged as tpaged
    from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig

    jcfg, jp, tcfg, tp = micro
    kw = dict(max_batch_size=2, max_seq_len=48, block_size=8,
              prefill_chunk=16, decode_chunk=4, num_blocks=24)
    jeng = PagedJaxLLMEngine(JLLMConfig(model_config=jcfg, **kw), params=jp)
    teng = tpaged.PagedTorchLLMEngine(LLMConfig(model_config=tcfg, **kw),
                                      params=tp, device="cpu")
    jeng.slo_label = teng.slo_label = "tel-paged"
    assert teng._telemetry is not None
    prompts = [list(np.random.RandomState(s).randint(1, 47, size=9))
               for s in (0, 1, 2)]
    for p in prompts:
        jeng.add_request(p, JGen(max_new_tokens=6))
        teng.add_request(p, GenerationConfig(max_new_tokens=6))
    assert _occupancy(teng.utilization()) == _occupancy(jeng.utilization())
    for _ in range(3):
        jeng.step()
        teng.step()
        assert _occupancy(teng.utilization()) == _occupancy(
            jeng.utilization())
    u = teng.utilization()
    with teng._lock:
        active = sum(1 for r in teng._slot_req if r is not None)
        free = teng.blocks.num_free()
    assert u["engine"] == "paged" and u["deployment"] == "tel-paged"
    assert u["slots"] == {"active": active, "max": 2, "free": 2 - active}
    assert u["kv_blocks"] == {"total": 23, "free": free, "used": 23 - free}
    assert 0.0 <= u["duty_cycle"] <= 1.0 and u["rates"]["steps"] == 3
    assert set(u) == set(jeng.utilization()) - {"tp"}
    hbm = u["hbm"]
    assert hbm["weights_bytes"] == tdt.tree_nbytes(teng.params)
    assert hbm["kv_pool_bytes"] == tdt.tree_nbytes(teng.pool)
    assert hbm["transient_bytes"] >= 0
    # the local fold (what state.utilization() serves with no cluster)
    from ray_tpu_torch.util import state

    d = state.utilization()["deployments"]["tel-paged"]
    assert (d["active_slots"], d["free_slots"], d["free_kv_blocks"],
            d["total_kv_blocks"]) == (active, 2 - active, free, 23)
    assert state.utilization("no-such-dep")["deployments"] == {}
    # the same requests end in the same books
    while jeng.has_work():
        jeng.step()
    while teng.has_work():
        teng.step()
    assert _occupancy(teng.utilization()) == _occupancy(jeng.utilization())


def test_static_engine_utilization_headroom(micro, reset_telemetry):
    from ray_tpu.llm import JaxLLMEngine
    from ray_tpu.llm import LLMConfig as JLLMConfig
    from ray_tpu_torch.llm import engine as tengine
    from ray_tpu_torch.llm.config import LLMConfig

    jcfg, jp, tcfg, tp = micro
    kw = dict(kv_cache="static", max_batch_size=3, max_seq_len=48)
    jeng = JaxLLMEngine(JLLMConfig(model_config=jcfg, **kw), params=jp)
    teng = tengine.TorchLLMEngine(LLMConfig(model_config=tcfg, **kw),
                                  params=tp, device="cpu")
    jeng.slo_label = teng.slo_label = "tel-static"
    u = teng.utilization()
    assert _occupancy(u) == _occupancy(jeng.utilization())
    assert u["engine"] == "static" and u["deployment"] == "tel-static"
    assert u["slots"] == {"active": 0, "max": 3, "free": 3}
    assert u["kv_blocks"] == {"total": 3, "free": 3, "used": 0}
    teng.add_request([1, 2, 3], tengine.GenerationConfig(max_new_tokens=5))
    teng.step()
    u = teng.utilization()
    assert u["slots"]["active"] == 1 and u["rates"]["steps"] == 1
    assert u["hbm"]["kv_pool_bytes"] == tdt.tree_nbytes(teng.cache)


def test_disagg_local_app_utilization_fold(micro, reset_telemetry):
    """state.utilization() on a live disaggregated local app: both stage
    deployments fold with rows exact to their engines' books."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_disagg_llm_deployment
    from ray_tpu_torch.llm.config import LLMConfig
    from ray_tpu_torch.util import state

    _, _, tcfg, tp = micro
    lcfg = LLMConfig(model_config=tcfg, max_batch_size=2, max_seq_len=48,
                     block_size=8, prefill_chunk=16, decode_chunk=4,
                     num_blocks=24)
    app = build_disagg_llm_deployment(lcfg, tp, name="dtel", device="cpu")
    h = serve.run(app, name="dtel-app", _local_testing_mode=True)
    try:
        prompt = list(np.random.RandomState(3).randint(1, 47, size=11))
        out = h.generate.remote(prompt=prompt,
                                max_new_tokens=4).result(timeout_s=120)
        assert len(out) == 4
        deps = state.utilization()["deployments"]
        assert "dtel-prefill" in deps and "dtel-decode" in deps
        for dep in deps.values():
            assert dep["replicas"]
            assert dep["free_slots"] == dep["total_slots"] - dep["active_slots"]
            for row in dep["replicas"]:
                s, b = row["slots"], row["kv_blocks"]
                assert s["free"] == s["max"] - s["active"]
                assert b["used"] == b["total"] - b["free"]
                assert 0.0 <= row["duty_cycle"] <= 1.0
        pre = deps["dtel-prefill"]["replicas"][0]
        assert pre["rates"]["prefill_spent_tokens"] == len(prompt)
        assert pre["rates"]["prefill_budget_tokens"] == 16
    finally:
        serve.delete("dtel-app")


# ---------------------------------------------------------------------------
# the pool autoscaler's default headroom source reads the fold
# ---------------------------------------------------------------------------


def test_pool_shrinks_through_the_default_headroom_source(reset_telemetry):
    """The controller's headroom source (``utilization_headroom``) reads
    the utilization fold's mean duty cycle: a pool whose replicas report
    a low duty cycle gives back a replica once its alert is clear and its
    cooldown has passed; a busy pool does not."""
    from ray_tpu_torch._private.config import RayTpuConfig
    from ray_tpu_torch.serve._private.pool_autoscaler import (
        PoolAutoscaler,
        utilization_headroom,
    )

    class Replica:
        def __init__(self, duty):
            self.duty = duty

        def utilization(self):
            return {"deployment": "llm-decode", "duty_cycle": self.duty,
                    "slots": {"active": 1, "max": 8, "free": 7},
                    "kv_blocks": {"total": 63, "free": 60, "used": 3}}

    replicas = [Replica(0.1), Replica(0.2)]
    for i, r in enumerate(replicas):
        tdt.register_utilization_object(f"llm-decode:{i}", r)
    assert utilization_headroom("llm-decode") == pytest.approx(0.15)
    assert utilization_headroom("llm-prefill") is None  # nobody reported

    now = [1000.0]
    counts = {"llm-decode": 2}
    sc = PoolAutoscaler(
        actuate=counts.__setitem__, current=counts.__getitem__,
        config=RayTpuConfig(serve_pool_scale_cooldown_s=30.0,
                            serve_pool_max_replicas=8),
        clock=lambda: now[0], headroom_source=utilization_headroom)
    alert = {"rule": "serve_itl_burn", "key": "deployment=llm",
             "value": 5.0, "threshold": 1.0, "severity": "WARNING",
             "time": 0.0, "description": ""}
    sc.on_alert(dict(alert, state="firing"))
    assert counts["llm-decode"] == 3
    sc.on_alert(dict(alert, state="cleared"))
    now[0] += 31.0
    sc.tick()
    assert counts["llm-decode"] == 2  # clear, cooled down, idle: shrinks
    for r in replicas:
        r.duty = 0.9
    now[0] += 31.0
    sc.tick()
    assert counts["llm-decode"] == 2  # busy: no shrink
    assert sc.snapshot()["actuations"][-1]["reason"].startswith(
        "alert clear, duty 0.15")
