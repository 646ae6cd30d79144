"""The port's state API and timeline against the JAX package's.

One scenario runs on each runtime in this process (``ray_tpu.init``, then
``ray_tpu_torch.init``, on the CPU): three tasks and an actor's two calls,
the state listings and summaries, ``timeline()``, and serving in process
under a deployment label -- three requests through an ``LLMServer`` and
two through a ``PrefillServer`` -> ``DecodeServer`` handoff -- then
``serving_slo()``, ``utilization()`` and ``goodput()``.  The two must
give rows of the same keys, the same task summary, the same timeline
event shapes, the same SLO stage names and counts for the same requests,
and the same occupancy.  Durations are not compared.  Then the port's
own: a torch.profiler capture of a worker through ``state.profile`` and
the compile watch in ``state.diagnose()``.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import device_telemetry as jdt
from ray_tpu.llm import disagg as jdisagg
from ray_tpu.llm import serve as jserve
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu.serve._private import slo as jslo
from ray_tpu.util import state as jstate
from ray_tpu_torch import convert
from ray_tpu_torch._private import device_telemetry as tdt
from ray_tpu_torch.llm import disagg as tdisagg
from ray_tpu_torch.llm import serve as tserve
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve._private import slo as tslo
from ray_tpu_torch.util import state as tstate

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

pytestmark = pytest.mark.timeout(300)

_CFG_KW = dict(vocab_size=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
               ffn_dim=64, max_seq_len=64)
_ENGINE_KW = dict(max_batch_size=2, max_seq_len=64, block_size=8,
                  prefill_chunk=16, decode_chunk=4, num_blocks=32)
_PROMPTS = [[int(t) for t in np.random.RandomState(s).randint(1, 63, n)]
            for s, n in ((0, 9), (1, 20), (2, 5))]


def _weights():
    jcfg = jl.LlamaConfig.tiny(**_CFG_KW, compute_dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tl.LlamaConfig.tiny(**_CFG_KW)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _scenario(rt, state, slo, dt, servers):
    """Run the scenario on runtime ``rt``; returns what the tests read."""
    slo.reset_ledger()
    dt._reset_for_tests()
    rt.init(num_cpus=2)
    try:
        @rt.remote
        def square(x):
            return x * x

        @rt.remote
        class Acc:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        assert rt.get([square.remote(i) for i in range(3)]) == [0, 1, 4]
        acc = Acc.remote()
        assert rt.get([acc.add.remote(1), acc.add.remote(2)]) == [1, 3]
        deadline = time.monotonic() + 30
        while True:
            summary = state.summarize_tasks()
            done = {k: v for k, v in summary.items()
                    if k.endswith(("square", "add"))}
            if (sum(v.get("FINISHED", 0) for v in done.values()) >= 5
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
        tasks = state.list_tasks()
        actors = state.list_actors()
        events = rt.timeline()

        monolithic, make_pre, make_dec = servers
        srv = monolithic()
        srv.set_slo_label("state-dep")
        try:
            outs = [srv.generate(p, max_new_tokens=4) for p in _PROMPTS]
            util = state.utilization("state-dep")
        finally:
            srv.shutdown()
        pre, dec = make_pre(), make_dec()
        pre.set_slo_label("state-pre")
        dec.set_slo_label("state-dec")
        try:
            for p in _PROMPTS[:2]:
                h = pre.prefill(p, max_new_tokens=4)
                outs.append(dec.decode_from_handoff(h, max_new_tokens=4))
        finally:
            dec.shutdown()
        slo.get_ledger().maybe_publish(force=True)
        report = state.serving_slo()
        return dict(summary=done, tasks=tasks, actors=actors, events=events,
                    outs=outs, util=util, report=report,
                    goodput=state.goodput())
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def observed():
    """{"jax": ..., "torch": ...}: the scenario on each runtime."""
    (jcfg, jp), (tcfg, tp) = _weights()
    jconf = JLLMConfig(model_config=jcfg, **_ENGINE_KW)
    tconf = LLMConfig(model_config=tcfg, **_ENGINE_KW)
    out = {"jax": _scenario(ray_tpu, jstate, jslo, jdt, (
        lambda: jserve.LLMServer(jconf, jp),
        lambda: jdisagg.PrefillServer(jconf, jp),
        lambda: jdisagg.DecodeServer(jconf, jp)))}
    out["torch"] = _scenario(ray_tpu_torch, tstate, tslo, tdt, (
        lambda: tserve.LLMServer(tconf, tp, device="cpu"),
        lambda: tdisagg.PrefillServer(tconf, tp, device="cpu"),
        lambda: tdisagg.DecodeServer(tconf, tp, device="cpu")))
    return out


def _ours(rows):
    return [r for r in rows if str(r.get("name", "")).endswith(
        ("square", "add"))]


def test_the_same_requests_give_the_same_tokens(observed):
    assert observed["torch"]["outs"] == observed["jax"]["outs"]


def test_list_tasks_rows_have_the_references_keys(observed):
    got = {n: _ours(o["tasks"]) for n, o in observed.items()}
    assert len(got["torch"]) == len(got["jax"]) == 5
    assert ({tuple(sorted(r)) for r in got["torch"]}
            == {tuple(sorted(r)) for r in got["jax"]})
    assert (sorted((r["name"], r["state"]) for r in got["torch"])
            == sorted((r["name"], r["state"]) for r in got["jax"]))


def test_summarize_tasks_counts_as_the_reference(observed):
    assert observed["torch"]["summary"] == observed["jax"]["summary"]
    assert sum(v["FINISHED"] for v in observed["torch"]["summary"].values()) == 5


def test_list_actors_rows_have_the_references_keys(observed):
    rows = {n: [a for a in o["actors"] if a.get("class_name", "").endswith("Acc")]
            for n, o in observed.items()}
    assert len(rows["torch"]) == len(rows["jax"]) == 1
    assert sorted(rows["torch"][0]) == sorted(rows["jax"][0])
    assert rows["torch"][0]["state"] == rows["jax"][0]["state"]


def _event_shapes(events):
    return sorted((e["ph"], e["cat"], e["name"].rsplit(".", 1)[-1],
                   tuple(sorted(e)), tuple(sorted(e.get("args", {}))))
                  for e in events
                  if e["name"].endswith(("square", "add"))
                  or e["cat"] == "task_flow")


def test_timeline_events_match_the_references(observed):
    """One execute slice and one submit slice per call, each flow arrow a
    pair, with the reference's keys; the events are a Chrome trace."""
    got = {n: _event_shapes(o["events"]) for n, o in observed.items()}
    assert got["torch"] == got["jax"]
    execute = [e for e in observed["torch"]["events"]
               if e["ph"] == "X" and e["cat"] in ("task", "actor_task")
               and e["name"].endswith(("square", "add"))]
    assert len(execute) == 5 and all(e["dur"] >= 0 for e in execute)
    json.dumps(observed["torch"]["events"])


def test_timeline_writes_a_chrome_trace_file(tmp_path):
    ray_tpu_torch.init(num_cpus=1)
    try:
        @ray_tpu_torch.remote
        def slow():
            time.sleep(0.05)
            return 1

        ray_tpu_torch.get([slow.remote() for _ in range(2)])
        out = tmp_path / "trace.json"
        deadline = time.monotonic() + 10
        while True:
            events = [e for e in ray_tpu_torch.timeline(str(out))
                      if e["name"].endswith("slow") and e["cat"] == "task"]
            if len(events) == 2 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert len(events) == 2
        assert all(e["dur"] >= 0.04 * 1e6 for e in events)
        assert json.loads(out.read_text())
    finally:
        ray_tpu_torch.shutdown()
    with pytest.raises(RuntimeError, match="init"):
        ray_tpu_torch.timeline()


def _stages(report):
    """The scenario's deployments' stage counts (the stage sketches are
    process-wide metrics: other tests in this process book their own)."""
    return {dep: {stage: s["count"] for stage, s in d["stages"].items()}
            for dep, d in report["deployments"].items()
            if dep in ("state-dep", "state-pre", "state-dec")}


def test_serving_slo_books_the_references_stages(observed):
    got = {n: _stages(o["report"]) for n, o in observed.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["state-dep"] == {"queue_wait": 3, "prefill": 3,
                                         "decode": 3}
    # the disaggregated pair: the prefill stage's engine books admission
    # and prefill, the decode stage the handoff and the decode
    assert got["torch"]["state-pre"] == {"queue_wait": 2, "prefill": 2}
    assert got["torch"]["state-dec"] == {"handoff": 2, "decode": 2}


def test_utilization_folds_the_servers_engine_as_the_reference(observed):
    rows = {n: o["util"]["deployments"]["state-dep"]
            for n, o in observed.items()}
    for key in ("active_slots", "total_slots", "free_slots",
                "free_kv_blocks", "total_kv_blocks"):
        assert rows["torch"][key] == rows["jax"][key], key
    assert sorted(rows["torch"]) == sorted(rows["jax"])
    row = rows["torch"]["replicas"][0]
    assert row["deployment"] == "state-dep" and row["source"] == "local"
    assert row["hbm"]["weights_bytes"] > 0
    assert 0.0 <= row["duty_cycle"] <= 1.0


def test_goodput_is_empty_without_a_run(observed):
    assert observed["torch"]["goodput"] == observed["jax"]["goodput"] == {}


def test_state_api_offers_the_references_functions():
    ref = set(jstate.__all__)
    assert set(tstate.__all__) == (ref - {"jax_profile"}) | {"torch_profile"}
    with pytest.raises(ValueError, match="auto|torch|cpu"):
        tstate.StateApiClient(worker=object()).profile(1, mode="jax")


def test_profile_captures_a_workers_torch_trace_and_diagnose_names_storms():
    os.environ.setdefault("RAY_TPU_NUM_CHIPS", "0")
    ray_tpu_torch.init(num_cpus=1)
    tdt._reset_for_tests()
    try:
        @ray_tpu_torch.remote
        class Busy:
            def pid(self):
                return os.getpid()

            def spin(self, s):
                end = time.monotonic() + s
                x = torch.ones(64, 64)
                while time.monotonic() < end:
                    x = x @ x / 64
                return True

        b = Busy.remote()
        pid = ray_tpu_torch.get(b.pid.remote())
        spin = b.spin.remote(2.0)
        rep = tstate.profile(pid, duration_s=0.5, mode="torch")
        assert ray_tpu_torch.get(spin)
        assert rep["mode"] == "torch" and rep["pid"] == pid
        assert rep["artifact"].endswith("trace.json")
        with open(rep["artifact"]) as f:
            trace = json.load(f)
        assert trace["traceEvents"]
        # a program recapturing fast enough is a storm in diagnose()
        for w in range(6):
            tdt.note_trace("state.test.churn", shape_key=w)
        report = tstate.diagnose(include_stacks=False)
        assert not report["hung"]
        assert [r["program"] for r in report["compile_storm"]] == [
            "state.test.churn"]
    finally:
        tdt._reset_for_tests()
        ray_tpu_torch.shutdown()
