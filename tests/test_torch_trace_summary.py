"""``tracing.trace_summary_snapshot`` on both runtimes: after a traced call
the snapshot carries the state API's critical-path summary of that trace.

The port's snapshot calls its own ``util.state.summarize_trace`` as the
JAX package's calls its own.  Each runtime brings a cluster up in this
process, finishes a span around a task that calls another, waits for the
spans to land and takes the snapshot; the port's summary must have the
JAX package's keys and phases and no ``error``.
"""

import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.util import state as jstate
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.util import state as tstate
from ray_tpu_torch.util import tracing as ttracing

pytestmark = pytest.mark.timeout(120)


def _snapshot(rt, state, tracing):
    """Run one traced call on runtime ``rt``; returns (trace id, snapshot)."""
    rt.init(num_cpus=2)
    try:
        @rt.remote
        def leaf():
            time.sleep(0.02)
            return 1

        @rt.remote
        def mid():
            return rt.get(leaf.remote()) + 1

        with tracing.span("root") as sp:
            assert rt.get(mid.remote()) == 2
        rt._private.worker.get_global_worker().flush_task_events()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            by_name = {s["name"]: s for s in state.get_trace(sp.trace_id)}
            if all(by_name.get(n, {}).get("end") is not None
                   for n in ("root", "mid", "leaf")):
                break
            time.sleep(0.1)
        return sp.trace_id, tracing.trace_summary_snapshot()
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def snapshots():
    return {"jax": _snapshot(ray_tpu, jstate, jtracing),
            "torch": _snapshot(ray_tpu_torch, tstate, ttracing)}


@pytest.mark.parametrize("runtime", ["jax", "torch"])
def test_snapshot_summarizes_last_trace(snapshots, runtime):
    trace_id, snap = snapshots[runtime]
    assert snap["enabled"] and snap["last_trace_id"] == trace_id
    summ = snap["last_trace_summary"]
    assert "error" not in summ, summ
    assert summ["trace_id"] == trace_id
    assert summ["num_spans"] >= 3
    assert [s["name"] for s in summ["critical_path"]][0] == "root"
    assert summ["wall_clock_s"] > 0


def test_port_summary_has_the_reference_keys(snapshots):
    ref = snapshots["jax"][1]["last_trace_summary"]
    port = snapshots["torch"][1]["last_trace_summary"]
    assert set(port) == set(ref)
    assert set(snapshots["torch"][1]) == set(snapshots["jax"][1])
    assert ({k for s in port["critical_path"] for k in s}
            == {k for s in ref["critical_path"] for k in s})
    assert "execution" in port["phases_s"] and "execution" in ref["phases_s"]
