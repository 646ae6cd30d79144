"""Chrome-trace timeline export from the cluster task-event log.

reference: ray.timeline() — task events buffered per-worker
(src/ray/core_worker/task_event_buffer.cc) flow to the GCS task sink
(gcs_task_manager.h) and render as a Chrome trace in the dashboard.
Load the output at chrome://tracing or https://ui.perfetto.dev.

Besides the per-task execute slices, the export now draws the causal
structure: a driver-side ``submit:<name>`` slice per task (SUBMITTED →
SCHEDULED) and matched flow events (``ph:"s"`` on the submit slice,
``ph:"f"`` on the execute slice) so Perfetto renders an arrow from each
submission to its cross-process execution — the visual of one distributed
trace.  ``args.trace_id``/``span_id``/``parent_span_id`` are attached
wherever the trace context propagated (util/tracing.py).
"""

from __future__ import annotations

import json
from typing import List, Optional


def _trace_args(t: dict) -> dict:
    out = {}
    if t.get("trace_id"):
        out["trace_id"] = t["trace_id"]
        out["span_id"] = t.get("span_id")
        if t.get("parent_span_id"):
            out["parent_span_id"] = t["parent_span_id"]
    return out


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Build Chrome trace events; write JSON to ``filename`` if given."""
    from ray_tpu_torch._private.worker import get_global_worker
    from ray_tpu_torch.util.state import list_tasks

    w = get_global_worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called before ray_tpu_torch.timeline()")
    w.flush_task_events()

    events: List[dict] = []
    for t in list_tasks(limit=100000):
        start, end = t.get("start_time"), t.get("end_time")
        flow_id = f"{t['task_id']}:{t.get('attempt', 0)}"
        exec_pid = t.get("node_id") or "driver"
        exec_tid = t.get("pid") or 0
        if start is not None:
            slice_end = end if end is not None and end >= start else start
            events.append({
                "name": t["name"],
                "cat": "actor_task" if t.get("actor_id") else "task",
                "ph": "X",
                "ts": start * 1e6,
                "dur": (slice_end - start) * 1e6,
                "pid": exec_pid,
                "tid": exec_tid,
                "args": {
                    **(t.get("attributes") or {}),
                    # fixed diagnostic keys win over user attributes
                    "task_id": t["task_id"],
                    "attempt": t.get("attempt", 0),
                    "state": t.get("state"),
                    **_trace_args(t),
                },
            })
        # driver-side submit slice + flow arrow to the execute slice.
        # Only real tasks have a SUBMITTED event (custom spans don't).
        sub = t.get("creation_time")
        if sub is None:
            continue
        sub_end = t.get("scheduled_time") or t.get("queued_time") or start
        if sub_end is None or sub_end < sub:
            sub_end = sub
        submit_pid = t.get("submit_node_id") or "driver"
        submit_tid = t.get("submit_pid") or 0
        events.append({
            "name": f"submit:{t['name']}",
            "cat": "task_submit",
            "ph": "X",
            "ts": sub * 1e6,
            "dur": max(sub_end - sub, 1e-6) * 1e6,
            "pid": submit_pid,
            "tid": submit_tid,
            "args": {"task_id": t["task_id"], "attempt": t.get("attempt", 0),
                     **_trace_args(t)},
        })
        if start is None:
            continue  # never ran: no execute slice to link to
        # flow pair: the "s" timestamp must fall inside the submit slice
        # and the "f" timestamp inside the execute slice (Chrome trace
        # binds flow events to the slice enclosing their ts); clamp both
        # so cross-host clock skew can't detach an arrow from its slice.
        slice_end = end if end is not None and end >= start else start
        if sub > slice_end:
            # owner clock leads the worker's by more than the task ran:
            # no forward-in-time arrow exists — skip rather than emit a
            # backwards (unrendered) flow pair
            continue
        s_ts = min(max(start, sub), sub_end)
        f_ts = min(max(s_ts, start), slice_end)
        events.append({
            "name": "submit→execute", "cat": "task_flow", "ph": "s",
            "id": flow_id, "ts": s_ts * 1e6,
            "pid": submit_pid, "tid": submit_tid,
        })
        events.append({
            "name": "submit→execute", "cat": "task_flow", "ph": "f",
            "bp": "e", "id": flow_id, "ts": f_ts * 1e6,
            "pid": exec_pid, "tid": exec_tid,
        })
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
