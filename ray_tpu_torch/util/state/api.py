"""State API: list/summarize live cluster entities.

reference: python/ray/util/state/api.py — list_actors/list_tasks/list_objects/
list_nodes/list_placement_groups/list_jobs/list_workers + summaries; data
sourced from the GCS (actors, nodes, PGs, jobs, task events) and from each
raylet (objects, workers), exactly the reference's GCS + per-node-agent split.

Filters are ``(key, op, value)`` tuples with op in {"=", "!="} — the subset
the reference CLI uses most.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

Filter = Tuple[str, str, Any]


def _apply_filters(rows: List[dict], filters: Optional[Sequence[Filter]]) -> List[dict]:
    if not filters:
        return rows
    out = []
    for r in rows:
        ok = True
        for key, op, value in filters:
            have = r.get(key)
            have_s = have.hex() if hasattr(have, "hex") and not isinstance(have, (str, bytes)) else have
            if op == "=":
                ok = have_s == value or have == value
            elif op == "!=":
                ok = have_s != value and have != value
            else:
                raise ValueError(f"unsupported filter op {op!r} (use '=' or '!=')")
            if not ok:
                break
        if ok:
            out.append(r)
    return out


class StateApiClient:
    """Talks to the GCS of the connected cluster (reference: StateApiClient)."""

    def __init__(self, worker=None):
        if worker is None:
            from ray_tpu_torch._private.worker import get_global_worker

            worker = get_global_worker()
        if worker is None:
            raise RuntimeError("ray_tpu_torch.init() must be called before using the state API")
        self._w = worker

    # -- GCS-backed listings -------------------------------------------

    def list_nodes(self, filters=None, limit: int = 10000) -> List[dict]:
        rows = self._w.gcs.call("GetAllNodeInfo", {}) or []
        return _apply_filters(rows, filters)[:limit]

    def list_cluster_events(self, filters=None, limit: int = 1000,
                            severity: Optional[str] = None,
                            after_id: int = 0) -> List[dict]:
        """reference: dashboard/modules/event/ aggregated cluster events."""
        rows = self._w.gcs.call("ListEvents", {
            "severity": severity, "after_id": after_id, "limit": limit}) or []
        return _apply_filters(rows, filters)[:limit]

    def record_event(self, message: str, *, severity: str = "INFO",
                     source: str = "user", **metadata) -> None:
        """Append a user event to the cluster event log."""
        self._w.gcs.call("RecordEvent", {
            "severity": severity, "source": source, "message": message,
            "metadata": metadata})

    def list_actors(self, filters=None, limit: int = 10000) -> List[dict]:
        rows = self._w.gcs.call("ListActors", {}) or []
        return _apply_filters(rows, filters)[:limit]

    def list_placement_groups(self, filters=None, limit: int = 10000) -> List[dict]:
        rows = self._w.gcs.call("ListPlacementGroups", {}) or []
        return _apply_filters(rows, filters)[:limit]

    def list_jobs(self, filters=None, limit: int = 10000) -> List[dict]:
        rows = self._w.gcs.call("ListJobs", {}) or []
        return _apply_filters(rows, filters)[:limit]

    @staticmethod
    def _fold_task_events(events: List[dict]) -> List[dict]:
        """Latest state per (task_id, attempt), folded from the task-event
        log (reference: GcsTaskManager).  Per-attempt phase timestamps:
        creation (owner SUBMITTED), queued/scheduled (raylet), start
        (executor RUNNING), end (owner FINISHED/FAILED)."""
        folded: Dict[Tuple[str, int], dict] = {}
        for ev in events:
            key = (ev["task_id"], ev.get("attempt", 0))
            row = folded.setdefault(
                key,
                {
                    "task_id": ev["task_id"],
                    "attempt": ev.get("attempt", 0),
                    "name": ev.get("name"),
                    "job_id": ev.get("job_id"),
                    "actor_id": ev.get("actor_id"),
                    "state": None,
                    "creation_time": None,
                    "queued_time": None,
                    "scheduled_time": None,
                    "start_time": None,
                    "end_time": None,
                    "node_id": None,
                    "pid": None,
                    "submit_pid": None,
                    "submit_node_id": None,
                },
            )
            if ev.get("trace_id"):
                row["trace_id"] = ev["trace_id"]
                row["span_id"] = ev.get("span_id")
                row["parent_span_id"] = ev.get("parent_span_id")
            if ev.get("kind"):
                row["kind"] = ev["kind"]
            state, t = ev["state"], ev["time"]
            if state == "SUBMITTED":
                row["creation_time"] = t
                row["submit_pid"] = ev.get("pid")
                row["submit_node_id"] = ev.get("node_id")
            elif state == "QUEUED":
                row["queued_time"] = t
            elif state == "SCHEDULED":
                row["scheduled_time"] = t
            elif state == "RUNNING":
                row["start_time"] = t
                row["node_id"] = ev.get("node_id")
                row["pid"] = ev.get("pid")
                if ev.get("attributes"):
                    row["attributes"] = ev["attributes"]
            elif state in ("FINISHED", "FAILED"):
                row["end_time"] = t
            order = {"SUBMITTED": 0, "QUEUED": 1, "SCHEDULED": 2,
                     "RUNNING": 3, "FINISHED": 4, "FAILED": 4}
            if row["state"] is None or order.get(state, 0) >= order.get(row["state"], 0):
                row["state"] = state
        return sorted(folded.values(),
                      key=lambda r: (r["creation_time"] or r["start_time"] or 0))

    def list_tasks(self, filters=None, limit: int = 10000) -> List[dict]:
        """Latest state per (task_id, attempt), folded from the task-event log
        (reference: GcsTaskManager)."""
        events = self._w.gcs.call("ListTaskEvents", {"limit": 100000}) or []
        rows = self._fold_task_events(events)
        return _apply_filters(rows, filters)[:limit]

    # -- distributed traces (tentpole: util/tracing.py context) ---------

    def get_trace(self, trace_id: str) -> List[dict]:
        """Every span of one trace, folded per (span_id, attempt): task
        spans carry phase timestamps (creation/queued/scheduled/start/end),
        custom spans (tracing.span, collectives, engine phases) carry
        start/end + kind."""
        # flush this process's buffered span events first (like timeline()):
        # a just-closed driver-side span must be queryable immediately
        try:
            self._w.flush_task_events()
        except Exception:  # noqa: BLE001 — flush is best-effort; stale spans still list
            pass
        events = self._w.gcs.call(
            "ListTaskEvents", {"limit": 100000, "trace_id": trace_id}) or []
        rows = self._fold_task_events(events)
        out = []
        for r in rows:
            if not r.get("span_id"):
                continue
            kind = r.get("kind")
            if kind is None:
                kind = "actor_task" if r.get("actor_id") else "task"
            out.append({
                "trace_id": trace_id,
                "span_id": r["span_id"],
                "parent_span_id": r.get("parent_span_id"),
                "name": r.get("name"),
                "kind": kind,
                "attempt": r.get("attempt", 0),
                "task_id": r.get("task_id"),
                "state": r.get("state"),
                "submitted": r.get("creation_time"),
                "queued": r.get("queued_time"),
                "scheduled": r.get("scheduled_time"),
                "start": r.get("start_time"),
                "end": r.get("end_time"),
                "node_id": r.get("node_id"),
                "pid": r.get("pid"),
                # span payloads: collective bytes/world_size, engine
                # active_slots/chunk, data num_rows
                "attributes": r.get("attributes"),
            })
        return out

    @staticmethod
    def _span_begin(s: dict):
        for k in ("submitted", "queued", "scheduled", "start"):
            if s.get(k) is not None:
                return s[k]
        return None

    @staticmethod
    def _span_end(s: dict):
        for k in ("end", "start", "scheduled", "queued", "submitted"):
            if s.get(k) is not None:
                return s[k]
        return None

    def summarize_trace(self, trace_id: str,
                        spans: Optional[List[dict]] = None) -> dict:
        """Critical-path walk of one trace.

        From the root span, repeatedly descend into the latest-ending
        child; a cursor sweeps wall-clock time once, so the per-phase
        attribution (submit rpc / queueing / spawn+dispatch / execution /
        collective) telescopes to exactly the root span's duration —
        "where did this request's time go?".  Pass ``spans`` (a
        ``get_trace`` result) to avoid re-fetching the event log.
        """
        from collections import defaultdict

        if spans is None:
            spans = self.get_trace(trace_id)
        # latest attempt wins per span_id (retries reuse the span)
        by_id: Dict[str, dict] = {}
        for s in spans:
            cur = by_id.get(s["span_id"])
            if cur is None or s["attempt"] >= cur["attempt"]:
                by_id[s["span_id"]] = s
        if not by_id:
            return {"trace_id": trace_id, "num_spans": 0,
                    "wall_clock_s": 0.0, "phases_s": {}, "critical_path": []}
        children = defaultdict(list)
        for s in by_id.values():
            parent = s.get("parent_span_id")
            if parent and parent in by_id:
                children[parent].append(s)
        roots = [s for s in by_id.values()
                 if not s.get("parent_span_id")
                 or s["parent_span_id"] not in by_id]
        root = min(roots, key=lambda s: self._span_begin(s) or float("inf"))
        # partial traces (the bounded event sink can evict a trace's older
        # RUNNING/SUBMITTED events while later ones survive) may leave the
        # root — or every span — with no begin timestamp; anchor the walk
        # at the earliest timestamp present instead of epoch 0
        begins = [b for s in by_id.values()
                  for b in (self._span_begin(s),) if b is not None]
        if not begins:
            return {"trace_id": trace_id, "num_spans": len(by_id),
                    "wall_clock_s": 0.0, "phases_s": {}, "critical_path": [],
                    "partial": True}

        phases: Dict[str, float] = defaultdict(float)

        def bucket_of(s: dict) -> str:
            return "collective" if s.get("kind") == "collective" else "execution"

        # build the latest-ending-child chain ITERATIVELY: a continuation-
        # style trace can nest deeper than the interpreter recursion limit
        path: List[dict] = [root]
        seen = {root["span_id"]}
        while True:
            kids = children.get(path[-1]["span_id"]) or []
            kid = max(kids, key=lambda c: self._span_end(c) or 0.0,
                      default=None)
            if kid is None or kid["span_id"] in seen:
                break
            path.append(kid)
            seen.add(kid["span_id"])

        begin = self._span_begin(root) or min(begins)
        cursor = begin
        # descend: each span's pre-execution phases, with the gap up to a
        # child's begin charged to the PARENT's execution bucket
        for i, s in enumerate(path):
            if i > 0:
                kb = self._span_begin(s)
                if kb is not None and kb > cursor:
                    phases[bucket_of(path[i - 1])] += kb - cursor
                    cursor = kb
            for phase, key in (("submit", "queued"),
                               ("queueing", "scheduled"),
                               ("spawn", "start")):
                t = s.get(key)
                if t is not None and t > cursor:
                    phases[phase] += t - cursor
                    cursor = t
        # ascend: close each span leaf-first, charging the remainder to its
        # own bucket — together the cursor sweeps [begin, finish] exactly
        # once, so the phase sums telescope to the wall clock
        for s in reversed(path):
            e = self._span_end(s)
            if e is not None and e > cursor:
                phases[bucket_of(s)] += e - cursor
                cursor = e
        finish = cursor
        return {
            "trace_id": trace_id,
            "num_spans": len(by_id),
            "wall_clock_s": finish - begin,
            "phases_s": dict(phases),
            "critical_path": [
                {"span_id": s["span_id"], "name": s.get("name"),
                 "kind": s.get("kind"), "task_id": s.get("task_id"),
                 "begin": self._span_begin(s), "end": self._span_end(s),
                 "node_id": s.get("node_id"), "pid": s.get("pid")}
                for s in path
            ],
        }

    # -- raylet-backed listings ----------------------------------------

    def _each_raylet(self, method: str, payload: dict) -> List[dict]:
        out = []
        for node in self.list_nodes():
            if node.get("state") == "DEAD":
                continue
            try:
                reply = self._w.pool.get(tuple(node["address"])).call(method, payload, timeout=5)
            except Exception:  # noqa: BLE001 — unreachable raylet: return the rows we have
                continue
            for row in reply or []:
                row["node_id"] = node["node_id"]
                out.append(row)
        return out

    def list_objects(self, filters=None, limit: int = 10000) -> List[dict]:
        rows = self._each_raylet("ListObjects", {})
        return _apply_filters(rows, filters)[:limit]

    def list_workers(self, filters=None, limit: int = 10000) -> List[dict]:
        rows = self._each_raylet("ListWorkers", {})
        return _apply_filters(rows, filters)[:limit]

    # -- per-node agent endpoints (reference: dashboard reporter) -------

    def node_stats(self) -> List[dict]:
        """CPU/memory/load + per-worker rss for every alive node."""
        out = []
        for node in self._alive_nodes():
            try:
                stats = self._w.pool.get(tuple(node["address"])).call(
                    "AgentNodeStats", {}, timeout=10)
                stats["node_id"] = node["node_id"]
                out.append(stats)
            except Exception:  # noqa: BLE001 — unreachable node: skip its stats
                continue
        return out

    def _alive_nodes(self, node_id=None):
        """Alive nodes, optionally narrowed to one id (NodeID or hex str) —
        the shared filter for every per-node agent endpoint."""
        want = None
        if node_id is not None:
            want = node_id.hex() if hasattr(node_id, "hex") else str(node_id)
        for node in self.list_nodes():
            if node.get("state") == "DEAD":
                continue
            nid = node["node_id"]
            nid_hex = nid.hex() if hasattr(nid, "hex") else str(nid)
            if want is not None and nid_hex != want:
                continue
            yield node

    def node_metrics(self, node_id=None) -> List[dict]:
        """Per-node Prometheus exposition text from each raylet's metrics
        agent endpoint (reference: the per-node MetricsAgent /metrics; the
        head's /metrics is the cluster aggregate)."""
        out = []
        for node in self._alive_nodes(node_id):
            try:
                text = self._w.pool.get(tuple(node["address"])).call(
                    "AgentMetrics", {}, timeout=10)
                out.append({"node_id": node["node_id"], "metrics": text})
            except Exception:  # noqa: BLE001 — unreachable node: skip its metrics
                continue
        return out

    def dump_stacks(self, node_id=None, pid: Optional[int] = None) -> List[dict]:
        """Stack traces from every worker (reference: `ray stack`)."""
        out = []
        for node in self.list_nodes():
            if node.get("state") == "DEAD":
                continue
            if node_id is not None and node["node_id"] != node_id:
                continue
            try:
                reply = self._w.pool.get(tuple(node["address"])).call(
                    "AgentStacks", {"pid": pid}, timeout=30)
            except Exception:  # noqa: BLE001 — unreachable node: skip its stacks
                continue
            for row in reply or []:
                row["node_id"] = node["node_id"]
                out.append(row)
        return out

    def dump_native_stacks(self, pid: int, node_id=None) -> List[dict]:
        """Native (C/XLA) frames of one worker's threads, even when it is
        wedged inside a native call where the Python-level ``dump_stacks``
        shows nothing (reference: reporter agent py-spy integration)."""
        out = []
        for node in self.list_nodes():
            if node.get("state") == "DEAD":
                continue
            if node_id is not None and node["node_id"] != node_id:
                continue
            try:
                reply = self._w.pool.get(tuple(node["address"])).call(
                    "AgentNativeStacks", {"pid": pid}, timeout=30)
            except Exception:  # noqa: BLE001 — unreachable node: skip its native stacks
                continue
            if reply:
                reply["node_id"] = node["node_id"]
                out.append(reply)
        return out

    def flight_recorder(self, node_id=None, pid: Optional[int] = None,
                        seconds: Optional[float] = None,
                        limit: Optional[int] = 200) -> List[dict]:
        """Flight-recorder tails from every (or one) node: per process, the
        last seconds of step phases, collective entry/exit marks, task and
        lease transitions.  Dead workers come back as their crash-dump
        contents (the `<pid>.flight` file written next to the native stack
        dump)."""
        out = []
        for node in self._alive_nodes(node_id):
            try:
                reply = self._w.pool.get(tuple(node["address"])).call(
                    "AgentFlightRecorder",
                    {"pid": pid, "seconds": seconds, "limit": limit},
                    timeout=15)
            except Exception:  # noqa: BLE001 — unreachable node: skip its recorder tail
                continue
            for row in reply or []:
                row["node_id"] = node["node_id"]
                out.append(row)
        return out

    # -- hang & straggler diagnosis (tentpole) -------------------------

    def diagnose(self, hang_timeout_s: Optional[float] = None,
                 include_stacks: bool = True,
                 source: str = "api") -> dict:
        """One cluster-wide hang sweep: "why is my job stuck right now?"

        Folds three sources into one report:
          1. the collective store's arrival monitor — pending rounds whose
             missing ranks have kept the group waiting past
             ``hang_detect_timeout_s`` name the blocking member (rank +
             actor + node, identity captured at join), the op, and the seq
             it never entered; completed-round arrival-lag EWMAs are the
             persistent-straggler scores;
          2. every process's flight-recorder tail (what each worker was
             doing in the last seconds; entries recorded under a tracing
             context carry trace_ids, cross-linking to state.get_trace());
          3. stack dumps of the blocking workers (python-level; callers can
             follow up with dump_native_stacks/cpu_profile for wedged ones).

        A healthy cluster returns ``hung=False`` with empty ``blocking`` —
        pending rounds younger than the timeout are listed under
        ``pending_young`` but never flagged.
        """
        from ray_tpu_torch._private import runtime_metrics
        from ray_tpu_torch._private.config import global_config

        if hang_timeout_s is None:
            hang_timeout_s = global_config().hang_detect_timeout_s
        runtime_metrics.inc_hang_sweep(source)
        report: dict = {
            "time": time.time(),
            "hang_timeout_s": hang_timeout_s,
            "hung": False,
            "blocking": [],
            "pending_young": [],
            "stragglers": {},
            "aborted_groups": {},
            "trace_ids": [],
        }

        # -- 1. collective arrival monitor --------------------------------
        store_rep = None
        try:
            import ray_tpu_torch
            from ray_tpu_torch.util.collective.store import STORE_ACTOR_NAME

            store = ray_tpu_torch.get_actor(STORE_ACTOR_NAME)
            store_rep = ray_tpu_torch.get(store.straggler_report.remote(),
                                    timeout=15)
        except Exception:  # noqa: BLE001 — no store actor = no collectives
            pass

        # actor -> (node, pid) so a blocking member is named as a process,
        # not just a rank
        actor_nodes: Dict[str, str] = {}
        actor_pids: Dict[str, Optional[int]] = {}
        if store_rep and any(g.get("pending") or g.get("members")
                             for g in store_rep["groups"].values()):
            for a in self.list_actors():
                aid = a.get("actor_id")
                aid = aid.hex() if hasattr(aid, "hex") else str(aid)
                nid = a.get("node_id")
                if nid is not None:
                    actor_nodes[aid] = (nid.hex() if hasattr(nid, "hex")
                                        else str(nid))
            for wrow in self.list_workers():
                if wrow.get("actor_id"):
                    actor_pids[wrow["actor_id"]] = wrow.get("pid")

        if store_rep:
            for group, g in store_rep["groups"].items():
                if g.get("lag_ewma_s"):
                    report["stragglers"][group] = g["lag_ewma_s"]
                if g.get("aborted"):
                    report["aborted_groups"][group] = g["aborted"]
                members = g.get("members") or {}
                for round_ in g.get("pending") or []:
                    rows = []
                    for rank in round_.get("missing") or []:
                        m = members.get(rank) or members.get(str(rank)) or {}
                        aid = m.get("actor_id")
                        rows.append({
                            "group": group,
                            "op": round_["op"],
                            "seq": round_["seq"],
                            "rank": rank,
                            "actor_id": aid,
                            "node_id": m.get("node_id")
                            or actor_nodes.get(aid),
                            "pid": actor_pids.get(aid),
                            "waiting_s": round_["waiting_s"],
                        })
                    if round_["waiting_s"] >= hang_timeout_s and rows:
                        report["blocking"].extend(rows)
                    else:
                        report["pending_young"].append(
                            {"group": group, **round_})
        if report["blocking"]:
            report["hung"] = True

        # -- 2. flight-recorder tails (every process's last seconds) ------
        tails = self.flight_recorder(seconds=max(hang_timeout_s * 2, 30.0),
                                     limit=100)
        report["flight_recorder"] = tails
        trace_ids: List[str] = []
        for row in tails:
            for e in row.get("entries") or []:
                tid = e.get("trace_id")
                if tid and tid not in trace_ids:
                    trace_ids.append(tid)
        report["trace_ids"] = trace_ids[-16:]

        # -- 3. stacks of the blocking workers ----------------------------
        if include_stacks and report["blocking"]:
            stacks = []
            for b in report["blocking"]:
                if b.get("pid") is None:
                    continue
                try:
                    stacks.extend(self.dump_stacks(pid=b["pid"]))
                except Exception:  # noqa: BLE001 — stack dump is enrichment; the report stands without it
                    continue
            report["stacks"] = stacks

        # -- compile watch: storm detector (device telemetry) -------------
        # N traces/compiles of one program inside the storm window name
        # the program and its callers — a shape-churn workload surfaces
        # here before it surfaces as missing throughput
        from ray_tpu_torch._private import device_telemetry

        report["compile_storm"] = device_telemetry.storm_report()

        # -- 4. lock-order witness (test/chaos lanes) ---------------------
        # when RAY_TPU_lock_witness_enabled=1 the driver's own witnessed
        # locks have been building the acquired-while-holding graph; any
        # recorded cycle (with both acquisition stacks) rides the hang
        # report, so an inversion surfaces the same way a hang does
        from ray_tpu_torch._private.analysis import lock_witness

        lw = lock_witness.report()
        if lw.get("enabled"):
            report["lock_witness"] = lw
            if lw.get("cycles"):
                report["hung"] = True
        return report

    # -- goodput ledger (train controller wall-clock accounting) --------

    def goodput(self, run: Optional[str] = None) -> dict:
        """Published goodput ledgers: per run, wall-clock split into
        productive_step / checkpoint / restore / preemption_recovery /
        input_wait / stall buckets (summing exactly to the wall) plus the
        derived goodput ratio.  ``run`` narrows to one run name; also
        accepts a job id recorded in the ledger."""
        from ray_tpu_torch.train._internal.goodput import GOODPUT_KV_PREFIX

        out: Dict[str, dict] = {}
        keys = self._w.gcs.call(
            "KVKeys", {"prefix": GOODPUT_KV_PREFIX}) or []
        for k in keys:
            blob = self._w.gcs.call("KVGet", {"key": k})
            if not blob:
                continue
            try:
                import json

                snap = json.loads(blob)
            except Exception:  # noqa: BLE001 — malformed snapshot row: skip it
                continue
            name = k[len(GOODPUT_KV_PREFIX):]
            if run is not None and run not in (name, snap.get("job_id")):
                continue
            out[name] = snap
        return out

    # -- serving SLO layer (request-level ledger + burn-rate monitoring) --

    def _slo_rows(self) -> list:
        """Fetch every process's published ``slo:*`` snapshot row."""
        import json

        from ray_tpu_torch.serve._private.slo import SLO_KV_PREFIX

        rows = []
        keys = self._w.gcs.call("KVKeys", {"prefix": SLO_KV_PREFIX}) or []
        blobs = self._w.gcs.call("KVMultiGet", {"keys": keys}) or {}
        for blob in blobs.values():
            if not blob:
                continue
            try:
                rows.append(json.loads(blob))
            except Exception:  # noqa: BLE001 — one bad row, not all
                continue
        return rows

    def serving_slo(self, deployment: Optional[str] = None) -> dict:
        """Cluster-wide serving SLO report: per deployment, TTFT/ITL
        percentiles (lossless sketch merge across every ingress — the p99
        is the TRUE p99 of the combined request stream), split by tenant,
        per-stage percentiles (queue_wait/prefill/handoff/decode), terminal
        status counts, effective SLO targets, and multi-window (5m/1h)
        burn rates with the breach list ranked worst-first.  A single slow
        replica shows up here as the deployment's burn rate crossing the
        alert threshold."""
        import json

        from ray_tpu_torch.serve._private import slo as slo_mod

        conf_rows = {}
        try:
            keys = self._w.gcs.call(
                "KVKeys", {"prefix": slo_mod.SLO_CONF_KV_PREFIX}) or []
            blobs = self._w.gcs.call("KVMultiGet", {"keys": keys}) or {}
            for key, blob in blobs.items():
                try:
                    conf_rows[key[len(slo_mod.SLO_CONF_KV_PREFIX):]] = (
                        json.loads(blob))
                except Exception:  # noqa: BLE001 — malformed SLO conf row: skip it
                    continue
        except Exception:  # noqa: BLE001 — defaults still apply
            pass
        report = slo_mod.fold_rows(self._slo_rows(), conf_rows=conf_rows)
        if deployment is not None:
            report["deployments"] = {
                k: v for k, v in report["deployments"].items()
                if k == deployment}
            report["breaches"] = [b for b in report["breaches"]
                                  if b["deployment"] == deployment]
        return report

    def recent_requests(self, limit: int = 100,
                        deployment: Optional[str] = None,
                        tenant: Optional[str] = None) -> List[dict]:
        """Overload forensics: the newest completed requests cluster-wide
        (tenant, status, route reason, TTFT, mean/max ITL, duration,
        trace_id cross-link), folded from every ingress's recent ring."""
        from ray_tpu_torch.serve._private import slo as slo_mod

        rows = slo_mod.fold_recent(self._slo_rows(), limit=limit * 4)
        if deployment is not None:
            rows = [r for r in rows if r.get("deployment") == deployment]
        if tenant is not None:
            rows = [r for r in rows if r.get("tenant") == tenant]
        return rows[-limit:]

    # -- device telemetry (chip-level observability) --------------------

    def utilization(self, deployment: Optional[str] = None) -> dict:
        """Cluster utilization snapshot (device telemetry): per
        deployment, every replica's free decode slots, free KV blocks,
        duty cycle, and HBM split, plus summed headroom — free slots and
        free blocks per deployment are THE SLO-feedback autoscaler's
        inputs (ROADMAP item 1).  Folds GCS-published replica rows
        (serve/_private/replica.py utilization loop) with this process's
        locally registered engines (local-testing-mode serve apps and
        engine-direct benches publish nowhere, but still fold here)."""
        import json

        from ray_tpu_torch._private import device_telemetry

        rows: List[dict] = []
        try:
            keys = self._w.gcs.call(
                "KVKeys",
                {"prefix": device_telemetry.UTIL_KV_PREFIX}) or []
            blobs = self._w.gcs.call("KVMultiGet", {"keys": keys}) or {}
            for blob in blobs.values():
                if not blob:
                    continue
                try:
                    rows.append(json.loads(blob))
                except Exception:  # noqa: BLE001 — one bad row, not all
                    continue
        except Exception:  # noqa: BLE001 — KV unreachable: local rows only
            pass
        rows.extend(device_telemetry.local_utilization_rows())
        snap = device_telemetry.fold_utilization_rows(rows)
        if deployment is not None:
            snap["deployments"] = {
                k: v for k, v in snap["deployments"].items()
                if k == deployment}
        return snap

    # -- metrics history + watch alerts (_private/metrics_history.py) --

    def metric_history(self, family: Optional[str] = None,
                       tags: Optional[dict] = None,
                       window_s: Optional[float] = None,
                       step_s: Optional[float] = None,
                       op: Optional[str] = None,
                       q: float = 0.99) -> dict:
        """Trailing time-series of the cluster metric aggregate, straight
        from the in-GCS history store: per matching (family, tagset) a
        two-resolution sample list (counters as per-bucket deltas — never
        negative across restarts/evictions; gauges last-wins; sketches as
        per-bucket delta sketches whose window merge is lossless).  With
        ``op`` one of rate / delta / avg_over_time / quantile_over_time
        (``q`` sets the quantile) the GCS also evaluates the operator per
        series.  No ``family`` lists the retained families + store
        stats."""
        req: dict = {"family": family, "tags": tags, "window_s": window_s,
                     "step_s": step_s}
        if op:
            req["op"] = op
            req["q"] = q
        return self._w.gcs.call("MetricHistory", req) or {}

    def alerts(self, rule: Optional[str] = None) -> dict:
        """Watch-engine state: active alerts (pending/firing/clearing,
        firing first), the installed rule definitions, and the recent
        firing/cleared transition log.  ``rule`` filters to one rule."""
        return self._w.gcs.call("ListAlerts", {"rule": rule}) or {}

    def add_watch_rule(self, rule: dict) -> bool:
        """Install (or replace, by name) a declarative watch rule — the
        same contract the built-in pack uses; see
        metrics_history.WatchRule for the field grammar."""
        return bool(self._w.gcs.call("AddWatchRule", {"rule": rule}))

    def remove_watch_rule(self, name: str) -> bool:
        return bool(self._w.gcs.call("RemoveWatchRule", {"name": name}))

    def profile(self, pid: int, node_id=None, duration_s: float = 2.0,
                mode: str = "auto") -> dict:
        """On-demand profiler capture of one worker (device telemetry):
        a torch.profiler Chrome trace (CPU, and CUDA kernels where the
        worker has a CUDA context), else the pure-Python sampling profile (sys._current_frames
        over the worker RPC thread, like the flight recorder's tail).
        Returns the artifact path plus the trace_ids active on the
        worker around the capture window (flight-recorder tail), so a
        chip-level capture cross-links to ``state.get_trace()``."""
        if mode not in ("auto", "torch", "cpu"):
            raise ValueError(f"mode must be auto|torch|cpu (got {mode!r})")
        result: dict = {"pid": pid, "mode": None, "artifact": None}
        if mode in ("auto", "torch"):
            try:
                rep = self.torch_profile(pid, node_id=node_id,
                                         duration_s=duration_s)
                files = rep.get("files") or []
                if files or mode == "torch":
                    result["mode"] = "torch"
                    result["artifact"] = files[0] if files \
                        else rep.get("logdir")
                    result["logdir"] = rep.get("logdir")
                    result["files"] = files
            except Exception:  # noqa: BLE001 — fall back to sampling
                if mode == "torch":
                    raise
        if result["mode"] is None:
            import json
            import os
            import tempfile

            rep = self.cpu_profile(pid, node_id=node_id,
                                   duration_s=duration_s)
            fd, path = tempfile.mkstemp(
                prefix=f"ray_tpu_profile_{pid}_", suffix=".json")
            with os.fdopen(fd, "w") as f:
                json.dump(rep, f, indent=1)
            result["mode"] = "cpu"
            result["artifact"] = path
            result["samples"] = rep.get("samples")
        try:
            tids: List[str] = []
            for row in self.flight_recorder(pid=pid,
                                            seconds=duration_s + 30):
                for e in row.get("entries") or []:
                    t = e.get("trace_id")
                    if t and t not in tids:
                        tids.append(t)
            result["trace_ids"] = tids[-16:]
        except Exception:  # noqa: BLE001 — cross-link is enrichment only
            result["trace_ids"] = []
        return result

    def _agent_call_by_pid(self, method: str, payload: dict, *, pid,
                           node_id, timeout: float) -> dict:
        """Try every live node's agent endpoint for ``pid``; the hosting
        node's real error must never be overwritten by other nodes'
        'no worker with pid' noise."""
        last_error: Optional[Exception] = None
        for node in self.list_nodes():
            if node.get("state") == "DEAD":
                continue
            if node_id is not None and node["node_id"] != node_id:
                continue
            try:
                return self._w.pool.get(tuple(node["address"])).call(
                    method, payload, timeout=timeout)
            except Exception as e:  # noqa: BLE001
                if last_error is None or "no worker with pid" in str(last_error):
                    last_error = e
        raise ValueError(
            f"no worker with pid {pid} found on any node"
            + (f" (last error: {last_error})" if last_error else ""))

    def cpu_profile(self, pid: int, node_id=None, duration_s: float = 5.0) -> dict:
        """Sampling CPU profile of one worker (reference: reporter's
        profiling endpoint)."""
        return self._agent_call_by_pid(
            "AgentProfile", {"pid": pid, "duration_s": duration_s},
            pid=pid, node_id=node_id, timeout=duration_s + 30)

    def torch_profile(self, pid: int, node_id=None,
                      duration_s: float = 3.0,
                      logdir: Optional[str] = None) -> dict:
        """Capture a torch.profiler Chrome trace on one worker (CPU ops,
        and the CUDA kernels where it has a CUDA context); open the
        returned trace.json with Perfetto or chrome://tracing."""
        return self._agent_call_by_pid(
            "AgentTorchProfile",
            {"pid": pid, "duration_s": duration_s, "logdir": logdir},
            pid=pid, node_id=node_id, timeout=duration_s + 60)

    # -- summaries ------------------------------------------------------

    def summarize_tasks(self) -> Dict[str, Dict[str, int]]:
        """Per-function-name count by state (reference: `ray summary tasks`)."""
        summary: Dict[str, Dict[str, int]] = {}
        for t in self.list_tasks(limit=100000):
            by_state = summary.setdefault(t["name"] or "?", {})
            by_state[t["state"]] = by_state.get(t["state"], 0) + 1
        return summary

    def summarize_actors(self) -> Dict[str, Dict[str, int]]:
        summary: Dict[str, Dict[str, int]] = {}
        for a in self.list_actors(limit=100000):
            by_state = summary.setdefault(a.get("class_name") or "?", {})
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
        return summary


def _client() -> StateApiClient:
    return StateApiClient()


def list_nodes(filters=None, limit: int = 10000):
    return _client().list_nodes(filters, limit)


def list_actors(filters=None, limit: int = 10000):
    return _client().list_actors(filters, limit)


def list_tasks(filters=None, limit: int = 10000):
    return _client().list_tasks(filters, limit)


def get_trace(trace_id: str):
    return _client().get_trace(trace_id)


def summarize_trace(trace_id: str):
    return _client().summarize_trace(trace_id)


def list_objects(filters=None, limit: int = 10000):
    return _client().list_objects(filters, limit)


def list_placement_groups(filters=None, limit: int = 10000):
    return _client().list_placement_groups(filters, limit)


def list_jobs(filters=None, limit: int = 10000):
    return _client().list_jobs(filters, limit)


def list_workers(filters=None, limit: int = 10000):
    return _client().list_workers(filters, limit)


def summarize_tasks():
    return _client().summarize_tasks()


def list_cluster_events(filters=None, limit: int = 1000, severity=None,
                        after_id: int = 0):
    return _client().list_cluster_events(filters, limit, severity, after_id)


def record_event(message: str, *, severity: str = "INFO", source: str = "user",
                 **metadata):
    return _client().record_event(message, severity=severity, source=source,
                                  **metadata)


def summarize_actors():
    return _client().summarize_actors()


def node_stats():
    return _client().node_stats()


def node_metrics(node_id=None):
    return _client().node_metrics(node_id)


def dump_stacks(node_id=None, pid=None):
    return _client().dump_stacks(node_id, pid)


def flight_recorder(node_id=None, pid=None, seconds=None, limit=200):
    return _client().flight_recorder(node_id, pid, seconds, limit)


def diagnose(hang_timeout_s=None, include_stacks: bool = True,
             source: str = "api"):
    return _client().diagnose(hang_timeout_s, include_stacks, source)


def goodput(run=None):
    return _client().goodput(run)


def serving_slo(deployment=None):
    return _client().serving_slo(deployment)


def metric_history(family=None, tags=None, window_s=None, step_s=None,
                   op=None, q: float = 0.99):
    return _client().metric_history(family, tags, window_s, step_s, op, q)


def alerts(rule=None):
    return _client().alerts(rule)


def add_watch_rule(rule: dict):
    return _client().add_watch_rule(rule)


def remove_watch_rule(name: str):
    return _client().remove_watch_rule(name)


def recent_requests(limit: int = 100, deployment=None, tenant=None):
    return _client().recent_requests(limit, deployment, tenant)


def dump_native_stacks(pid, node_id=None):
    return _client().dump_native_stacks(pid, node_id)


def cpu_profile(pid, node_id=None, duration_s: float = 5.0):
    return _client().cpu_profile(pid, node_id, duration_s)


def torch_profile(pid, node_id=None, duration_s: float = 3.0,
                  logdir=None):
    return _client().torch_profile(pid, node_id, duration_s, logdir)


def utilization(deployment=None):
    try:
        client = _client()
    except RuntimeError:
        # no cluster connection: fold this process's registered engines
        # (local-testing-mode serve apps, engine-direct benches)
        from ray_tpu_torch._private import device_telemetry

        snap = device_telemetry.local_utilization()
        if deployment is not None:
            snap["deployments"] = {
                k: v for k, v in snap["deployments"].items()
                if k == deployment}
        return snap
    return client.utilization(deployment)


def profile(pid, node_id=None, duration_s: float = 2.0,
            mode: str = "auto"):
    return _client().profile(pid, node_id, duration_s, mode)


def ingress() -> dict:
    """Ingress control-plane view: this process's admission gate
    (weights, per-tenant inflight), the local scale-out tier (backends,
    live splices) and — when a serve controller is reachable — the pool
    autoscaler's pools and recent actuations.  Reads only state that
    already exists; never constructs the admission singleton."""
    from ray_tpu_torch.serve._private import admission as adm
    from ray_tpu_torch.serve._private import ingress as ing

    out: dict = {"admission": None, "tier": None, "pool_autoscaler": None}
    gate = adm._controller
    if gate is not None:
        out["admission"] = gate.snapshot()
    tier = ing.get_tier()
    if tier is not None:
        out["tier"] = {"address": list(tier.address),
                       "backends": [list(b) for b in tier.backends()],
                       "connections": tier._conns}
    try:
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.controller import get_controller_if_exists

        ctrl = get_controller_if_exists()
        if ctrl is not None:
            out["pool_autoscaler"] = ray_tpu_torch.get(
                ctrl.pool_autoscaler_report.remote())
    except Exception:  # noqa: BLE001 — no controller: local view only
        pass
    return out
