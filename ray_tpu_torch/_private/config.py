"""Cluster-wide flag system.

TPU-native equivalent of the reference's ``RAY_CONFIG(type, name, default)``
macro table (reference: src/ray/common/ray_config_def.h:18-22, 223 entries).
Every entry is overridable per-process via a ``RAY_TPU_<name>`` environment
variable, and the head node distributes its resolved config blob to all other
components at registration time (reference: NodeManager::HandleGetSystemConfig,
node_manager.cc:2384).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, fields


def _coerce(raw: str, default):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    return type(default)(raw)


@dataclass
class RayTpuConfig:
    # --- timeouts / intervals (seconds) ---
    heartbeat_interval_s: float = 0.5
    health_check_failure_threshold: int = 10
    resource_report_interval_s: float = 0.2
    gcs_rpc_timeout_s: float = 30.0
    rpc_connect_timeout_s: float = 10.0
    worker_register_timeout_s: float = 30.0
    actor_creation_timeout_s: float = 120.0
    gcs_snapshot_interval_s: float = 1.0
    # grace for a finished stream's in-flight item delivery before the
    # consumer declares it lost (ObjectRefGenerator)
    streaming_item_grace_s: float = 30.0
    # periodic re-subscribe heals pubsub across GCS restarts and transient
    # connect-failure evictions (Subscribe is idempotent)
    resubscribe_interval_s: float = 5.0
    # --- built-in runtime metrics (_private/runtime_metrics.py) ---
    # min seconds between piggybacked metric pushes to the GCS per process
    metrics_report_interval_s: float = 2.0
    # a spawned worker that never registers is killed and its _starting slot
    # reclaimed after this deadline; must sit comfortably above the worker's
    # 90 s registration retry window
    worker_spawn_timeout_s: float = 180.0
    # zygote socket ops under the dispatch lock get this budget before the
    # spawn falls back to the Popen path (a wedged zygote must not stall
    # dispatch)
    zygote_spawn_timeout_s: float = 2.0
    # --- object store ---
    object_store_memory_bytes: int = 2 * 1024**3
    object_store_spill_dir: str = os.path.join(tempfile.gettempdir(),
                                               "ray_tpu_torch_spill")
    # remote spill target: any fsspec URI (gs://bucket/spill, memory://...);
    # empty -> local object_store_spill_dir (reference:
    # _private/external_storage.py:72,398 — URI-addressed external storage)
    object_spill_uri: str = ""
    object_spilling_enabled: bool = True
    # Inline (in-band) return threshold, like the reference's
    # max_direct_call_object_size (ray_config_def.h).
    max_inline_object_size: int = 100 * 1024
    object_transfer_chunk_bytes: int = 8 * 1024**2
    # --- cluster-view sync (versioned delta protocol; reference:
    # src/ray/common/ray_syncer/ray_syncer.h versioned gossip) ---
    # how many node-state mutations the GCS changelog ring remembers; a
    # raylet whose known version fell behind the ring gets one full
    # snapshot instead of a delta (then rides deltas again).  At the 0.2s
    # report tick this covers minutes of heavy churn.
    cluster_view_changelog_len: int = 4096
    # --- pubsub tree fan-out (control channels: NODE events / drain
    # notices) ---
    # branching factor of the raylet relay tree the GCS publishes through:
    # the GCS sends O(fanout) RelayPublish frames per event and relays
    # re-publish to their subtree, so GCS-side publish work stays O(fanout)
    # instead of O(nodes).  0 = flat (direct push to every raylet, the A/B
    # baseline); the payload is pickled once per publish either way.
    pubsub_tree_fanout: int = 4
    # --- scheduler ---
    scheduler_top_k_fraction: float = 0.2
    scheduler_top_k_absolute: int = 1
    enable_native_scheduler: bool = True  # C++ hybrid scorer (sched_policy.cc)
    scheduler_spread_threshold: float = 0.5
    # --- worker pool ---
    num_prestart_workers: int = 0
    # fork workers off a warm pre-imported zygote process (linux): ~50 ms
    # per spawn vs ~2.3 s full interpreter startup on images whose
    # sitecustomize imports jax everywhere (see _private/zygote.py)
    enable_worker_zygote: bool = True
    maximum_startup_concurrency: int = 4
    idle_worker_kill_timeout_s: float = 300.0
    # --- memory monitor (reference: memory_monitor.h:52) ---
    memory_usage_threshold: float = 0.95  # node used-memory fraction
    memory_monitor_refresh_ms: int = 250  # 0 disables the monitor
    # --- owner-side lease cache / pipelined submission (fast path) ---
    # reference: scheduling-key lease queues, normal_task_submitter.h:40-77.
    # Granted worker leases are kept by the owner after a task finishes and
    # reused for the next task of the same scheduling key, with up to this
    # many tasks pushed (pipelined) per leased worker; the worker executes
    # FIFO.  1 restores one-task-per-push (still one lease per task batch).
    max_tasks_in_flight_per_worker: int = 10
    # a cached lease with no in-flight tasks is returned to its raylet
    # after this long (holding it longer trades cross-key resource
    # availability for reuse hit rate)
    worker_lease_idle_timeout_s: float = 1.0
    # raylet-side lease time-to-live: the owner extends held leases at
    # ~ttl/4; a lease not extended (owner dead, extension RPCs lost) is
    # reclaimed once its worker's task queue is empty
    worker_lease_ttl_s: float = 10.0
    # master switch for the owner-side lease cache + pipelining; off makes
    # every task acquire and return its own lease (the pre-fast-path
    # behavior, kept for A/B benchmarking)
    worker_lease_reuse_enabled: bool = True
    # --- rpc framing ---
    # pickle-protocol-5 out-of-band frames: payload buffers (task arg/return
    # blobs, object chunks) are written to the socket as separate iovecs
    # instead of being copied into one joined frame
    rpc_oob_frames_enabled: bool = True
    # wrap inline arg/return blobs at least this large in PickleBuffer so
    # they ride the out-of-band path (tiny blobs aren't worth the iovec)
    rpc_oob_min_buffer_bytes: int = 4096
    # --- retries / fault tolerance ---
    task_max_retries_default: int = 3
    actor_max_restarts_default: int = 0
    lineage_reconstruction_enabled: bool = True
    # a pushed task unacknowledged this long is probed on the executing
    # worker (HasTask); a definitively-lost push is resent on the same
    # lease instead of hanging the owner forever
    task_push_ack_timeout_s: float = 10.0
    # --- preemption / drain (maintenance watcher + graceful drain) ---
    # how often the TPU maintenance watcher polls the GCE metadata server
    maintenance_poll_interval_s: float = 1.0
    # default drain window when a drain request carries no deadline (GCE
    # preemption gives ~30 s; planned maintenance announces more)
    drain_deadline_s: float = 60.0
    # store-backend collective groups: member-liveness poll period; a dead
    # or draining member aborts the group's pending ops within ~this bound
    collective_abort_poll_interval_s: float = 0.5
    # --- flight recorder / hang diagnosis (_private/flight_recorder.py) ---
    # always-on per-process ring buffer of step phases, collective
    # entry/exit marks, checkpoint/restore and lease/task transitions;
    # ~O(100ns) per record, fixed memory (capacity entries), readable
    # post-mortem via the agent endpoints and dumped on worker crash
    flight_recorder_enabled: bool = True
    flight_recorder_capacity: int = 2048
    # no training progress / a collective member missing for this long
    # triggers the hang sweep (state.diagnose names the blocking member);
    # a pending collective round younger than this is NOT flagged, so a
    # healthy slow step never false-positives
    hang_detect_timeout_s: float = 30.0
    # per-member collective arrival-lag EWMA smoothing (straggler scores:
    # ray_tpu_collective_straggler_lag_seconds)
    straggler_ewma_alpha: float = 0.2
    # --- task events / observability ---
    task_events_enabled: bool = True
    task_events_max_buffer: int = 10000
    # distributed tracing (util/tracing.py): context propagation through
    # TaskSpec + raylet phase events + serve traceparent.  ANDed with
    # task_events_enabled — turning either off restores the near-zero
    # per-task fast path (benchmarks/tracing_overhead_bench.py).
    # Span events share the bounded task sink (task_events_max_buffer
    # ring): heavy traced traffic evicts the oldest events; hot-path
    # emitters (engine step phases) self-rate-limit for this reason.
    tracing_enabled: bool = True
    # --- serve: cache-aware routing / disaggregated LLM serving ---
    # master switch for prefix-digest routing in DeploymentHandle: the
    # router reads per-replica prefix digests (published to the GCS KV by
    # replicas whose callable exposes prefix_digest()) and routes a request
    # to the replica holding the longest matching KV prefix chain, falling
    # back to power-of-two-choices on cold prefixes / overloaded winners
    serve_prefix_routing_enabled: bool = True
    # queue-length probe results (and digest-carried queue depths) are
    # cached this long per replica, so steady-state routing costs zero
    # probe RPCs at high QPS (<= 2 probes per replica per TTL window)
    serve_route_probe_ttl_s: float = 0.25
    # router-side digest refresh period (one KVKeys + KVGets per handle per
    # interval, amortized over every request routed in between)
    serve_prefix_digest_ttl_s: float = 1.0
    # replica-side publish throttle: a changed digest is pushed to the GCS
    # KV at most this often (version-bumped; unchanged digests are skipped)
    serve_prefix_digest_interval_s: float = 1.0
    # digest size cap: the newest N chain hashes (~16 KB JSON at 1024) —
    # compact by design; replicas holding more advertise the newest chains
    serve_prefix_digest_max_hashes: int = 1024
    # a prefix-routing winner whose (cached) queue length exceeds the
    # shorter pow-2 candidate by more than this many requests is considered
    # overloaded and routing falls back to pow-2 (cache affinity must not
    # create hot spots)
    serve_prefix_overload_slack: int = 8
    # --- serve: request-level SLO layer (serve/_private/slo.py) ---
    # master switch for the per-request lifecycle ledger, latency sketches,
    # per-tenant metering and burn-rate monitoring.  Off => the whole layer
    # books NOTHING (no sketch inserts, no KV writes, no flight-recorder
    # events) and the per-token cost is one no-op method call
    serve_slo_enabled: bool = True
    # default per-deployment SLO targets; serve.deployment(slo_config={...})
    # overrides per deployment (keys: slo_ttft_ms, slo_itl_ms,
    # slo_availability)
    serve_slo_ttft_ms: float = 2000.0
    serve_slo_itl_ms: float = 200.0
    serve_slo_availability: float = 0.99
    # burn-rate gauge + KV snapshot publish throttle (piggybacks on request
    # completions — an idle deployment publishes nothing)
    serve_slo_publish_interval_s: float = 2.0
    # per-process recent-requests forensics ring (state.recent_requests());
    # each KV snapshot ships the newest serve_slo_recent_publish of them
    serve_slo_recent_capacity: int = 256
    serve_slo_recent_publish: int = 64
    # burn rate above this is reported as a breach by state.serving_slo()
    # (1.0 = consuming error budget exactly as fast as the SLO allows)
    serve_slo_burn_alert: float = 1.0
    # --- serve: tenant-fair ingress admission (serve/_private/admission.py) --
    # master switch for the ingress admission gate: per-tenant token-rate
    # buckets, weighted-fair queueing and burn-rate load shedding at the
    # proxy.  Off => every request is admitted unconditionally and the gate
    # books NOTHING (byte-identical metric surface, perf-smoke pinned)
    serve_admission_enabled: bool = True
    # per-tenant token bucket: sustained admissions/s and burst capacity.
    # rate <= 0 disables rate limiting (fair queueing + shedding still
    # apply); a tenant over its bucket gets 429 + Retry-After
    serve_admission_tenant_rate: float = 0.0
    serve_admission_tenant_burst: float = 32.0
    # weighted-fair queueing weights, "tenant=weight,tenant2=weight"; tenants
    # not listed get weight 1.0.  Under saturation admitted work is
    # interleaved in weight proportion; an idle tenant never blocks others
    # (work conservation)
    serve_admission_weights: str = ""
    # burn-rate shed threshold: when the target deployment's short-window
    # availability burn exceeds this, new requests are shed with 503 +
    # Retry-After before the queue collapses.  <= 0 disables burn shedding
    serve_admission_shed_burn: float = 8.0
    # per-tenant admitted-but-not-finished cap: a tenant at its in-flight
    # ceiling is shed with 503 (protects the proxy from a single tenant
    # consuming every handle thread).  <= 0 disables
    serve_admission_max_inflight: int = 0
    # Retry-After floor (seconds) on 503 shed responses (429 responses
    # compute the exact bucket refill time instead)
    serve_admission_retry_after_s: float = 1.0
    # bounded fair backlog behind the proxy's handle threads: admitted
    # work beyond the running threads queues in weighted-fair order up to
    # this deep, past which requests are shed with 503 + Retry-After (the
    # executor queue can never grow unboundedly)
    serve_admission_backlog: int = 128
    # --- serve: ingress tier (serve/_private/ingress.py) ---
    # proxy replicas started by serve.start_ingress() behind one front
    # endpoint; connections pin to a proxy by peer address (rendezvous
    # hash), so SSE streams and reconnects keep session affinity
    serve_ingress_proxies: int = 2
    # --- serve: SLO-feedback pool autoscaler (pool_autoscaler.py) ---
    # master switch for the controller-side loop that subscribes to watch
    # ALERT transitions (serve_ttft_burn / serve_itl_burn) and actuates
    # prefill/decode pool replica counts
    serve_pool_autoscaler_enabled: bool = True
    # replicas added per firing burn alert, and the cooldown between
    # actuations on the same pool (hysteresis against alert flapping)
    serve_pool_scale_step: int = 1
    serve_pool_scale_cooldown_s: float = 30.0
    serve_pool_min_replicas: int = 1
    serve_pool_max_replicas: int = 8
    # scale-down guard: a pool is only shrunk while its alert is clear AND
    # the utilization fold shows mean duty cycle below this headroom
    # threshold (never shrink a busy pool on a quiet alert alone)
    serve_pool_scale_down_headroom: float = 0.5
    # --- serve: live KV migration (serve/_private/kv_migration.py) ---
    # master switch for decode->decode stream migration: the controller's
    # migrate-first drain path and the queue-depth rebalance trigger.
    # Off => draining replicas wait out their streams (as before migration existed)
    # and the engine/serve layers book NOTHING migration-related
    serve_migration_enabled: bool = True
    # handoff transport: "object" ships KV host arrays through the actor
    # call payload (plasma); "channel" stages them through an
    # XlaTensorChannel like the P/D handoff (adds int8 on-wire option)
    serve_migration_transport: str = "object"
    # rebalance trigger: migrate streams off a replica only when the
    # queue-depth gap between the hottest and coldest replica of a
    # deployment exceeds this many requests...
    serve_migration_rebalance_threshold: int = 8
    # ...for this many consecutive planner ticks (hysteresis: a
    # transient burst never triggers a migration storm)
    serve_migration_rebalance_ticks: int = 3
    # per-replica migration-rate cap (token bucket, streams/second):
    # bounds how fast rebalancing can move streams off any one replica,
    # so planner oscillation can never thrash the pool
    serve_migration_max_rate_per_s: float = 4.0
    # max streams moved per rebalance actuation (drain evacuation is
    # never capped — it must empty the replica)
    serve_migration_rebalance_batch: int = 2
    # --- device telemetry (_private/device_telemetry.py) ---
    # master switch for the chip-level observability layer: per-device HBM
    # gauges, per-deployment engine utilization/headroom gauges, the
    # process-wide jit-compile watch and the MFU gauges.  Off => engines
    # never attach a telemetry recorder (the per-step cost is one attribute
    # read + None check) and the layer books NOTHING
    device_telemetry_enabled: bool = True
    # engine-step gauge flush throttle: note_step() updates plain slots
    # every step and flushes bound gauges at most this often
    device_telemetry_flush_interval_s: float = 0.5
    # compile-observer heartbeat: while this process is alive the telemetry
    # heartbeat thread re-pushes metrics at this period so a replica stuck
    # in a long jit compile reports stale-but-present gauges instead of
    # being swept by the GCS's silent-reporter gauge expiry
    device_telemetry_heartbeat_s: float = 5.0
    # compile-storm detector (state.diagnose): this many observed
    # traces/compiles of the SAME program inside the window names the
    # program and its callers in the diagnose report
    compile_storm_threshold: int = 5
    compile_storm_window_s: float = 60.0
    # replica-side utilization publish period (KV row per replica:
    # free slots/blocks, duty cycle, HBM split — the autoscaler's input)
    utilization_publish_interval_s: float = 2.0
    # --- metrics history + watch engine (_private/metrics_history.py) ---
    # master switch for the in-GCS time-series store and the watch-rule
    # engine.  Off => the GCS constructs NEITHER (history/watch stay None)
    # and the only addition to ReportMetrics is one attribute read + None
    # check (benchmarks/watch_overhead_bench.py gates it)
    metrics_history_enabled: bool = True
    # cheap per-push gate: the GCS folds the cluster aggregate into the
    # history at most this often (pushes in between pay one clock read)
    metrics_history_fold_interval_s: float = 5.0
    # raw ring: bucket width and trailing retention (default 10s for 15min)
    metrics_history_raw_step_s: float = 10.0
    metrics_history_raw_retention_s: float = 900.0
    # rollup ring: coarse buckets for the long view (default 60s for 4h)
    metrics_history_rollup_step_s: float = 60.0
    metrics_history_rollup_retention_s: float = 14400.0
    # hard global byte cap on the whole history store, counter-enforced;
    # exceeded => whole tagsets are LRU-evicted (oldest fold first), so
    # adversarial tag churn degrades coverage, never memory
    metrics_history_max_bytes: int = 8 * 1024**2
    # shrink-only per-family retention overrides:
    # "family=seconds,family2=seconds" (caps BOTH rings for that family)
    metrics_history_family_retention: str = ""
    # watch engine: rule evaluation on the GCS health tick.  ANDed with
    # metrics_history_enabled (rules read the history store)
    watch_rules_enabled: bool = True
    # ship the built-in rule pack (kv occupancy, queue growth, input wait,
    # compile storm, straggler lag, goodput drop, dead reporter, serve
    # burn); off => only explicitly added rules run
    watch_builtin_rules_enabled: bool = True
    # --- lock-order witness (_private/analysis/lock_witness.py) ---
    # test/chaos-lane knob: locks built through make_lock/make_rlock become
    # lockdep-style witnesses that record per-thread acquisition stacks,
    # maintain the global acquired-while-holding edge set, and record the
    # first cycle-forming acquisition (both stacks) into the flight
    # recorder + state.diagnose().  Off (the default) the factories return
    # raw threading locks — the acquisition path is byte-identical to
    # pre-witness code (benchmarks/lint_overhead_bench.py)
    lock_witness_enabled: bool = False
    # --- testing / chaos ---
    # Format mirrors RAY_testing_rpc_failure (reference: src/ray/rpc/rpc_chaos.h:23-35):
    # "method1=max_failures:req_prob:resp_prob,method2=..."
    testing_rpc_failure: str = ""
    # Deterministic preemption injection for the maintenance watcher
    # (chaos-style, like testing_rpc_failure): "<delay_s>:<kind>:<deadline_s>"
    # e.g. "0.5:preempted:30" — after 0.5 s the watcher reports a synthetic
    # preemption notice with a 30 s deadline.  Empty disables.  Tests that
    # want to preempt ONE node of a cluster pass the same spec to that
    # node's Raylet directly (testing_preemption_notice=...) instead.
    testing_preemption_notice: str = ""
    # Deterministic fault injection for live KV migration
    # (serve/_private/kv_migration.py), chaos-style like
    # testing_preemption_notice: "<phase>:<mode>" where phase is one of
    # export / transfer / import / splice and mode is "fail" (the phase
    # raises) or "refuse" (import only: the destination reports
    # no-capacity).  e.g. "import:fail" — every import attempt dies, so
    # migration must degrade to the next candidate / recompute / local
    # restore with zero dropped streams.  Empty disables.
    testing_migration_fault: str = ""

    def __post_init__(self):
        for f in fields(self):
            raw = os.environ.get(f"RAY_TPU_{f.name}")
            if raw is not None:
                setattr(self, f.name, _coerce(raw, f.default))

    def to_blob(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_blob(cls, blob: str) -> "RayTpuConfig":
        cfg = cls()
        for k, v in json.loads(blob).items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg


_global_config: RayTpuConfig | None = None


def global_config() -> RayTpuConfig:
    global _global_config
    if _global_config is None:
        _global_config = RayTpuConfig()
    return _global_config


def set_global_config(cfg: RayTpuConfig):
    global _global_config
    _global_config = cfg
