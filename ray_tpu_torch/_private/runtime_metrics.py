"""Built-in runtime metrics: the canonical metric set every layer records.

TPU-native analog of the reference's C++ stats registry
(reference: src/ray/stats/metric_defs.cc — ray_scheduler_*, ray_raylet_*,
ray_object_store_*, ray_grpc_server_* families; exposition via the per-node
MetricsAgent, _private/metrics_agent.py).  This module declares every
built-in family ONCE and hands the hot paths constant-cost bound recorders
(util/metrics.py BoundCounter/BoundGauge/BoundHistogram): recording is a
lock + one dict update, flushes piggyback on the existing periodic GCS
pushes (metrics.maybe_push), so instrumentation never adds an RPC to a hot
path.

Naming: ``ray_tpu_<layer>_<what>[_<unit>]``; layers are scheduler, raylet,
gcs, object_store, task, collective, tpu, serve, data.  The full family
list lives in FAMILIES (used by docs and the exposure test).

Tag cardinality discipline: tags are bounded sets (op names, worker states,
resource-shape strings, deployment names) — never ids of unbounded spaces
(task ids, object ids).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.analysis.lock_witness import make_lock
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, Sketch

# latency boundaries tuned for control-plane work: 100 µs .. 30 s
_LATENCY_BOUNDS = [0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0]
# worker spawn spans 50 ms (zygote fork) .. minutes (cold Popen + imports)
_SPAWN_BOUNDS = [0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                 60.0, 180.0]

# ---------------------------------------------------------------------------
# Declarations (one per family; zero-point metrics emit nothing, so
# declaring everything in every process is free until a layer records)
# ---------------------------------------------------------------------------

# -- scheduler --------------------------------------------------------------
SCHEDULE_LATENCY = Histogram(
    "ray_tpu_scheduler_schedule_latency_seconds",
    "Lease enqueue to worker grant, per granted lease",
    boundaries=_LATENCY_BOUNDS, tag_keys=())
PENDING_TASKS = Gauge(
    "ray_tpu_scheduler_pending_tasks",
    "Lease requests queued on this raylet, by resource shape",
    tag_keys=("shape",))
SPILLBACKS = Counter(
    "ray_tpu_scheduler_spillbacks_total",
    "Lease requests redirected to another node")

# -- raylet -----------------------------------------------------------------
WORKER_SPAWN_LATENCY = Histogram(
    "ray_tpu_raylet_worker_spawn_seconds",
    "Worker process spawn to registration",
    boundaries=_SPAWN_BOUNDS, tag_keys=("method",))
WORKER_SPAWNS = Counter(
    "ray_tpu_raylet_worker_spawns_total",
    "Worker spawns by method (zygote fork vs full Popen)",
    tag_keys=("method",))
WORKER_SPAWN_TIMEOUTS = Counter(
    "ray_tpu_raylet_worker_spawn_timeout_total",
    "Spawned workers killed for never registering within the deadline")
ZYGOTE_FALLBACKS = Counter(
    "ray_tpu_raylet_zygote_fallback_total",
    "Zygote spawn attempts that fell back to the Popen path")
WORKERS = Gauge(
    "ray_tpu_raylet_workers",
    "Worker pool population by state",
    tag_keys=("state",))
DISPATCH_SECONDS = Histogram(
    "ray_tpu_raylet_dispatch_seconds",
    "One dispatch-loop pass (queue scan + grant matching); sustained high "
    "values mean the loop lags lease traffic",
    boundaries=_LATENCY_BOUNDS, tag_keys=())

# -- gcs --------------------------------------------------------------------
GCS_RPC_LATENCY = Histogram(
    "ray_tpu_gcs_rpc_latency_seconds",
    "GCS handler execution time per RPC method",
    boundaries=_LATENCY_BOUNDS, tag_keys=("method",))
GCS_SINK_SIZE = Gauge(
    "ray_tpu_gcs_sink_size",
    "GCS observability sink populations (task events, metric reporters, "
    "cluster events)",
    tag_keys=("sink",))
# cluster-view sync (versioned delta protocol): the cost the control plane
# ships per report tick.  kind=full is a whole-cluster snapshot (register,
# version gap, changelog overflow); kind=delta is changed-nodes-only — in
# steady state a delta reply is a constant-size empty frame, so
# rate(delta) staying flat as the cluster grows is the scalability proof.
GCS_SYNC_BYTES = Counter(
    "ray_tpu_gcs_sync_bytes_total",
    "Cluster-view sync payload bytes shipped by the GCS, by reply kind "
    "(full snapshot vs versioned delta)",
    tag_keys=("kind",))
GCS_SYNC_VERSION = Gauge(
    "ray_tpu_gcs_sync_version",
    "Monotonic cluster-view version at the GCS: bumps once per node-state "
    "mutation (register, availability change, DRAINING, DEAD); deltas ship "
    "only mutations since each reporter's known version")
# tree pubsub: RelayPublish sends by role.  root = GCS fan-out (O(fanout)
# per event in tree mode, O(nodes) in flat mode — the A/B axis), relay =
# raylet re-publish into its subtree, fallback = direct delivery around a
# dead relay.
PUBSUB_RELAY_PUBLISHES = Counter(
    "ray_tpu_pubsub_relay_publishes_total",
    "Tree-pubsub RelayPublish sends by role (root = GCS fan-out, relay = "
    "raylet subtree re-publish, fallback = direct push around a dead relay)",
    tag_keys=("role",))
RAYLET_REPORT_FAILURES = Counter(
    "ray_tpu_raylet_report_failures_total",
    "Resource-report ticks that failed to reach the GCS (paired with a "
    "throttled raylet warning, so a flapping GCS link is diagnosable)")

# -- preemption / drain lifecycle -------------------------------------------
# drains can take anywhere from seconds (idle node) to the full platform
# window (minutes of running-lease runout)
_DRAIN_BOUNDS = [0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
                 600.0]
NODE_DRAINS = Counter(
    "ray_tpu_node_drains_total",
    "Nodes entering the DRAINING state, by drain reason",
    tag_keys=("reason",))
NODE_DRAIN_LATENCY = Histogram(
    "ray_tpu_node_drain_latency_seconds",
    "Graceful-drain duration: DRAINING to DEAD(drained)",
    boundaries=_DRAIN_BOUNDS, tag_keys=())

# -- object store -----------------------------------------------------------
STORE_STORED_BYTES = Counter(
    "ray_tpu_object_store_stored_bytes_total",
    "Bytes admitted into the plasma store (creates, incl. transfer receives)")
STORE_SPILLED_BYTES = Counter(
    "ray_tpu_object_store_spilled_bytes_total",
    "Bytes spilled to external storage")
STORE_RESTORED_BYTES = Counter(
    "ray_tpu_object_store_restored_bytes_total",
    "Bytes restored from spilled copies")
STORE_USED_BYTES = Gauge(
    "ray_tpu_object_store_used_bytes",
    "Plasma bytes resident per node",
    tag_keys=("node",))
STORE_OBJECTS = Gauge(
    "ray_tpu_object_store_objects",
    "Objects resident per node",
    tag_keys=("node",))

# -- owner-side lease cache / pipelined submission --------------------------
LEASE_REQUESTS = Counter(
    "ray_tpu_task_lease_requests_total",
    "Owner-side RequestWorkerLease RPCs issued (a batched request counts "
    "once regardless of how many leases it asks for)")
LEASE_REUSE = Counter(
    "ray_tpu_task_lease_reuse_total",
    "Task-to-lease assignments by lease provenance: 'hit' rode a cached "
    "lease, 'new' waited for a fresh grant",
    tag_keys=("outcome",))
TASKS_IN_FLIGHT = Gauge(
    "ray_tpu_task_in_flight",
    "Normal tasks pushed to leased workers and awaiting their reply "
    "(owner-side view)")
LEASE_BATCH_GRANTED = Counter(
    "ray_tpu_raylet_lease_batch_granted_total",
    "Leases granted by this raylet through batched RequestWorkerLease "
    "calls (num_leases > 1)")
LEASES_REVOKED = Counter(
    "ray_tpu_raylet_leases_revoked_total",
    "Reusable leases reclaimed by the raylet (TTL expiry with an empty "
    "worker queue — owner dead or its extensions lost)")

# -- task (worker) ----------------------------------------------------------
TASK_SUBMIT_TO_START = Histogram(
    "ray_tpu_task_submit_to_start_seconds",
    "Owner-side submit to lease-granted (scheduling + spillback latency)",
    boundaries=_LATENCY_BOUNDS, tag_keys=())
TASK_EXECUTION = Histogram(
    "ray_tpu_task_execution_seconds",
    "User-function wall time on the executing worker",
    boundaries=_LATENCY_BOUNDS, tag_keys=("kind",))
TASK_SERIALIZED_BYTES = Counter(
    "ray_tpu_task_serialized_bytes_total",
    "Inline-serialized task payload bytes by direction",
    tag_keys=("direction",))

# -- collective -------------------------------------------------------------
COLLECTIVE_LATENCY = Histogram(
    "ray_tpu_collective_op_seconds",
    "Collective op wall time",
    boundaries=_LATENCY_BOUNDS,
    tag_keys=("op", "backend", "world_size", "dtype"))
COLLECTIVE_BYTES = Counter(
    "ray_tpu_collective_bytes_total",
    "Per-rank payload bytes moved through collectives",
    tag_keys=("op", "backend", "world_size", "dtype"))
COLLECTIVE_BUS_BW = Gauge(
    "ray_tpu_collective_bus_bandwidth_gbps",
    "Derived bus bandwidth of the most recent op (NCCL-tests busbw "
    "convention: allreduce scales payload by 2(n-1)/n)",
    tag_keys=("op", "backend", "world_size", "dtype"))
# compression-aware collectives: logical payload vs what actually
# crossed the wire, per group — rate(wire)/rate(logical) is the live
# savings figure operators read off /api/node_metrics.  Group names are a
# bounded user-chosen set (like serve deployment names), so they are a
# legal tag; ids are not.
COLLECTIVE_LOGICAL_BYTES = Counter(
    "ray_tpu_collective_logical_bytes_total",
    "Per-rank payload bytes at the API boundary of compression-enabled "
    "collective ops (the uncompressed size)",
    tag_keys=("op", "backend", "world_size", "algorithm", "scheme", "group"))
COLLECTIVE_WIRE_BYTES = Counter(
    "ray_tpu_collective_wire_bytes_total",
    "Per-rank bytes that actually crossed the transport for "
    "compression-enabled collective ops (quantized codes + scales, "
    "hierarchical shard traffic)",
    tag_keys=("op", "backend", "world_size", "algorithm", "scheme", "group"))
COLLECTIVE_INTER_SLICE_BYTES = Counter(
    "ray_tpu_collective_inter_slice_bytes_total",
    "DCN-phase share of wire bytes for hierarchical collectives (the "
    "slow-path traffic the algorithm exists to shrink)",
    tag_keys=("op", "backend", "world_size", "group"))
COLLECTIVE_QUANT_ERROR = Gauge(
    "ray_tpu_collective_quant_error",
    "Relative L2 error of the most recent quantized collective's local "
    "round trip (||x - deq(q(x))|| / ||x||)",
    tag_keys=("op", "backend", "world_size", "group"))
COLLECTIVE_ALGORITHM = Counter(
    "ray_tpu_collective_algorithm_total",
    "Collective ops by the algorithm/scheme the selection policy chose",
    tag_keys=("op", "backend", "algorithm", "scheme"))
COLLECTIVE_PLAN = Counter(
    "ray_tpu_collective_plan_total",
    "Planner decisions by chosen algorithm and reason (latency_bound, "
    "bandwidth_bound, dcn_boundary, unaligned_slices, ...) — booked only "
    "when a compression spec is in force; the stock path records nothing",
    tag_keys=("algorithm", "reason"))
COLLECTIVE_ABORTS = Counter(
    "ray_tpu_collective_aborts_total",
    "Collective groups aborted promptly on member death/drain (pending ops "
    "raise CollectiveAbortError instead of hanging to timeout)",
    tag_keys=("backend", "group"))
# hang / straggler diagnosis (flight recorder + arrival monitor): rank is a
# bounded tag (collective world sizes are small, user-chosen groups)
COLLECTIVE_STRAGGLER_LAG = Gauge(
    "ray_tpu_collective_straggler_lag_seconds",
    "Per-member collective arrival-lag EWMA (seconds behind the round's "
    "first arrival; persistently high = this rank is the straggler)",
    tag_keys=("group", "rank"))
HANG_SWEEPS = Counter(
    "ray_tpu_hang_sweeps_total",
    "Cluster-wide hang-diagnosis sweeps triggered (watchdog or explicit "
    "state.diagnose), by trigger source",
    tag_keys=("source",))

# -- train goodput ledger ---------------------------------------------------
# job wall-clock classified into buckets that sum exactly to the wall (the
# cost-accounting view of arxiv 2605.25645); run names are user-chosen and
# bounded, like serve deployment names.  A gauge mirroring the ledger's
# authoritative bucket values — NOT a counter: reclassification (input_wait
# carved out of productive_step) moves already-accrued seconds between
# buckets, which monotonic counters cannot represent without breaking the
# buckets-sum-to-wall-clock invariant on the metric surface
TRAIN_GOODPUT_SECONDS = Gauge(
    "ray_tpu_train_goodput_seconds",
    "Train-controller wall-clock by bucket: productive_step, checkpoint, "
    "restore, preemption_recovery, input_wait, stall (sums to wall-clock)",
    tag_keys=("run", "bucket"))
TRAIN_GOODPUT_RATIO = Gauge(
    "ray_tpu_train_goodput_ratio",
    "productive_step share of the run's wall-clock so far",
    tag_keys=("run",))

# -- tpu --------------------------------------------------------------------
TPU_CHIPS = Gauge(
    "ray_tpu_tpu_chips",
    "TPU chips per node by claim state",
    tag_keys=("node", "state"))
TPU_PROCESS_CHIPS = Gauge(
    "ray_tpu_tpu_process_chips",
    "TPU chips bound to this worker process via visible-chip carving")

# -- serve ------------------------------------------------------------------
SERVE_REQUEST_LATENCY = Histogram(
    "ray_tpu_serve_request_latency_seconds",
    "Replica-side request handling latency",
    boundaries=_LATENCY_BOUNDS, tag_keys=("app", "deployment"))
SERVE_REQUESTS = Counter(
    "ray_tpu_serve_replica_requests_total",
    "Requests handled by replicas (rate() = per-deployment QPS)",
    tag_keys=("app", "deployment"))
# tiered prefix cache (paged engine HBM chain-hash -> host RAM -> plasma)
# + cache-aware routing.  Tier / stage / transport are tiny fixed sets.
# Hit/miss unit is one KV BLOCK (block_size tokens): rate(hits)/(rate(hits)
# + rate(misses)) is the live prefix-cache hit rate; recorded only when
# prefix caching is enabled — the disabled path books nothing.
SERVE_PREFIX_CACHE_HITS = Counter(
    "ray_tpu_serve_prefix_cache_hits_total",
    "Prompt KV blocks served from the prefix cache, by tier "
    "(hbm = chain-hash pool match, host = host-RAM revival, plasma = "
    "object-store revival, router = routed to the replica already holding "
    "the chain)",
    tag_keys=("tier",))
SERVE_PREFIX_CACHE_MISSES = Counter(
    "ray_tpu_serve_prefix_cache_misses_total",
    "Prompt KV blocks that had to be prefilled fresh (no tier held them)",
    tag_keys=("tier",))
SERVE_PREFIX_CACHE_EVICTIONS = Counter(
    "ray_tpu_serve_prefix_cache_evictions_total",
    "Cached KV blocks evicted from a tier under pressure (an hbm eviction "
    "that demotes to host RAM still counts here)",
    tag_keys=("tier",))
# prefill -> decode KV-block handoff (disaggregated serving)
KV_HANDOFF_BYTES = Counter(
    "ray_tpu_kv_handoff_bytes_total",
    "KV-cache bytes handed from prefill to decode replicas, by transport "
    "(object = plasma/inline actor-call payload, channel = device-tensor "
    "channel, channel_int8 = quantized channel)",
    tag_keys=("transport",))
KV_HANDOFF_LATENCY = Histogram(
    "ray_tpu_kv_handoff_latency_seconds",
    "Wall time of one KV handoff leg: receive + pool scatter under the "
    "plain transport tag (one observation per handoff — the authoritative "
    "count); export gather + transfer enqueue under <transport>_export",
    boundaries=_LATENCY_BOUNDS, tag_keys=("transport",))
# decode -> decode live KV migration (serve/_private/kv_migration.py).
# Booked ONLY when a migration actually runs — serve_migration_enabled off
# (or simply no migration traffic) books nothing and the engine step is
# byte-identical (perf-smoke pinned).  reason = why the stream moved
# (drain / rebalance / manual); outcome = migrated (KV moved, splice ok) /
# fallback (a phase failed and the stream survived via next-candidate,
# recompute, or local restore) / lost (no recovery path left — must stay
# 0 in every chaos lane).
SERVE_KV_MIGRATIONS = Counter(
    "ray_tpu_serve_kv_migrations_total",
    "Live stream migrations between decode replicas (reason = drain / "
    "rebalance / manual; outcome = migrated / fallback = a phase failed "
    "and the stream survived via recompute-or-retry / lost)",
    tag_keys=("reason", "outcome"))
SERVE_KV_MIGRATION_LATENCY = Histogram(
    "ray_tpu_serve_kv_migration_latency_seconds",
    "Wall time of one live-migration phase (export = drain + KV gather on "
    "the source, transfer = handoff staging, import = destination scatter "
    "+ draft re-seed, splice = waiter relay install, total = source-pause "
    "to resumed decode — the client-visible stall bound)",
    boundaries=_LATENCY_BOUNDS, tag_keys=("phase",))
SERVE_DISAGG_QUEUE_DEPTH = Gauge(
    "ray_tpu_serve_disagg_queue_depth",
    "Live requests per disaggregated serving stage (prefill = queued + "
    "mid-prefill, decode = decode-active slots)",
    tag_keys=("stage",))
# -- serving SLO layer (request lifecycle ledger, serve/_private/slo.py) ----
# Mergeable quantile sketches (kind=sketch, lossless cluster fold through
# the GCS aggregate): TTFT and per-token inter-token latency at the ingress
# split by tenant; per-stage durations replica/engine-side.  Tenant ids are
# a bounded operator-assigned set (like deployment names); the SLO layer
# caps the tag value length.  Recorded only when serve_slo_enabled — the
# disabled path books nothing anywhere in the lifecycle.
SERVE_TTFT = Sketch(
    "ray_tpu_serve_ttft_seconds",
    "Time to first token per request at the serving ingress (sketch: "
    "cluster-mergeable p50/p99 within 2% relative error)",
    relative_accuracy=0.01, tag_keys=("deployment", "tenant"))
SERVE_ITL = Sketch(
    "ray_tpu_serve_itl_seconds",
    "Per-token inter-token latency during streamed decode at the serving "
    "ingress (one weighted insert per SSE frame)",
    relative_accuracy=0.01, tag_keys=("deployment", "tenant"))
SERVE_STAGE_SECONDS = Sketch(
    "ray_tpu_serve_stage_seconds",
    "Per-request serving-stage durations: proxy_queue (executor wait), "
    "queue_wait (engine admission), prefill, handoff (P/D import leg), "
    "decode (first token to completion), total",
    relative_accuracy=0.01, tag_keys=("deployment", "stage"))
SERVE_ROUTE_DECISIONS = Counter(
    "ray_tpu_serve_route_decisions_total",
    "Cache-aware router outcomes per routed request (prefix_hit = longest-"
    "chain affinity won, pow2_cold = no chain matched, overload_divert = "
    "affinity winner over the overload slack, stale_row = the would-be "
    "winner's digest row left the live set, shun_resubmit = re-route after "
    "a caller observed the replica dead)",
    tag_keys=("reason",))
SERVE_SLO_REQUESTS = Counter(
    "ray_tpu_serve_slo_requests_total",
    "Requests reaching a terminal lifecycle state at the serving ingress "
    "(ok / error / aborted = client disconnect / shed = admission refusal)",
    tag_keys=("deployment", "tenant", "status"))
# draft-model speculative decoding (paged engine).  Booked ONLY when a
# speculative_config is in force — the disabled path (the default) books
# nothing, the same invariant as the rest of the SLO layer.  deployment =
# the serving deployment's label ("engine" for direct engine use).
# accepted/proposed over a window is the live acceptance rate; accepted
# alone is the decode tokens that cost ZERO extra target forwards.
SERVE_SPECDEC_PROPOSED = Counter(
    "ray_tpu_serve_specdec_proposed_tokens_total",
    "Draft-model tokens proposed for target verification (k per slot per "
    "speculative step)",
    tag_keys=("deployment",))
SERVE_SPECDEC_ACCEPTED = Counter(
    "ray_tpu_serve_specdec_accepted_tokens_total",
    "Drafted tokens accepted by target verification (each one is a decode "
    "token emitted without its own target forward pass)",
    tag_keys=("deployment",))
# planner-routed tensor-parallel serving collectives (llm/paged.py): the
# per-layer decode/verify/prefill allreduces of a TP-sharded engine, by
# the algorithm the α-β planner chose.  Booked ONLY when the engine is
# sharded with planned collectives on — the single-device / disabled path
# books nothing and the metric surface stays byte-identical (tier-1
# pinned).  seconds are the α-β model's attribution (host timing cannot
# see inside the async dispatch pipeline without fencing it).
SERVE_TP_COLLECTIVE_SECONDS = Counter(
    "ray_tpu_serve_tp_collective_seconds",
    "Modeled seconds spent in planner-routed tensor-parallel serving "
    "collectives (α-β cost x dispatched collective count)",
    tag_keys=("deployment", "algorithm"))
SERVE_TP_COLLECTIVE_BYTES = Counter(
    "ray_tpu_serve_tp_collective_bytes_total",
    "Logical bytes moved through planner-routed tensor-parallel serving "
    "collectives (2 per-layer allreduces per dispatched program)",
    tag_keys=("deployment", "algorithm"))
# tenant-fair ingress admission (serve/_private/admission.py).  Booked ONLY
# when serve_admission_enabled — the disabled path books nothing and the
# metric surface is byte-identical (perf-smoke pinned).  decision is a tiny
# fixed set: admit / throttle (per-tenant token bucket exhausted, 429) /
# shed (burn-rate or capacity shed, 503).  Tenant ids are the same bounded
# operator-assigned set the SLO layer caps.
SERVE_ADMISSION = Counter(
    "ray_tpu_serve_admission_total",
    "Ingress admission decisions per tenant (admit / throttle = token "
    "bucket exhausted -> 429 + Retry-After / shed = burn-rate or capacity "
    "refusal -> 503 + Retry-After)",
    tag_keys=("tenant", "decision"))
SERVE_TENANT_QUEUE_DEPTH = Gauge(
    "ray_tpu_serve_tenant_queue_depth",
    "Admitted-but-unfinished ingress requests per tenant (the weighted-"
    "fair scheduler's live backlog view)",
    tag_keys=("tenant",))
SERVE_SLO_BURN_RATE = Gauge(
    "ray_tpu_serve_slo_burn_rate",
    "SLO error-budget burn rate per deployment, objective (ttft / itl / "
    "availability) and trailing window (5m / 1h): breach fraction over the "
    "window divided by the budget (1 - slo_availability); >1 burns budget "
    "faster than the SLO allows",
    tag_keys=("deployment", "window", "objective"))

# -- data -------------------------------------------------------------------
DATA_ROWS = Counter(
    "ray_tpu_data_rows_total",
    "Rows emitted by streaming-executor operators (rate() = rows/s)",
    tag_keys=("operator",))
DATA_BACKPRESSURE = Counter(
    "ray_tpu_data_backpressure_total",
    "Dispatches deferred by the per-operator memory budget",
    tag_keys=("operator",))
# train-ingest data plane (data/_internal/ingest.py + the streaming-split
# coordinator): the datasource -> plasma -> host-view -> device pipeline
# feeding the trainer.  kind on the bytes counter distinguishes zero-copy
# views over plasma buffers from host memcpys (ragged batch boundaries,
# null/bit-packed columns) — the zero-copy invariant is perf-smoke-gated
# on the copy side staying at zero for aligned fixed-dtype streams.
DATA_INGEST_ROWS = Counter(
    "ray_tpu_data_ingest_rows_total",
    "Rows delivered to a consumer by the ingest iterators (rate() = "
    "ingest rows/s)",
    tag_keys=("source",))
DATA_INGEST_BYTES = Counter(
    "ray_tpu_data_ingest_bytes_total",
    "Host-batch bytes delivered by the ingest iterators, split by kind: "
    "view = numpy views aliasing plasma shared memory (zero-copy), "
    "copy = host memcpys (ragged batch boundaries, chunked/null columns)",
    tag_keys=("source", "kind"))
DATA_INGEST_BUFFER = Gauge(
    "ray_tpu_data_ingest_buffer_occupancy",
    "Prefetch buffer occupancy per pipeline stage (host = decoded host "
    "batches, device = device-resident batches awaiting hand-off)",
    tag_keys=("stage",))
DATA_INGEST_BACKPRESSURE = Counter(
    "ray_tpu_data_ingest_backpressure_total",
    "Ingest backpressure events: split = the streaming-split coordinator "
    "parked a producer pull because a consumer's buffer hit its cap, "
    "host/device = a full prefetch buffer parked the producer thread",
    tag_keys=("stage",))
DATA_INGEST_WAIT = Counter(
    "ray_tpu_data_ingest_wait_seconds_total",
    "Seconds a consumer spent blocked on an EMPTY ingest buffer (real "
    "buffer-empty waits; the source of the goodput ledger's input_wait "
    "bucket)",
    tag_keys=("source",))

# -- train checkpoint/snapshot subsystem (train/_internal/snapshot.py) ------
# async per-shard snapshots: bytes actually written per persistence kind
# (full = periodic whole-state snapshot, delta = changed-leaves-only write,
# replica = host-RAM copy pushed to the ring neighbor), the step-blocking
# stall the pipeline could NOT hide (backpressure + device→host staging —
# the <1%-of-step-time acceptance surface), and whether a snapshot is
# draining on the background thread right now.
TRAIN_SNAPSHOT_BYTES = Counter(
    "ray_tpu_train_snapshot_bytes_total",
    "Checkpoint-subsystem bytes written by kind: full = periodic full "
    "snapshot, delta = changed leaves only, replica = peer host-RAM push",
    tag_keys=("kind",))
TRAIN_SNAPSHOT_STALL = Counter(
    "ray_tpu_train_snapshot_stall_seconds_total",
    "Training-thread seconds spent inside SnapshotManager.save(): "
    "at-most-one-in-flight backpressure plus the device→host staging copy "
    "— the checkpoint-induced step stall the async pipeline could not hide")
TRAIN_SNAPSHOT_INFLIGHT = Gauge(
    "ray_tpu_train_snapshot_inflight",
    "Snapshots currently draining on the background persistence thread "
    "(0 or 1: the manager enforces at-most-one-in-flight)")

# -- rllib RL execution paths (rllib/anakin.py, rllib/sebulba.py) -----------
# Podracer-class throughput accounting: env-steps by execution path (anakin =
# co-located fully-jitted rollout+update, sebulba = decoupled EnvRunner
# actors streaming fragments to the learner, sync = the synchronous
# sample-the-group baseline), the Sebulba bounded sample queue's live depth
# (the backpressure surface between continuous samplers and the learner),
# and the measured policy lag (learner version minus the behavior version a
# fragment was sampled under — the staleness V-trace is correcting).
RL_ENV_STEPS = Counter(
    "ray_tpu_rl_env_steps_total",
    "Environment transitions consumed by an RL execution path (rate() = "
    "env-steps/s), by path: anakin / sebulba / async / sync",
    tag_keys=("path",))
RL_SAMPLE_QUEUE_DEPTH = Gauge(
    "ray_tpu_rl_sample_queue_depth",
    "Fragments buffered in the Sebulba learner's bounded sample queue "
    "(capacity caps runner-ahead-of-learner staleness)")
RL_POLICY_LAG = Histogram(
    "ray_tpu_rl_policy_lag_updates",
    "Learner updates between a fragment's behavior policy version and the "
    "learner version that consumed it (0 = on-policy; V-trace's importance "
    "ratios correct the rest)",
    boundaries=[0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0], tag_keys=())

# -- device telemetry (_private/device_telemetry.py) --------------
# The chip-level observability pillar: per-device HBM live bytes (device
# memory stats on TPU, live-arrays fallback on CPU hosts), the paged
# engine's HBM split (weights vs KV pool vs transient activations), the
# per-deployment utilization/headroom gauges the SLO-feedback autoscaler
# scales on (ROADMAP item 1), the process-wide jit-compile watch, and the
# MFU/roofline gauges.  Everything here is recorded OUTSIDE engine locks
# (the note_step values are captured under the lock into locals and booked
# after release, same discipline as the PhaseRecorder stamps).
DEVICE_HBM_BYTES = Gauge(
    "ray_tpu_device_hbm_bytes",
    "Per-device HBM bytes by kind: used = live bytes in use (device "
    "memory_stats where available, summed live-array bytes on hosts "
    "without allocator stats), limit = allocator capacity (0 when the "
    "backend does not report one)",
    tag_keys=("device", "kind"))
ENGINE_HBM_BYTES = Gauge(
    "ray_tpu_engine_hbm_bytes",
    "Paged-engine HBM breakdown per deployment: weights = model parameter "
    "bytes, kv_pool = paged KV-cache pool bytes (draft pool included under "
    "speculative decoding), transient = device live bytes minus weights "
    "and pool (activations, staging buffers; clamped at zero)",
    tag_keys=("deployment", "segment"))
ENGINE_SLOT_OCCUPANCY = Gauge(
    "ray_tpu_engine_slot_occupancy_ratio",
    "Decode slot occupancy per deployment: active slots / max_batch "
    "(headroom = 1 - occupancy; the autoscaler's decode-pool signal)",
    tag_keys=("deployment",))
ENGINE_KV_OCCUPANCY = Gauge(
    "ray_tpu_engine_kv_block_occupancy_ratio",
    "KV block-pool occupancy per deployment: (total - free) / total "
    "blocks (1.0 means the next allocation preempts)",
    tag_keys=("deployment",))
ENGINE_PREFILL_SPEND = Gauge(
    "ray_tpu_engine_prefill_budget_spend_ratio",
    "Fraction of the chunked-prefill token budget spent on the last "
    "engine step (sustained 1.0 = prefill-bound; 0 = decode-only steps)",
    tag_keys=("deployment",))
ENGINE_STEP_DUTY = Gauge(
    "ray_tpu_engine_step_duty_cycle",
    "Engine step duty cycle per deployment: device-dispatch seconds over "
    "wall seconds since the previous step ended (1.0 = the engine loop "
    "never idles; low values with queued work indicate a stalled loop)",
    tag_keys=("deployment",))
JIT_COMPILES = Counter(
    "ray_tpu_jit_compiles_total",
    "XLA backend compiles observed by the process-wide compile watch, by "
    "program (instrumented call sites name their program; unattributed "
    "compiles book under '_jax')",
    tag_keys=("program",))
JIT_COMPILE_SECONDS = Counter(
    "ray_tpu_jit_compile_seconds_total",
    "Seconds spent in XLA backend compilation, by program (same "
    "attribution as ray_tpu_jit_compiles_total)",
    tag_keys=("program",))
TRAIN_MFU = Gauge(
    "ray_tpu_train_mfu_ratio",
    "Model FLOPs utilization per train run: model FLOPs/s (cost_analysis "
    "per program, cached) over the device's peak FLOPs/s",
    tag_keys=("run",))
SERVE_TOKENS_PER_CHIP = Gauge(
    "ray_tpu_serve_tokens_per_chip_per_s",
    "Serving throughput normalized per chip (aggregate decoded tokens/s "
    "divided by the chips the deployment occupies) — the headline "
    "cost-per-token comparison figure",
    tag_keys=("deployment",))

# -- metrics history + watch engine (_private/metrics_history.py) -----------
# The in-GCS time-series store and declarative alert rules.
# Alert transitions are counted (not gauged) so Prometheus increase() sees
# every firing even between scrapes; the history footprint gauges are the
# byte-cap observability surface (the cap itself is enforced in-store).
WATCH_ALERTS = Counter(
    "ray_tpu_watch_alerts_total",
    "Watch-rule alert transitions by rule and state (firing = breach held "
    "past for_s, cleared = recovery held past clear_for_s)",
    tag_keys=("rule", "state"))
METRICS_HISTORY_BYTES = Gauge(
    "ray_tpu_metrics_history_bytes",
    "Estimated bytes held by the GCS metrics-history store (counter-"
    "enforced against metrics_history_max_bytes by LRU tagset eviction)")
METRICS_HISTORY_SERIES = Gauge(
    "ray_tpu_metrics_history_series",
    "(family, tagset) series currently retained by the GCS metrics-"
    "history store")

FAMILIES = (
    SCHEDULE_LATENCY, PENDING_TASKS, SPILLBACKS,
    WORKER_SPAWN_LATENCY, WORKER_SPAWNS, WORKER_SPAWN_TIMEOUTS,
    ZYGOTE_FALLBACKS, WORKERS, DISPATCH_SECONDS,
    GCS_RPC_LATENCY, GCS_SINK_SIZE,
    GCS_SYNC_BYTES, GCS_SYNC_VERSION, PUBSUB_RELAY_PUBLISHES,
    RAYLET_REPORT_FAILURES,
    NODE_DRAINS, NODE_DRAIN_LATENCY,
    STORE_STORED_BYTES, STORE_SPILLED_BYTES, STORE_RESTORED_BYTES,
    STORE_USED_BYTES, STORE_OBJECTS,
    LEASE_REQUESTS, LEASE_REUSE, TASKS_IN_FLIGHT, LEASE_BATCH_GRANTED,
    LEASES_REVOKED,
    TASK_SUBMIT_TO_START, TASK_EXECUTION, TASK_SERIALIZED_BYTES,
    COLLECTIVE_LATENCY, COLLECTIVE_BYTES, COLLECTIVE_BUS_BW,
    COLLECTIVE_LOGICAL_BYTES, COLLECTIVE_WIRE_BYTES,
    COLLECTIVE_INTER_SLICE_BYTES, COLLECTIVE_QUANT_ERROR,
    COLLECTIVE_ALGORITHM, COLLECTIVE_PLAN, COLLECTIVE_ABORTS,
    COLLECTIVE_STRAGGLER_LAG, HANG_SWEEPS,
    TRAIN_GOODPUT_SECONDS, TRAIN_GOODPUT_RATIO,
    TPU_CHIPS, TPU_PROCESS_CHIPS,
    SERVE_REQUEST_LATENCY, SERVE_REQUESTS,
    SERVE_PREFIX_CACHE_HITS, SERVE_PREFIX_CACHE_MISSES,
    SERVE_PREFIX_CACHE_EVICTIONS,
    KV_HANDOFF_BYTES, KV_HANDOFF_LATENCY, SERVE_DISAGG_QUEUE_DEPTH,
    SERVE_KV_MIGRATIONS, SERVE_KV_MIGRATION_LATENCY,
    SERVE_TTFT, SERVE_ITL, SERVE_STAGE_SECONDS, SERVE_ROUTE_DECISIONS,
    SERVE_SLO_REQUESTS, SERVE_SLO_BURN_RATE,
    SERVE_ADMISSION, SERVE_TENANT_QUEUE_DEPTH,
    SERVE_SPECDEC_PROPOSED, SERVE_SPECDEC_ACCEPTED,
    SERVE_TP_COLLECTIVE_SECONDS, SERVE_TP_COLLECTIVE_BYTES,
    DATA_ROWS, DATA_BACKPRESSURE,
    DATA_INGEST_ROWS, DATA_INGEST_BYTES, DATA_INGEST_BUFFER,
    DATA_INGEST_BACKPRESSURE, DATA_INGEST_WAIT,
    TRAIN_SNAPSHOT_BYTES, TRAIN_SNAPSHOT_STALL, TRAIN_SNAPSHOT_INFLIGHT,
    RL_ENV_STEPS, RL_SAMPLE_QUEUE_DEPTH, RL_POLICY_LAG,
    DEVICE_HBM_BYTES, ENGINE_HBM_BYTES,
    ENGINE_SLOT_OCCUPANCY, ENGINE_KV_OCCUPANCY,
    ENGINE_PREFILL_SPEND, ENGINE_STEP_DUTY,
    JIT_COMPILES, JIT_COMPILE_SECONDS,
    TRAIN_MFU, SERVE_TOKENS_PER_CHIP,
    WATCH_ALERTS, METRICS_HISTORY_BYTES, METRICS_HISTORY_SERIES,
)

# ---------------------------------------------------------------------------
# Bound fast paths for untagged hot-loop metrics
# ---------------------------------------------------------------------------

_schedule_latency = SCHEDULE_LATENCY.with_tags()
_dispatch_seconds = DISPATCH_SECONDS.with_tags()
_spillbacks = SPILLBACKS.with_tags()
_submit_to_start = TASK_SUBMIT_TO_START.with_tags()
_stored_bytes = STORE_STORED_BYTES.with_tags()
_spilled_bytes = STORE_SPILLED_BYTES.with_tags()
_restored_bytes = STORE_RESTORED_BYTES.with_tags()
_spawn_timeouts = WORKER_SPAWN_TIMEOUTS.with_tags()
_zygote_fallbacks = ZYGOTE_FALLBACKS.with_tags()
_history_bytes = METRICS_HISTORY_BYTES.with_tags()
_history_series = METRICS_HISTORY_SERIES.with_tags()

# dynamic-tag recorders are bound once per tag-set and cached; the key
# spaces are small (rpc method names, op × world-size, deployment names)
_BOUND_CACHE: Dict[Tuple, object] = {}
_BOUND_LOCK = make_lock("runtime_metrics._BOUND_LOCK")
_BOUND_CACHE_MAX = 4096  # runaway-cardinality backstop


def _bound(metric, **tags):
    key = (metric._name, tuple(sorted(tags.items())))
    b = _BOUND_CACHE.get(key)
    if b is None:
        with _BOUND_LOCK:
            b = _BOUND_CACHE.get(key)
            if b is None:
                if len(_BOUND_CACHE) >= _BOUND_CACHE_MAX:
                    _BOUND_CACHE.clear()
                b = _BOUND_CACHE[key] = metric.with_tags(tags)
    return b


# ---------------------------------------------------------------------------
# Recording helpers (what the instrumented layers call)
# ---------------------------------------------------------------------------


def observe_schedule_latency(seconds: float) -> None:
    _schedule_latency.observe(seconds)


def observe_dispatch(seconds: float) -> None:
    _dispatch_seconds.observe(seconds)


def inc_spillback() -> None:
    _spillbacks.inc()


class TaggedGaugeSet:
    """Gauge family whose live tag-set changes over time (pending resource
    shapes, worker states): setting a new snapshot zeroes tags that vanished,
    so stale series don't report their last value forever."""

    def __init__(self, gauge: Gauge, tag_key: str):
        self._gauge = gauge
        self._tag_key = tag_key
        self._seen: set = set()

    def set_all(self, values: Dict[str, float]) -> None:
        for name in self._seen - set(values):
            _bound(self._gauge, **{self._tag_key: name}).set(0.0)
        for name, v in values.items():
            _bound(self._gauge, **{self._tag_key: name}).set(v)
        self._seen = set(values)


def shape_str(resources: Dict[str, float]) -> str:
    """Canonical resource-shape tag: 'CPU:1,TPU:4' (sorted, compact)."""
    return ",".join(f"{k}:{v:g}" for k, v in sorted(resources.items())) or "none"


def observe_spawn(method: str, seconds: float) -> None:
    _bound(WORKER_SPAWN_LATENCY, method=method).observe(seconds)


def inc_spawn(method: str) -> None:
    _bound(WORKER_SPAWNS, method=method).inc()


def inc_spawn_timeout() -> None:
    _spawn_timeouts.inc()


def inc_zygote_fallback() -> None:
    _zygote_fallbacks.inc()


def observe_gcs_rpc(method: str, seconds: float) -> None:
    _bound(GCS_RPC_LATENCY, method=method).observe(seconds)


def inc_node_drain(reason: str) -> None:
    _bound(NODE_DRAINS, reason=reason).inc()


_drain_latency = NODE_DRAIN_LATENCY.with_tags()


def observe_drain_latency(seconds: float) -> None:
    _drain_latency.observe(seconds)


def inc_collective_abort(backend: str, group: str) -> None:
    _bound(COLLECTIVE_ABORTS, backend=backend, group=group).inc()


def set_straggler_lag(group: str, rank: int, lag_s: float) -> None:
    _bound(COLLECTIVE_STRAGGLER_LAG, group=group, rank=str(rank)).set(lag_s)


def inc_hang_sweep(source: str) -> None:
    _bound(HANG_SWEEPS, source=source).inc()


def set_goodput_seconds(run: str, bucket: str, total_seconds: float) -> None:
    """Mirror one bucket's authoritative ledger value (set, not inc — the
    ledger owns the accounting; the metric is a view of it)."""
    _bound(TRAIN_GOODPUT_SECONDS, run=run, bucket=bucket).set(total_seconds)


def set_goodput_ratio(run: str, ratio: float) -> None:
    _bound(TRAIN_GOODPUT_RATIO, run=run).set(ratio)


def goodput_metrics_snapshot() -> dict:
    """This process's goodput gauge points for bench.py's JSON line:
    per run, seconds by bucket + the derived goodput ratio (the gauges
    mirror each ledger's buckets, so these sum to wall-clock exactly)."""
    out: dict = {}
    for p in TRAIN_GOODPUT_SECONDS._snapshot():
        t = p["tags"]
        run = out.setdefault(t.get("run", "?"), {"buckets_s": {}})
        b = t.get("bucket", "?")
        run["buckets_s"][b] = run["buckets_s"].get(b, 0.0) + p["value"]
    for run, d in out.items():
        total = sum(d["buckets_s"].values())
        if total > 0:
            d["wall_clock_s"] = round(total, 6)
            d["goodput_ratio"] = round(
                d["buckets_s"].get("productive_step", 0.0) / total, 4)
    return out


_snapshot_stall = TRAIN_SNAPSHOT_STALL.with_tags()
_snapshot_inflight = TRAIN_SNAPSHOT_INFLIGHT.with_tags()


def inc_snapshot_bytes(kind: str, n: int) -> None:
    """Bytes the checkpoint subsystem wrote, by persistence kind
    (full / delta / replica)."""
    _bound(TRAIN_SNAPSHOT_BYTES, kind=kind).inc(float(n))


def add_snapshot_stall(seconds: float) -> None:
    if seconds > 0:
        _snapshot_stall.inc(seconds)


def set_snapshot_inflight(n: int) -> None:
    _snapshot_inflight.set(float(n))


def snapshot_metrics_snapshot() -> dict:
    """Process-local checkpoint-subsystem counters for bench.py's
    ``checkpoint`` block: bytes by kind + total training-thread stall."""
    out: dict = {"bytes_total": {}}
    for p in TRAIN_SNAPSHOT_BYTES._snapshot():
        k = p["tags"].get("kind", "?")
        out["bytes_total"][k] = out["bytes_total"].get(k, 0.0) + p["value"]
    for p in TRAIN_SNAPSHOT_STALL._snapshot():
        out["stall_seconds"] = out.get("stall_seconds", 0.0) + p["value"]
    for p in TRAIN_SNAPSHOT_INFLIGHT._snapshot():
        out["inflight"] = p["value"]
    return out


_sync_bytes_full = GCS_SYNC_BYTES.with_tags({"kind": "full"})
_sync_bytes_delta = GCS_SYNC_BYTES.with_tags({"kind": "delta"})
_sync_version = GCS_SYNC_VERSION.with_tags()
_report_failures = RAYLET_REPORT_FAILURES.with_tags()


def add_gcs_sync_bytes(kind: str, n: int) -> None:
    if n > 0:
        (_sync_bytes_full if kind == "full" else _sync_bytes_delta).inc(n)


def set_gcs_sync_version(v: int) -> None:
    _sync_version.set(v)


def inc_relay_publish(role: str, n: int = 1) -> None:
    if n > 0:
        _bound(PUBSUB_RELAY_PUBLISHES, role=role).inc(n)


def inc_report_failure() -> None:
    _report_failures.inc()


def sync_snapshot() -> dict:
    """Process-local cluster-view sync accounting: bytes shipped by reply
    kind, relay-publish sends by role, and the current view version.
    Hermetic (this process's counters only) — the perf-smoke delta-budget
    gate and bench.py's control_plane section both read it."""
    out = {"full_bytes": 0.0, "delta_bytes": 0.0, "relay_publishes": {},
           "version": 0.0}
    for tags_key, v in dict(GCS_SYNC_BYTES._points).items():
        kind = dict(tags_key).get("kind", "?")
        out[f"{kind}_bytes"] = out.get(f"{kind}_bytes", 0.0) + v
    for tags_key, v in dict(PUBSUB_RELAY_PUBLISHES._points).items():
        role = dict(tags_key).get("role", "?")
        out["relay_publishes"][role] = (
            out["relay_publishes"].get(role, 0.0) + v)
    for p in GCS_SYNC_VERSION._snapshot():
        out["version"] = p["value"]
    return out


def set_gcs_sink_sizes(task_events: int, reporters: int, events: int) -> None:
    _bound(GCS_SINK_SIZE, sink="task_events").set(task_events)
    _bound(GCS_SINK_SIZE, sink="metric_reporters").set(reporters)
    _bound(GCS_SINK_SIZE, sink="cluster_events").set(events)


def inc_watch_alert(rule: str, state: str) -> None:
    _bound(WATCH_ALERTS, rule=rule, state=state).inc()


def set_history_footprint(nbytes: int, nseries: int) -> None:
    _history_bytes.set(float(nbytes))
    _history_series.set(float(nseries))


def add_stored_bytes(n: int) -> None:
    _stored_bytes.inc(n)


def add_spilled_bytes(n: int) -> None:
    _spilled_bytes.inc(n)


def add_restored_bytes(n: int) -> None:
    _restored_bytes.inc(n)


def observe_submit_to_start(seconds: float) -> None:
    _submit_to_start.observe(seconds)


_lease_requests = LEASE_REQUESTS.with_tags()
_lease_reuse_hit = LEASE_REUSE.with_tags({"outcome": "hit"})
_lease_reuse_new = LEASE_REUSE.with_tags({"outcome": "new"})
_tasks_in_flight = TASKS_IN_FLIGHT.with_tags()
_lease_batch_granted = LEASE_BATCH_GRANTED.with_tags()
_leases_revoked = LEASES_REVOKED.with_tags()


def inc_lease_request() -> None:
    _lease_requests.inc()


def add_lease_reuse(outcome: str, n: int = 1) -> None:
    (_lease_reuse_hit if outcome == "hit" else _lease_reuse_new).inc(n)


def set_tasks_in_flight(n: int) -> None:
    _tasks_in_flight.set(n)


def inc_lease_batch_granted(n: int) -> None:
    if n > 0:
        _lease_batch_granted.inc(n)


def inc_lease_revoked() -> None:
    _leases_revoked.inc()


def lease_snapshot() -> dict:
    """Process-local lease fast-path accounting: requests issued, reuse
    hit/new assignment counts and the derived hit rate.  Hermetic (reads
    this process's counters only) — the perf-smoke budget test and
    bench.py's core_perf block both read it."""
    requests = sum(dict(LEASE_REQUESTS._points).values())
    hit = hits = 0.0
    for tags_key, v in dict(LEASE_REUSE._points).items():
        if ("outcome", "hit") in tags_key:
            hit += v
        hits += v
    return {
        "lease_requests": requests,
        "assignments": hits,
        "reuse_hits": hit,
        "reuse_hit_rate": (hit / hits) if hits else 0.0,
    }


def observe_task_execution(seconds: float, kind: str = "task") -> None:
    _bound(TASK_EXECUTION, kind=kind).observe(seconds)


def add_serialized_bytes(direction: str, n: int) -> None:
    if n > 0:
        _bound(TASK_SERIALIZED_BYTES, direction=direction).inc(n)


# busbw convention (NCCL-tests): factor × payload / time
_BUSBW_FACTOR = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "reducescatter": lambda n: (n - 1) / n,
    "allgather": lambda n: (n - 1) / n,
    "reduce": lambda n: 1.0,
    "broadcast": lambda n: 1.0,
    "send": lambda n: 1.0,
    "recv": lambda n: 1.0,
}


def record_collective(op: str, backend: str, world_size: int, nbytes: int,
                      seconds: float, dtype: str = "") -> None:
    """One collective op: payload bytes, latency, derived bus bandwidth."""
    tags = {"op": op, "backend": backend, "world_size": str(world_size),
            "dtype": dtype}
    _bound(COLLECTIVE_LATENCY, **tags).observe(seconds)
    if nbytes > 0:
        _bound(COLLECTIVE_BYTES, **tags).inc(nbytes)
        if seconds > 0 and world_size > 0:
            factor = _BUSBW_FACTOR.get(op, lambda n: 1.0)(max(world_size, 1))
            _bound(COLLECTIVE_BUS_BW, **tags).set(
                factor * nbytes / seconds / 1e9)


def record_collective_compression(op: str, backend: str, world_size: int,
                                  group: str, logical_bytes: int,
                                  wire_bytes: int, algorithm: str,
                                  scheme: str, quant_error: float = 0.0,
                                  inter_slice_bytes: int = 0) -> None:
    """One compression-enabled collective op: logical vs wire bytes, the
    chosen algorithm/scheme, and the quantization round-trip error.

    Recorded ONLY when a compression spec was in force — the disabled path
    books nothing here, so compression-off metric output is byte-identical
    to the pre-compression runtime."""
    tags = {"op": op, "backend": backend, "world_size": str(world_size),
            "algorithm": algorithm, "scheme": scheme, "group": group}
    if logical_bytes > 0:
        _bound(COLLECTIVE_LOGICAL_BYTES, **tags).inc(logical_bytes)
    if wire_bytes > 0:
        _bound(COLLECTIVE_WIRE_BYTES, **tags).inc(wire_bytes)
    if inter_slice_bytes > 0:
        _bound(COLLECTIVE_INTER_SLICE_BYTES, op=op, backend=backend,
               world_size=str(world_size), group=group).inc(inter_slice_bytes)
    if scheme != "none" and quant_error >= 0.0:
        # negative = unmeasured (device-side requantization): better no
        # gauge point than a gauge asserting a lossy op was exact
        _bound(COLLECTIVE_QUANT_ERROR, op=op, backend=backend,
               world_size=str(world_size), group=group).set(quant_error)
    _bound(COLLECTIVE_ALGORITHM, op=op, backend=backend,
           algorithm=algorithm, scheme=scheme).inc()


def inc_collective_plan(algorithm: str, reason: str) -> None:
    """One collective-planner decision (only spec-in-force paths book)."""
    _bound(COLLECTIVE_PLAN, algorithm=algorithm, reason=reason).inc()


def plan_snapshot() -> dict:
    """Planner-decision counts for bench.py / the multichip dryrun:
    "algorithm/reason" -> count."""
    out: Dict[str, float] = {}
    for p in COLLECTIVE_PLAN._snapshot():
        t = p["tags"]
        key = "{}/{}".format(t.get("algorithm", "?"), t.get("reason", "?"))
        out[key] = out.get(key, 0.0) + p["value"]
    return out


def add_prefix_cache_hits(tier: str, n: int = 1) -> None:
    if n > 0:
        _bound(SERVE_PREFIX_CACHE_HITS, tier=tier).inc(n)


def add_prefix_cache_misses(n: int = 1, tier: str = "all") -> None:
    if n > 0:
        _bound(SERVE_PREFIX_CACHE_MISSES, tier=tier).inc(n)


def add_prefix_cache_evictions(tier: str, n: int = 1) -> None:
    if n > 0:
        _bound(SERVE_PREFIX_CACHE_EVICTIONS, tier=tier).inc(n)


def record_kv_handoff(transport: str, nbytes: int, seconds: float) -> None:
    """One prefill->decode KV handoff leg.  Senders book latency only
    (nbytes=0) under "<transport>_export"; the receiver books the moved
    bytes under the plain transport tag — it is the one side that knows
    the true wire size for every transport — so per-transport bytes,
    handoff count and effective bandwidth each count a handoff exactly
    once even when both stages share a process."""
    if nbytes > 0:
        _bound(KV_HANDOFF_BYTES, transport=transport).inc(nbytes)
    _bound(KV_HANDOFF_LATENCY, transport=transport).observe(seconds)


def set_disagg_queue_depth(stage: str, n: int) -> None:
    _bound(SERVE_DISAGG_QUEUE_DEPTH, stage=stage).set(n)


def record_kv_migration(reason: str, outcome: str) -> None:
    """One live-migration attempt reaching a terminal outcome.  Callers
    only exist on the migration path — no migration traffic books
    nothing (the documented invariant the perf smoke pins)."""
    _bound(SERVE_KV_MIGRATIONS, reason=reason, outcome=outcome).inc(1)


def observe_kv_migration_phase(phase: str, seconds: float) -> None:
    """Wall time of one migration phase (export / transfer / import /
    splice) or the whole source-pause -> resumed-decode span (total)."""
    _bound(SERVE_KV_MIGRATION_LATENCY, phase=phase).observe(seconds)


# -- serving SLO layer ------------------------------------------------------


def observe_ttft(deployment: str, tenant: str, seconds: float) -> None:
    _bound(SERVE_TTFT, deployment=deployment, tenant=tenant).observe(seconds)


def observe_itl(deployment: str, tenant: str, seconds: float,
                n: int = 1) -> None:
    """One weighted insert per SSE frame: ``seconds`` is the per-token
    inter-token latency, ``n`` the tokens the frame carried."""
    _bound(SERVE_ITL, deployment=deployment, tenant=tenant).observe(
        seconds, n)


def observe_serve_stage(deployment: str, stage: str, seconds: float) -> None:
    _bound(SERVE_STAGE_SECONDS, deployment=deployment, stage=stage).observe(
        seconds)


def inc_route_decision(reason: str) -> None:
    _bound(SERVE_ROUTE_DECISIONS, reason=reason).inc()


def inc_slo_request(deployment: str, tenant: str, status: str) -> None:
    _bound(SERVE_SLO_REQUESTS, deployment=deployment, tenant=tenant,
           status=status).inc()


def set_slo_burn_rate(deployment: str, window: str, objective: str,
                      rate: float) -> None:
    _bound(SERVE_SLO_BURN_RATE, deployment=deployment, window=window,
           objective=objective).set(rate)


def inc_admission(tenant: str, decision: str) -> None:
    _bound(SERVE_ADMISSION, tenant=tenant, decision=decision).inc()


def set_tenant_queue_depth(tenant: str, n: int) -> None:
    _bound(SERVE_TENANT_QUEUE_DEPTH, tenant=tenant).set(n)


def admission_snapshot() -> dict:
    """Process-local admission forensics: decision counts by (tenant,
    decision).  Hermetic — this process's counters only; used by the
    benches and the disabled-path byte-identity perf-smoke gate."""
    out: dict = {}
    for tags_key, v in dict(SERVE_ADMISSION._points).items():
        tags = dict(tags_key)
        key = (tags.get("tenant", "?"), tags.get("decision", "?"))
        out[key] = out.get(key, 0.0) + v
    return out


def route_decision_snapshot() -> dict:
    """Process-local router forensics: decision counts by reason."""
    out: dict = {}
    for tags_key, v in dict(SERVE_ROUTE_DECISIONS._points).items():
        reason = dict(tags_key).get("reason", "?")
        out[reason] = out.get(reason, 0.0) + v
    return out


def serving_sketch_snapshot() -> dict:
    """Process-local serving latency sketches for bench.py and the perf
    tests: per deployment, TTFT/ITL percentiles overall and split by
    tenant, plus per-stage percentiles.  Hermetic — this process's
    sketches only (cluster-wide folds go through state.serving_slo())."""
    from ray_tpu_torch._private.latency_sketch import merge_points, summary

    out: dict = {}

    def _fold(metric, field, split_key):
        by_dep: dict = {}
        for p in metric._snapshot():
            dep = p["tags"].get("deployment", "?")
            by_dep.setdefault(dep, []).append(p)
        for dep, points in by_dep.items():
            d = out.setdefault(dep, {})
            merged = merge_points(points)
            if merged:
                d[field] = summary(merged)
            per = d.setdefault(f"{field}_by_{split_key}", {})
            for p in points:
                per[p["tags"].get(split_key, "?")] = summary(p)

    _fold(SERVE_TTFT, "ttft", "tenant")
    _fold(SERVE_ITL, "itl", "tenant")
    _fold(SERVE_STAGE_SECONDS, "stage", "stage")
    for dep, d in out.items():
        # stage merge across stages is meaningless; keep the split only
        d.pop("stage", None)
        if "stage_by_stage" in d:
            d["stages"] = d.pop("stage_by_stage")
    return out


def prefix_cache_snapshot() -> dict:
    """Process-local tiered prefix-cache accounting for bench.py and the
    perf tests: per-tier hit/miss/eviction block counts plus the derived
    overall hit rate.  Hermetic — reads this process's counters only."""
    out: dict = {"hits": {}, "misses": 0.0, "evictions": {}}
    for tags_key, v in dict(SERVE_PREFIX_CACHE_HITS._points).items():
        tier = dict(tags_key).get("tier", "?")
        out["hits"][tier] = out["hits"].get(tier, 0.0) + v
    for _tags_key, v in dict(SERVE_PREFIX_CACHE_MISSES._points).items():
        out["misses"] += v
    for tags_key, v in dict(SERVE_PREFIX_CACHE_EVICTIONS._points).items():
        tier = dict(tags_key).get("tier", "?")
        out["evictions"][tier] = out["evictions"].get(tier, 0.0) + v
    hits = sum(out["hits"].values())
    total = hits + out["misses"]
    out["hit_rate"] = (hits / total) if total else 0.0
    return out


def kv_handoff_snapshot() -> dict:
    """Process-local KV-handoff accounting: per-transport bytes, handoff
    count, mean latency and the derived effective bandwidth (bytes moved /
    time spent handing off — the busbw analog for the handoff plane)."""
    out: dict = {}
    for tags_key, v in dict(KV_HANDOFF_BYTES._points).items():
        t = dict(tags_key).get("transport", "?")
        out.setdefault(t, {})["bytes_total"] = (
            out.get(t, {}).get("bytes_total", 0.0) + v)
    for p in KV_HANDOFF_LATENCY._snapshot():
        t = p["tags"].get("transport", "?")
        d = out.setdefault(t, {})
        d["handoffs"] = d.get("handoffs", 0) + p["count"]
        d["latency_sum_s"] = d.get("latency_sum_s", 0.0) + p["sum"]
    for d in out.values():
        n = d.get("handoffs", 0)
        lat = d.pop("latency_sum_s", 0.0)
        if n:
            d["mean_latency_s"] = lat / n
        if lat > 0 and d.get("bytes_total"):
            d["effective_gbps"] = d["bytes_total"] / lat / 1e9
    return out


def kv_migration_snapshot() -> dict:
    """Process-local live-migration accounting for bench.py and the perf
    tests: outcome counts per reason plus per-phase latency count / sum /
    mean.  Hermetic — this process's counters only."""
    out: dict = {"outcomes": {}, "phases": {}}
    for tags_key, v in dict(SERVE_KV_MIGRATIONS._points).items():
        t = dict(tags_key)
        key = (t.get("reason", "?"), t.get("outcome", "?"))
        out["outcomes"][key] = out["outcomes"].get(key, 0.0) + v
    for p in SERVE_KV_MIGRATION_LATENCY._snapshot():
        ph = p["tags"].get("phase", "?")
        d = out["phases"].setdefault(ph, {"count": 0, "sum_s": 0.0})
        d["count"] += p["count"]
        d["sum_s"] += p["sum"]
    for d in out["phases"].values():
        if d["count"]:
            d["mean_s"] = d["sum_s"] / d["count"]
    return out


def add_specdec_tokens(deployment: str, proposed: int,
                       accepted: int) -> None:
    """One speculative collect's drafted/accepted token counts.  Callers
    only exist when a speculative_config is in force — the disabled path
    books nothing (the documented invariant)."""
    if proposed > 0:
        _bound(SERVE_SPECDEC_PROPOSED, deployment=deployment).inc(proposed)
    if accepted > 0:
        _bound(SERVE_SPECDEC_ACCEPTED, deployment=deployment).inc(accepted)


def observe_tp_collective(deployment: str, algorithm: str, *,
                          seconds: float, nbytes: int) -> None:
    """One TP-sharded engine dispatch's planner-routed collectives
    (llm/paged.py): modeled seconds + logical bytes by chosen algorithm.
    Callers only exist when the engine is sharded with planned
    collectives on — the single-device path books nothing."""
    if nbytes > 0:
        _bound(SERVE_TP_COLLECTIVE_BYTES, deployment=deployment,
               algorithm=algorithm).inc(nbytes)
    if seconds > 0:
        _bound(SERVE_TP_COLLECTIVE_SECONDS, deployment=deployment,
               algorithm=algorithm).inc(seconds)


def tp_collective_snapshot() -> dict:
    """Process-local TP serving-collective accounting for bench.py and
    the tier-1 pins: {deployment: {algorithm: {bytes, seconds}}}."""
    out: dict = {}
    for tags_key, v in dict(SERVE_TP_COLLECTIVE_BYTES._points).items():
        t = dict(tags_key)
        row = out.setdefault(t.get("deployment", "?"), {}).setdefault(
            t.get("algorithm", "?"), {"bytes": 0.0, "seconds": 0.0})
        row["bytes"] += v
    for tags_key, v in dict(SERVE_TP_COLLECTIVE_SECONDS._points).items():
        t = dict(tags_key)
        row = out.setdefault(t.get("deployment", "?"), {}).setdefault(
            t.get("algorithm", "?"), {"bytes": 0.0, "seconds": 0.0})
        row["seconds"] += v
    return out


def specdec_snapshot() -> dict:
    """Process-local speculative-decoding accounting for bench.py and the
    perf tests: per-deployment proposed/accepted token counts plus the
    derived acceptance rate.  Hermetic — this process's counters only."""
    out: dict = {}
    for tags_key, v in dict(SERVE_SPECDEC_PROPOSED._points).items():
        dep = dict(tags_key).get("deployment", "?")
        out.setdefault(dep, {})["proposed"] = (
            out.get(dep, {}).get("proposed", 0.0) + v)
    for tags_key, v in dict(SERVE_SPECDEC_ACCEPTED._points).items():
        dep = dict(tags_key).get("deployment", "?")
        out.setdefault(dep, {})["accepted"] = (
            out.get(dep, {}).get("accepted", 0.0) + v)
    for d in out.values():
        p = d.get("proposed", 0.0)
        d["acceptance_rate"] = (d.get("accepted", 0.0) / p) if p else 0.0
    return out


def set_tpu_chips(node: str, total: float, claimed: float) -> None:
    _bound(TPU_CHIPS, node=node, state="total").set(total)
    _bound(TPU_CHIPS, node=node, state="claimed").set(claimed)


def add_data_rows(operator: str, n: int) -> None:
    if n > 0:
        _bound(DATA_ROWS, operator=operator).inc(n)


def inc_data_backpressure(operator: str) -> None:
    _bound(DATA_BACKPRESSURE, operator=operator).inc()


def add_ingest_rows(source: str, n: int) -> None:
    if n > 0:
        _bound(DATA_INGEST_ROWS, source=source).inc(n)


def add_ingest_bytes(source: str, kind: str, n: int) -> None:
    if n > 0:
        _bound(DATA_INGEST_BYTES, source=source, kind=kind).inc(n)


def set_ingest_buffer(stage: str, n: int) -> None:
    _bound(DATA_INGEST_BUFFER, stage=stage).set(n)


def inc_ingest_backpressure(stage: str) -> None:
    _bound(DATA_INGEST_BACKPRESSURE, stage=stage).inc()


def add_ingest_wait(source: str, seconds: float) -> None:
    if seconds > 0:
        _bound(DATA_INGEST_WAIT, source=source).inc(seconds)


def add_rl_env_steps(path: str, n: int) -> None:
    if n > 0:
        _bound(RL_ENV_STEPS, path=path).inc(n)


def set_rl_queue_depth(n: int) -> None:
    _bound(RL_SAMPLE_QUEUE_DEPTH).set(n)


def observe_rl_policy_lag(lag: float) -> None:
    _bound(RL_POLICY_LAG).observe(max(0.0, float(lag)))


def rl_snapshot() -> dict:
    """Process-local RL execution-path accounting for bench.py and the
    perf gates: env steps per path, the Sebulba sample queue's last
    depth, and the policy-lag distribution (count / sum / mean).
    Hermetic — this process's counters only."""
    out: dict = {"env_steps": {}, "queue_depth": 0.0,
                 "policy_lag": {"count": 0.0, "sum": 0.0, "mean": 0.0}}
    for tags_key, v in dict(RL_ENV_STEPS._points).items():
        out["env_steps"][dict(tags_key).get("path", "?")] = v
    for _tags_key, v in dict(RL_SAMPLE_QUEUE_DEPTH._points).items():
        out["queue_depth"] = v
    for _tags_key, st in dict(RL_POLICY_LAG._hist).items():
        # histogram state is [bucket counts, sum, count]
        s, cnt = float(st[1]), float(st[2])
        out["policy_lag"] = {"count": cnt, "sum": s,
                             "mean": (s / cnt) if cnt else 0.0}
    return out


def set_device_hbm(device: str, used: int, limit: int) -> None:
    _bound(DEVICE_HBM_BYTES, device=device, kind="used").set(used)
    if limit > 0:
        _bound(DEVICE_HBM_BYTES, device=device, kind="limit").set(limit)


def record_engine_hbm(deployment: str, weights: int, kv_pool: int,
                      transient: int) -> None:
    _bound(ENGINE_HBM_BYTES, deployment=deployment,
           segment="weights").set(weights)
    _bound(ENGINE_HBM_BYTES, deployment=deployment,
           segment="kv_pool").set(kv_pool)
    _bound(ENGINE_HBM_BYTES, deployment=deployment,
           segment="transient").set(max(0, transient))


def record_engine_utilization(deployment: str, slot_occupancy: float,
                              kv_occupancy: float, prefill_spend: float,
                              duty_cycle: float) -> None:
    _bound(ENGINE_SLOT_OCCUPANCY, deployment=deployment).set(slot_occupancy)
    _bound(ENGINE_KV_OCCUPANCY, deployment=deployment).set(kv_occupancy)
    _bound(ENGINE_PREFILL_SPEND, deployment=deployment).set(prefill_spend)
    _bound(ENGINE_STEP_DUTY, deployment=deployment).set(duty_cycle)


def inc_jit_compile(program: str, seconds: float) -> None:
    _bound(JIT_COMPILES, program=program).inc()
    if seconds > 0:
        _bound(JIT_COMPILE_SECONDS, program=program).inc(seconds)


def set_train_mfu(run: str, ratio: float) -> None:
    _bound(TRAIN_MFU, run=run).set(ratio)


def set_serve_tokens_per_chip(deployment: str, tok_per_s: float) -> None:
    _bound(SERVE_TOKENS_PER_CHIP, deployment=deployment).set(tok_per_s)


def device_telemetry_snapshot() -> dict:
    """Process-local device-telemetry accounting for bench.py and the perf
    gates: per-device HBM gauges, per-deployment engine HBM split and
    utilization gauges, jit-compile counts/seconds per program, and the
    MFU / tok-per-chip gauges.  Hermetic — this process's points only."""
    out: dict = {"device_hbm": {}, "engine_hbm": {}, "utilization": {},
                 "jit_compiles": {}, "jit_compile_seconds": {},
                 "train_mfu": {}, "serve_tokens_per_chip": {}}
    for tags_key, v in dict(DEVICE_HBM_BYTES._points).items():
        t = dict(tags_key)
        out["device_hbm"].setdefault(
            t.get("device", "?"), {})[t.get("kind", "?")] = v
    for tags_key, v in dict(ENGINE_HBM_BYTES._points).items():
        t = dict(tags_key)
        out["engine_hbm"].setdefault(
            t.get("deployment", "?"), {})[t.get("segment", "?")] = v
    for gauge, key in ((ENGINE_SLOT_OCCUPANCY, "slot_occupancy"),
                       (ENGINE_KV_OCCUPANCY, "kv_occupancy"),
                       (ENGINE_PREFILL_SPEND, "prefill_spend"),
                       (ENGINE_STEP_DUTY, "duty_cycle")):
        for tags_key, v in dict(gauge._points).items():
            dep = dict(tags_key).get("deployment", "?")
            out["utilization"].setdefault(dep, {})[key] = v
    for tags_key, v in dict(JIT_COMPILES._points).items():
        out["jit_compiles"][dict(tags_key).get("program", "?")] = v
    for tags_key, v in dict(JIT_COMPILE_SECONDS._points).items():
        out["jit_compile_seconds"][dict(tags_key).get("program", "?")] = v
    for tags_key, v in dict(TRAIN_MFU._points).items():
        out["train_mfu"][dict(tags_key).get("run", "?")] = v
    for tags_key, v in dict(SERVE_TOKENS_PER_CHIP._points).items():
        out["serve_tokens_per_chip"][dict(tags_key).get("deployment", "?")] = v
    return out


def ingest_snapshot() -> dict:
    """Process-local data-plane accounting for bench.py and the perf
    gates: ingest rows, view vs copied bytes per source, buffer-empty
    wait seconds, and backpressure event counts.  Hermetic — this
    process's counters only."""
    out: dict = {"rows": {}, "bytes": {}, "wait_s": {}, "backpressure": {}}
    for tags_key, v in dict(DATA_INGEST_ROWS._points).items():
        out["rows"][dict(tags_key).get("source", "?")] = v
    for tags_key, v in dict(DATA_INGEST_BYTES._points).items():
        t = dict(tags_key)
        d = out["bytes"].setdefault(t.get("source", "?"), {})
        d[t.get("kind", "?")] = d.get(t.get("kind", "?"), 0.0) + v
    for tags_key, v in dict(DATA_INGEST_WAIT._points).items():
        out["wait_s"][dict(tags_key).get("source", "?")] = v
    for tags_key, v in dict(DATA_INGEST_BACKPRESSURE._points).items():
        out["backpressure"][dict(tags_key).get("stage", "?")] = v
    return out


# ---------------------------------------------------------------------------
# Snapshots for bench integration
# ---------------------------------------------------------------------------


def collective_snapshot() -> dict:
    """Summarize this process's collective metric points for bench.py's JSON
    line.  Keys carry the FULL tag-set (op/backend/world_size/dtype) so two
    series (e.g. float32 grads and bfloat16 params) never blend into one
    internally-inconsistent entry: per key, total bytes, op count, mean
    latency, and the last derived bus bandwidth."""
    def _key(tags: Dict[str, str]) -> str:
        return "{}/{}/ws{}/{}".format(
            tags.get("op", "?"), tags.get("backend", "?"),
            tags.get("world_size", "?"), tags.get("dtype") or "na")

    out: Dict[str, dict] = {}
    for p in COLLECTIVE_BYTES._snapshot():
        d = out.setdefault(_key(p["tags"]), {})
        d["bytes_total"] = d.get("bytes_total", 0.0) + p["value"]
    for p in COLLECTIVE_BUS_BW._snapshot():
        out.setdefault(_key(p["tags"]), {})["busbw_gbps"] = p["value"]
    for p in COLLECTIVE_LATENCY._snapshot():
        d = out.setdefault(_key(p["tags"]), {})
        d["ops"] = d.get("ops", 0) + p["count"]
        d["latency_sum_s"] = d.get("latency_sum_s", 0.0) + p["sum"]
    for d in out.values():
        if d.get("ops"):
            d["mean_latency_s"] = d.pop("latency_sum_s", 0.0) / d["ops"]
        else:
            d.pop("latency_sum_s", None)
    return out


def compression_snapshot() -> dict:
    """Summarize this process's compressed-collective metric points for
    bench.py's JSON line and the multichip dryrun: per
    op/backend/ws/algorithm/scheme/group key, logical vs wire byte totals,
    the savings ratio, and the last quant error."""
    def _key(tags: Dict[str, str]) -> str:
        return "{}/{}/ws{}/{}/{}/{}".format(
            tags.get("op", "?"), tags.get("backend", "?"),
            tags.get("world_size", "?"), tags.get("algorithm", "?"),
            tags.get("scheme", "?"), tags.get("group", "?"))

    out: Dict[str, dict] = {}
    for p in COLLECTIVE_LOGICAL_BYTES._snapshot():
        d = out.setdefault(_key(p["tags"]), {})
        d["logical_bytes"] = d.get("logical_bytes", 0.0) + p["value"]
    for p in COLLECTIVE_WIRE_BYTES._snapshot():
        d = out.setdefault(_key(p["tags"]), {})
        d["wire_bytes"] = d.get("wire_bytes", 0.0) + p["value"]
    for p in COLLECTIVE_QUANT_ERROR._snapshot():
        # the gauge is tagged op/backend/ws/group only; attribute it to the
        # QUANTIZED rows of that slice, never the scheme="none" ones (a
        # lossless row must not inherit a neighbor's error figure)
        t = p["tags"]
        prefix = "{}/{}/ws{}/".format(
            t.get("op", "?"), t.get("backend", "?"), t.get("world_size", "?"))
        suffix = "/" + t.get("group", "?")
        for k, d in out.items():
            if k.startswith(prefix) and k.endswith(suffix):
                parts = k.split("/")
                if len(parts) >= 5 and parts[4] != "none":
                    d["quant_error"] = p["value"]
    for d in out.values():
        wire = d.get("wire_bytes", 0.0)
        logical = d.get("logical_bytes", 0.0)
        if wire > 0 and logical > 0:
            d["wire_reduction_x"] = round(logical / wire, 3)
    return out


def maybe_push(min_interval_s: Optional[float] = None) -> bool:
    """Piggyback flush (see util/metrics.maybe_push)."""
    from ray_tpu_torch._private.config import global_config
    from ray_tpu_torch.util import metrics

    if min_interval_s is None:
        min_interval_s = global_config().metrics_report_interval_s
    return metrics.maybe_push(min_interval_s)


__all__ = [n for n in dir() if not n.startswith("_")]
