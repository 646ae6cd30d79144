"""DataContext: per-process execution knobs.

reference: python/ray/data/context.py (DataContext).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass
class DataContext:
    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    max_tasks_in_flight: int = 16
    cpus_per_task: float = 1.0
    default_batch_format: str = "numpy"
    # -- streaming executor (reference: execution/resource_manager.py +
    # backpressure_policy/; ExecutionOptions.preserve_order)
    op_memory_budget: int = 256 * 1024 * 1024  # bytes parked downstream of one op
    output_queue_blocks: int = 16  # consumer-side bounded queue (blocks)
    preserve_order: bool = True  # release outputs in data order (never gates submission)
    tasks_per_actor: int = 2  # per-actor pipelining in actor pools
    actor_idle_timeout_s: float = 30.0  # autoscaling pool scale-down
    # -- train-ingest data plane (data/_internal/ingest.py) ------------------
    # consumer-side ref lookahead: locally-sealed plasma blocks in the window
    # resolve in ONE raylet round-trip (the PlasmaGetBatch path) instead of
    # one RPC per block
    ingest_resolve_window: int = 4
    # per-consumer block cap in the streaming-split coordinator: a slow
    # consumer's round-robin assignment parks the producer pull (PARKED
    # backpressure) instead of buffering the whole stream in the store
    split_buffer_blocks: int = 16
    # device-side double buffer depth for iter_device_batches: batch N+1's
    # host-to-device copy (a pinned staging ring, a side stream) overlaps
    # the caller's step on batch N (2 = classic double buffering; 0
    # disables the prefetch thread entirely)
    device_prefetch_depth: int = 2

    _current: "Optional[DataContext]" = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = DataContext()
            return cls._current
