"""Train-ingest data plane: datasource -> plasma -> host views -> device.

The high-throughput path that feeds a training step at device speed
(ROADMAP item 4; the input-stall goodput tax of arxiv 2510.20171):

  - **windowed block resolution** (`resolved_blocks`): a small ref
    lookahead resolves every locally-sealed plasma block in ONE raylet
    round-trip (the PlasmaGetBatch path);
    resolved blocks are numpy columns whose buffers ALIAS the store's
    shared memory (protocol-5 out-of-band reconstruction), so host
    batches are read-only numpy views — no pickle of the payload, no
    memcpy; the staging copy reads them in place.
  - **host prefetch with honest wait stamping** (`HostPrefetcher`): a
    named producer thread keeps a bounded buffer of decoded host batches;
    the consumer's buffer-EMPTY seconds are measured with an injectable
    clock and surfaced (``ray_tpu_data_ingest_wait_seconds_total`` +
    the per-session ``input_wait_s`` the goodput ledger reclassifies).
  - **double-buffered device prefetch** (`DevicePrefetcher`): the
    prefetch thread copies batch N+1 into a ring of pinned staging
    buffers (``depth + 1`` per column, reused: a ``pin_memory()`` per
    batch would pay a ``cudaHostAlloc`` each time) and issues its
    non-blocking host-to-device copy on a side stream, then records an
    event; at the hand-over the caller's stream waits on that event and
    ``record_stream`` tells the caching allocator that the caller's stream
    reads the batch, so its memory is not handed to a later copy while
    the step still runs.  Nothing calls ``torch.cuda.synchronize`` and the
    host never waits on the step: stream order is the barrier (the JAX
    package stages through a donated ``optimization_barrier`` instead).
  - **DataShard**: the per-worker wrapper ``session.get_dataset_shard``
    returns — iterators feed the double buffer, stamp ``input_wait_s``
    from real buffer-empty waits into the session, and release their
    remaining blocks back to the streaming-split coordinator when the
    host's preemption drain fires (elastic re-shard: survivors take over
    the drained consumer's assignment, no row lost or duplicated).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from ray_tpu_torch._private import runtime_metrics

MASK_COLUMN = "mask"

_PARTIAL_BATCH_MODES = ("error", "pad", "drop")


# ---------------------------------------------------------------------------
# Windowed zero-copy block resolution
# ---------------------------------------------------------------------------

def resolved_blocks(ref_iter: Iterable[Any], window: int = 4) -> Iterator[Any]:
    """Yield blocks for ``ref_iter`` in order, resolving locally-sealed
    plasma objects across a ``window``-ref lookahead in one raylet
    round-trip.  The head ref, when not yet local, falls back to the
    ordinary (blocking) get — later sealed refs in the window still ride
    the batch, so a straggler producer never serializes the whole
    window behind per-object RPCs."""
    from collections import deque

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import get_global_worker

    if window is None or window <= 1:
        for ref in ref_iter:
            yield ray_tpu_torch.get(ref)
        return
    it = iter(ref_iter)
    pend: deque = deque()
    ready: Dict[Any, Any] = {}
    done = False
    while True:
        while not done and len(pend) < window:
            try:
                pend.append(next(it))
            except StopIteration:
                done = True
        if not pend:
            return
        head = pend[0]
        if head.id not in ready:
            w = get_global_worker()
            resolved = None
            if w is not None:
                try:
                    resolved = w.resolve_plasma_batch(
                        [r for r in pend if r.id not in ready])
                except Exception:  # noqa: BLE001 — view fast path only; the per-object get below is authoritative
                    resolved = None
            if resolved:
                ready.update(resolved)
        if head.id in ready:
            value = ready.pop(head.id)
        else:
            value = ray_tpu_torch.get(head)
        pend.popleft()
        yield value


# ---------------------------------------------------------------------------
# Host-side prefetch with buffer-empty wait stamping
# ---------------------------------------------------------------------------

class HostPrefetcher:
    """Bounded background producer + wait-stamped consumer.

    The producer thread pumps ``gen`` into a ``depth``-bounded queue; the
    consumer measures every second it spends blocked on an EMPTY buffer
    (the honest definition of input wait — time the training loop wanted
    data and none was staged).  ``on_wait`` receives each wait interval;
    ``wait_seconds()`` is the running total.  Errors re-raise at the
    consumer; closing/abandoning the iterator stops the producer."""

    _END = object()

    def __init__(self, gen: Iterable[Any], depth: int = 2, *,
                 source: str = "ingest",
                 clock: Callable[[], float] = time.perf_counter,
                 on_wait: Optional[Callable[[float], None]] = None,
                 stage: str = "host"):
        self._gen = gen
        self._depth = max(1, depth)
        self._source = source
        self._clock = clock
        self._on_wait = on_wait
        self._stage = stage
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._wait_s = 0.0
        self._waits = 0
        self._thread = threading.Thread(
            target=self._pump, daemon=True,
            name=f"ray_tpu_torch-data-ingest-{stage}")
        self._thread.start()

    def wait_seconds(self) -> float:
        return self._wait_s

    def wait_events(self) -> int:
        return self._waits

    def close(self) -> None:
        self._stop.set()

    def _put(self, item) -> bool:
        parked = False
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                if not parked:
                    parked = True
                    runtime_metrics.inc_ingest_backpressure(self._stage)
                continue
        return False  # consumer abandoned the iterator

    def _pump(self) -> None:
        try:
            for item in self._gen:
                if not self._put(item):
                    close = getattr(self._gen, "close", None)
                    if close is not None:
                        close()
                    return
            self._put(self._END)
        except BaseException as e:  # noqa: BLE001 — surface at the consumer
            self._put(e)

    def __iter__(self):
        try:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    t0 = self._clock()
                    item = self._q.get()
                    dt = self._clock() - t0
                    if dt > 0:
                        self._wait_s += dt
                        self._waits += 1
                        runtime_metrics.add_ingest_wait(self._source, dt)
                        if self._on_wait is not None:
                            self._on_wait(dt)
                runtime_metrics.set_ingest_buffer(self._stage, self._q.qsize())
                if item is self._END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop.set()


# ---------------------------------------------------------------------------
# Partial-batch policy (the ragged-final-batch fix)
# ---------------------------------------------------------------------------

def apply_partial_batch(batch: Dict[str, Any], batch_size: Optional[int],
                        partial_batch: str) -> Optional[Dict[str, Any]]:
    """Resolve a final batch shorter than ``batch_size``:

    - ``"error"``: return it unchanged (a sharding mismatch downstream
      raises, today's behavior);
    - ``"drop"``: return None (caller skips it);
    - ``"pad"``: zero-pad every column to ``batch_size`` rows and add a
      float32 ``mask`` column (1.0 = real row, 0.0 = padding) so loss
      masking stays exact.
    """
    import numpy as np

    if partial_batch not in _PARTIAL_BATCH_MODES:
        raise ValueError(
            f"partial_batch must be one of {_PARTIAL_BATCH_MODES}, "
            f"got {partial_batch!r}")
    if batch_size is None or not batch:
        return batch
    rows = len(next(iter(batch.values())))
    if rows >= batch_size or partial_batch == "error":
        return batch
    if partial_batch == "drop":
        return None
    if MASK_COLUMN in batch:
        raise ValueError(
            f"partial_batch='pad' adds a {MASK_COLUMN!r} column but the "
            "batch already has one — rename it or use drop_last")
    out: Dict[str, Any] = {}
    pad_rows = batch_size - rows
    for name, col in batch.items():
        arr = np.asarray(col)
        pad = np.zeros((pad_rows,) + arr.shape[1:], dtype=arr.dtype)
        out[name] = np.concatenate([arr, pad], axis=0)
        runtime_metrics.add_ingest_bytes("partial_pad", "copy", arr.nbytes)
    mask = np.zeros(batch_size, dtype=np.float32)
    mask[:rows] = 1.0
    out[MASK_COLUMN] = mask
    return out


# ---------------------------------------------------------------------------
# Double-buffered device prefetch
# ---------------------------------------------------------------------------

def resolve_device(device: Any = None):
    """The torch device batches land on: ``None`` is the current CUDA
    device, ``"cpu"`` gives host tensors.  Raises without a GPU rather than
    hand back host tensors, and refuses a port Mesh where the JAX package
    takes a sharding."""
    import torch

    if device is not None and not isinstance(device, (str, int, torch.device)):
        if type(device).__name__ in ("Mesh", "MeshSpec"):
            raise NotImplementedError(
                "device batches sharded over a Mesh (iter_jax_batches' "
                "sharding) are not ported (ROADMAP A16, data/: sharded "
                "device batches); under the trainer each rank already gets "
                "its own shard: pass that rank's device")
        raise TypeError(f"device must be a torch.device or a name, got "
                        f"{type(device).__name__}")
    if device is None:
        dev = torch.device("cuda")
    elif isinstance(device, int):
        dev = torch.device("cuda", device)
    else:
        dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device batches go to 'cuda' or 'cpu', not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("device batches need a CUDA device; none is "
                           "available (pass device='cpu' for host tensors)")
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def _torch_dtype(dtype):
    import numpy as np
    import torch

    if dtype == object:
        raise TypeError("a column of Python objects (strings, ragged lists) "
                        "cannot go to the device")
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class _Staged:
    """A batch whose copies are queued on the stager's side stream, and
    the event recorded after them."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event


class DeviceStager:
    """Host batch -> device tensors (the per-batch transfer leg, shared by
    the overlapped and the synchronous paths).

    On CUDA, ``to_device`` (the prefetch thread) copies each column into
    its pinned staging slot, issues the non-blocking copy into a fresh
    device tensor on the side stream (``stream``, default a new one), casts
    there where ``dtypes`` asks, and records an event.  The ring holds
    ``depth + 1`` slots a column, allocated at the first batch (a batch
    with more rows than the slots reallocates them); a slot is overwritten
    only after the event of its previous copy, which waits for a copy and
    never for the step.  ``hand_over`` (the consumer's thread) makes the
    consumer's current stream wait on the event and records the tensors
    on it.  On the CPU, batches are owned host tensors."""

    def __init__(self, device: Any = None, *,
                 dtypes: Optional[Dict[str, Any]] = None, depth: int = 2,
                 stream: Any = None):
        self._device = resolve_device(device)
        self._dtypes = dtypes or {}
        self._slots = max(0, depth) + 1
        self._cuda = self._device.type == "cuda"
        self._stream = stream
        self._ring: Dict[str, list] = {}
        self._done: list = [None] * self._slots
        self._next = 0

    @property
    def device(self):
        return self._device

    def _slot(self, name: str, slot: int, arr):
        import torch

        ring = self._ring.get(name)
        want = _torch_dtype(arr.dtype)
        if (ring is None or ring[0].dtype != want
                or ring[0].shape[1:] != arr.shape[1:]
                or ring[0].shape[0] < arr.shape[0]):
            rows = arr.shape[0]
            if ring is not None and ring[0].shape[1:] == arr.shape[1:]:
                rows = max(rows, ring[0].shape[0])
            ring = [torch.empty((rows,) + tuple(arr.shape[1:]), dtype=want,
                                pin_memory=True)
                    for _ in range(self._slots)]
            self._ring[name] = ring
        return ring[slot][:arr.shape[0]]

    def to_device(self, host: Dict[str, Any]):
        import numpy as np
        import torch

        if not self._cuda:
            out = {}
            for name, col in host.items():
                t = torch.from_numpy(np.array(col))  # owned and writable
                want = self._dtypes.get(name)
                out[name] = t if want is None else t.to(want)
            return out
        slot, self._next = self._next, (self._next + 1) % self._slots
        prev = self._done[slot]
        if prev is not None:
            prev.synchronize()  # the slot's last copy has read it
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._device)
        out = {}
        with torch.cuda.stream(self._stream):
            for name, col in host.items():
                arr = np.asarray(col)
                buf = self._slot(name, slot, arr)
                np.copyto(buf.numpy(), arr)
                dev = torch.empty(buf.shape, dtype=buf.dtype,
                                  device=self._device)
                dev.copy_(buf, non_blocking=True)
                want = self._dtypes.get(name)
                out[name] = dev if want is None else dev.to(want)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._done[slot] = event
        return _Staged(out, event)

    def hand_over(self, staged) -> Dict[str, Any]:
        """The batch for the calling thread's current stream: that stream
        waits on the copies, and the allocator keeps the tensors' memory
        until what that stream queues on them has run."""
        if not isinstance(staged, _Staged):
            return staged  # host tensors
        import torch

        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(staged.event)
        for t in staged.tensors.values():
            t.record_stream(stream)
        return staged.tensors


def staged_batches(host_iter: Iterable[Dict[str, Any]], stager: DeviceStager,
                   batch_size: Optional[int], partial_batch: str,
                   hand_over: bool = False):
    """Host batches -> partial-batch policy -> staged device batches (the
    one consume loop shared by the overlapped and synchronous paths).
    ``hand_over``: hand each batch to the calling thread's stream here
    (the synchronous path); the prefetcher hands over in the consumer's
    thread instead."""
    for host in host_iter:
        batch = apply_partial_batch(host, batch_size, partial_batch)
        if batch is None:  # partial_batch="drop"
            continue
        staged = stager.to_device(batch)
        yield stager.hand_over(staged) if hand_over else staged


class DevicePrefetcher:
    """Double-buffered device-side prefetch over a host-batch iterator.

    The producer thread stages batch N+1 (pinned copy, side-stream
    transfer, dtype casts) while the caller steps on batch N; the
    consumer's thread hands each batch to its current stream.  ``depth``
    bounds the staged batches (2 = double buffering).  ``stager``: a
    ``DeviceStager`` to use in place of the default one.  NOTE: the
    prefetch thread starts at construction — wrap in a generator to stay
    lazy (the iter_device_batches entry points do)."""

    def __init__(self, host_iter: Iterable[Dict[str, Any]], device: Any = None,
                 *,
                 dtypes: Optional[Dict[str, Any]] = None,
                 depth: int = 2,
                 batch_size: Optional[int] = None,
                 partial_batch: str = "error",
                 source: str = "ingest",
                 clock: Callable[[], float] = time.perf_counter,
                 on_wait: Optional[Callable[[float], None]] = None,
                 stager: Optional[DeviceStager] = None):
        depth = max(1, depth)
        self._stager = stager or DeviceStager(device, dtypes=dtypes,
                                              depth=depth)
        self._prefetch = HostPrefetcher(
            staged_batches(host_iter, self._stager, batch_size,
                           partial_batch),
            depth=depth,
            source=source, clock=clock, on_wait=on_wait, stage="device")

    def wait_seconds(self) -> float:
        return self._prefetch.wait_seconds()

    def __iter__(self):
        for staged in self._prefetch:
            yield self._stager.hand_over(staged)

    def close(self) -> None:
        self._prefetch.close()


# ---------------------------------------------------------------------------
# The per-worker train shard
# ---------------------------------------------------------------------------

def _default_drain_probe() -> Callable[[], bool]:
    """True once this host announced a preemption/maintenance drain
    (the runtime context caches the raylet poll ~1s)."""
    def probe() -> bool:
        try:
            import ray_tpu_torch

            return ray_tpu_torch.get_runtime_context().preemption_deadline() \
                is not None
        except Exception:  # noqa: BLE001 — clusterless unit contexts have no drain source
            return False
    return probe


class DataShard:
    """What ``session.get_dataset_shard`` hands the training loop.

    Wraps a streaming-split consumer (or any shard exposing
    ``iter_batches``): iterators resolve blocks through the zero-copy
    window, prefetch on named threads, stamp real buffer-empty waits into
    the owning session's ``input_wait_s`` (the goodput ledger carves that
    into the ``input_wait`` bucket), and — when the host's preemption
    drain fires mid-epoch — hand the shard's remaining blocks back to
    the coordinator so surviving consumers finish the epoch with every
    row delivered exactly once."""

    def __init__(self, shard: Any, *, name: str = "train",
                 session: Any = None,
                 drain_probe: Optional[Callable[[], bool]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self._shard = shard
        self._name = name
        self._session = session
        self._drain_probe = (drain_probe if drain_probe is not None
                             else _default_drain_probe())
        self._clock = clock
        self._wait_s = 0.0
        self.drained = False

    # everything we don't wrap (count, schema, iter_rows, ...) passes through
    def __getattr__(self, item):
        return getattr(self._shard, item)

    def wait_seconds(self) -> float:
        return self._wait_s

    def _note_wait(self, dt: float) -> None:
        self._wait_s += dt
        if self._session is not None:
            try:
                self._session.note_input_wait(dt)
            except Exception:  # noqa: BLE001 — wait stamping is telemetry; ingestion continues
                pass

    def _block_iter(self):
        """Ref->block stream with the drain hook: when the probe fires,
        the CURRENT (unresolved) ref and everything the coordinator still
        holds for this consumer are reassigned to survivors; in-flight
        resolved blocks drain to the caller, so rows are delivered exactly
        once across the gang."""
        from ray_tpu_torch.data.context import DataContext

        ctx = getattr(self._shard, "_ctx", None) or DataContext.get_current()
        window = ctx.ingest_resolve_window
        release = getattr(self._shard, "release", None)
        probe = self._drain_probe

        def refs():
            it = self._shard.iter_blocks()
            try:
                for ref in it:
                    if probe is not None and probe():
                        self.drained = True
                        if release is not None:
                            release([ref])
                        return
                    yield ref
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()

        yield from resolved_blocks(refs(), window=window)

    def _host_iter(self, batch_size, batch_format, drop_last):
        """Raw host-batch generator — NO wait stamping (production time
        here may be overlapped by a downstream prefetch thread; only
        consumer-side buffer-empty time is input wait)."""
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.dataset import _batches_over_blocks

        ctx = getattr(self._shard, "_ctx", None) or DataContext.get_current()
        batch_format = batch_format or ctx.default_batch_format
        if hasattr(self._shard, "iter_blocks"):
            return _batches_over_blocks(
                self._block_iter(), batch_size, batch_format, drop_last,
                source=self._name)
        # plain Dataset shard: its own iterator already resolves refs
        return self._shard.iter_batches(
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            **({"prefetch_batches": 0}
               if "prefetch_batches" in _kwargs_of(
                   self._shard.iter_batches) else {}))

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = None,
                     drop_last: bool = False,
                     prefetch_batches: int = 2) -> Iterator[Any]:
        if prefetch_batches and prefetch_batches > 0:
            def lazy():  # nothing (plan execution included) runs pre-next()
                gen = self._host_iter(batch_size, batch_format, drop_last)
                yield from HostPrefetcher(
                    gen, depth=prefetch_batches, source=self._name,
                    clock=self._clock, on_wait=self._note_wait,
                    stage="host")
            return lazy()
        # synchronous: there is no overlap, so time spent producing the
        # next batch IS starvation — stamp it
        gen = self._host_iter(batch_size, batch_format, drop_last)
        return _waited_iter(gen, self._clock, self._note_wait, self._name)

    def iter_device_batches(self, *, batch_size: Optional[int] = 256,
                            drop_last: bool = False,
                            dtypes: Optional[Dict[str, Any]] = None,
                            device: Any = None,
                            partial_batch: str = "error",
                            prefetch_batches: Optional[int] = None
                            ) -> Iterator[Dict[str, Any]]:
        """Tensors on the card through the double buffer (the counterpart
        of the JAX package's ``iter_jax_batches``): the next batch's
        transfer overlaps the caller's step; buffer-empty waits land in
        the session's ``input_wait_s``."""
        from ray_tpu_torch.data.context import DataContext

        target = resolve_device(device)
        ctx = getattr(self._shard, "_ctx", None) or DataContext.get_current()
        depth = (getattr(ctx, "device_prefetch_depth", 2)
                 if prefetch_batches is None else prefetch_batches)
        if depth and depth > 0:
            def lazy():
                # the raw host gen feeds the device thread; only the
                # CONSUMER's device-buffer-empty time is input wait
                host = self._host_iter(batch_size, "numpy", drop_last)
                yield from DevicePrefetcher(
                    host, target, dtypes=dtypes, depth=depth,
                    batch_size=batch_size, partial_batch=partial_batch,
                    source=self._name, clock=self._clock,
                    on_wait=self._note_wait)
            return lazy()

        # synchronous fallback (prefetch 0): no overlap — production time
        # is starvation, stamped by the iter_batches(prefetch 0) path
        def sync_gen():
            host = self.iter_batches(
                batch_size=batch_size, batch_format="numpy",
                drop_last=drop_last, prefetch_batches=0)
            stager = DeviceStager(target, dtypes=dtypes, depth=0)
            yield from staged_batches(host, stager, batch_size,
                                      partial_batch, hand_over=True)
        return sync_gen()


def _kwargs_of(fn) -> set:
    import inspect

    try:
        return set(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return set()


def _waited_iter(gen, clock, on_wait, source):
    """Unprefetched iterator that still stamps time blocked in the
    upstream generator as input wait (prefetch_batches=0 path)."""
    it = iter(gen)
    while True:
        t0 = clock()
        try:
            item = next(it)
        except StopIteration:
            return
        dt = clock() - t0
        if dt > 0:
            runtime_metrics.add_ingest_wait(source, dt)
            on_wait(dt)
        yield item
