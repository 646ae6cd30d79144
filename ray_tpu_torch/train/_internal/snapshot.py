"""Async snapshots of the training state: staged on the step, persisted off
it (port of ``ray_tpu/train/_internal/snapshot.py``).

The format is the JAX package's, so either package restores the other's
snapshots:
  * **Leaf keys** are the JAX ``TrainState`` paths (``step``,
    ``params/layers/wq``, ``opt_state/0/mu/embed``, under gradient
    compression ``opt_state/1/0/mu/embed``): the port's state nests as
    optax's chain, and ``_private.tree`` flattens it in ``jax.tree`` order.
  * **Files**: one ``.npy`` per shard under ``leaves/``, a per-rank
    manifest, then ``manifest.json`` written last by atomic rename + dir
    fsync (the crash-safe commit).  A bf16 leaf is written as its raw
    bits under the ``.npy`` descr ``'bfloat16'``, which ``np.load`` reads
    as ``ml_dtypes.bfloat16`` wherever ``ml_dtypes`` is imported (every
    JAX process): the JAX package's ``_assemble_leaf`` then fills its
    bf16 array from it.  (``np.save`` would write the descr ``'<V2'``,
    which no reader casts back.)
  * **Delta snapshots**: per-leaf keyed-blake2b content hashes
    (``_private/prefix_hash.content_hash``) over the leaf's bytes; an
    unchanged leaf's entry names the earlier snapshot dir that holds it.

Staging on the card: JAX donates the state to the next step, the port
updates it in place.  So ``save()`` enqueues each leaf's device -> host
copy into a fresh pinned buffer on the current stream and records a CUDA
event: the next step's in-place updates run after the copies on the same
stream.  The writer thread waits on the event before it hashes or writes.
``save()`` blocks only for backpressure (at most one snapshot in flight)
and the enqueue, both metered as stall.  A failed snapshot raises from the
next ``save()`` (``last_error``); nothing is skipped quietly.

Not ported: the metric families and flight recorder (ROADMAP A12) and
fsspec storage.  The training session (``_internal/session.py``) owns one
manager per worker, started by ``train.report(state=...)``; with
``CheckpointConfig(peer_replicas=True)`` it pushes each snapshot to the
trainer's ``ReplicaHolder`` actors.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.host_arrays import to_numpy
from ray_tpu_torch._private.prefix_hash import content_hash
from ray_tpu_torch._private.tree import tree_leaves_with_keys, tree_map_with_keys
from ray_tpu_torch.train._internal.checkpoint_util import (
    existing_checkpoint_indices,
)

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
_RANK_MANIFEST_RE = re.compile(r"^manifest\.rank(\d+)\.json$")
_FORMAT = "ray_tpu-snapshot-v1"
_LEAF_DIR = "leaves"


# ---------------------------------------------------------------------------
# Staging (the only step-blocking work)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostLeaf:
    """One leaf's host copy: global metadata + local shards (one shard, the
    whole leaf, on one process)."""

    shape: Tuple[int, ...]
    dtype: str
    shards: List[Tuple[Tuple[Tuple[int, int], ...], Any]]  # (index, ndarray)

    def nbytes(self) -> int:
        return sum(int(d.nbytes) for _, d in self.shards)


@dataclasses.dataclass
class HostSnapshot:
    """Everything this process must persist for one snapshot.  ``ready``
    is the CUDA event after the staging copies (None when every leaf was
    copied on the host): its shards hold their bytes once it completes."""

    leaves: Dict[str, HostLeaf]
    step: int = 0
    world_size: int = 1
    ready: Optional[Any] = None

    def wait_ready(self) -> None:
        if self.ready is not None:
            self.ready.synchronize()

    def nbytes(self) -> int:
        return sum(leaf.nbytes() for leaf in self.leaves.values())

    def to_payload(self) -> dict:
        """Picklable form for a peer-replica push (call after
        ``wait_ready``)."""
        return {
            "step": self.step,
            "world_size": self.world_size,
            "leaves": {
                k: {"shape": list(leaf.shape), "dtype": leaf.dtype,
                    "shards": [(idx, data) for idx, data in leaf.shards]}
                for k, leaf in self.leaves.items()
            },
        }


def _stage_leaf(leaf, copies: list) -> np.ndarray:
    """A fresh host copy of one leaf, as numpy.  A CUDA tensor's copy is
    enqueued into a pinned buffer (its bytes land when the stream reaches
    it); anything else is copied now."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            copies.append(buf)
        else:
            buf = t.clone(memory_format=torch.contiguous_format)
        return to_numpy(buf)
    return np.array(leaf, order="C")  # a copy; keeps a 0-d leaf 0-d


def stage_host_snapshot(state: Any, *, step: int = 0,
                        world_size: int = 1) -> HostSnapshot:
    """Host copies of every leaf of ``state`` (tensors, on the card or not,
    or numpy arrays) in fresh buffers, so an in-place update of the state
    after this returns can never reach them.  CUDA copies are enqueued on
    the current stream, and ``ready`` marks their end."""
    leaves: Dict[str, HostLeaf] = {}
    copies: list = []
    for key, leaf in tree_leaves_with_keys(state):
        arr = _stage_leaf(leaf, copies)
        leaves[key] = HostLeaf(shape=tuple(int(d) for d in arr.shape),
                               dtype=arr.dtype.name,
                               shards=[(tuple((0, int(d)) for d in arr.shape),
                                        arr)])
    ready = None
    if copies:
        ready = torch.cuda.Event()
        ready.record()
    return HostSnapshot(leaves=leaves, step=step, world_size=world_size,
                        ready=ready)


def _raw(data: np.ndarray) -> memoryview:
    """A C-contiguous array's bytes (bf16 included: ``memoryview`` has no
    format for ``ml_dtypes`` types, so go through a byte view)."""
    return memoryview(np.ascontiguousarray(data).reshape(-1).view(np.uint8))


def leaf_content_hash(leaf: HostLeaf) -> int:
    """Keyed blake2b over a leaf's shard bytes + framing (shape, dtype,
    shard indices), as the JAX package frames it: stable across processes,
    machines and the two packages."""
    frame = json.dumps([list(leaf.shape), leaf.dtype,
                        [list(map(list, idx)) for idx, _ in leaf.shards]],
                       separators=(",", ":")).encode()
    h = content_hash(b"", extra=frame)
    for _, data in leaf.shards:
        h = content_hash(_raw(data), extra=h.to_bytes(8, "little"))
    return h


def _save_npy(f, data: np.ndarray) -> None:
    """``np.save``, but a bf16 array goes out as its raw bits under the
    descr ``'bfloat16'`` (module docstring)."""
    if data.dtype.name != "bfloat16":
        np.save(f, data)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": "bfloat16", "fortran_order": False,
            "shape": tuple(data.shape)})
    f.write(_raw(data))


# ---------------------------------------------------------------------------
# On-disk layout helpers
# ---------------------------------------------------------------------------


def snapshot_dir_name(step: int) -> str:
    return f"checkpoint_{step:06d}"


def _same_shard_layout(entry: dict, leaf: HostLeaf) -> bool:
    """Does a previous manifest entry cover exactly the shard indices this
    rank stages now?  False after an elastic resize re-partitioned the
    leaf — a no-hash reference would then point at wrong coverage."""
    prev_idx = sorted(tuple(map(tuple, s["index"])) for s in entry["shards"])
    cur_idx = sorted(idx for idx, _ in leaf.shards)
    return (tuple(entry["shape"]) == tuple(leaf.shape)
            and entry["dtype"] == leaf.dtype and prev_idx == cur_idx)


def _safe_name(key: str) -> str:
    """Filesystem-safe leaf file stem; a key-hash suffix keeps distinct keys
    distinct after sanitization."""
    stem = re.sub(r"[^A-Za-z0-9_.-]", "_", key)[:80]
    return f"{stem}-{content_hash(key.encode()) & 0xFFFFFFFF:08x}"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json_atomic(path: str, obj: dict) -> None:
    """tmp + fsync + atomic rename + dir fsync: the file either exists with
    full content or not at all."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def is_committed(snapshot_dir: str) -> bool:
    return os.path.exists(os.path.join(snapshot_dir, MANIFEST))


def load_manifest(snapshot_dir: str) -> dict:
    with open(os.path.join(snapshot_dir, MANIFEST)) as f:
        return json.load(f)


def latest_committed(run_dir: str) -> Optional[str]:
    """Newest snapshot dir under ``run_dir`` with a committed manifest."""
    for idx in reversed(existing_checkpoint_indices(run_dir)):
        d = os.path.join(run_dir, snapshot_dir_name(idx))
        if is_committed(d):
            return d
    return None


def _rank_manifests(snapshot_dir: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        names = os.listdir(snapshot_dir)
    except FileNotFoundError:
        return out
    for n in names:
        m = _RANK_MANIFEST_RE.match(n)
        if m:
            out[int(m.group(1))] = os.path.join(snapshot_dir, n)
    return out


def maybe_commit_manifest(snapshot_dir: str, world_size: int) -> bool:
    """Merge per-rank manifests into ``manifest.json`` once ALL of THIS
    gang's ranks have staged theirs.  Written last and atomically — the
    commit point.  Safe under racing callers (both write identical content
    through an atomic rename).

    Rank manifests carry a ``gang`` id: a stale manifest left by a
    crashed/resized earlier attempt (different gang id, or a rank beyond
    this world size) never merges with fresh ones — it is simply ignored
    until its rank's fresh manifest overwrites it.  Returns True if the
    manifest is committed on exit."""
    if is_committed(snapshot_dir):
        return True
    ranks = _rank_manifests(snapshot_dir)
    loaded: Dict[int, dict] = {}
    for r, path in sorted(ranks.items()):
        if r >= world_size:
            continue  # stale leftover from a larger previous gang
        try:
            with open(path) as f:
                loaded[r] = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False  # racing writer; a later caller commits
    if set(loaded) != set(range(world_size)):
        return False
    if len({rm.get("gang", "") for rm in loaded.values()}) != 1:
        return False  # mixed attempts: wait for fresh overwrites
    first = loaded[0]
    merged = {k: first[k] for k in
              ("format", "step", "dir", "kind", "world_size", "mesh")}
    merged["ranks"] = {str(r): rm["leaves"] for r, rm in loaded.items()}
    _write_json_atomic(os.path.join(snapshot_dir, MANIFEST), merged)
    return True


def chain_refs(manifest: dict) -> set:
    """Snapshot dir NAMES a manifest's delta entries reference for their
    bytes (excluding the manifest's own dir) — the dirs retention must
    never prune while this manifest is kept."""
    own = manifest.get("dir")
    refs = set()
    for leaves in manifest.get("ranks", {}).values():
        for entry in leaves.values():
            if entry["dir"] != own:
                refs.add(entry["dir"])
    return refs


def prune_snapshots(run_dir: str, num_to_keep: Optional[int]) -> List[str]:
    """``num_to_keep`` retention over the run dir: keep the newest
    ``num_to_keep`` COMMITTED snapshots plus every dir a kept manifest's
    delta chain references, plus any newer uncommitted (in-flight) dir.
    Returns the pruned dir names."""
    if not num_to_keep or num_to_keep < 1:
        return []
    indices = existing_checkpoint_indices(run_dir)
    committed = [i for i in indices
                 if is_committed(os.path.join(run_dir, snapshot_dir_name(i)))]
    newest_committed = committed[-1] if committed else -1
    keep = {snapshot_dir_name(i) for i in committed[-num_to_keep:]}
    # protect live delta chains: anything a kept manifest references
    for name in list(keep):
        try:
            keep |= chain_refs(load_manifest(os.path.join(run_dir, name)))
        except (OSError, json.JSONDecodeError):  # racing writer; keep safe
            return []
    pruned: List[str] = []
    for i in indices:
        name = snapshot_dir_name(i)
        if name in keep or i > newest_committed:
            continue  # kept, referenced, or still in flight
        shutil.rmtree(os.path.join(run_dir, name), ignore_errors=True)
        pruned.append(name)
    return pruned


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _np_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        import ml_dtypes  # registers the name, for np.dtype and np.load

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _assemble_leaf(key: str, manifest: dict, run_dir: str) -> np.ndarray:
    """Global ndarray for one leaf from every rank's recorded shards (each
    entry names the dir that actually holds the bytes — no chain walking)."""
    entries = []
    for leaves in manifest["ranks"].values():
        e = leaves.get(key)
        if e is not None:
            entries.append(e)
    if not entries:
        raise KeyError(f"leaf {key!r} not present in snapshot manifest")
    shape = tuple(entries[0]["shape"])
    dtype = _np_dtype(entries[0]["dtype"])
    out = None if len(entries) == 1 and len(entries[0]["shards"]) == 1 \
        else np.empty(shape, dtype)
    filled = 0
    for e in entries:
        base = os.path.join(run_dir, e["dir"])
        for sh in e["shards"]:
            data = np.load(os.path.join(base, sh["file"]))
            if data.dtype != dtype and data.dtype.kind == "V":
                data = data.view(dtype)  # raw 16-bit records of a bf16 leaf
            if out is None:  # one shard covering the leaf: use it as is
                if not shape:  # the JAX package stages a scalar as [1]
                    data = data.reshape(shape)
                if tuple(data.shape) != shape:
                    raise ValueError(f"leaf {key!r}: a {data.shape} shard "
                                     f"for a {shape} leaf")
                return data.astype(dtype, copy=False)
            out[tuple(slice(a, b) for a, b in sh["index"])] = data
            filled += data.size
    if filled < int(np.prod(shape)):
        raise ValueError(
            f"leaf {key!r}: shards cover {filled} of {int(np.prod(shape))} "
            "elements — snapshot incomplete for this world size")
    return out


def _like(arr: np.ndarray, like):
    """One assembled host array placed like the target leaf: a tensor on
    its device in its dtype, or a numpy array in its dtype."""
    if isinstance(like, torch.Tensor):
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr if arr.flags.c_contiguous
                                 else arr.copy(order="C"))
        return t.to(device=like.device, dtype=like.dtype)
    want = getattr(like, "dtype", None)
    return arr if want is None else arr.astype(want, copy=False)


def _restore_into_target(target: Any, fetch: Callable[[str], Any]):
    """Rebuild ``target``'s pytree from per-key global arrays, one leaf at
    a time (at most one assembled host array live)."""
    return tree_map_with_keys(lambda key, like: _like(fetch(key), like), target)


def restore_snapshot(snapshot_dir: str, target: Any = None):
    """Restore a committed snapshot (the port's or the JAX package's).

    With ``target`` (a pytree of tensors or arrays: e.g. a fresh
    ``TrainState``) returns a new pytree of its structure, each leaf on the
    target leaf's device in its dtype.  Without ``target`` returns a flat
    ``{leaf_key: ndarray}`` dict."""
    snapshot_dir = os.path.abspath(snapshot_dir)
    if not is_committed(snapshot_dir):
        raise FileNotFoundError(
            f"{snapshot_dir} has no {MANIFEST}: never committed (crash "
            "mid-persist?) — restore from the previous snapshot")
    manifest = load_manifest(snapshot_dir)
    run_dir = os.path.dirname(snapshot_dir)
    if target is None:
        keys = set()
        for leaves in manifest["ranks"].values():
            keys.update(leaves)
        return {k: _assemble_leaf(k, manifest, run_dir) for k in sorted(keys)}
    return _restore_into_target(
        target, lambda key: _assemble_leaf(key, manifest, run_dir))


# ---------------------------------------------------------------------------
# Warm peer replicas
# ---------------------------------------------------------------------------


class ReplicaHolder:
    """Host-RAM shard replica store for ONE ring position.  Lives outside
    the gang (the trainer owns it), so it survives gang restarts."""

    def __init__(self):
        self._by_rank: Dict[int, dict] = {}

    def put_replica(self, rank: int, payload: dict) -> bool:
        payload.setdefault("rank", rank)
        cur = self._by_rank.get(rank)
        if cur is None or payload["step"] >= cur["step"]:
            self._by_rank[rank] = payload
        return True

    def get_replica(self, rank: int) -> Optional[dict]:
        return self._by_rank.get(rank)

    def all_replicas(self) -> Dict[int, dict]:
        return dict(self._by_rank)

    def newest_steps(self) -> Dict[int, int]:
        return {r: p["step"] for r, p in self._by_rank.items()}

    def clear(self) -> None:
        self._by_rank.clear()


def select_replica_set(payloads: Sequence[dict]) -> Optional[List[dict]]:
    """Newest COMPLETE replica set from a bag of per-rank payloads (as
    gathered across the ring's holders): a set is complete when one
    distinct payload exists for every save-time rank at the same step.
    Returns that set (any order) or None."""
    by_step: Dict[int, Dict[int, dict]] = {}
    for p in payloads:
        by_step.setdefault(p["step"], {})[p.get("rank", -1)] = p
    for step in sorted(by_step, reverse=True):
        ranks = by_step[step]
        world = next(iter(ranks.values()))["world_size"]
        if len(ranks) == world and set(ranks) == set(range(world)):
            return list(ranks.values())
    return None


def assemble_from_payloads(payloads: Sequence[dict]) -> Dict[str, Any]:
    """Global ``{key: ndarray}`` from a full set of per-rank replica
    payloads (all save-time ranks, same step).  Raises if coverage is
    incomplete — a partial replica set must not masquerade as a state."""
    steps = {p["step"] for p in payloads}
    if len(steps) != 1:
        raise ValueError(f"replica payloads span steps {sorted(steps)}")
    out: Dict[str, Any] = {}
    filled: Dict[str, int] = {}
    for p in payloads:
        for key, leaf in p["leaves"].items():
            shape = tuple(leaf["shape"])
            if key not in out:
                out[key] = np.empty(shape, _np_dtype(leaf["dtype"]))
                filled[key] = 0
            for idx, data in leaf["shards"]:
                if not shape:
                    out[key] = np.array(data, copy=True)
                    filled[key] = 1
                    continue
                out[key][tuple(slice(a, b) for a, b in idx)] = data
                filled[key] += int(np.asarray(data).size)
    for key, arr in out.items():
        want = int(np.prod(arr.shape)) if arr.shape else 1
        if filled[key] < want:
            raise ValueError(
                f"leaf {key!r}: replica set covers {filled[key]} of {want} "
                "elements — a rank's payload is missing")
    return out


def restore_from_payloads(payloads: Sequence[dict], target: Any = None):
    """Like :func:`restore_snapshot` but from peer-RAM replica payloads:
    the preemption-drain fast path (no storage round-trip)."""
    flat = assemble_from_payloads(payloads)
    if target is None:
        return flat
    return _restore_into_target(target, lambda key: flat[key])


# ---------------------------------------------------------------------------
# The manager: staging on the caller, persistence on a named thread
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SnapshotConfig:
    """Knobs (mirrored from the JAX package's ``CheckpointConfig``)."""

    full_snapshot_interval: int = 8
    optimizer_state_interval: int = 1
    optimizer_key_prefixes: Tuple[str, ...] = ("opt_state", "opt", "optimizer")
    num_to_keep: Optional[int] = None
    fsync: bool = True


class SnapshotManager:
    """Per-process async snapshot pipeline.

    ``save(state)`` blocks only for (a) backpressure if the previous
    snapshot is still draining (at-most-one-in-flight) and (b) enqueueing
    the device→host staging copies; waiting for them, hashing, delta
    splitting, shard writes, manifest commit, peer push and retention all
    run on the named ``train-snapshot-r<rank>`` thread.  ``stall_seconds``
    sums save()'s blocking time, ``persist_seconds`` the thread's time per
    snapshot (its wait for the copies included)."""

    def __init__(self, run_dir: str, *, world_rank: int = 0,
                 world_size: int = 1, config: Optional[SnapshotConfig] = None,
                 gang_id: str = "",
                 clock: Callable[[], float] = time.monotonic,
                 on_commit: Optional[Callable[[str, int], None]] = None,
                 on_error: Optional[Callable[[int, BaseException],
                                             None]] = None,
                 replica_push: Optional[Callable[[int, dict], None]] = None):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.world_rank = int(world_rank)
        self.world_size = int(world_size)
        self.config = config or SnapshotConfig()
        self.gang_id = gang_id
        self._clock = clock
        self._on_commit = on_commit
        self._on_error = on_error
        self._replica_push = replica_push
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight: Optional[int] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self.last_error: Optional[BaseException] = None
        # observable accounting
        self.stall_seconds = 0.0
        self.persist_seconds = 0.0
        self.bytes_written = {"full": 0, "delta": 0, "replica": 0}
        self.snapshots_taken = 0
        # step sequence continues from the last COMMITTED snapshot — NOT
        # from raw dir listing: an uncommitted dir a faster peer already
        # created would desynchronize this rank's counter from the gang's
        # (every rank derives the same base + its own save-call count)
        self._last_full = 0
        self._prev_entries: Dict[str, dict] = {}
        self._seq = 0
        prev = latest_committed(self.run_dir)
        if prev is not None:
            man = load_manifest(prev)
            self._seq = int(man["step"])
            # previous committed entries for THIS rank (delta base)
            self._prev_entries = dict(
                man["ranks"].get(str(self.world_rank), {}))
        self._thread = threading.Thread(
            target=self._drain, daemon=True,
            name=f"train-snapshot-r{self.world_rank}")
        self._thread.start()

    # -- critical-path side --------------------------------------------------
    def save(self, state: Any) -> int:
        """Stage and enqueue one snapshot; returns its step index.  The
        only step-blocking costs are backpressure + enqueueing the
        device→host copies, both metered into the stall counter."""
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise RuntimeError(
                f"previous async snapshot failed: {err!r}") from err
        t0 = self._clock()
        with self._idle:
            while self._inflight is not None:
                self._idle.wait(timeout=0.05)
            self._seq += 1
            step = self._seq
            self._inflight = step
        try:
            snap = stage_host_snapshot(state, step=step,
                                       world_size=self.world_size)
            kind = "full"
            if self._prev_entries and (
                    step - self._last_full
                    < self.config.full_snapshot_interval):
                kind = "delta"
            else:
                self._last_full = step
            self._queue.put((snap, kind))
        except BaseException:
            # a failed staging must not leave the pipeline marked busy
            # (every later save() would deadlock on the backpressure wait)
            # nor consume the step number — the gang's ranks count save
            # calls in lockstep, and a one-rank gap would block every
            # later commit barrier
            with self._idle:
                self._seq = step - 1
                self._inflight = None
                self._idle.notify_all()
            raise
        self.stall_seconds += self._clock() - t0
        self.snapshots_taken += 1
        return step

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until no snapshot is in flight (tests / clean shutdown)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._inflight is not None:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=0.05 if remaining is None
                                else min(remaining, 0.05))
        return True

    def close(self, timeout: float = 30.0) -> None:
        self.wait(timeout)
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5.0)

    @property
    def inflight(self) -> Optional[int]:
        return self._inflight

    # -- background side -----------------------------------------------------
    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            snap, kind = job
            t0 = self._clock()
            try:
                snap.wait_ready()
                self._push_replica(snap)
                self._persist(snap, kind)
            except BaseException as e:  # noqa: BLE001 — surfaced on next save()
                self.last_error = e
                logger.exception("async snapshot step %d failed", snap.step)
                if self._on_error is not None:
                    # a FINAL failed snapshot has no next save() to raise
                    # from — the callback lets the caller surface it
                    try:
                        self._on_error(snap.step, e)
                    except Exception:  # noqa: BLE001 — reporting is best-effort
                        logger.exception("snapshot on_error callback failed")
            finally:
                self.persist_seconds += self._clock() - t0
                # drop the staged buffers before the next save() allocates
                # its own (the pinned ones go back to the host allocator)
                del job, snap
                with self._idle:
                    self._inflight = None
                    self._idle.notify_all()

    def _push_replica(self, snap: HostSnapshot) -> None:
        """Newest host-RAM copy to the ring neighbor BEFORE storage: the
        drain-window restore path must not wait for the shard writes.
        Best-effort — a dead neighbor holder degrades the replica ring,
        it must never fail the durable persist behind it."""
        if self._replica_push is None:
            return
        peer = (self.world_rank + 1) % max(self.world_size, 1)
        payload = snap.to_payload()
        payload["rank"] = self.world_rank
        try:
            self._replica_push(peer, payload)
        except Exception:  # noqa: BLE001 — ring degraded, persist continues
            logger.warning(
                "peer-replica push to ring position %d failed for step %d "
                "(holder dead?); storage persist continues",
                peer, snap.step, exc_info=True)
            return
        self.bytes_written["replica"] += snap.nbytes()

    def _persist(self, snap: HostSnapshot, kind: str) -> None:
        d = os.path.join(self.run_dir, snapshot_dir_name(snap.step))
        leaf_dir = os.path.join(d, _LEAF_DIR)
        os.makedirs(leaf_dir, exist_ok=True)
        dir_name = snapshot_dir_name(snap.step)
        entries: Dict[str, dict] = {}
        written = 0
        opt_skip = self._optimizer_skip(snap.step)
        for key, leaf in snap.leaves.items():
            prev = self._prev_entries.get(key)
            if kind == "delta" and prev is not None:
                if opt_skip and self._is_optimizer_key(key) \
                        and _same_shard_layout(prev, leaf):
                    # every-N policy: reference the last written version
                    # without even hashing (the skip is the point)
                    entries[key] = dict(prev)
                    continue
                h = leaf_content_hash(leaf)
                if h == prev["hash"]:
                    entries[key] = dict(prev)
                    continue
            else:
                h = leaf_content_hash(leaf)
            files = []
            for i, (idx, data) in enumerate(leaf.shards):
                fname = f"{_LEAF_DIR}/{_safe_name(key)}" \
                        f".r{self.world_rank}.s{i}.npy"
                path = os.path.join(d, fname)
                with open(path, "wb") as f:
                    _save_npy(f, data)
                    f.flush()
                    if self.config.fsync:
                        os.fsync(f.fileno())
                written += int(data.nbytes)
                files.append({"file": fname,
                              "index": [list(p) for p in idx]})
            entries[key] = {"shape": list(leaf.shape), "dtype": leaf.dtype,
                            "hash": h, "dir": dir_name, "kind": "written",
                            "shards": files}
        if self.config.fsync:
            _fsync_dir(leaf_dir)
        rank_manifest = {
            "format": _FORMAT, "step": snap.step, "dir": dir_name,
            "kind": kind, "world_size": snap.world_size,
            "gang": self.gang_id, "mesh": self._mesh_info(),
            "leaves": entries,
        }
        _write_json_atomic(
            os.path.join(d, f"manifest.rank{self.world_rank}.json"),
            rank_manifest)
        self.bytes_written[kind] += written
        self._prev_entries = entries
        if maybe_commit_manifest(d, snap.world_size):
            prune_snapshots(self.run_dir, self.config.num_to_keep)
            if self._on_commit is not None:
                self._on_commit(d, snap.step)

    def _is_optimizer_key(self, key: str) -> bool:
        head = key.split("/", 1)[0]
        return head in self.config.optimizer_key_prefixes

    def _optimizer_skip(self, step: int) -> bool:
        n = self.config.optimizer_state_interval
        return n > 1 and step % n != 0

    def _mesh_info(self) -> dict:
        """Save-time device provenance (restore never needs it)."""
        cuda = torch.cuda.is_available()
        return {"devices": torch.cuda.device_count() if cuda else 1,
                "process_count": self.world_size,
                "backend": "cuda" if cuda else "cpu"}
