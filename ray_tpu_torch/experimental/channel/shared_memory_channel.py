"""Single-slot shared-memory channels for compiled graphs.

TPU-native equivalent of the reference's mutable-plasma-object channels
(reference: python/ray/experimental/channel/shared_memory_channel.py backed by
src/ray/core_worker/experimental_mutable_object_manager.cc).  Semantics match
the reference's mutable objects: ONE slot, a writer that blocks until every
registered reader has consumed the previous version, and readers that block
until a new version is written.  This bypasses the per-call RPC/scheduling
path entirely — after compile, steady-state data movement is two memcpys and
two counter bumps per edge.

Layout of the shared segment (all fields little-endian uint64, 8-aligned):

    [0]  closed flag (0 open, 1 closed)
    [1]  write_seq   (versions completed by the writer)
    [2]  data_len    (payload bytes of the current version)
    [3]  num_readers
    [4..4+R) read_seq per reader
    [...] payload area

Synchronisation relies on aligned single-word store atomicity and total store
order (x86-64 — this framework's deployment target: TPU-VM hosts and the CI
image are x86_64): the writer publishes payload and len BEFORE bumping
write_seq; readers ack by bumping their own read_seq slot only after copying
out.  Readers additionally re-check write_seq after the copy and retry if it
moved, so a torn read can only happen if stores become visible out of program
order (impossible under TSO).
"""

from __future__ import annotations

import os
import pickle
import struct
import time
import uuid
from multiprocessing import shared_memory
from typing import Any, Optional

_U64 = struct.Struct("<Q")

_CLOSED = 0
_WRITE_SEQ = 8
_DATA_LEN = 16
_NUM_READERS = 24
_READ_SEQ0 = 32

DEFAULT_CAPACITY = 16 * 1024 * 1024


class ChannelClosed(Exception):
    """The channel was torn down (CompiledDAG.teardown or process exit)."""


class ChannelFull(Exception):
    """Payload exceeds the channel's fixed slot capacity."""


def _spin_wait(cond, timeout: Optional[float], closed_check):
    """Poll `cond()` with a spin-then-sleep backoff; raise on close/timeout."""
    deadline = None if timeout is None else time.monotonic() + timeout
    spins = 0
    while True:
        if cond():
            return
        if closed_check():
            raise ChannelClosed()
        spins += 1
        if spins < 200:
            continue
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError("channel wait timed out")
        time.sleep(2e-5 if spins < 2000 else 2e-4)


class ShmChannel:
    """Single-writer / N-reader single-slot channel over POSIX shared memory."""

    def __init__(self, num_readers: int = 1, capacity: int = DEFAULT_CAPACITY,
                 name: Optional[str] = None, _create: bool = True):
        self.num_readers = num_readers
        self.capacity = capacity
        self._payload_off = _READ_SEQ0 + 8 * num_readers
        if _create:
            name = name or f"rtpu-chan-{uuid.uuid4().hex[:12]}"
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=self._payload_off + capacity)
            buf = self._shm.buf
            for off in (_CLOSED, _WRITE_SEQ, _DATA_LEN):
                _U64.pack_into(buf, off, 0)
            _U64.pack_into(buf, _NUM_READERS, num_readers)
            for r in range(num_readers):
                _U64.pack_into(buf, _READ_SEQ0 + 8 * r, 0)
        else:
            from ray_tpu_torch._private.object_store import attach_shm

            self._shm = attach_shm(name)
        self.name = name
        self._creator = _create
        self._reader_idx: Optional[int] = None
        self._last_read = 0

    # -- wire format: channels travel by (name, num_readers, capacity) ------

    def __reduce__(self):
        return (ShmChannel._attach, (self.name, self.num_readers, self.capacity))

    @staticmethod
    def _attach(name, num_readers, capacity):
        ch = ShmChannel(num_readers=num_readers, capacity=capacity,
                        name=name, _create=False)
        return ch

    # -- header accessors ---------------------------------------------------

    def _u64(self, off: int) -> int:
        return _U64.unpack_from(self._shm.buf, off)[0]

    def _set_u64(self, off: int, v: int):
        _U64.pack_into(self._shm.buf, off, v)

    @property
    def closed(self) -> bool:
        try:
            return self._u64(_CLOSED) != 0
        except (ValueError, OSError):
            return True

    # -- writer -------------------------------------------------------------

    def write_bytes(self, payload: bytes, timeout: Optional[float] = None):
        if len(payload) > self.capacity:
            raise ChannelFull(
                f"payload {len(payload)}B > channel capacity {self.capacity}B; "
                "compile with a larger buffer_size_bytes")
        wseq = self._u64(_WRITE_SEQ)
        _spin_wait(
            lambda: min(self._u64(_READ_SEQ0 + 8 * r)
                        for r in range(self.num_readers)) >= wseq,
            timeout, lambda: self.closed)
        buf = self._shm.buf
        buf[self._payload_off:self._payload_off + len(payload)] = payload
        self._set_u64(_DATA_LEN, len(payload))
        self._set_u64(_WRITE_SEQ, wseq + 1)

    def write(self, value: Any, timeout: Optional[float] = None):
        self.write_bytes(pickle.dumps(value, protocol=5), timeout)

    # -- reader -------------------------------------------------------------

    def register_reader(self, idx: int):
        if not 0 <= idx < self.num_readers:
            raise IndexError(f"reader index {idx} out of range "
                             f"[0, {self.num_readers})")
        self._reader_idx = idx
        self._last_read = self._u64(_READ_SEQ0 + 8 * idx)

    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        idx = self._reader_idx
        assert idx is not None, "call register_reader() first"
        _spin_wait(lambda: self._u64(_WRITE_SEQ) > self._last_read,
                   timeout, lambda: self.closed)
        while True:
            seq = self._u64(_WRITE_SEQ)
            n = self._u64(_DATA_LEN)
            data = bytes(self._shm.buf[self._payload_off:self._payload_off + n])
            if self._u64(_WRITE_SEQ) == seq:
                break
        self._last_read += 1
        self._set_u64(_READ_SEQ0 + 8 * idx, self._last_read)
        return data

    def read(self, timeout: Optional[float] = None) -> Any:
        return pickle.loads(self.read_bytes(timeout))

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        try:
            self._set_u64(_CLOSED, 1)
        except (ValueError, OSError):
            pass

    def destroy(self):
        self.close()
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass
        if self._creator:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):
        try:
            self._shm.close()
        except Exception:  # noqa: BLE001 — __del__: close is best-effort
            pass


class IntraProcessChannel:
    """Same-process edge: a single mutable slot, no copies, no shm
    (reference: experimental/channel/intra_process_channel.py).

    Available for same-process pipelines that want the channel interface;
    the compiled DAG currently passes same-actor values in-memory directly.
    """

    def __init__(self):
        self._value = None
        self._full = False

    def write(self, value, timeout=None):
        self._value = value
        self._full = True

    def read(self, timeout=None):
        assert self._full, "intra-process channel read before write"
        v = self._value
        self._value = None
        self._full = False
        return v

    def close(self):
        pass

    def destroy(self):
        pass
