"""Unique identifiers for cluster entities.

TPU-native rebuild of the reference ID scheme (reference: src/ray/common/id.h).
The reference derives task/object IDs deterministically from parent task + index
so that lineage reconstruction can re-create the *same* object IDs when a task
is re-executed.  We keep that property: an ObjectID is
``sha1(task_id || return_index)`` and a re-submitted task reuses its TaskID, so
reconstructed objects keep their identity.
"""

from __future__ import annotations

import hashlib
import os
import random as _random
import threading

_NIL = "0" * 32

# Per-process CSPRNG-seeded generator for id entropy.  os.urandom (and even
# getpid) per id is a syscall costing ~100 µs on some kernels (measured on
# the task-submit hot path); one urandom seed per process keeps ids unique
# across processes (pid + 256-bit seed) at ~1 µs per id.  Re-seeded on fork
# (register_at_fork) so zygote-forked workers never share a stream.
_rng_lock = threading.Lock()
_rng_state: list = [None]


def _reseed_rng():
    _rng_state[0] = _random.Random(
        os.urandom(32) + os.getpid().to_bytes(4, "little"))


_reseed_rng()
os.register_at_fork(after_in_child=_reseed_rng)


def _rand_hex(nchars: int) -> str:
    with _rng_lock:
        return "%0*x" % (nchars, _rng_state[0].getrandbits(nchars * 4))


class BaseID:
    """Hex-string backed ID. Cheap, hashable, picklable."""

    __slots__ = ("_hex",)
    _length = 32  # hex chars

    def __init__(self, hex_str: str):
        self._hex = hex_str

    @classmethod
    def random(cls) -> "BaseID":
        return cls(_rand_hex(cls._length))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls("0" * cls._length)

    def is_nil(self) -> bool:
        return self._hex == "0" * self._length

    def hex(self) -> str:
        return self._hex

    def __hash__(self):
        return hash(self._hex)

    def __eq__(self, other):
        return isinstance(other, BaseID) and self._hex == other._hex

    def __lt__(self, other):
        return self._hex < other._hex

    def __repr__(self):
        return f"{type(self).__name__}({self._hex[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._hex,))


class JobID(BaseID):
    _length = 8


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    _length = 24


class PlacementGroupID(BaseID):
    _length = 24


class TaskID(BaseID):
    _length = 32

    @classmethod
    def for_attempt(cls, base: "TaskID", attempt: int) -> "TaskID":
        """Same task identity across attempts; attempt carried separately."""
        return base


class ObjectID(BaseID):
    _length = 40

    @classmethod
    def from_task(cls, task_id: TaskID, return_index: int) -> "ObjectID":
        h = hashlib.sha1(f"{task_id.hex()}:{return_index}".encode()).hexdigest()
        return cls(h)

    @classmethod
    def from_put(cls, worker_id: WorkerID, put_index: int) -> "ObjectID":
        h = hashlib.sha1(f"put:{worker_id.hex()}:{put_index}".encode()).hexdigest()
        return cls(h)


class _Counter:
    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._n += 1
            return self._n
