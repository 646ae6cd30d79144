"""Checkpoint: a directory of files, referenced by path.

reference: python/ray/train/_checkpoint.py (Checkpoint = directory + fsspec
URI); the port takes local paths only.  Sharded checkpoints (save_sharded /
restore_sharded below) go through torch.distributed.checkpoint where the
JAX package uses orbax: every rank writes its own shards, and a restore
can go to another layout.  The two formats differ: neither package reads
the other's sharded checkpoints (the step snapshots, ``_internal/
snapshot.py``, are the shared format).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, Optional


from ray_tpu_torch.train._internal.checkpoint_util import (
    is_remote_path as _is_remote,
    normalize_local_path as _normalize_local,
    refuse_remote as _refuse_remote,
)


class Checkpoint:
    """A reference to a local directory holding checkpoint data (reference:
    Checkpoint = directory + fsspec URI; a URI refuses here)."""

    def __init__(self, path: str):
        p = os.fspath(path)
        if _is_remote(p):
            _refuse_remote(p)
        self.path = os.path.abspath(_normalize_local(p))

    @classmethod
    def from_directory(cls, path) -> "Checkpoint":
        return cls(path)

    def as_directory(self):
        """Context manager over a local view of the checkpoint: its own
        directory."""
        @contextlib.contextmanager
        def cm() -> Iterator[str]:
            yield self.path

        return cm()

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize the checkpoint at ``path`` (or a fresh temp dir).

        Collision-free under concurrent callers sharing one dest on one
        host: each caller stages into a unique sibling and commits by
        rename, so ``dest`` only ever holds one caller's COMPLETE copy —
        never an interleaving of two mid-flight downloads."""
        from ray_tpu_torch.train._internal.checkpoint_util import commit_dir_atomic

        dest = path or os.path.join(tempfile.gettempdir(),
                                    f"ckpt_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) == self.path:
            return dest
        # replace a PRE-EXISTING dest (stale materialization), but accept a
        # concurrent caller's copy committed while we staged — same
        # checkpoint, and retiring it would yank the dir from under their
        # readers
        replace = os.path.isdir(dest)
        tmp = f"{dest}.tmp-{uuid.uuid4().hex[:8]}"
        try:
            shutil.copytree(self.path, tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        commit_dir_atomic(tmp, dest, replace=replace)
        return dest

    def _meta_path(self) -> str:
        return os.path.join(self.path, ".metadata.json")

    def update_metadata(self, metadata: Dict[str, Any]):
        import json

        existing = self.get_metadata()
        existing.update(metadata)
        with open(self._meta_path(), "w") as f:
            json.dump(existing, f)

    def get_metadata(self) -> Dict[str, Any]:
        import json

        meta = self._meta_path()
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
        return {}

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


def _flat_tensors(state: Any) -> Dict[str, Any]:
    """``{leaf key: tensor}`` in the JAX package's key order (a leaf that
    is not a tensor becomes one)."""
    import torch

    from ray_tpu_torch._private.tree import tree_leaves_with_keys

    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in tree_leaves_with_keys(state)}


def save_sharded(state: Any, path: str, *, force: bool = True) -> str:
    """Write a pytree of tensors (nested dicts, tuples, NamedTuples, lists)
    with torch.distributed.checkpoint.  Inside a process group every rank
    calls this together and writes its own shards: a DTensor leaf's local
    shards, a plain tensor once (it counts as replicated).  ``force=False``
    refuses an existing ``path``."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"{path} exists (force=False)")
    dcp.save(_flat_tensors(state),
             storage_writer=dcp.FileSystemWriter(path),
             no_dist=not dist.is_initialized())
    return path


def restore_sharded(path: str, target: Any = None) -> Any:
    """Restore what :func:`save_sharded` wrote.  ``target`` (a pytree of
    its structure: tensors or DTensors of any layout) is filled in place
    and returned, each leaf resharded to the target's layout; without it
    a flat ``{leaf key: tensor}`` dict of whole CPU tensors comes back."""
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from ray_tpu_torch._private.tree import tree_map_with_keys

    path = os.path.abspath(path)
    reader = dcp.FileSystemReader(path)
    if target is None:
        meta = reader.read_metadata().state_dict_metadata
        flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                for k, m in meta.items()}
    else:
        flat = _flat_tensors(target)
    dcp.load(flat, storage_reader=reader, no_dist=not dist.is_initialized())
    if target is None:
        return flat
    return tree_map_with_keys(lambda k, _: flat[k], target)
