"""Shared checkpoint persistence helpers (used by train's BackendExecutor
and the step snapshots).

The JAX package also reaches remote storage (gs://, s3://) through
fsspec; the port takes local paths only and refuses a URI.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Tuple

_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")


def is_remote_path(path: str) -> bool:
    return "://" in str(path) and not str(path).startswith("file://")


def refuse_remote(path: str):
    raise ValueError(f"{path}: remote storage (fsspec) is not ported to "
                     f"ray_tpu_torch; use a local path")


def normalize_local_path(path: str) -> str:
    """Strip the canonical fsspec local scheme: file:///x -> /x (callers
    then treat it as a plain local path)."""
    p = str(path)
    if p.startswith("file://"):
        return p[len("file://"):] or "/"
    return p


def join_path(base: str, *names: str) -> str:
    if is_remote_path(base):
        refuse_remote(base)
    return os.path.join(base, *names)


def makedirs_any(path: str) -> None:
    if is_remote_path(path):
        refuse_remote(path)
    os.makedirs(path, exist_ok=True)


def rmtree_any(path: str) -> None:
    if is_remote_path(path):
        refuse_remote(path)
    shutil.rmtree(path, ignore_errors=True)


def commit_dir_atomic(tmp: str, dest: str, replace: bool = True) -> None:
    """Move a FULLY-staged sibling dir into place.  ``dest`` is never
    observable partially written: every committed copy is complete, and a
    caller losing a concurrent race accepts the winner's complete copy
    (and cleans up its own staging) rather than fighting over the slot.

    ``replace=False`` (concurrent callers staging the SAME content, e.g.
    to_directory): an existing dest is accepted as-is — no retire/swap, so
    a reader of the winner's copy never sees the dest vanish mid-read."""
    import uuid as uuid_mod

    try:
        os.rename(tmp, dest)  # fast path: dest absent
        return
    except FileNotFoundError:
        shutil.rmtree(tmp, ignore_errors=True)
        raise  # dest's parent is gone — NOT a race; don't claim success
    except OSError:
        pass  # dest occupied
    if not replace and os.path.isdir(dest):
        shutil.rmtree(tmp, ignore_errors=True)
        return
    old = f"{dest}.old-{uuid_mod.uuid4().hex[:8]}"
    try:
        os.rename(dest, old)  # retire the previous complete contents
    except FileNotFoundError:
        # dest vanished under a concurrent committer mid-swap: retry the
        # fast path once; if their complete commit landed, accept it
        try:
            os.rename(tmp, dest)
            return
        except OSError:
            if os.path.isdir(dest):
                shutil.rmtree(tmp, ignore_errors=True)
                return
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    except OSError:
        # environmental failure (permissions, I/O): the previous dest is
        # intact — surface it rather than discarding the staged copy and
        # reporting success
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        os.rename(tmp, dest)
    except OSError:
        if os.path.isdir(dest):
            # a concurrent complete commit took the slot in the window
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.rmtree(old, ignore_errors=True)
            return
        os.rename(old, dest)  # roll the previous contents back
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(old, ignore_errors=True)


def persist_staged_checkpoint(src_path: str, dest: str) -> str:
    """Move (if worker-staged) or copy a local checkpoint dir to ``dest``.

    Crash-safe replacement: the bytes are fully staged NEXT TO the
    destination first, then committed by rename — a crash mid-persist
    leaves the previous checkpoint intact and restorable (the old
    rmtree-then-copy order left a corrupt "latest" instead)."""
    import uuid as uuid_mod

    staged_src = os.path.dirname(src_path).endswith(".staged")
    if is_remote_path(dest):
        refuse_remote(dest)
    if os.path.abspath(src_path) == os.path.abspath(dest):
        return dest
    tmp = f"{dest}.tmp-{uuid_mod.uuid4().hex[:8]}"
    try:
        if staged_src:
            shutil.move(src_path, tmp)
        else:
            shutil.copytree(src_path, tmp)
    except BaseException:
        # a crash/kill mid-copy leaves only the staging dir; the previous
        # dest is untouched and still restores
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    commit_dir_atomic(tmp, dest)
    return dest


def existing_checkpoint_indices(run_dir: str) -> List[int]:
    """Indices of checkpoint_NNNNNN dirs already in a run dir (so a restarted
    gang continues the sequence instead of overwriting)."""
    if is_remote_path(run_dir):
        refuse_remote(run_dir)
    if os.path.isdir(run_dir):
        names = os.listdir(run_dir)
    else:
        return []
    out = []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def set_session_resume_checkpoint(path: str) -> bool:
    """Runs inside a worker actor (via _execute): point the session's
    latest_checkpoint at ``path`` so train.get_checkpoint() resumes from it."""
    from ray_tpu_torch.train._checkpoint import Checkpoint
    from ray_tpu_torch.train._internal import session as session_mod

    s = session_mod.get_session()
    if s is not None:
        s.latest_checkpoint = Checkpoint(path)
    return True
