"""Checkpoint directory helpers of the port: the local-path part of
``ray_tpu/train/_internal/checkpoint_util.py`` that the snapshots use.

The JAX package also reaches remote storage (gs://, s3://) through
fsspec; the port takes local paths only and refuses a URI.
"""

from __future__ import annotations

import os
import re
from typing import List

_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")


def is_remote_path(path: str) -> bool:
    return "://" in str(path) and not str(path).startswith("file://")


def existing_checkpoint_indices(run_dir: str) -> List[int]:
    """Indices of checkpoint_NNNNNN dirs already in a run dir (so a restarted
    gang continues the sequence instead of overwriting)."""
    if is_remote_path(run_dir):
        raise ValueError(f"{run_dir}: remote storage (fsspec) is not ported "
                         f"to ray_tpu_torch; use a local path")
    if not os.path.isdir(run_dir):
        return []
    out = []
    for name in os.listdir(run_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)
