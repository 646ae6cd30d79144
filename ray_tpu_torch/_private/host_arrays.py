"""Tensors to and from the numpy arrays the JAX package reads and writes.

numpy has no bf16 of its own; the JAX package's bf16 arrays are
``ml_dtypes.bfloat16``, the same bits as torch's.  So a bf16 tensor goes
out as an ``ml_dtypes.bfloat16`` view of its bits, and such an array comes
back through a 16-bit integer view.  ``ml_dtypes`` is imported only for
bf16 (JAX depends on it; the H100 machine has it too).
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view (bf16 as ``ml_dtypes.bfloat16``; the same
    memory, no copy)."""
    if t.dtype != torch.bfloat16:
        return t.numpy()
    import ml_dtypes

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def from_numpy(arr, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from a numpy array (``ml_dtypes.bfloat16``
    included), cast to ``dtype`` when given."""
    arr = np.array(arr)  # a writable contiguous copy: torch shares its memory
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)
