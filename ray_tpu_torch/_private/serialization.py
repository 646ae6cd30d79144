"""Object serialization with zero-copy buffer support.

TPU-native equivalent of the reference's serialization stack
(reference: python/ray/_private/serialization.py + cloudpickle): cloudpickle
for code/closures, pickle protocol 5 out-of-band buffers so large numpy/jax
host arrays round-trip through the shared-memory store without copies on the
read side.

Wire layout of a stored object (one contiguous region in the store):

    [8B meta_len][meta = pickle((inband, [len0, len1, ...]))]
    [align64][buffer0][align64][buffer1]...

Buffer offsets are recomputed by the reader from the lengths with the same
alignment rule, so the layout needs no absolute offsets.  Buffers are 64-byte
aligned so reconstructed numpy arrays are alignment-friendly.

Torch tensors take the numpy path: a strided tensor's bytes go out of band
as a numpy array (dtypes numpy lacks, bf16 and the float8 types, through an
unsigned view of their width), and a CPU tensor read back is a view of the
store, as a numpy array is.  A CUDA tensor is copied to the host once, at
put, and rebuilt on the reader's current CUDA device, as a ``jax.Array``
rebuilds on the reader's default device; a reader with no card raises
rather than hand back a CPU tensor.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from typing import List, Tuple

import cloudpickle

_ALIGN = 64
_LEN = struct.Struct("<Q")


def _aligned(x: int) -> int:
    return (x + _ALIGN - 1) // _ALIGN * _ALIGN


_UNSIGNED = {1: "uint8", 2: "uint16", 4: "uint32", 8: "uint64"}


def _rebuild_tensor(array, dtype, on_cuda: bool, requires_grad: bool):
    import torch

    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError(
            "this object holds a CUDA tensor, and this process has no CUDA "
            "device to rebuild it on")
    t = torch.from_numpy(array)  # aliases the buffer it was read from
    if t.dtype != dtype:
        t = t.view(dtype)
    if on_cuda:
        t = t.to(torch.cuda.current_device())
    return t.requires_grad_() if requires_grad else t


def _reduce_tensor(t):
    import torch

    host = t.detach().resolve_conj().resolve_neg().contiguous().cpu()
    try:
        array = host.numpy()
    except TypeError:  # no numpy dtype: the bits through an unsigned view
        array = host.view(getattr(torch, _UNSIGNED[host.element_size()])).numpy()
    return _rebuild_tensor, (array, t.dtype, t.is_cuda, t.requires_grad)


class _Pickler(cloudpickle.Pickler):
    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and type(obj) is torch.Tensor
                and obj.layout is torch.strided and not obj.is_quantized
                and obj.device.type in ("cpu", "cuda")):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def _dumps(obj, buffer_callback=None) -> bytes:
    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def dumps_with_buffers(obj) -> Tuple[bytes, List[memoryview]]:
    """Returns (meta_bytes, raw_buffers). Total size via serialized_size."""
    pbufs: List[pickle.PickleBuffer] = []
    inband = _dumps(obj, buffer_callback=pbufs.append)
    raws = []
    for pb in pbufs:
        try:
            raws.append(pb.raw())
        except BufferError:
            # Non-contiguous buffer: copy to contiguous bytes.
            raws.append(memoryview(bytes(pb)))
    meta = pickle.dumps((inband, [r.nbytes for r in raws]), protocol=5)
    return meta, raws


def serialized_size(meta: bytes, raws) -> int:
    offset = _LEN.size + len(meta)
    for r in raws:
        offset = _aligned(offset) + r.nbytes
    return offset


def write_to(view: memoryview, meta: bytes, raws) -> int:
    """Serialize into ``view``; returns total bytes written."""
    view[: _LEN.size] = _LEN.pack(len(meta))
    offset = _LEN.size
    view[offset : offset + len(meta)] = meta
    offset += len(meta)
    for r in raws:
        offset = _aligned(offset)
        n = r.nbytes
        view[offset : offset + n] = r.cast("B")
        offset += n
    return offset


class _Pinned:
    """A buffer of the store that keeps ``pin`` alive as long as anything
    rebuilt over it (a numpy array, a CPU tensor) lives: the owner frees an
    object when its last ObjectRef goes, and a zero-copy view must not
    outlive the object it reads."""

    __slots__ = ("_view", "_pin")

    def __init__(self, view: memoryview, pin):
        self._view, self._pin = view, pin

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self._view)


def read_from(view: memoryview, pin=None):
    """Zero-copy deserialize from ``view`` (buffers alias the view; given
    ``pin``, the ObjectRef read through, every buffer holds it)."""
    (meta_len,) = _LEN.unpack(view[: _LEN.size])
    inband, lengths = pickle.loads(view[_LEN.size : _LEN.size + meta_len])
    offset = _LEN.size + meta_len
    buffers = []
    for n in lengths:
        offset = _aligned(offset)
        buf = view[offset : offset + n]
        buffers.append(buf if pin is None else _Pinned(buf, pin))
        offset += n
    return pickle.loads(inband, buffers=buffers)


def dumps_inline(obj) -> bytes:
    """One-shot in-band serialization for small objects (RPC payloads)."""
    return _dumps(obj)


def loads_inline(data: bytes):
    return pickle.loads(data)
