"""Device-tensor channel: one edge between two processes, CUDA tensors kept
on the card (port of the JAX package's
``experimental/channel/xla_tensor_channel.py``).

reference: python/ray/experimental/channel/torch_tensor_accelerator_channel.py
— tensors move between actors out of band while the non-tensor structure
rides the mutable-plasma metadata channel.  Here:

- the structure, the scalars and None ride a ``ShmChannel`` (the value
  with a placeholder for each tensor leaf), as in the JAX package;
- CUDA leaves travel card to card.  Between two processes on one card (the
  disaggregated deployment's prefill and decode replicas at half a card
  each) NCCL cannot help — it refuses two ranks on one device — so the
  writer gathers the leaves into a staging buffer in its own card memory,
  shared once per buffer as a CUDA IPC handle (``torch.multiprocessing``'s
  tensor reducer: the handle names the caching allocator's base block, and
  the reducer carries the buffer's offset in it).  An interprocess CUDA
  event recorded after the gather orders the reader's copy; the reader
  opens the handle once, copies device to device into its own tensors on a
  side stream, waits for that copy alone and acknowledges through a second
  ``ShmChannel``.  The writer waits for the acknowledgement before it
  reuses the buffer (never on its own stream), and ``release`` frees it
  once the reader has let go of its mapping, so a channel per request
  leaves no buffer behind.  The staging buffer is allocated with the
  allocator's expandable segments off: their memory is not shared this
  way.  With ``backend="nccl"`` CUDA leaves ride an ``NCCLGroup``'s
  send/recv instead (cards of one host; unverified: it needs two cards,
  and NCCL refuses two ranks on one).
- CPU tensors and numpy arrays ride the collective communicator: the store
  actor (``backend="store"`` or ``"auto"``) or the ``NCCLGroup``'s gloo.
- A CUDA leaf never goes through the host: with ``backend="store"`` it
  raises, and an IPC handle the reader cannot open (another card or host)
  raises on the reader.

``compression="int8"`` (lossy, opt in) sends each large float leaf as int8
codes and per-block scales: the torch codec on the card for a CUDA leaf,
the copied numpy codec for a host one (the two are bit for bit the same).
``last_write_nbytes``/``last_read_nbytes`` are the wire bytes of the last
transfer (codes + scales for a quantized leaf).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.experimental.channel.shared_memory_channel import (
    ChannelClosed,
    ShmChannel,
)

logger = logging.getLogger(__name__)

_ALIGN = 256  # bytes: each leaf's offset in the staging buffer
_ACK_CAPACITY = 4096


class _Leaf:
    """Marks where a tensor or array leaf was removed from the value.
    ``route`` is "ipc" (the staging buffer) or "comm" (the communicator);
    ``parts`` the (shape, dtype) of what travels (the tensor, or int8
    codes and fp32 scales); ``quant`` (numel, block size) when quantized."""

    __slots__ = ("index", "shape", "dtype", "kind", "route", "parts", "quant",
                 "offsets")

    def __init__(self, index, shape, dtype, kind, route, parts, quant):
        self.index = index
        self.shape = shape
        self.dtype = dtype
        self.kind = kind  # "cuda", "cpu" or "numpy"
        self.route = route
        self.parts = parts
        self.quant = quant
        self.offsets: List[int] = []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _resolve_backend(backend: str) -> str:
    if backend not in ("auto", "store", "nccl"):
        raise ValueError(f"backend must be 'auto', 'store' or 'nccl' "
                         f"(got {backend!r})")
    return backend


class CudaTensorChannel:
    """One edge: metadata via shm, CUDA leaves through a CUDA IPC staging
    buffer (or NCCL), host leaves through the communicator.

    Writer is rank 0, reader rank 1 of a dedicated 2-member collective
    group for the host leaves; both sides lazily join at first use.
    """

    WRITER, READER = 0, 1

    def __init__(self, group_name: str, backend: str = "auto",
                 capacity: Optional[int] = None,
                 _meta: Optional[ShmChannel] = None,
                 compression=None, _ack: Optional[ShmChannel] = None):
        from ray_tpu_torch.util.collective import compression as comp

        self._group = group_name
        self._backend = _resolve_backend(backend)
        self._meta = _meta or ShmChannel(
            num_readers=1, capacity=capacity or 1024 * 1024)
        # reader -> writer: "read" after each read's copies completed,
        # "closed" once the reader dropped its mapping of the buffer
        self._ack = _ack or ShmChannel(num_readers=1,
                                       capacity=_ACK_CAPACITY)
        self._comm = None
        self._comm_lock = threading.Lock()
        self.last_write_nbytes = 0
        self.last_read_nbytes = 0
        # how the last read's leaves came: "ipc", "nccl", "comm" or None
        self.last_read_path: Optional[str] = None
        self._compression = comp.resolve_spec(compression)
        if self._compression is not None and \
                self._compression.scheme == comp.SCHEME_NONE:
            self._compression = None
        # writer side
        self._staging: Optional[torch.Tensor] = None
        self._epoch = 0
        self._shared = None  # the staging buffer's reducer, sent once
        self._event = None
        self._stream = None
        self._ack_registered = False
        self._unacked = 0
        # reader side
        self._peer: Optional[torch.Tensor] = None
        self._peer_epoch = -1
        self._peer_event = None
        self._meta_registered = False

    # channels travel by value descriptor, like ShmChannel
    def __reduce__(self):
        return (CudaTensorChannel, (self._group, self._backend, None,
                                    self._meta, self._compression,
                                    self._ack))

    @property
    def name(self):
        return self._meta.name

    @property
    def backend(self) -> str:
        return self._backend

    def _communicator(self, role: int):
        with self._comm_lock:
            if self._comm is None:
                from ray_tpu_torch.experimental.channel.accelerator_context import (
                    get_accelerator_context,
                )

                cls = get_accelerator_context()
                backend = "nccl" if self._backend == "nccl" else "store"
                self._comm = cls(2, role, backend=backend,
                                 group_name=self._group)
            return self._comm

    # -- writer -------------------------------------------------------------

    def _plan_leaf(self, x, index: int, payloads: list) -> _Leaf:
        """The placeholder for one leaf; appends what travels to
        ``payloads``."""
        from ray_tpu_torch.util.collective import compression as comp

        kind = "numpy" if isinstance(x, np.ndarray) else (
            "cuda" if x.is_cuda else "cpu")
        t = torch.from_numpy(np.ascontiguousarray(x)) if kind == "numpy" \
            else x.detach()
        if kind == "cuda":
            if self._backend == "store":
                raise TypeError(
                    "a CUDA tensor on a channel with backend='store' would "
                    "cross the host: use backend='auto' (CUDA IPC on one "
                    "card) or 'nccl'")
            route = "ipc" if self._backend == "auto" else "comm"
        else:
            route = "comm"
        spec = self._compression
        quant = None
        if (spec is not None and t.is_floating_point()
                and _nbytes(t) >= spec.min_bytes):
            n, bs = t.numel(), spec.block_size
            if kind == "cuda":
                flat = t.reshape(-1).float()
                codes, scales = comp.torch_quantize_blocks(
                    F.pad(flat, (0, (-n) % bs)), bs)
            else:
                c, s = comp.quantize_blocks(t.float().numpy(), bs)
                codes, scales = torch.from_numpy(c), torch.from_numpy(s)
            parts = [codes, scales]
            quant = (n, bs)
            self._record_wire(_nbytes(t), _nbytes(codes) + _nbytes(scales))
        else:
            parts = [t.contiguous()]
        payloads.extend(parts)
        return _Leaf(index, tuple(t.shape), str(t.dtype).split(".")[1], kind,
                     route, [(tuple(p.shape), str(p.dtype).split(".")[1])
                             for p in parts], quant)

    def _split(self, value):
        """(structure with placeholders, [leaf], [payload tensors])."""
        from ray_tpu_torch._private.tree import tree_map

        leaves, payloads = [], []

        def rep(x):
            if isinstance(x, (torch.Tensor, np.ndarray)):
                leaf = self._plan_leaf(x, len(leaves), payloads)
                leaves.append(leaf)
                return leaf
            return x

        return tree_map(rep, value), leaves, payloads

    def _ensure_staging(self, nbytes: int, device) -> Optional[tuple]:
        """A staging buffer of at least ``nbytes`` on ``device``; returns
        the (epoch, reducer, event handle) the reader needs when the buffer
        is new, else None."""
        if self._staging is not None and self._staging.numel() >= nbytes:
            return None
        from torch.multiprocessing.reductions import reduce_tensor

        self._staging = None
        conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
        expandable = "expandable_segments:True" in conf
        if expandable:
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
        try:
            self._staging = torch.empty(nbytes, dtype=torch.uint8,
                                        device=device)
        finally:
            if expandable:
                torch.cuda.memory._set_allocator_settings(
                    "expandable_segments:True")
        self._shared = reduce_tensor(self._staging)
        if self._event is None:
            self._event = torch.cuda.Event(interprocess=True)
            self._event.record()  # the event exists before its handle
            self._stream = torch.cuda.Stream(device=device)
        self._epoch += 1
        return self._epoch, self._shared, self._event.ipc_handle()

    def _await_ack(self, want: str, timeout: Optional[float]):
        if not self._ack_registered:
            self._ack.register_reader(0)
            self._ack_registered = True
        while True:
            msg = self._ack.read(timeout)
            if msg == want or msg == "closed":
                return msg

    def write(self, value: Any, timeout: Optional[float] = None):
        """Send ``value``: its CUDA leaves gathered into the staging buffer
        on a side stream after the caller's stream's work, its host leaves
        through the communicator.  Waits (on the host) for the reader's
        acknowledgement of the previous value first."""
        if self._unacked:
            self._await_ack("read", timeout)
            self._unacked = 0
        structure, leaves, payloads = self._split(value)
        ipc, comm = [], []
        i = 0
        for leaf in leaves:
            for _ in leaf.parts:
                (ipc if leaf.route == "ipc" else comm).append(
                    (leaf, payloads[i]))
                i += 1
        opened = None
        if ipc:
            off, offs = 0, []
            for leaf, p in ipc:
                leaf.offsets.append(off)
                offs.append(off)
                off += -(-_nbytes(p) // _ALIGN) * _ALIGN
            device = ipc[0][1].device
            opened = self._ensure_staging(off, device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self._stream):
                for (_, p), o in zip(ipc, offs):
                    self._staging[o:o + _nbytes(p)].copy_(_as_bytes(p))
                    p.record_stream(self._stream)
            self._event.record(self._stream)
        # metadata first: the reader learns the structure, the routes, and
        # (for a new buffer) the IPC handles
        self._meta.write((structure, leaves, opened), timeout)
        self._unacked = 1
        if comm:
            c = self._communicator(self.WRITER)
            for _, p in comm:
                c.send(p, self.READER)
        self.last_write_nbytes = sum(_nbytes(p) for p in payloads)

    def _record_wire(self, logical: int, wire: int):
        try:
            from ray_tpu_torch._private import runtime_metrics

            # quant_error=-1: the writer never dequantizes its own payload
            runtime_metrics.record_collective_compression(
                "channel", self._backend, 2, self._group, int(logical),
                int(wire), "flat", "int8", quant_error=-1.0)
        except Exception:  # noqa: BLE001 — telemetry must never fail a write
            pass

    # -- reader -------------------------------------------------------------

    def register_reader(self, idx: int):
        self._meta.register_reader(idx)
        self._meta_registered = True

    def _open(self, opened):
        """Map the writer's (new) staging buffer and its event, once per
        buffer."""
        epoch, (rebuild, args), handle = opened
        if epoch == self._peer_epoch:
            return
        try:
            self._peer = rebuild(*args)
            if self._peer_event is None:
                self._peer_event = torch.cuda.Event.from_ipc_handle(
                    self._peer.device, handle)
        except Exception as e:
            raise RuntimeError(
                f"channel {self.name}: the writer's CUDA IPC buffer cannot "
                f"be opened here ({e}); a CUDA tensor is never sent through "
                "the host: use backend='nccl' across cards") from e
        self._peer_epoch = epoch
        self._stream = torch.cuda.Stream(device=self._peer.device)

    def read(self, timeout: Optional[float] = None) -> Any:
        from ray_tpu_torch._private.tree import tree_map
        from ray_tpu_torch.util.collective import compression as comp

        if not self._meta_registered:
            self.register_reader(0)
        structure, leaves, opened = self._meta.read(timeout)
        if opened is not None:
            self._open(opened)
        parts = {}
        wire = 0
        done = None
        ipc = [lf for lf in leaves if lf.route == "ipc"]
        if ipc:
            cur = torch.cuda.current_stream(self._peer.device)
            self._stream.wait_event(self._peer_event)
            with torch.cuda.stream(self._stream):
                for lf in ipc:
                    got = []
                    for (shape, dtype), o in zip(lf.parts, lf.offsets):
                        out = torch.empty(shape, dtype=getattr(torch, dtype),
                                          device=self._peer.device)
                        n = _nbytes(out)
                        _as_bytes_view(out).copy_(self._peer[o:o + n])
                        wire += n
                        got.append(out)
                    parts[lf.index] = got
            done = torch.cuda.Event()
            done.record(self._stream)
            cur.wait_stream(self._stream)
            for got in parts.values():
                for t in got:
                    t.record_stream(cur)
        comm_leaves = [lf for lf in leaves if lf.route == "comm"]
        if comm_leaves:
            c = self._communicator(self.READER)
            for lf in comm_leaves:
                got = [c.recv(self.WRITER) for _ in lf.parts]
                wire += sum(_nbytes(t) for t in got)
                parts[lf.index] = got
        out = []
        for lf in leaves:
            got = parts[lf.index]
            dtype = getattr(torch, lf.dtype)
            if lf.quant is None:
                t = got[0]
            else:
                n, bs = lf.quant
                codes, scales = got
                if codes.is_cuda:
                    t = comp.torch_dequantize_blocks(codes, scales, bs,
                                                     dtype=dtype)[:n]
                else:
                    t = torch.from_numpy(comp.dequantize_blocks(
                        codes.numpy(), scales.numpy(), n, bs)).to(dtype)
                t = t.reshape(lf.shape)
            out.append(t.numpy() if lf.kind == "numpy" else t)
        if done is not None:
            # the copies out of the staging buffer are complete: the writer
            # may reuse it (a wait on this side stream alone)
            done.synchronize()
        self._ack.write("read", timeout)
        self.last_read_nbytes = wire
        self.last_read_path = (
            None if not leaves else "ipc" if ipc else
            ("nccl" if self._backend == "nccl" else "comm"))
        return tree_map(
            lambda x: out[x.index] if isinstance(x, _Leaf) else x, structure)

    # -- lifecycle ----------------------------------------------------------

    def release(self, timeout: Optional[float] = None):
        """Let go of this side's resources.  The reader drops its mapping of
        the staging buffer and says so; the writer waits for that (or
        ``timeout``), then frees the buffer.  Either side leaves its
        collective group."""
        if self._meta_registered:
            self._peer = self._peer_event = None
            self._meta_registered = False
            try:
                self._ack.write("closed", timeout)
            except (ChannelClosed, TimeoutError):
                pass
        if self._unacked:
            self._unacked = 0
            try:
                self._await_ack("closed", timeout)
            except (ChannelClosed, TimeoutError):
                logger.warning("channel %s: no release from the reader",
                               self.name)
        if self._staging is not None:
            self._stream.synchronize()
            self._staging = self._shared = None
            torch.cuda.ipc_collect()
        with self._comm_lock:
            if self._comm is not None:
                try:
                    self._comm.destroy()
                except Exception:  # noqa: BLE001 — peer may have destroyed the group first
                    pass
                self._comm = None

    @property
    def closed(self) -> bool:
        return self._meta.closed

    def close(self):
        self._meta.close()
        self._ack.close()

    def destroy(self):
        """Close and unlink the channel's shared memory (its creator's
        call); the ends release their own resources."""
        self._meta.destroy()
        self._ack.destroy()


def _as_bytes_view(t: torch.Tensor) -> torch.Tensor:
    """A writable uint8 view of a contiguous tensor."""
    return t.reshape(-1).view(torch.uint8)
