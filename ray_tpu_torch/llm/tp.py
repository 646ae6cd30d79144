"""The rank processes of a tensor-parallel paged engine.

The JAX package's engine is one program over N devices: GSPMD shards the
weights and the pool over the mesh's "tensor" axis and the host side (the
block manager, admission, the prefix cache and its tiers, scheduling)
stays one copy.  The port keeps that split with PyTorch's own idiom, one
process per card:

  - the process that builds ``PagedTorchLLMEngine`` with
    ``tensor_parallel_size = N`` is rank 0, the leader: it owns the host
    side and spawns ranks 1..N-1 here (spawned, never forked: CUDA and
    fork do not mix), each on its own card (``cuda:r`` of the cards the
    process sees; on the CPU every rank runs on the CPU);
  - every rank builds the same engine over its shard of the params and
    of the pool (``models/llama.py inference_param_specs``,
    ``paged_kv_cache_spec``) and an ``NCCLGroup`` joining the ranks
    (rendezvous on a ``TCPStore`` the leader starts on localhost; NCCL
    for CUDA tensors, gloo for CPU tensors);
  - before each device operation (a program's dispatch with its host
    inputs, a loop-state refresh, a block's gather or scatter, a warm-up)
    the leader broadcasts the operation over the group's gloo process
    group, then runs it; the other ranks run the same operation on their
    shards (``PagedTorchLLMEngine.follow``).  So every rank runs the same
    programs in the same order, and their collectives meet.

The weights reach each rank over its own pipe, never as spawn arguments
and never through CUDA IPC (a block the leader shares stays held on its
card until every consumer lets it go): random weights as the generator's
state, from which the rank draws them again tensor by tensor on its card
and keeps its slice (``models/llama.py init_params``'s ``place``), and a
caller's weights as that rank's slice alone, a host copy in shared
memory.  So no card ever holds more than its shard and one full tensor.
``RankProcesses.shutdown`` stops the ranks (the leader's engine calls it
from ``shutdown`` and when it is collected) and joins them; the processes
are daemonic, so they also end with their parent.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import sys
from typing import List

import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(seconds=300)
_JOIN_S = 30.0
_names = itertools.count()


def rank_devices(device: torch.device, size: int) -> List[torch.device]:
    """The device of each rank: ``cuda:0..size-1`` of the cards this
    process sees (refusing fewer cards than ranks: an engine never
    computes on fewer cards than it reserves), or the CPU for every rank."""
    if device.type != "cuda":
        return [device] * size
    n = torch.cuda.device_count()
    if n < size:
        raise ValueError(
            f"tensor_parallel_size={size} needs {size} CUDA devices but only "
            f"{n} are visible — an engine never computes on fewer cards than "
            f"it reserves")
    return [torch.device("cuda", i) for i in range(size)]


def _exit_with_parent(poll_s: float = 1.0) -> None:
    """End this rank when its parent is gone: a daemonic process outlives a
    parent that was killed (a serve replica's), and its loop would wait on
    the group until the collective timeout."""
    import threading
    import time

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(poll_s)
        os._exit(1)

    threading.Thread(target=watch, name="tp-rank-parent-watch",
                     daemon=True).start()


def _rank_main(rank: int, size: int, port: int, name: str, config, conn,
               devices: List[str]) -> None:
    """A follower rank: join the group, take its weights from ``conn``
    (``RankProcesses.hand_over``), build the engine on this rank's shard,
    run the leader's operations until it stops."""
    from ray_tpu_torch.llm.paged import PagedTorchLLMEngine
    from ray_tpu_torch.parallel.mesh import Mesh, TensorGroup
    from ray_tpu_torch.util.collective.collective_group.nccl_group import (
        NCCLGroup,
    )

    _exit_with_parent()
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, size, False, timeout=_TIMEOUT)
    group = NCCLGroup(size, rank, name, store=store)
    mesh = Mesh({"tensor": size}, rank=rank, group=TensorGroup(group),
                device=dev, devices=devices)
    try:
        params, gen_state, draft_params = conn.recv()
        conn.close()
        generator = None
        if gen_state is not None:
            generator = torch.Generator(device=dev)
            generator.set_state(gen_state)
        eng = PagedTorchLLMEngine(dataclasses.replace(config, mesh=mesh),
                                  params, device=dev, generator=generator,
                                  draft_params=draft_params,
                                  _params_sharded=params is not None)
        del params, draft_params  # the engine holds its own copies
        eng.follow()
    finally:
        group.destroy()


class RankProcesses:
    """Ranks 1..N-1 of an engine, spawned, and rank 0's ``mesh`` over the
    group joining them.  Each rank waits for its weights
    (:meth:`hand_over`) before it builds its engine."""

    def __init__(self, config, device: torch.device):
        from ray_tpu_torch.parallel.mesh import Mesh, TensorGroup
        from ray_tpu_torch.util.collective.collective_group.nccl_group import (
            NCCLGroup,
        )

        size = config.tensor_parallel_size
        devices = [str(d) for d in rank_devices(device, size)]
        name = f"paged-tp-{os.getpid()}-{next(_names)}"
        store = dist.TCPStore("127.0.0.1", 0, size, True, timeout=_TIMEOUT,
                              wait_for_workers=False)
        ctx = torch.multiprocessing.get_context("spawn")
        conf = dataclasses.replace(config, mesh=None)
        self.procs = []
        self._conns = []
        self._stopped = False
        try:
            for r in range(1, size):
                conn, child = ctx.Pipe()
                p = ctx.Process(
                    target=_rank_main, daemon=True,
                    name=f"ray_tpu_torch-tp-rank{r}",
                    args=(r, size, store.port, name, conf, child, devices))
                p.start()
                child.close()
                self.procs.append(p)
                self._conns.append(conn)
            self.group = NCCLGroup(size, 0, name, store=store)
        except BaseException:
            self._kill()
            raise
        self.mesh = Mesh({"tensor": size}, rank=0,
                         group=TensorGroup(self.group), device=devices[0],
                         devices=devices)

    def hand_over(self, params, gen_state, draft_params, specs) -> None:
        """Send each rank its weights: with ``params`` None the state
        ``gen_state`` of the generator every rank draws them from, else
        the rank's slice of full ``params`` by ``specs``, one rank at a
        time as a host copy.  ``draft_params`` (replicated; None: each
        rank draws them) go whole, as host copies."""
        from ray_tpu_torch.parallel.mesh import shard_pytree

        cpu = torch.device("cpu")
        if draft_params is not None:
            draft_params = shard_pytree(draft_params, None, self.mesh, cpu)
        for r, conn in enumerate(self._conns, start=1):
            part = (None if params is None
                    else shard_pytree(params, specs, self.mesh, cpu, rank=r))
            conn.send((part, gen_state, draft_params))
            conn.close()
            del part
        self._conns = []

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def _kill(self) -> None:
        for conn in self._conns:
            conn.close()
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(_JOIN_S)

    def shutdown(self) -> None:
        """Stop the ranks (a ``None`` operation ends their loop), join
        them, and destroy the group.  Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        try:
            # ranks still waiting for their weights are not in the
            # group's loop: closing their pipes ends them
            if self.alive() and not self._conns:
                self.mesh.group.broadcast_object(None)
        except Exception as e:  # noqa: BLE001 — a rank is gone: kill the rest
            print(f"tp ranks: stop broadcast failed ({e}); terminating",
                  file=sys.stderr)
        for conn in self._conns:
            conn.close()
        self._conns = []
        for p in self.procs:
            p.join(_JOIN_S)
        self._kill()
        self.group.destroy()


__all__ = ["RankProcesses", "rank_devices"]
