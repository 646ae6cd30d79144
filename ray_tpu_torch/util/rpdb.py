"""Remote pdb for worker processes.

reference: python/ray/util/rpdb.py — `ray_tpu_torch.util.rpdb.set_trace()` inside
a task/actor opens a TCP-served pdb, announces it in the GCS KV, and blocks
until a client attaches; `python -m ray_tpu_torch debug` lists open breakpoints
and connects.  Post-mortem: set RAY_TPU_POST_MORTEM=1 and any task raising
an exception drops into a remote pdb at the crash frame.
"""

from __future__ import annotations

import os
import pdb
import socket
import sys
import uuid
from typing import List, Optional


class _SocketIO:
    """File-like stdin/stdout over one accepted connection."""

    def __init__(self, conn: socket.socket):
        self._r = conn.makefile("r")
        self._w = conn.makefile("w")

    def readline(self):
        return self._r.readline()

    def write(self, data):
        self._w.write(data)
        return len(data)

    def flush(self):
        self._w.flush()


def _default_bind_host() -> str:
    """Bind where this worker is reachable from other nodes: the address the
    worker's own RPC server advertises (loopback only for local clusters)."""
    try:
        from ray_tpu_torch._private.worker import _global_worker

        if _global_worker is not None:
            return _global_worker.server.address[0]
    except Exception:  # noqa: BLE001 — no worker yet: loopback is the right default
        pass
    return "127.0.0.1"


class RemotePdb(pdb.Pdb):
    def __init__(self, host: Optional[str] = None, port: int = 0,
                 quiet: bool = False):
        host = host or _default_bind_host()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self.address = self._listener.getsockname()
        self._quiet = quiet
        self._conn: Optional[socket.socket] = None
        self._key: Optional[str] = None

    def _announce(self, label: str):
        """Record the open breakpoint in the GCS KV so `ray_tpu_torch debug` can
        find it (reference: ray debug's KV-registered active breakpoints)."""
        try:
            from ray_tpu_torch._private.worker import _global_worker

            if _global_worker is None:
                return
            self._key = f"debug:{uuid.uuid4().hex[:12]}"
            _global_worker.gcs.call("KVPut", {
                "key": self._key,
                "value": {"host": self.address[0], "port": self.address[1],
                          "pid": os.getpid(), "label": label},
                "overwrite": True,
            }, timeout=5)
        except Exception:  # noqa: BLE001
            self._key = None

    def _withdraw(self):
        if self._key is None:
            return
        try:
            from ray_tpu_torch._private.worker import _global_worker

            _global_worker.gcs.call("KVDel", {"key": self._key}, timeout=5)
        except Exception:  # noqa: BLE001 — GCS gone: the session key dies with it
            pass

    def _accept(self, label: str):
        if not self._quiet:
            print(f"RemotePdb [{label}] waiting for client at "
                  f"{self.address[0]}:{self.address[1]} "
                  f"(connect: python -m ray_tpu_torch debug)",
                  file=sys.stderr, flush=True)
        self._announce(label)
        conn, _ = self._listener.accept()
        self._conn = conn
        io = _SocketIO(conn)
        pdb.Pdb.__init__(self, stdin=io, stdout=io)
        self.prompt = "(ray_tpu_torch-pdb) "

    def cleanup(self):
        self._withdraw()
        for s in (self._conn, self._listener):
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass

    # pdb exits: always clean up the KV entry + sockets
    def do_continue(self, arg):
        try:
            return super().do_continue(arg)
        finally:
            self.cleanup()

    do_c = do_cont = do_continue

    def do_quit(self, arg):
        try:
            return super().do_quit(arg)
        finally:
            self.cleanup()

    do_q = do_exit = do_quit

    def do_EOF(self, arg):
        """Client detached (Ctrl-D): quit AND clean up — pdb's default EOF
        path skips do_quit, which would leak the KV entry + sockets."""
        try:
            return super().do_EOF(arg)
        finally:
            self.cleanup()


def set_trace(frame=None, label: Optional[str] = None):
    """Open a remote breakpoint and block for a client (reference:
    ray.util.rpdb.set_trace)."""
    rpdb = RemotePdb()
    rpdb._accept(label or "breakpoint")
    rpdb.set_trace(frame or sys._getframe().f_back)


def post_mortem(tb=None, label: Optional[str] = None):
    if tb is None:
        tb = sys.exc_info()[2]
    if tb is None:
        raise ValueError("no traceback to post-mortem")
    rpdb = RemotePdb()
    rpdb._accept(label or "post-mortem")
    try:
        rpdb.reset()
        rpdb.interaction(None, tb)
    finally:
        rpdb.cleanup()


def post_mortem_enabled() -> bool:
    return bool(os.environ.get("RAY_TPU_POST_MORTEM"))


def list_breakpoints(worker=None) -> List[dict]:
    """All currently-open remote breakpoints, from the GCS KV."""
    from ray_tpu_torch._private.worker import get_global_worker

    w = worker or get_global_worker()
    keys = w.gcs.call("KVKeys", {"prefix": "debug:"}) or []
    out = []
    for k in keys:
        v = w.gcs.call("KVGet", {"key": k})
        if v:
            out.append({"key": k, **v})
    return out


def connect(host: str, port: int):
    """Interactive bridge: local terminal <-> remote pdb socket."""
    import select

    sock = socket.create_connection((host, int(port)))
    print(f"connected to {host}:{port}; Ctrl-D to detach", file=sys.stderr)
    try:
        while True:
            readable, _, _ = select.select([sock, sys.stdin], [], [])
            if sock in readable:
                data = sock.recv(4096)
                if not data:
                    break
                sys.stdout.write(data.decode("utf-8", "replace"))
                sys.stdout.flush()
            if sys.stdin in readable:
                line = sys.stdin.readline()
                if not line:
                    break
                sock.sendall(line.encode())
    finally:
        sock.close()
