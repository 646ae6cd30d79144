"""Small shared utilities."""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import Future
from typing import Callable

# getpid is a real syscall on some kernels (~50 µs measured in this
# container) and sits on per-task hot paths (event stamping); cache it,
# fork-safely (zygote workers fork without exec).
_PID = [os.getpid()]
os.register_at_fork(after_in_child=lambda: _PID.__setitem__(0, os.getpid()))


def fast_getpid() -> int:
    return _PID[0]


class DaemonExecutor:
    """Minimal thread pool whose threads are daemonic, so interpreter exit is
    never blocked by in-flight RPC waits (unlike concurrent.futures'
    ThreadPoolExecutor, whose atexit hook joins worker threads)."""

    def __init__(self, max_workers: int, thread_name_prefix: str = "daemon-pool"):
        self._max = max_workers
        self._prefix = thread_name_prefix
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._idle = 0
        self._shutdown = False

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._shutdown:
                fut.set_exception(RuntimeError("executor shut down"))
                return fut
            self._q.put((fut, fn, args, kwargs))
            if self._idle == 0 and len(self._threads) < self._max:
                t = threading.Thread(
                    target=self._run, daemon=True, name=f"{self._prefix}-{len(self._threads)}"
                )
                self._threads.append(t)
                t.start()
        return fut

    def _run(self):
        while True:
            with self._lock:
                self._idle += 1
            item = self._q.get()
            with self._lock:
                self._idle -= 1
            if item is None:
                return
            fut, fn, args, kwargs = item
            if self._shutdown:
                fut.cancel()
                continue
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

    def shutdown(self, wait: bool = False, cancel_futures: bool = False):
        with self._lock:
            self._shutdown = True
            n = len(self._threads)
        for _ in range(n):
            self._q.put(None)


def parse_host_port(address: str, default_host: str = "127.0.0.1"):
    """Parse a 'host:port' string (one canonical place; init() and the
    ray:// client both route here)."""
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"address {address!r} must be 'host:port' "
            "(or 'ray://host:port' for client mode)")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]  # bracketed IPv6 literal, e.g. [::1]:8000
    return (host or default_host, int(port))
