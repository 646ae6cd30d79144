"""Native (C/XLA-frame) stack dumps of live workers.

The reference's reporter agent shells out to py-spy, which can show
native frames of a worker wedged inside C++/CUDA
(dashboard/modules/reporter/reporter_agent.py).  py-spy is not in this
image; the equivalent here is worker-carried: every worker installs a
C-level SIGUSR2 handler (``_native/stack_dump.cc``) that appends the
receiving thread's ``backtrace(3)`` to a per-process dump file, and the
raylet's dump endpoint directs the signal at EVERY thread of the target
via ``tgkill`` — a thread spinning inside an XLA dispatch or the native
arena is interrupted at the C level, where a Python-level handler (or
``sys._current_frames``) shows nothing.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import platform
import signal
import tempfile
import time
from typing import Optional

_SYS_TGKILL = {"x86_64": 234, "aarch64": 131}


def dump_path(pid: Optional[int] = None) -> str:
    # per-uid, 0700 dir: the path is predictable, so a world-shared /tmp
    # dir would invite symlink clobbers (the C side also opens O_NOFOLLOW)
    base = os.path.join(tempfile.gettempdir(),
                        f"ray_tpu_native_dumps_{os.getuid()}")
    os.makedirs(base, mode=0o700, exist_ok=True)
    return os.path.join(base, f"{pid or os.getpid()}.dump")


def install() -> Optional[str]:
    """Install the SIGUSR2 native-dump handler in THIS process; returns
    the dump file path, or None when the native component is unavailable
    (pure-Python fallback: the Python-level stack endpoints still work)."""
    from ray_tpu_torch import _native

    lib = _native.load("stack_dump")
    if lib is None:
        return None
    lib.stack_dump_install.restype = ctypes.c_int
    lib.stack_dump_install.argtypes = [ctypes.c_char_p]
    path = dump_path()
    if lib.stack_dump_install(path.encode()) != 0:
        return None
    return path


def _tgkill(pid: int, tid: int, sig: int) -> bool:
    nr = _SYS_TGKILL.get(platform.machine())
    if nr is None:
        return False
    libc = ctypes.CDLL(None, use_errno=True)
    return libc.syscall(nr, pid, tid, sig) == 0


def dump_native_stacks(pid: int, timeout: float = 2.0) -> str:
    """Signal every thread of ``pid`` to append its native stack, then
    return the dump file contents (most recent dump last)."""
    path = dump_path(pid)
    if not os.path.exists(path):
        # install() creates the file when it registers the handler — its
        # absence means the target NEVER installed one, and SIGUSR2's
        # default disposition would TERMINATE it.  Never signal blind.
        return (f"(no native dump handler in {pid} — worker predates the "
                "dump feature, or the native component failed to build)")
    start_size = os.path.getsize(path)
    task_dir = f"/proc/{pid}/task"
    try:
        tids = [int(t) for t in os.listdir(task_dir)]
    except OSError:
        return f"(process {pid} not found)"
    delivered = 0
    for tid in tids:
        if _tgkill(pid, tid, signal.SIGUSR2):
            delivered += 1
    if not delivered:
        try:
            os.kill(pid, signal.SIGUSR2)  # process-directed fallback
            delivered = 1
        except OSError:
            return f"(cannot signal process {pid})"
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size > start_size:
            # give stragglers a beat to finish writing
            time.sleep(0.2)
            break
        time.sleep(0.05)
    with open(path, "rb") as f:
        f.seek(start_size)
        return f.read().decode(errors="replace")
