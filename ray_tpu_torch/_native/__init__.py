"""Native (C++) components, built on demand with g++ and loaded via ctypes.

The build is cached in the package's ``_build/`` directory (listed in
.gitignore), beside the CUDA kernels' libraries; a failed toolchain falls back to the pure-Python implementations, so the package works
everywhere and is merely faster where a compiler exists.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_build_lock = threading.Lock()
_cache: dict = {}


def _sanitize_mode() -> str | None:
    """RAY_TPU_NATIVE_SANITIZE selects an instrumented build/load variant:
    "1"/"address" -> ASAN (lib<name>.asan.so), "thread" -> TSAN
    (lib<name>.tsan.so). The process must run with the matching runtime
    preloaded (LD_PRELOAD) — tests/test_native_asan.py and
    tests/test_native_tsan.py drive the native suite both ways.
    reference: the reference CI's .bazelrc asan/tsan configs
    (.bazelrc:114-134 in the upstream repo)."""
    v = os.environ.get("RAY_TPU_NATIVE_SANITIZE")
    if v in ("1", "address"):
        return "address"
    if v == "thread":
        return "thread"
    return None


def _build(name: str, extra_flags=()) -> str | None:
    src = os.path.join(_DIR, f"{name}.cc")
    mode = _sanitize_mode()
    if mode == "address":
        out = os.path.join(_BUILD_DIR, f"lib{name}.asan.so")
        flags = ["-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address",
                 *extra_flags]
    elif mode == "thread":
        out = os.path.join(_BUILD_DIR, f"lib{name}.tsan.so")
        flags = ["-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=thread",
                 *extra_flags]
    else:
        out = os.path.join(_BUILD_DIR, f"lib{name}.so")
        flags = ["-O2", *extra_flags]
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    # processes of a fresh checkout build at once: compile to a private
    # name, then rename, so none dlopens a half-written library
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-std=c++17", "-fPIC", "-shared", "-o", tmp, src,
           "-lrt", *flags]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        stderr = getattr(e, "stderr", b"")
        logger.warning("native build of %s failed (%s); using Python fallback",
                       name, (stderr or b"").decode(errors="replace")[:500])
        return None


def load(name: str) -> ctypes.CDLL | None:
    """Build (if needed) and dlopen a native component; None on failure."""
    with _build_lock:
        if name in _cache:
            return _cache[name]
        # graftlint: allow(blocking-under-lock) — the lock EXISTS to
        # single-flight the g++ compile; waiters need its artifact and
        # cannot proceed until it lands in _cache
        path = _build(name)
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                logger.warning("dlopen %s failed: %s", path, e)
        _cache[name] = lib
        return lib


def load_sched_policy() -> ctypes.CDLL | None:
    lib = load("sched_policy")
    if lib is None:
        return None
    lib.hybrid_choose.restype = ctypes.c_longlong
    lib.hybrid_choose.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double,
        ctypes.c_ulonglong,
    ]
    return lib


def load_plasma() -> ctypes.CDLL | None:
    lib = load("plasma_store")
    if lib is None:
        return None
    lib.plasma_create.restype = ctypes.c_void_p
    lib.plasma_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.plasma_destroy.argtypes = [ctypes.c_void_p]
    lib.plasma_alloc.restype = ctypes.c_uint64
    lib.plasma_alloc.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    for fn in ("plasma_seal", "plasma_unpin", "plasma_contains",
               "plasma_mark_secondary", "plasma_free"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.plasma_get.restype = ctypes.c_int
    lib.plasma_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_uint64),
                               ctypes.POINTER(ctypes.c_uint64)]
    lib.plasma_evict.restype = ctypes.c_int
    lib.plasma_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_uint64]
    for fn in ("plasma_used", "plasma_capacity", "plasma_num_objects"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.plasma_base.restype = ctypes.c_void_p
    lib.plasma_base.argtypes = [ctypes.c_void_p]
    return lib
