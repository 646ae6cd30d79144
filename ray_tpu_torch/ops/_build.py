"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library is keyed by a hash of the source, every ``csrc`` header it
includes (``#include "x.cuh"``, followed recursively), the flags and the
compiler, so an edited kernel or header rebuilds and an unchanged one
loads from ``ray_tpu_torch/_build/`` (listed in .gitignore).  No PyTorch
headers are compiled: a build takes seconds, where
``torch.utils.cpp_extension`` takes minutes.  A failed build raises with
the compiler's output; nothing falls back to another path.

Nothing here runs at import time: the CPU-only test machines import this
module but never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "build from source on the machine with the card")


def _sources_of(name: str) -> List[str]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes with quotes,
    recursively, each once, in the order first included."""
    todo, seen = [name + ".cu"], []
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        with open(os.path.join(_CSRC, f), "rb") as fh:
            todo += [h.decode() for h in _INCLUDE.findall(fh.read())]
    return seen


def _target(name: str, nvcc: str) -> str:
    h = hashlib.sha256(" ".join(_FLAGS + [nvcc]).encode())
    for f in _sources_of(name):
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read() + b"\0")
    return os.path.join(_BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[List[str]] = None) -> Dict[str, Tuple[str, str]]:
    """Compile every kernel of ``names`` (default: all) that has no
    up-to-date library yet: one nvcc per source, all started together.
    Returns {name: (library path, compiler output)} -- the output, with
    ptxas's register and shared-memory report, is "" for a library that
    was already built.  Raises if any compile fails."""
    names = sources() if names is None else list(names)
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = {n: (_target(n, nvcc), "") for n in names}
    procs = {}
    for n, (path, _) in out.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *_FLAGS, "-o", tmp, os.path.join(_CSRC, n + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out[n][0])  # atomic: a reader never sees a partial .so
        out[n] = (out[n][0], log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name][0])
            lib.ray_tpu_torch_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ray_tpu_torch_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = lib.ray_tpu_torch_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
