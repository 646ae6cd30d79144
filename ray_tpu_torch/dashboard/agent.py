"""Per-node agent: stats, stack traces, CPU profiling.

reference: python/ray/dashboard/agent.py + dashboard/modules/reporter/ —
each node runs an agent the head queries for node/worker stats, py-spy
stack dumps, and profiling.  Here the agent rides the raylet's existing RPC
server (handlers Agent*, wired in raylet.py); stacks and profiles come from
the workers themselves (sys._current_frames / a sampling profiler in
worker.py), which needs no ptrace privileges the way py-spy does.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

_CLK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _read_proc_stat() -> Optional[List[int]]:
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:]
        return [int(x) for x in fields]
    except (OSError, ValueError):
        return None


def _meminfo() -> Dict[str, int]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                name, _, rest = line.partition(":")
                out[name] = int(rest.split()[0]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return out


class NodeStatsCollector:
    """CPU% needs two /proc/stat samples; the collector keeps the last one."""

    def __init__(self):
        self._last = _read_proc_stat()
        self._last_t = time.monotonic()

    def cpu_percent(self) -> Optional[float]:
        cur = _read_proc_stat()
        if cur is None or self._last is None:
            return None
        total = sum(cur) - sum(self._last)
        idle = (cur[3] + cur[4]) - (self._last[3] + self._last[4])
        self._last, self._last_t = cur, time.monotonic()
        if total <= 0:
            return 0.0
        return round(100.0 * (total - idle) / total, 1)

    def collect(self, worker_pids: List[int]) -> Dict:
        mem = _meminfo()
        try:
            load = os.getloadavg()
        except OSError:
            load = (0.0, 0.0, 0.0)
        return {
            "cpu_percent": self.cpu_percent(),
            "cpus": os.cpu_count(),
            "load_avg": load,
            "mem_total": mem.get("MemTotal"),
            "mem_available": mem.get("MemAvailable"),
            "workers": [w for w in (worker_stats(p) for p in worker_pids) if w],
            "ts": time.time(),
        }


def worker_stats(pid: int) -> Optional[Dict]:
    """RSS + cumulative CPU seconds for one worker from /proc/<pid>."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            parts = f.read().rsplit(") ", 1)[1].split()
        utime, stime = int(parts[11]), int(parts[12])
        rss_pages = int(parts[21])
        return {
            "pid": pid,
            "cpu_seconds": (utime + stime) / _CLK,
            "rss": rss_pages * os.sysconf("SC_PAGE_SIZE"),
        }
    except (OSError, ValueError, IndexError):
        return None
