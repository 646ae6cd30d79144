"""Per-node worker-log tailer (reference: python/ray/_private/log_monitor.py).

The raylet redirects each worker's stdout+stderr into a per-worker file under
a node-local log dir, and one LogMonitor thread tails every file, publishing
new lines to the GCS "WORKER_LOGS" pubsub channel tagged with the job the
worker is currently leased to.  Drivers subscribe
(``ray_tpu_torch.init(log_to_driver=True)``, the default) and echo their own job's
lines as ``(pid=..., ip=...) line`` the way the reference's driver does.

Set RAY_TPU_WORKER_QUIET=1 on the raylet to keep logs file-only (tests and
benchmark harnesses); files are written either way.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class LogMonitor:
    def __init__(self, gcs_client, node_ip: str, node_id_hex: str,
                 poll_interval_s: float = 0.3):
        self._gcs = gcs_client
        self._ip = node_ip
        self._quiet = bool(os.environ.get("RAY_TPU_WORKER_QUIET"))
        self.log_dir = tempfile.mkdtemp(prefix=f"ray_tpu_logs_{node_id_hex[:8]}_")
        self._poll_interval_s = poll_interval_s
        self._counter = 0
        self._offsets: Dict[str, int] = {}   # path -> bytes consumed
        self._partial: Dict[str, bytes] = {}  # path -> trailing unterminated chunk
        self._pids: Dict[str, Optional[int]] = {}
        self._paths: Dict[int, str] = {}  # pid -> path (reverse of _pids)
        self._jobs: Dict[int, str] = {}  # pid -> job id hex of current lease
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="raylet-log-monitor")
        self._thread.start()

    def new_log_file(self) -> str:
        with self._lock:
            self._counter += 1
            path = os.path.join(self.log_dir, f"worker-{self._counter:05d}.log")
        self._pids[path] = None
        return path

    def register_pid(self, path: str, pid: int):
        self._pids[path] = pid
        self._paths[pid] = path

    def set_job(self, pid: int, job_hex: str):
        """Tag a worker with the job it is currently leased to, so drivers
        can filter the echo stream to their own job's output.  When a worker
        is reused by a DIFFERENT job, drain its file first so buffered lines
        keep the job that actually produced them."""
        if self._jobs.get(pid) not in (None, job_hex):
            path = self._paths.get(pid)
            if path is not None:
                try:
                    self._drain_file(path, pid)
                except Exception:  # noqa: BLE001 — drain is best-effort;
                    pass            # the tail resumes under the new job
        self._jobs[pid] = job_hex

    def stop(self):
        self._stopped.set()
        # final drain, then drop the node-local tmp dir on clean shutdown
        try:
            self._quiet or self._poll_once()
        except Exception:  # noqa: BLE001 — final drain on a dying
            pass            # monitor; nothing left to tell
        import shutil

        shutil.rmtree(self.log_dir, ignore_errors=True)

    # ------------------------------------------------------------------

    def _loop(self):
        while not self._stopped.wait(self._poll_interval_s):
            try:
                self._poll_once()
            except Exception:  # noqa: BLE001 — a bad file must not kill the tailer
                pass

    def _poll_once(self):
        if self._quiet:
            return
        for path, pid in list(self._pids.items()):
            try:
                size = os.path.getsize(path)
            except OSError:
                self._forget(path, pid)  # file vanished
                continue
            offset = self._offsets.get(path, 0)
            if size <= offset:
                if pid is not None and not _pid_alive(pid):
                    self._forget(path, pid)  # fully drained and worker exited
                continue
            self._drain_file(path, pid, size=size)

    def _drain_file(self, path: str, pid, size: Optional[int] = None):
        """Publish every complete new line in ``path`` (thread-safe: called
        from the poll loop and from set_job on worker reuse)."""
        with self._lock:
            if size is None:
                try:
                    size = os.path.getsize(path)
                except OSError:
                    return
            offset = self._offsets.get(path, 0)
            if size <= offset:
                return
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(size - offset)
            self._offsets[path] = size
            data = self._partial.pop(path, b"") + data
            lines = data.split(b"\n")
            if lines and lines[-1]:
                self._partial[path] = lines[-1]
            lines = lines[:-1]
            text = [ln.decode("utf-8", "replace") for ln in lines if ln.strip()]
            job = self._jobs.get(pid)
        if not text:
            return
        try:
            self._gcs.notify("Publish", {
                "channel": "WORKER_LOGS",
                "message": {"ip": self._ip, "pid": pid, "job": job,
                            "lines": text},
            })
        except Exception:  # noqa: BLE001 — this batch of lines is dropped;
            # the tailer keeps running and the next poll publishes fresh
            # ones.  Debug, not warning: a GCS outage would otherwise log
            # once per poll tick per worker file.
            logger.debug("worker-log publish failed (pid=%s); dropping %d "
                         "line(s) this tick", pid, len(text))

    def _forget(self, path: str, pid):
        """Stop tracking an exited worker's log (the file stays on disk
        until shutdown removes the dir)."""
        self._pids.pop(path, None)
        self._offsets.pop(path, None)
        self._partial.pop(path, None)
        if pid is not None:
            self._jobs.pop(pid, None)
            self._paths.pop(pid, None)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True
