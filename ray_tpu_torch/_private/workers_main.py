"""Worker process entrypoint (reference: python/ray/_private/workers/default_worker.py).

Spawned by the raylet's worker pool; registers back over RPC and then serves
PushTask / CreateActor / PushActorTask until told to exit or the raylet dies.
"""

from __future__ import annotations

import logging
import os
import sys
import time


def main():
    logging.basicConfig(level=os.environ.get("RAY_TPU_LOG_LEVEL", "WARNING"))
    raylet_addr = (os.environ["RAY_TPU_RAYLET_HOST"], int(os.environ["RAY_TPU_RAYLET_PORT"]))
    gcs_addr = (os.environ["RAY_TPU_GCS_HOST"], int(os.environ["RAY_TPU_GCS_PORT"]))

    from ray_tpu_torch._private.config import RayTpuConfig, set_global_config
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch._private.worker import WORKER, CoreWorker, set_global_worker

    node_id = NodeID(os.environ["RAY_TPU_NODE_ID"])
    worker = CoreWorker(mode=WORKER, raylet_addr=raylet_addr, gcs_addr=gcs_addr, node_id=node_id)
    set_global_worker(worker)

    # native stack dumps (C-level SIGUSR2 handler): a worker wedged inside
    # an XLA dispatch still yields frames to `ray_tpu_torch.util.state
    # .dump_native_stacks` — best-effort, the Python endpoints don't
    # depend on it
    try:
        from ray_tpu_torch._private.native_stack import install as _nsinstall

        _nsinstall()
    except Exception:  # noqa: BLE001 — optional native component; Python paths stand alone
        pass

    # flight-recorder post-mortem dump (crash / exit / SIGUSR2 when the C
    # handler above didn't claim the signal): the <pid>.flight file lands
    # alongside the native stack dump, so a dead worker's last seconds of
    # step phases / collective marks / task transitions stay readable
    try:
        from ray_tpu_torch._private.flight_recorder import install_dump as _frinstall

        _frinstall()
    except Exception:  # noqa: BLE001 — post-mortem dump hooks are best-effort by design
        pass

    # Apply this worker's runtime env BEFORE serving any task (dedicated
    # workers per env; reference: runtime-env agent materializes pre-lease).
    env_hash = os.environ.get("RAY_TPU_RUNTIME_ENV_HASH", "")
    env_json = os.environ.get("RAY_TPU_RUNTIME_ENV")
    if env_json:
        import json

        from ray_tpu_torch._private import runtime_env as renv

        try:
            renv.apply_in_worker(worker.gcs, json.loads(env_json))
        except Exception as e:  # noqa: BLE001
            # Tell the raylet so it fails the waiting leases instead of
            # respawning crashing workers forever (reference:
            # RuntimeEnvSetupError surfaces to the caller).
            try:
                worker.raylet.call(
                    "ReportWorkerEnvFailure",
                    {"env_hash": env_hash, "error": f"{type(e).__name__}: {e}"},
                    timeout=10)
            except Exception:  # noqa: BLE001 — raylet unreachable: the spawn timeout reaps us
                pass
            sys.exit(1)

    from concurrent.futures import TimeoutError as FutTimeout

    from ray_tpu_torch._private.rpc import ConnectionLost

    try:
        # 90 s: a zygote fork-burst (1,000 actors in seconds) can swamp a
        # 1-core raylet's reply queue well past 15 s while it is perfectly
        # alive.  A DEAD raylet surfaces as ConnectionLost immediately
        # (connection refused), so the long timeout never delays orphan
        # prevention.
        reply = worker.raylet.call(
            "RegisterWorker",
            {"worker_id": worker.worker_id, "address": worker.server.address,
             "pid": os.getpid(), "env_hash": env_hash},
            timeout=90, retry_deadline=90)
    except (ConnectionLost, FutTimeout, TimeoutError):
        # raylet died while we were booting: exit NOW instead of retrying
        # into the long default RPC deadline (orphan prevention). Other
        # failures propagate loudly — a healthy raylet rejecting us is a
        # bug that must leave a traceback, not a silent exit 0.
        sys.exit(0)
    set_global_config(RayTpuConfig.from_blob(reply["config_blob"]))
    worker.job_id = None

    # Serve until the raylet goes away (orphan suicide) or we're told to
    # exit.  A slow reply is NOT death (load spikes starve the raylet on
    # small hosts): only consecutive failures trigger suicide.
    misses = 0
    while True:
        time.sleep(2.0)
        try:
            worker.raylet.call("GetNodeStats", None, timeout=30,
                               retry_deadline=30)
            misses = 0
        except Exception:  # noqa: BLE001
            misses += 1
            if misses >= 2:
                sys.exit(0)


if __name__ == "__main__":
    main()
