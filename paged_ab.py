"""Times the paged decode kernel of this checkout against another
checkout's, in turns on one card: chip_smoke.py's phase 3
(``phase_kernel``: three decode shapes, kernel vs plain, controls, times
by CUDA-graph replay) in a fresh process per run, each process importing
its checkout's ``ray_tpu_torch``.

    python3 paged_ab.py OTHER_CHECKOUT [PAIRS]

Runs other, this, this, other, PAIRS / 2 times over (PAIRS: 2), prints
each run's phase 3 lines, and last one JSON line with every run's
results by checkout.  Imports torch and ray_tpu_torch only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def child() -> None:
    """One run of phase 3 on the ray_tpu_torch first on PYTHONPATH."""
    if os.path.abspath(sys.path[0] or ".") == HERE:  # the script's own
        del sys.path[0]  # directory: PYTHONPATH's checkout comes first
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import paged_attention as pa

    if not hasattr(pa, "split_plan"):  # a kernel without splits
        pa.split_plan = lambda *shape: (2 ** 30, 1)
    print(f"ray_tpu_torch from {os.path.dirname(pa.__file__)}", flush=True)
    cfg = llama.LlamaConfig.llama3_8b(param_dtype=torch.bfloat16,
                                      compute_dtype=torch.bfloat16)
    with torch.no_grad():
        results = smoke.phase_kernel(pa, cfg, torch.device("cuda"))
    print("RESULT " + json.dumps(results), flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child()
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    runs = {other: [], HERE: []}
    for _ in range(max(1, pairs // 2)):
        for tree in (other, HERE, HERE, other):
            env = dict(os.environ, PYTHONPATH=tree)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child"],
                env=env, capture_output=True, text=True)
            print(f"=== {tree}", flush=True)
            print(proc.stdout, end="", flush=True)
            if proc.returncode:
                print(proc.stderr, file=sys.stderr)
                return proc.returncode
            line = next(ln for ln in proc.stdout.splitlines()
                        if ln.startswith("RESULT "))
            runs[tree].append(json.loads(line[len("RESULT "):]))
    print(json.dumps({"other": runs[other], "this": runs[HERE]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
