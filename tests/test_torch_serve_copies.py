"""The port's serve control plane is a copy of the JAX package's.

Each file below equals its original under the rules of
``tests/test_torch_runtime_copies.py`` (the word ``ray_tpu`` renamed to
``ray_tpu_torch``, ``RAY_TPU_*`` variables, config keys and ``ray_tpu_*``
metric names kept, the reference's citations of its own change numbers
dropped), apart from the hunks listed here, each with its reason.  So do
the state API, the timeline and the goodput ledger (``STATE_COPIES``).
The port's ``_private/device_telemetry.py`` is its own module (the CUDA
twin: HBM rows from the CUDA allocator, captures as compiles, the H100's
peak): each name it copies is held to its original below, with its
hunks.
"""

import ast
import pathlib

import pytest

from test_torch_runtime_copies import renamed

ROOT = pathlib.Path(__file__).resolve().parents[1]

COPIES = [
    "serve/_private/slo.py", "serve/_private/admission.py",
    "serve/batching.py", "serve/multiplex.py", "serve/handle.py",
    "serve/_private/local_testing.py", "serve/_private/replica.py",
    "serve/_private/pool_autoscaler.py", "serve/_private/kv_migration.py",
    "serve/_private/controller.py", "serve/_private/proxy.py",
    "serve/_private/rpc_proxy.py", "serve/_private/ingress.py",
    "serve/asgi.py", "serve/api.py", "serve/__init__.py",
]

# the state API and what it reads, copied whole
STATE_COPIES = [
    "train/_internal/goodput.py", "util/state/api.py",
    "util/state/__init__.py", "_private/timeline.py",
]

_TORCH_PROFILE = ("the port's worker captures a torch.profiler Chrome trace "
                  "(AgentTorchProfile, which names the CUDA kernels) where "
                  "the reference captures a JAX XPlane trace")

# file -> [(reason, old, new)]: ``old`` is a unique span of the renamed
# original, ``new`` what the port has in its place
HUNKS = {
    "serve/_private/controller.py": [
        ("a tensor's plain pickle names its storage's address, so two "
         "deploys of the same bound tensors (weights) hashed differently "
         "and a scale-only redeploy restarted every replica; the runtime's "
         "pickler writes a tensor's bytes",
         '''    import hashlib
    import pickle

    blob''',
         '''    import hashlib

    from ray_tpu_torch._private.serialization import _dumps

    blob'''),
        ("(as above)",
         '''    return hashlib.sha1(pickle.dumps(key)).hexdigest()''',
         '''    return hashlib.sha1(_dumps(key)).hexdigest()'''),
    ],
    "serve/_private/pool_autoscaler.py": [
        ("the reference reads the pool's row at the fold's top level, where "
         "state.utilization() never puts it (its rows are under "
         "'deployments'), so its default headroom source always says "
         "unknown and no pool ever shrinks; the port reads the row where "
         "the fold puts it",
         '''        row = (fold or {}).get(deployment) or {}''',
         '''        row = ((fold or {}).get("deployments") or {}).get(deployment) or {}'''),
    ],
    "util/state/api.py": [
        (_TORCH_PROFILE,
         '''        """On-demand profiler capture of one worker (device telemetry):
        a jax.profiler XPlane trace where the target's backend supports
        it, else''',
         '''        """On-demand profiler capture of one worker (device telemetry):
        a torch.profiler Chrome trace (CPU, and CUDA kernels where the
        worker has a CUDA context), else'''),
        ("the reference's docstring cites its own change number",
         "over the worker RPC thread, like PR 6's FlightRecorderTail).",
         "over the worker RPC thread, like the flight recorder's tail)."),
        (_TORCH_PROFILE,
         '''        if mode not in ("auto", "jax", "cpu"):
            raise ValueError(f"mode must be auto|jax|cpu (got {mode!r})")
        result: dict = {"pid": pid, "mode": None, "artifact": None}
        if mode in ("auto", "jax"):
            try:
                rep = self.jax_profile(pid, node_id=node_id,
                                       duration_s=duration_s)
                files = rep.get("files") or []
                if files or mode == "jax":
                    result["mode"] = "jax"''',
         '''        if mode not in ("auto", "torch", "cpu"):
            raise ValueError(f"mode must be auto|torch|cpu (got {mode!r})")
        result: dict = {"pid": pid, "mode": None, "artifact": None}
        if mode in ("auto", "torch"):
            try:
                rep = self.torch_profile(pid, node_id=node_id,
                                         duration_s=duration_s)
                files = rep.get("files") or []
                if files or mode == "torch":
                    result["mode"] = "torch"'''),
        (_TORCH_PROFILE,
         '''            except Exception:  # noqa: BLE001 — fall back to sampling
                if mode == "jax":
                    raise''',
         '''            except Exception:  # noqa: BLE001 — fall back to sampling
                if mode == "torch":
                    raise'''),
        (_TORCH_PROFILE,
         '''    def jax_profile(self, pid: int, node_id=None, duration_s: float = 3.0,
                    logdir: Optional[str] = None) -> dict:
        """Capture a JAX profiler (XPlane) trace on one worker; open the
        returned logdir with TensorBoard/xprof (SURVEY §5: the TPU analog of
        the reference's GPU profiler plugins)."""
        return self._agent_call_by_pid(
            "AgentJaxProfile",''',
         '''    def torch_profile(self, pid: int, node_id=None,
                      duration_s: float = 3.0,
                      logdir: Optional[str] = None) -> dict:
        """Capture a torch.profiler Chrome trace on one worker (CPU ops,
        and the CUDA kernels where it has a CUDA context); open the
        returned trace.json with Perfetto or chrome://tracing."""
        return self._agent_call_by_pid(
            "AgentTorchProfile",'''),
        (_TORCH_PROFILE,
         '''def jax_profile(pid, node_id=None, duration_s: float = 3.0, logdir=None):
    return _client().jax_profile(pid, node_id, duration_s, logdir)''',
         '''def torch_profile(pid, node_id=None, duration_s: float = 3.0,
                  logdir=None):
    return _client().torch_profile(pid, node_id, duration_s, logdir)'''),
    ],
    "util/state/__init__.py": [
        (_TORCH_PROFILE, "    jax_profile,\n", "    torch_profile,\n"),
        (_TORCH_PROFILE, '''    "jax_profile",''', '''    "torch_profile",'''),
    ],
}

# the port's device_telemetry.py: names copied from the original's, and
# the hunks of each (name -> [(reason, old, new)])
TELEMETRY_NAMES = [
    "UTIL_KV_PREFIX", "enabled", "record_hbm", "device_used_bytes",
    "_UNATTRIBUTED", "_MAX_PROGRAMS", "_MAX_EVENTS", "_CompileWatch",
    "_watch", "note_trace", "trace_count", "storm_report",
    "compile_snapshot", "_hb_thread", "_hb_lock", "_hb_last_stamp",
    "_default_heartbeat_push", "_heartbeat_push", "_heartbeat_stamp",
    "_start_heartbeat", "EngineTelemetry", "engine_telemetry_for",
    "_providers", "_providers_lock", "register_utilization_provider",
    "unregister_utilization_provider", "register_utilization_object",
    "local_utilization_rows", "fold_utilization_rows", "local_utilization",
    "util_kv_key", "note_serving_rate",
]
_CAPTURES = ("the port's compile is a CUDA-graph capture, and its capture "
             "sites report themselves: there is no jax.monitoring feed")
TELEMETRY_HUNKS = {
    "_CompileWatch": [(_CAPTURES, '''    Two feeds: ``note_trace(program)`` from instrumented call sites — it
    executes inside the traced Python function, i.e. only on a cache
    miss, so each call marks an imminent compile and names it — and the
    ``jax.monitoring`` backend-compile duration events, attributed to the
    calling thread's most recent traced program.  Trace counts back the
    ``compile_count()`` APIs (rllib/env_runner.py); backend events back
    the ``ray_tpu_jit_compiles_total`` / ``_seconds_total`` families.''',
                       '''    Two feeds, both from the capture sites: ``note_trace(program)``
    right before a CUDA-graph capture (each call marks an imminent
    capture and names it) and ``note_compile(program, seconds)`` right
    after it.  Trace counts back ``trace_count``; captures back the
    ``ray_tpu_jit_compiles_total`` / ``_seconds_total`` families.''')],
    "note_trace": [(_CAPTURES, '''    """Mark a retrace of ``program`` (call INSIDE the jitted Python
    function: the body only runs on a cache miss, so each call is an
    imminent compile).  Always books into the watch — ``compile_count()``
    APIs must work even with the metric layer disabled — and installs the
    jax.monitoring listener on first use."""''',
                    '''    """Mark an imminent capture of ``program`` (call right before a
    CUDA-graph capture, the port's compile).  Always books into the watch
    — ``trace_count`` must work even with the metric layer disabled — and
    starts the heartbeat on first use."""''')],
    "EngineTelemetry": [("the port's HBM rows read the CUDA allocator's "
                         "stats, never a walk over live arrays",
                         '''the HBM split flushes on
    a 10x slower cadence (it may walk ``jax.live_arrays()`` on CPU
    hosts).''', '''the HBM split flushes on
    a 10x slower cadence (it reads the CUDA allocator's stats and the
    card's total).''')],
}


def expected(rel: str) -> str:
    """The port's file as the reference and the hunks make it."""
    text = renamed((ROOT / "ray_tpu" / rel).read_text())
    for reason, old, new in HUNKS.get(rel, ()):
        n = text.count(old)
        if n != 1:
            raise AssertionError(
                f"{rel}: a hunk's old text occurs {n} times in the renamed "
                f"original (want once): {reason}")
        text = text.replace(old, new)
    return text


def test_hunks_belong_to_copies():
    assert set(HUNKS) <= set(COPIES + STATE_COPIES)
    assert len(COPIES) == len(set(COPIES))
    assert set(TELEMETRY_HUNKS) <= set(TELEMETRY_NAMES)
    # every module of the reference's serve package is copied
    want = sorted(str(p.relative_to(ROOT / "ray_tpu"))
                  for p in (ROOT / "ray_tpu" / "serve").rglob("*.py"))
    assert sorted(COPIES) == want


def _top_level(path: pathlib.Path) -> dict:
    """Top-level name -> its source text, for functions, classes and
    assignments."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.get_source_segment(text, node)
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)):
            out[node.target.id] = ast.get_source_segment(text, node)
    return out


def expected_name(name: str) -> str:
    """A copied device_telemetry name as the original and its hunks make
    it."""
    text = renamed(_top_level(
        ROOT / "ray_tpu" / "_private" / "device_telemetry.py")[name])
    for reason, old, new in TELEMETRY_HUNKS.get(name, ()):
        assert reason.strip() and text.count(old) == 1, (name, reason)
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize(
    "rel", COPIES + STATE_COPIES + [f"_private/device_telemetry.py:{n}"
                                    for n in TELEMETRY_NAMES])
def test_port_file_is_a_copy(rel):
    if ":" in rel:
        rel, name = rel.split(":")
        got = _top_level(ROOT / "ray_tpu_torch" / rel).get(name)
        assert got == expected_name(name), (
            f"ray_tpu_torch/{rel}:{name} drifted from its original")
        return
    assert all(reason.strip() for reason, _, _ in HUNKS.get(rel, ()))
    got = (ROOT / "ray_tpu_torch" / rel).read_text()
    assert got == expected(rel), (
        f"ray_tpu_torch/{rel} drifted from ray_tpu/{rel} beyond its listed "
        f"hunks")
