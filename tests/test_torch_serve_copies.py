"""The port's serve control plane is a copy of the JAX package's.

Each file below equals its original under the rules of
``tests/test_torch_runtime_copies.py`` (the word ``ray_tpu`` renamed to
``ray_tpu_torch``, ``RAY_TPU_*`` variables, config keys and ``ray_tpu_*``
metric names kept, the reference's citations of its own change numbers
dropped), apart from the hunks listed here, each with its reason.  The
port's ``_private/device_telemetry.py`` is its own module: it holds only
the constant and the two functions a serve replica reads, each held to its
original below.
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
        ("the utilization fold reads util/state, which is not ported: the "
         "default headroom source says 'unknown' outright (never shrink) "
         "instead of letting a missing module read as 'no replica "
         "reported'",
         '''def utilization_headroom(deployment: str) -> Optional[float]:
    """Default headroom source: the cluster utilization fold's mean duty
    cycle for the pool, None when no replica has reported."""
    try:
        from ray_tpu_torch.util.state import api as state_api

        fold = state_api.utilization(deployment)
        row = (fold or {}).get(deployment) or {}
        duty = row.get("mean_duty_cycle")
        return float(duty) if duty is not None else None
    except Exception:  # noqa: BLE001 — unknown reads as "never shrink"
        return None''',
         '''def utilization_headroom(deployment: str) -> Optional[float]:
    """Default headroom source: always None (unknown), so the scale-down
    pass never shrinks a pool.  The reference reads the cluster
    utilization fold's mean duty cycle from the state API (util/state),
    which is not ported yet: ROADMAP A16."""
    return None'''),
    ],
}

# the port's device_telemetry.py: names copied from the original's
TELEMETRY_NAMES = ["UTIL_KV_PREFIX", "enabled", "util_kv_key"]


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
    assert set(HUNKS) <= set(COPIES)
    assert len(COPIES) == len(set(COPIES))
    # every module of the reference's serve package is copied
    want = sorted(str(p.relative_to(ROOT / "ray_tpu"))
                  for p in (ROOT / "ray_tpu" / "serve").rglob("*.py"))
    assert sorted(COPIES) == want


def _top_level(path: pathlib.Path) -> dict:
    """Top-level name -> its source text, for functions and assignments."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.get_source_segment(text, node)
    return out


@pytest.mark.parametrize(
    "rel", COPIES + [f"_private/device_telemetry.py:{n}"
                     for n in TELEMETRY_NAMES])
def test_port_file_is_a_copy(rel):
    if ":" in rel:
        rel, name = rel.split(":")
        want = _top_level(ROOT / "ray_tpu" / rel)[name]
        got = _top_level(ROOT / "ray_tpu_torch" / rel).get(name)
        assert got == renamed(want), (
            f"ray_tpu_torch/{rel}:{name} drifted from its original")
        return
    assert all(reason.strip() for reason, _, _ in HUNKS.get(rel, ()))
    got = (ROOT / "ray_tpu_torch" / rel).read_text()
    assert got == expected(rel), (
        f"ray_tpu_torch/{rel} drifted from ray_tpu/{rel} beyond its listed "
        f"hunks")
