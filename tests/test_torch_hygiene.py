"""The port stands alone: ``ray_tpu_torch``, ``chip_smoke.py``,
``paged_ab.py`` and ``gmm_ab.py`` import
neither JAX nor anything of ``ray_tpu``, and every kernel PERF.md calls
ported has its CUDA source in the package."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    p for p in (ROOT / "ray_tpu_torch").rglob("*.py")
    if "_build" not in p.relative_to(ROOT).parts) + [ROOT / "chip_smoke.py",
                                                      ROOT / "paged_ab.py",
                                                      ROOT / "gmm_ab.py"]
FORBIDDEN = {"jax", "jaxlib", "ray_tpu"}


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}:{node.lineno}: relative import"
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_port_sources_import_no_jax_and_nothing_of_ray_tpu():
    assert len(PORT_FILES) > 10
    bad = [f"{p.relative_to(ROOT)}:{line}: {name}"
           for p in PORT_FILES for line, name in _imported(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_engine_loads_no_jax():
    code = ("import sys, ray_tpu_torch.llm.paged, ray_tpu_torch.convert, "
            "ray_tpu_torch.ops, ray_tpu_torch.parallel, "
            "ray_tpu_torch.ops.attention, ray_tpu_torch.ops.flash_attention, "
            "ray_tpu_torch.models.moe, ray_tpu_torch.ops.grouped_matmul, "
            "ray_tpu_torch.parallel.optim, "
            "ray_tpu_torch.util.collective.compression, "
            "ray_tpu_torch.train._internal.snapshot, "
            "ray_tpu_torch._private.worker, ray_tpu_torch._private.raylet, "
            "ray_tpu_torch._private.gcs, ray_tpu_torch._private.zygote, "
            "ray_tpu_torch._private.workers_main, ray_tpu_torch._native, "
            "ray_tpu_torch._private.node, ray_tpu_torch._private.log_monitor, "
            "ray_tpu_torch._private.runtime_env, "
            "ray_tpu_torch._private.external_storage, "
            "ray_tpu_torch._private.native_stack, "
            "ray_tpu_torch._private.metrics_history, "
            "ray_tpu_torch._private.latency_sketch, "
            "ray_tpu_torch.dashboard.agent, ray_tpu_torch.cluster_utils, "
            "ray_tpu_torch.runtime_context, ray_tpu_torch.util.rpdb, "
            "ray_tpu_torch.serve, ray_tpu_torch.llm, "
            "ray_tpu_torch.util.collective, "
            "ray_tpu_torch.util.collective.collective_group.nccl_group, "
            "ray_tpu_torch.util.collective.collective_group.store_group, "
            "ray_tpu_torch.experimental.channel, "
            "ray_tpu_torch.experimental.device_objects, "
            "ray_tpu_torch.parallel.bucketing, "
            "ray_tpu_torch.util.state, ray_tpu_torch._private.timeline, "
            "ray_tpu_torch.train._internal.goodput, "
            "ray_tpu_torch.train, ray_tpu_torch.train.v2, "
            "ray_tpu_torch.train.collective, ray_tpu_torch.train.backend, "
            "ray_tpu_torch._private.device_telemetry, "
            "ray_tpu_torch.data, ray_tpu_torch.data._internal.ingest, "
            "ray_tpu_torch.data._internal.streaming_executor, "
            "ray_tpu_torch.llm.batch; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=50)
    assert res.returncode == 0, res.stdout + res.stderr


def _module_scope_imports(path: pathlib.Path):
    """Imports in a module's own body (not inside a def or a class)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo.extend(getattr(node, field, []))
        elif isinstance(node, ast.ExceptHandler):
            todo.extend(node.body)


def test_no_module_of_the_port_imports_pyarrow_or_pandas_at_import():
    """The card's machine has neither: the data layer's blocks are numpy,
    and Arrow or pandas is imported inside the calls that need it."""
    bad = [f"{p.relative_to(ROOT)}:{line}: {name}"
           for p in PORT_FILES for line, name in _module_scope_imports(p)
           if name.split(".")[0] in ("pyarrow", "pandas")]
    assert not bad, bad
    code = ("import sys, ray_tpu_torch.data, ray_tpu_torch.llm, "
            "ray_tpu_torch.train, ray_tpu_torch.data._internal.ingest; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('pyarrow', 'pandas')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=50)
    assert res.returncode == 0, res.stdout + res.stderr


def test_ported_kernels_have_their_cuda_source():
    rows = [line for line in (ROOT / "PERF.md").read_text().splitlines()
            if line.startswith("|") and "ported, PR" in line]
    assert rows, "PERF.md lists no ported kernel"
    for row in rows:
        srcs = re.findall(r"ray_tpu_torch/\S+?\.cu", row)
        assert srcs, f"ported row names no .cu source: {row}"
        for src in srcs:
            assert (ROOT / src).is_file(), src


def test_the_serve_control_plane_loads_no_torch():
    """The controller, the proxies and the replica host import no torch
    and no serving class at module scope: the controller's process would
    otherwise pay the torch import for nothing."""
    code = ("import sys, ray_tpu_torch.serve, "
            "ray_tpu_torch.serve._private.controller, "
            "ray_tpu_torch.serve._private.replica, "
            "ray_tpu_torch.serve._private.proxy, "
            "ray_tpu_torch.serve._private.rpc_proxy, "
            "ray_tpu_torch.serve._private.ingress, "
            "ray_tpu_torch.serve._private.kv_migration, "
            "ray_tpu_torch._private.device_telemetry; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu') or m.startswith('ray_tpu_torch.llm')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=50)
    assert res.returncode == 0, res.stdout + res.stderr
