"""The port stands alone: ``ray_tpu_torch``, ``chip_smoke.py`` and
``paged_ab.py`` import
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
                                                      ROOT / "paged_ab.py"]
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
            "ray_tpu_torch.train._internal.snapshot; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu')); "
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
