"""The port's data context and logical plan are copies of the JAX
package's ``data/context.py`` and ``data/_internal/plan.py``.

Each file below equals its original under the rules of
``tests/test_torch_runtime_copies.py`` (the word ``ray_tpu`` renamed to
``ray_tpu_torch``, the reference's citations of its own change numbers
dropped), apart from the hunks listed here, each with its reason.  The
rest of ``ray_tpu_torch/data/`` is the port's own: its blocks are numpy
columns where the reference's are Arrow tables (``tests/test_torch_data.py``
holds it to the reference's behaviour).
"""

import pathlib

import pytest

from test_torch_runtime_copies import renamed

ROOT = pathlib.Path(__file__).resolve().parents[1]

COPIES = ["data/context.py", "data/_internal/plan.py"]

# file -> [(reason, old, new)]: ``old`` is a unique span of the renamed
# original, ``new`` what the port has in its place
HUNKS = {
    "data/context.py": [
        ("the device buffer depth means the CUDA double buffer of iter_device_batches (pinned staging ring, side-stream copies), the counterpart of iter_jax_batches' device_put",
         '''    # device-side double buffer depth for iter_jax_batches: batch N+1's
    # device_put overlaps the caller's step on batch N (2 = classic double
    # buffering; 0 disables the prefetch thread entirely)
''',
         '''    # device-side double buffer depth for iter_device_batches: batch N+1's
    # host-to-device copy (a pinned staging ring, a side stream) overlaps
    # the caller's step on batch N (2 = classic double buffering; 0
    # disables the prefetch thread entirely)
'''),
    ],
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
    assert set(HUNKS) <= set(COPIES)
    assert len(COPIES) == len(set(COPIES))


@pytest.mark.parametrize("rel", COPIES)
def test_port_file_is_a_copy(rel):
    assert all(reason.strip() for reason, _, _ in HUNKS.get(rel, ()))
    got = (ROOT / "ray_tpu_torch" / rel).read_text()
    assert got == expected(rel), (
        f"ray_tpu_torch/{rel} drifted from ray_tpu/{rel} beyond its listed "
        f"hunks")
