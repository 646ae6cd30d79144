"""The port's collective and channel modules that are copies of the JAX
package's.

Each file below equals its original under the rules of
``tests/test_torch_runtime_copies.py`` (the word ``ray_tpu`` renamed to
``ray_tpu_torch``, ``RAY_TPU_*`` variables, config keys and ``ray_tpu_*``
metric names kept, the reference's citations of its own change numbers
dropped), apart from the hunks listed here, each with its reason.  The
port's ``util/collective/compression.py`` is its own module around the
numpy side it copies: each copied name is held to its original below.
``collective_group/nccl_group.py`` (the twin of ``xla_group.py``),
``collective.py``, ``parallel/bucketing.py``, ``accelerator_context.py``,
``cuda_tensor_channel.py`` (the twin of ``xla_tensor_channel.py``) and
``experimental/device_objects.py`` are ports, held by
``tests/test_torch_collective.py`` and ``tests/test_torch_channel.py``.
"""

import ast
import pathlib
import re

import pytest

from test_torch_runtime_copies import renamed as _renamed

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's citations of its own change numbers in forms the shared
# rule does not catch; these copies drop them too
_MORE_CITATIONS = [(re.compile(r" \(satellite of ISSUE \d+\)"), ""),
                   (re.compile(r"\bPR-\d+ "), ""),
                   (re.compile(r"\bPR \d+'s "), "the ")]


def renamed(text: str) -> str:
    text = _renamed(text)
    for pattern, repl in _MORE_CITATIONS:
        text = pattern.sub(repl, text)
    return text

COPIES = [
    "util/collective/types.py", "util/collective/planner.py",
    "util/collective/store.py",
    "util/collective/collective_group/base_group.py",
    "util/collective/collective_group/store_group.py",
    "experimental/channel/shared_memory_channel.py",
    "experimental/channel/communicator.py",
]

# the numpy side of compression.py the port copies, by top-level name
COMPRESSION_NAMES = [
    "ALG_FLAT", "ALG_HIERARCHICAL", "ALG_RING", "ALG_TREE",
    "CompressionSpec", "resolve_spec", "Plan", "_STOCK_PLAN", "choose_plan",
    "is_float_dtype", "estimate_wire_bytes", "dtype_from_name",
    "pad_to_multiple", "quantize_blocks", "dequantize_blocks", "wire_nbytes",
    "relative_error", "ErrorFeedbackStore", "error_feedback", "ef_quantize",
    "OpStats",
]

# file -> [(reason, old, new)]: ``old`` is a unique span of the renamed
# original, ``new`` what the port has in its place
HUNKS = {
    "util/collective/types.py": [
        ("the port's device backend is NCCL over torch.distributed: 'nccl' "
         "names it, the host-side names map onto the store backend as in "
         "the reference, and the JAX package's 'xla' refuses naming 'nccl'",
         '''class Backend:
    """Backend name constants (reference: collective.py:81-96 dispatch).

    The reference dispatches MPI/GLOO/NCCL/TORCH_GLOO; the TPU-native set is:

    - ``XLA``: jax.distributed process groups; data rides ICI/DCN via XLA
      collectives over a one-axis device mesh (the NCCL analog).
    - ``STORE``: named-store-actor rendezvous + object-store data plane —
      control-plane collectives that work anywhere (the gloo analog).
    """

    XLA = "xla"
    STORE = "store"

    @staticmethod
    def validate(name: str) -> str:
        name = str(name).lower()
        if name in ("nccl", "gloo", "torch_gloo", "mpi"):
            # GPU-era names map onto the TPU-native equivalents so reference
            # user code ports unchanged.
            return Backend.XLA if name == "nccl" else Backend.STORE
        if name not in (Backend.XLA, Backend.STORE):
            raise ValueError(f"unknown collective backend {name!r}")
        return name''',
         '''class Backend:
    """Backend name constants (reference: collective.py:81-96 dispatch).

    - ``NCCL``: a ``torch.distributed`` process group per named group (a
      TCPStore rendezvous published through the store actor); CUDA tensors
      ride NCCL, CPU tensors gloo (the twin of the JAX package's ``XLA``).
    - ``STORE``: named-store-actor rendezvous + object-store data plane —
      control-plane collectives that work anywhere (the gloo analog).
    """

    NCCL = "nccl"
    STORE = "store"

    @staticmethod
    def validate(name: str) -> str:
        name = str(name).lower()
        if name in ("gloo", "torch_gloo", "mpi"):
            # the reference's host-side names map onto the store backend,
            # as in the JAX package, so its user code ports unchanged
            return Backend.STORE
        if name == "xla":
            raise ValueError(
                "collective backend 'xla' is the JAX package's; the port's "
                "device backend is 'nccl'")
        if name not in (Backend.NCCL, Backend.STORE):
            raise ValueError(f"unknown collective backend {name!r}")
        return name'''),
    ],
    "util/collective/planner.py": [
        ("the docstring: what the copy is, without the reference's history; "
         "the port's backends and its intra-node link class",
         '''"""Topology-aware collective planner (TACCL-flavored, arxiv 2111.04867).

shipped a two-way ``choose_plan`` branch (flat vs a fixed
intra→inter→intra hierarchy) with a sqrt-divisor slice guess.  This module
replaces it with a real planner over an explicit topology descriptor:

- :class:`Topology` records the per-rank latency-domain (TPU slice / host)
  ids and the link classes + calibrated α-β figures of the intra- and
  inter-domain links.  Backends build it from real metadata (device
  ``slice_index`` in ``XLAGroup``, group-member node identity in
  ``StoreGroup``) and refine''',
         '''"""Topology-aware collective planner (TACCL-flavored, arxiv 2111.04867),
a copy of the JAX package's over an explicit topology descriptor:

- :class:`Topology` records the per-rank latency-domain (host) ids and the
  link classes + α-β figures of the intra- and inter-domain links.
  Backends build it from real metadata (group-member node identity in
  ``NCCLGroup`` and ``StoreGroup``; the intra-node class of a group of
  cards is their NVLink/IPC link) and refine'''),
        ("(as above: the reference's history)",
         '''"ICI" phase over DCN — the exact failure mode of the old sqrt fallback.''',
         '''"intra" phase over DCN.'''),
        ("the intra-node class of the port's cards: NVLink between cards, "
         "CUDA IPC between two processes on one card",
         '''# link classes, fastest to slowest
LINK_ICI = "ici"    # intra-slice TPU interconnect
''',
         '''# link classes, fastest to slowest
LINK_NVLINK = "nvlink"  # cards of one host: NVLink, or CUDA IPC on one card
LINK_ICI = "ici"    # intra-slice TPU interconnect
'''),
        ("the priors are coarse ratios, not measurements of any card; "
         "NVLink takes ICI's, so plans match the reference's on equal "
         "topologies",
         '''# default α (per-message-step latency, seconds) and β⁻¹ (bandwidth,
# bytes/s) seeds per link class — deliberately coarse priors; the per-group
# probe replaces the bandwidth with a measured figure.  Ratios are what
# matter: ICI is ~10x DCN bandwidth at ~10x lower launch latency, and the
# store relay pays an actor round trip per step.
DEFAULT_ALPHA = {LINK_ICI: 1e-6, LINK_DCN: 2.5e-5, LINK_HOST: 4e-4}
DEFAULT_BANDWIDTH = {LINK_ICI: 4.0e10, LINK_DCN: 3.0e9, LINK_HOST: 1.0e9}''',
         '''# default α (per-message-step latency, seconds) and β⁻¹ (bandwidth,
# bytes/s) seeds per link class — deliberately coarse priors: ratios, not
# measurements of any card or network (none was taken for them); the
# per-group probe replaces the bandwidth with a measured figure.  Ratios
# are what matter: the fast intra-node link is ~10x DCN bandwidth at ~10x
# lower launch latency, and the store relay pays an actor round trip per
# step.  NVLink takes ICI's priors.
DEFAULT_ALPHA = {LINK_NVLINK: 1e-6, LINK_ICI: 1e-6, LINK_DCN: 2.5e-5,
                 LINK_HOST: 4e-4}
DEFAULT_BANDWIDTH = {LINK_NVLINK: 4.0e10, LINK_ICI: 4.0e10, LINK_DCN: 3.0e9,
                     LINK_HOST: 1.0e9}'''),
        ("topology_for_devices takes torch devices: the cards one process "
         "sees share a host, and CUDA members cross NVLink",
         '''    """Topology for an in-program device group — e.g. one mesh axis of a
    tensor-parallel serving engine.  Latency domains come from each
    device's ``slice_index`` (TPU multislice) falling back to
    ``process_index``; the intra link defaults to ICI when every member is
    a TPU and host loopback otherwise (CPU test meshes), so the α-β model
    prices decode's small latency-bound collectives on the link class
    they actually cross."""
    devs = list(devices)
    if intra_link is None:
        intra_link = (LINK_ICI if devs and all(
            getattr(d, "platform", "") == "tpu" for d in devs)
            else LINK_HOST)
    sids = []
    for d in devs:
        sid = getattr(d, "slice_index", None)
        if sid is None:
            sid = getattr(d, "process_index", 0)
        sids.append(sid)''',
         '''    """Topology for a group of torch devices (``torch.device`` or their
    names) — e.g. the cards of one tensor-parallel serving engine.  One
    process sees the cards of one host, so they form one latency domain;
    the intra link is NVLink when every member is a CUDA device and host
    loopback otherwise (CPU tests), so the α-β model prices decode's small
    latency-bound collectives on the link class they actually cross."""
    import torch

    devs = [torch.device(d) for d in devices]
    if intra_link is None:
        intra_link = (LINK_NVLINK if devs and all(
            d.type == "cuda" for d in devs) else LINK_HOST)
    sids = [0] * len(devs)'''),
    ],
    "util/collective/collective_group/store_group.py": [
        ("torch tensors go in and come out: numpy stays inside",
         "import numpy as np\n",
         "import numpy as np\nimport torch\n"),
        ("a torch tensor goes to the host as numpy (a bf16 one as fp32, "
         "exactly: numpy has no bf16, so a bf16 reduction sums in fp32 and "
         "rounds once) and its result comes back in its dtype, on its "
         "device; a sent tensor carries its dtype and device; the JAX "
         "branches go",
         '''def _to_numpy(tensor):
    """numpy view of a tensor + a converter back to the original kind."""
    if isinstance(tensor, np.ndarray):
        return tensor, lambda a: a
    mod = type(tensor).__module__
    if mod.startswith("jax") or "ArrayImpl" in type(tensor).__name__:
        import jax.numpy as jnp

        return np.asarray(tensor), lambda a: jnp.asarray(a)
    if mod.startswith("torch"):
        return tensor.detach().cpu().numpy(), None  # converter built lazily below
    return np.asarray(tensor), lambda a: a


def _convert_back(result_np, original):
    if isinstance(original, np.ndarray):
        return result_np
    mod = type(original).__module__
    if mod.startswith("jax") or "ArrayImpl" in type(original).__name__:
        import jax.numpy as jnp

        return jnp.asarray(result_np)
    if mod.startswith("torch"):
        import torch

        return torch.from_numpy(np.ascontiguousarray(result_np))
    if isinstance(original, (int, float)):
        return type(original)(result_np)
    return result_np''',
         '''def _to_numpy(tensor):
    """numpy view of a tensor + a converter back to the original kind: a
    torch tensor goes to the host, a bf16 one as fp32 (exactly: numpy has
    no bf16)."""
    if isinstance(tensor, np.ndarray):
        return tensor, lambda a: a
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), None  # converter built lazily below
    return np.asarray(tensor), lambda a: a


def _convert_back(result_np, original):
    """A result for ``original``: a torch tensor's in its dtype and on its
    device (a bf16 one rounded once from the fp32 sum)."""
    if isinstance(original, np.ndarray):
        return result_np
    if isinstance(original, torch.Tensor):
        out = torch.from_numpy(np.require(result_np, requirements=["C", "W"]))
        return out.to(device=original.device, dtype=original.dtype)
    if isinstance(original, (int, float)):
        return type(original)(result_np)
    return result_np


def _kind(tensor):
    """(dtype name, device type) of a torch tensor, else None: what a
    receiver needs to give the tensor back."""
    if isinstance(tensor, torch.Tensor):
        return str(tensor.dtype).split(".")[1], tensor.device.type
    return None


def _from_wire(value):
    """Inverse of a send's ``{"array", "kind"}`` (a dict: a tuple could
    pass for the abort sentinel): the tensor as it was sent (on the card
    when it was sent from one and this process has one)."""
    arr, kind = value["array"], value["kind"]
    if kind is None:
        return arr
    dtype, device = kind
    out = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
        getattr(torch, dtype))
    if device == "cuda" and torch.cuda.is_available():
        out = out.cuda()
    return out'''),
        ("bucketed payloads may be tensors (allreduce_pytree over torch "
         "trees): reduce their numpy twins",
         "                a = np.ascontiguousarray(arr)\n",
         "                a = np.ascontiguousarray(_to_numpy(arr)[0])\n"),
        ("(as above: each bucket's result in its payload's kind)",
         "                outs.append(out)\n",
         "                outs.append(_convert_back(out, arrays[len(outs)]))\n"),
        ("a sent tensor carries its dtype and device, so recv gives it back",
         "            check_abort(ray_tpu_torch.get(self._store.put.remote("
         "key, arr)))",
         "            check_abort(ray_tpu_torch.get(self._store.put.remote(\n"
         "                key, {\"array\": arr, \"kind\": _kind(tensor)})))"),
        ("(as above)",
         '            return store_wait(self._store, "pop", (key,))',
         '            return _from_wire(store_wait(self._store, "pop", '
         '(key,)))'),
    ],
    "experimental/channel/communicator.py": [
        ("the port's backends: NCCL on the card, the store actor across "
         "hosts",
         """graphs use for tensor movement.  The TPU-native implementation rides the
framework's collective groups: in-slice ops compile to ICI via the xla
backend, cross-process CPU tensors ride the store backend.""",
         """graphs use for tensor movement.  The port's implementation rides the
framework's collective groups: the nccl backend (NCCL for CUDA tensors,
gloo for CPU ones), or the store backend for host tensors anywhere."""),
        ("(as above)",
         """    torch/cupy-backed communicators; here tensors are numpy/jax arrays and
    the backend decides the wire — xla collectives in-slice, the store""",
         """    torch/cupy-backed communicators; here tensors are torch tensors and
    the backend decides the wire — NCCL between cards, the store"""),
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


def _top_level(path: pathlib.Path) -> dict:
    """Top-level name -> its source text (decorators included), for
    functions, classes and assignments."""
    text = path.read_text()
    lines = text.splitlines()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            start = min([d.lineno for d in node.decorator_list]
                        + [node.lineno])
            out[node.name] = "\n".join(lines[start - 1:node.end_lineno])
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.get_source_segment(text, node)
    return out


def test_hunks_belong_to_copies():
    assert set(HUNKS) <= set(COPIES)
    assert len(COPIES) == len(set(COPIES))


@pytest.mark.parametrize(
    "rel", COPIES + [f"util/collective/compression.py:{n}"
                     for n in COMPRESSION_NAMES])
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
