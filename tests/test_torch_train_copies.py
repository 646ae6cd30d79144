"""The port's trainer is a copy of the JAX package's ``train/``.

Each file below equals its original under the rules of
``tests/test_torch_runtime_copies.py`` (the word ``ray_tpu`` renamed to
``ray_tpu_torch``, ``RAY_TPU_*`` variables, config keys and ``ray_tpu_*``
metric names kept, the reference's citations of its own change numbers
dropped), apart from the hunks listed here, each with its reason.
``train/backend.py`` is the port's own module (``TorchConfig`` and
``_TorchBackend`` where the reference has ``JaxConfig`` and
``_JaxBackend``): the names it copies are held to their originals below.
``train/_internal/snapshot.py`` is the port's own (``tests/
test_torch_snapshot.py``) and ``goodput.py`` is held by
``tests/test_torch_serve_copies.py``.
"""

import ast
import pathlib

import pytest

from test_torch_runtime_copies import renamed

ROOT = pathlib.Path(__file__).resolve().parents[1]

COPIES = [
    "train/config.py", "train/_internal/checkpoint_util.py",
    "train/_checkpoint.py", "train/policies.py",
    "train/_internal/watchdog.py", "train/_internal/session.py",
    "train/_internal/worker_group.py", "train/_internal/backend_executor.py",
    "train/collective.py", "train/trainer.py", "train/v2/controller.py",
    "train/v2/__init__.py", "train/__init__.py",
]

# names train/backend.py copies whole
BACKEND_NAMES = ["BackendConfig", "Backend"]

# file -> [(reason, old, new)]: ``old`` is a unique span of the renamed
# original, ``new`` what the port has in its place
HUNKS = {
    "train/config.py": [
        ("the port's docstring: use_gpu books the card, the TPU settings refuse",
         '''FailureConfig, CheckpointConfig. Per SURVEY §2.3 the rebuild adds ``use_tpu``
and ``topology`` (the reference has no use_tpu).
''',
         '''FailureConfig, CheckpointConfig. The port trains on the card: ``use_gpu``
(on by default) books ``{"GPU": chips_per_worker or 1}`` per worker, the
counterpart of the JAX package's ``use_tpu``; ``use_tpu``, ``topology``
and ``tpu_slice`` refuse (the port has no TPU).
'''),
        ('(as above), and use_gpu is on by default: the entry point trains on the card unless the caller asks for the CPU',
         '''    TPU semantics: one worker per TPU host (SPMD gang over a slice);
    ``topology`` (e.g. "4x4x8") or ``num_workers`` sizes the gang, and
    ``chips_per_worker`` carves chips (ICI-aligned blocks of 1/2/4/8).
    """

    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = False  # reference-compat; maps onto generic accelerator
''',
         '''    One worker per card by default: ``num_workers`` sizes the gang and
    ``chips_per_worker`` gives a worker several cards.  ``use_gpu=False``
    trains on the CPU (the tests).
    """

    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = True  # {"GPU": chips_per_worker or 1} per worker
'''),
        ('use_gpu books {"GPU": chips_per_worker or 1} per worker (the counterpart of use_tpu\'s booking); use_tpu, topology and tpu_slice refuse: the port has no TPU',
         '''    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_tpu and "TPU" not in res:
            chips = self.chips_per_worker
            if chips is None:
                from ray_tpu_torch._private.accelerators import get_accelerator_manager

                chips = get_accelerator_manager("TPU").get_current_node_num_accelerators() or 4
            res["TPU"] = float(chips)
''',
         '''    def __post_init__(self):
        asked = [name for name, v in (("use_tpu", self.use_tpu),
                                      ("topology", self.topology),
                                      ("tpu_slice", self.tpu_slice)) if v]
        if asked:
            raise ValueError(
                f"ScalingConfig({', '.join(asked)}=...): the port has no TPU; "
                "it trains on NVIDIA cards (use_gpu=True, chips_per_worker) "
                "or on the CPU (use_gpu=False)")

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = float(self.chips_per_worker or 1)
'''),
        ('a URI storage path refuses: fsspec storage is not ported',
         '''            return base  # fsspec URI (gs://, s3://, ...): not a local path
''',
         '''            raise ValueError(
                f"RunConfig(storage_path={base!r}): remote storage (fsspec) "
                "is not ported to ray_tpu_torch; use a local path")
'''),
    ],
    "train/_internal/checkpoint_util.py": [
        ("the port's docstring: local paths only",
         '''"""Shared checkpoint persistence helpers (used by train's BackendExecutor and
tune's TuneController).

Storage paths may be local or any fsspec URI (gs://, s3://, ...) — the
reference persists checkpoints through fsspec the same way
(train/_internal/storage.py).
''',
         '''"""Shared checkpoint persistence helpers (used by train's BackendExecutor
and the step snapshots).

The JAX package also reaches remote storage (gs://, s3://) through
fsspec; the port takes local paths only and refuses a URI.
'''),
        ('every fsspec branch refuses a URI instead (fsspec storage is not ported)',
         '''
def normalize_local_path(path: str) -> str:
''',
         '''
def refuse_remote(path: str):
    raise ValueError(f"{path}: remote storage (fsspec) is not ported to "
                     f"ray_tpu_torch; use a local path")


def normalize_local_path(path: str) -> str:
'''),
        ('(as above); upload_dir and download_dir go with the fsspec branches',
         '''        return "/".join([str(base).rstrip("/")] + [n.strip("/") for n in names])
    return os.path.join(base, *names)


def makedirs_any(path: str) -> None:
    if is_remote_path(path):
        import fsspec

        fs, p = fsspec.core.url_to_fs(path)
        fs.makedirs(p, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def rmtree_any(path: str) -> None:
    if is_remote_path(path):
        import fsspec

        fs, p = fsspec.core.url_to_fs(path)
        try:
            fs.rm(p, recursive=True)
        except FileNotFoundError:
            pass
    else:
        shutil.rmtree(path, ignore_errors=True)


def upload_dir(local_src: str, dest: str) -> None:
    import fsspec

    fs, p = fsspec.core.url_to_fs(dest)
    fs.makedirs(p, exist_ok=True)
    fs.put(local_src.rstrip("/") + "/", p, recursive=True)


def download_dir(src: str, local_dest: str) -> str:
    import fsspec

    fs, p = fsspec.core.url_to_fs(src)
    os.makedirs(local_dest, exist_ok=True)
    fs.get(p.rstrip("/") + "/", local_dest.rstrip("/") + "/", recursive=True)
    return local_dest
''',
         '''        refuse_remote(base)
    return os.path.join(base, *names)


def makedirs_any(path: str) -> None:
    if is_remote_path(path):
        refuse_remote(path)
    os.makedirs(path, exist_ok=True)


def rmtree_any(path: str) -> None:
    if is_remote_path(path):
        refuse_remote(path)
    shutil.rmtree(path, ignore_errors=True)
'''),
        ('(as above)',
         '''    """Move (if worker-staged) or copy a local checkpoint dir to ``dest``
    (local path or fsspec URI).

    Crash-safe replacement: the bytes are fully staged NEXT TO the
    destination first, then committed by rename (local) or by retiring the
    old prefix only after the new upload completed (remote) — a crash
    mid-persist leaves the previous checkpoint intact and restorable (the
    old rmtree-then-copy order left a corrupt "latest" instead)."""
    import uuid as uuid_mod

    staged_src = os.path.dirname(src_path).endswith(".staged")
    if is_remote_path(dest):
        import fsspec

        tag = uuid_mod.uuid4().hex[:8]
        staging = dest.rstrip("/") + f".staging-{tag}"
        upload_dir(src_path, staging)  # a crash here never touches dest
        fs, p_dest = fsspec.core.url_to_fs(dest)
        _, p_stage = fsspec.core.url_to_fs(staging)
        # retire-by-rename, never rm-then-upload: at every instant at
        # least one COMPLETE copy exists under some name (a crash between
        # the mvs leaves the previous checkpoint at .retired-* and the new
        # one at .staging-* — recoverable, nothing destroyed)
        retired = None
        if fs.exists(p_dest):
            retired = f"{p_dest}.retired-{tag}"
            fs.mv(p_dest, retired, recursive=True)
        fs.mv(p_stage, p_dest, recursive=True)
        if retired is not None:
            try:
                fs.rm(retired, recursive=True)
            except FileNotFoundError:
                pass
        if staged_src:
            shutil.rmtree(src_path, ignore_errors=True)
        return dest
''',
         '''    """Move (if worker-staged) or copy a local checkpoint dir to ``dest``.

    Crash-safe replacement: the bytes are fully staged NEXT TO the
    destination first, then committed by rename — a crash mid-persist
    leaves the previous checkpoint intact and restorable (the old
    rmtree-then-copy order left a corrupt "latest" instead)."""
    import uuid as uuid_mod

    staged_src = os.path.dirname(src_path).endswith(".staged")
    if is_remote_path(dest):
        refuse_remote(dest)
'''),
        ('(as above)',
         '''        import fsspec

        fs, p = fsspec.core.url_to_fs(run_dir)
        try:
            names = [n.rstrip("/").rsplit("/", 1)[-1]
                     for n in fs.ls(p, detail=False)]
        except FileNotFoundError:
            return []
    elif os.path.isdir(run_dir):
''',
         '''        refuse_remote(run_dir)
    if os.path.isdir(run_dir):
'''),
    ],
    "train/_checkpoint.py": [
        ("the port's docstring: local paths, and torch.distributed.checkpoint where the reference uses orbax",
         '''URI). TPU-native extension (SURVEY §5 checkpoint/resume): sharded jax
checkpoints — every host writes its address-local array shards concurrently
via orbax/tensorstore (save_sharded / restore_sharded below), generalizing
the reference's single-rank upload model.
''',
         '''URI); the port takes local paths only.  Sharded checkpoints (save_sharded /
restore_sharded below) go through torch.distributed.checkpoint where the
JAX package uses orbax: every rank writes its own shards, and a restore
can go to another layout.  The two formats differ: neither package reads
the other's sharded checkpoints (the step snapshots, ``_internal/
snapshot.py``, are the shared format).
'''),
        ('a Checkpoint holds a local path: a URI refuses at construction, and the download and fsspec branches go',
         ''')


class Checkpoint:
    """A reference to a directory holding checkpoint data — local or any
    fsspec URI (reference: Checkpoint = directory + fsspec URI)."""

    def __init__(self, path: str):
        p = os.fspath(path)
        self.path = p if _is_remote(p) else os.path.abspath(_normalize_local(p))

    @classmethod
    def from_directory(cls, path) -> "Checkpoint":
        return cls(path)

    def as_directory(self):
        """Context manager over a local view of the checkpoint.  For a
        remote checkpoint the download lands in a unique ``ckpt_dl_*``
        temp dir that is removed however the block exits — normal exit,
        exception, early ``break``/``return`` (generator close), or a
        download that dies mid-transfer — so no temp dirs leak."""
        @contextlib.contextmanager
        def cm() -> Iterator[str]:
            if not _is_remote(self.path):
                yield self.path
                return
            from ray_tpu_torch.train._internal.checkpoint_util import download_dir

            # eager unique creation: collision-free under concurrent
            # callers, and the finally below owns it from the first byte
            tmp = tempfile.mkdtemp(prefix="ckpt_dl_")
            try:
                yield download_dir(self.path, tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
''',
         '''    refuse_remote as _refuse_remote,
)


class Checkpoint:
    """A reference to a local directory holding checkpoint data (reference:
    Checkpoint = directory + fsspec URI; a URI refuses here)."""

    def __init__(self, path: str):
        p = os.fspath(path)
        if _is_remote(p):
            _refuse_remote(p)
        self.path = os.path.abspath(_normalize_local(p))

    @classmethod
    def from_directory(cls, path) -> "Checkpoint":
        return cls(path)

    def as_directory(self):
        """Context manager over a local view of the checkpoint: its own
        directory."""
        @contextlib.contextmanager
        def cm() -> Iterator[str]:
            yield self.path
'''),
        ('(as above)',
         '''        if not _is_remote(self.path) and os.path.abspath(dest) == self.path:
''',
         '''        if os.path.abspath(dest) == self.path:
'''),
        ('(as above)',
         '''            if _is_remote(self.path):
                from ray_tpu_torch.train._internal.checkpoint_util import download_dir

                download_dir(self.path, tmp)
            else:
                shutil.copytree(self.path, tmp)
''',
         '''            shutil.copytree(self.path, tmp)
'''),
        ('(as above)',
         '''        if _is_remote(self.path):
            return self.path.rstrip("/") + "/.metadata.json"
''',
         ''''''),
        ('(as above)',
         '''        if _is_remote(self.path):
            import fsspec

            with fsspec.open(self._meta_path(), "w") as f:
                json.dump(existing, f)
            return
''',
         ''''''),
        ('(as above)',
         '''        if _is_remote(self.path):
            import fsspec

            fs, p = fsspec.core.url_to_fs(meta)
            if fs.exists(p):
                with fs.open(p) as f:
                    return json.load(f)
            return {}
''',
         ''''''),
        ("save_sharded/restore_sharded on torch.distributed.checkpoint in place of orbax: each rank writes its own shards, a restore reshards to the target's layout",
         '''def save_sharded(state: Any, path: str, *, force: bool = True) -> str:
    """Write a pytree of (possibly sharded) jax arrays; every process writes
    its own address-local shards concurrently (orbax/tensorstore ocdbt)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, state, force=force)
    ckptr.wait_until_finished()
    return path


def restore_sharded(path: str, target: Any = None) -> Any:
    """Restore a pytree saved by save_sharded. ``target`` (a pytree of
    ShapeDtypeStructs with shardings, or concrete arrays) drives resharding."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    if target is None:
        return ckptr.restore(os.path.abspath(path))
    return ckptr.restore(os.path.abspath(path), target)
''',
         '''def _flat_tensors(state: Any) -> Dict[str, Any]:
    """``{leaf key: tensor}`` in the JAX package's key order (a leaf that
    is not a tensor becomes one)."""
    import torch

    from ray_tpu_torch._private.tree import tree_leaves_with_keys

    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in tree_leaves_with_keys(state)}


def save_sharded(state: Any, path: str, *, force: bool = True) -> str:
    """Write a pytree of tensors (nested dicts, tuples, NamedTuples, lists)
    with torch.distributed.checkpoint.  Inside a process group every rank
    calls this together and writes its own shards: a DTensor leaf's local
    shards, a plain tensor once (it counts as replicated).  ``force=False``
    refuses an existing ``path``."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"{path} exists (force=False)")
    dcp.save(_flat_tensors(state),
             storage_writer=dcp.FileSystemWriter(path),
             no_dist=not dist.is_initialized())
    return path


def restore_sharded(path: str, target: Any = None) -> Any:
    """Restore what :func:`save_sharded` wrote.  ``target`` (a pytree of
    its structure: tensors or DTensors of any layout) is filled in place
    and returned, each leaf resharded to the target's layout; without it
    a flat ``{leaf key: tensor}`` dict of whole CPU tensors comes back."""
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from ray_tpu_torch._private.tree import tree_map_with_keys

    path = os.path.abspath(path)
    reader = dcp.FileSystemReader(path)
    if target is None:
        meta = reader.read_metadata().state_dict_metadata
        flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                for k, m in meta.items()}
    else:
        flat = _flat_tensors(target)
    dcp.load(flat, storage_reader=reader, no_dist=not dist.is_initialized())
    if target is None:
        return flat
    return tree_map_with_keys(lambda k, _: flat[k], target)
'''),
    ],
    "train/_internal/session.py": [
        ("the port's note_train_step gives None where the card's peak is unknown (the CPU): no mfu then",
         '''            metrics.setdefault("mfu", round(mfu, 4))
''',
         '''            if mfu is not None:  # None: the device's peak is unknown
                metrics.setdefault("mfu", round(mfu, 4))
'''),
    ],
    "train/_internal/worker_group.py": [
        ('a worker reports the cards its lease bound (get_gpu_ids) where the reference reports TPU ids',
         '''            "tpu_ids": ray_tpu_torch.get_tpu_ids(),
''',
         '''            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
'''),
    ],
    "train/collective.py": [
        ("the average over a tree of tensors goes through the port's _private/tree.py, not jax.tree.map",
         '''    import jax

    return jax.tree.map(lambda a: a / world, out)
''',
         '''    from ray_tpu_torch._private.tree import tree_map

    return tree_map(lambda a: a / world, out)
'''),
    ],
    "train/trainer.py": [
        ("TorchTrainer (Ray's name for the torch backend's trainer) in place of JaxTrainer",
         '''"""Trainers: DataParallelTrainer + JaxTrainer.
''',
         '''"""Trainers: DataParallelTrainer + TorchTrainer (Ray's name for the torch
backend's trainer; the JAX package's JaxTrainer is its counterpart).
'''),
        ('(as above)',
         '''from ray_tpu_torch.train.backend import BackendConfig, JaxConfig
''',
         '''from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
'''),
        ('TorchTrainer with torch_config= in place of JaxTrainer with jax_config=',
         '''class JaxTrainer(DataParallelTrainer):
    """DataParallelTrainer with the JAX backend: the gang comes up with
    jax.distributed initialized so user code sees the slice's global devices
    (reference analog: TorchTrainer + _TorchBackend, torch/config.py:154)."""

    _default_backend_config = JaxConfig()

    def __init__(self, train_loop_per_worker, *, jax_config: Optional[JaxConfig] = None,
                 **kwargs):
        kwargs.setdefault("backend_config", jax_config or JaxConfig())
''',
         '''class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch backend: the gang comes up with a
    torch.distributed process group (NCCL where the workers hold cards,
    gloo otherwise) whose store also serves the port's meshes
    (reference: TorchTrainer + _TorchBackend, torch/config.py:154; the
    JAX package's JaxTrainer)."""

    _default_backend_config = TorchConfig()

    def __init__(self, train_loop_per_worker, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        kwargs.setdefault("backend_config", torch_config or TorchConfig())
'''),
    ],
    "train/v2/__init__.py": [
        ("the v2 trainer is TorchTrainer, over v1's TorchTrainer",
         '''The v1 surface (ray_tpu_torch.train.JaxTrainer) runs its control loop in the
''',
         '''The v1 surface (ray_tpu_torch.train.TorchTrainer) runs its control loop in the
'''),
        ('(as above)',
         '''class JaxTrainer:
    """v2 trainer: same constructor surface as v1's JaxTrainer, but fit()
    drives a controller actor. ``detached_name`` makes the controller a
    named detached actor so training survives the driver (re-join with
    ``JaxTrainer.attach(name)``)."""
''',
         '''class TorchTrainer:
    """v2 trainer: same constructor surface as v1's TorchTrainer, but fit()
    drives a controller actor. ``detached_name`` makes the controller a
    named detached actor so training survives the driver (re-join with
    ``TorchTrainer.attach(name)``)."""
'''),
        ('(as above)',
         '''            from ray_tpu_torch.train.trainer import JaxTrainer as V1JaxTrainer

            return V1JaxTrainer(fn, **kwargs)
''',
         '''            from ray_tpu_torch.train.trainer import TorchTrainer as V1TorchTrainer

            return V1TorchTrainer(fn, **kwargs)
'''),
        ('(as above)',
         '''    "JaxTrainer",
''',
         '''    "TorchTrainer",
'''),
    ],
    "train/__init__.py": [
        ("the package docstring: the port's gang trains on NVIDIA cards, with the torch pair",
         '''"""ray_tpu_torch.train — SPMD gang training on TPU slices.

reference: python/ray/train/ (SURVEY §2.3, §3.4). The JaxTrainer brings a
gang of one-worker-per-TPU-host actors up with jax.distributed initialized,
runs the user train loop on each, pumps ``report()`` results back, persists
checkpoints (sharded via orbax), and restarts the whole gang on failure.
''',
         '''"""ray_tpu_torch.train — gang training on NVIDIA cards (or the CPU).

reference: python/ray/train/ (SURVEY §2.3, §3.4). The TorchTrainer (the
JAX package's JaxTrainer) brings a gang of one-worker-per-card actors up
with a torch.distributed process group, runs the user train loop on each,
pumps ``report()`` results back, persists checkpoints and step snapshots,
and restarts the whole gang on failure.  TorchConfig is JaxConfig's
counterpart.
'''),
        ('TorchConfig and TorchTrainer in place of JaxConfig and JaxTrainer',
         '''from ray_tpu_torch.train.backend import Backend, BackendConfig, JaxConfig
''',
         '''from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
'''),
        ('(as above)',
         '''from ray_tpu_torch.train.trainer import DataParallelTrainer, JaxTrainer, Result
''',
         '''from ray_tpu_torch.train.trainer import DataParallelTrainer, Result, TorchTrainer
'''),
        ('(as above)',
         '''    "JaxConfig",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "DataParallelTrainer",
    "JaxTrainer",
''',
         '''    "TorchConfig",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "DataParallelTrainer",
    "TorchTrainer",
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
    # every module of the reference's train package is copied, apart from
    # the backend (the port's own) and what other tests hold
    ref = {str(p.relative_to(ROOT / "ray_tpu")) for p in
           (ROOT / "ray_tpu" / "train").rglob("*.py")}
    own = {"train/backend.py", "train/_internal/snapshot.py",
           "train/_internal/goodput.py", "train/_internal/__init__.py"}
    assert ref - own == set(COPIES)


@pytest.mark.parametrize("rel", COPIES)
def test_port_file_is_a_copy(rel):
    assert all(reason.strip() for reason, _, _ in HUNKS.get(rel, ()))
    got = (ROOT / "ray_tpu_torch" / rel).read_text()
    assert got == expected(rel), (
        f"ray_tpu_torch/{rel} drifted from ray_tpu/{rel} beyond its listed "
        f"hunks")


def _definitions(text: str) -> dict:
    tree = ast.parse(text)
    return {n.name: ast.get_source_segment(text, n) for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))}


@pytest.mark.parametrize("name", BACKEND_NAMES)
def test_backend_name_is_a_copy(name):
    ref = _definitions(renamed((ROOT / "ray_tpu/train/backend.py").read_text()))
    got = _definitions((ROOT / "ray_tpu_torch/train/backend.py").read_text())
    assert got[name] == ref[name]
