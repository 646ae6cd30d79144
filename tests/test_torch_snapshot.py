"""Snapshots of the training state (``ray_tpu_torch.train._internal.
snapshot``) against the JAX package's (``ray_tpu/train/_internal/
snapshot.py``): one format, so either package restores the other's.

States are ``LlamaConfig.tiny``'s, made by JAX's ``make_train_step`` and
carried over by ``convert``: fp32 with the default optimizer, with int8
gradient compression and error feedback, and bf16 params with bf16 mu.
Restored leaves must equal the saved ones bit for bit.  The JAX package's
own ``SnapshotManager`` cannot write a bf16 state (its content hash takes
``memoryview(...).cast("B")``, which has no format for ``ml_dtypes``'
bf16), so the JAX -> port direction is held on the fp32 states.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu.train._internal import snapshot as js
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import adamw, make_train_step
from ray_tpu_torch.parallel.train_step import tree_leaves
from ray_tpu_torch.train._internal import snapshot as ts

torch.set_num_threads(1)  # tiny shapes; see tests/test_torch_ops.py

KINDS = {
    "fp32": ({}, {}, jnp.float32, torch.float32),
    "compressed": ({"grad_compression": {"error_feedback": True}},
                   {"grad_compression": {"error_feedback": True}},
                   jnp.float32, torch.float32),
    "bf16": ({"optimizer": optax.adamw(1e-3, mu_dtype=jnp.bfloat16)},
             {"optimizer": adamw(1e-3, mu_dtype=torch.bfloat16)},
             jnp.bfloat16, torch.bfloat16),
}


def _tokens():
    return np.random.default_rng(4).integers(0, 256, (2, 64)).astype(np.int32)


def _states(kind, steps=1):
    """(JAX state, the port's copy of it, the port's config and step_fn)
    after ``steps`` JAX steps."""
    jkw, tkw, jdt, tdt = KINDS[kind]
    init_fn, jstep = jax_make_train_step(jl.LlamaConfig.tiny(param_dtype=jdt),
                                         **jkw)
    jstate = init_fn(jax.random.PRNGKey(0))
    for _ in range(steps):
        jstate, _ = jstep(jstate, jnp.asarray(_tokens()))
    cfg = tl.LlamaConfig.tiny(param_dtype=tdt)
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                         device="cpu")
    _, step_fn = make_train_step(cfg, device="cpu", **tkw)
    return jstate, state, step_fn


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_snapshot_is_restored_by_ray_tpu(kind, tmp_path):
    jstate, state, _ = _states(kind)
    mgr = ts.SnapshotManager(str(tmp_path))
    try:
        assert mgr.save(state) == 1
        assert mgr.wait(30)
    finally:
        mgr.close()
    assert mgr.last_error is None
    snap = str(tmp_path / ts.snapshot_dir_name(1))
    # the JAX package's keys, and its restore onto a JAX state's shardings
    assert sorted(js.restore_snapshot(snap)) == sorted(
        k for k, _ in js.tree_leaves_with_keys(jstate))
    restored = js.restore_snapshot(snap, target=jstate)
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    want = jax.tree_util.tree_flatten_with_path(
        convert.train_state_to_jax(state))[0]
    assert [js._key_str(p) for p, _ in got] == [js._key_str(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert np.asarray(g).dtype == w.dtype, js._key_str(path)
        np.testing.assert_array_equal(_bits(g), _bits(w), js._key_str(path))


@pytest.mark.parametrize("kind", ["fp32", "compressed"])
def test_ray_tpu_snapshot_is_restored_by_the_port(kind, tmp_path):
    jstate, state, _ = _states(kind)
    mgr = js.SnapshotManager(str(tmp_path))
    try:
        mgr.save(jstate)
        assert mgr.wait(60)
    finally:
        mgr.close()
    assert mgr.last_error is None
    snap = str(tmp_path / js.snapshot_dir_name(1))
    fresh = jax.tree.map(torch.zeros_like, state)
    restored = ts.restore_snapshot(snap, target=fresh)
    assert isinstance(restored, type(state))
    for (k, g), (_, w) in zip(ts.tree_leaves_with_keys(restored),
                              ts.tree_leaves_with_keys(state)):
        assert g.dtype == w.dtype and torch.equal(g, w), k
    flat = ts.restore_snapshot(snap)
    assert sorted(flat) == sorted(k for k, _ in ts.tree_leaves_with_keys(state))


def test_delta_entries_point_at_the_earlier_snapshot(tmp_path):
    _, state, _ = _states("fp32")
    mgr = ts.SnapshotManager(str(tmp_path))
    try:
        mgr.save(state)
        mgr.wait(30)
        full = mgr.bytes_written["full"]
        assert full == sum(t.numel() * t.element_size()
                           for t in tree_leaves(state))
        mgr.save(state)  # nothing changed: every leaf is a reference
        mgr.wait(30)
        assert mgr.bytes_written["delta"] == 0
        state.params["layers"]["wq"].add_(1.0)  # one leaf changes
        mgr.save(state)
        mgr.wait(30)
    finally:
        mgr.close()
    assert mgr.last_error is None
    wq = state.params["layers"]["wq"]
    assert mgr.bytes_written["delta"] == wq.numel() * wq.element_size()
    man2 = ts.load_manifest(str(tmp_path / ts.snapshot_dir_name(2)))
    man3 = ts.load_manifest(str(tmp_path / ts.snapshot_dir_name(3)))
    assert man2["kind"] == man3["kind"] == "delta"
    assert {e["dir"] for e in man2["ranks"]["0"].values()} == {"checkpoint_000001"}
    written = {k for k, e in man3["ranks"]["0"].items()
               if e["dir"] == "checkpoint_000003"}
    assert written == {"params/layers/wq"}
    assert ts.chain_refs(man3) == {"checkpoint_000001"}
    restored = ts.restore_snapshot(str(tmp_path / ts.snapshot_dir_name(3)),
                                   target=state)
    for (k, g), (_, w) in zip(ts.tree_leaves_with_keys(restored),
                              ts.tree_leaves_with_keys(state)):
        assert torch.equal(g, w), k


def test_an_uncommitted_snapshot_is_ignored_and_retention_keeps_chains(tmp_path):
    _, state, _ = _states("fp32")
    mgr = ts.SnapshotManager(str(tmp_path))
    try:
        for _ in range(3):
            mgr.save(state)
            mgr.wait(30)
    finally:
        mgr.close()
    # a crash mid-persist: shards and a rank manifest, no manifest.json
    crashed = tmp_path / ts.snapshot_dir_name(4)
    (crashed / "leaves").mkdir(parents=True)
    (crashed / "manifest.rank0.json").write_text("{}")
    assert ts.latest_committed(str(tmp_path)) == str(tmp_path / "checkpoint_000003")
    with pytest.raises(FileNotFoundError, match="never committed"):
        ts.restore_snapshot(str(crashed))
    # a new manager continues from the last committed snapshot
    mgr = ts.SnapshotManager(str(tmp_path))
    try:
        assert mgr.save(state) == 4
        mgr.wait(30)
    finally:
        mgr.close()
    assert ts.is_committed(str(crashed))
    # snapshots 2-4 are deltas on 1: keeping one keeps 1 too
    assert ts.prune_snapshots(str(tmp_path), 1) == ["checkpoint_000002",
                                                    "checkpoint_000003"]
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_000001",
                                            "checkpoint_000004"]
    restored = ts.restore_snapshot(str(tmp_path / "checkpoint_000004"),
                                   target=state)
    assert all(torch.equal(g, w) for g, w in
               zip(tree_leaves(restored), tree_leaves(state)))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_resume_from_a_snapshot_is_bit_identical_to_running_through(kind,
                                                                    tmp_path):
    _, state, step_fn = _states(kind)
    tokens = torch.from_numpy(_tokens())
    mgr = ts.SnapshotManager(str(tmp_path))
    try:
        mgr.save(state)
        # the state is updated in place right after save(): the snapshot
        # must hold the bytes it had at save()
        through = [float(step_fn(state, tokens)[1]["loss"]) for _ in range(3)]
        mgr.wait(30)
    finally:
        mgr.close()
    fresh = ts.restore_snapshot(str(tmp_path / ts.snapshot_dir_name(1)),
                                target=state)
    resumed = [float(step_fn(fresh, tokens)[1]["loss"]) for _ in range(3)]
    assert resumed == through
    for (k, g), (_, w) in zip(ts.tree_leaves_with_keys(fresh),
                              ts.tree_leaves_with_keys(state)):
        assert g.dtype == w.dtype and torch.equal(g, w), k


def test_a_failed_persist_raises_from_the_next_save(tmp_path, monkeypatch):
    _, state, _ = _states("fp32")
    errors = []
    mgr = ts.SnapshotManager(str(tmp_path),
                             on_error=lambda step, e: errors.append(step))

    def full_disk(f, data):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ts, "_save_npy", full_disk)
    try:
        mgr.save(state)
        mgr.wait(30)
        assert errors == [1] and not ts.is_committed(
            str(tmp_path / ts.snapshot_dir_name(1)))
        with pytest.raises(RuntimeError, match="No space left"):
            mgr.save(state)
    finally:
        mgr.close()
    assert mgr.stall_seconds >= 0 and mgr.persist_seconds > 0


def test_replica_payloads_restore_the_state(tmp_path):
    _, state, _ = _states("bf16")
    holder = ts.ReplicaHolder()
    mgr = ts.SnapshotManager(str(tmp_path), replica_push=holder.put_replica)
    try:
        mgr.save(state)
        mgr.wait(30)
    finally:
        mgr.close()
    payloads = ts.select_replica_set(list(holder.all_replicas().values()))
    assert payloads is not None and holder.newest_steps() == {0: 1}
    restored = ts.restore_from_payloads(payloads, target=state)
    assert all(torch.equal(g, w) for g, w in
               zip(tree_leaves(restored), tree_leaves(state)))
    assert mgr.bytes_written["replica"] == sum(
        t.numel() * t.element_size() for t in tree_leaves(state))
