"""The port's trainer fed by its data layer, against the JAX package's step.

Tiny Llama trained three steps through ``TorchTrainer`` with two workers
over gloo, on a dataset: ``from_numpy`` of 12 token rows in 6 blocks,
``streaming_split(2)`` (what ``_shard_datasets`` now does), each worker's
``get_dataset_shard("train")`` a ``DataShard`` whose
``iter_device_batches`` (host tensors: ``device="cpu"``) gives it 2 rows a
step.  The ranks gather the global batch of 4 rows and step
``MeshSpec(data=2)``'s step on it; every report names the row ids it
trained on.  The JAX package's ``make_train_step`` then runs from the same
initial state on the same batches in the same order, and the losses and
grad norms must match within ``tests/test_torch_train_step.py``'s
tolerance (1e-5 absolute loss, 1e-5 relative grad norm).  The workers'
measured buffer-empty waits reach their reports as ``input_wait_s`` and
the goodput ledger's ``input_wait`` bucket.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.data

pytestmark = pytest.mark.timeout(240)

N, S, STEPS = 12, 32, 3


@pytest.fixture(scope="module")
def runtime():
    os.environ.setdefault("RAY_TPU_NUM_CHIPS", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


def _tokens():
    return np.random.default_rng(21).integers(0, 256, (N, S)).astype(np.int32)


def _make_loop():
    # made in a function, so it travels to the workers by value
    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.parallel import make_train_step
        from ray_tpu_torch.parallel.mesh import MeshSpec
        from ray_tpu_torch.train.backend import gang_store

        torch.set_num_threads(1)
        ctx = train.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        mesh = MeshSpec(data=world).build(rank=rank, store=gang_store("mesh"),
                                          device="cpu", name="gang")
        _, step_fn = make_train_step(llama.LlamaConfig.tiny(), mesh,
                                     device="cpu")
        state = config["state"]
        shard = train.get_dataset_shard("train")
        assert type(shard).__name__ == "DataShard"
        for batch in shard.iter_device_batches(batch_size=config["rows"],
                                               device="cpu"):
            parts = [torch.empty_like(batch["tokens"]) for _ in range(world)]
            ids = [torch.empty_like(batch["id"]) for _ in range(world)]
            dist.all_gather(parts, batch["tokens"])
            dist.all_gather(ids, batch["id"])
            state, m = step_fn(state, torch.cat(parts))
            train.report({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "ids": torch.cat(ids).tolist(), "rank": rank})

    return loop


def test_two_workers_train_on_a_dataset_as_the_jax_step_does(runtime,
                                                             tmp_path):
    from ray_tpu.models import llama as jl
    from ray_tpu.parallel import make_train_step as jax_make_train_step
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.train import (
        RunConfig,
        ScalingConfig,
        TorchConfig,
        TorchTrainer,
    )

    init_fn, jstep = jax_make_train_step(jl.LlamaConfig.tiny())
    jstate = init_fn(jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         tl.LlamaConfig.tiny(), device="cpu")
    tokens = _tokens()
    ds = ray_tpu_torch.data.from_numpy(
        {"tokens": tokens, "id": np.arange(N)}).repartition(6)
    trainer = TorchTrainer(
        _make_loop(), train_loop_config={"state": state, "rows": N // 6},
        torch_config=TorchConfig(backend="gloo"),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="data", storage_path=str(tmp_path)),
        datasets={"train": ds})
    result = trainer.fit()
    assert result.error is None, result.error
    hist = [m for m in result.metrics_history if m["rank"] == 0]
    assert len(hist) == STEPS
    seen = [i for m in hist for i in m["ids"]]
    assert sorted(seen) == list(range(N))  # every row once
    for m in hist:
        jstate, jm = jstep(jstate, jnp.asarray(tokens[m["ids"]]))
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-5)
    waits = [m["input_wait_s"] for m in result.metrics_history
             if "input_wait_s" in m]
    assert waits and all(w > 0 for w in waits)
    bucket = trainer.goodput_ledger.snapshot()["buckets_s"]["input_wait"]
    assert 0 < bucket < float("inf")
