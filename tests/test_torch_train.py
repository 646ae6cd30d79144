"""The port's trainer against the JAX package's, on the CPU.

Both runtimes run in this process (``ray_tpu.init``, then
``ray_tpu_torch.init``, four CPUs each, in a module fixture).  Each
scenario of ``tests/test_train.py`` and ``tests/test_train_v2.py`` runs on
the JAX package's trainer and on the port's, and the two must report the
same: metrics history, the checkpoints kept under ``num_to_keep`` and the
score order, the step a restarted gang resumes from, the error after the
failures run out, ranks and ``train_loop_config``, broadcast and barrier,
the gang an elastic policy sizes, the v2 controller's status.  The port's
gangs train on the CPU (``use_gpu=False``); its ``use_gpu`` is on by
default.  The regrow scenario is in ``tests/test_torch_train_regrow.py``
(a cluster of its own), the jitted step's in
``tests/test_torch_train_llama.py``; the fsspec storage path, which the
port refuses, is among the refusals below, and a dataset reaches the loop
through the data layer (``tests/test_torch_train_data.py``).

Then the port's own: a gang of two over gloo builds ``MeshSpec(data=2)``
from the backend's store and trains tiny Llama three steps, held to the
world-1 step on the global batch within ``tests/test_torch_train_mesh.py``'s
tolerance (its control, one rank's gradient left unsynced, must break it);
the gang's ranks write one tensor's shards through
``torch.distributed.checkpoint`` and one process reads it whole; and the
port's refusals, each with its message.  ``tests/test_torch_train_llama.py``
holds the slice as a whole.
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(180)

RUNTIMES = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}


@pytest.fixture(scope="module")
def runtimes():
    os.environ.setdefault("RAY_TPU_NUM_CHIPS", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _train(pkg):
    return importlib.import_module(f"{pkg}.train")


def _scaling(pkg, **kw):
    """The scenario's ScalingConfig; the port's gangs stay on the CPU."""
    if pkg == "ray_tpu_torch":
        kw.setdefault("use_gpu", False)
    return _train(pkg).ScalingConfig(**kw)


def _run_config(pkg, name, tmp, **kw):
    return _train(pkg).RunConfig(name=name, storage_path=str(tmp), **kw)


# -- scenarios: each takes the package's name and a fresh directory and
# returns what the two trainers must agree on ------------------------------


def basic_fit(pkg, tmp):
    def train_fn(config):
        train = importlib.import_module(f"{pkg}.train")
        ctx = train.get_context()
        for step in range(3):
            train.report({"step": step, "rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size()})

    t = _train(pkg)
    result = t.DataParallelTrainer(
        train_fn,
        scaling_config=_scaling(pkg, num_workers=2,
                                resources_per_worker={"CPU": 0.5}),
        run_config=_run_config(pkg, "t0", tmp)).fit()
    return {"error": result.error, "metrics": result.metrics,
            "history": result.metrics_history}


def loop_config_and_ranks(pkg, tmp):
    def train_fn(config):
        train = importlib.import_module(f"{pkg}.train")
        ctx = train.get_context()
        train.report({"lr": config["lr"], "rank": ctx.get_world_rank(),
                      "local_rank": ctx.get_local_rank(),
                      "node_rank": ctx.get_node_rank(),
                      "local_world": ctx.get_local_world_size(),
                      "trial": ctx.get_trial_name()})

    result = _train(pkg).DataParallelTrainer(
        train_fn, train_loop_config={"lr": 0.1},
        scaling_config=_scaling(pkg, num_workers=2,
                                resources_per_worker={"CPU": 0.5}),
        run_config=_run_config(pkg, "t1", tmp)).fit()
    return {"error": result.error, "history": result.metrics_history}


def _keep_top_k(order):
    def scenario(pkg, tmp):
        def train_fn(config):
            import tempfile as tf

            train = importlib.import_module(f"{pkg}.train")
            for step in range(4):
                with tf.TemporaryDirectory() as d:
                    with open(os.path.join(d, "model.txt"), "w") as f:
                        f.write(f"step={step}")
                    train.report({"score": float(step)},
                                 checkpoint=train.Checkpoint.from_directory(d))

        t = _train(pkg)
        result = t.DataParallelTrainer(
            train_fn, scaling_config=_scaling(pkg, num_workers=1),
            run_config=_run_config(
                pkg, "t2", tmp, checkpoint_config=t.CheckpointConfig(
                    num_to_keep=2, checkpoint_score_attribute="score",
                    checkpoint_score_order=order))).fit()
        run_dir = os.path.join(str(tmp), "t2")
        kept = sorted(d for d in os.listdir(run_dir)
                      if d.startswith("checkpoint_"))
        texts = []
        for d in kept:
            with open(os.path.join(run_dir, d, "model.txt")) as f:
                texts.append(f.read())
        return {"error": result.error, "kept": kept, "texts": texts,
                "latest": os.path.basename(result.checkpoint.path),
                "latest_exists": os.path.isdir(result.checkpoint.path)}
    return scenario


def failure_resumes_from_checkpoint(pkg, tmp):
    def train_fn(config):
        import tempfile as tf

        train = importlib.import_module(f"{pkg}.train")
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.txt")) as f:
                start = int(f.read()) + 1
        for step in range(start, 3):
            with tf.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.txt"), "w") as f:
                    f.write(str(step))
                train.report({"step": step},
                             checkpoint=train.Checkpoint.from_directory(d))
            if step == 1 and ckpt is None:
                raise RuntimeError("injected failure after step 1")

    t = _train(pkg)
    result = t.DataParallelTrainer(
        train_fn, scaling_config=_scaling(pkg, num_workers=1),
        run_config=_run_config(pkg, "t3", tmp, failure_config=t.FailureConfig(
            max_failures=1))).fit()
    return {"error": result.error, "history": result.metrics_history,
            "latest": os.path.basename(result.checkpoint.path)}


def failures_run_out(pkg, tmp):
    def train_fn(config):
        train = importlib.import_module(f"{pkg}.train")
        train.report({"attempt": 1})
        raise ValueError("always fails")

    t = _train(pkg)
    result = t.DataParallelTrainer(
        train_fn, scaling_config=_scaling(pkg, num_workers=1),
        run_config=_run_config(pkg, "t4", tmp, failure_config=t.FailureConfig(
            max_failures=1))).fit()
    err = result.error
    return {"error_type": type(err).__name__,
            "error_names_cause": "always fails" in str(err),
            "history": result.metrics_history, "metrics": result.metrics}


def broadcast_and_barrier(pkg, tmp):
    def train_fn(config):
        train = importlib.import_module(f"{pkg}.train")
        train_col = importlib.import_module(f"{pkg}.train.collective")
        ctx = train.get_context()
        value = {"payload": 42} if ctx.get_world_rank() == 0 else None
        got = train_col.broadcast_from_rank_zero(value)
        train_col.barrier()
        train.report({"got": got["payload"], "rank": ctx.get_world_rank()})

    result = _train(pkg).DataParallelTrainer(
        train_fn, scaling_config=_scaling(pkg, num_workers=2,
                                          resources_per_worker={"CPU": 0.5}),
        run_config=_run_config(pkg, "t6", tmp)).fit()
    return {"error": result.error, "history": result.metrics_history}


def allreduce_gradients(pkg, tmp):
    """Each rank's tree ``rank + 1`` everywhere: the average is 1.5."""
    def train_fn(config):
        import numpy as np

        train = importlib.import_module(f"{pkg}.train")
        train_col = importlib.import_module(f"{pkg}.train.collective")
        r = train.get_context().get_world_rank()
        if pkg == "ray_tpu_torch":
            import torch

            tree = {"a": torch.full((3,), r + 1.0), "b": [torch.ones(2) * r]}
        else:
            import jax.numpy as jnp

            tree = {"a": jnp.full((3,), r + 1.0), "b": [jnp.ones(2) * r]}
        out = train_col.allreduce_gradients(tree)
        train.report({"a": np.asarray(out["a"]).tolist(),
                      "b": np.asarray(out["b"][0]).tolist()})

    result = _train(pkg).DataParallelTrainer(
        train_fn, scaling_config=_scaling(pkg, num_workers=2,
                                          resources_per_worker={"CPU": 0.5}),
        run_config=_run_config(pkg, "t6b", tmp)).fit()
    return {"error": result.error, "history": result.metrics_history}


class _Splittable:
    """A dataset that offers only ``split``: materialized pieces."""

    def __init__(self, rows):
        self.rows = list(rows)

    def split(self, n):
        return [self.rows[i::n] for i in range(n)]


def split_and_replicated_datasets(pkg, tmp):
    def train_fn(config):
        train = importlib.import_module(f"{pkg}.train")
        train.report({"rank": train.get_context().get_world_rank(),
                      "piece": train.get_dataset_shard("train"),
                      "same": train.get_dataset_shard("table")})

    result = _train(pkg).DataParallelTrainer(
        train_fn, scaling_config=_scaling(pkg, num_workers=2,
                                          resources_per_worker={"CPU": 0.5}),
        run_config=_run_config(pkg, "ds", tmp),
        datasets={"train": _Splittable(range(10)), "table": {"k": [1, 2]}},
    ).fit()
    return {"error": result.error, "history": result.metrics_history}


def elastic_policy_sizes_gang(pkg, tmp):
    t = _train(pkg)
    policy = t.ElasticScalingPolicy(min_workers=1, max_workers=8,
                                    workers_per_slice=1,
                                    resources_per_worker={"CPU": 1.0})

    def loop(config):
        train = importlib.import_module(f"{pkg}.train")
        train.report({"world_size": train.get_context().get_world_size()})

    trainer = (t.TorchTrainer if pkg == "ray_tpu_torch" else t.JaxTrainer)(
        loop, scaling_config=_scaling(pkg, num_workers=16),
        run_config=_run_config(pkg, "elastic", tmp), scaling_policy=policy)
    result = trainer.fit()
    return {"error": result.error, "metrics": result.metrics}


def goodput_ledger(pkg, tmp):
    def loop(config):
        train = importlib.import_module(f"{pkg}.train")
        for i in range(2):
            train.report({"i": i})

    trainer = _train(pkg).DataParallelTrainer(
        loop, scaling_config=_scaling(pkg, num_workers=1),
        run_config=_run_config(pkg, "gp", tmp))
    t0 = time.monotonic()
    result = trainer.fit()
    wall = time.monotonic() - t0
    snap = trainer.goodput_ledger.snapshot()
    return {"error": result.error, "buckets": sorted(snap["buckets_s"]),
            "sums_to_wall": abs(sum(snap["buckets_s"].values())
                                - snap["wall_clock_s"]) < 1e-6,
            "within_fit": snap["wall_clock_s"] <= wall}


def _v2_loop(pkg):
    def loop(config):
        train = importlib.import_module(f"{pkg}.train")
        for step in range(3):
            train.report({"step": step, "loss": 1.0 / (step + 1)})
    return loop


def _v2(pkg):
    v2 = importlib.import_module(f"{pkg}.train.v2")
    return v2.TorchTrainer if pkg == "ray_tpu_torch" else v2.JaxTrainer


def v2_fit_in_controller(pkg, tmp):
    result = _v2(pkg)(_v2_loop(pkg), scaling_config=_scaling(pkg, num_workers=2),
                      run_config=_run_config(pkg, "v2a", tmp)).fit()
    return {"error": result.error, "history": result.metrics_history}


def v2_fit_async_status(pkg, tmp):
    handle = _v2(pkg)(_v2_loop(pkg), scaling_config=_scaling(pkg, num_workers=1),
                      run_config=_run_config(pkg, "v2b", tmp)).fit_async()
    first = handle.status()["state"] in ("RUNNING", "FINISHED")
    result = handle.result(timeout=120)
    st = handle.status()
    return {"error": result.error, "first": first, "state": st["state"],
            "iterations": st["iterations"], "latest": st["latest_metrics"]}


def v2_detached_attach(pkg, tmp):
    name = f"train-v2-ctl-{pkg}"
    handle = _v2(pkg)(_v2_loop(pkg), detached_name=name,
                      scaling_config=_scaling(pkg, num_workers=1),
                      run_config=_run_config(pkg, "v2c", tmp)).fit_async()
    del handle
    attached = _v2(pkg).attach(name)
    result = attached.result(timeout=120)
    rt = importlib.import_module(pkg)
    rt.kill(attached._actor)
    return {"error": result.error, "metrics": result.metrics}


SCENARIOS = {
    "basic_fit": basic_fit,
    "loop_config_and_ranks": loop_config_and_ranks,
    "keep_top_k_max": _keep_top_k("max"),
    "keep_top_k_min": _keep_top_k("min"),
    "failure_resumes_from_checkpoint": failure_resumes_from_checkpoint,
    "failures_run_out": failures_run_out,
    "broadcast_and_barrier": broadcast_and_barrier,
    "allreduce_gradients": allreduce_gradients,
    "split_and_replicated_datasets": split_and_replicated_datasets,
    "elastic_policy_sizes_gang": elastic_policy_sizes_gang,
    "goodput_ledger": goodput_ledger,
    "v2_fit_in_controller": v2_fit_in_controller,
    "v2_fit_async_status": v2_fit_async_status,
    "v2_detached_attach": v2_detached_attach,
}

# what the reference's own tests assert, held on the port's result
EXPECTED = {
    "basic_fit": lambda o: (o["metrics"]["step"] == 2
                            and o["metrics"]["world"] == 2
                            and len(o["history"]) == 3),
    "loop_config_and_ranks": lambda o: (o["history"][0]["lr"] == 0.1
                                        and o["history"][0]["node_rank"] == 0),
    "keep_top_k_max": lambda o: (len(o["kept"]) == 2
                                 and o["texts"] == ["step=2", "step=3"]),
    "keep_top_k_min": lambda o: o["texts"] == ["step=0", "step=1"],
    "failure_resumes_from_checkpoint": lambda o: (
        [m["step"] for m in o["history"]] == [0, 1, 2]),
    "failures_run_out": lambda o: (o["error_names_cause"]
                                   and len(o["history"]) == 2),
    "broadcast_and_barrier": lambda o: o["history"][0]["got"] == 42,
    "allreduce_gradients": lambda o: (o["history"][0]["a"] == [1.5] * 3
                                      and o["history"][0]["b"] == [0.5] * 2),
    "split_and_replicated_datasets": lambda o: (
        o["history"][0]["piece"] == [0, 2, 4, 6, 8]
        and o["history"][0]["same"] == {"k": [1, 2]}),
    "elastic_policy_sizes_gang": lambda o: 1 <= o["metrics"]["world_size"] <= 4,
    "goodput_ledger": lambda o: o["sums_to_wall"] and o["within_fit"],
    "v2_fit_in_controller": lambda o: (o["history"][-1]["step"] == 2
                                       and len(o["history"]) == 3),
    "v2_fit_async_status": lambda o: (o["first"] and o["state"] == "FINISHED"
                                      and o["iterations"] == 3),
    "v2_detached_attach": lambda o: o["metrics"]["step"] == 2,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_reports_what_the_jax_trainer_reports(runtimes, tmp_path,
                                                       name):
    got = {}
    for side, pkg in RUNTIMES.items():
        d = tmp_path / side
        d.mkdir()
        got[side] = SCENARIOS[name](pkg, d)
    assert got["torch"].get("error") is None, got["torch"]["error"]
    assert got["torch"] == got["jax"]
    assert EXPECTED[name](got["torch"]), got["torch"]


def test_failure_policy_decisions_match():
    from ray_tpu.train import DefaultFailurePolicy as J
    from ray_tpu_torch.train import DefaultFailurePolicy as T

    for n in (0, 2, -1):
        for count in (1, 2, 3, 99):
            assert (T(max_failures=n).make_decision(count, RuntimeError())
                    == J(max_failures=n).make_decision(count, RuntimeError()))


def test_exports_are_the_references_with_the_torch_pair():
    import ray_tpu.train as jt
    import ray_tpu_torch.train as tt

    assert set(tt.__all__) == ((set(jt.__all__) - {"JaxTrainer", "JaxConfig"})
                               | {"TorchTrainer", "TorchConfig"})
    for name in tt.__all__:
        assert getattr(tt, name) is not None
    assert tt.ScalingConfig().use_gpu is True
    assert tt.ScalingConfig(chips_per_worker=2).worker_resources() == {
        "CPU": 1.0, "GPU": 2.0}
    assert "GPU" not in tt.ScalingConfig(use_gpu=False).worker_resources()


# -- the port's refusals --------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(use_tpu=True), dict(topology="4x4"),
                                dict(tpu_slice="v5p-8")])
def test_tpu_settings_refuse(kw):
    from ray_tpu_torch.train import ScalingConfig

    with pytest.raises(ValueError, match="the port has no TPU"):
        ScalingConfig(**kw)


def test_multislice_refuses():
    from ray_tpu_torch.train import TorchConfig

    with pytest.raises(ValueError, match="megascale"):
        TorchConfig(multislice=True)


def test_uri_storage_refuses(runtimes):
    from ray_tpu_torch.train import Checkpoint, RunConfig, TorchTrainer

    trainer = TorchTrainer(lambda: None, scaling_config=_scaling(
        "ray_tpu_torch", num_workers=1),
        run_config=RunConfig(name="fs", storage_path="memory://ckpts"))
    with pytest.raises(ValueError, match="remote storage .fsspec. is not ported"):
        trainer.fit()
    with pytest.raises(ValueError, match="remote storage"):
        Checkpoint("gs://bucket/ckpt")


def test_a_shard_with_iter_batches_refuses(runtimes, tmp_path):
    """The port refused such a shard until it had the data layer (the name
    is kept from then): the session now wraps it in the ingest DataShard,
    once per name, and the rest passes through to the shard."""
    from ray_tpu_torch import train

    class Batches:
        label = "mine"

        def iter_batches(self, **kw):
            yield from ()

    def loop(config):
        from ray_tpu_torch import train

        shard = train.get_dataset_shard("train")
        train.report({"type": type(shard).__name__, "label": shard.label,
                      "again": shard is train.get_dataset_shard("train")})

    result = train.TorchTrainer(
        loop, scaling_config=_scaling("ray_tpu_torch", num_workers=1),
        run_config=_run_config("ray_tpu_torch", "it", tmp_path),
        datasets={"train": Batches()}).fit()
    assert result.error is None, result.error
    m = result.metrics_history[-1]
    assert (m["type"], m["label"], m["again"]) == ("DataShard", "mine", True)


def test_a_streaming_dataset_refuses(runtimes, tmp_path):
    """The port refused a dataset with streaming_split until it had the
    data layer (the name is kept from then): the trainer now splits it as
    the JAX package's does, one consumer a worker, the coordinator's idle
    window 3600 s."""
    from ray_tpu_torch import train

    calls = []

    class Streaming:
        def streaming_split(self, n, **kw):
            calls.append((n, kw))
            return [f"piece {i}" for i in range(n)]

    trainer = train.TorchTrainer(
        lambda: None, scaling_config=_scaling("ray_tpu_torch", num_workers=2),
        run_config=_run_config("ray_tpu_torch", "st", tmp_path),
        datasets={"train": Streaming()})
    shards = trainer._shard_datasets(2)
    assert calls == [(2, {"equal": True, "idle_timeout_s": 3600.0})]
    assert shards == [{"train": "piece 0"}, {"train": "piece 1"}]


# -- a gang of two over gloo: the mesh from the backend ---------------------------

B, S, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5  # tests/test_torch_train_mesh.py


def _make_mesh_loop():
    # made in a function, so it travels by value (workers cannot import
    # this module)
    def mesh_loop(config):
        """Each rank: MeshSpec(data=world) over the gang's store, tiny Llama
        from the same seed, ``STEPS`` steps on the global batch; the ranks
        then save one DTensor's shards.  ``unsynced_rank`` keeps that rank's
        own gradient (the peers still get its part)."""
        import numpy as np
        import torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor

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
        if config.get("unsynced_rank") == rank:
            group = mesh.axis_group("data")
            reduce = group.allreduce_

            def allreduce_(t, op="sum"):
                reduce(t.clone(), op)
                return t
            group.allreduce_ = allreduce_
        cfg = llama.LlamaConfig.tiny()
        init_fn, step_fn = make_train_step(cfg, mesh, device="cpu")
        state = init_fn(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(config["tokens"])
        for _ in range(config["steps"]):
            state, m = step_fn(state, tokens)
            train.report({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]), "rank": rank})
        if config.get("save_to"):
            from ray_tpu_torch.train import save_sharded

            full = torch.arange(24.0).reshape(8, 3)
            dm = init_device_mesh("cpu", (world,))
            save_sharded({"w": distribute_tensor(full, dm, [Shard(0)]),
                          "step": state.step}, config["save_to"])


    return mesh_loop


def _tokens():
    return np.random.default_rng(11).integers(0, 256, (B, S)).astype(np.int32)


def _gang(tmp_path, name, **config):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    return TorchTrainer(
        _make_mesh_loop(), train_loop_config=dict(tokens=_tokens(), steps=STEPS,
                                           **config),
        torch_config=TorchConfig(backend="gloo"),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name=name, storage_path=str(tmp_path))).fit()


@pytest.fixture(scope="module")
def world1():
    """The mesh-free step on the global batch: (loss, grad_norm) per step."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import make_train_step

    init_fn, step_fn = make_train_step(llama.LlamaConfig.tiny(), device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    out = []
    for _ in range(STEPS):
        state, m = step_fn(state, torch.from_numpy(_tokens()))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _ratio(history, ref):
    """The largest relative difference of (loss, grad_norm) over the steps,
    in units of LOSS_RTOL."""
    got = [(h["loss"], h["grad_norm"]) for h in history]
    assert len(got) == len(ref)
    return max(abs(g - w) / abs(w) / LOSS_RTOL
               for gs, ws in zip(got, ref) for g, w in zip(gs, ws))


def test_a_gang_of_two_trains_data_parallel_on_the_backends_mesh(
        runtimes, tmp_path, world1):
    from ray_tpu_torch.train import restore_sharded

    path = str(tmp_path / "sharded")
    result = _gang(tmp_path, "mesh", save_to=path)
    assert result.error is None, result.error
    assert _ratio(result.metrics_history, world1) <= 1.0
    # the two ranks' shards come back whole in one process, with no group
    flat = restore_sharded(path)
    torch.testing.assert_close(flat["w"], torch.arange(24.0).reshape(8, 3),
                               rtol=0, atol=0)
    assert int(flat["step"]) == STEPS
    target = {"w": torch.zeros(8, 3), "step": torch.zeros((), dtype=torch.int32)}
    back = restore_sharded(path, target=target)
    assert back["w"] is target["w"] and float(back["w"][7, 2]) == 23.0


def test_the_unsynced_control_breaks_the_gangs_tolerance(runtimes, tmp_path,
                                                          world1):
    result = _gang(tmp_path, "unsynced", unsynced_rank=1)
    assert result.error is None, result.error
    assert _ratio(result.metrics_history, world1) > 1.0


def test_save_sharded_round_trip_in_one_process(tmp_path):
    """The port's format only: orbax's checkpoints are not readable here."""
    from ray_tpu_torch.parallel import make_train_step
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import restore_sharded, save_sharded

    init_fn, _ = make_train_step(llama.LlamaConfig.tiny(), device="cpu")
    state = init_fn(torch.Generator().manual_seed(3))
    path = save_sharded(state, str(tmp_path / "s"))
    with pytest.raises(FileExistsError):
        save_sharded(state, path, force=False)
    fresh = init_fn(torch.Generator().manual_seed(4))
    back = restore_sharded(path, target=fresh)
    from ray_tpu_torch._private.tree import tree_leaves_with_keys

    want = dict(tree_leaves_with_keys(state))
    got = dict(tree_leaves_with_keys(back))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    flat = restore_sharded(path)
    assert sorted(flat) == sorted(want)
