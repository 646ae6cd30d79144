"""Elastic regrow mid-run (``tests/test_train.py``'s last scenario) on the
JAX package's trainer and on the port's, one after the other in this
process, each on its own two-node cluster: a gang started at one worker
on a full one-CPU head checkpoints and regrows to two when a node joins,
resuming from its last checkpoint, not from iteration 0.  The iterations
are shorter than the reference test's (0.5 s, ten of them, the policy
polled every 0.5 s), and the node joins once the one-worker gang has
persisted its first checkpoint (the reference waits 6 s)."""

import importlib
import os
import threading
import time

import pytest

pytestmark = pytest.mark.timeout(240)

ITERS = 10


def _loop(pkg):
    # made in a function, so it travels by value
    def loop(config):
        import json as js
        import os as _os
        import tempfile
        import time as _t

        train = importlib.import_module(f"{pkg}.train")
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            with open(_os.path.join(ckpt.path, "it.json")) as f:
                start = js.load(f)["i"] + 1
        ctx = train.get_context()
        ws = ctx.get_world_size()
        for i in range(start, ITERS):
            _t.sleep(0.5)
            d = tempfile.mkdtemp()
            with open(_os.path.join(d, "it.json"), "w") as f:
                js.dump({"i": i}, f)
            train.report({"iter": i, "world_size": ws},
                         checkpoint=train.Checkpoint.from_directory(d)
                         if ctx.get_world_rank() == 0 else None)
    return loop


def _regrow(pkg, tmp_path):
    rt = importlib.import_module(pkg)
    train = importlib.import_module(f"{pkg}.train")
    cluster = importlib.import_module(f"{pkg}.cluster_utils").Cluster(
        head_node_args={"num_cpus": 1})
    try:
        cluster.connect_driver()
        policy = train.ElasticScalingPolicy(min_workers=1, max_workers=2,
                                            workers_per_slice=1,
                                            resources_per_worker={"CPU": 1.0})
        policy.growth_poll_interval_s = 0.5
        kw = {"use_gpu": False} if pkg == "ray_tpu_torch" else {}
        trainer_cls = (train.TorchTrainer if pkg == "ray_tpu_torch"
                       else train.JaxTrainer)
        first = tmp_path / pkg / "regrow" / "checkpoint_000001"
        done = threading.Event()

        def add_node_after_the_first_checkpoint():
            deadline = time.monotonic() + 60
            while not first.is_dir() and time.monotonic() < deadline:
                if done.wait(0.05):
                    return
            cluster.add_node(num_cpus=1)

        adder = threading.Thread(target=add_node_after_the_first_checkpoint)
        adder.start()
        try:
            result = trainer_cls(
                _loop(pkg),
                scaling_config=train.ScalingConfig(num_workers=2, **kw),
                run_config=train.RunConfig(name="regrow",
                                           storage_path=str(tmp_path / pkg)),
                scaling_policy=policy).fit()
        finally:
            done.set()
            adder.join(30)
    finally:
        cluster.shutdown()
        if rt.is_initialized():
            rt.shutdown()
    return result


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_a_gang_regrows_mid_run_from_its_checkpoint(pkg, tmp_path):
    os.environ.setdefault("RAY_TPU_NUM_CHIPS", "0")
    result = _regrow(pkg, tmp_path)
    assert result.error is None, result.error
    sizes = [m["world_size"] for m in result.metrics_history]
    iters = [m["iter"] for m in result.metrics_history]
    assert sizes[0] == 1, sizes  # started shrunk to what fit
    assert result.metrics["world_size"] == 2, sizes  # regrew mid-run
    first_regrown = sizes.index(2)
    assert iters[first_regrown] > 0, iters  # resumed, not restarted
    assert iters[-1] == ITERS - 1
