"""The slice as a whole: tiny Llama trained through the JAX package's
JaxTrainer and through the port's TorchTrainer, with a failure and a
restore from a step snapshot, on the CPU.

``LlamaConfig.tiny()`` at fp32 (the JAX package's snapshots cannot hold a
bf16 state: ROADMAP C5), the same weights (the JAX step's initial state,
carried over by ``convert.train_state_from_jax``), one token batch, four
steps.  Each loop reports ``loss``, ``grad_norm`` and ``model_flops`` at
every step and passes ``state=`` at step 2; on its first attempt it raises
once step 2's snapshot has committed, and on the second it resumes from
``train.restore_state()``.  The two trainers' histories must hold the same
steps (1, 2, then 3, 4 after the restore), losses within 1e-5 and grad
norms within 1e-5 relative (``tests/test_torch_train_step.py``'s
tolerances), and the restart must resume at step 3, from step 2's
snapshot; a one-step-stale restore is the control.  Both runtimes run in
this process (``ray_tpu.init``, then ``ray_tpu_torch.init``, in a module
fixture).
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import llama as jl
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

B, S, STEPS, SNAP = 2, 64, 4, 2


def _tokens():
    return np.random.default_rng(4).integers(0, 256, (B, S)).astype(np.int32)


def _make_loop(pkg):
    """The train loop for ``pkg`` (made in a function: it travels by value,
    and workers cannot import this module).  It snapshots the state at
    steps 1 and 2; ``stale`` (the control) resumes from step 1's snapshot
    with the step counter at 2."""
    def loop(config):
        import importlib
        import os
        import time

        train = importlib.import_module(f"{pkg}.train")
        snapshot = importlib.import_module(f"{pkg}.train._internal.snapshot")
        tokens = config["tokens"]
        if pkg == "ray_tpu":
            import jax
            import jax.numpy as jnp

            from ray_tpu.models.llama import LlamaConfig
            from ray_tpu.parallel import make_train_step

            init_fn, step_fn = make_train_step(LlamaConfig.tiny())
            state = init_fn(jax.random.PRNGKey(0))
            tokens = jnp.asarray(tokens)
        else:
            import torch

            from ray_tpu_torch.models.llama import LlamaConfig
            from ray_tpu_torch.parallel import make_train_step

            torch.set_num_threads(1)
            _, step_fn = make_train_step(LlamaConfig.tiny(), device="cpu")
            state = config["state"]
            tokens = torch.from_numpy(tokens)
        run_dir = train.get_context().get_storage_path()
        restored = train.restore_state(target=state)
        start = 0
        if restored is not None:
            if pkg == "ray_tpu":
                # the JAX package's restore gives a scalar leaf back as [1]
                state = jax.tree.map(lambda r, t: r.reshape(t.shape),
                                     restored[0], state)
            else:
                state = restored[0]
            start = int(state.step)
            if config.get("stale"):
                state = snapshot.restore_snapshot(
                    os.path.join(run_dir, snapshot.snapshot_dir_name(1)),
                    target=state)
                state.step.fill_(start)
        for i in range(start, config["steps"]):
            state, m = step_fn(state, tokens)
            step = i + 1
            train.report({"step": step, "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "model_flops": config["model_flops"]},
                         state=state if step <= config["snap"] else None)
            if step == config["snap"] and restored is None:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    latest = snapshot.latest_committed(run_dir)
                    if (latest is not None and snapshot.load_manifest(
                            latest)["step"] == config["snap"]):
                        break
                    time.sleep(0.02)
                raise RuntimeError(f"injected failure after step {step}")
    return loop


@pytest.fixture(scope="module")
def runtimes():
    os.environ.setdefault("RAY_TPU_NUM_CHIPS", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ray_tpu.init(num_cpus=2)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _fit(pkg, tmp, **extra):
    import importlib

    train = importlib.import_module(f"{pkg}.train")
    config = dict(tokens=_tokens(), steps=STEPS, snap=SNAP,
                  model_flops=6.0 * B * S * 1e6, **extra)
    kw = {}
    if pkg == "ray_tpu_torch":
        jstate = jax_make_train_step(jl.LlamaConfig.tiny())[0](
            jax.random.PRNGKey(0))
        config["state"] = convert.train_state_from_jax(
            jax.tree.map(np.asarray, jstate), tl.LlamaConfig.tiny(),
            device="cpu")
        kw["use_gpu"] = False
        trainer_cls = train.TorchTrainer
    else:
        trainer_cls = train.JaxTrainer
    trainer = trainer_cls(
        _make_loop(pkg), train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1, **kw),
        run_config=train.RunConfig(
            name="llama", storage_path=str(tmp),
            failure_config=train.FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None, result.error
    return result, trainer


@pytest.fixture(scope="module")
def fits(runtimes, tmp_path_factory):
    """{side: (Result, trainer)}: the JAX package's and the port's runs."""
    return {side: _fit(pkg, tmp_path_factory.mktemp(side))
            for side, pkg in (("jax", "ray_tpu"), ("torch", "ray_tpu_torch"))}


def _steps(result):
    return [m["step"] for m in result.metrics_history if "step" in m]


def test_both_trainers_resume_at_step_3_from_step_2s_snapshot(fits):
    for side, (result, _) in fits.items():
        assert _steps(result) == [1, 2, 3, 4], side
        assert os.path.basename(result.checkpoint.path) == "checkpoint_000002"
        assert result.metrics["step"] == STEPS
    assert (_steps(fits["torch"][0]) == _steps(fits["jax"][0]))


def _ratio(got, want):
    """The largest difference over the steps in units of the tolerance:
    loss 1e-5 absolute, grad norm 1e-5 relative."""
    worst = 0.0
    for g, w in zip(got.metrics_history, want.metrics_history):
        worst = max(worst, abs(g["loss"] - w["loss"]) / 1e-5,
                    abs(g["grad_norm"] - w["grad_norm"])
                    / abs(w["grad_norm"]) / 1e-5)
    return worst


def test_losses_and_grad_norms_match_the_jax_trainer(fits):
    assert _ratio(fits["torch"][0], fits["jax"][0]) <= 1.0
    losses = [m["loss"] for m in fits["torch"][0].metrics_history]
    assert losses[-1] < losses[0]


def test_a_one_step_stale_restore_breaks_the_tolerance(runtimes, fits,
                                                        tmp_path):
    stale, _ = _fit("ray_tpu_torch", tmp_path, stale=True)
    assert _steps(stale) == [1, 2, 3, 4]
    assert _ratio(stale, fits["jax"][0]) > 1.0


def test_the_goodput_buckets_sum_to_the_wall_clock(fits):
    for side, (_, trainer) in fits.items():
        snap = trainer.goodput_ledger.snapshot()
        assert sum(snap["buckets_s"].values()) == pytest.approx(
            snap["wall_clock_s"]), side
        assert snap["buckets_s"]["restore"] > 0
        assert snap["buckets_s"]["productive_step"] > 0
