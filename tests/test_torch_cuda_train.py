"""The port's trainer on the card: ``TorchTrainer`` with one worker.

A small Llama (2 layers, head_dim 128, bf16 params and products, so the
flash kernels B2/B3 run) trained through ``TorchTrainer`` with
``ScalingConfig(num_workers=1, use_gpu=True)``: the worker sees exactly
its card, B2/B3 launch 2 x 2 and 2 times a step there, and every loss and
grad norm it reports equals the same step run directly in this process,
bit for bit.  With a failure after step 2 and a restore from step 2's
snapshot the resumed steps are bit for bit too.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch and ray_tpu_torch, so it runs where JAX
is not installed (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_train.py
"""

import os

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import adamw, make_train_step

pytestmark = pytest.mark.cuda

SEED, B, S, STEPS = 7, 2, 256, 4


def _cfg():
    return llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=2,
                             n_kv_heads=1, ffn_dim=512, max_seq_len=S,
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)


def _optimizer():
    return adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1,
                 mu_dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trainer's worker holds the card")
    os.environ["RAY_TPU_NUM_CHIPS"] = "0"
    os.environ["RAY_TPU_DISABLE_METADATA_SERVER"] = "1"
    os.environ.setdefault("RAY_TPU_WORKER_QUIET", "1")
    rt.init(num_cpus=2, num_gpus=1)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def direct():
    """(loss, grad_norm) of STEPS steps run in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    init_fn, step_fn = make_train_step(_cfg(), device=dev, optimizer=_optimizer())
    state = init_fn(torch.Generator(device=dev).manual_seed(SEED))
    tokens = torch.randint(0, 1024, (B, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    out = []
    for _ in range(STEPS):
        state, m = step_fn(state, tokens)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    del state
    torch.cuda.empty_cache()
    return out


def _make_loop():
    # made in a function: it travels to the worker by value
    def loop(config):
        import time

        import torch

        import ray_tpu_torch
        from ray_tpu_torch import train
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.parallel import make_train_step
        from ray_tpu_torch.train._internal import snapshot

        dev = torch.device("cuda")
        init_fn, step_fn = make_train_step(config["cfg"], device=dev,
                                           optimizer=config["optimizer"])
        state = init_fn(torch.Generator(device=dev).manual_seed(config["seed"]))
        tokens = torch.randint(
            0, 1024, tuple(config["batch"]), device=dev,
            generator=torch.Generator(device=dev).manual_seed(config["seed"] + 1))
        restored = train.restore_state(target=state)
        start = 0
        if restored is not None:
            state = restored[0]
            start = int(state.step)
        for i in range(start, config["steps"]):
            f0, b0 = fa.fwd_launches, fa.bwd_launches
            state, m = step_fn(state, tokens)
            step = i + 1
            train.report({"step": step, "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "fwd": fa.fwd_launches - f0,
                          "bwd": fa.bwd_launches - b0,
                          "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                          "cuda_devices": torch.cuda.device_count()},
                         state=state if step == config.get("snap") else None)
            if step == config.get("fail") and restored is None:
                run_dir = train.get_context().get_storage_path()
                deadline = time.monotonic() + 120
                while (snapshot.latest_committed(run_dir) is None
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                raise RuntimeError(f"injected failure after step {step}")
    return loop


def _fit(tmp_path, **extra):
    result = train.TorchTrainer(
        _make_loop(),
        train_loop_config=dict(cfg=_cfg(), optimizer=_optimizer(), seed=SEED,
                               batch=(B, S), steps=STEPS, **extra),
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(
            name="card", storage_path=str(tmp_path),
            failure_config=train.FailureConfig(max_failures=1))).fit()
    assert result.error is None, result.error
    return result


def _check(result, direct, want_steps):
    steps = [m for m in result.metrics_history if "step" in m]
    assert [m["step"] for m in steps] == want_steps
    for m in steps:
        assert (m["loss"], m["grad_norm"]) == direct[m["step"] - 1], m
        assert (m["fwd"], m["bwd"]) == (4, 2), m
        assert m["gpu_ids"] == [0] and m["cuda_devices"] == 1, m


def test_a_worker_on_the_card_trains_bit_for_bit_the_direct_step(
        cluster, direct, tmp_path):
    _check(_fit(tmp_path), direct, [1, 2, 3, 4])


def test_a_restart_resumes_from_the_snapshot_bit_for_bit(cluster, direct,
                                                         tmp_path):
    result = _fit(tmp_path, snap=2, fail=2)
    _check(result, direct, [1, 2, 3, 4])
    assert os.path.basename(result.checkpoint.path) == "checkpoint_000001"
