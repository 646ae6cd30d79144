"""The port's runtime core on the card: the H100 as the ``GPU`` resource.

- the node finds the card without initialising CUDA in the raylet, and a
  ``num_gpus=1`` actor sees exactly the card its lease bound;
- a CUDA tensor goes driver -> actor -> driver through the object store
  bit for bit, rebuilt on each reader's card;
- a reader with no card refuses a CUDA tensor;
- a ``build_llm_deployment`` replica at Llama-3-8B's width, 2 layers,
  holds the card as ``GPU`` 1 and answers over HTTP with the tokens of
  the driver's own server over the same seed-0 weights; two replicas at
  ``chips_per_replica=0.5`` share the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch, numpy and ray_tpu_torch, so it runs
where JAX is not installed (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_runtime.py
"""

import json
import os
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private.accelerators.nvidia_gpu import (
    NvidiaGPUAcceleratorManager,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GPU resource is the card")
    # no TPU probing (the TPU manager would ask the GCE metadata server for
    # a slice's name) and quiet workers, as the repo's conftest has it
    os.environ["RAY_TPU_NUM_CHIPS"] = "0"
    os.environ["RAY_TPU_DISABLE_METADATA_SERVER"] = "1"
    os.environ.setdefault("RAY_TPU_WORKER_QUIET", "1")
    rt.init(num_cpus=2, num_gpus=1)
    try:
        yield
    finally:
        rt.shutdown()


@rt.remote(num_gpus=1, num_cpus=0)
class _OnCard:
    def seen(self):
        return (os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids(),
                torch.cuda.device_count())

    def round_trip(self, refs):
        x = rt.get(refs[0])
        assert x.is_cuda and x.device.index == torch.cuda.current_device()
        return x


@rt.remote(num_cpus=0)
class _NoCard:
    def read(self, refs):
        return rt.get(refs[0])

    def sees_a_card(self):
        return torch.cuda.is_available()


def test_actor_sees_its_leased_card(cluster):
    assert NvidiaGPUAcceleratorManager.get_current_node_num_accelerators() >= 1
    assert rt.cluster_resources()["GPU"] == 1
    a = _OnCard.remote()
    assert rt.get(a.seen.remote(), timeout=120) == ("0", [0], 1)
    rt.kill(a)


def test_cuda_tensor_round_trips_bit_for_bit(cluster):
    x = torch.randn(1 << 22, device="cuda").to(torch.bfloat16)
    x[:3] = float("nan")
    a = _OnCard.remote()
    y = rt.get(a.round_trip.remote([rt.put(x)]), timeout=120)
    assert y.is_cuda and y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    rt.kill(a)


def test_reader_without_a_card_refuses_a_cuda_tensor(cluster):
    b = _NoCard.options(
        runtime_env={"env_vars": {"CUDA_VISIBLE_DEVICES": ""}}).remote()
    assert rt.get(b.sees_a_card.remote(), timeout=120) is False
    with pytest.raises(Exception, match="no CUDA device"):
        rt.get(b.read.remote([rt.put(torch.ones(8, device="cuda"))]),
               timeout=120)
    rt.kill(b)


def _llm_config(**kw):
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(n_layers=2, param_dtype=torch.bfloat16,
                                      compute_dtype=torch.bfloat16)
    return LLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=512,
                     num_blocks=64, **kw)


def _wait_for(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


@pytest.mark.timeout(600)
def test_llm_deployment_holds_the_card_and_answers_over_http(cluster):
    from ray_tpu_torch.llm import LLMServer, build_llm_deployment

    conf = _llm_config()
    handle = serve.run(build_llm_deployment(conf), name="llm",
                       route_prefix="/llm")
    mine = None
    try:
        _wait_for(lambda: rt.available_resources().get("GPU", 0.0) == 0,
                  "the replica's GPU held")
        assert len(serve.status()["llm"]["replicas"]) == 1
        mine = LLMServer(conf)  # seed-0 weights, as the replica's
        # two prompts neither server has seen (a cached prefix changes the
        # prefill's arithmetic, and random weights have near-ties)
        a, b = torch.randint(1, 128000, (2, 37),
                             generator=torch.Generator().manual_seed(3)
                             ).tolist()
        assert handle.generate.remote(a, max_new_tokens=16).result(
            timeout_s=300) == mine.generate(a, max_new_tokens=16)
        host, port = serve.start_http_proxy(port=0)
        req = urllib.request.Request(
            f"http://{host}:{port}/llm",
            data=json.dumps({"prompt": b, "max_new_tokens": 16}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            got = json.loads(resp.read())
        assert got == {"tokens": mine.generate(b, max_new_tokens=16)}
    finally:
        if mine is not None:
            mine.shutdown()
        serve.shutdown()
    _wait_for(lambda: rt.available_resources().get("GPU") == 1,
              "the card back")


@pytest.mark.timeout(600)
def test_two_half_card_replicas_share_the_card(cluster):
    from ray_tpu_torch.llm import build_llm_deployment

    conf = _llm_config(num_replicas=2, chips_per_replica=0.5)
    assert conf.resources_per_replica() == {"CPU": 1.0, "GPU": 0.5}
    handle = serve.run(build_llm_deployment(conf), name="halves")
    try:
        _wait_for(lambda: len(serve.status()["halves"]["replicas"]) == 2,
                  "two replicas")
        _wait_for(lambda: rt.available_resources().get("GPU", 0.0) == 0,
                  "both halves held")
        outs = [handle.generate.remote([1, 2, 3, 4], max_new_tokens=4)
                for _ in range(8)]
        assert len({tuple(r.result(timeout_s=300)) for r in outs}) == 1
    finally:
        serve.shutdown()
    _wait_for(lambda: rt.available_resources().get("GPU") == 1,
              "the card back")
