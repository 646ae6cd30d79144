"""The port's runtime core on the card: the H100 as the ``GPU`` resource.

- the node finds the card without initialising CUDA in the raylet, and a
  ``num_gpus=1`` actor sees exactly the card its lease bound;
- a CUDA tensor goes driver -> actor -> driver through the object store
  bit for bit, rebuilt on each reader's card;
- a reader with no card refuses a CUDA tensor.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch, numpy and ray_tpu_torch, so it runs
where JAX is not installed (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_runtime.py
"""

import os

import pytest
import torch

import ray_tpu_torch as rt
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
