"""Channels (reference: python/ray/experimental/channel/): the shared-memory
slot channel and the CUDA tensor channel."""

from ray_tpu_torch.experimental.channel.accelerator_context import (
    get_accelerator_context,
    register_accelerator_context,
    set_accelerator_context,
)
from ray_tpu_torch.experimental.channel.communicator import (
    CollectiveGroupCommunicator,
    Communicator,
)
from ray_tpu_torch.experimental.channel.cuda_tensor_channel import (
    CudaTensorChannel,
)
from ray_tpu_torch.experimental.channel.shared_memory_channel import (
    ChannelClosed,
    ChannelFull,
    IntraProcessChannel,
    ShmChannel,
)

__all__ = [
    "ChannelClosed",
    "ChannelFull",
    "IntraProcessChannel",
    "ShmChannel",
    "CudaTensorChannel",
    "Communicator",
    "CollectiveGroupCommunicator",
    "get_accelerator_context",
    "register_accelerator_context",
    "set_accelerator_context",
]
