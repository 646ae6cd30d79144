"""ray_tpu_torch.train — gang training on NVIDIA cards (or the CPU).

reference: python/ray/train/ (SURVEY §2.3, §3.4). The TorchTrainer (the
JAX package's JaxTrainer) brings a gang of one-worker-per-card actors up
with a torch.distributed process group, runs the user train loop on each,
pumps ``report()`` results back, persists checkpoints and step snapshots,
and restarts the whole gang on failure.  TorchConfig is JaxConfig's
counterpart.
"""

from ray_tpu_torch.train._checkpoint import Checkpoint, restore_sharded, save_sharded
from ray_tpu_torch.train._internal.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
    restore_state,
)
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.policies import (
    DefaultFailurePolicy,
    ElasticScalingPolicy,
    FailureDecision,
    FailurePolicy,
    FixedScalingPolicy,
    ScalingDecision,
    ScalingPolicy,
)
from ray_tpu_torch.train.trainer import DataParallelTrainer, Result, TorchTrainer

__all__ = [
    "Checkpoint",
    "save_sharded",
    "restore_sharded",
    "report",
    "restore_state",
    "get_context",
    "get_checkpoint",
    "get_dataset_shard",
    "TrainContext",
    "Backend",
    "BackendConfig",
    "TorchConfig",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "DataParallelTrainer",
    "TorchTrainer",
    "Result",
    "FailurePolicy",
    "DefaultFailurePolicy",
    "FailureDecision",
    "ScalingPolicy",
    "ScalingDecision",
    "FixedScalingPolicy",
    "ElasticScalingPolicy",
]
