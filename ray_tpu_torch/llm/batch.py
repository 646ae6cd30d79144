"""Batch LLM inference over datasets: Processor + stages.

reference: python/ray/llm/_internal/batch/processor/ + stages/ — a
Processor turns a Dataset through preprocess -> engine inference ->
postprocess stages, with the engine stage running on an autoscaling actor
pool (one engine per actor, its card bound through the "GPU" resource that
``LLMConfig.resources_per_replica`` asks for).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.llm.config import GenerationConfig, LLMConfig


@dataclasses.dataclass
class ProcessorConfig:
    """reference analog: batch/processor config (concurrency + batch size).

    ``device``: where each engine actor serves (None: the card its lease
    binds; ``"cpu"`` asks for no GPU, as the tests do).  The JAX package's
    config has no such field: its engines take the accelerator JAX sees."""

    llm_config: LLMConfig = None
    batch_size: int = 8
    concurrency: int = 1
    max_new_tokens: int = 32
    temperature: float = 0.0
    device: Optional[str] = None


class _EngineStage:
    """Actor-pool stage: owns one engine (``make_engine``), maps prompt
    batches.  Its weights come from ``weights``: None draws them at random
    from seed 0, as the JAX package's stage draws ``init_params(cfg,
    PRNGKey(0))``; a subclass that loads real weights overrides it (and
    goes in ``Processor.engine_stage``)."""

    def __init__(self, llm_config: LLMConfig, max_new_tokens: int,
                 temperature: float, device: Optional[str] = None):
        from ray_tpu_torch.llm.engine import make_engine

        self._engine = make_engine(llm_config,
                                   self.weights(llm_config, device),
                                   device=device)
        self._gen = GenerationConfig(max_new_tokens=max_new_tokens,
                                     temperature=temperature)

    def weights(self, llm_config: LLMConfig, device: Optional[str]):
        """The engine's params (None: random from seed 0)."""
        return None

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        prompts = [list(p) for p in batch["prompt_tokens"]]
        outs = self._engine.generate(prompts, self._gen)
        out = dict(batch)
        out["generated_tokens"] = outs
        return out


class Processor:
    """``processor(dataset) -> dataset`` (reference: batch/processor/base).

    Stages: optional row-wise preprocess -> engine map_batches on an actor
    pool -> optional row-wise postprocess.  ``engine_stage`` is the actor
    pool's callable class.
    """

    engine_stage = _EngineStage

    def __init__(self, config: ProcessorConfig,
                 preprocess: Optional[Callable[[dict], dict]] = None,
                 postprocess: Optional[Callable[[dict], dict]] = None):
        if config.llm_config is None:
            raise ValueError("ProcessorConfig.llm_config is required")
        self.config = config
        self.preprocess = preprocess
        self.postprocess = postprocess

    def __call__(self, dataset):
        from ray_tpu_torch.data.dataset import ActorPoolStrategy

        ds = dataset
        if self.preprocess is not None:
            ds = ds.map(self.preprocess)
        ds = ds.map_batches(
            self.engine_stage,
            batch_size=self.config.batch_size,
            batch_format="pydict",
            compute=ActorPoolStrategy(size=self.config.concurrency),
            fn_constructor_args=(self.config.llm_config,
                                 self.config.max_new_tokens,
                                 self.config.temperature,
                                 self.config.device),
            resources=self.config.llm_config.resources_per_replica(
                self.config.device),
        )
        if self.postprocess is not None:
            ds = ds.map(self.postprocess)
        return ds


def build_llm_processor(config: ProcessorConfig,
                        preprocess: Optional[Callable] = None,
                        postprocess: Optional[Callable] = None) -> Processor:
    """reference: ray.data.llm.build_llm_processor."""
    return Processor(config, preprocess, postprocess)
