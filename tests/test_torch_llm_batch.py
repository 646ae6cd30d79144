"""The port's batch inference (``llm/batch.py``) against the JAX package's.

JAX's ``test_llm_batch_processor`` setup (``tests/test_llm.py``): six rows
of two-token prompts, ``LlamaConfig.tiny()``, ``batch_size=3``, one engine
actor, four new tokens, a postprocess that counts them.  The JAX stage's
engine draws ``init_params(cfg, PRNGKey(0))``; the port's stage gets the
same weights through ``convert.params_from_jax`` in a subclass of its
engine stage (``Processor.engine_stage``), which adds no field to
``ProcessorConfig``.  The port's actor serves on the CPU
(``ProcessorConfig(device="cpu")`` asks for no GPU).  Greedy tokens must
be equal per row.
"""

import os

import pytest

import ray_tpu
import ray_tpu_torch

pytestmark = pytest.mark.timeout(240)


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


ITEMS = [{"prompt_tokens": [1 + i, 2 + i]} for i in range(6)]


def _jax_rows():
    import ray_tpu.data as rdata
    from ray_tpu.llm import LLMConfig, ProcessorConfig, build_llm_processor
    from ray_tpu.models.llama import LlamaConfig

    processor = build_llm_processor(
        ProcessorConfig(
            llm_config=LLMConfig(model_config=LlamaConfig.tiny(),
                                 max_batch_size=4, max_seq_len=64,
                                 chips_per_replica=0),
            batch_size=3, concurrency=1, max_new_tokens=4),
        postprocess=lambda row: {"n": len(row["generated_tokens"]), **row})
    return processor(rdata.from_items(ITEMS)).take_all()


def _jax_weights_stage():
    # made in a function, so it travels to the actor by value
    from ray_tpu_torch.llm.batch import _EngineStage

    class JaxWeights(_EngineStage):
        def weights(self, llm_config, device):
            import jax
            import numpy as np

            from ray_tpu.models import llama as jl
            from ray_tpu_torch import convert

            params = jl.init_params(jl.LlamaConfig.tiny(),
                                    jax.random.PRNGKey(0))
            return convert.params_from_jax(
                jax.tree.map(np.asarray, params), llm_config.model_config,
                device=device)

    return JaxWeights


def _torch_rows():
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.llm import LLMConfig, Processor, ProcessorConfig
    from ray_tpu_torch.models.llama import LlamaConfig

    class JaxWeightsProcessor(Processor):
        engine_stage = _jax_weights_stage()

    config = ProcessorConfig(
        llm_config=LLMConfig(model_config=LlamaConfig.tiny(),
                             max_batch_size=4, max_seq_len=64,
                             chips_per_replica=0),
        batch_size=3, concurrency=1, max_new_tokens=4, device="cpu")
    processor = JaxWeightsProcessor(
        config,
        postprocess=lambda row: {"n": len(row["generated_tokens"]), **row})
    return processor(rdata.from_items(ITEMS)).take_all()


def test_processor_gives_the_jax_packages_greedy_tokens(runtimes):
    want = {tuple(r["prompt_tokens"]): r for r in _jax_rows()}
    got = {tuple(r["prompt_tokens"]): r for r in _torch_rows()}
    assert len(got) == len(want) == 6
    assert all(r["n"] == 4 for r in got.values())
    for prompt, row in want.items():
        assert list(got[prompt]["generated_tokens"]) == list(
            row["generated_tokens"]), prompt


def test_processor_books_the_replicas_resources():
    from ray_tpu_torch.llm import LLMConfig, ProcessorConfig, build_llm_processor
    from ray_tpu_torch.models.llama import LlamaConfig

    conf = LLMConfig(model_config=LlamaConfig.tiny())
    calls = []

    class Dataset:
        def map_batches(self, fn, **kw):
            calls.append(kw)
            return self

    for device, want in ((None, {"CPU": 1.0, "GPU": 1.0}),
                         ("cpu", {"CPU": 1.0})):
        build_llm_processor(ProcessorConfig(llm_config=conf, device=device))(
            Dataset())
        assert calls[-1]["resources"] == want
        assert calls[-1]["fn_constructor_args"][-1] == device
    with pytest.raises(ValueError, match="llm_config"):
        build_llm_processor(ProcessorConfig())
