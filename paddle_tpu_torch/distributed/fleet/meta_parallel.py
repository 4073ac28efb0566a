"""``fleet.meta_parallel`` import paths (reference python/paddle/
distributed/fleet/meta_parallel/__init__.py): the model-parallel layers,
the RNG tracker and the pipeline pieces under the names hybrid-parallel
scripts import."""
from ..mp_layers import (ColumnParallelLinear,  # noqa: F401
                         RowParallelLinear, VocabParallelEmbedding)
from ..random import (RNGStatesTracker,  # noqa: F401
                      get_rng_state_tracker, model_parallel_random_seed)

_PIPELINE = {"GPTPipeline": "GPTPipeline", "PipelineParallel": "GPTPipeline",
             "split_microbatches": "split_microbatches",
             "merge_microbatches": "merge_microbatches"}


def __getattr__(name):
    # the pipeline lives with the model (models/gpt_pipeline.py), which
    # imports this package: resolved at first use
    if name in _PIPELINE:
        from ...models import gpt_pipeline
        return getattr(gpt_pipeline, _PIPELINE[name])
    raise AttributeError(name)


__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "GPTPipeline", "PipelineParallel", "split_microbatches",
           "merge_microbatches"]
