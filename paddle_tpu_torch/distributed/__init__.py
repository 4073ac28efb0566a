"""``paddle.distributed`` of the port: the JAX package's one SPMD program
over a mesh becomes one process per rank over ``torch.distributed``, with
the collectives written where GSPMD would put them.

- topology.py   — ``CommunicateTopology`` / ``HybridCommunicateGroup``:
                  coordinates over [dp, pp, sharding, mp], a group per axis
                  slice, the embedding group of the pipeline's end stages
- collective.py — the collectives by axis name (gloo's host staging only
                  here, counted)
- parallel.py   — ``init_parallel_env`` (the backend rule), ``DataParallel``
                  (the dp group's bucketed gradient all-reduce)
- spawn.py, launch/ — one process per rank with the launcher's env
- random.py     — the model-parallel RNG tracker
- mp_layers.py, mp_ops.py — Megatron layers, the vocab-parallel loss and
                  embedding
- fleet/        — ``init``, ``distributed_model`` / ``_optimizer`` /
                  ``_scaler``, ``HybridParallelOptimizer``
- moe.py, checkpoint.py, fingerprint.py, elastic.py — one card's forms

Without a process group (one process) every collective is the identity
and ``get_rank`` / ``get_world_size`` are 0 and 1, as the JAX package's
outside a mesh.
"""
from __future__ import annotations

from . import fleet  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         all_reduce_quantized, all_to_all, barrier,
                         broadcast, host_staged_bytes, p2p_push, reduce,
                         reduce_scatter, reset_host_staged_bytes, scatter,
                         send_recv_permute, split)
from .mp_layers import (ColumnParallelLinear, RowParallelLinear,  # noqa: F401
                        VocabParallelEmbedding)
from .mp_ops import (parallel_cross_entropy, parallel_log_softmax,  # noqa: F401
                     vocab_parallel_embedding)
from .parallel import (DataParallel, ParallelEnv, get_rank,  # noqa: F401
                       get_world_size, init_parallel_env)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)
from .spawn import spawn  # noqa: F401
from .topology import (CommunicateTopology, HybridCommunicateGroup,  # noqa: F401
                       get_hybrid_communicate_group, get_mesh,
                       set_hybrid_communicate_group)
from . import launch  # noqa: F401,E402

__all__ = [
    "fleet", "launch", "ReduceOp", "all_gather", "all_reduce",
    "all_reduce_quantized", "all_to_all", "barrier", "broadcast",
    "host_staged_bytes", "reset_host_staged_bytes", "p2p_push", "reduce",
    "reduce_scatter", "scatter", "send_recv_permute", "split", "spawn",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "parallel_cross_entropy", "parallel_log_softmax",
    "vocab_parallel_embedding", "DataParallel", "ParallelEnv", "get_rank",
    "get_world_size", "init_parallel_env", "RNGStatesTracker",
    "get_rng_state_tracker", "model_parallel_random_seed",
    "CommunicateTopology", "HybridCommunicateGroup",
    "get_hybrid_communicate_group", "get_mesh",
    "set_hybrid_communicate_group",
]
