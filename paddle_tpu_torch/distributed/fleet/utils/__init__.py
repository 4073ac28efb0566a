"""``fleet.utils`` (reference python/paddle/distributed/fleet/utils/):
``recompute`` at its canonical import path and the hybrid_parallel_util
helpers, which here do the collectives (the JAX package's are no-ops
because GSPMD derives them)."""
from __future__ import annotations

from ..recompute import recompute, recompute_wrapper  # noqa: F401

__all__ = ["recompute", "recompute_wrapper", "fused_allreduce_gradients",
           "broadcast_dp_parameters", "broadcast_mp_parameters"]


def fused_allreduce_gradients(parameter_list, hcg=None) -> None:
    """Average the parameters' gradients over the dp group
    (hybrid_parallel_util.py:156)."""
    from ...parallel import allreduce_gradients
    allreduce_gradients(list(parameter_list), "dp")


def broadcast_dp_parameters(model, hcg=None) -> None:
    """Every parameter and buffer from dp rank 0
    (hybrid_parallel_util.py:128)."""
    from ...parallel import sync_params_buffers
    sync_params_buffers(model, "dp")


def broadcast_mp_parameters(model, hcg=None) -> None:
    """The parameters the mp ranks hold whole, from mp rank 0."""
    from .. import broadcast_mp_parameters as _bcast
    _bcast(model)
