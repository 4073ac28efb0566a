"""Parallel layers of the port (serial, single-card forms) and the process
coordinates the runtime reads: :func:`get_rank` and :func:`get_world_size`
come from ``torch.distributed`` when a process group is initialised, and
are 0 and 1 otherwise (the JAX package reads ``jax.process_index()`` /
``jax.process_count()`` at the same places)."""
from __future__ import annotations

__all__ = ["get_rank", "get_world_size"]


def _group_ready() -> bool:
    import torch.distributed as tdist
    return tdist.is_available() and tdist.is_initialized()


def get_rank() -> int:
    """This process's rank in the default group, 0 without one."""
    if not _group_ready():
        return 0
    import torch.distributed as tdist
    return int(tdist.get_rank())


def get_world_size() -> int:
    """The default group's size, 1 without one."""
    if not _group_ready():
        return 1
    import torch.distributed as tdist
    return int(tdist.get_world_size())
