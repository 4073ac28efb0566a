"""Hybrid-parallel topology over ``torch.distributed``: the port of
``paddle_tpu/distributed/topology.py`` (``CommunicateTopology``,
``HybridCommunicateGroup``, the registry).

The JAX package names the axes of one device mesh and lets GSPMD derive
every group.  Here each rank is a process, so the topology is the
reference's own bookkeeping: the cartesian coordinates over [dp, pp,
sharding, mp] (outermost first, mp innermost, so an mp group is adjacent
ranks), one ``torch.distributed`` group per slice of each axis, and the
**embedding group** {first stage, last stage} of each (dp, sharding, mp)
coordinate, over which the tied embedding's two gradients are summed.
Every rank creates every group in the same order (``new_group`` is a
collective call) and keeps the ones it belongs to.

``get_hybrid_communicate_group() is not None`` is what the callers of the
JAX ``get_mesh()`` test; :func:`get_mesh` keeps that meaning.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..framework.errors import enforce

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group",
           "get_mesh", "axis_size", "axis_rank"]

# canonical short names of the axes, as the JAX package's mesh names them
_AXIS_SHORT = {"data": "dp", "pipe": "pp", "sharding": "sharding",
               "model": "mp", "expert": "ep", "sequence": "sp"}


class CommunicateTopology:
    """Axis-name -> degree bookkeeping (reference topology.py:52): the
    same coordinates and rank lists as the JAX class."""

    def __init__(self, hybrid_group_names: Sequence[str] = (
            "data", "pipe", "sharding", "model"),
            dims: Sequence[int] = (1, 1, 1, 1)):
        enforce(len(hybrid_group_names) == len(dims),
                "names and dims must align")
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world_size = int(np.prod(self._dims)) if self._dims else 1
        self._coord_array = np.arange(self._world_size).reshape(self._dims)

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        """Coordinate dict -> linear rank."""
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return int(self._coord_array[coord])

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        ax = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[ax] = index
        return [int(r) for r in self._coord_array[tuple(sl)].ravel()]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The groups of ranks that communicate along ``axis_name`` (every
        other coordinate fixed)."""
        ax = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._coord_array, ax, -1)
        return [list(map(int, row))
                for row in moved.reshape(-1, self._dims[ax])]


class HybridCommunicateGroup:
    """This rank's place in the topology and its process groups
    (reference topology.py:133).  The default ``torch.distributed`` group
    must be initialised with the topology's world size."""

    def __init__(self, topology: CommunicateTopology):
        import torch.distributed as tdist
        enforce(tdist.is_available() and tdist.is_initialized(),
                "HybridCommunicateGroup needs torch.distributed initialised "
                "(init_parallel_env or fleet.init)")
        n = topology.world_size()
        enforce(tdist.get_world_size() == n,
                f"the topology has {n} ranks, the process group "
                f"{tdist.get_world_size()}")
        self._topo = topology
        self.global_rank = int(tdist.get_rank())
        self.nranks = n
        names = topology.get_hybrid_group_names()
        coord = topology.get_coord(self.global_rank)
        self._coord = {_AXIS_SHORT.get(nm, nm): c
                       for nm, c in zip(names, coord)}
        self._ranks: Dict[str, List[int]] = {}
        self._groups: Dict[str, object] = {}
        for name in names:
            short = _AXIS_SHORT.get(name, name)
            for ranks in topology.get_comm_list(name):
                group = tdist.new_group(ranks) if len(ranks) > 1 else None
                if self.global_rank in ranks:
                    self._ranks[short] = ranks
                    self._groups[short] = group
        # the embedding group: {first stage, last stage} of each pipeline
        self._emb_ranks, self._emb_group = [self.global_rank], None
        if "pipe" in names and topology.get_dim("pipe") > 1:
            for ranks in topology.get_comm_list("pipe"):
                pair = [ranks[0], ranks[-1]]
                group = tdist.new_group(pair)
                if self.global_rank in pair:
                    self._emb_ranks, self._emb_group = pair, group

    # -- paddle-parity query API ------------------------------------------
    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self) -> str:
        if self.get_model_parallel_world_size() > 1:
            return "tensor"
        if self.get_pipe_parallel_world_size() > 1:
            return "pipeline"
        if self.get_sharding_parallel_world_size() > 1:
            return "sharding"
        return "data"

    def axis_size(self, short: str) -> int:
        return len(self._ranks.get(short, [self.global_rank]))

    def axis_rank(self, short: str) -> int:
        return int(self._coord.get(short, 0))

    def axis_ranks(self, short: str) -> List[int]:
        """The global ranks of this rank's group along ``short``."""
        return list(self._ranks.get(short, [self.global_rank]))

    def axis_group(self, short: str):
        """The ``torch.distributed`` group of this rank along ``short``
        (None when the axis has one rank)."""
        return self._groups.get(short)

    def get_data_parallel_world_size(self) -> int:
        return self.axis_size("dp")

    def get_model_parallel_world_size(self) -> int:
        return self.axis_size("mp")

    def get_pipe_parallel_world_size(self) -> int:
        return self.axis_size("pp")

    def get_sharding_parallel_world_size(self) -> int:
        return self.axis_size("sharding")

    def get_expert_parallel_world_size(self) -> int:
        return self.axis_size("ep")

    def get_data_parallel_rank(self) -> int:
        return self.axis_rank("dp")

    def get_model_parallel_rank(self) -> int:
        return self.axis_rank("mp")

    def get_stage_id(self) -> int:
        return self.axis_rank("pp")

    def get_sharding_parallel_rank(self) -> int:
        return self.axis_rank("sharding")

    def get_data_parallel_group(self):
        return self.axis_group("dp")

    def get_model_parallel_group(self):
        return self.axis_group("mp")

    def get_pipe_parallel_group(self):
        return self.axis_group("pp")

    def get_sharding_parallel_group(self):
        return self.axis_group("sharding")

    def get_embedding_group(self):
        """The {first stage, last stage} group of this rank's pipeline
        (None without pp or off the end stages)."""
        return self._emb_group

    def get_embedding_ranks(self) -> List[int]:
        return list(self._emb_ranks)

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def axis_names(self) -> Tuple[str, ...]:
        return tuple(_AXIS_SHORT.get(n, n)
                     for n in self._topo.get_hybrid_group_names())

    def coord(self) -> Dict[str, int]:
        """This rank's coordinate on every axis, by short name."""
        return dict(self._coord)

    def destroy(self) -> None:
        """Destroy every group this object created on this rank."""
        import torch.distributed as tdist
        if not tdist.is_initialized():
            return
        for group in {id(g): g for g in (*self._groups.values(),
                                         self._emb_group)
                      if g is not None}.values():
            tdist.destroy_process_group(group)
        self._groups, self._emb_group = {}, None


# ---------------------------------------------------------------------------
# The registry (fleet's module-level _HYBRID_PARALLEL_GROUP)
# ---------------------------------------------------------------------------
_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    """Install ``hcg`` (None resets).  A replaced group object's process
    groups are destroyed."""
    global _hcg
    if _hcg is not None and _hcg is not hcg:
        _hcg.destroy()
    _hcg = hcg
    return hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg


def get_mesh() -> Optional[HybridCommunicateGroup]:
    """The active hybrid group, or None before ``fleet.init`` (the JAX
    function returns the mesh; callers test it against None)."""
    return _hcg


def axis_size(name: str) -> int:
    """Degree of an axis by short name (1 without a hybrid group)."""
    return _hcg.axis_size(name) if _hcg is not None else 1


def axis_rank(name: str) -> int:
    """This rank's coordinate on an axis (0 without a hybrid group)."""
    return _hcg.axis_rank(name) if _hcg is not None else 0
