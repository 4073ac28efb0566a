"""Collective communication over ``torch.distributed``: the port of
``paddle_tpu/distributed/collective.py``.

Each function takes ``group=`` as the JAX package does: an axis name
(``"dp"``, ``"mp"``, ``"pp"``, ``"sharding"``) naming this rank's group
along that axis of the hybrid topology (``topology.py``), a
``torch.distributed`` group object, or None for every rank.  Results are
returned, never written into the argument, as the JAX functions return
theirs.  A group of one rank, or no initialised process group, makes every
collective the identity (the JAX package outside a mesh axis).  Ranks
named inside a group (``src``, ``dst``, ``perm``) are indices along the
axis, as ``lax.axis_index`` numbers them.

**Host staging.**  The gloo backend has CUDA forms of ``broadcast`` and
``all_reduce`` only.  Under gloo every other collective and every
point-to-point transfer of a tensor on the card copies it to the host,
communicates there and copies the result back; this module is the one
place that does so, never under NCCL, and it counts the bytes copied each
way (:func:`host_staged_bytes`).  Gloo reduces half-precision tensors in
float32 (the sum of two bf16 values rounded once, as one bf16 add).

Every call is timed into the registry as the JAX ``_observed`` does:
``collective.<op>.ms`` / ``.calls`` / ``.bytes`` labelled
``[axis=<group>,n=<ranks>]``.
"""
from __future__ import annotations

import functools
import inspect
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..framework.errors import UnimplementedError, enforce
from . import topology as topo

__all__ = [
    "ReduceOp", "all_reduce", "all_reduce_quantized", "all_gather",
    "reduce_scatter", "broadcast", "all_to_all", "reduce", "scatter",
    "send_recv_permute", "barrier", "split", "p2p_push", "p2p_exchange",
    "host_staged_bytes", "reset_host_staged_bytes", "group_ranks",
]

# collectives gloo runs on CUDA tensors itself (the torch.distributed
# backend table); every other op is staged through the host under gloo
_GLOO_CUDA_OPS = frozenset({"broadcast", "all_reduce"})

_staged: Dict[str, int] = {}


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def host_staged_bytes(op: Optional[str] = None) -> int:
    """Bytes this process copied between the card and the host for gloo
    collectives (both ways), all ops or one."""
    if op is not None:
        return _staged.get(op, 0)
    return sum(_staged.values())


def reset_host_staged_bytes() -> None:
    _staged.clear()


def _torch_op(op: str):
    import torch.distributed as tdist
    table = {ReduceOp.SUM: tdist.ReduceOp.SUM, ReduceOp.AVG: tdist.ReduceOp.SUM,
             ReduceOp.MAX: tdist.ReduceOp.MAX, ReduceOp.MIN: tdist.ReduceOp.MIN,
             ReduceOp.PROD: tdist.ReduceOp.PRODUCT}
    enforce(op in table, f"unknown reduce op {op!r}")
    return table[op]


def _resolve(group) -> Tuple[object, List[int]]:
    """(process group or None for the world, global ranks) of ``group``;
    ranks [] when nothing is initialised."""
    import torch.distributed as tdist
    if not (tdist.is_available() and tdist.is_initialized()):
        return None, []
    if isinstance(group, str):
        hcg = topo.get_hybrid_communicate_group()
        if hcg is None:
            return None, []
        return hcg.axis_group(group), hcg.axis_ranks(group)
    if group is None:
        return None, list(range(tdist.get_world_size()))
    return group, list(tdist.get_process_group_ranks(group))


def group_ranks(group) -> List[int]:
    """The global ranks of ``group`` ([] without a process group)."""
    return _resolve(group)[1]


def _stage(name: str, pg) -> bool:
    """Whether ``name`` on a card tensor goes through the host here."""
    import torch.distributed as tdist
    return tdist.get_backend(pg) == "gloo" and name not in _GLOO_CUDA_OPS


class _Staging:
    """A tensor as the backend takes it: on the host when gloo has no CUDA
    form of the op (copies counted), in float32 when gloo reduces half
    precision, and a copy of its own when the op writes in place;
    :meth:`back` gives a result in the caller's device and dtype."""

    def __init__(self, name: str, x: torch.Tensor, pg, reduces: bool = False,
                 inplace: bool = False):
        import torch.distributed as tdist
        self.name, self.device, self.dtype = name, x.device, x.dtype
        gloo = tdist.get_backend(pg) == "gloo"
        self.host = x.is_cuda and _stage(name, pg)
        self.upcast = (gloo and reduces
                       and x.dtype in (torch.bfloat16, torch.float16))
        t = x.detach()
        if self.host:
            t = t.cpu()
            self._count(x)
        if self.upcast:
            t = t.float()
        if inplace and not (self.host or self.upcast):
            t = t.clone()
        self.tensor = t.contiguous()

    def _count(self, t: torch.Tensor) -> None:
        _staged[self.name] = (_staged.get(self.name, 0)
                              + t.numel() * t.element_size())

    def back(self, t: torch.Tensor) -> torch.Tensor:
        if self.upcast:
            t = t.to(self.dtype)
        if self.host:
            t = t.to(self.device)
            self._count(t)
        return t


def _observed(fn):
    """Per-collective host ms, calls and payload bytes into the registry,
    labelled with the axis and its ranks when ``group`` is an axis name."""
    base = f"collective.{fn.__name__}"
    params = list(inspect.signature(fn).parameters)
    group_idx = params.index("group") if "group" in params else None
    group_default = (inspect.signature(fn).parameters["group"].default
                     if group_idx is not None else None)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt_ms = (time.perf_counter() - t0) * 1e3
            group = kwargs.get("group", group_default)
            if ("group" not in kwargs and group_idx is not None
                    and len(args) > group_idx):
                group = args[group_idx]
            suffix = ""
            if isinstance(group, str):
                suffix = f"[axis={group},n={topo.axis_size(group)}]"
            x = args[0] if args else None
            from ..observability.registry import get_registry
            reg = get_registry()
            reg.histogram(f"{base}.ms{suffix}").observe(dt_ms)
            reg.counter(f"{base}.calls{suffix}").inc()
            if suffix and isinstance(x, torch.Tensor):
                reg.counter(f"{base}.bytes{suffix}").inc(
                    x.numel() * x.element_size())
    return wrapped


@_observed
def all_reduce(x: torch.Tensor, op: str = ReduceOp.SUM,
               group="dp") -> torch.Tensor:
    """c_allreduce_{sum,max,min,prod,avg}: every rank gets the reduction."""
    import torch.distributed as tdist
    pg, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    s = _Staging("all_reduce", x, pg, reduces=True, inplace=True)
    t = s.tensor
    tdist.all_reduce(t, op=_torch_op(op), group=pg)
    if op == ReduceOp.AVG:
        t = t / len(ranks)
    return s.back(t)


@_observed
def all_gather(x: torch.Tensor, group="dp", axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """c_allgather: the ranks' tensors concatenated along ``axis`` in
    group order (stacked on a new ``axis`` when not ``tiled``)."""
    import torch.distributed as tdist
    pg, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x if tiled else x.unsqueeze(axis)
    s = _Staging("all_gather", x, pg)
    parts = [torch.empty_like(s.tensor) for _ in ranks]
    tdist.all_gather(parts, s.tensor, group=pg)
    out = (torch.cat(parts, dim=axis) if tiled
           else torch.stack(parts, dim=axis))
    return s.back(out)


@_observed
def reduce_scatter(x: torch.Tensor, op: str = ReduceOp.SUM, group="dp",
                   axis: int = 0) -> torch.Tensor:
    """c_reducescatter: this rank's block along ``axis`` of the
    reduction (an all-reduce, then the block)."""
    _, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    n = len(ranks)
    enforce(x.shape[axis] % n == 0,
            f"reduce_scatter axis {axis} size {x.shape[axis]} not divisible "
            f"by group size {n}")
    total = all_reduce.__wrapped__(x, op, group)
    return total.chunk(n, dim=axis)[_index(ranks)].contiguous()


def _index(ranks: List[int]) -> int:
    import torch.distributed as tdist
    return ranks.index(tdist.get_rank())


@_observed
def broadcast(x: torch.Tensor, src: int = 0, group="dp") -> torch.Tensor:
    """c_broadcast: every rank gets the tensor of the group's ``src``-th
    rank."""
    import torch.distributed as tdist
    pg, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    s = _Staging("broadcast", x, pg, inplace=True)
    t = s.tensor
    tdist.broadcast(t, src=ranks[src], group=pg)
    return s.back(t)


@_observed
def reduce(x: torch.Tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group="dp") -> torch.Tensor:
    """c_reduce: the reduction on the ``dst``-th rank, zeros elsewhere."""
    _, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    total = all_reduce.__wrapped__(x, op, group)
    return total if _index(ranks) == dst else torch.zeros_like(total)


@_observed
def scatter(x: torch.Tensor, src: int = 0, group="dp",
            axis: int = 0) -> torch.Tensor:
    """Each rank keeps its block along ``axis`` of the ``src``-th rank's
    tensor."""
    _, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    n = len(ranks)
    enforce(x.shape[axis] % n == 0,
            f"scatter axis {axis} size {x.shape[axis]} not divisible by "
            f"group size {n}")
    full = broadcast.__wrapped__(x, src, group)
    return full.chunk(n, dim=axis)[_index(ranks)].contiguous()


@_observed
def all_to_all(x: torch.Tensor, group="ep", split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """alltoall: block j of this rank's ``x`` along ``split_axis`` goes to
    the group's j-th rank; the received blocks are concatenated along
    ``concat_axis`` in group order."""
    _, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    n, me = len(ranks), _index(ranks)
    enforce(x.shape[split_axis] % n == 0,
            f"all_to_all axis {split_axis} size {x.shape[split_axis]} not "
            f"divisible by group size {n}")
    every = all_gather.__wrapped__(x, group, 0, False)      # (n, ...)
    return torch.cat([every[r].chunk(n, dim=split_axis)[me]
                      for r in range(n)], dim=concat_axis)


@_observed
def split(x: torch.Tensor, group="mp", axis: int = -1) -> torch.Tensor:
    """c_split: this rank's block of ``x`` along ``axis``."""
    _, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    n = len(ranks)
    enforce(x.shape[axis] % n == 0,
            f"split axis {axis} size {x.shape[axis]} not divisible by group "
            f"size {n}")
    return x.chunk(n, dim=axis)[_index(ranks)].contiguous()


def p2p_exchange(sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[Sequence[int], torch.dtype,
                                       torch.device, int]],
                 group=None) -> List[torch.Tensor]:
    """Point-to-point transfers issued together: each ``(tensor, dst)`` is
    sent and each ``(shape, dtype, device, src)`` received (``src`` /
    ``dst`` global ranks), then all are waited for; returns the received
    tensors.  Under gloo, card tensors travel through the host (counted
    under ``p2p``)."""
    import torch.distributed as tdist
    pg, _ = _resolve(group)
    ops, received = [], []
    for t, dst in sends:
        s = _Staging("p2p", t, pg)
        ops.append(tdist.P2POp(tdist.isend, s.tensor, dst, group=pg))
    for shape, dtype, device, src in recvs:
        host = torch.device(device).type == "cuda" and _stage("p2p", pg)
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if host else device)
        ops.append(tdist.P2POp(tdist.irecv, buf, src, group=pg))
        received.append((buf, host, device))
    if ops:
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
    out = []
    for buf, host, device in received:
        if host:
            buf = buf.to(device)
            _staged["p2p"] = (_staged.get("p2p", 0)
                              + buf.numel() * buf.element_size())
        out.append(buf)
    return out


@_observed
def send_recv_permute(x: torch.Tensor, perm: Sequence[tuple],
                      group="pp") -> torch.Tensor:
    """collective_permute: for each ``(src, dst)`` of ``perm`` (indices
    along the axis) the ``src``-th rank's tensor goes to the ``dst``-th;
    a rank that receives nothing gets zeros."""
    _, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    me = _index(ranks)
    sends = [(x, ranks[d]) for s_, d in perm if s_ == me]
    recvs = [(x.shape, x.dtype, x.device, ranks[s_])
             for s_, d in perm if d == me]
    got = p2p_exchange(sends, recvs, group)
    return got[0] if got else torch.zeros_like(x)


@_observed
def p2p_push(x: torch.Tensor, offset: int = 1, group="pp") -> torch.Tensor:
    """Shift along the ring: the i-th rank's tensor goes to rank
    ``i + offset`` (mod the group size)."""
    _, ranks = _resolve(group)
    if len(ranks) <= 1:
        return x
    n = len(ranks)
    return send_recv_permute.__wrapped__(
        x, [(i, (i + offset) % n) for i in range(n)], group)


@_observed
def barrier(group=None, timeout: Optional[float] = None) -> None:
    """Host rendezvous of the group's ranks, under the run supervisor's
    watchdog when one is installed (a dead peer raises ``StepTimeout``
    instead of hanging the caller)."""
    import torch.distributed as tdist
    from ..supervisor.watchdog import guarded
    pg, ranks = _resolve(group)
    if len(ranks) <= 1:
        return None
    with guarded("collective.barrier", timeout=timeout):
        tdist.barrier(group=pg)
    return None


def all_reduce_quantized(x, group: str = "dp", bits: int = 8,
                         block_size: int = 256):
    """The int8 all-reduce of the JAX ``comm`` package: not ported yet
    (ROADMAP.md Queue 1 item 10, with ``comm/`` and ZeRO)."""
    raise UnimplementedError(
        "all_reduce_quantized needs the comm/ package, which is not ported "
        "yet (ROADMAP.md Queue 1 item 10)")
