"""The parallel environment and data parallelism: the port of
``paddle_tpu/distributed/parallel.py`` (``init_parallel_env``,
``ParallelEnv``, ``DataParallel``).

One process per rank.  :func:`init_parallel_env` joins the process group
from the launcher's environment (``launch`` / ``spawn`` wire it):

- with no ``backend`` named, NCCL, and only when every rank has a card of
  its own (ranks on this host <= visible cards; rank ``i`` takes card
  ``i``).  More ranks than cards raises: the port never falls back to gloo
  by itself, since gloo moves most card tensors through the host;
- ``backend="gloo"`` runs ranks that share a card (or the CPU); every rank
  then takes card ``local_rank % cards``.

The backend it used is logged.  :class:`DataParallel` owns its gradient
all-reduce over the **dp group only** (the hybrid topology's data axis),
which ``torch.nn.parallel.DistributedDataParallel`` cannot do inside a
hybrid group: gradients are averaged in buckets of ``comm_buffer_size`` MB
(float32 on the wire) at the end of each backward, in a fixed order on
every rank; ``no_sync()`` skips it, ``apply_collective_grads()`` runs it
by hand.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, List, Optional

import torch

from ..framework.errors import UnavailableError, enforce
from ..framework.log import get_logger
from ..nn.layer import Layer
from . import collective

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "DataParallel", "allreduce_gradients", "sync_params_buffers",
           "backend_for"]


def _env_int(*names: str, default: int) -> int:
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return default


def backend_for(world_size: int, local_world_size: int,
                backend: Optional[str]) -> str:
    """The backend rule: a named backend as it is; otherwise NCCL when
    every rank on this host has a visible card of its own, else raise."""
    if backend is not None:
        return backend
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    enforce(local_world_size <= cards,
            f"{local_world_size} ranks on this host but {cards} visible "
            f"card(s): NCCL needs a card per rank; name the backend "
            f"(init_parallel_env(backend='gloo')) to run ranks that share "
            f"a card or the CPU", exc=UnavailableError)
    return "nccl"


def init_parallel_env(backend: Optional[str] = None,
                      init_method: Optional[str] = None,
                      timeout_s: float = 600.0) -> "ParallelEnv":
    """Join the process group of the launcher's environment (idempotent).

    Rank and world size come from ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS_NUM`` (or torch's ``RANK`` / ``WORLD_SIZE``); the
    rendezvous from ``init_method``, else ``PADDLE_INIT_METHOD`` (e.g. a
    ``file://`` store), else ``tcp://`` at ``PADDLE_MASTER`` (or
    ``MASTER_ADDR:MASTER_PORT``)."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        return ParallelEnv()
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    local_rank = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=rank)
    local_world = _env_int("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
                           default=world)
    chosen = backend_for(world, local_world, backend)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    method = init_method or os.environ.get("PADDLE_INIT_METHOD")
    if not method:
        master = os.environ.get("PADDLE_MASTER") or (
            f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
            f"{os.environ.get('MASTER_PORT', '29500')}")
        method = f"tcp://{master}"
    tdist.init_process_group(
        chosen, init_method=method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    get_logger().info("init_parallel_env: rank %d of %d, backend %s, %s",
                      rank, world, chosen, method)
    return ParallelEnv()


def get_rank() -> int:
    """This process's rank in the default group, 0 without one."""
    import torch.distributed as tdist
    return int(tdist.get_rank()) if tdist.is_initialized() else 0


def get_world_size() -> int:
    """The default group's size, 1 without one."""
    import torch.distributed as tdist
    return int(tdist.get_world_size()) if tdist.is_initialized() else 1


class ParallelEnv:
    """The reference's env bundle (rank, world size, device)."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=self.rank)

    @property
    def device_id(self) -> int:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else 0

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def trainer_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


def _buckets(params: List[torch.Tensor], mb: float) -> List[List[int]]:
    """Indices of ``params`` in reverse order (the order backward makes
    their gradients), cut into buckets of at most ``mb`` MB of float32."""
    cap = max(1, int(mb * (1 << 20) / 4))
    out, cur, size = [], [], 0
    for i in reversed(range(len(params))):
        n = params[i].numel()
        if cur and size + n > cap:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    if cur:
        out.append(cur)
    return out


def allreduce_gradients(params: List[torch.Tensor], group="dp",
                        comm_buffer_size: float = 25,
                        average: bool = True) -> None:
    """Sum (``average``: mean) every parameter's ``.grad`` over ``group``
    in buckets of ``comm_buffer_size`` MB, flattened in float32; a
    parameter without a gradient contributes zeros (its ``.grad`` is set).
    Every rank of the group must call it with the same parameters."""
    if len(collective.group_ranks(group)) <= 1:
        return
    params = [p for p in params if p.requires_grad]
    for bucket in _buckets(params, comm_buffer_size):
        ps = [params[i] for i in bucket]
        flat = torch.cat([
            (p.grad if p.grad is not None
             else torch.zeros_like(p)).reshape(-1).float() for p in ps])
        op = collective.ReduceOp.AVG if average else collective.ReduceOp.SUM
        flat = collective.all_reduce(flat, op=op, group=group)
        off = 0
        for p in ps:
            n = p.numel()
            g = flat[off:off + n].view_as(p).to(p.dtype)
            off += n
            if p.grad is None:
                p.grad = g
            else:
                p.grad.copy_(g)


def sync_params_buffers(model: torch.nn.Module, group="dp",
                        src: int = 0) -> None:
    """Broadcast every parameter and buffer from the group's ``src``-th
    rank (the reference's ``sync_params_buffers`` at wrap time)."""
    if len(collective.group_ranks(group)) <= 1:
        return
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            t.copy_(collective.broadcast(t.detach(), src=src, group=group))


class DataParallel(Layer):
    """Data parallelism over the dp group (reference parallel.py:413).

    Parameters are broadcast from dp rank 0 at wrap time.  Each backward's
    gradients are averaged over the dp group when it ends (a callback
    queued by the first gradient hook), bucket by bucket in one order on
    every rank.  ``state_dict``, ``set_state_dict`` and
    ``named_parameters`` are the wrapped layer's, so names carry no
    prefix."""

    def __init__(self, layers: torch.nn.Module, strategy=None,
                 comm_buffer_size: float = 25,
                 last_comm_buffer_size: float = 1,
                 find_unused_parameters: bool = False):
        super().__init__()
        self._layers = layers
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        self._sync_grads = True
        self._queued = False
        self._params = [p for p in layers.parameters() if p.requires_grad]
        sync_params_buffers(layers, "dp")
        if len(collective.group_ranks("dp")) > 1:
            for p in self._params:
                p.register_post_accumulate_grad_hook(self._on_grad)

    def _on_grad(self, _param) -> None:
        if not self._sync_grads or self._queued:
            return
        self._queued = True
        torch.autograd.Variable._execution_engine.queue_callback(
            self._end_of_backward)

    def _end_of_backward(self) -> None:
        self._queued = False
        self.apply_collective_grads()

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        """Identity: the gradient all-reduce averages."""
        return loss

    def apply_collective_grads(self) -> None:
        """Average the gradients over the dp group now."""
        allreduce_gradients(self._params, "dp", self.comm_buffer_size)

    @contextlib.contextmanager
    def no_sync(self) -> Iterator[None]:
        """Backward passes inside accumulate without the all-reduce."""
        prev, self._sync_grads = self._sync_grads, False
        try:
            yield
        finally:
            self._sync_grads = prev

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            layers = self.__dict__.get("_modules", {}).get("_layers")
            if layers is None:
                raise
            return getattr(layers, name)
