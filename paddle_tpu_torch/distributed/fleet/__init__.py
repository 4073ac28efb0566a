"""``fleet``: the hybrid-parallel facade over ``torch.distributed``, the
port of ``paddle_tpu/distributed/fleet/__init__.py`` (reference
fleet_base.py ``init``:206, ``distributed_optimizer``:875,
``distributed_model``:932, ``DistributedStrategy``).

    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    model = fleet.distributed_model(GPTForCausalLM(cfg))   # this rank's shard
    opt = fleet.distributed_optimizer(AdamW(..., grad_clip=
        ClipGradByGlobalNorm(1.0), parameters=model.named_parameters()))
    loss = model.train_batch(ids, labels, opt)      # pp > 1: 1F1B
    # pp == 1: training.train_step(model, opt, ids, labels)

``init`` joins the process group (``init_parallel_env``; the backend rule
there) and builds the topology from ``hybrid_configs`` (dp filled in from
the world size when it is -1 or 0, as the JAX ``init``), and seeds the
model-parallel RNG streams when ``tensor_parallel_configs`` names a
``tensor_init_seed``.  A model built after it holds this rank's shard.
``distributed_model`` applies ``strategy.recompute`` and ``strategy.amp``
and returns the pipeline wrapper when pp > 1, else the model wrapped for
dp (:class:`~..parallel.DataParallel`).  ``distributed_optimizer`` returns
:class:`~.optimizer.HybridParallelOptimizer` (amp loss scaling,
``gradient_merge``, the global-norm clip over mp and pp);
``distributed_scaler`` makes a ``GradScaler`` agree on overflow across the
world.  ``strategy.sharding``, ``sp_degree``, ``ep_degree`` and
``comm_configs`` raise ``UnimplementedError``: ZeRO, sequence / context
and expert parallelism and the compressed collectives are ROADMAP.md
Queue 1 item 10's next slice.
"""
from __future__ import annotations

import enum as _enum
import sys as _sys
from typing import Any, Dict, Optional

from ...framework.errors import UnimplementedError, enforce
from .. import collective
from ..parallel import (DataParallel, get_rank, get_world_size,
                        init_parallel_env)
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        get_hybrid_communicate_group, get_mesh,
                        set_hybrid_communicate_group)
from . import meta_parallel  # noqa: F401  (ported-script import path)
from . import utils  # noqa: F401  (fleet.utils.recompute import path)
from .recompute import recompute

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "distributed_scaler",
           "get_hybrid_communicate_group", "get_mesh", "recompute",
           "worker_index", "worker_num", "fleet_initialized"]


class DistributedStrategy:
    """The reference's strategy fields (distributed_strategy.proto
    :276-336) with the JAX package's defaults."""

    def __init__(self):
        self.amp = False
        self.amp_configs: Dict[str, Any] = {}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict[str, Any] = {}
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "micro_batch_size": 1}
        self.hybrid_configs: Dict[str, int] = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "ep_degree": 1,
        }
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1}
        self.comm_configs: Dict[str, Any] = {}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


_strategy: Optional[DistributedStrategy] = None

_NOT_YET = "is not ported yet (ROADMAP.md Queue 1 item 10: ZeRO, sequence " \
    "/ context and expert parallelism, the compressed collectives)"


def _amp_dtype(amp_configs) -> str:
    """bfloat16 unless the config asks for fp16 (``use_fp16_guard``)."""
    cfg = amp_configs or {}
    return cfg.get("dtype",
                   "float16" if cfg.get("use_fp16_guard") else "bfloat16")


def _refuse_unported(strategy: DistributedStrategy) -> None:
    cfg = strategy.hybrid_configs
    checks = (
        ("strategy.sharding", bool(strategy.sharding)
         or int(cfg.get("sharding_degree", 1)) > 1),
        ("hybrid_configs['sp_degree']", int(cfg.get("sp_degree", 1)) > 1),
        ("hybrid_configs['ep_degree']", int(cfg.get("ep_degree", 1)) > 1),
        ("strategy.comm_configs", bool(strategy.comm_configs)),
    )
    for what, on in checks:
        enforce(not on, f"{what} {_NOT_YET}", exc=UnimplementedError)


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None,
         backend: Optional[str] = None) -> None:
    """Join the process group and build the hybrid topology of
    ``strategy.hybrid_configs`` (reference fleet_base.py:206, :279-311)."""
    global _strategy
    strategy = strategy or DistributedStrategy()
    _refuse_unported(strategy)
    init_parallel_env(backend=backend)
    _strategy = strategy
    cfg = strategy.hybrid_configs
    n = get_world_size()
    pp = int(cfg.get("pp_degree", 1))
    mp = int(cfg.get("mp_degree", 1))
    dp = int(cfg.get("dp_degree", 1))
    if dp <= 0:
        enforce(n % (pp * mp) == 0,
                f"world size {n} not divisible by pp x mp = {pp * mp}")
        dp = n // (pp * mp)
    enforce(dp * pp * mp == n,
            f"dp {dp} x pp {pp} x mp {mp} = {dp * pp * mp}, but the world "
            f"has {n} ranks")
    topo = CommunicateTopology(("data", "pipe", "sharding", "model"),
                               (dp, pp, 1, mp))
    set_hybrid_communicate_group(HybridCommunicateGroup(topo))
    seed = (strategy.tensor_parallel_configs or {}).get("tensor_init_seed")
    if seed is not None:
        from ..random import model_parallel_random_seed
        model_parallel_random_seed(int(seed))


def fleet_initialized() -> bool:
    return get_hybrid_communicate_group() is not None


def _enable_recompute(model, configs) -> None:
    """strategy.recompute: a model with ``config.use_recompute`` (GPT,
    BERT) gets it set; any other has each child of its outermost
    ``LayerList`` / ``Sequential`` recomputed."""
    from .recompute import recompute_wrapper
    policy = (configs or {}).get("policy")
    cfg = getattr(model, "config", None)
    if cfg is not None and hasattr(cfg, "use_recompute"):
        cfg.use_recompute = True
        if policy is not None:
            cfg.recompute_policy = policy
        return

    def walk(layer):
        for child in layer.children():
            if type(child).__name__ in ("LayerList", "Sequential",
                                        "ModuleList"):
                for block in child.children():
                    block.forward = recompute_wrapper(block.forward, policy)
            else:
                walk(child)
    walk(model)


def _amp_wrap_model(model, configs) -> None:
    """strategy.amp: the forward under ``auto_cast`` (O2, with
    ``use_pure_fp16``, also casts the parameters)."""
    from ... import amp as amp_mod
    cfg = dict(configs or {})
    dtype = _amp_dtype(cfg)
    level = "O2" if cfg.get("use_pure_fp16") else "O1"
    if level == "O2":
        amp_mod.decorate(model, level="O2", dtype=dtype)
    if getattr(model, "_fleet_amp", False):
        return
    fwd = model.forward

    def _amp_forward(*a, **kw):
        with amp_mod.auto_cast(True, cfg.get("custom_white_list"),
                               cfg.get("custom_black_list"),
                               level=level, dtype=dtype):
            return fwd(*a, **kw)

    model.forward = _amp_forward
    model._fleet_amp = True


def broadcast_mp_parameters(model) -> None:
    """Broadcast the parameters every mp rank holds whole (all but the
    ``mp_sharded`` shards) from mp rank 0."""
    import torch
    with torch.no_grad():
        for p in model.parameters():
            if not getattr(p, "mp_sharded", False):
                p.copy_(collective.broadcast(p.detach(), 0, group="mp"))


def distributed_model(model):
    """Wrap the model for the hybrid group (reference fleet_base.py:932):
    recompute and amp as the strategy says, the mp-replicated parameters
    made equal, then the pipeline wrapper (pp > 1) or the dp wrapper."""
    enforce(fleet_initialized(), "call fleet.init() first")
    strat = _strategy or DistributedStrategy()
    if strat.recompute:
        _enable_recompute(model, strat.recompute_configs)
    if strat.amp:
        _amp_wrap_model(model, strat.amp_configs)
    hcg = get_hybrid_communicate_group()
    broadcast_mp_parameters(model)
    pp = hcg.get_pipe_parallel_world_size()
    if pp > 1:
        enforce(hasattr(model, "build_pipeline"),
                f"pp_degree={pp} but {type(model).__name__} has no "
                "build_pipeline")
        micro = int((strat.pipeline_configs or {}).get("accumulate_steps",
                                                        pp))
        return model.build_pipeline(pp, micro)
    if hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model)
    return model


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """:class:`~.optimizer.HybridParallelOptimizer` over ``optimizer``
    (reference fleet_base.py:875)."""
    enforce(fleet_initialized(), "call fleet.init() first")
    from .optimizer import HybridParallelOptimizer
    return HybridParallelOptimizer(optimizer,
                                   strategy or _strategy
                                   or DistributedStrategy())


def distributed_scaler(scaler):
    """A ``GradScaler`` whose overflow flag is the world's (reference
    ``fleet.distributed_scaler``)."""
    from .optimizer import HybridParallelGradScaler
    return HybridParallelGradScaler(scaler)


def worker_index() -> int:
    return get_rank()


def worker_num() -> int:
    return get_world_size()


# ---------------------------------------------------------------------------
# The reference fleet's module-level surface: Role, UtilBase, role makers,
# the data generators and the Fleet class
# ---------------------------------------------------------------------------
class Role(_enum.IntEnum):
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class UtilBase:
    """Cross-worker helpers over the world's process group (the identity
    in one process)."""

    def all_gather(self, input, comm_world: str = "worker"):  # noqa: A002
        import numpy as np
        import torch
        t = torch.as_tensor(np.asarray(input))
        out = collective.all_gather(t, group=None, tiled=False)
        return [np.asarray(x) for x in out.unbind(0)]

    def all_reduce(self, input, mode: str = "sum",  # noqa: A002
                   comm_world: str = "worker"):
        import numpy as np
        ops = {"sum": np.sum, "min": np.min, "max": np.max}
        enforce(mode in ops, f"all_reduce mode must be one of {list(ops)}")
        return ops[mode](np.stack(self.all_gather(input)), axis=0)

    def barrier(self, comm_world: str = "worker"):
        collective.barrier(group=None)

    def get_file_shard(self, files):
        """This worker's share of ``files`` (a balanced remainder)."""
        n, i = get_world_size(), get_rank()
        base, rem = divmod(len(files), n)
        start = i * base + min(i, rem)
        return files[start:start + base + (1 if i < rem else 0)]

    def print_on_rank(self, message: str, rank_id: int = 0):
        if get_rank() == rank_id:
            print(message)  # noqa: print


class PaddleCloudRoleMaker:
    """Identity from the launcher's environment."""

    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = is_collective

    def _worker_index(self) -> int:
        return get_rank()

    def _worker_num(self) -> int:
        return get_world_size()

    worker_index = _worker_index
    worker_num = _worker_num

    def _role(self):
        return Role.WORKER

    def _is_first_worker(self) -> bool:
        return get_rank() == 0

    is_first_worker = _is_first_worker

    def _server_num(self) -> int:
        return 0


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective: bool = True, init_gloo: bool = False,
                 **kwargs):
        super().__init__(is_collective)
        self._kwargs = kwargs


class MultiSlotDataGenerator:
    """The slot-file line protocol (``generate_sample`` in a subclass)."""

    def __init__(self):
        self._proto_info = None

    def generate_sample(self, line):
        raise NotImplementedError(
            "subclass MultiSlotDataGenerator and implement "
            "generate_sample(line) -> iterable of (name, values) lists")

    def _format(self, sample):
        parts = []
        for name, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def run_from_stdin(self):
        for line in _sys.stdin:
            for sample in self.generate_sample(line)():
                _sys.stdout.write(self._format(sample) + "\n")

    def run_from_memory(self, lines):
        out = []
        for line in lines:
            for sample in self.generate_sample(line)():
                out.append(self._format(sample))
        return out


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """String slots: the same line protocol."""


class Fleet:
    """The class behind the module-level facade: ``Fleet().init(...)`` is
    ``fleet.init(...)``."""

    def __init__(self):
        self.util = UtilBase()

    def __getattr__(self, name):
        mod = _sys.modules[__name__]
        if hasattr(mod, name):
            return getattr(mod, name)
        raise AttributeError(name)


__all__ += ["Role", "UtilBase", "PaddleCloudRoleMaker",
            "UserDefinedRoleMaker", "MultiSlotDataGenerator",
            "MultiSlotStringDataGenerator", "Fleet", "broadcast_mp_parameters"]
