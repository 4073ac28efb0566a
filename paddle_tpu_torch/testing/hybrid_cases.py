"""The rank side of the hybrid-parallel checks (no JAX here): each rank of
a process world runs the named jobs and writes its results to
``<out>/rank<r>.pkl`` (pickled numpy); the tests hold them against the JAX package.

A world is started by ``distributed.spawn(rank_main, (spec,), nprocs=n)``
or by ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node n
paddle_tpu_torch/testing/hybrid_cases.py <spec.json>``.  ``spec``:

- ``out``: the directory of the results; ``data``: an ``.npz`` of the
  inputs (``state/<key>`` the whole GPT state, ``ids`` / ``labels`` the
  global batch, and the small jobs' arrays);
- ``layout``: ``{"dp", "mp", "pp", "micro"}``; ``cfg``: ``GPTConfig``
  keyword arguments; ``opt``: ``{"lr", "wd", "clip"}``;
- ``jobs``: names of :data:`JOBS`, run in order by every rank.

Every rank runs one intra-op thread on the CPU over gloo.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
from typing import Dict

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def job_env(spec, data) -> Dict[str, object]:
    import torch.distributed as tdist
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_MASTER", "RANK", "WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "OMP_NUM_THREADS")
    return {"env": {k: os.environ.get(k) for k in keys},
            "rank": tdist.get_rank(), "world": tdist.get_world_size(),
            "backend": tdist.get_backend(), "threads": torch.get_num_threads()}


def job_allreduce(spec, data) -> Dict[str, object]:
    from paddle_tpu_torch.distributed import collective as C
    import torch.distributed as tdist
    r = tdist.get_rank()
    x = torch.tensor([r + 1.0, 2.0 * (r + 1)])
    return {"world": _np(C.all_reduce(x, group=None)),
            "dp": _np(C.all_reduce(x, group="dp")),
            "dp_ranks": C.group_ranks("dp")}


def job_collectives(spec, data) -> Dict[str, object]:
    """Each collective over the axis ``spec["axis"]`` on this rank's row
    of ``coll_x``."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import topology as topo
    axis = spec.get("axis", "pp")
    i = topo.axis_rank(axis)
    x = torch.from_numpy(data["coll_x"][i].copy())
    pos = torch.from_numpy(np.abs(data["coll_x"][i]) + 0.5)
    R = C.ReduceOp
    out = {
        "sum": C.all_reduce(x, R.SUM, axis), "max": C.all_reduce(x, R.MAX, axis),
        "min": C.all_reduce(x, R.MIN, axis),
        "prod": C.all_reduce(pos, R.PROD, axis),
        "avg": C.all_reduce(x, R.AVG, axis),
        "all_gather": C.all_gather(x, axis, axis=1),
        "all_gather_stacked": C.all_gather(x, axis, axis=0, tiled=False),
        "reduce_scatter": C.reduce_scatter(x, R.SUM, axis, axis=0),
        "broadcast": C.broadcast(x, 1, axis),
        "reduce": C.reduce(x, 1, R.SUM, axis),
        "scatter": C.scatter(x, 0, axis, axis=0),
        "all_to_all": C.all_to_all(x, axis, split_axis=0, concat_axis=1),
        "permute": C.send_recv_permute(x, [(0, 1)], axis),
        "p2p_push": C.p2p_push(x, 1, axis),
        "split": C.split(x, axis, axis=-1),
    }
    C.barrier(group=axis)
    res = {k: _np(v) for k, v in out.items()}
    res["index"] = i
    return res


def _local_rows(arr: np.ndarray) -> torch.Tensor:
    """This dp replica's rows of a global batch."""
    from paddle_tpu_torch.distributed import topology as topo
    dp, d = topo.axis_size("dp"), topo.axis_rank("dp")
    n = arr.shape[0] // dp
    return torch.from_numpy(arr[d * n:(d + 1) * n].copy())


def job_gpt_step(spec, data) -> Dict[str, object]:
    """One AdamW step with the global-norm clip of this rank's shard of
    the GPT in ``data``: the replica's loss, the clip's norm, every
    gradient (after the tied and dp sums) and every updated parameter."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import topology as topo
    from paddle_tpu_torch.distributed.parallel import allreduce_gradients
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    hcg = topo.get_hybrid_communicate_group()
    state = {k[len("state/"):]: data[k] for k in data.files
             if k.startswith("state/")}
    model = GPTForCausalLM(GPTConfig(**spec["cfg"]), device="cpu")
    convert.load_jax_state(model, convert.shard_state(
        state, mp_rank=hcg.get_model_parallel_rank(),
        mp=hcg.get_model_parallel_world_size(),
        pp_rank=hcg.get_stage_id(), pp=hcg.get_pipe_parallel_world_size(),
        device="cpu"))
    wrapped = fleet.distributed_model(model)
    o = spec["opt"]
    inner = AdamW(learning_rate=o["lr"], weight_decay=o["wd"],
                  grad_clip=ClipGradByGlobalNorm(o["clip"]),
                  parameters=model.named_parameters())
    opt = fleet.distributed_optimizer(inner)
    ids, labels = _local_rows(data["ids"]), _local_rows(data["labels"])
    C.reset_host_staged_bytes()
    if hcg.get_pipe_parallel_world_size() > 1:
        loss = wrapped.forward_backward(ids, labels, level="O0")
        wrapped.allreduce_shared_weight_gradients()
        allreduce_gradients(wrapped._params, "dp")
    else:
        loss, _ = wrapped(ids, labels=labels)
        loss.backward()
        loss = loss.detach()
    loss = C.all_reduce(loss, op=C.ReduceOp.AVG, group="dp")
    grads = {k: _np(p.grad) for k, p in model.named_parameters()}
    opt.step()
    return {"loss": float(loss), "norm": float(inner._grad_clip.last_norm),
            "grads": grads,
            "params": {k: _np(p) for k, p in model.named_parameters()},
            "coord": hcg.coord(), "staged": C.host_staged_bytes()}


def job_recompute_dropout(spec, data) -> Dict[str, object]:
    """This rank's GPT shard with dropout 0.1 under the model-parallel
    RNG streams, its gradients from one stream state with and without
    activation recompute (a replay must draw the forward's masks, those of
    the named streams too)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import topology as topo
    from paddle_tpu_torch.distributed.random import model_parallel_random_seed
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    hcg = topo.get_hybrid_communicate_group()
    state = {k[len("state/"):]: data[k] for k in data.files
             if k.startswith("state/")}
    shard = convert.shard_state(
        state, mp_rank=hcg.get_model_parallel_rank(),
        mp=hcg.get_model_parallel_world_size(), device="cpu")
    ids, labels = _local_rows(data["ids"]), _local_rows(data["labels"])
    model_parallel_random_seed(7)
    start = fw_random.get_state()
    out = {}
    for recompute in (False, True):
        cfg = GPTConfig(**{**spec["cfg"], "hidden_dropout": 0.1,
                           "attention_dropout": 0.1,
                           "use_recompute": recompute})
        model = GPTForCausalLM(cfg, device="cpu")
        convert.load_jax_state(model, shard)
        fw_random.set_state(start)
        loss, _ = model(ids, labels=labels)
        loss.backward()
        out["recompute" if recompute else "plain"] = {
            "loss": float(loss),
            "grads": {k: _np(p.grad) for k, p in model.named_parameters()}}
    return out


def job_mp_layers(spec, data) -> Dict[str, object]:
    """The column / row MLP and the vocab-parallel embedding of
    ``TestTPLayersGSPMD``'s shapes: outputs and gradients of a fixed
    cotangent, both the parallel-output and the gathered forms."""
    from paddle_tpu_torch.distributed import mp_layers as L
    from paddle_tpu_torch.nn import functional as F
    n, r = L.mp_degree(), L.mp_rank()
    w1, b1, w2, b2 = (data[k] for k in ("mlp_w1", "mlp_b1", "mlp_w2",
                                        "mlp_b2"))

    def block(a, axis):
        return torch.from_numpy(np.array_split(a, n, axis=axis)[r].copy())

    out = {}
    for form, (gather, parallel) in {"parallel": (False, True),
                                     "gathered": (True, False)}.items():
        fc1 = L.ColumnParallelLinear(16, 32, gather_output=gather,
                                     device="cpu")
        fc2 = L.RowParallelLinear(32, 16, input_is_parallel=parallel,
                                  device="cpu")
        with torch.no_grad():
            fc1.weight.copy_(block(w1, 1))
            fc1.bias.copy_(block(b1, 0))
            fc2.weight.copy_(block(w2, 0))
            fc2.bias.copy_(torch.from_numpy(b2))
        x = torch.from_numpy(data["mlp_x"].copy()).requires_grad_(True)
        y = fc2(F.gelu(fc1(x)))
        (y * torch.from_numpy(data["mlp_cot"])).sum().backward()
        out[form] = {"y": _np(y), "dx": _np(x.grad),
                     "dw1": _np(fc1.weight.grad), "db1": _np(fc1.bias.grad),
                     "dw2": _np(fc2.weight.grad), "db2": _np(fc2.bias.grad)}
    emb = L.VocabParallelEmbedding(16, 8, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(block(data["emb_table"], 0))
    e = emb(torch.from_numpy(data["emb_ids"]))
    (e * torch.from_numpy(data["emb_cot"])).sum().backward()
    out["embedding"] = {"y": _np(e), "dtable": _np(emb.weight.grad)}
    out["mp_rank"] = r
    return out


def job_mp_ops(spec, data) -> Dict[str, object]:
    """parallel_cross_entropy ("none" and "mean" with its logits'
    gradient), parallel_log_softmax and vocab_parallel_embedding on this
    rank's vocabulary block."""
    from paddle_tpu_torch.distributed import mp_ops, topology as topo
    n, r = topo.axis_size("mp"), topo.axis_rank("mp")
    logits = np.array_split(data["ce_logits"], n, axis=-1)[r].copy()
    lg = torch.from_numpy(logits).requires_grad_(True)
    label = torch.from_numpy(data["ce_labels"])
    none = mp_ops.parallel_cross_entropy(lg, label, reduction="none")
    mean = mp_ops.parallel_cross_entropy(lg, label, reduction="mean")
    mean.backward()
    table = np.array_split(data["emb_table"], n, axis=0)[r].copy()
    return {"none": _np(none), "mean": float(mean), "dlogits": _np(lg.grad),
            "log_softmax": _np(mp_ops.parallel_log_softmax(
                torch.from_numpy(logits))),
            "embedding": _np(mp_ops.vocab_parallel_embedding(
                torch.from_numpy(data["emb_ids"]), torch.from_numpy(table))),
            "mp_rank": r}


def job_tracker(spec, data) -> Dict[str, object]:
    """Dropout masks and hash seeds drawn in the model-parallel stream and
    in the global one after ``model_parallel_random_seed(123)``."""
    from paddle_tpu_torch.distributed import topology as topo
    from paddle_tpu_torch.distributed.random import (
        MODEL_PARALLEL_RNG, get_rng_state_tracker, model_parallel_random_seed)
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.nn import functional as F
    model_parallel_random_seed(123)
    tracker = get_rng_state_tracker()
    ones = torch.ones(64)
    with tracker.rng_state(MODEL_PARALLEL_RNG):
        local = F.dropout(ones, p=0.5, training=True)
        local_seed = fw_random.draw_seed()
    glob = F.dropout(ones, p=0.5, training=True)
    glob_seed = fw_random.draw_seed()
    return {"local": _np(local), "local_seed": local_seed,
            "global": _np(glob), "global_seed": glob_seed,
            "coord": topo.get_hybrid_communicate_group().coord()}


def job_dataparallel(spec, data) -> Dict[str, object]:
    """A linear layer under ``DataParallel`` on rank-specific data: the
    gradient of a ``no_sync`` backward (local) and of a synced one."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.parallel import DataParallel
    lin = torch.nn.Linear(4, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(data["dp_w"]))
        lin.bias.zero_()
    model = DataParallel(lin, comm_buffer_size=1e-5)   # a bucket a tensor
    x = torch.from_numpy(data["dp_x"][tdist.get_rank()].copy())
    with model.no_sync():
        model(x).square().sum().backward()
    local = _np(lin.weight.grad)
    lin.zero_grad()
    model(x).square().sum().backward()
    return {"local": local, "synced": _np(lin.weight.grad),
            "synced_bias": _np(lin.bias.grad)}


def job_engine_refuses(spec, data) -> str:
    """The serving engine's answer to a model built under the group."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(**spec["cfg"]), device="cpu")
    try:
        ServingEngine(model, max_seqs=2, kv_block_size=4, max_model_len=32)
    except Exception as exc:  # noqa: BLE001 — the refusal is the result
        return str(exc)
    return "accepted"


JOBS = {"env": job_env, "allreduce": job_allreduce,
        "collectives": job_collectives, "gpt_step": job_gpt_step,
        "mp_layers": job_mp_layers, "mp_ops": job_mp_ops,
        "tracker": job_tracker, "dataparallel": job_dataparallel,
        "engine_refuses": job_engine_refuses,
        "recompute_dropout": job_recompute_dropout}


def rank_main(spec) -> None:
    """One rank: join the world over gloo with the spec's layout, run the
    jobs, write the results, leave."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group)
    torch.set_num_threads(1)
    lay = spec["layout"]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": lay["dp"], "mp_degree": lay["mp"],
                               "pp_degree": lay["pp"]}
    strategy.pipeline_configs = {"accumulate_steps": lay.get("micro", 1)}
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    data = np.load(spec["data"])
    results = {job: JOBS[job](spec, data) for job in spec["jobs"]}
    path = os.path.join(spec["out"], f"rank{tdist.get_rank()}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(path + ".tmp", path)
    tdist.barrier()
    set_hybrid_communicate_group(None)
    tdist.destroy_process_group()


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        rank_main(json.load(f))
