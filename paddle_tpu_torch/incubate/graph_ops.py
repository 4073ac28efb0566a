"""Graph message passing and segment reductions: the port of
``paddle_tpu/incubate/graph_ops.py`` (reference
python/paddle/incubate/operators/graph_send_recv.py:22 and the incubate
segment ops).

The reductions are PyTorch scatter-reduces (``index_add`` and
``scatter_reduce``) over dim 0.  An empty segment's value is the JAX
package's: ``segment_sum`` / ``segment_mean`` give 0, ``segment_max`` the
dtype's lowest value (-inf for floats) and ``segment_min`` its highest
(+inf), as ``jax.ops.segment_max`` / ``segment_min`` give them; the
reference Paddle kernel gives 0 there.  ``graph_send_recv`` zero-fills
rows that receive no message, for every pool type (the reference kernel's
rule, kept by the JAX package).

The samplers (``graph_khop_sampler``, ``graph_sample_neighbors``) and
``graph_reindex`` are host-side graph preparation, as in the JAX package;
the samplers draw from the framework's CPU stream
(``framework/random.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework import random as fw_random
from ..framework.dtype import as_tensor, creation_device
from ..framework.errors import enforce

__all__ = ["graph_send_recv", "graph_khop_sampler", "graph_sample_neighbors",
           "graph_reindex", "segment_sum", "segment_mean", "segment_max",
           "segment_min"]

_POOLS = ("sum", "mean", "max", "min")


def _extreme(dtype, lowest: bool):
    if dtype.is_floating_point:
        return float("-inf") if lowest else float("inf")
    info = torch.iinfo(dtype)
    return info.min if lowest else info.max


def _segment(data, ids, n: int, reduce: str):
    """Reduce rows of ``data`` into ``n`` segments by ``ids``; an empty
    segment keeps the reduction's identity (0, or the dtype's extreme)."""
    shape = (n,) + tuple(data.shape[1:])
    if reduce == "sum":
        return torch.zeros(shape, dtype=data.dtype,
                           device=data.device).index_add(0, ids, data)
    init = _extreme(data.dtype, lowest=reduce == "amax")
    out = torch.full(shape, init, dtype=data.dtype, device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, reduce, include_self=False)


def _counts(ids, n: int, dtype):
    return torch.zeros(n, dtype=dtype, device=ids.device).index_add(
        0, ids, torch.ones(ids.shape[0], dtype=dtype, device=ids.device))


def graph_send_recv(x, src_index, dst_index, pool_type: str = "sum",
                    out_size: Optional[int] = None, name=None):
    """Gather ``x[src_index]`` and scatter-reduce into row ``dst_index``.

    Rows of the output that receive no message are 0 for every pool type.
    ``out_size`` fixes the number of output rows (``x.shape[0]`` by
    default)."""
    enforce(pool_type in _POOLS,
            f"pool_type must be one of {_POOLS}, got {pool_type!r}")
    x = as_tensor(x)
    src = as_tensor(src_index, x).long()
    dst = as_tensor(dst_index, x).long()
    enforce(src.dim() == 1 and dst.dim() == 1 and src.shape == dst.shape,
            f"src/dst_index must be equal-length 1-D, got "
            f"{tuple(src.shape)} vs {tuple(dst.shape)}")
    n = int(out_size) if out_size is not None else x.shape[0]
    gathered = x[src]
    if pool_type == "sum":
        return _segment(gathered, dst, n, "sum")
    counts = _counts(dst, n, x.dtype)
    shape = (-1,) + (1,) * (x.dim() - 1)
    if pool_type == "mean":
        s = _segment(gathered, dst, n, "sum")
        return s / torch.clamp(counts, min=1).reshape(shape)
    r = _segment(gathered, dst, n, "amax" if pool_type == "max" else "amin")
    return torch.where((counts == 0).reshape(shape), torch.zeros_like(r), r)


def _num_segments(ids) -> int:
    """max(id) + 1: the output length (a shape, read on the host)."""
    enforce(ids.numel() > 0, "segment ops need at least one segment id")
    return int(ids.max()) + 1


def segment_sum(data, segment_ids):
    """Segment reduction over dim 0 (reference incubate segment_sum)."""
    data = as_tensor(data)
    ids = as_tensor(segment_ids, data).long()
    return _segment(data, ids, _num_segments(ids), "sum")


def segment_mean(data, segment_ids):
    data = as_tensor(data)
    ids = as_tensor(segment_ids, data).long()
    n = _num_segments(ids)
    s = _segment(data, ids, n, "sum")
    c = _counts(ids, n, data.dtype)
    return s / torch.clamp(c, min=1).reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data, segment_ids):
    data = as_tensor(data)
    ids = as_tensor(segment_ids, data).long()
    return _segment(data, ids, _num_segments(ids), "amax")


def segment_min(data, segment_ids):
    data = as_tensor(data)
    ids = as_tensor(segment_ids, data).long()
    return _segment(data, ids, _num_segments(ids), "amin")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _choose(n: int, k: int) -> np.ndarray:
    """``k`` of ``n`` positions without replacement, from the CPU stream."""
    return torch.randperm(n, generator=fw_random.generator("cpu"))[:k].numpy()


def _out_device(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return creation_device()


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids: bool = False):
    """K-hop neighbor sampling over a CSC graph (reference incubate
    graph_khop_sampler: returns (edge_src, edge_dst, sample_index,
    reindex_nodes[, edge_eids])).  ``sample_index`` lists unique touched
    nodes with the input nodes first (first-seen order);
    ``reindex_nodes`` gives the input nodes' positions in it."""
    dev = _out_device(row, colptr, input_nodes)
    row, colptr = _host(row), _host(colptr)
    inputs = _host(input_nodes).reshape(-1)
    eids_all = None if sorted_eids is None else _host(sorted_eids)
    frontier = inputs
    all_rows, all_cols, all_eids = [], [], []
    for k in sample_sizes:
        rs, cs, es = [], [], []
        for dst in frontier:
            lo, hi = int(colptr[dst]), int(colptr[dst + 1])
            neigh = row[lo:hi]
            eid = eids_all[lo:hi] if eids_all is not None \
                else np.arange(lo, hi)
            if k >= 0 and len(neigh) > k:
                sel = _choose(len(neigh), k)
                neigh, eid = neigh[sel], eid[sel]
            rs.append(neigh)
            cs.append(np.full(len(neigh), dst, row.dtype))
            es.append(eid)
        rs = np.concatenate(rs) if rs else np.empty(0, row.dtype)
        cs = np.concatenate(cs) if cs else np.empty(0, row.dtype)
        es = np.concatenate(es) if es else np.empty(0, np.int64)
        all_rows.append(rs)
        all_cols.append(cs)
        all_eids.append(es)
        frontier = np.unique(rs)
    rows = np.concatenate(all_rows)
    cols = np.concatenate(all_cols)
    mapping, sample_index = {}, []
    for v in np.concatenate([inputs, cols, rows]):
        v = int(v)
        if v not in mapping:
            mapping[v] = len(sample_index)
            sample_index.append(v)
    r_re = np.asarray([mapping[int(v)] for v in rows], np.int64)
    c_re = np.asarray([mapping[int(v)] for v in cols], np.int64)
    reindex_nodes = np.arange(len(inputs), dtype=np.int64)
    out = tuple(torch.as_tensor(a, device=dev) for a in (
        r_re, c_re, np.asarray(sample_index, np.int64), reindex_nodes))
    if return_eids:
        return out + (torch.as_tensor(np.concatenate(all_eids).astype(
            np.int64), device=dev),)
    return out


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size: int = -1,
                           return_eids: bool = False,
                           flag_perm_buffer: bool = False):
    """One-hop neighbor sampling (reference graph_sample_neighbors):
    ``(neighbors, counts[, eids])``."""
    dev = _out_device(row, colptr, input_nodes)
    row, colptr = _host(row), _host(colptr)
    outs, counts, es = [], [], []
    for dst in _host(input_nodes).reshape(-1):
        lo, hi = int(colptr[dst]), int(colptr[dst + 1])
        neigh = row[lo:hi]
        eid = np.arange(lo, hi)
        if sample_size >= 0 and len(neigh) > sample_size:
            sel = _choose(len(neigh), sample_size)
            neigh, eid = neigh[sel], eid[sel]
        outs.append(neigh)
        counts.append(len(neigh))
        es.append(eid)
    out = np.concatenate(outs) if outs else np.empty(0, row.dtype)
    cnt = np.asarray(counts, np.int32)
    res = (torch.as_tensor(out, device=dev), torch.as_tensor(cnt, device=dev))
    if return_eids:
        return res + (torch.as_tensor(
            np.concatenate(es) if es else np.empty(0, np.int64),
            device=dev),)
    return res


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable: bool = False):
    """Reindex a sampled subgraph to contiguous ids (reference
    graph_reindex): x (the dst nodes) keep ids 0..n-1; new neighbor ids
    follow in first-seen order.  Returns (reindexed neighbors, reindexed
    dst per neighbor, out_nodes)."""
    dev = _out_device(x, neighbors, count)
    x = _host(x).reshape(-1)
    neighbors = _host(neighbors).reshape(-1)
    count = _host(count).reshape(-1)
    mapping = {int(v): i for i, v in enumerate(x)}
    out_nodes = [int(v) for v in x]
    reindexed = np.empty(len(neighbors), np.int64)
    for i, v in enumerate(neighbors):
        v = int(v)
        if v not in mapping:
            mapping[v] = len(out_nodes)
            out_nodes.append(v)
        reindexed[i] = mapping[v]
    dst = np.repeat(np.arange(len(x), dtype=np.int64), count)
    return (torch.as_tensor(reindexed, device=dev),
            torch.as_tensor(dst, device=dev),
            torch.as_tensor(np.asarray(out_nodes, np.int64), device=dev))
