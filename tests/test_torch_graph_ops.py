"""The port's graph and segment ops (``paddle_tpu_torch/incubate/
graph_ops.py``) against the JAX package's on the CPU: the segment
reductions, an empty segment included (the JAX values: 0 for sum and mean,
-inf / the integer minimum for max, +inf / the maximum for min),
``graph_send_recv`` in every pool with rows that receive nothing,
``graph_reindex``, and the samplers by their invariants (they draw from
the framework's streams, so their picks are not the JAX package's).
float32: 1e-6 relative and absolute; integers exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.incubate as jinc
import paddle_tpu_torch.incubate as tinc
from paddle_tpu_torch.framework import dtype as fw_dtype
from paddle_tpu_torch.framework import random as fw_random


@pytest.fixture(autouse=True)
def _on_cpu():
    """Outputs of numpy-only calls land on the CPU; the current device is
    restored afterwards."""
    with fw_dtype.device_scope("cpu"):
        yield


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ids with an empty segment (2) between used ones
IDS = np.array([0, 0, 1, 3, 3, 3], np.int32)


@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op in ("segment_sum", "segment_mean", "segment_max",
                        "segment_min") for dt in (np.float32, np.int32)
    if (op, dt) != ("segment_mean", np.int32)])
def test_segments_with_an_empty_one_match_jax(op, dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 3) * 4).astype(dtype)
    got = getattr(tinc, op)(torch.as_tensor(x), torch.as_tensor(IDS))
    want = getattr(jinc, op)(jnp.asarray(x), IDS)
    assert got.shape == (4, 3)
    _close(got, want)


def test_segment_ids_from_numpy_and_no_ids():
    x = torch.ones(3, 2)
    out = tinc.segment_sum(x, np.array([1, 1, 0]))
    assert out.tolist() == [[1.0, 1.0], [2.0, 2.0]]
    with pytest.raises(Exception, match="at least one"):
        tinc.segment_sum(torch.ones(0, 2), torch.zeros(0, dtype=torch.long))


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("out_size", [None, 7])
def test_graph_send_recv_matches_jax(pool, out_size):
    rng = np.random.RandomState(1)
    x = rng.randn(5, 4).astype(np.float32)
    src = np.array([0, 1, 2, 3, 4, 0, 2], np.int32)
    dst = np.array([1, 1, 3, 3, 3, 0, 0], np.int32)   # rows 2, 4 get nothing
    got = tinc.graph_send_recv(torch.as_tensor(x), src, dst, pool,
                               out_size=out_size)
    want = jinc.graph_send_recv(jnp.asarray(x), src, dst, pool,
                                out_size=out_size)
    _close(got, want)
    assert float(got[2].abs().sum()) == 0.0


def test_graph_send_recv_gradient():
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = tinc.graph_send_recv(x, [0, 1, 2], [1, 1, 3], "sum")
    y.sum().backward()
    assert x.grad.tolist() == [[1.0] * 3] * 3 + [[0.0] * 3]
    with pytest.raises(Exception, match="pool_type"):
        tinc.graph_send_recv(x, [0], [0], "median")


def test_graph_reindex_matches_jax():
    x = np.array([10, 20, 30], np.int64)
    neighbors = np.array([20, 40, 10, 50, 40, 60], np.int64)
    count = np.array([2, 3, 1], np.int32)
    got = tinc.graph_reindex(torch.as_tensor(x), torch.as_tensor(neighbors),
                             torch.as_tensor(count))
    want = jinc.graph_reindex(x, neighbors, count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _csc():
    # 6 nodes; column j lists the in-neighbors of node j
    cols = [[1, 2, 3], [0, 2], [0, 1, 3, 4, 5], [2], [], [0, 1, 2, 3]]
    colptr = np.cumsum([0] + [len(c) for c in cols]).astype(np.int64)
    row = np.concatenate([np.asarray(c, np.int64) for c in cols])
    return row, colptr, cols


@pytest.mark.parametrize("size", [-1, 2])
def test_graph_sample_neighbors_invariants(size):
    row, colptr, cols = _csc()
    nodes = np.array([2, 4, 5], np.int64)
    fw_random.seed(3)
    out, cnt, eids = tinc.graph_sample_neighbors(
        torch.as_tensor(row), torch.as_tensor(colptr), nodes,
        sample_size=size, return_eids=True)
    jout, jcnt = jinc.graph_sample_neighbors(row, colptr, nodes,
                                             sample_size=size)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    pos = 0
    for node, c in zip(nodes, cnt.tolist()):
        picked = out[pos:pos + c].tolist()
        assert len(set(picked)) == c and set(picked) <= set(cols[node])
        assert row[eids[pos:pos + c].numpy()].tolist() == picked
        pos += c
    if size < 0:
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # the same seed draws the same sample
    fw_random.seed(3)
    again = tinc.graph_sample_neighbors(row, colptr, nodes, sample_size=size)
    assert torch.equal(again[0], out.to(again[0].device))


def test_graph_khop_sampler_invariants():
    row, colptr, cols = _csc()
    nodes = np.array([5, 2], np.int64)
    src, dst, index, reindex, eids = tinc.graph_khop_sampler(
        torch.as_tensor(row), torch.as_tensor(colptr), nodes, [2, 2],
        return_eids=True)
    jsrc, jdst, jindex, jreindex = jinc.graph_khop_sampler(
        row, colptr, nodes, [-1, -1])
    index = index.tolist()
    assert index[:2] == [5, 2] and reindex.tolist() == [0, 1]
    assert np.asarray(jindex)[:2].tolist() == [5, 2]
    assert len(set(index)) == len(index) and len(src) == len(dst) == len(eids)
    for s, d, e in zip(src.tolist(), dst.tolist(), eids.tolist()):
        assert index[s] in cols[index[d]] and row[e] == index[s]
    # no limit: every edge of both hops, as the JAX sampler gives them
    full = tinc.graph_khop_sampler(row, colptr, nodes, [-1, -1])
    for g, w in zip(full, (jsrc, jdst, jindex, jreindex)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_incubate_exports_as_jax():
    want = {"graph_send_recv", "graph_khop_sampler", "graph_sample_neighbors",
            "graph_reindex", "segment_sum", "segment_mean", "segment_max",
            "segment_min", "softmax_mask_fuse",
            "softmax_mask_fuse_upper_triangle", "nn"}
    assert want <= set(tinc.__all__) and want <= set(jinc.__all__)
    x = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    m = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    np.testing.assert_allclose(
        tinc.softmax_mask_fuse(torch.as_tensor(x), torch.as_tensor(m)).numpy(),
        np.asarray(jinc.softmax_mask_fuse(x, m)), rtol=1e-6, atol=1e-6)
