"""``paddle_tpu_torch.sparse`` against ``paddle_tpu.sparse`` on the CPU:
the same seeded numpy indices and values into both packages, every op
compared through ``to_dense`` (float32, ``RTOL = ATOL = 1e-5``; integer
indices exactly).

By design the port's indices are int64 (torch's sparse index type) and
``coalesce`` keeps only the distinct entries, where the JAX op keeps the
input's static entry count and pads it with out-of-range entries; the
distinct entries come out in the same row-major order (pinned below).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.sparse as js
import paddle_tpu_torch.sparse as ts
from paddle_tpu_torch.framework.dtype import device_scope

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    # a hybrid mesh left set by an earlier JAX test file on this xdist
    # worker would shard the JAX side (and refuse its ServingEngine in
    # later files); these tests compare single-device runs
    from paddle_tpu.distributed import topology
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(None)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with device_scope("cpu"):
        yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol)


def _coo_args(seed, shape=(6, 5), nnz=9, dup=True):
    """Indices (2, nnz) in a shuffled order, one duplicate entry when
    ``dup``, and positive values."""
    r = np.random.RandomState(seed)
    flat = r.choice(shape[0] * shape[1], nnz - int(dup), replace=False)
    if dup:
        flat = np.concatenate([flat, flat[:1]])
    r.shuffle(flat)
    idx = np.stack([flat // shape[1], flat % shape[1]]).astype(np.int64)
    vals = r.uniform(0.5, 2.0, nnz).astype(np.float32)
    return idx, vals, shape


def _pair(seed, layout="coo", **kw):
    idx, vals, shape = _coo_args(seed, **kw)
    j = js.sparse_coo_tensor(idx, vals, shape)
    t = ts.sparse_coo_tensor(idx, vals, shape)
    if layout == "csr":
        return j.to_sparse_csr(), t.to_sparse_csr()
    return j, t


LAYOUTS = ["coo", "csr"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_surface_and_round_trips(layout):
    j, t = _pair(0, layout)
    assert t.layout == j.layout == layout and t.shape == j.shape
    assert t.nnz() == j.nnz()
    close(t.to_dense(), j.to_dense())
    np.testing.assert_array_equal(_np(t.crows()), np.asarray(j.crows()))
    np.testing.assert_array_equal(_np(t.cols()), np.asarray(j.cols()))
    close(t.csr_values(), j.csr_values())
    close(t.to_sparse_coo().to_dense(), j.to_sparse_coo().to_dense())
    close(t.to_sparse_csr().to_dense(), j.to_sparse_csr().to_dense())
    assert t.indices().dtype == torch.int64      # JAX: int32, by design
    assert ts.is_sparse(t) and not ts.is_sparse(t.to_dense())


def test_coo_keeps_the_given_entry_order_as_jax():
    j, t = _pair(1)
    np.testing.assert_array_equal(_np(t.indices()), np.asarray(j.indices()))
    close(t.values(), j.values())


def test_dense_conversions_match_jax():
    r = np.random.RandomState(2)
    dense = r.randn(5, 7).astype(np.float32) * (r.rand(5, 7) < 0.4)
    for conv in ("to_sparse_coo", "to_sparse_csr"):
        j = getattr(js, conv)(jnp.asarray(dense))
        t = getattr(ts, conv)(dense)
        assert t.nnz() == j.nnz() == int((dense != 0).sum())
        np.testing.assert_array_equal(_np(t.indices()),
                                      np.asarray(j.indices()))
        close(t.to_dense(), dense)
    close(ts.to_dense(dense), dense)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_coalesce_in_the_jax_sorted_order(layout):
    j, t = _pair(3, layout)
    cj, ct = js.coalesce(j), ts.coalesce(t)
    close(ct.to_dense(), cj.to_dense())
    # the JAX result pads to the input's entry count with out-of-range
    # entries; its distinct entries lead, in the port's order
    n = ct.nnz()
    assert n == t.nnz() - 1 and ct.layout == layout
    jidx = np.asarray(js.coalesce(js.sparse_coo_tensor(
        *_coo_args(3))).indices())
    np.testing.assert_array_equal(_np(ct.indices()), jidx[:, :n])
    assert (jidx[:, n:] >= np.array(t.shape)[:, None]).all()


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_elementwise_match_jax(op, layout):
    (ja, ta), (jb, tb) = _pair(4, layout), _pair(5, layout)
    if op == "divide":       # b nonzero wherever a is stored
        jb = js.sparse_coo_tensor(np.asarray(ja.indices()),
                                  np.full(ja.nnz(), 2.0, np.float32),
                                  ja.shape)
        tb = ts.sparse_coo_tensor(_np(ta.indices()),
                                  np.full(ta.nnz(), 2.0, np.float32),
                                  ta.shape)
    close(getattr(ts, op)(ta, tb).to_dense(),
          getattr(js, op)(ja, jb).to_dense())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_products_match_jax(layout):
    j, t = _pair(6, layout)
    r = np.random.RandomState(6)
    dense_r = r.randn(5, 3).astype(np.float32)
    dense_l = r.randn(4, 6).astype(np.float32)
    vec = r.randn(5).astype(np.float32)
    inp = r.randn(6, 3).astype(np.float32)
    close(ts.matmul(t, dense_r), js.matmul(j, jnp.asarray(dense_r)))
    close(ts.matmul(dense_l, t), js.matmul(jnp.asarray(dense_l), j))
    close(ts.matmul(dense_l, inp), js.matmul(jnp.asarray(dense_l),
                                             jnp.asarray(inp)))
    close(ts.mv(t, vec), js.mv(j, jnp.asarray(vec)))
    close(ts.addmm(inp, t, dense_r, beta=0.5, alpha=2.0),
          js.addmm(jnp.asarray(inp), j, jnp.asarray(dense_r), beta=0.5,
                   alpha=2.0))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_matmul_matches_jax(layout):
    j, t = _pair(7, layout, dup=False)
    r = np.random.RandomState(7)
    a = r.randn(6, 4).astype(np.float32)
    b = r.randn(4, 5).astype(np.float32)
    mt = ts.masked_matmul(a, b, t)
    mj = js.masked_matmul(jnp.asarray(a), jnp.asarray(b), j)
    assert mt.layout == layout and mt.nnz() == mj.nnz()
    close(mt.to_dense(), mj.to_dense())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_transpose_and_softmax_match_jax(layout):
    j, t = _pair(8, layout)
    tt, jt = ts.transpose(t), js.transpose(j)
    assert tt.shape == jt.shape and tt.layout == layout
    close(tt.to_dense(), jt.to_dense())
    np.testing.assert_array_equal(_np(tt.indices()), np.asarray(jt.indices()))
    assert ts.transpose(t, [0, 1]) is t
    with pytest.raises(Exception):
        ts.transpose(t, [0, 2])
    sm_t, sm_j = ts.softmax(t), js.softmax(j)
    close(sm_t.to_dense(), sm_j.to_dense())
    # each stored row sums to one over its stored entries only
    rows = _np(ts.coalesce(t).indices())[0]
    sums = np.zeros(t.shape[0])
    np.add.at(sums, rows, _np(sm_t.values()))
    close(sums[np.unique(rows)], np.ones(len(np.unique(rows))))


VALUEWISE = ["relu", "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh",
             "atanh", "sqrt", "square", "log1p", "abs", "expm1", "neg"]


@pytest.mark.parametrize("name", VALUEWISE)
def test_valuewise_ops_keep_the_pattern(name):
    idx, vals, shape = _coo_args(9)
    vals = (vals - 1.0) * 0.9          # in (-1, 1): asin / atanh defined
    if name in ("sqrt", "log1p"):
        vals = np.abs(vals)
    j = js.sparse_coo_tensor(idx, vals, shape)
    t = ts.sparse_coo_tensor(idx, vals, shape)
    out_t, out_j = getattr(ts, name)(t), getattr(js, name)(j)
    np.testing.assert_array_equal(_np(out_t.indices()), _np(t.indices()))
    close(out_t.values(), out_j.values())
    close(out_t.to_dense(), out_j.to_dense())


def test_pow_cast_relu_layer_and_attention_match_jax():
    j, t = _pair(10)
    close(ts.pow(t, 3.0).values(), js.pow(j, 3.0).values())
    assert ts.cast(t, "float64").dtype == torch.float64
    assert t.astype(torch.float64).values().dtype == torch.float64
    close(ts.nn.ReLU()(ts.neg(t)).values(), js.nn.ReLU()(js.neg(j)).values())
    close(ts.nn.functional.relu(t).values(),
          js.nn.functional.relu(j).values())
    r = np.random.RandomState(10)
    q, k, v = (r.randn(6, 4).astype(np.float32) for _ in range(3))
    for layout in LAYOUTS:
        jm, tm = _pair(11, layout, shape=(6, 6), nnz=14, dup=False)
        out_t = ts.nn.functional.attention(q, k, v, tm)
        out_j = js.nn.functional.attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jm)
        close(out_t, out_j)
        close(ts.nn.functional.attention(q, k, v, tm, scale=0.3),
              js.nn.functional.attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jm, scale=0.3))


def test_csr_constructor_matches_jax():
    crows = np.array([0, 2, 2, 5], np.int64)
    cols = np.array([1, 3, 0, 2, 3], np.int64)
    vals = np.arange(1, 6, dtype=np.float32)
    t = ts.sparse_csr_tensor(crows, cols, vals, (3, 4))
    j = js.sparse_csr_tensor(crows, cols, vals, (3, 4))
    assert t.layout == "csr"
    close(t.to_dense(), j.to_dense())
    np.testing.assert_array_equal(_np(t.indices()), np.asarray(j.indices()))
    np.testing.assert_array_equal(_np(t.crows()), crows)
