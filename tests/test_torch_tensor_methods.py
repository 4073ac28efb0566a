"""The paddle methods of the PyTorch port on ``torch.Tensor``
(``paddle_tpu_torch/framework/tensor_methods.py``) against the JAX
package's methods on its arrays.

``torch.Tensor`` already has 149 of the JAX package's 191 method names;
they keep torch's meaning (pinned below where it differs), and the port
installs exactly the 42 it lacks, changing no attribute torch has (checked
in a fresh process).  Each installed method gives the value of the JAX
package's method on the same input: float32 1e-6, integers exact."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt  # noqa: F401  (installs the JAX methods)
import paddle_tpu_torch as tpt
from paddle_tpu.framework.tensor_methods import \
    INSTALLED_METHODS as JAX_METHODS
from paddle_tpu_torch.framework import dtype as fw_dtype
from paddle_tpu_torch.framework.tensor_methods import (INSTALLED_METHODS,
                                                       METHOD_NAMES)

REPO = pathlib.Path(__file__).resolve().parent.parent

LACKED = ["cast", "mod", "greater_than", "less_than", "cond", "eigvals",
          "eigvalsh", "increment", "multiplex", "scale", "scale_", "stanh",
          "add_n", "floor_mod", "broadcast_shape", "equal_all", "is_empty",
          "is_tensor", "concat", "flatten_", "gather_nd", "reshape_",
          "reverse", "scatter_nd_add", "scatter_nd", "shard_index", "slice",
          "tensordot", "stack", "strided_slice", "unstack", "index_sample",
          "is_integer", "rank", "broadcast_tensors", "multi_dot",
          "lu_unpack", "as_complex", "as_real", "take_along_axis",
          "put_along_axis", "put_along_axis_"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with fw_dtype.device_scope("cpu"):
        yield


def test_installs_exactly_the_42_names_torch_lacks():
    assert sorted(INSTALLED_METHODS) == sorted(LACKED)
    assert len(set(JAX_METHODS)) == 191
    assert set(JAX_METHODS) <= set(METHOD_NAMES)
    owned = [n for n in JAX_METHODS if n not in INSTALLED_METHODS]
    assert len(owned) == 149
    assert all(n in dir(torch.Tensor) for n in JAX_METHODS)


def test_existing_torch_attributes_are_untouched_in_a_fresh_process():
    code = (
        "import inspect, torch\n"
        "before = {n: inspect.getattr_static(torch.Tensor, n)\n"
        "          for n in dir(torch.Tensor)}\n"
        "import paddle_tpu_torch\n"
        "after = {n: inspect.getattr_static(torch.Tensor, n)\n"
        "         for n in dir(torch.Tensor)}\n"
        "changed = [n for n in before if after[n] is not before[n]]\n"
        "assert not changed, changed\n"
        "added = sorted(set(after) - set(before))\n"
        "print(','.join(added))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert sorted(out.stdout.strip().split(",")) == sorted(LACKED)


X = np.random.RandomState(0).randn(3, 4).astype(np.float32)
SPD = (X[:, :3].T @ X[:, :3] + 3 * np.eye(3)).astype(np.float32)
IDX = np.array([[0, 2], [1, 1], [3, 0]], np.int64)

# name -> (receiver, args): the method is called on the receiver with the
# args, on both packages' arrays
CALLS = {
    "cast": (X, ("float64",)), "mod": (X, (0.7,)),
    "greater_than": (X, (X[0],)), "less_than": (X, (X[:, :1],)),
    "cond": (SPD, ()), "eigvals": (SPD, ()), "eigvalsh": (SPD, ()),
    "increment": (X[:1, :1], (3.0,)), "multiplex": (
        np.stack([X, -X]), (np.array([1, 0, 1]),)),
    "scale": (X, (2.0, 0.5)), "stanh": (X, ()), "add_n": (X, ()),
    "floor_mod": (X, (0.3,)), "equal_all": (X, (X,)),
    "is_empty": (X, ()), "is_tensor": (X, ()), "concat": (X, (0,)),
    "gather_nd": (X, (IDX[:, :2] % 3,)), "reverse": (X, ([0, 1],)),
    "scatter_nd_add": (X, (np.array([[0], [2]]), X[:2])),
    "scatter_nd": (np.array([[1], [0]]), (X[:2], [3, 4])),
    "shard_index": (np.array([0, 5, 9], np.int64), (10, 2, 1)),
    "slice": (X, ([1], [1], [3])),
    "tensordot": (X, (X.T, 1)), "stack": (X, (1,)),
    "strided_slice": (X, ([1], [3], [0], [-1])), "unstack": (X, ()),
    "index_sample": (X, (IDX % 4,)), "is_integer": (X, ()),
    "rank": (X, ()), "broadcast_tensors": (X, ()),
    "multi_dot": (np.stack([SPD, SPD]), ()),
    "as_complex": (X.reshape(3, 2, 2), ()), "as_real": (X, ()),
    "take_along_axis": (X, (IDX % 4, 1)),
    "put_along_axis": (X, (IDX % 4, 9.0, 1)),
}


def _t(a):
    return torch.as_tensor(np.array(a, copy=True)) if isinstance(
        a, np.ndarray) else a


def _j(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _values(x):
    if isinstance(x, (list, tuple)):
        return [_values(v) for v in x]
    return fw_dtype.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_installed_method_matches_jax(name):
    recv, args = CALLS[name]
    got = getattr(_t(recv), name)(*[_t(a) for a in args])
    want = getattr(_j(recv), name)(*[_j(a) for a in args])
    if name == "is_tensor":
        assert got is True and want is True
        return
    g, w = _values(got), _values(want)
    if name == "eigvals":
        g, w = np.sort_complex(g), np.sort_complex(w)
    np.testing.assert_allclose(np.asarray(g, dtype=np.asarray(w).dtype)
                               if not isinstance(g, list) else g, w,
                               rtol=1e-5, atol=1e-5)


def test_broadcast_shape_and_lu_unpack_methods():
    assert torch.tensor([2, 1]).broadcast_shape([1, 3]) == [2, 3]
    lu, piv = tpt.linalg.lu(torch.as_tensor(SPD))
    p, l, u = lu.lu_unpack(piv)
    np.testing.assert_allclose((p @ l @ u).numpy(), SPD, rtol=1e-5,
                               atol=1e-5)


def test_in_place_methods_write_into_the_tensor():
    x = torch.as_tensor(X.copy())
    assert x.scale_(2.0, 1.0) is x
    np.testing.assert_allclose(x.numpy(), X * 2 + 1, rtol=1e-6)
    y = torch.as_tensor(X.copy())
    assert y.put_along_axis_(torch.as_tensor(IDX % 4), 0.0, 1) is y
    np.testing.assert_allclose(y.numpy(), np.asarray(jnp.asarray(X)
                               .put_along_axis(jnp.asarray(IDX % 4), 0.0,
                                               1)))
    z = torch.as_tensor(X.copy())
    assert z.flatten_() is z and tuple(z.shape) == (12,)
    assert z.reshape_([6, 2]) is z and tuple(z.shape) == (6, 2)
    np.testing.assert_array_equal(z.numpy(), X.reshape(6, 2))


def test_torch_owned_names_keep_torchs_meaning():
    x = torch.as_tensor(X)
    jx = jnp.asarray(X)
    # max(axis): torch gives values and indices, JAX the values
    out = x.max(1)
    assert isinstance(out, tuple) and torch.equal(out.indices,
                                                  x.argmax(1))
    np.testing.assert_allclose(out.values.numpy(), np.asarray(jx.max(1)))
    # split(n): torch pieces of size n, the JAX method n sections
    assert [tuple(p.shape) for p in x.split(1)] == [(1, 4)] * 3
    assert [tuple(p.shape) for p in jx.split(1)] == [(3, 4)]
    # transpose: torch swaps two dims, JAX permutes
    assert tuple(x.transpose(0, 1).shape) == (4, 3)
    assert tuple(jx.transpose((1, 0)).shape) == (4, 3)
    # flip / expand: the same values through torch's own methods
    np.testing.assert_array_equal(x.flip([0]).numpy(),
                                  np.asarray(jx.flip(0)))
    np.testing.assert_array_equal(x[:1].expand(3, 4).numpy(),
                                  np.asarray(jx[:1].expand((3, 4))))
    # numpy / cpu / detach / dim are torch's
    assert x.dim() == 2 and x.cpu() is x
