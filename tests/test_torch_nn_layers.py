"""Port parity of the rest of the layers (``paddle_tpu_torch/nn/layers.py``
and ``layers_ext.py``) against the JAX package's on the CPU, over the
layer case table ``paddle_tpu_torch.testing.nn_cases.layer_cases``: the
JAX layer's state goes into the port's through ``convert.load_jax_state``
(so every key, shape and dtype must be the JAX one), the inputs are the
same seeded numpy arrays, and the outputs and the gradients of
``sum(out * ct)`` with respect to every parameter and the case's float
inputs are compared.  Also: ``SpectralNorm``'s buffers (loaded from the
JAX state, advanced only in training), ``Conv2DTranspose``'s unreachable
``output_size``, ``LayerDict`` and ``SyncBatchNorm.convert_sync_batchnorm``,
the public names of ``nn`` / ``nn.functional`` / ``nn.utils`` against the
JAX package's, and that no new constructor runs on the CPU unless asked.

Tolerances: float32 on both sides; values and gradients within 1e-5 of
each tensor's range (absolute floor 1e-6), integer outputs exact.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework.errors import InvalidArgumentError, \
    UnavailableError
from paddle_tpu_torch.testing.nn_cases import layer_cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite's xdist
    workers oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5
CASES = layer_cases()


def _close(got, ref, what, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-1)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _jit(fn, *args):
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile({"xla_backend_optimization_level": 0})(*args)


def _takes_device(cls):
    return "device" in inspect.signature(cls.__init__).parameters


def build(case, device="cpu"):
    """The JAX layer (seeded) and the port's, the JAX state loaded."""
    pt.seed(11)
    jlayer = getattr(jnn, case.cls)(*case.args, **case.kwargs)
    tcls = getattr(tnn, case.cls)
    kw = dict(case.kwargs, device=device) if _takes_device(tcls) \
        else dict(case.kwargs)
    tlayer = tcls(*case.args, **kw)
    state = {k: np.asarray(v) for k, v in jlayer.state_dict().items()}
    if state:
        load_jax_state(tlayer, state)
    else:
        assert not tlayer.state_dict(), case.name
    return jlayer, tlayer, state


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_layer_matches_jax(case):
    jlayer, tlayer, _ = build(case)
    # every variable, buffers too: ``apply`` binds and restores them all
    params = {k: jnp.asarray(v) for k, v in jlayer.state_dict().items()}
    inputs = [jnp.asarray(a) for a in case.inputs]

    def f(p, *g):
        xs = list(inputs)
        for i, v in zip(case.grad, g):
            xs[i] = v
        return _first(jlayer.apply(p, *xs, **case.call))
    primals = [inputs[i] for i in case.grad]
    shape = jax.eval_shape(f, params, *primals).shape
    ct = np.asarray(np.random.RandomState(99).randn(*shape), np.float32)

    def both(p, *g):
        out, vjp = jax.vjp(f, p, *g)
        return out, vjp(jnp.asarray(ct))
    jout, (jpg, *jxg) = _jit(both, params, *primals)

    xs = [torch.from_numpy(np.array(a)) for a in case.inputs]
    for i in case.grad:
        xs[i].requires_grad_()
    tout = _first(tlayer(*xs, **case.call))
    _close(tout, jout, f"{case.name} output")
    (tout * torch.from_numpy(ct)).sum().backward()
    for name, p in tlayer.named_parameters():
        _close(p.grad, jpg[name], f"{case.name} grad {name}")
    assert set(dict(tlayer.named_parameters())) <= set(jpg)
    for i, g in zip(case.grad, jxg):
        _close(xs[i].grad, g, f"{case.name} grad input {i}")


@pytest.mark.parametrize("case", [c for c in CASES if c.name in (
    "Conv2DTranspose", "Conv3D", "InstanceNorm2D", "PReLU", "Bilinear",
    "BatchNorm_act", "HSigmoidLoss", "Conv1DTranspose", "GroupNorm")],
    ids=lambda c: c.name)
def test_state_dict_keys_shapes_dtypes_are_jax(case):
    _, tlayer, state = build(case)
    tsd = tlayer.state_dict()
    assert list(tsd) == list(state)
    for k, v in state.items():
        assert tuple(tsd[k].shape) == v.shape, k
        assert str(tsd[k].dtype).split(".")[-1] == str(v.dtype), k


def test_prelu_and_instance_norm_defaults_are_jax():
    p = tnn.PReLU(3, device="cpu")
    assert torch.equal(p.weight, torch.full((3,), 0.25))
    n = tnn.InstanceNorm2D(3, device="cpu")
    assert list(n.state_dict()) == ["scale", "bias"]


def test_conv2d_transpose_output_size_out_of_reach_is_refused():
    layer = tnn.Conv2DTranspose(2, 2, 3, stride=2, device="cpu")
    x = torch.zeros(1, 2, 4, 4)
    assert tuple(layer(x, output_size=(10, 9)).shape) == (1, 2, 10, 9)
    with pytest.raises(InvalidArgumentError):
        layer(x, output_size=(11, 9))


def test_spectral_norm_layer_matches_jax_and_updates_only_in_training():
    pt.seed(12)
    shape = (6, 3, 2, 2)
    jsn = jnn.SpectralNorm(shape, dim=1, power_iters=2)
    tsn = tnn.SpectralNorm(shape, dim=1, power_iters=2, device="cpu")
    state = {k: np.asarray(v) for k, v in jsn.state_dict().items()}
    assert sorted(state) == ["weight_u", "weight_v"]
    assert state["weight_u"].shape == (3,) and state["weight_v"].shape == (24,)
    tsn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    w = np.random.RandomState(13).randn(*shape).astype(np.float32)
    ct = np.random.RandomState(14).randn(*shape).astype(np.float32)
    # one training forward: its output, gradient and updated u / v
    jout, vjp, jnew = jax.vjp(
        lambda w: jsn.apply(dict(jsn.state_dict()), w, mutable=True),
        jnp.asarray(w), has_aux=True)
    tw = torch.from_numpy(w.copy()).requires_grad_()
    tout = tsn(tw)
    _close(tout, jout, "spectral norm output")
    (tout * torch.from_numpy(ct)).sum().backward()
    _close(tw.grad, vjp(jnp.asarray(ct))[0], "spectral norm grad")
    for k in ("weight_u", "weight_v"):
        _close(tsn.state_dict()[k], jnew[k], f"updated {k}")
    tsn.eval()
    before = {k: v.clone() for k, v in tsn.state_dict().items()}
    tsn(tw)
    for k, v in tsn.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_layer_dict_and_convert_sync_batchnorm():
    d = tnn.LayerDict({"a": tnn.Linear(2, 3, device="cpu"),
                       "b": tnn.BatchNorm1D(3, device="cpu")})
    assert list(d.state_dict())[:2] == ["a.weight", "a.bias"]
    assert "b._mean" in d.state_dict()
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(d)
    assert isinstance(out["b"], tnn.SyncBatchNorm)
    assert out["b"]._mean is d["b"]._mean
    assert isinstance(tnn.ParameterList(), torch.nn.ParameterList)


def _own_public(module):
    """Functions and classes ``module`` defines itself, public names."""
    return {n for n, o in vars(module).items() if not n.startswith("_")
            and (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == module.__name__}


def test_public_names_match_the_jax_package():
    from paddle_tpu.nn import _functional_ext as jfe
    from paddle_tpu.nn import functional as jF
    from paddle_tpu.nn import layers as jl
    from paddle_tpu.nn import layers_ext as jle
    from paddle_tpu.nn import rnn as jrnn
    from paddle_tpu.nn import utils as jutils
    from paddle_tpu_torch.nn import functional as tF
    layer_names = (_own_public(jl) | set(jle.__all__) | set(jrnn.__all__)
                   | {"RNNCellBase"}) - {"Layer", "Parameter"}
    fn_names = _own_public(jF) | set(jfe.__all__)
    assert sorted(n for n in layer_names if not hasattr(tnn, n)) == []
    assert sorted(n for n in fn_names if not hasattr(tF, n)) == []
    assert sorted(n for n in jutils.__all__
                  if not hasattr(tnn.utils, n)) == []
    assert set(tnn.__all__) >= layer_names
    assert set(tF.__all__) >= fn_names


@pytest.mark.parametrize("make", [
    lambda: tnn.GroupNorm(2, 4), lambda: tnn.Conv1D(2, 2, 3),
    lambda: tnn.Conv3D(2, 2, 3), lambda: tnn.Conv2DTranspose(2, 2, 3),
    lambda: tnn.InstanceNorm2D(3), lambda: tnn.SpectralNorm((3, 4)),
    lambda: tnn.PReLU(), lambda: tnn.Bilinear(2, 3, 4),
    lambda: tnn.Conv1DTranspose(2, 2, 3), lambda: tnn.Conv3DTranspose(
        2, 2, 3), lambda: tnn.BatchNorm(3), lambda: tnn.SyncBatchNorm(3),
    lambda: tnn.HSigmoidLoss(4, 5), lambda: tnn.LSTM(3, 4),
    lambda: tnn.GRU(3, 4), lambda: tnn.SimpleRNN(3, 4),
    lambda: tnn.LSTMCell(3, 4), lambda: tnn.GRUCell(3, 4),
    lambda: tnn.SimpleRNNCell(3, 4)])
def test_entry_points_need_a_card_unless_cpu_is_asked(make):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(UnavailableError):
        make()
