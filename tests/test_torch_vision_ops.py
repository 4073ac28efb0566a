"""Port parity of the vision slice's functional ops and layers
(``paddle_tpu_torch/nn/functional.py``, ``nn/layers.py``) on the CPU: the
same seeded numpy inputs through the JAX op and the port's, values and
every gradient (a vector-Jacobian product with one seeded cotangent).

- ``conv2d`` over stride, int / pair / ``"SAME"`` (stride 2, and an even
  kernel: asymmetric pads) / ``"VALID"`` padding, dilation, groups and both
  data formats, with and without a bias; ``conv1d``;
- ``max_pool2d`` / ``avg_pool2d`` with padding (above half the kernel too),
  ``return_mask``, NHWC; the adaptive pools at divisible and non-divisible
  sizes;
- ``batch_norm``: outputs, gradients and the running statistics over three
  training steps then eval, for ``BatchNorm1D`` (2-D and 3-D inputs),
  ``2D``, ``3D`` and NHWC;
- the activations with inputs at their kinks (exact zeros: relu's gradient
  is 0.5 there, as ``jnp.maximum``'s);
- the O1 casts: conv2d computes in bf16, batch_norm in float32 and returns
  bf16;
- ``group_norm``, ``flatten``, ``one_hot``, ``nll_loss``, ``mse_loss``.

Tolerances, float32 on both sides: elementwise ops and pools 1e-6 of the
output's range (the same arithmetic); convolutions, adaptive means and
gradients through sums 1e-5 of the range (another summation order);
batch_norm 2e-5 of the range for outputs and gradients and 1e-6 absolute
for the running statistics.  ``batch_norm`` is torch's library op:
its batch variance is the two-pass one where JAX's is ``E[x^2] - mean^2``,
which differ by float32 rounding of the mean's square (inputs of mean ~1
and spread ~1 here: a few 1e-7).  Under O1, bf16 outputs within 1e-2 of
the range (an 8-bit mantissa); masks and integer outputs exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF


def _close(got, ref, what, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * max(float(np.abs(ref).max()), 1.0)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _vjp_both(jfn, tfn, args, tol, seed=1, kw=None):
    """Values and the gradients of every argument, both packages."""
    kw = kw or {}
    y, vjp = jax.vjp(lambda *a: jfn(*a, **kw), *[jnp.asarray(a)
                                                 for a in args])
    ct = np.random.RandomState(seed).randn(*y.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = tfn(*ts, **kw)
    out.backward(torch.from_numpy(ct))
    _close(out.detach(), y, "value", tol)
    for i, (t, g) in enumerate(zip(ts, jgrads)):
        _close(t.grad, g, f"grad of argument {i}", tol)
    return out


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- conv -------------------------------------------------------------------
CONV_CASES = {
    # tag: (x shape, w shape, kwargs, bias)
    "stride1_pad0": ((2, 3, 9, 9), (4, 3, 3, 3), {}, True),
    "stride2_pad1": ((2, 3, 9, 9), (4, 3, 3, 3),
                     {"stride": 2, "padding": 1}, True),
    "pair_padding": ((2, 3, 9, 10), (4, 3, 3, 5),
                     {"stride": (2, 1), "padding": (1, 2)}, False),
    "same_stride2": ((2, 3, 10, 9), (4, 3, 3, 3),
                     {"stride": 2, "padding": "SAME"}, True),
    "same_even_kernel": ((2, 3, 8, 8), (4, 3, 4, 2),
                         {"padding": "same"}, False),
    "valid": ((2, 3, 9, 9), (4, 3, 3, 3),
              {"stride": 2, "padding": "VALID"}, True),
    "dilation": ((2, 3, 11, 11), (4, 3, 3, 3),
                 {"dilation": 2, "padding": 2}, False),
    "groups": ((2, 4, 8, 8), (6, 2, 3, 3), {"groups": 2, "padding": 1},
               True),
    "nhwc": ((2, 9, 9, 3), (4, 3, 3, 3),
             {"stride": 2, "padding": 1, "data_format": "NHWC"}, True),
    "nhwc_same_stride2": ((2, 10, 9, 3), (4, 3, 3, 3),
                          {"stride": 2, "padding": "SAME",
                           "data_format": "NHWC"}, False),
}


@pytest.mark.parametrize("tag", sorted(CONV_CASES))
def test_conv2d_matches_jax(tag):
    xs, ws, kw, with_bias = CONV_CASES[tag]
    args = [_rand(*xs), _rand(*ws, seed=1)]
    if with_bias:
        args.append(_rand(ws[0], seed=2))
    _vjp_both(JF.conv2d, TF.conv2d, args, 1e-5, kw=kw)


def test_conv1d_matches_jax():
    _vjp_both(JF.conv1d, TF.conv1d,
              [_rand(2, 3, 12), _rand(5, 3, 3, seed=1), _rand(5, seed=2)],
              1e-5, kw={"stride": 2, "padding": 1})


def test_conv2d_refuses_a_channel_mismatch():
    with pytest.raises(Exception, match="does not fit"):
        TF.conv2d(torch.zeros(1, 3, 4, 4), torch.zeros(2, 2, 1, 1))


# -- pools ------------------------------------------------------------------
POOL_CASES = {
    "max_k3_s2_p1": ("max", (3, 2, 1), "NCHW"),
    "max_k2": ("max", (2, None, 0), "NCHW"),
    "max_pad_above_half": ("max", (3, 1, 2), "NCHW"),
    "max_nhwc": ("max", (3, 2, 1), "NHWC"),
    "avg_k3_s2_p1": ("avg", (3, 2, 1), "NCHW"),
    "avg_k2": ("avg", (2, None, 0), "NCHW"),
    "avg_pad_above_half": ("avg", ((3, 2), 1, (2, 1)), "NCHW"),
    "avg_nhwc": ("avg", (3, 2, 1), "NHWC"),
}


@pytest.mark.parametrize("tag", sorted(POOL_CASES))
def test_pool_matches_jax(tag):
    kind, (k, s, p), fmt = POOL_CASES[tag]
    x = _rand(2, 3, 9, 8) if fmt == "NCHW" else _rand(2, 9, 8, 3)
    jfn, tfn = ((JF.max_pool2d, TF.max_pool2d) if kind == "max"
                else (JF.avg_pool2d, TF.avg_pool2d))
    _vjp_both(jfn, tfn, [x], 1e-6,
              kw={"kernel_size": k, "stride": s, "padding": p,
                  "data_format": fmt})


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool_mask_matches_jax(k, s, p):
    x = _rand(2, 3, 9, 8)
    x[0, 0] = -5.0 - np.abs(x[0, 0])     # negative maxima next to padding
    jy, jm = JF.max_pool2d(jnp.asarray(x), k, s, p, return_mask=True)
    ty, tm = TF.max_pool2d(torch.from_numpy(x), k, s, p, return_mask=True)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


ADAPTIVE_CASES = {
    "avg_divisible": ("avg", (8, 8), (4, 2)),
    "avg_non_divisible": ("avg", (7, 9), (3, 4)),
    "avg_to_one": ("avg", (5, 6), (1, 1)),
    "max_divisible": ("max", (8, 8), (4, 4)),
    "max_non_divisible": ("max", (7, 9), (3, 4)),
}


@pytest.mark.parametrize("tag", sorted(ADAPTIVE_CASES))
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_adaptive_pool_matches_jax(tag, fmt):
    kind, (h, w), out = ADAPTIVE_CASES[tag]
    x = _rand(2, 3, h, w) if fmt == "NCHW" else _rand(2, h, w, 3)
    jfn, tfn = ((JF.adaptive_avg_pool2d, TF.adaptive_avg_pool2d)
                if kind == "avg" else
                (JF.adaptive_max_pool2d, TF.adaptive_max_pool2d))
    _vjp_both(jfn, tfn, [x], 1e-5,
              kw={"output_size": out, "data_format": fmt})


# -- batch norm -------------------------------------------------------------
BN_CASES = {
    # tag: (layer name, x shape, data_format)
    "1d_nc": ("BatchNorm1D", (8, 5), "NCL"),
    "1d_ncl": ("BatchNorm1D", (4, 5, 6), "NCL"),
    "2d": ("BatchNorm2D", (4, 5, 6, 7), "NCHW"),
    "2d_nhwc": ("BatchNorm2D", (4, 6, 7, 5), "NHWC"),
    "3d": ("BatchNorm3D", (2, 5, 3, 4, 5), "NCDHW"),
}


@pytest.mark.parametrize("tag", sorted(BN_CASES))
def test_batch_norm_layer_matches_jax(tag):
    """Three training steps (outputs, gradients of x / weight / bias, the
    running statistics after each, JAX's carried from ``apply(...,
    mutable=True)``) then eval, through the layers."""
    name, shape, fmt = BN_CASES[tag]
    jl = getattr(jnn, name)(5, momentum=0.8, data_format=fmt)
    tl = getattr(tnn, name)(5, momentum=0.8, data_format=fmt, device="cpu")
    r = np.random.RandomState(3)
    w = (1 + 0.1 * r.randn(5)).astype(np.float32)
    b = r.randn(5).astype(np.float32)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(b))
    stats = {"_mean": jnp.zeros(5), "_variance": jnp.ones(5)}
    for step in range(3):
        x = (1.0 + r.randn(*shape)).astype(np.float32)
        ct = r.randn(*shape).astype(np.float32)

        def fwd(x, w, b):
            return jl.apply({"weight": w, "bias": b, **stats}, x,
                            mutable=True)
        y, vjp, newv = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), has_aux=True)
        jg = vjp(jnp.asarray(ct))
        stats = {k: newv[k] for k in stats}
        tx = torch.tensor(x, requires_grad=True)
        tl.weight.grad = tl.bias.grad = None
        ty = tl(tx)
        ty.backward(torch.from_numpy(ct))
        _close(ty.detach(), y, f"step {step} y", 2e-5)
        for got, ref, what in ((tx.grad, jg[0], "dx"),
                               (tl.weight.grad, jg[1], "dweight"),
                               (tl.bias.grad, jg[2], "dbias")):
            _close(got, ref, f"step {step} {what}", 2e-5)
        for k in stats:
            np.testing.assert_allclose(getattr(tl, k).numpy(),
                                       np.asarray(stats[k]), atol=1e-6,
                                       rtol=0, err_msg=f"step {step} {k}")
    jl.eval()
    tl.eval()
    x = r.randn(*shape).astype(np.float32)
    jy = jl.apply({"weight": jnp.asarray(w), "bias": jnp.asarray(b),
                   **stats}, jnp.asarray(x))
    _close(tl(torch.from_numpy(x)).detach(), jy, "eval y", 2e-5)
    assert tl._mean.dtype == tl._variance.dtype == torch.float32
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_function_matches_jax(training):
    """The functional form returns the new statistics and leaves the ones
    it was given as they were."""
    r = np.random.RandomState(4)
    x = (2.0 + r.randn(6, 4, 5, 5)).astype(np.float32)
    rm, rv = r.randn(4).astype(np.float32), (1 + r.rand(4)).astype(np.float32)
    jy, jm, jv = JF.batch_norm(jnp.asarray(x), jnp.asarray(rm),
                               jnp.asarray(rv), training=training)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    ty, tm, tv = TF.batch_norm(torch.from_numpy(x), trm, trv,
                               training=training)
    _close(ty, jy, "y", 2e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(trm.numpy(), rm)
    np.testing.assert_array_equal(trv.numpy(), rv)


def test_batch_norm_one_value_per_channel_matches_jax():
    """n = 1 (torch refuses it in training): the JAX formula."""
    x = _rand(1, 3)
    rm, rv = _rand(3, seed=1), 1 + np.abs(_rand(3, seed=2))
    jy, jm, jv = JF.batch_norm(jnp.asarray(x), jnp.asarray(rm),
                               jnp.asarray(rv), training=True)
    ty, tm, tv = TF.batch_norm(torch.from_numpy(x), torch.from_numpy(rm),
                               torch.from_numpy(rv), training=True)
    _close(ty, jy, "y", 1e-6)
    _close(tm, jm, "mean", 1e-6)
    _close(tv, jv, "var", 1e-6)


# -- activations --------------------------------------------------------------
KINKS = np.array([-6.0, -3.0, -1.0, 0.0, 0.0, 1.0, 3.0, 6.0, 7.5, -0.5],
                 np.float32)


@pytest.mark.parametrize("name", ["relu", "relu6", "silu", "sigmoid",
                                  "leaky_relu", "hardswish", "hardsigmoid",
                                  "softmax", "log_softmax"])
def test_activation_matches_jax_at_kinks(name):
    x = np.stack([KINKS, _rand(10)])
    _vjp_both(getattr(JF, name), getattr(TF, name), [x], 1e-6)


def test_relu_gradient_at_zero_is_half():
    x = torch.zeros(4, requires_grad=True)
    TF.relu(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full(4, 0.5, np.float32))
    # and so through the layer, in bf16 (where exact zeros are common)
    xb = torch.zeros(3, dtype=torch.bfloat16, requires_grad=True)
    tnn.ReLU()(xb).sum().backward()
    assert xb.grad.tolist() == [0.5, 0.5, 0.5]


# -- O1 casts ---------------------------------------------------------------
def test_conv2d_o1_computes_in_bf16():
    x, w, b = _rand(2, 3, 8, 8), _rand(4, 3, 3, 3, seed=1), _rand(4, seed=2)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jy = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       padding=1)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        ty = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), padding=1)
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    _close(ty.float(), np.asarray(jy, np.float32), "y", 1e-2)


def test_batch_norm_o1_computes_in_float32_and_returns_bf16():
    r = np.random.RandomState(5)
    x = (1 + r.randn(4, 3, 6, 6)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    ones, zeros = np.ones(3, np.float32), np.zeros(3, np.float32)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jy, jm, jv = JF.batch_norm(jx, jnp.asarray(zeros), jnp.asarray(ones),
                                   jnp.asarray(ones), jnp.asarray(zeros),
                                   training=True)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        ty, tm, tv = TF.batch_norm(xb, torch.zeros(3), torch.ones(3),
                                   torch.ones(3), torch.zeros(3),
                                   training=True)
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    assert tm.dtype == tv.dtype == torch.float32
    _close(ty.float(), np.asarray(jy, np.float32), "y", 1e-2)
    # the statistics of the same bf16 values, in float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)


# -- the rest -----------------------------------------------------------------
def test_group_norm_matches_jax():
    _vjp_both(lambda x, w, b: JF.group_norm(x, 3, w, b),
              lambda x, w, b: TF.group_norm(x, 3, w, b),
              [_rand(2, 6, 4, 5), _rand(6, seed=1), _rand(6, seed=2)], 2e-5)


@pytest.mark.parametrize("start,stop", [(0, -1), (1, -1), (1, 2)])
def test_flatten_matches_jax(start, stop):
    x = _rand(2, 3, 4, 5)
    np.testing.assert_array_equal(
        TF.flatten(torch.from_numpy(x), start, stop).numpy(),
        np.asarray(JF.flatten(jnp.asarray(x), start, stop)))


def test_one_hot_matches_jax():
    ids = np.array([[0, 3], [2, 1]], np.int64)
    np.testing.assert_array_equal(
        TF.one_hot(torch.from_numpy(ids), 4).numpy(),
        np.asarray(JF.one_hot(jnp.asarray(ids), 4)))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match_jax(reduction):
    logp = np.log(np.random.RandomState(6).dirichlet(np.ones(5), 8)
                  ).astype(np.float32)
    label = np.random.RandomState(7).randint(0, 5, 8)
    _close(TF.nll_loss(torch.from_numpy(logp), torch.from_numpy(label),
                       reduction),
           JF.nll_loss(jnp.asarray(logp), jnp.asarray(label), reduction),
           "nll", 1e-6)
    a, b = _rand(4, 3), _rand(4, 3, seed=1)
    _close(TF.mse_loss(torch.from_numpy(a), torch.from_numpy(b), reduction),
           JF.mse_loss(jnp.asarray(a), jnp.asarray(b), reduction), "mse",
           1e-6)


def test_cross_entropy_loss_layer_matches_jax():
    logits, label = _rand(6, 5), np.random.RandomState(8).randint(0, 5, 6)
    _close(tnn.CrossEntropyLoss()(torch.from_numpy(logits),
                                  torch.from_numpy(label)),
           jnn.CrossEntropyLoss()(jnp.asarray(logits), jnp.asarray(label)),
           "loss", 1e-6)


def test_layers_forward_as_jax():
    """Conv2D / pools / Flatten / Identity / activation layers on the same
    weights."""
    jc = jnn.Conv2D(3, 4, 3, stride=2, padding="SAME")
    tc = tnn.Conv2D(3, 4, 3, stride=2, padding="SAME", device="cpu")
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(np.asarray(jc.weight.value)))
        tc.bias.copy_(torch.from_numpy(np.asarray(jc.bias.value)))
    x = _rand(2, 3, 9, 9)
    for jl, tl in ((jc, tc), (jnn.MaxPool2D(3, 2, 1), tnn.MaxPool2D(3, 2, 1)),
                   (jnn.AvgPool2D(2), tnn.AvgPool2D(2)),
                   (jnn.AdaptiveAvgPool2D(2), tnn.AdaptiveAvgPool2D(2)),
                   (jnn.AdaptiveMaxPool2D(2), tnn.AdaptiveMaxPool2D(2)),
                   (jnn.Flatten(), tnn.Flatten()),
                   (jnn.Identity(), tnn.Identity()),
                   (jnn.LeakyReLU(0.2), tnn.LeakyReLU(0.2)),
                   (jnn.Softmax(axis=1), tnn.Softmax(axis=1))):
        _close(tl(torch.from_numpy(x)).detach(), jl(jnp.asarray(x)),
               type(tl).__name__, 1e-5)
