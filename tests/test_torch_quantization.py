"""Quantization of the port against the JAX package's, on the CPU: fake
quant and its straight-through gradient, the fake-quant layers' scales,
QAT swaps, PTQ calibration, and the int8 layers, whose quantized input
``xq`` and int32 accumulation must equal JAX's exactly and whose output
must match at ``rtol 1e-6``.  Last, the deployment example's flow (train,
PTQ, int8, export, predictor) at its own sizes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as JQ

from paddle_tpu_torch import jit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework.dtype import device_scope
from paddle_tpu_torch.inference import Config, create_predictor

RTOL = 1e-6


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


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_dequant_and_its_gradient_match_jax(bits):
    rng = np.random.RandomState(bits)
    x = rng.randn(64, 33).astype(np.float32) * 3
    scale = np.float32(np.abs(x).max() * 0.7)       # some values clip
    want = np.asarray(JQ.quant_dequant(jnp.asarray(x), scale, bits))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = TQ.quant_dequant(xt, torch.tensor(scale), bits)
    np.testing.assert_array_equal(_np(got), want)
    got.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def _batches(n, shape, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale * (i + 1)).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("kind", ["ema", "max", "observer"])
def test_fake_quant_scales_update_as_jax(kind):
    if kind == "observer":
        jl, tl = JQ.MovingAverageAbsMaxScale(0.8), \
            TQ.MovingAverageAbsMaxScale(0.8)
    else:
        jl = JQ.FakeQuantMovingAverageAbsMax(8, 0.8, mode=kind)
        tl = TQ.FakeQuantMovingAverageAbsMax(8, 0.8, mode=kind)
    jl.train()
    tl.train()
    for b in _batches(3, (4, 10)):
        jy, ty = jl(jnp.asarray(b)), tl(torch.as_tensor(b))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=RTOL)
        np.testing.assert_allclose(_np(tl.scale),
                                   np.asarray(jl._buffers["scale"]),
                                   rtol=RTOL)
    jl.eval()
    tl.eval()
    before = _np(tl.scale).copy()
    tl(torch.as_tensor(_batches(1, (4, 10), seed=9, scale=50)[0]))
    assert _np(tl.scale) == before                  # frozen in eval


def _conv_net_pair(seed=0):
    jpt.seed(seed)
    jm = jnn.Sequential(jnn.Conv2D(3, 8, 3, padding=1), jnn.ReLU(),
                        jnn.Flatten(), jnn.Linear(8 * 6 * 6, 10))
    tm = tnn.Sequential(tnn.Conv2D(3, 8, 3, padding=1, device="cpu"),
                        tnn.ReLU(), tnn.Flatten(),
                        tnn.Linear(8 * 6 * 6, 10, device="cpu"))
    load_jax_state(tm, _state(jm))
    return jm, tm


@pytest.mark.parametrize("wtype", ["abs_max", "channel_wise_abs_max"])
def test_qat_swaps_and_forward_match_jax(wtype):
    jm, tm = _conv_net_pair()
    kw = dict(weight_quantize_type=wtype)
    JQ.ImperativeQuantAware(**kw).quantize(jm)
    TQ.ImperativeQuantAware(**kw).quantize(tm)
    assert [type(m).__name__ for m in tm] == \
        [type(m).__name__ for m in jm._sub_layers.values()]
    assert isinstance(tm[0], TQ.QuantizedConv2D)
    assert isinstance(tm[3], TQ.QuantizedLinear)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    x = _batches(1, (4, 3, 6, 6))[0]
    np.testing.assert_allclose(_np(tm(torch.as_tensor(x))),
                               np.asarray(jm(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tm[0].input_quanter.scale),
                               np.asarray(jm._sub_layers["0"].input_quanter
                                          ._buffers["scale"]), rtol=RTOL)


def _ptq_pair(cal):
    jm, tm = _conv_net_pair(1)
    JQ.PostTrainingQuantization().quantize(jm, [jnp.asarray(c) for c in cal])
    TQ.PostTrainingQuantization().quantize(tm,
                                           [torch.as_tensor(c) for c in cal])
    return jm, tm


def test_ptq_calibration_scales_match_jax():
    jm, tm = _ptq_pair(_batches(3, (4, 3, 6, 6)))
    js = {k: np.asarray(v) for k, v in jm.state_dict().items()
          if k.endswith("scale")}
    ts = {k: _np(v) for k, v in tm.state_dict().items()
          if k.endswith("scale")}
    assert sorted(js) == sorted(ts) == ["0.input_quanter.scale",
                                        "3.input_quanter.scale"]
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=RTOL)


def test_converted_model_matches_jax_and_carries_across():
    jm, tm = _ptq_pair(_batches(3, (4, 3, 6, 6)))
    JQ.PostTrainingQuantization().convert(jm)
    TQ.PostTrainingQuantization().convert(tm)
    assert isinstance(tm[0], TQ.Int8Conv2D)
    assert isinstance(tm[3], TQ.Int8Linear)
    js = _state(jm)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(_np(v), js[k])   # int8 exact
        assert _np(v).dtype == js[k].dtype, k
    x = _batches(1, (5, 3, 6, 6), seed=3)[0]
    np.testing.assert_allclose(_np(tm(torch.as_tensor(x))),
                               np.asarray(jm(jnp.asarray(x))), rtol=RTOL,
                               atol=1e-7)
    # the JAX model's int8 buffers into a freshly converted port model
    _, fresh = _ptq_pair(_batches(2, (4, 3, 6, 6), seed=7))
    TQ.PostTrainingQuantization().convert(fresh)
    load_jax_state(fresh, js)
    np.testing.assert_array_equal(_np(fresh(torch.as_tensor(x))),
                                  _np(tm(torch.as_tensor(x))))


def _jax_xq(x, in_scale, bits=8):
    qmax = float(2 ** (bits - 1) - 1)
    s = jnp.maximum(in_scale, 1e-9)
    return jnp.clip(jnp.round(x / s * qmax), -qmax, qmax).astype(jnp.int8)


@pytest.mark.parametrize("shape", [(7, 40, 24), (2, 3, 16, 8)])
def test_int8_linear_xq_and_accumulation_are_exact(shape):
    *lead, k, n = shape
    rng = np.random.RandomState(k)
    jpt.seed(0)
    jl = jnn.Linear(k, n)
    tl = tnn.Linear(k, n, device="cpu")
    load_jax_state(tl, _state(jl))
    ji, ti = JQ.Int8Linear(jl), TQ.Int8Linear(tl)
    in_scale = np.float32(1.7)
    ji._buffers["in_scale"] = jnp.asarray(in_scale)
    ti.in_scale.fill_(float(in_scale))
    x = rng.randn(*lead, k).astype(np.float32)
    jxq = _jax_xq(jnp.asarray(x), in_scale)
    np.testing.assert_array_equal(_np(ti.quantize_input(torch.as_tensor(x))),
                                  np.asarray(jxq))
    jacc = lax.dot_general(jxq, ji._buffers["qweight"],
                           (((x.ndim - 1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    tacc = ti.accumulate(torch.as_tensor(x))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(_np(tacc), np.asarray(jacc))
    np.testing.assert_allclose(_np(ti(torch.as_tensor(x))),
                               np.asarray(ji(jnp.asarray(x))), rtol=RTOL,
                               atol=1e-7)


CONV_CASES = {
    "stem_7x7_s2": dict(cin=3, cout=8, k=7, stride=2, padding=3),
    "3x3_same_groups": dict(cin=4, cout=8, k=3, stride=1, padding="SAME",
                            groups=2),
    "3x3_dilated_valid": dict(cin=3, cout=5, k=3, stride=1, padding="VALID",
                              dilation=2),
    "1x1_nhwc": dict(cin=6, cout=4, k=1, stride=2, padding=0,
                     data_format="NHWC"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv2d_xq_and_accumulation_are_exact(case):
    c = dict(CONV_CASES[case])
    cin, cout, k = c.pop("cin"), c.pop("cout"), c.pop("k")
    fmt = c.get("data_format", "NCHW")
    jpt.seed(2)
    jc = jnn.Conv2D(cin, cout, k, **c)
    tc = tnn.Conv2D(cin, cout, k, device="cpu", **c)
    load_jax_state(tc, _state(jc))
    kw = dict(weight_quantize_type="channel_wise_abs_max",
              activation_quantize_type="moving_average_abs_max",
              weight_bits=8, activation_bits=8, moving_rate=0.9)
    ji = JQ.Int8Conv2D(JQ.QuantizedConv2D(jc, **kw))
    ti = TQ.Int8Conv2D(TQ.QuantizedConv2D(tc, **kw))
    in_scale = np.float32(2.5)
    ji._buffers["in_scale"] = jnp.asarray(in_scale)
    ti.in_scale.fill_(float(in_scale))
    shape = (2, cin, 13, 11) if fmt == "NCHW" else (2, 13, 11, cin)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jxq = _jax_xq(jnp.asarray(x), in_scale)
    w = ji._buffers["qweight"]
    stride = (c["stride"],) * 2
    dil = (c.get("dilation", 1),) * 2
    pad = c["padding"].upper() if isinstance(c["padding"], str) \
        else [(c["padding"],) * 2] * 2
    dn = lax.conv_dimension_numbers(
        x.shape, w.shape, ("NCHW", "OIHW", "NCHW") if fmt == "NCHW"
        else ("NHWC", "OIHW", "NHWC"))
    jacc = lax.conv_general_dilated(
        jxq, w, window_strides=stride, padding=pad, rhs_dilation=dil,
        dimension_numbers=dn, feature_group_count=c.get("groups", 1),
        preferred_element_type=jnp.int32)
    tacc = ti.accumulate(torch.as_tensor(x))       # NCHW
    if fmt != "NCHW":
        tacc = tacc.permute(0, 2, 3, 1)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(_np(tacc), np.asarray(jacc))
    np.testing.assert_allclose(_np(ti(torch.as_tensor(x))),
                               np.asarray(ji(jnp.asarray(x))), rtol=RTOL,
                               atol=1e-6)


def test_convert_refuses_an_uncalibrated_model():
    _, tm = _conv_net_pair()
    TQ.ImperativeQuantAware(activation_quantize_type="abs_max").quantize(tm)
    with pytest.raises(ValueError, match="calibrated input observer"):
        TQ.PostTrainingQuantization().convert(tm)
    _, tm = _conv_net_pair()
    TQ.PostTrainingQuantization().quantize(tm, [])
    with pytest.raises(ValueError, match="never calibrated"):
        TQ.PostTrainingQuantization().convert(tm)


def test_quantize_weight_to_int_matches_jax():
    w = np.random.RandomState(4).randn(12, 6).astype(np.float32)
    for bits, axis in ((8, None), (8, 1), (12, 0)):
        jq, js = JQ.quantize_weight_to_int(jnp.asarray(w), bits, axis)
        tq, ts = TQ.quantize_weight_to_int(torch.as_tensor(w), bits, axis)
        np.testing.assert_array_equal(_np(tq), np.asarray(jq))
        assert _np(tq).dtype == np.asarray(jq).dtype
        np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=RTOL)


def test_the_deployment_example_flow(tmp_path):
    """examples/quantize_and_deploy.py on the port: train, PTQ, int8,
    export of the float32 model, the predictor."""
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    x_all = torch.as_tensor(rng.randn(512, 16).astype(np.float32))
    w_true = torch.as_tensor(rng.randn(16, 4).astype(np.float32))
    y_all = torch.argmax(x_all @ w_true, dim=1)

    def net():
        return tnn.Sequential(tnn.Linear(16, 64, device="cpu"), tnn.ReLU(),
                              tnn.Linear(64, 4, device="cpu"))
    model = net()
    opt = topt.Adam(learning_rate=5e-3, parameters=model.parameters())
    for _ in range(30):
        loss = torch.nn.functional.cross_entropy(model(x_all), y_all)
        opt.clear_grad()
        loss.backward()
        opt.step()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.eval()
    with torch.no_grad():
        fp32_acc = float((model(x_all).argmax(1) == y_all).float().mean())
    assert fp32_acc > 0.8
    ptq = TQ.PostTrainingQuantization()
    ptq.quantize(model, [x_all[i * 64:(i + 1) * 64] for i in range(4)])
    ptq.convert(model)
    with torch.no_grad():
        int8_acc = float((model(x_all).argmax(1) == y_all).float().mean())
    assert sum(isinstance(m, TQ.Int8Linear) for m in model.modules()) == 2
    assert int8_acc > fp32_acc - 0.05
    # the int8 model exports too: its int8 GEMM is a registered op
    jit.save(model, str(tmp_path / "int8"),
             [jit.InputSpec([None, 16], "float32")])
    np.testing.assert_array_equal(
        _np(jit.load(str(tmp_path / "int8"))(x_all[:8])),
        _np(model(x_all[:8])))
    fresh = net()
    fresh.set_state_dict(params)
    fresh.eval()
    path = str(tmp_path / "clf")
    jit.save(fresh, path, [jit.InputSpec([None, 16], "float32")])
    predictor = create_predictor(Config(path))
    handle = predictor.get_input_handle(predictor.get_input_names()[0])
    handle.copy_from_cpu(x_all[:8].numpy())
    predictor.run()
    out = predictor.get_output_handle(
        predictor.get_output_names()[0]).copy_to_cpu()
    with torch.no_grad():
        direct = fresh(x_all[:8]).argmax(1).numpy()
    assert (np.argmax(out, 1) == direct).all()
