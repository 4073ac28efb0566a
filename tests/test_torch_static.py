"""``paddle.static`` and ``text.viterbi_decode`` of the port against the
JAX package's, on the CPU.

Each ``static.nn`` helper runs once in a JAX and a port program (each
builds its layers), the JAX program's parameters are carried into the
port's slots by name (``convert.program_state_from_jax``), and a second
run of both must agree (float32, ``rtol 1e-5, atol 1e-5`` unless a case
says otherwise; integer outputs exactly).  The control-flow helpers run
on concrete values; the Program / Executor / inference-model round trip
runs the port alone against its own eager run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.static as jst
from paddle_tpu import text as jtext

import paddle_tpu_torch as tpt
import paddle_tpu_torch.static as tst
from paddle_tpu_torch import text as ttext
from paddle_tpu_torch.convert import program_state_from_jax
from paddle_tpu_torch.framework.dtype import device_scope

RTOL = ATOL = 1e-5


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


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _both(call, args, rtol=RTOL, atol=ATOL):
    """``call(S, *args)`` in a JAX and a port program; the JAX program's
    parameters carried into the port's; the second runs compared."""
    jpt.seed(0)
    tpt.seed(0)
    jp, tp = jst.Program("j"), tst.Program("t")
    ja = [jnp.asarray(a) for a in args]
    ta = [torch.as_tensor(a) for a in args]
    with jst.program_guard(jp):
        call(jst, *ja)
    with tst.program_guard(tp):
        call(tst, *ta)
    assert sorted(tp._nn_layers) == sorted(jp._nn_layers)
    program_state_from_jax(tp, jp)
    jp._nn_counters.clear()
    tp._nn_counters.clear()
    with jst.program_guard(jp):
        jo = _flat(call(jst, *ja))
    with tst.program_guard(tp):
        to = _flat(call(tst, *ta))
    assert len(jo) == len(to)
    for j, t in zip(jo, to):
        j, t = np.asarray(j), _np(t)
        assert j.shape == t.shape
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


R = np.random.RandomState(0)
X4 = R.randn(2, 4, 8, 8).astype(np.float32)
X5 = R.randn(1, 2, 4, 4, 4).astype(np.float32)
SEQ = R.randn(3, 6, 4).astype(np.float32)
LENS = np.asarray([6, 3, 0], np.int32)

HELPERS = {
    "fc": (lambda S, x: S.nn.fc(x, 5, num_flatten_dims=2,
                                activation="relu"), [SEQ]),
    "embedding": (lambda S, i: S.nn.embedding(i, size=(10, 6),
                                              padding_idx=0),
                  [np.asarray([[1, 2, 0]], np.int64)]),
    "batch_norm": (lambda S, x: S.nn.batch_norm(x, act="relu"), [X4]),
    "conv2d": (lambda S, x: S.nn.conv2d(x, 6, 3, stride=2, padding=1,
                                        act="relu"), [X4]),
    "conv2d_nhwc": (lambda S, x: S.nn.conv2d(x, 3, 3, padding=1,
                                             data_format="NHWC"),
                    [X4.transpose(0, 2, 3, 1)]),
    "conv3d": (lambda S, x: S.nn.conv3d(x, 3, 3, padding=1), [X5]),
    "conv2d_transpose": (lambda S, x: S.nn.conv2d_transpose(x, 5, 3,
                                                            stride=2),
                         [X4]),
    "conv2d_transpose_output_size": (
        lambda S, x: S.nn.conv2d_transpose(x, 5, output_size=12), [X4]),
    "conv3d_transpose": (lambda S, x: S.nn.conv3d_transpose(x, 3, 3), [X5]),
    "deform_conv2d": (
        lambda S, x, o, m: S.nn.deform_conv2d(x, o, m, 4, 3, padding=1),
        [X4, R.randn(2, 18, 8, 8).astype(np.float32) * 0.5,
         R.rand(2, 9, 8, 8).astype(np.float32)]),
    "layer_norm": (lambda S, x: S.nn.layer_norm(x, begin_norm_axis=2), [X4]),
    "group_norm": (lambda S, x: S.nn.group_norm(x, 2, act="tanh"), [X4]),
    "instance_norm": (lambda S, x: S.nn.instance_norm(x), [X4]),
    "data_norm": (lambda S, x: S.nn.data_norm(x), [X4]),
    "prelu_channel": (lambda S, x: S.nn.prelu(x, mode="channel"), [X4]),
    "spectral_norm": (lambda S, w: S.nn.spectral_norm(w, power_iters=2),
                      [R.randn(4, 5).astype(np.float32)]),
    "bilinear_tensor_product": (
        lambda S, x, y: S.nn.bilinear_tensor_product(x, y, 5),
        [R.randn(2, 3).astype(np.float32), R.randn(2, 4).astype(np.float32)]),
    "row_conv": (lambda S, x: S.nn.row_conv(x, 2), [SEQ]),
    "sequence_conv": (lambda S, x: S.nn.sequence_conv(x, 5, 3), [SEQ]),
    # with no negative sample the loss is deterministic: -log sigmoid of
    # the positive logit
    "nce_positive_only": (
        lambda S, x, y: S.nn.nce(x, y, 10, num_neg_samples=0),
        [R.randn(4, 8).astype(np.float32), np.asarray([0, 1, 2, 9])]),
    "sparse_embedding": (lambda S, i: S.nn.sparse_embedding(i, [10, 6]),
                         [np.asarray([[1, 2]], np.int64)]),
    "crf_decoding": (lambda S, x, n: S.nn.crf_decoding(x, length=n),
                     [R.rand(3, 6, 4).astype(np.float32),
                      np.asarray([6, 4, 1], np.int32)]),
    "multi_box_head": (
        lambda S, a, b: S.nn.multi_box_head([a, b], None, 3,
                                            aspect_ratios=[[2.0], [2.0, 3.0]]),
        [R.randn(1, 4, 4, 4).astype(np.float32),
         R.randn(1, 8, 2, 2).astype(np.float32)]),
}


@pytest.mark.parametrize("case", sorted(HELPERS))
def test_static_nn_helper_matches_jax(case):
    call, args = HELPERS[case]
    _both(call, args)


SEQUENCE_OPS = {
    "softmax": (lambda S, x, n: S.nn.sequence_softmax(x[..., 0], n),
                [SEQ, LENS]),
    "pool_sum": (lambda S, x, n: S.nn.sequence_pool(x, "sum", n),
                 [SEQ, LENS]),
    "pool_average": (lambda S, x, n: S.nn.sequence_pool(x, "average", n),
                     [SEQ, LENS]),
    "pool_sqrt": (lambda S, x, n: S.nn.sequence_pool(x, "sqrt", n),
                  [SEQ, LENS]),
    "pool_max": (lambda S, x, n: S.nn.sequence_pool(x, "max", n,
                                                    pad_value=-1.0),
                 [SEQ, LENS]),
    "first_step": (lambda S, x, n: S.nn.sequence_first_step(x, n),
                   [SEQ, LENS]),
    "last_step": (lambda S, x, n: S.nn.sequence_last_step(x, n),
                  [SEQ, LENS]),
    "concat": (lambda S, x: S.nn.sequence_concat([x, x[:, :2]]), [SEQ]),
    "slice": (lambda S, x, o, n: S.nn.sequence_slice(x, o, n),
              [SEQ, np.asarray([0, 2, 1], np.int32),
               np.asarray([3, 3, 3], np.int32)]),
    "expand": (lambda S, x, y: S.nn.sequence_expand(x, y),
               [SEQ[:, 0], np.zeros((3, 2), np.float32)]),
    "expand_as": (lambda S, x, y: S.nn.sequence_expand_as(x, y),
                  [SEQ[:, 0], np.zeros((6, 2), np.float32)]),
    "pad": (lambda S, x, n: S.nn.sequence_pad(x, 9.0, maxlen=8, length=n),
            [SEQ, LENS]),
    "unpad": (lambda S, x, n: S.nn.sequence_unpad(x, n), [SEQ, LENS]),
    "reshape": (lambda S, x: S.nn.sequence_reshape(x, 8), [SEQ]),
    "reverse": (lambda S, x, n: S.nn.sequence_reverse(x, n), [SEQ, LENS]),
    "scatter": (lambda S, x, i, u: S.nn.sequence_scatter(x, i, u),
                [SEQ[..., 0], np.asarray([[0, 1], [2, 2], [5, 0]], np.int64),
                 R.randn(3, 2).astype(np.float32)]),
    "enumerate": (lambda S, i: S.nn.sequence_enumerate(i, 3, pad_value=-1),
                  [np.arange(12, dtype=np.int64).reshape(2, 6)]),
}


@pytest.mark.parametrize("case", sorted(SEQUENCE_OPS))
def test_sequence_op_matches_jax(case):
    call, args = SEQUENCE_OPS[case]
    _both(call, args)


def test_nce_with_negatives_draws_from_the_framework_stream():
    """The negatives are the port's draws (the JAX package's come from its
    key stream): the loss is positive, one a row, and two programs seeded
    alike give the same loss."""
    x = torch.as_tensor(R.randn(4, 8).astype(np.float32))
    y = torch.as_tensor(np.asarray([0, 1, 2, 3]))
    losses = []
    for _ in range(2):
        tpt.seed(5)
        with tst.program_guard(tst.Program("nce")):
            losses.append(tst.nn.nce(x, y, 10, num_neg_samples=5))
    assert losses[0].shape == (4, 1) and bool((losses[0] > 0).all())
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)


def test_control_flow_matches_jax():
    for S, arr in ((jst, jnp.asarray), (tst, torch.as_tensor)):
        one = arr(np.float32(1.0))
        assert float(S.nn.cond(arr(True), lambda: one * 2,
                               lambda: one * 3)) == 2.0
        assert float(S.nn.cond(arr(False), lambda: one * 2,
                               lambda: one * 3)) == 3.0
        i, acc = S.nn.while_loop(lambda i, a: i < 5,
                                 lambda i, a: (i + 1, a * 2),
                                 [arr(np.int32(0)), one])
        assert int(i) == 5 and float(acc) == 32.0
        pairs = [(arr(False), lambda: one * 1), (arr(True), lambda: one * 2),
                 (arr(True), lambda: one * 3)]
        assert float(S.nn.case(pairs)) == 2.0
        assert float(S.nn.case(pairs[:1], default=lambda: one * 7)) == 7.0
        assert float(S.nn.case([(arr(False), lambda: one * 4),
                                (arr(False), lambda: one * 5)])) == 5.0
        fns = {1: lambda: one * 10, 3: lambda: one * 30}
        assert float(S.nn.switch_case(arr(3), fns)) == 30.0
        assert float(S.nn.switch_case(arr(2), fns,
                                      default=lambda: one * -1)) == -1.0
        assert float(S.nn.switch_case(arr(2), fns)) == 30.0
        assert float(S.nn.switch_case(arr(9), [lambda: one * 0,
                                               lambda: one * 1])) == 1.0


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_decode_matches_jax(bos_eos):
    rng = np.random.RandomState(int(bos_eos))
    pot = rng.randn(4, 7, 5).astype(np.float32)
    trans = rng.randn(5, 5).astype(np.float32)
    lens = np.asarray([7, 3, 1, 5], np.int32)
    js, jpath = jtext.viterbi_decode(jnp.asarray(pot), jnp.asarray(trans),
                                     jnp.asarray(lens), bos_eos)
    ts, tpath = ttext.viterbi_decode(torch.as_tensor(pot),
                                     torch.as_tensor(trans),
                                     torch.as_tensor(lens), bos_eos)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=RTOL)
    assert tpath.dtype == torch.int32
    np.testing.assert_array_equal(_np(tpath), np.asarray(jpath))
    dec = ttext.ViterbiDecoder(trans, bos_eos)
    np.testing.assert_array_equal(_np(dec(torch.as_tensor(pot))[1]),
                                  np.asarray(jtext.ViterbiDecoder(
                                      trans, bos_eos)(jnp.asarray(pot))[1]))


def _lenet(x):
    h = tst.nn.conv2d(x, 6, 5, padding=2, act="relu")
    h = tst.nn.batch_norm(h)
    h = tst.nn.conv2d(h, 16, 5, stride=2, act="relu")
    return {"logits": tst.nn.fc(tst.nn.fc(h, 32, activation="relu"), 10)}


def test_program_executor_and_inference_model_round_trip(tmp_path):
    tpt.seed(0)
    prog = tst.Program("lenet").set_fn(_lenet)
    exe = tst.Executor(tst.cuda_places()[:1] or tst.cpu_places())
    x = np.random.RandomState(0).randn(4, 1, 28, 28).astype(np.float32)
    first = exe.run(prog, feed={"x": x}, fetch_list=["logits"])[0]
    again = exe.run(prog, feed={"x": x}, fetch_list=["logits"])[0]
    assert first.shape == (4, 10)
    # train mode: the same layers, batch statistics both times
    np.testing.assert_array_equal(first, again)
    assert sorted(prog._nn_layers) == ["batch_norm_0", "conv2d_0",
                                       "conv2d_1", "fc_0", "fc_1"]
    test_prog = prog.clone(for_test=True)
    want = exe.run(test_prog, feed={"x": x})[0]
    path = str(tmp_path / "lenet")
    tst.save_inference_model(path, [tst.data("x", [None, 1, 28, 28])],
                             None, exe, program=prog)
    loaded, feeds, _ = tst.load_inference_model(path, exe)
    assert feeds == ["x"]
    got = exe.run(loaded, feed={"x": x[:3]})
    np.testing.assert_allclose(got[0], want[:3], rtol=RTOL, atol=ATOL)


def test_program_state_save_load_and_persistables(tmp_path):
    tpt.seed(0)
    prog = tst.Program("p").set_fn(
        lambda x: tst.nn.layer_norm(tst.nn.fc(x, 4), begin_norm_axis=1))
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    want = prog.run({"x": x})
    tst.save(prog, str(tmp_path / "p"))
    blob = tst.serialize_persistables([], [], None)
    with torch.no_grad():
        for layer in prog._nn_layers.values():
            for p in layer.parameters():
                p.add_(1.0)
    assert not torch.equal(prog.run({"x": x}), want)
    tst.load(prog, str(tmp_path / "p"))
    torch.testing.assert_close(prog.run({"x": x}), want)
    with tst.program_guard(prog):
        tst.deserialize_persistables(prog, blob)
    state = tst.load_program_state(str(tmp_path / "p"))
    assert sorted(state) == ["fc_0", "layer_norm_0"]


def test_static_utilities_match_jax():
    logits = np.random.RandomState(2).randn(8, 5).astype(np.float32)
    label = np.asarray([0, 1, 2, 3, 4, 0, 1, 2], np.int64)
    for k in (1, 3):
        assert float(tst.accuracy(torch.as_tensor(logits),
                                  torch.as_tensor(label), k=k)) == \
            pytest.approx(float(jst.accuracy(jnp.asarray(logits),
                                             jnp.asarray(label), k=k)))
    probs = np.random.RandomState(3).rand(16, 2).astype(np.float32)
    lbl = (np.random.RandomState(4).rand(16) > 0.5).astype(np.int64)
    assert float(tst.auc(torch.as_tensor(probs), torch.as_tensor(lbl))) == \
        pytest.approx(float(jst.auc(jnp.asarray(probs), jnp.asarray(lbl))),
                      rel=1e-6)
    jema, tema = jst.ExponentialMovingAverage(0.9), \
        tst.ExponentialMovingAverage(0.9)
    for i in range(3):
        p = {"w": np.full((2,), float(i + 1), np.float32)}
        jema.update(p)
        tema.update(p)
    with tema.apply() as shadow:
        np.testing.assert_allclose(_np(shadow["w"]),
                                   np.asarray(jema.shadow()["w"]), rtol=1e-6)
    v = tst.create_global_var([2, 3], 1.5, "float32", name="g")
    assert tst.global_scope().find_var("g") is v and float(v.sum()) == 9.0
    out = tst.py_func(lambda a: np.asarray(a) * 2, torch.ones(3),
                      torch.zeros(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert tst.cuda_places() == [tpt.CUDAPlace(i)
                                 for i in range(torch.cuda.device_count())]
    with pytest.raises(NotImplementedError, match="backward"):
        tst.append_backward(None)
    bs = tst.BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    assert bs.fuse_all_optimizer_ops and not bs.enable_inplace
