"""Port parity of the vision zoo (``paddle_tpu_torch/vision/models``) and
the vision rows' workloads and step (``convert.resnet_training_workload``
/ ``lenet_training_workload``, ``training.classification_step``) on the
CPU, against the JAX package: the JAX model's numpy ``state_dict``
(parameters and BatchNorm buffers) loaded into the port's.

- ``state_dict`` keys, shapes and dtypes equal the JAX ones (LeNet,
  resnet18, resnet50, resnext50_32x4d, wide_resnet50_2);
- training-mode logits, the loss, every gradient and the new BatchNorm
  statistics (JAX's ``apply(..., mutable=True)``) in float64 for LeNet,
  resnet18, one resnet50 and one resnext50_32x4d, and in float32 for
  LeNet and resnet18;
- 3 steps of the JAX bench step (``bench.py`` ``_bench_resnet50``:
  ``Momentum(0.1, 0.9, weight_decay=1e-4)``, JAX's ``newv`` carried into
  the next step) against ``classification_step`` in float32: losses,
  parameters, BatchNorm buffers, then eval-mode logits, for LeNet and
  resnet18; resnet18's first step under bf16 O1 (its loss);
- the workloads' data is the JAX rows' draw, and without a card they
  raise unless ``device="cpu"``.

Tolerances.  Float64 on both sides: 1e-9 of each tensor's range (the
same arithmetic in another order; seen: 4e-12).  This is where the deep
models are held: in float32 at B=2 the last stages' BatchNorm (8 values a
channel at 64 x 64) amplifies rounding, and both packages' float32
gradients of resnet50 differ from the float64 ones by up to 0.3 of a
tensor's range.  Float32 (LeNet, resnet18 at 64 x 64): logits and the loss
1e-4 relative, each gradient 5e-4 of its range, BatchNorm statistics 1e-5.
After 3 Momentum steps at lr 0.1, losses within 1e-4 relative and each
parameter and buffer within ``STEP_TOL`` of the range of its change over
the 3 steps (LeNet 1e-4, seen 2e-6; resnet18 5e-2, seen 1.4e-2: its loss
rises to 5 on the third step at B=2 and amplifies float32 rounding).  The
JAX reference steps are jitted, except the float32 forward / backward,
which runs eagerly: at B=4 XLA's jitted CPU gradient of resnet18 differed
from its own eager one (and from the port's and from float64) by 0.27 of
one conv weight gradient's range.  Under O1 (bf16 products) the first
loss within 2e-2 relative.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import convert, training
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import models as tmodels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work.  Under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores and spin: six translation recipes run at once took 916 s
    each with eight threads and 5 s each with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name: (constructor kwargs, batch, image size, channels, classes)
MODELS = {
    "LeNet": ({}, 4, 28, 1, 10),
    "resnet18": ({"num_classes": 10}, 2, 64, 3, 10),
    "resnet50": ({}, 2, 64, 3, 1000),
    "resnext50_32x4d": ({"num_classes": 10}, 2, 64, 3, 10),
    "wide_resnet50_2": ({"num_classes": 10}, 2, 32, 3, 10),
}


STEP_TOL = {"LeNet": 1e-4, "resnet18": 5e-2}


def _close(got, ref, what, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * max(float(np.abs(ref).max()), 1e-3)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """One JAX model per name for the whole file (``apply`` leaves its
    eager state as it was): built after ``pt.seed(0)``."""
    pt.seed(0)
    return getattr(jmodels, name)(**MODELS[name][0])


def _pair(name):
    kw = MODELS[name][0]
    jm = _jax_model(name)
    tm = getattr(tmodels, name)(device="cpu", **kw)
    load_jax_state(tm, {k: np.array(v) for k, v in jm.state_dict().items()})
    jm.train()
    tm.train()
    return jm, tm


def _batch(name, seed=0):
    _, b, hw, c, classes = MODELS[name]
    r = np.random.RandomState(seed)
    return ((r.randn(b, c, hw, hw) * 0.5).astype(np.float32),
            r.randint(0, classes, (b,)))


def _jax_step_fn(jm, level=None):
    """The JAX bench's loss: logits under ``auto_cast`` (or none), the
    float32 cross-entropy, the new buffers as aux."""
    def loss_fn(tp, rest, x, y):
        if level:
            with jamp.auto_cast(level=level, dtype="bfloat16"):
                logits, newv = jm.apply({**rest, **tp}, x, mutable=True)
        else:
            logits, newv = jm.apply({**rest, **tp}, x, mutable=True)
        newv = {k: v for k, v in newv.items() if k in rest}
        logits32 = logits if logits.dtype == jnp.float64 else logits.astype(
            jnp.float32)
        return JF.cross_entropy(logits32, y), (logits, newv)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _split(jm):
    trainable = jm.trainable_variables()
    rest = {k: v for k, v in jm.state_dict().items() if k not in trainable}
    return dict(trainable), rest


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_keys_shapes_dtypes_match_jax(name):
    jsd = _jax_model(name).state_dict()
    tsd = getattr(tmodels, name)(device="cpu", **MODELS[name][0]).state_dict()
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tuple(tsd[k].shape) == tuple(v.shape), k
        assert str(tsd[k].dtype).replace("torch.", "") == str(v.dtype), k
    if name.startswith("res"):
        assert "layer2.0.downsample.conv.weight" in tsd
        assert "bn1._mean" in tsd and "layer4.1.bn2._variance" in tsd


def _check_step(tm, x, y, jloss, jlogits, jgrads, newv, tols):
    """The port's training-mode forward / backward on ``x`` against the
    JAX results; ``tols``: (loss and logits, gradients, statistics)."""
    logits = tm(x)
    loss = TF.cross_entropy(logits, y)
    loss.backward()
    _close(loss.detach(), jloss, "loss", tols[0])
    _close(logits.detach(), jlogits, "logits", tols[0])
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(jgrads)
    for k, g in jgrads.items():
        _close(params[k].grad, g, f"grad {k}", tols[1])
    buffers = dict(tm.named_buffers())
    assert sorted(buffers) == sorted(newv)
    for k, v in newv.items():
        _close(buffers[k], v, f"buffer {k}", tols[2])


@pytest.mark.parametrize("name", ["LeNet", "resnet18", "resnet50",
                                  "resnext50_32x4d"])
def test_forward_backward_float64_matches_jax(name):
    jm, tm = _pair(name)
    x, y = _batch(name)
    state = {k: np.asarray(v, np.float64) for k, v in jm.state_dict().items()}
    trainable = jm.trainable_variables()
    with enable_x64():
        tp = {k: jnp.asarray(state[k]) for k in trainable}
        rest = {k: jnp.asarray(v) for k, v in state.items()
                if k not in trainable}
        (jloss, (jlogits, newv)), jgrads = _jax_step_fn(jm)(
            tp, rest, jnp.asarray(x, jnp.float64), jnp.asarray(y))
        out = jax.tree_util.tree_map(np.asarray,
                                     (jloss, jlogits, jgrads, newv))
    assert out[1].dtype == np.float64
    _check_step(tm.double(), torch.from_numpy(x).double(),
                torch.from_numpy(y), *out, (1e-9, 1e-9, 1e-9))


@pytest.mark.parametrize("name", ["LeNet", "resnet18"])
def test_forward_backward_float32_matches_jax(name):
    jm, tm = _pair(name)
    x, y = _batch(name)
    trainable, rest = _split(jm)

    def loss_fn(tp):
        logits, newv = jm.apply({**rest, **tp}, jnp.asarray(x), mutable=True)
        newv = {k: v for k, v in newv.items() if k in rest}
        return JF.cross_entropy(logits, jnp.asarray(y)), (logits, newv)
    (jloss, (jlogits, newv)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(trainable)
    _check_step(tm, torch.from_numpy(x), torch.from_numpy(y), jloss,
                jlogits, jgrads, newv, (1e-4, 5e-4, 1e-5))


def _train_both(name, level=None, steps=3):
    """``steps`` JAX bench steps against ``classification_step``; returns
    both models' final states and the losses."""
    jm, tm = _pair(name)
    x, y = _batch(name)
    trainable, rest = _split(jm)
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    state = jo.init(trainable)
    step = _jax_step_fn(jm, level)
    to = topt.Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                       parameters=tm.named_parameters())
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jlosses, tlosses = [], []
    for _ in range(steps):
        (loss, (_, newv)), grads = step(trainable, rest, jnp.asarray(x),
                                        jnp.asarray(y))
        trainable, state = jo.apply_gradients(grads, trainable, state)
        rest = {**rest, **newv}
        jlosses.append(float(loss))
        tlosses.append(float(training.classification_step(
            tm, to, tx, ty, level=level or "O0")))
    return jm, tm, {**rest, **trainable}, jlosses, tlosses


@pytest.mark.parametrize("name", ["LeNet", "resnet18"])
def test_momentum_steps_match_jax_bench_step(name):
    jm, tm, jstate, jlosses, tlosses = _train_both(name)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    start = _jax_model(name).state_dict()
    tsd = tm.state_dict()
    for k, v in jstate.items():
        change = np.abs(np.asarray(v) - np.asarray(start[k])).max()
        err = np.abs(tsd[k].numpy() - np.asarray(v)).max()
        assert err <= STEP_TOL[name] * max(change, 1e-6), (k, err, change)
    # eval mode reads the carried statistics
    x, _ = _batch(name, seed=1)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(x))
    _close(tlogits, jm.apply(jstate, jnp.asarray(x)), "eval logits",
           STEP_TOL[name])


def test_o1_step_matches_jax_bench_step():
    """One step under O1: bf16 rounding differences, amplified by lr 0.1 at
    B=2, make later steps incomparable, so the first loss is held."""
    _, _, _, jlosses, tlosses = _train_both("resnet18", level="O1", steps=1)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-2)


@pytest.mark.parametrize("make,kw,shape,classes", [
    (convert.resnet_training_workload, {"depth": 18, "batch": 2, "hw": 32},
     (2, 3, 32, 32), 1000),
    (convert.lenet_training_workload, {"batch": 4}, (4, 1, 28, 28), 10)])
def test_workload_data_is_the_jax_rows_draw(make, kw, shape, classes):
    model, opt, images, labels, step_kw = make("cpu", **kw)
    rng = np.random.RandomState(0)
    ref = (rng.randn(*shape) * 0.5).astype(np.float32)
    np.testing.assert_array_equal(images.numpy(), ref)
    np.testing.assert_array_equal(labels.numpy(),
                                  rng.randint(0, classes, (shape[0],)))
    assert isinstance(opt, topt.Momentum) and opt.momentum == 0.9
    assert opt.get_lr() == 0.1 and opt._wd == 1e-4
    assert len(opt._params) == len(list(model.parameters()))
    assert step_kw == {"level": "O1" if classes == 1000 else "O0"}
    losses = [float(training.classification_step(model, opt, images, labels,
                                                  **step_kw))
              for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("make", [
    convert.resnet_training_workload, convert.lenet_training_workload,
    tmodels.LeNet, tmodels.resnet18, tmodels.alexnet, tmodels.vgg16,
    tmodels.squeezenet1_1, tmodels.mobilenet_v1, tmodels.mobilenet_v2,
    tmodels.mobilenet_v3_large, tmodels.mobilenet_v3_small,
    tmodels.shufflenet_v2_x1_0, tmodels.densenet121, tmodels.googlenet,
    tmodels.inception_v3,
    lambda: convert.vision_training_workload("mobilenet_v2")])
def test_entry_points_need_a_card_unless_cpu_is_asked(make):
    """No device means ``cuda``: without a card every entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(UnavailableError):
        make()
