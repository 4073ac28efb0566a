"""Port parity of the rest of the vision zoo (``paddle_tpu_torch/vision/
models``: AlexNet, VGG, SqueezeNet, MobileNet V1 / V2 / V3, ShuffleNetV2,
DenseNet, GoogLeNet, InceptionV3, ``ConvNormActivation``) and of
``convert.vision_training_workload`` on the CPU, against the JAX package,
on the same numpy state.

- ``state_dict`` keys, shapes and dtypes equal the JAX ones for every
  constructor of the 11 families at full width and 1000 classes, and the
  Dropout layers have the JAX model's p, in order (construction only: the
  JAX model is built under ``jax.eval_shape``, which draws nothing);
- one training-mode forward and backward of every family, 10 classes,
  B=2, at a narrow width where the family has ``scale`` and a small legal
  input: the logits, the loss (GoogLeNet: the sum of its three heads'
  cross-entropies), every gradient and the new BatchNorm statistics (the
  JAX ``apply(..., mutable=True)``, jitted).  Dropout runs at p=0 on both
  sides (masks differ between packages).  The families built from a table
  run a shorter one (``DEPTH_CUTS``); ``ConvNormActivation`` for each
  activation; the exports cover the JAX package's;
- the headless backbones (``num_classes=0``, ``with_pool``) give the JAX
  test's shapes;
- ``vision_training_workload`` builds any family with the JAX vision
  rows' optimizer and data, at the family's ImageNet size by default.

Tolerances.  Families with BatchNorm run in float64 on both sides: 1e-9
of each tensor's range (the same arithmetic in another order), at 64 x 64
(InceptionV3 107 x 107) so that the last BatchNorm sees 8 values a
channel: at 2 a channel its gradient is a cancellation even in float64.
In float32 at B=2 the last stages' BatchNorm amplifies rounding (slice
9's ResNet-50 finding), so float32 is no test of them.  AlexNet, VGG-11,
SqueezeNet and GoogLeNet have no BatchNorm and run in float32: logits and
loss 1e-4 of their range, each gradient 5e-4 of its range.
``ConvNormActivation`` in eval mode: 1e-5 of the range.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

import paddle_tpu as pt
from paddle_tpu.framework import random as jrandom
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layers import Dropout as JDropout
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import convert, training
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.nn.layers import Dropout as TDropout
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


# every constructor of the 11 families: (name, kwargs)
CONSTRUCTORS = [
    ("alexnet", {}), ("vgg11", {}), ("vgg13", {}), ("vgg16", {}),
    ("vgg19", {}), ("vgg11", {"batch_norm": True}),
    ("vgg13", {"batch_norm": True}), ("vgg16", {"batch_norm": True}),
    ("vgg19", {"batch_norm": True}), ("squeezenet1_0", {}),
    ("squeezenet1_1", {}), ("mobilenet_v1", {}), ("mobilenet_v2", {}),
    ("mobilenet_v3_large", {}), ("mobilenet_v3_small", {}),
    ("shufflenet_v2_x0_25", {}), ("shufflenet_v2_x0_33", {}),
    ("shufflenet_v2_x0_5", {}), ("shufflenet_v2_x1_0", {}),
    ("shufflenet_v2_x1_5", {}), ("shufflenet_v2_x2_0", {}),
    ("shufflenet_v2_swish", {}), ("densenet121", {}), ("densenet161", {}),
    ("densenet169", {}), ("densenet201", {}), ("densenet264", {}),
    ("googlenet", {}), ("inception_v3", {}),
]

# forward / backward cases: id -> (constructor, kwargs, image size,
# float64, XLA's fast compile: see _jit)
FAMILIES = {
    "alexnet": ("alexnet", {}, 63, False, False),
    "vgg11": ("vgg11", {}, 32, False, False),
    "squeezenet1_1": ("squeezenet1_1", {}, 31, False, True),
    "mobilenet_v1": ("mobilenet_v1", {"scale": 0.25}, 64, True, True),
    "mobilenet_v2": ("mobilenet_v2", {"scale": 0.25}, 64, True, True),
    "mobilenet_v3_small": ("mobilenet_v3_small", {"scale": 0.5}, 64, True,
                           True),
    "mobilenet_v3_large": ("mobilenet_v3_large", {"scale": 0.35}, 64, True,
                           True),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", {}, 64, True, True),
    "densenet121": ("densenet121", {}, 64, True, True),
    "googlenet": ("googlenet", {}, 32, False, True),
    "inception_v3": ("inception_v3", {}, 107, True, False),
}
CLASSES, BATCH = 10, 2
# The forward / backward cases of the families built from a table run a
# shorter table, set in both packages' modules for that test: every kind
# of block the full table holds (expansion or none, stride 1 and 2, the
# residual add, squeeze-excite, both activations, 3x3 and 5x5 kernels,
# dense layers and transitions) at a depth whose XLA compile the test's
# time allows (DenseNet-121's takes 20 s).  The full tables are held by the
# state-dict test here and by chip_smoke.py's c2h on the card.
DEPTH_CUTS = {
    "mobilenet_v1": ("mobilenetv1", {"_BLOCKS": [(64, 1), (128, 2),
                                                 (128, 1), (1024, 2)]}),
    "mobilenet_v2": ("mobilenetv2", {"_SETTINGS": [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 1, 2), (6, 320, 1, 1)]}),
    "mobilenet_v3_small": ("mobilenetv3", {"_SMALL": [
        (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
        (5, 96, 40, True, "hardswish", 2),
        (5, 240, 40, True, "hardswish", 1)]}),
    "mobilenet_v3_large": ("mobilenetv3", {"_LARGE": [
        (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
        (5, 72, 40, True, "relu", 2), (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "hardswish", 2),
        (3, 480, 112, True, "hardswish", 1)]}),
    "shufflenet_v2_x0_25": ("shufflenetv2", {"_STAGE_REPEATS": [2, 2, 2]}),
    "densenet121": ("densenet", {"_CONFIGS": {121: (64, 32, [2, 2, 3, 2])}}),
}


def _close(got, ref, what, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * max(float(np.abs(ref).max()), 1e-3)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _jax_dropouts(model):
    return [m.p for m in model.sublayers(include_self=True)
            if isinstance(m, JDropout)]


def _torch_dropouts(model):
    return [m.p for m in model.modules() if isinstance(m, TDropout)]


def _abstract_jax(make):
    """``make()``'s JAX model built under ``jax.eval_shape`` (its
    initializers draw nothing and the global stream is left as it was):
    the model and its ``state_dict``'s shapes.  ``apply`` binds every
    variable it is given, so the model runs on any numpy state."""
    built = []
    gen = jrandom.default_generator()
    saved = gen.get_state()
    try:
        def build():
            built.append(make())
            return dict(built[0].state_dict())
        shapes = jax.eval_shape(build)
    finally:
        gen.set_state(saved)
    return built[0], shapes


@pytest.mark.parametrize("name,kw", CONSTRUCTORS,
                         ids=[f"{n}{'_bn' if kw else ''}"
                              for n, kw in CONSTRUCTORS])
def test_state_dict_keys_shapes_dtypes_match_jax(name, kw, monkeypatch):
    jm, jsd = _abstract_jax(lambda: getattr(jmodels, name)(**kw))
    # construction only: the port's draws are skipped as well
    monkeypatch.setattr(tinit, "_uniform", lambda shape, *a: torch.empty(
        tuple(shape)))
    tm = getattr(tmodels, name)(device="cpu", **kw)
    tsd = tm.state_dict()
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tuple(tsd[k].shape) == tuple(v.shape), k
        assert str(tsd[k].dtype).replace("torch.", "") == str(v.dtype), k
    assert _torch_dropouts(tm) == _jax_dropouts(jm)


def _loss(logits, y, cross_entropy):
    if isinstance(logits, tuple):     # GoogLeNet: main + two aux heads
        return sum(cross_entropy(l, y) for l in logits)
    return cross_entropy(logits, y)


def _jit(fn, *args, fast_compile=True):
    """``jax.jit(fn)(*args)``, compiled at XLA's backend optimisation level
    0 when ``fast_compile`` (the same arithmetic, compiled in about half
    the time and run slower: the large products of AlexNet's and VGG's
    classifiers and InceptionV3's convolutions take the default)."""
    lowered = jax.jit(fn).lower(*args)
    return (lowered.compile({"xla_backend_optimization_level": 0})
            if fast_compile else lowered.compile())(*args)


def _jax_reference(jm, state, x, y, fast_compile):
    """The JAX model's training-mode loss, logits, gradients and new
    BatchNorm statistics on the numpy ``state``, jitted."""
    trainable = jm.trainable_variables()
    tp = {k: jnp.asarray(state[k]) for k in trainable}
    rest = {k: jnp.asarray(v) for k, v in state.items() if k not in trainable}

    def loss_fn(p, x, y):
        logits, newv = jm.apply({**rest, **p}, x, mutable=True)
        newv = {k: v for k, v in newv.items() if k in rest}
        return _loss(logits, y, JF.cross_entropy), (logits, newv)
    jm.train()
    out = _jit(jax.value_and_grad(loss_fn, has_aux=True), tp,
               jnp.asarray(x), jnp.asarray(y), fast_compile=fast_compile)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_forward_backward_match_jax(case, monkeypatch):
    name, kw, hw, f64, fast_compile = FAMILIES[case]
    if case in DEPTH_CUTS:
        module, tables = DEPTH_CUTS[case]
        for package in ("paddle_tpu", "paddle_tpu_torch"):
            mod = importlib.import_module(f"{package}.vision.models.{module}")
            for attr, table in tables.items():
                monkeypatch.setattr(mod, attr, table)
    make_j, make_t = getattr(jmodels, name), getattr(tmodels, name)
    jm, _ = _abstract_jax(lambda: make_j(num_classes=CLASSES, **kw))
    tm = make_t(num_classes=CLASSES, device="cpu", **kw)
    for m in tm.modules():            # Dropout at p=0 on both sides
        if isinstance(m, TDropout):
            m.p = 0.0
    for m in jm.sublayers(include_self=True):
        if isinstance(m, JDropout):
            m.p = 0.0
    dtype = np.float64 if f64 else np.float32
    state = {k: v.numpy().astype(dtype) for k, v in tm.state_dict().items()}
    r = np.random.RandomState(0)
    x = (r.randn(BATCH, 3, hw, hw) * 0.5).astype(dtype)
    y = r.randint(0, CLASSES, (BATCH,))
    if f64:
        with enable_x64():
            (jloss, (jlogits, newv)), jgrads = _jax_reference(
                jm, state, x, y, fast_compile)
        tm = tm.double()
        tols = (1e-9, 1e-9, 1e-9)
    else:
        (jloss, (jlogits, newv)), jgrads = _jax_reference(
            jm, state, x, y, fast_compile)
        tols = (1e-4, 5e-4, 1e-5)
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = _loss(logits, torch.from_numpy(y), TF.cross_entropy)
    loss.backward()
    _close(loss.detach(), jloss, "loss", tols[0])
    if isinstance(logits, tuple):
        assert len(logits) == len(jlogits) == 3
        for i, (t, j) in enumerate(zip(logits, jlogits)):
            _close(t.detach(), j, f"logits {i}", tols[0])
    else:
        _close(logits.detach(), jlogits, "logits", tols[0])
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(jgrads)
    for k, g in jgrads.items():
        _close(params[k].grad, g, f"grad {k}", tols[1])
    buffers = dict(tm.named_buffers())
    assert sorted(buffers) == sorted(newv)
    for k, v in newv.items():
        _close(buffers[k], v, f"buffer {k}", tols[2])


def test_headless_backbones_match_the_jax_shapes():
    """``num_classes=0`` / ``with_pool=False`` as the JAX test."""
    x = torch.randn(2, 3, 64, 64)
    m = tmodels.mobilenet_v2(scale=0.25, num_classes=0, device="cpu").eval()
    with torch.no_grad():
        feats = m(x)
    assert feats.shape == (2, 1280, 1, 1)
    m = tmodels.vgg11(num_classes=0, with_pool=False, device="cpu").eval()
    with torch.no_grad():
        feats = m(x)
    assert feats.shape == (2, 512, 2, 2)
    m = tmodels.googlenet(num_classes=0, device="cpu").eval()
    with torch.no_grad():
        assert m(x).shape == (2, 1024, 1, 1)


def test_conv_norm_activation_matches_jax():
    from paddle_tpu.vision.models.utils import ConvNormActivation as JCNA
    from paddle_tpu_torch.vision.ops import ConvNormActivation as TCNA
    x = np.random.RandomState(3).randn(2, 8, 9, 9).astype(np.float32)
    for act in ("relu", "relu6", "hardswish", "swish", "none"):
        pt.seed(0)
        jb = JCNA(8, 16, 3, stride=2, groups=8, act=act)
        tb = TCNA(8, 16, 3, stride=2, groups=8, act=act, device="cpu")
        load_jax_state(tb, {k: np.array(v)
                            for k, v in jb.state_dict().items()})
        jb.eval()
        tb.eval()
        with torch.no_grad():
            _close(tb(torch.from_numpy(x)), jb(jnp.asarray(x)), act, 1e-5)
    with pytest.raises(ValueError):
        TCNA(8, 8, act="gelu", device="cpu")


@pytest.mark.parametrize("name,hw", [("mobilenet_v2", 224),
                                     ("inception_v3", 299)])
def test_vision_training_workload_builds_a_family(name, hw):
    model, opt, images, labels, kw = convert.vision_training_workload(
        name, "cpu", batch=2, scale=0.25) if name == "mobilenet_v2" else \
        convert.vision_training_workload(name, "cpu", batch=1)
    assert tuple(images.shape) == (images.shape[0], 3, hw, hw)
    rng = np.random.RandomState(0)
    ref = (rng.randn(*images.shape) * 0.5).astype(np.float32)
    np.testing.assert_array_equal(images.numpy(), ref)
    np.testing.assert_array_equal(labels.numpy(),
                                  rng.randint(0, 1000, (images.shape[0],)))
    assert isinstance(opt, topt.Momentum) and opt.momentum == 0.9
    assert opt.get_lr() == 0.1 and opt._wd == 1e-4
    assert kw == {"level": "O1"}
    assert model.num_classes == 1000
    if name == "mobilenet_v2":
        assert model.scale == 0.25


def test_vision_training_workload_trains_at_a_small_size():
    model, opt, images, labels, kw = convert.vision_training_workload(
        "squeezenet1_1", "cpu", batch=4, hw=31, level="O0")
    losses = [float(training.classification_step(model, opt, images, labels,
                                                  **kw)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_exports_cover_the_jax_package():
    import inspect

    from paddle_tpu.vision import ops as jops
    from paddle_tpu_torch.vision import ops as tops
    names = [n for n, v in vars(jmodels).items()
             if not n.startswith("_") and not inspect.ismodule(v)]
    assert len(names) > 50
    assert [n for n in names if not hasattr(tmodels, n)] == []
    assert set(names) <= set(tmodels.__all__)
    assert set(jops.__all__) <= set(tops.__all__)
    assert all(hasattr(tops, n) for n in tops.__all__)
