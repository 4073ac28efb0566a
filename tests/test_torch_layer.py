"""CPU parity of the port's ``nn.Layer`` / ``nn.Parameter``
(``paddle_tpu_torch/nn/layer.py``) with the JAX ``paddle_tpu/nn/layer.py``.

The same seeded numpy weights and inputs go through a net at gpt_tiny's
width (hidden 128) in both packages, in float64: ``apply`` with and
without ``mutable`` (BatchNorm's new statistics), its gradients,
``bind``, ``set_state_dict`` (strict, not strict, the same ``KeyError``
text), the state-dict and forward hooks, ``full_name``,
``create_parameter``'s initializer choice and ``Parameter``'s surface,
all within ``TOL`` = 1e-12.  torch's own protocol is driven on the same
layers (``apply(fn)``, ``copy.deepcopy``, ``torch.save`` / ``torch.load``,
``weight_norm`` / ``spectral_norm``), and every difference by design is
pinned by a test of its own (``test_differs_by_design_*``)."""
import copy
import importlib
import inspect
import io

import numpy as np
import pytest
import torch
from torch.utils.hooks import RemovableHandle

import jax
import jax.numpy as jnp
from jax import enable_x64

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.framework.errors import InvalidArgumentError as JInvalid
from paddle_tpu.nn import initializer as jI
from paddle_tpu.nn import layer as jlayer

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.framework.errors import InvalidArgumentError as TInvalid
from paddle_tpu_torch.nn import initializer as tI
from paddle_tpu_torch.nn import layer as tlayer

TOL = 1e-12
H = 128            # gpt_tiny's hidden width
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite's xdist
    workers oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL, (what, err)


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(H, 2 * H)
        self.bn = jnn.BatchNorm1D(2 * H)
        self.ln = jnn.LayerNorm(2 * H)
        self.fc2 = jnn.Linear(2 * H, H)
        self.scale = self.create_parameter(
            [H], default_initializer=jI.Constant(1.5))
        self.register_buffer("calls", jnp.zeros(()), persistable=False)

    def forward(self, x):
        y = self.ln(jax.nn.relu(self.bn(self.fc1(x))))
        return self.fc2(y) * self.scale

    def head(self, x):
        return self.fc1(x)


class TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(H, 2 * H, device=CPU)
        self.bn = tnn.BatchNorm1D(2 * H, device=CPU)
        self.ln = tnn.LayerNorm(2 * H, device=CPU)
        self.fc2 = tnn.Linear(2 * H, H, device=CPU)
        # no device: where the layer's tensors already are
        self.scale = self.create_parameter(
            [H], default_initializer=tI.Constant(1.5))
        self.register_buffer("calls", torch.zeros(()), persistable=False)

    def forward(self, x):
        y = self.ln(torch.relu(self.bn(self.fc1(x))))
        return self.fc2(y) * self.scale

    def head(self, x):
        return self.fc1(x)


def _nets():
    """The JAX net (float64) and the port's with its weights."""
    with enable_x64():
        pt.seed(0)
        j = JNet()
        j.astype("float64")
        sd = {k: np.asarray(v) for k, v in j.state_dict().items()}
    t = TNet()
    t.astype("float64")
    t.set_state_dict(sd)
    return j, t, sd


def _inputs(seed=1, n=6):
    return np.random.default_rng(seed).standard_normal((n, H))


def _perturbed(sd, seed=2):
    rng = np.random.default_rng(seed)
    return {k: v + 0.01 * rng.standard_normal(v.shape) for k, v in sd.items()}


def test_state_dict_keys_and_values_match_jax():
    j, t, sd = _nets()
    tsd = t.state_dict()
    assert sorted(tsd) == sorted(sd)
    for k in sd:
        _close(tsd[k], sd[k], k)
    assert "calls" not in tsd and "calls" in dict(t.named_buffers())
    # without buffers the two orders agree: parameters, depth first
    assert list(t.to_static_state_dict(include_buffers=False)) == list(
        j.to_static_state_dict(include_buffers=False))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_apply_and_its_gradients_match_jax(mode):
    j, t, sd = _nets()
    getattr(j, mode)()
    getattr(t, mode)()
    x = _inputs()
    var = _perturbed(sd)
    tvar = {k: torch.from_numpy(v.copy()) for k, v in var.items()}
    own_before = {k: v.clone() for k, v in t.state_dict().items()}
    with enable_x64():
        jvar = {k: jnp.asarray(v) for k, v in var.items()}
        jout, jnew = j.apply(jvar, jnp.asarray(x), mutable=True)
        jplain = j.apply(jvar, jnp.asarray(x))
        params = [k for k, _ in j.named_parameters()]

        def loss(p):
            return jnp.sum(j.apply({**jvar, **p}, jnp.asarray(x)) ** 2)

        jgrad = jax.grad(loss)({k: jvar[k] for k in params})
    tout, tnew = t.apply(tvar, torch.from_numpy(x), mutable=True)
    _close(tout, jout, "out")
    _close(t.apply(tvar, torch.from_numpy(x)), jplain, "out, not mutable")
    assert set(tnew) == set(jnew)
    for k in jnew:
        _close(tnew[k], jnew[k], k)
    if mode == "train":     # the new running statistics come back
        assert not np.allclose(_np(tnew["bn._mean"]), var["bn._mean"])
    # neither the layer nor the caller's dict changed
    for k, v in t.state_dict().items():
        assert torch.equal(v, own_before[k]), k
    for k, v in var.items():
        assert np.array_equal(_np(tvar[k]), v), k
    leaves = {k: tvar[k].clone().requires_grad_() for k in params}
    tl = (t.apply({**tvar, **leaves}, torch.from_numpy(x)) ** 2).sum()
    tgrad = torch.autograd.grad(tl, list(leaves.values()))
    for k, g in zip(leaves, tgrad):
        _close(g, jgrad[k], f"grad {k}")


def test_apply_method_and_bind_match_jax():
    j, t, sd = _nets()
    j.eval()
    t.eval()
    x = _inputs(3)
    var = _perturbed(sd, 4)
    tvar = {k: torch.from_numpy(v) for k, v in var.items()}
    originals = {n: p for n, p in t.named_parameters()}
    with enable_x64():
        jvar = {k: jnp.asarray(v) for k, v in var.items()}
        jhead = j.apply(jvar, jnp.asarray(x), method="head")
        with j.bind(jvar):
            jbound = j(jnp.asarray(x))
    _close(t.apply(tvar, torch.from_numpy(x), method="head"), jhead, "head")
    with t.bind({**tvar, "optimizer.slot": torch.zeros(1)}):
        tbound = t(torch.from_numpy(x))
    _close(tbound, jbound, "bound")
    for n, p in t.named_parameters():
        assert p is originals[n], n


def test_set_state_dict_errors_match_jax():
    j, t, sd = _nets()
    bad = dict(sd)
    bad["extra.weight"] = np.zeros(2)
    del bad["fc2.bias"]
    with enable_x64():
        with pytest.raises(KeyError) as je:
            j.set_state_dict(bad)
    with pytest.raises(KeyError) as te:
        t.set_state_dict(bad)
    assert str(te.value) == str(je.value)
    # not strict: what matches loads
    new = _perturbed(sd, 5)
    del new["fc1.weight"]
    with enable_x64():
        j.set_state_dict({k: jnp.asarray(v) for k, v in new.items()},
                         strict=False)
        want = {k: np.asarray(v) for k, v in j.state_dict().items()}
    weight = t.fc1.weight
    t.set_state_dict(new, strict=False)
    assert t.fc1.weight is weight       # parameters load in place
    for k, v in t.state_dict().items():
        _close(v, want[k], k)
    wrong = {"fc2.bias": np.zeros(H + 1)}
    with enable_x64():
        with pytest.raises(JInvalid) as je:
            j.set_state_dict(wrong, strict=False)
    with pytest.raises(TInvalid) as te:
        t.set_state_dict(wrong, strict=False)
    assert str(te.value) == str(je.value)
    assert t.load_dict(sd) is t


def test_state_dict_hooks_fire_during_the_parent_call():
    j, t, _ = _nets()
    seen = {"jax": [], "port": []}

    def hook(tag):
        def fn(sd):
            seen[tag].append(len(sd))
            out = dict(sd)
            out["hooked"] = np.ones(1)
            return out
        return fn

    hj = j.fc1.register_state_dict_hook(hook("jax"))
    ht = t.fc1.register_state_dict_hook(hook("port"))
    with enable_x64():
        jkeys = list(j.state_dict())
    assert sorted(t.state_dict()) == sorted(jkeys) and "hooked" in jkeys
    assert seen["jax"] == seen["port"] == [len(jkeys) - 1]
    hj.remove()
    ht.remove()
    with enable_x64():
        assert "hooked" not in j.state_dict()
    assert "hooked" not in t.state_dict()


def test_forward_hooks_follow_the_jax_conventions():
    j, t, _ = _nets()
    j.eval()
    t.eval()
    x = _inputs(6)

    def pre(layer, args):
        return (args[0] * 2.0,)

    def post(layer, args, out):
        return out + 1.0

    def watch(layer, args, out):
        return None                     # None keeps the output

    with enable_x64():
        jp = j.fc1.register_forward_pre_hook(pre)
        jq = j.register_forward_post_hook(post)
        j.register_forward_post_hook(watch)
        jout = j(jnp.asarray(x))
        del j.fc1._forward_pre_hooks[jp]
        del j._forward_post_hooks[jq]
        jplain = j(jnp.asarray(x))
    tp = t.fc1.register_forward_pre_hook(pre)
    tq = t.register_forward_post_hook(post)
    t.register_forward_post_hook(watch)
    _close(t(torch.from_numpy(x)), jout, "hooked")
    tp.remove()
    tq.remove()
    _close(t(torch.from_numpy(x)), jplain, "unhooked")


def test_full_name_counts_per_class_as_jax():
    jlayer._full_name_counts.clear()
    tlayer._full_name_counts.clear()
    jl = [jnn.Linear(2, 2), jnn.Linear(2, 2), jnn.LayerNorm(2)]
    tl = [tnn.Linear(2, 2, device=CPU), tnn.Linear(2, 2, device=CPU),
          tnn.LayerNorm(2, device=CPU)]
    jn = [m.full_name() for m in jl] + [jl[0].full_name()]
    tn = [m.full_name() for m in tl] + [tl[0].full_name()]
    assert tn == jn == ["linear_0", "linear_1", "layernorm_0", "linear_0"]


def test_create_parameter_picks_the_initializer_as_jax():
    arr = np.random.default_rng(7).standard_normal((3, 4))
    jl, tl = jnn.Layer(), tnn.Layer()
    cases = [
        (dict(default_initializer=jI.Constant(0.5)),
         dict(default_initializer=tI.Constant(0.5))),
        (dict(default_initializer=jI.Assign(arr)),
         dict(default_initializer=tI.Assign(arr))),
        (dict(is_bias=True), dict(is_bias=True)),
        (dict(attr=jI.ParamAttr(initializer=jI.Constant(2.0))),
         dict(attr=tI.ParamAttr(initializer=tI.Constant(2.0)))),
        (dict(default_initializer=jI.Constant(-1.0), dtype="float64",
              trainable=False),
         dict(default_initializer=tI.Constant(-1.0), dtype="float64",
              trainable=False)),
    ]
    with enable_x64():
        for jkw, tkw in cases:
            jp = jl.create_parameter([3, 4], **jkw)
            tp = tl.create_parameter([3, 4], device=CPU, **tkw)
            assert isinstance(tp, tnn.Parameter)
            assert tp.dtype == getattr(torch, str(jp.dtype)), jkw
            assert tp.stop_gradient == jp.stop_gradient
            _close(tp, jp.value, str(jkw))
        jI.set_global_initializer(jI.Constant(0.25), jI.Constant(0.75))
        tI.set_global_initializer(tI.Constant(0.25), tI.Constant(0.75))
        try:
            for bias in (False, True):
                _close(tl.create_parameter([2], is_bias=bias, device=CPU),
                       jl.create_parameter([2], is_bias=bias).value, bias)
        finally:
            jI.set_global_initializer(None, None)
            tI.set_global_initializer(None, None)
        # the default weight rule: XavierUniform in both
        jw = np.asarray(jl.create_parameter([64, 32]).value)
    tw = _np(tl.create_parameter([64, 32], device=CPU))
    bound = np.sqrt(6.0 / (64 + 32))
    for w in (jw, tw):
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound


def test_parameter_surface_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((3, 4))
    b = rng.standard_normal((3, 4))
    with enable_x64():
        jp = jlayer.Parameter(jnp.asarray(a), name="w", is_bias=False)
        jres = [jp + 1.0, 2.0 + jp, jp - b, b - jp, jp * 3.0, 3.0 * jp,
                jp / 2.0, 2.0 / jp, jp @ b.T, b.T @ jp, -jp, jp[1],
                jp.T, jp.reshape(4, 3), jp.numpy(), jp.astype("float32")]
        jp.stop_gradient = True
        jflags = (jp.trainable, jp.stop_gradient)
        jp.trainable = True
        jp.set_value(b)
        jafter = jp.numpy()
    tp = tnn.Parameter(torch.from_numpy(a), name="w", is_bias=False)
    tb = torch.from_numpy(b)
    tres = [tp + 1.0, 2.0 + tp, tp - tb, tb - tp, tp * 3.0, 3.0 * tp,
            tp / 2.0, 2.0 / tp, tp @ tb.T, tb.T @ tp, -tp, tp[1],
            tp.T, tp.reshape(4, 3), tp.numpy(), tp.astype("float32")]
    for i, (g, w) in enumerate(zip(tres, jres)):
        _close(g, w, i)
    assert tres[-1].dtype == torch.float32
    assert tuple(tp.shape) == jp.shape and tp.name == jp.name == "w"
    assert tp.is_bias is jp.is_bias is False
    tp.stop_gradient = True
    assert (tp.trainable, tp.stop_gradient) == jflags
    assert not tp.requires_grad
    tp.trainable = True
    assert tp.requires_grad
    tp.set_value(b)
    _close(tp, jafter, "set_value")
    assert repr(tp).startswith("Parameter(name='w', shape=(3, 4)")


def test_containers_are_layers_with_the_jax_keys():
    with enable_x64():
        pt.seed(0)
        jseq = jnn.Sequential(jnn.Linear(2, 3), jnn.ReLU(), jnn.Linear(3, 1))
        jnamed = jnn.Sequential([("enc", jnn.Linear(2, 2)),
                                 ("dec", jnn.Linear(2, 2))])
        jlist = jnn.LayerList([jnn.Linear(2, 2)]).append(jnn.Linear(2, 2))
        jplist = jnn.ParameterList([jlayer.Parameter(jnp.zeros(2))])
    tseq = tnn.Sequential(tnn.Linear(2, 3, device=CPU), tnn.ReLU(),
                          tnn.Linear(3, 1, device=CPU))
    tnamed = tnn.Sequential([("enc", tnn.Linear(2, 2, device=CPU)),
                             ("dec", tnn.Linear(2, 2, device=CPU))])
    tlist = tnn.LayerList([tnn.Linear(2, 2, device=CPU)])
    tlist.append(tnn.Linear(2, 2, device=CPU))
    tplist = tnn.ParameterList([tnn.Parameter(torch.zeros(2))])
    for jm, tm in ((jseq, tseq), (jnamed, tnamed), (jlist, tlist),
                   (jplist, tplist)):
        assert isinstance(tm, tnn.Layer)
        assert list(tm.state_dict()) == list(jm.state_dict())
        assert [n for n, _ in tm.named_sublayers()] == [
            n for n, _ in jm.named_sublayers()]
    assert isinstance(tseq[1:], tnn.Sequential)


# JAX module -> port module whose Layer classes must be port Layers
_FAMILIES = ["nn.layers", "nn.layers_ext", "nn.rnn", "incubate.nn",
             "models.gpt", "models.bert", "distributed.moe", "vision.ops",
             "vision.models.resnet", "vision.models.lenet",
             "vision.models.alexnet", "vision.models.vgg",
             "vision.models.squeezenet", "vision.models.mobilenetv1",
             "vision.models.mobilenetv2", "vision.models.mobilenetv3",
             "vision.models.shufflenetv2", "vision.models.densenet",
             "vision.models.googlenet", "vision.models.inceptionv3",
             "vision.models.utils"]


def test_every_port_layer_whose_jax_counterpart_is_a_layer_is_one():
    checked = []
    for fam in _FAMILIES:
        jm = importlib.import_module(f"paddle_tpu.{fam}")
        tm = importlib.import_module(f"paddle_tpu_torch.{fam}")
        for name, cls in vars(jm).items():
            if (inspect.isclass(cls) and issubclass(cls, jlayer.Layer)
                    and cls.__module__ == jm.__name__
                    and hasattr(tm, name)):
                assert issubclass(getattr(tm, name), tlayer.Layer), \
                    f"{fam}.{name}"
                checked.append(f"{fam}.{name}")
        for name, cls in vars(tm).items():
            if (inspect.isclass(cls) and issubclass(cls, torch.nn.Module)
                    and cls.__module__ == tm.__name__):
                assert issubclass(cls, tlayer.Layer), f"{fam}.{name}"
    assert len(checked) > 150, len(checked)
    from paddle_tpu_torch.models.translation import TranslationModel
    assert issubclass(TranslationModel, tlayer.Layer)


def test_torch_protocol_on_a_layer():
    _, t, sd = _nets()

    def zero_bias(m):
        if isinstance(m, tnn.Linear):
            with torch.no_grad():
                m.bias.zero_()

    assert t.apply(zero_bias) is t
    assert float(t.fc1.bias.abs().sum()) == 0.0
    t.apply_fn(zero_bias)
    clone = copy.deepcopy(t)
    assert isinstance(clone.scale, tnn.Parameter)
    assert clone.scale is not t.scale
    assert torch.equal(clone.scale, t.scale)
    list(t.named_parameters())              # names the parameters
    assert copy.deepcopy(t).scale.name == t.scale.name == "scale"
    buf = io.BytesIO()
    torch.save(t.state_dict(), buf)
    buf.seek(0)
    loaded = torch.load(buf)
    other = TNet()
    other.astype("float64")
    other.set_state_dict(loaded)
    other.load_state_dict(loaded)            # torch's own loader too
    for k, v in other.state_dict().items():
        assert torch.equal(v, loaded[k]), k
    pbuf = io.BytesIO()
    torch.save(t.scale, pbuf)
    pbuf.seek(0)
    p = torch.load(pbuf, weights_only=False)
    assert isinstance(p, tnn.Parameter) and p.name == "scale"
    x = torch.from_numpy(_inputs(9))
    loss = t(x).sum()
    loss.backward()
    assert t.fc1.weight.grad is not None
    t.clear_gradients()
    assert t.fc1.weight.grad is None


def test_weight_norm_and_spectral_norm_on_a_layer():
    torch.manual_seed(0)
    x = torch.from_numpy(_inputs(10, 4)).float()
    lin = tnn.utils.weight_norm(tnn.Linear(H, 8, device=CPU))
    assert isinstance(lin, tnn.Layer)
    variables = {k: v.detach().clone() for k, v in lin.state_dict().items()}
    assert "weight_g" in variables and "weight_v" in variables
    _close(lin.apply(variables, x), lin(x), "weight_norm")
    sn = tnn.utils.spectral_norm(tnn.Linear(H, 8, device=CPU))
    twin = copy.deepcopy(sn)
    own = {k: v.clone() for k, v in sn.named_buffers()}
    variables = dict(sn.named_parameters())
    out, new = sn.apply(variables, x, mutable=True)
    _close(out, twin(x), "spectral_norm")
    moved = sorted(set(new) - set(variables))
    assert moved, "the power iteration's vectors come back"
    twin_bufs = dict(twin.named_buffers())
    for k in moved:
        _close(new[k], twin_bufs[k], k)
    for k, v in sn.named_buffers():
        assert torch.equal(v, own[k]), k


def test_differs_by_design_hook_handles_are_torch_handles():
    j, t = jnn.Linear(2, 2), tnn.Linear(2, 2, device=CPU)
    assert isinstance(j.register_forward_post_hook(lambda *a: None), int)
    h = t.register_forward_post_hook(lambda *a: None)
    assert isinstance(h, RemovableHandle)
    assert isinstance(t.register_state_dict_hook(lambda sd: None),
                      RemovableHandle)


def test_differs_by_design_trainable_variables_are_the_parameters():
    _, t, _ = _nets()
    tv = t.trainable_variables()
    assert list(tv) == [n for n, _ in t.named_parameters()]
    assert all(tv[n] is p for n, p in t.named_parameters())
    assert inspect.isgenerator(t.parameters())     # torch's, not a list


def test_differs_by_design_state_dict_keeps_the_torch_order():
    """The same keys; torch lists each layer's buffers after its own
    parameters, the JAX package every parameter before any buffer."""
    j, t, sd = _nets()
    tkeys = list(t.state_dict())
    assert tkeys != list(sd) and sorted(tkeys) == sorted(sd)
    assert tkeys.index("bn._mean") < tkeys.index("ln.weight")


def test_differs_by_design_set_value_checks_the_shape():
    with enable_x64():
        jp = jlayer.Parameter(jnp.zeros((2, 2)))
        jp.set_value(np.ones((3,)))                 # JAX takes any shape
        assert jp.shape == (3,)
    tp = tnn.Parameter(torch.zeros(2, 2))
    with pytest.raises(TInvalid):
        tp.set_value(np.ones((3,)))


def test_differs_by_design_apply_leaves_the_layer_buffers():
    """The JAX ``apply`` updates a buffer that is not in ``variables`` in
    the layer itself; the port's never changes the layer."""
    with enable_x64():
        pt.seed(0)
        jbn = jnn.BatchNorm1D(4)
        x = _inputs(11)[:, :4]
        jbn.apply({}, jnp.asarray(x))
        jmoved = not np.allclose(np.asarray(jbn._mean), 0.0)
    tbn = tnn.BatchNorm1D(4, device=CPU)
    tbn.apply({}, torch.from_numpy(x).float())
    assert jmoved and torch.equal(tbn._mean, torch.zeros(4))


def test_gpt_tiny_apply_equals_the_module_bit_for_bit():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    torch.manual_seed(0)
    m = GPTForCausalLM(gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                                use_pallas_attention=True), device=CPU)
    assert isinstance(m, tnn.Layer)
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(rng.integers(0, 1024, (2, 16)))
    labels = torch.from_numpy(rng.integers(0, 1024, (2, 16)))
    variables = {**dict(m.named_parameters()), **dict(m.named_buffers())}
    names = [n for n, _ in m.named_parameters()]
    loss = m.apply(variables, ids, labels)[0]
    grads = torch.autograd.grad(loss, [variables[n] for n in names])
    ref = m(ids, labels=labels)[0]
    ref_grads = torch.autograd.grad(ref, [p for _, p in
                                          m.named_parameters()])
    assert torch.equal(loss, ref)
    for n, g, r in zip(names, grads, ref_grads):
        assert torch.equal(g, r), n
