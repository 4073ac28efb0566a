"""ASP n:m sparsity of the port (``incubate/sparsity.py``) against the JAX
package's, on the CPU.

The masks are the JAX numpy algorithm's, bit for bit, for every algorithm
and shape (padding and conv kernels included).  ``prune_model`` on
``gpt_tiny`` with the JAX weights (``convert.state_dict_from_jax``) prunes
the same weights to the same values, and the decorated optimizer keeps
the pattern through training while its losses track the JAX run's
(float32, ``rtol 1e-5``).  Exclusion is by exact name or dotted prefix.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.optimizer as jopt
from paddle_tpu.incubate import sparsity as jsp
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.framework.dtype import device_scope
from paddle_tpu_torch.incubate import sparsity as tsp
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny


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


@pytest.fixture(autouse=True)
def _clean_registries():
    for m in (jsp, tsp):
        m.reset_excluded_layers()
        m.reset_masks()
    yield
    for m in (jsp, tsp):
        m.reset_excluded_layers()
        m.reset_masks()


SHAPES = [(8, 16), (5, 7), (12, 4), (6, 4, 3, 3)]
ALGOS = ["MASK_1D", "MASK_2D_GREEDY", "MASK_2D_BEST"]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_masks_are_bit_identical_with_jax(algo, shape):
    r = np.random.RandomState(sum(shape))
    w = r.randn(*shape).astype(np.float32)
    w[0, :2] = 0.25                    # ties, handled as numpy does
    for n, m in ((2, 4), (1, 4)):
        jm = jsp.create_mask(w, getattr(jsp.MaskAlgo, algo), n, m)
        tm = tsp.create_mask(w, getattr(tsp.MaskAlgo, algo), n, m)
        assert tm.dtype == jm.dtype and tm.shape == jm.shape
        np.testing.assert_array_equal(tm, jm)
        # the tensor form gives the same mask
        np.testing.assert_array_equal(
            tsp.create_mask(torch.from_numpy(w),
                            getattr(tsp.MaskAlgo, algo), n, m), jm)
        check = tsp.CheckMethod.get_checking_method(
            getattr(tsp.MaskAlgo, algo))
        assert tsp.check_sparsity(w * tm, check, n, m)
        assert tsp.check_sparsity(w * tm, check, n, m) == \
            jsp.check_sparsity(w * jm, jsp.CheckMethod(check.value), n, m)


def test_checkers_and_density_match_jax():
    r = np.random.RandomState(3)
    for _ in range(20):
        w = r.randn(8, 8).astype(np.float32) * (r.rand(8, 8) < 0.5)
        for fn in ("check_mask_1d", "check_mask_2d"):
            assert getattr(tsp, fn)(w, 2, 4) == getattr(jsp, fn)(w, 2, 4)
        assert tsp.calculate_density(w) == jsp.calculate_density(w)
    assert tsp.calculate_density(torch.ones(2, 2, dtype=torch.bfloat16)) \
        == 1.0
    with pytest.raises(Exception):
        tsp.create_mask(np.ones(4, np.float32))


def _models(seed=0):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0, dtype="float32")
    jm = JaxGPT(jax_gpt_tiny(**kw))
    r = np.random.RandomState(seed)
    state = {k: (0.1 * r.randn(*v.shape)).astype(np.float32)
             for k, v in sorted(jm.state_dict().items())}
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tm = GPTForCausalLM(gpt_tiny(**kw), device="cpu")
    tm.load_state_dict(state_dict_from_jax(state, "cpu"))
    r = np.random.RandomState(seed + 1)
    ids = r.randint(0, 1024, (2, 32)).astype(np.int64)
    labels = r.randint(0, 1024, (2, 32)).astype(np.int64)
    return jm, tm, ids, labels


# the token embedding by its layer's prefix, the position table by its
# exact parameter name
EMBEDDINGS = ["gpt.wte", "gpt.wpe"]


@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_greedy"])
def test_prune_model_on_gpt_tiny_matches_jax(algo):
    jm, tm, _, _ = _models()
    names = dict(tm.named_parameters())
    for ex in EMBEDDINGS:
        assert any(n == ex or n.startswith(ex + ".") for n in names), ex
    jsp.set_excluded_layers(EMBEDDINGS)
    tsp.set_excluded_layers(EMBEDDINGS)
    jmasks = jsp.prune_model(jm, 2, 4, algo)
    tmasks = tsp.prune_model(tm, 2, 4, algo)
    assert sorted(tmasks) == sorted(jmasks) and len(tmasks) > 4
    assert not any(n.startswith(("gpt.wte", "gpt.wpe")) for n in tmasks)
    jstate = jm.state_dict()
    for name, mask in tmasks.items():
        np.testing.assert_array_equal(mask, jmasks[name])
        np.testing.assert_array_equal(names[name].detach().numpy(),
                                      np.asarray(jstate[name]))
        assert tsp.check_sparsity(names[name])


def test_decorated_optimizer_keeps_the_pattern_and_tracks_jax():
    jm, tm, ids, labels = _models(seed=4)
    jsp.set_excluded_layers(EMBEDDINGS)
    tsp.set_excluded_layers(EMBEDDINGS)
    jmasks = jsp.prune_model(jm, 2, 4, "mask_1d")
    tmasks = tsp.prune_model(tm, 2, 4, "mask_1d")
    jo = jsp.decorate(jopt.Momentum(learning_rate=0.05, momentum=0.9,
                                    weight_decay=0.01))
    to = tsp.decorate(topt.Momentum(learning_rate=0.05, momentum=0.9,
                                    weight_decay=0.01,
                                    parameters=tm.named_parameters()))

    def loss_fn(p):
        loss, _ = jm.apply(p, jnp.asarray(ids), labels=jnp.asarray(labels))
        return loss

    p = jm.state_dict()
    st = jo.init(p)
    step = jax.jit(jax.value_and_grad(loss_fn))
    ti, tl = torch.from_numpy(ids), torch.from_numpy(labels)
    for _ in range(3):
        jl, g = step(p)
        p, st = jo.apply_gradients(g, p, st)
        to.clear_grad()
        loss, _ = tm(ti, labels=tl)
        loss.backward()
        to.step()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    params = dict(tm.named_parameters())
    for name, mask in tmasks.items():
        w = params[name].detach().numpy()
        # momentum and weight decay would densify without the guard
        np.testing.assert_array_equal(w != 0, mask != 0)
        np.testing.assert_array_equal(np.asarray(p[name]) != 0,
                                      jmasks[name] != 0)
    # the wrapper passes everything else to the optimizer it wraps
    assert to.get_lr() == 0.05


def test_exclusion_is_exact_or_dotted_prefix():
    net = torch.nn.Sequential(*[torch.nn.Linear(8, 8) for _ in range(11)])
    tsp.set_excluded_layers(["0.weight", "1"])
    masks = tsp.prune_model(net, with_mask=False)
    assert "0.weight" not in masks and "1.weight" not in masks
    assert "10.weight" in masks          # "0.weight" is not a substring rule
    assert not tsp._MASKS                 # with_mask=False registers nothing
    tsp.reset_excluded_layers()
    assert "0.weight" in tsp.prune_model(net)
    assert "0.weight" in tsp._MASKS
    tsp.reset_masks()
    assert not tsp._MASKS
