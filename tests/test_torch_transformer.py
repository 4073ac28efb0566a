"""Port parity of the Transformer family (``paddle_tpu_torch/nn/layers.py``:
``MultiHeadAttention``, the encoder / decoder layers and stacks,
``Transformer``, ``RMSNorm``, ``Embedding``), the incubate fused layers
and the translation model's training, against the JAX package on the CPU:
the JAX layer's weights go into the port's through
``convert.load_jax_state``, the inputs are the same seeded numpy arrays.

Tolerances: float32 forward 2e-5 and gradients 5e-4, absolute and relative
(both sides multiply in float32; conftest pins JAX to "highest")."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.incubate import nn as jinc
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models.translation import TranslationModel, collate
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.text import WMT14
from paddle_tpu_torch.training import seq2seq_step


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


F32_TOL = 2e-5
GRAD_TOL = 5e-4
D, HEADS, FFN = 32, 4, 64


def _a(seed, *shape, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(
        np.float32)


def _np(v):
    return np.asarray(v.detach() if torch.is_tensor(v) else v, np.float32)


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


def _port_of(jlayer, tlayer):
    load_jax_state(tlayer, {k: np.asarray(v)
                            for k, v in jlayer.state_dict().items()})
    return tlayer


def _tree_out(out):
    """The first output of a layer that may return ``(out, cache)``."""
    return out[0] if isinstance(out, tuple) else out


def _check(jlayer, tlayer, inputs, kwargs=None, grads=True):
    """Forward of both layers on the same numpy inputs, then the gradients
    of ``sum(out * ct)`` by every parameter and input."""
    kwargs = kwargs or {}
    params = jlayer.trainable_variables()
    ct = _a(99, *_tree_out(jlayer.apply(params, *map(jnp.asarray, inputs),
                                        **kwargs)).shape)

    def jloss(p, *xs):
        out = _tree_out(jlayer.apply(p, *xs, **kwargs))
        return (out * ct).sum(), out
    (_, jout), (jg, *jxg) = jax.value_and_grad(
        jloss, argnums=tuple(range(len(inputs) + 1)), has_aux=True)(
            params, *map(jnp.asarray, inputs))
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    tkw = {k: torch.from_numpy(np.array(v)) if isinstance(
        v, (np.ndarray, jnp.ndarray)) else v for k, v in kwargs.items()}
    tout = _tree_out(tlayer(*xs, **tkw))
    _close(tout, jout, F32_TOL, f"{type(tlayer).__name__} out")
    if not grads:
        return
    (tout * torch.from_numpy(ct)).sum().backward()
    for name, p in tlayer.named_parameters():
        _close(p.grad, jg[name], GRAD_TOL, f"grad {name}")
    for i, (x, g) in enumerate(zip(xs, jxg)):
        _close(x.grad, g, GRAD_TOL, f"grad input {i}")


# ---------------------------------------------------------------------------
# MultiHeadAttention
# ---------------------------------------------------------------------------
def _mask(seed, q, k):
    m = np.where(np.random.RandomState(seed).rand(q, k) < 0.3,
                 np.finfo(np.float32).min, 0.0).astype(np.float32)
    m[:, 0] = 0.0       # every query sees a key
    return m


@pytest.mark.parametrize("form", ["self", "cross", "kdim_vdim", "masked"])
def test_multi_head_attention_matches_jax(form):
    kdim = vdim = None
    q = _a(1, 2, 5, D)
    if form == "self":
        inputs, kw = [q], {}
    elif form == "cross":
        inputs, kw = [q, _a(2, 2, 7, D), _a(3, 2, 7, D)], {}
    elif form == "kdim_vdim":
        kdim, vdim = 24, 20
        inputs, kw = [q, _a(2, 2, 7, 24), _a(3, 2, 7, 20)], {}
    else:
        inputs, kw = [q], {"attn_mask": _mask(4, 5, 5)}
    jm = jnn.MultiHeadAttention(D, HEADS, kdim=kdim, vdim=vdim)
    tm = _port_of(jm, tnn.MultiHeadAttention(D, HEADS, kdim=kdim, vdim=vdim,
                                             device="cpu"))
    _check(jm, tm, inputs, kw)


def test_multi_head_attention_cache_matches_jax():
    jm = jnn.MultiHeadAttention(D, HEADS)
    tm = _port_of(jm, tnn.MultiHeadAttention(D, HEADS, device="cpu"))
    ck, cv = _a(5, 2, HEADS, 3, D // HEADS), _a(6, 2, HEADS, 3, D // HEADS)
    x = _a(7, 2, 1, D)
    jout, (jk, jv) = jm(jnp.asarray(x), cache=(jnp.asarray(ck),
                                               jnp.asarray(cv)))
    tout, (tk, tv) = tm(torch.from_numpy(x), cache=(torch.from_numpy(ck),
                                                    torch.from_numpy(cv)))
    assert tuple(tk.shape) == (2, HEADS, 4, D // HEADS)
    _close(tout, jout, F32_TOL, "out")
    _close(tk, jk, F32_TOL, "k")
    _close(tv, jv, F32_TOL, "v")


# ---------------------------------------------------------------------------
# encoder / decoder layers and stacks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layer_matches_jax(pre, act):
    jm = jnn.TransformerEncoderLayer(D, HEADS, FFN, dropout=0.0,
                                     activation=act, normalize_before=pre)
    tm = _port_of(jm, tnn.TransformerEncoderLayer(
        D, HEADS, FFN, dropout=0.0, activation=act, normalize_before=pre,
        device="cpu"))
    _check(jm, tm, [_a(10, 2, 6, D)], {"src_mask": _mask(11, 6, 6)})


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_decoder_layer_matches_jax(pre, act):
    jm = jnn.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0,
                                     activation=act, normalize_before=pre)
    tm = _port_of(jm, tnn.TransformerDecoderLayer(
        D, HEADS, FFN, dropout=0.0, activation=act, normalize_before=pre,
        device="cpu"))
    mask = np.asarray(jnn.Transformer.generate_square_subsequent_mask(5))
    _check(jm, tm, [_a(12, 2, 5, D), _a(13, 2, 7, D)],
           {"tgt_mask": mask, "memory_mask": _mask(14, 5, 7)})


def test_causal_mask_matches_jax():
    got = tnn.Transformer.generate_square_subsequent_mask(6)
    ref = np.asarray(jnn.Transformer.generate_square_subsequent_mask(6))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_incremental_cache_matches_full_pass_and_jax(pre):
    # one token at a time on the cache, against the full causal pass
    mk = lambda M, **k: M.TransformerDecoderLayer(  # noqa: E731
        D, HEADS, FFN, dropout=0.0, normalize_before=pre, **k)
    jdec = jnn.TransformerDecoder(lambda: mk(jnn), 2,
                                  norm=jnn.LayerNorm(D) if pre else None)
    tdec = _port_of(jdec, tnn.TransformerDecoder(
        lambda: mk(tnn, device="cpu"), 2,
        norm=tnn.LayerNorm(D, device="cpu") if pre else None))
    tgt, memory = _a(15, 2, 6, D), _a(16, 2, 4, D)
    mask = tnn.Transformer.generate_square_subsequent_mask(6)
    full = tdec(torch.from_numpy(tgt), torch.from_numpy(memory),
                tgt_mask=mask)
    jfull = jdec(jnp.asarray(tgt), jnp.asarray(memory),
                 tgt_mask=jnp.asarray(mask.numpy()))
    _close(full, jfull, F32_TOL, "full pass")
    shape = (2, HEADS, 0, D // HEADS)
    caches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(2)]
    for t in range(6):
        step, caches = tdec(torch.from_numpy(tgt[:, t:t + 1]),
                            torch.from_numpy(memory), cache=caches)
        jstep, jcaches = jdec(jnp.asarray(tgt[:, t:t + 1]),
                              jnp.asarray(memory), cache=jcaches)
        _close(step, full[:, t:t + 1], F32_TOL, f"step {t} vs full")
        _close(step, jstep, F32_TOL, f"step {t} vs jax")
        assert tuple(caches[0][0].shape) == (2, HEADS, t + 1, D // HEADS)


@pytest.mark.parametrize("pre", [False, True])
def test_transformer_forward_and_grads_match_jax(pre):
    jm = jnn.Transformer(D, HEADS, 2, 2, FFN, dropout=0.0,
                         normalize_before=pre)
    tm = _port_of(jm, tnn.Transformer(D, HEADS, 2, 2, FFN, dropout=0.0,
                                      normalize_before=pre, device="cpu"))
    assert set(tm.state_dict()) == set(jm.state_dict())
    assert "encoder.layers.1.self_attn.q_proj.weight" in tm.state_dict()
    mask = np.asarray(jnn.Transformer.generate_square_subsequent_mask(5))
    _check(jm, tm, [_a(17, 2, 6, D), _a(18, 2, 5, D)], {"tgt_mask": mask})


def test_transformer_base_defaults():
    tm = tnn.Transformer(device="cpu")
    layer = tm.encoder.layers[0]
    assert (tm.d_model, tm.nhead) == (512, 8)
    assert len(tm.encoder.layers) == len(tm.decoder.layers) == 6
    assert layer.linear1.weight.shape == (512, 2048)
    assert layer.dropout1.p == 0.1 and not layer.normalize_before
    assert tm.encoder.norm is None and tm.decoder.norm is None


def test_dropout_is_active_in_training_only():
    tm = tnn.TransformerEncoderLayer(D, HEADS, FFN, dropout=0.5,
                                     device="cpu")
    x = torch.from_numpy(_a(19, 2, 6, D))
    tm.train()
    assert not torch.equal(tm(x), tm(x))
    tm.eval()
    assert torch.equal(tm(x), tm(x))


# ---------------------------------------------------------------------------
# RMSNorm, Embedding (Queue 3 item 1)
# ---------------------------------------------------------------------------
def test_rms_norm_matches_jax():
    jm = jnn.RMSNorm(D)
    tm = _port_of(jm, tnn.RMSNorm(D, device="cpu"))
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(1 + _a(20, D, std=0.1)))
    jm.weight.value = jnp.asarray(tm.weight.detach().numpy())
    _check(jm, tm, [_a(21, 2, 3, D)])
    ref = jF.rms_norm(jnp.asarray(_a(22, 4, D), jnp.bfloat16))
    got = tF.rms_norm(torch.from_numpy(_a(22, 4, D)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(ref, np.float32), 2.0 ** -7, "bf16")


def _normal_moments(w, what, z=6.0):
    w = np.asarray(w, np.float64).ravel()
    n = w.size
    assert abs(w.mean()) <= z * math.sqrt(1.0 / n), (what, w.mean())
    # the variance of a standard normal's sample variance is 2 / n
    assert abs(w.var() - 1.0) <= z * math.sqrt(2.0 / n), (what, w.var())


def test_embedding_defaults_to_standard_normal_as_jax():
    got = tnn.Embedding(512, 256, device="cpu").weight.detach().numpy()
    _normal_moments(got, "port Embedding.weight")
    _normal_moments(np.asarray(jnn.Embedding(512, 256).weight.value),
                    "jax Embedding.weight")
    attr = tnn.ParamAttr(initializer=tnn.initializer.Constant(0.5))
    assert torch.equal(tnn.Embedding(3, 2, weight_attr=attr,
                                     device="cpu").weight,
                       torch.full((3, 2), 0.5))


def test_embedding_std_keeps_torch_normal_draws():
    # GPT and BERT pass std: their draws are what they were
    torch.manual_seed(5)
    got = tnn.Embedding(7, 3, std=0.02, device="cpu").weight.detach()
    torch.manual_seed(5)
    want = torch.nn.init.normal_(torch.empty(7, 3), 0.0, 0.02)
    assert torch.equal(got, want)


def test_embedding_padding_idx_matches_jax():
    jm = jnn.Embedding(10, 6, padding_idx=3)
    tm = _port_of(jm, tnn.Embedding(10, 6, padding_idx=3, device="cpu"))
    ids = np.array([[1, 3, 3, 9], [3, 0, 2, 3]], np.int64)
    jout = jm(jnp.asarray(ids))
    tout = tm(torch.from_numpy(ids))
    _close(tout, jout, 0.0, "embedding")
    assert not bool(tout[ids == 3].any())
    (tout * torch.from_numpy(_a(23, 2, 4, 6))).sum().backward()
    assert not bool(tm.weight.grad[3].any())
    assert bool(tm.weight.grad[1].any())


# ---------------------------------------------------------------------------
# incubate.nn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pre", [False, True])
def test_fused_multi_head_attention_matches_jax(pre):
    jm = jinc.FusedMultiHeadAttention(D, HEADS, dropout_rate=0.0,
                                      attn_dropout_rate=0.0,
                                      normalize_before=pre)
    tm = _port_of(jm, tinc.nn.FusedMultiHeadAttention(
        D, HEADS, dropout_rate=0.0, attn_dropout_rate=0.0,
        normalize_before=pre, device="cpu"))
    _check(jm, tm, [_a(24, 2, 6, D)], {"attn_mask": _mask(25, 6, 6)})


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_feed_forward_matches_jax(pre, act):
    jm = jinc.FusedFeedForward(D, FFN, dropout_rate=0.0, activation=act,
                               normalize_before=pre)
    tm = _port_of(jm, tinc.nn.FusedFeedForward(
        D, FFN, dropout_rate=0.0, activation=act, normalize_before=pre,
        device="cpu"))
    _check(jm, tm, [_a(26, 2, 6, D)])


def test_fused_transformer_encoder_layer_matches_jax():
    jm = jinc.FusedTransformerEncoderLayer(D, HEADS, FFN, dropout_rate=0.0,
                                           activation="gelu")
    tm = _port_of(jm, tinc.nn.FusedTransformerEncoderLayer(
        D, HEADS, FFN, dropout_rate=0.0, activation="gelu", device="cpu"))
    _check(jm, tm, [_a(27, 2, 6, D)])


def test_fused_encoder_layer_is_the_plain_layer_on_the_same_weights():
    # the card check of the incubate layers holds the fused layer against
    # a plain TransformerEncoderLayer carrying its weights: q | k | v side
    # by side in qkv_proj
    fused = tinc.nn.FusedTransformerEncoderLayer(
        D, HEADS, FFN, dropout_rate=0.0, activation="gelu", device="cpu")
    plain = tnn.TransformerEncoderLayer(D, HEADS, FFN, dropout=0.0,
                                        activation="gelu", device="cpu")
    sd = fused.state_dict()
    w, b = sd["fused_attn.qkv_proj.weight"], sd["fused_attn.qkv_proj.bias"]
    mapped = {"linear1.weight": sd["ffn.linear1.weight"],
              "linear1.bias": sd["ffn.linear1.bias"],
              "linear2.weight": sd["ffn.linear2.weight"],
              "linear2.bias": sd["ffn.linear2.bias"],
              "norm1.weight": sd["fused_attn.norm.weight"],
              "norm1.bias": sd["fused_attn.norm.bias"],
              "norm2.weight": sd["ffn.norm.weight"],
              "norm2.bias": sd["ffn.norm.bias"],
              "self_attn.out_proj.weight": sd["fused_attn.out_proj.weight"],
              "self_attn.out_proj.bias": sd["fused_attn.out_proj.bias"]}
    for i, n in enumerate("qkv"):
        mapped[f"self_attn.{n}_proj.weight"] = w[:, i * D:(i + 1) * D]
        mapped[f"self_attn.{n}_proj.bias"] = b[i * D:(i + 1) * D]
    plain.load_state_dict(mapped)
    x = torch.from_numpy(_a(28, 2, 6, D))
    _close(fused(x), plain(x).detach().numpy(), F32_TOL, "fused vs plain")


# ---------------------------------------------------------------------------
# the translation model: a 3-step Adam + NoamDecay trajectory
# ---------------------------------------------------------------------------
V, L = 24, 12


class _JaxTranslation(jnn.Layer):
    """``examples/seq2seq_translation.py``'s TranslationModel at a test
    size."""

    def __init__(self):
        super().__init__()
        self.src_emb = jnn.Embedding(V, D)
        self.tgt_emb = jnn.Embedding(V, D)
        self.pos = jnn.Embedding(L, D)
        self.core = jnn.Transformer(d_model=D, nhead=HEADS,
                                    num_encoder_layers=2,
                                    num_decoder_layers=2,
                                    dim_feedforward=FFN, dropout=0.0)
        self.head = jnn.Linear(D, V)

    def _embed(self, emb, ids):
        return emb(ids) + self.pos(jnp.arange(ids.shape[1]))[None]

    def forward(self, src, tgt_in):
        mask = jnn.Transformer.generate_square_subsequent_mask(
            tgt_in.shape[1])
        return self.head(self.core(self._embed(self.src_emb, src),
                                   self._embed(self.tgt_emb, tgt_in),
                                   tgt_mask=mask))


def test_translation_training_trajectory_matches_jax():
    data = WMT14(mode="train", dict_size=V, synthetic_size=4)
    src, tin, tnx = collate([data[i] for i in range(4)], L)
    jm = _JaxTranslation()
    tm = _port_of(jm, TranslationModel(V, L, D, HEADS, 2, 2, FFN,
                                       dropout=0.0, device="cpu"))
    jsched = jopt.lr.NoamDecay(d_model=D, warmup_steps=4)
    jo = jopt.Adam(learning_rate=jsched, beta1=0.9, beta2=0.98,
                   epsilon=1e-9)
    params = jm.trainable_variables()
    state = jo.init(params)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(src), jnp.asarray(tin))
        return jF.cross_entropy(logits, jnp.asarray(tnx),
                                label_smoothing=0.1)
    tsched = topt.lr.NoamDecay(d_model=D, warmup_steps=4)
    to = topt.Adam(learning_rate=tsched, beta1=0.9, beta2=0.98,
                   epsilon=1e-9, parameters=tm.named_parameters())
    batch = [torch.from_numpy(a) for a in (src, tin, tnx)]
    for step in range(3):
        loss, grads = jax.value_and_grad(jloss)(params)
        params, state = jo.apply_gradients(grads, params, state,
                                           lr=jsched.get_lr())
        jsched.step()
        got = seq2seq_step(tm, to, *batch, level="O0", scheduler=tsched,
                           label_smoothing=0.1)
        tol = F32_TOL if step == 0 else GRAD_TOL
        assert abs(got - float(loss)) <= tol * abs(float(loss)), (
            step, got, float(loss))
    assert tsched.last_epoch == 3


def test_beam_search_on_the_decoder_cache_equals_reencoding():
    # the cached cell gives the example's re-encoding cell's beams
    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
    pt.seed(0)
    jm = _JaxTranslation()
    tm = _port_of(jm, TranslationModel(V, L, D, HEADS, 2, 2, FFN,
                                       dropout=0.0, device="cpu")).eval()
    src = torch.from_numpy(np.random.RandomState(3).randint(3, V, (2, 7)))
    with torch.no_grad():
        runs = []
        for cell, inits in (
                (tm.reencode_cell(), {"src": src, "prefix": torch.zeros(
                    (2, 0), dtype=torch.int64)}),
                (tm.cached_cell(), {"memory": tm.encode(src),
                                    "cache": tm.empty_cache(2, src.float())})):
            dec = BeamSearchDecoder(cell, start_token=0, end_token=1,
                                    beam_size=3)
            runs.append(dynamic_decode(dec, inits=inits, max_step_num=8))
    assert torch.equal(runs[0][0], runs[1][0])
    _close(runs[1][1], runs[0][1].numpy(), 1e-5, "log-probs")


def test_translation_recipe_runs_an_epoch():
    from paddle_tpu_torch.convert import translation_recipe
    out = translation_recipe("cpu", epochs=1)
    assert len(out["losses"]) == 2048 // 64
    assert out["loss_last"] < out["loss_first"]
    assert out["items"] == 8 and 0 <= out["exact"] <= 8
