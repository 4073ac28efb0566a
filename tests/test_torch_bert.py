"""Port parity for the BERT part of slice 7, on the CPU: the same numpy
weights and data through the JAX package's ``paddle_tpu/models/bert.py``
and the port's ``models/bert.py``.

- ``nn.functional.tanh`` and ``cross_entropy`` (hard labels with ignored
  ones, each reduction, a label of the logits' rank, soft labels, label
  smoothing, the O1 cast) against the JAX functions;
- ``BertForPretraining`` at ``bert_tiny``: MLM and NSP logits, the MLM +
  NSP loss and every gradient in float32, on the non-causal flash route
  (the JAX kernels in Pallas interpret mode, the port's plain flash
  version) and on the SDPA route with ``attention_mask`` and
  ``token_type_ids``; a 3-step AdamW loss trajectory and the bf16 O1 loss;
- ``BertForSequenceClassification``: loss, logits and every gradient;
- the additive mask's bf16 constant, and the bench workload's data.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.bert import BertForPretraining as JaxPretraining
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxClassifier
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import UnavailableError
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import (BERT_MASK_RATE,
                                      bert_pretraining_workload,
                                      load_jax_state)
from paddle_tpu_torch.models import (BertForPretraining,
                                     BertForSequenceClassification,
                                     bert_base, bert_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.training import train_step

B, S, V = 2, 128, 1024
# float32 on both sides with exact products (the suite pins JAX matmuls to
# "highest"): logits, losses and gradients differ by summation order only
# (~3e-6 of each tensor's range through two post-LN layers); 1e-4 of the
# range plus 1e-7 is the bound, far below what a missing mask, pooler,
# bias or loss term moves
F32_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_mesh():
    # JAX model parity runs serially; earlier files may leave a mesh
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


def _close(got, ref, what, tol=F32_TOL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * float(np.abs(ref).max()) + 1e-7
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# nn.functional: tanh and cross_entropy
# ---------------------------------------------------------------------------
def test_tanh_matches_jax():
    x = np.random.RandomState(0).randn(5, 7).astype(np.float32) * 3
    _close(F.tanh(_t(x)), JF.tanh(jnp.asarray(x)), "tanh", tol=1e-6)


CE_CASES = {
    "mean": dict(reduction="mean"),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "ignored": dict(reduction="mean", ignore=True),
    "all-ignored": dict(reduction="mean", all_ignored=True),
    "rank-label": dict(reduction="mean", keepdim=True),
    "smoothing": dict(reduction="mean", label_smoothing=0.1, ignore=True),
    "soft": dict(reduction="mean", soft=True),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax(case):
    kw = dict(CE_CASES[case])
    r = np.random.RandomState(1)
    logits = (2 * r.randn(6, 5)).astype(np.float32)
    label = r.randint(0, 5, (6,)).astype(np.int32)
    if kw.pop("ignore", False):
        label[[1, 4]] = -100
    if kw.pop("all_ignored", False):
        label[:] = -100
    if kw.pop("keepdim", False):
        label = label[:, None]
    soft = kw.pop("soft", False)
    if soft:
        label = np.abs(r.randn(6, 5)).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                           soft_label=soft, **kw)
    got = F.cross_entropy(_t(logits), _t(label), soft_label=soft, **kw)
    _close(got, ref, f"cross_entropy {case}", tol=1e-6)


def test_cross_entropy_refuses_another_axis():
    with pytest.raises(Exception, match="not the last axis"):
        F.cross_entropy(torch.zeros(5, 6), torch.zeros(6, dtype=torch.long),
                        axis=0)


def test_cross_entropy_casts_up_under_o1():
    r = np.random.RandomState(2)
    logits = r.randn(4, 3).astype(np.float32)
    label = r.randint(0, 3, (4,)).astype(np.int32)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        ref = JF.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                               jnp.asarray(label))
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        got = F.cross_entropy(_t(logits).to(torch.bfloat16), _t(label))
    assert got.dtype == torch.float32 and str(ref.dtype) == "float32"
    _close(got, ref, "O1 cross_entropy", tol=1e-6)


def test_mask_constant_is_jax_bf16_value():
    # (1 - mask) * -1e9 in the activation dtype: bf16 rounds -1e9 as JAX
    ref = float(jnp.asarray(-1e9, jnp.bfloat16))
    got = float(torch.tensor(-1e9, dtype=torch.bfloat16))
    assert got == ref == -998244352.0


# ---------------------------------------------------------------------------
# BertForPretraining / BertForSequenceClassification
# ---------------------------------------------------------------------------
def _state(jm, seed):
    r = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jm.state_dict().items()):
        a = r.randn(*v.shape).astype(np.float32)
        gain = k.endswith(("_ln.weight", "layer_norm.weight"))
        state[k] = (1.0 + 0.1 * a) if gain else 0.1 * a
    return state


def _pair(jax_cls, torch_cls, pallas, dtype="float32", seed=0, **ckw):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0, dtype=dtype,
              use_pallas_attention=pallas)
    jm = jax_cls(jax_bert_tiny(**kw), **ckw)
    jm.train()
    state = _state(jm, seed)
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tm = load_jax_state(torch_cls(bert_tiny(**kw), device="cpu", **ckw),
                        state)
    tm.train()
    return jm, tm


def _data(seed, with_mask):
    r = np.random.RandomState(seed)
    ids = r.randint(0, V, (B, S)).astype(np.int32)
    mlm = np.where(r.rand(B, S) < 0.15, r.randint(0, V, (B, S)),
                   -100).astype(np.int32)
    nsp = r.randint(0, 2, (B,)).astype(np.int32)
    extra = {}
    if with_mask:
        am = np.ones((B, S), np.int32)
        am[1, 90:] = 0                    # a padded row
        extra = {"token_type_ids": r.randint(0, 2, (B, S)).astype(np.int32),
                 "attention_mask": am}
    return ids, mlm, nsp, extra


ROUTES = {
    # (use_pallas_attention, attention_mask and token types given)
    "flash": (True, False),                 # the non-causal flash route
    "sdpa": (False, False),
    "sdpa-mask": (False, True),
    "flash-config-mask": (True, True),      # a mask sends it to SDPA
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pretraining_logits_loss_and_every_grad_match_jax(route):
    pallas, with_mask = ROUTES[route]
    jm, tm = _pair(JaxPretraining, BertForPretraining, pallas)
    ids, mlm, nsp, extra = _data(1, with_mask)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: _t(v) for k, v in extra.items()}
    jlog, jnsp = jm(jnp.asarray(ids), **jx)
    with torch.no_grad():
        tlog, tnsp = tm(_t(ids), **tx)
    _close(tlog, jlog, "mlm logits")
    _close(tnsp, jnsp, "nsp logits")

    def loss_fn(p):
        loss, _ = jm.apply(p, jnp.asarray(ids), mlm_labels=jnp.asarray(mlm),
                           nsp_labels=jnp.asarray(nsp), **jx)
        return loss
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jm.state_dict())
    tl, tlogits = tm(_t(ids), mlm_labels=_t(mlm), nsp_labels=_t(nsp), **tx)
    assert tlogits.shape == (B, S, V)
    tl.backward()
    _close(tl.detach(), jl, "loss")
    grads = dict(tm.named_parameters())
    assert set(grads) == set(jg)
    for k in sorted(jg):
        _close(grads[k].grad, jg[k], f"grad {k}")


def test_mlm_loss_alone_and_with_no_masked_position():
    jm, tm = _pair(JaxPretraining, BertForPretraining, pallas=False, seed=3)
    ids, mlm, _, _ = _data(2, False)
    none = np.full_like(mlm, -100)
    for labels in (mlm, none):
        jl, _ = jm(jnp.asarray(ids), mlm_labels=jnp.asarray(labels))
        with torch.no_grad():
            tl, _ = tm(_t(ids), mlm_labels=_t(labels))
        _close(tl, jl, "mlm-only loss")
    assert float(tl) == 0.0               # max(sum(valid), 1) keeps it finite


def test_sequence_classification_matches_jax():
    jm, tm = _pair(JaxClassifier, BertForSequenceClassification, True,
                   seed=5, num_classes=3)
    ids, _, _, extra = _data(4, True)
    labels = np.array([2, 0], np.int32)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    with torch.no_grad():
        _close(tm(_t(ids), **{k: _t(v) for k, v in extra.items()}),
               jm(jnp.asarray(ids), **jx), "logits")

    def loss_fn(p):
        loss, _ = jm.apply(p, jnp.asarray(ids), labels=jnp.asarray(labels),
                           **jx)
        return loss
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jm.state_dict())
    tl, logits = tm(_t(ids), labels=_t(labels),
                    **{k: _t(v) for k, v in extra.items()})
    assert logits.shape == (B, 3)
    tl.backward()
    _close(tl.detach(), jl, "loss")
    grads = dict(tm.named_parameters())
    assert set(grads) == set(jg)
    for k in sorted(jg):
        _close(grads[k].grad, jg[k], f"grad {k}")


def test_pretraining_adamw_trajectory_matches_jax():
    jm, tm = _pair(JaxPretraining, BertForPretraining, True, seed=6)
    ids, mlm, nsp, _ = _data(7, False)
    jo = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01)

    def loss_fn(p):
        loss, _ = jm.apply(p, jnp.asarray(ids), mlm_labels=jnp.asarray(mlm),
                           nsp_labels=jnp.asarray(nsp))
        return loss

    @jax.jit
    def jstep(p, st):
        loss, g = jax.value_and_grad(loss_fn)(p)
        p, st = jo.apply_gradients(g, p, st)
        return loss, p, st

    p = jm.state_dict()
    st = jo.init(p)
    to = AdamW(learning_rate=1e-3, weight_decay=0.01,
               parameters=tm.parameters())
    jl, tl = [], []
    for _ in range(3):
        loss, p, st = jstep(p, st)
        jl.append(float(loss))
        to.zero_grad(set_to_none=True)
        loss_t, _ = tm(_t(ids), mlm_labels=_t(mlm), nsp_labels=_t(nsp))
        loss_t.backward()
        to.step()
        tl.append(float(loss_t.detach()))
    # the losses, not every parameter: Adam moves rounding-noise gradients
    # by +-lr in either package (see test_torch_training.py)
    _close(tl, jl, "loss trajectory")
    assert tl[2] < tl[0]


def test_pretraining_o1_bf16_loss_matches_jax():
    # the bench row's configuration at bert_tiny: bf16 activations, the
    # flash route, bf16 O1
    jm, tm = _pair(JaxPretraining, BertForPretraining, True,
                   dtype="bfloat16", seed=8)
    ids, mlm, nsp, _ = _data(9, False)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jl, _ = jm(jnp.asarray(ids), mlm_labels=jnp.asarray(mlm),
                   nsp_labels=jnp.asarray(nsp))
    with torch.no_grad(), tamp.auto_cast(level="O1", dtype="bfloat16"):
        tl, logits = tm(_t(ids), mlm_labels=_t(mlm), nsp_labels=_t(nsp))
    assert logits.dtype == torch.bfloat16
    # bf16 activations and products on both sides, rounded at the same ops
    # but summed in other orders: single logits land a bf16 unit apart,
    # and the mean over the masked tokens' losses plus NSP moves far less;
    # 2^-8 of the loss bounds it (the masked positions are ~40 tokens,
    # fewer than the dense GPT test's 256)
    assert abs(float(tl) - float(jl)) <= 2.0 ** -8 * abs(float(jl))


# ---------------------------------------------------------------------------
# the workload and the configuration
# ---------------------------------------------------------------------------
def test_workload_draws_the_bench_data_and_trains():
    cfg = bert_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                    use_pallas_attention=True)
    model, opt, ids, inputs = bert_pretraining_workload("cpu", cfg, batch=2,
                                                        seq_len=128)
    # bench.py _bench_bert_base's draws, in its order
    rng = np.random.RandomState(0)
    want_ids = rng.randint(0, cfg.vocab_size, (2, 128))
    mask = rng.rand(2, 128) < BERT_MASK_RATE
    want_mlm = np.where(mask, rng.randint(0, cfg.vocab_size, (2, 128)), -100)
    want_nsp = rng.randint(0, 2, (2,))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(inputs["mlm_labels"].numpy(), want_mlm)
    np.testing.assert_array_equal(inputs["nsp_labels"].numpy(), want_nsp)
    # random_state: LayerNorm gains near 1, the rest 0.02-scaled
    gain = model.bert.encoder[0].attn_ln.weight.detach()
    assert abs(float(gain.mean()) - 1.0) < 0.05
    losses = [float(train_step(model, opt, ids, **inputs)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]


def test_bert_base_builds_at_full_width():
    m = BertForPretraining(bert_base(num_layers=1), device="cpu")
    assert tuple(m.bert.embeddings.word_embeddings.weight.shape) == \
        (30528, 768)
    assert tuple(m.bert.encoder[0].fc_in.weight.shape) == (768, 3072)
    assert tuple(m.mlm_bias.shape) == (30528,)


def test_bert_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = bert_tiny()
    with pytest.raises(UnavailableError, match="no CUDA device"):
        BertForPretraining(tiny)
    with pytest.raises(UnavailableError, match="no CUDA device"):
        BertForSequenceClassification(tiny, device="cuda")
    with pytest.raises(UnavailableError, match="no CUDA device"):
        bert_pretraining_workload(None, tiny, batch=1, seq_len=8)
