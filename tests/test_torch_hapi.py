"""Port parity of the training front end (``paddle_tpu_torch/hapi``,
``io``, ``metric``, ``framework/io.py``) on the CPU, against the JAX
package: the same seeded numpy data and the same weights go through
both packages' ``Model`` and data pipeline.

- metrics: ``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and
  ``accuracy`` give the JAX values exactly (both accumulate in numpy);
- samplers: the index order under one ``np.random.seed`` is the JAX
  order exactly (random, weighted, batched, distributed, ``random_split``);
  collation and worker-process loading give the same batches in order;
- callbacks fire in the JAX order; ``fit`` / ``evaluate`` / ``predict``
  of an MLP classifier with ``Accuracy`` and of ``gpt_tiny`` (its fused
  LM loss: inputs ``(ids, labels)``) give the JAX histories, losses,
  metrics and outputs within ``LOSS_RTOL``; the ``LRScheduler`` callback's
  applied learning rates, ``EarlyStopping``'s stop epoch and
  ``nonfinite_skip_budget``'s skips match;
- ``Model.save`` / ``load`` files (``.pdparams`` / ``.pdopt``, a bfloat16
  leaf included) load across packages both ways, bits unchanged.

Tolerances: float32 on both sides; losses, metrics and outputs within
``LOSS_RTOL`` = 1e-5 relative (2e-5 for gpt_tiny, whose two layers and
1024-way softmax sum in another order) and 1e-6 absolute; indices,
counts, callback orders and saved bits exact.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import framework as jframework
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu.hapi import (Callback as JCallback, EarlyStopping as JES,
                             Model as JModel)
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import io as tframework_io
from paddle_tpu_torch.framework.errors import UnimplementedError
from paddle_tpu_torch.hapi import (Callback as TCallback,
                                   EarlyStopping as TES, Model as TModel,
                                   flops as tflops, summary as tsummary)
from paddle_tpu_torch.nn import functional as TF

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


def _close(got, ref, rtol=LOSS_RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=LOSS_ATOL)


# -- metrics ----------------------------------------------------------------
def _metric_inputs():
    r = np.random.RandomState(0)
    logits = r.randn(64, 5).astype(np.float32)
    labels = r.randint(0, 5, (64, 1)).astype(np.int64)
    probs = r.rand(64).astype(np.float32)
    binary = r.randint(0, 2, 64).astype(np.int64)
    return logits, labels, probs, binary


@pytest.mark.parametrize("name", ["accuracy_top2", "precision", "recall",
                                  "auc", "accuracy_fn"])
def test_metric_matches_jax(name):
    logits, labels, probs, binary = _metric_inputs()
    out = []
    for M in (jmetric, tmetric):
        if name == "accuracy_fn":
            out.append([M.accuracy(logits, labels, k=k) for k in (1, 3)])
            continue
        m = {"accuracy_top2": lambda: M.Accuracy(topk=(1, 2)),
             "precision": M.Precision, "recall": M.Recall,
             "auc": lambda: M.Auc(num_thresholds=255)}[name]()
        vals = []
        for lo in (0, 32):
            if name == "accuracy_top2":
                m.update(m.compute(logits[lo:lo + 32], labels[lo:lo + 32]))
            else:
                m.update(probs[lo:lo + 32], binary[lo:lo + 32])
            vals.append(m.accumulate())
        vals.append(m.name())
        m.reset()
        out.append(vals)
    assert out[1] == out[0]
    # the port's metrics take tensors too
    if name == "precision":
        m = tmetric.Precision()
        m.update(torch.from_numpy(probs), torch.from_numpy(binary))
        assert m.accumulate() == out[0][1]


# -- samplers, collation, loading -----------------------------------------
def _sampler_orders(io):
    ds = io.TensorDataset([np.arange(23, dtype=np.float32)])
    out = {}
    np.random.seed(7)
    out["random"] = list(io.RandomSampler(ds))
    out["replacement"] = list(io.RandomSampler(ds, replacement=True,
                                               num_samples=9))
    out["weighted"] = list(io.WeightedRandomSampler(
        np.arange(1, 24, dtype=np.float64), num_samples=12))
    out["batched"] = list(io.BatchSampler(dataset=ds, shuffle=True,
                                          batch_size=5, drop_last=True))
    out["split"] = [s.indices for s in io.random_split(ds, [10, 13])]
    dist = io.DistributedBatchSampler(ds, batch_size=4, num_replicas=3,
                                      rank=1, shuffle=True)
    dist.set_epoch(3)
    out["distributed"] = (list(dist), len(dist))
    return out


def test_sampler_order_matches_jax():
    assert _sampler_orders(tio) == _sampler_orders(jio)
    # without a torch.distributed group the port's defaults are rank 0 of
    # 1 (the JAX sampler reads its device mesh, 8 virtual CPUs here)
    ds = tio.TensorDataset([np.arange(23, dtype=np.float32)])
    single = tio.DistributedBatchSampler(ds, batch_size=6, drop_last=True)
    assert (single.nranks, single.local_rank, len(single)) == (1, 0, 3)
    assert list(single)[-1] == list(range(12, 18))


def _as_np(batch):
    if isinstance(batch, (tuple, list)):
        return [_as_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _as_np(v) for k, v in batch.items()}
    return np.asarray(batch.cpu() if torch.is_tensor(batch) else batch)


class _Squares:
    """A map-style dataset of dict / int / float samples."""

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32), "i": i, "f": i * 0.5}

    def __len__(self):
        return 10


def _loads(io, places):
    kw = {"places": places} if places else {}
    ds = io.TensorDataset([np.arange(30, dtype=np.float32).reshape(15, 2),
                           np.arange(15)])
    out = {"workers": [_as_np(b) for b in io.DataLoader(
        ds, batch_size=4, num_workers=2, **kw)]}
    out["dicts"] = [_as_np(b) for b in io.DataLoader(
        _Squares(), batch_size=3, drop_last=True, **kw)]
    out["compose"] = _as_np(io.default_collate_fn(
        [io.ComposeDataset([ds, ds])[i] for i in (1, 4)]))
    out["subset"] = [int(io.Subset(ds, [3, 9])[k][1]) for k in (0, 1)]

    class Stream(io.IterableDataset):
        def __iter__(self):
            info = io.get_worker_info()
            for i in range(7):
                yield np.asarray([i, info.num_workers], np.int64)

    out["iterable"] = [_as_np(b) for b in io.DataLoader(
        io.ChainDataset([Stream(), Stream()]), batch_size=4, **kw)]
    out["no_worker_info"] = io.get_worker_info()
    return out


def test_collation_and_worker_loading_match_jax():
    jax_out, port_out = _loads(jio, None), _loads(tio, "cpu")
    np.testing.assert_equal(port_out, jax_out)


def test_port_loader_contract():
    ds = tio.TensorDataset([np.zeros((4, 2))])
    # batches come out as tensors on the asked device, float64 as float32
    (batch,) = list(tio.DataLoader(ds, batch_size=4, places="cpu"))
    assert batch[0].dtype == torch.float32
    assert isinstance(list(tio.DataLoader(ds, batch_size=4,
                                          to_device=False))[0][0],
                      np.ndarray)
    if not torch.cuda.is_available():     # no card: "cuda" by default
        with pytest.raises(Exception):
            tio.DataLoader(ds)


def test_native_transport_flag_is_refused(monkeypatch):
    ds = tio.TensorDataset([np.zeros((4, 2), np.float32)])
    monkeypatch.setenv("FLAGS_dataloader_use_native", "1")
    with pytest.raises(UnimplementedError):
        tio.DataLoader(ds, num_workers=2, places="cpu")
    tio.DataLoader(ds, num_workers=2, places="cpu", use_shared_memory=False)
    tio.DataLoader(ds, num_workers=0, places="cpu")


# -- Model: an MLP classifier -----------------------------------------------
def _mlp_pair(metrics=True, opt="adam", lr=1e-2):
    """The same 4-8-2 tanh MLP in both packages, prepared alike."""
    pt.seed(0)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 2))
    tnet = torch.nn.Sequential(tnn.Linear(4, 8, device="cpu"),
                               torch.nn.Tanh(),
                               tnn.Linear(8, 2, device="cpu"))
    load_jax_state(tnet, {k: np.asarray(v)
                          for k, v in jnet.state_dict().items()})
    jopt = (pt.optimizer.Adam if opt == "adam" else pt.optimizer.SGD)(
        learning_rate=lr)
    topt_ = (topt.Adam if opt == "adam" else topt.SGD)(
        learning_rate=lr, parameters=tnet.named_parameters())
    jm, tm = JModel(jnet), TModel(tnet)
    jm.prepare(optimizer=jopt, loss=lambda out, y: jnp.mean(
        pt.nn.functional.cross_entropy(out, y)),
        metrics=jmetric.Accuracy() if metrics else None)
    tm.prepare(optimizer=topt_, loss=lambda out, y: TF.cross_entropy(out, y),
               metrics=tmetric.Accuracy() if metrics else None)
    return jm, tm


def _toy(io, n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    return io.TensorDataset([x, y])


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.events, self.logs = [], []

        def on_train_begin(self, logs=None):
            self.events.append("train_begin")

        def on_train_end(self, logs=None):
            self.events.append("train_end")

        def on_epoch_begin(self, epoch, logs=None):
            self.events.append(f"epoch_begin{epoch}")

        def on_epoch_end(self, epoch, logs=None):
            self.events.append(f"epoch_end{epoch}")
            self.logs.append(dict(logs))

        def on_train_batch_begin(self, step, logs=None):
            self.events.append(f"batch_begin{step}")

        def on_train_batch_end(self, step, logs=None):
            self.events.append(f"batch_end{step}")
            self.logs.append(dict(logs))

        def on_eval_begin(self, logs=None):
            self.events.append("eval_begin")

        def on_eval_end(self, logs=None):
            self.events.append("eval_end")
            self.logs.append(dict(logs))
    return Recorder()


def test_mlp_fit_evaluate_predict_match_jax():
    jm, tm = _mlp_pair()
    runs = []
    for m, io, cb in ((jm, jio, _recorder(JCallback)),
                      (tm, tio, _recorder(TCallback))):
        np.random.seed(11)
        hist = m.fit(_toy(io), eval_data=_toy(io, 16, 1), batch_size=8,
                     epochs=2, verbose=0, callbacks=[cb])
        res = m.evaluate(_toy(io, 16, 2), batch_size=8, verbose=0)
        pred = m.predict(_toy(io, 12, 3), batch_size=5)
        runs.append((hist, res, pred, cb))
    (jh, jr, jp, jcb), (th, tr, tp, tcb) = runs
    assert tcb.events == jcb.events
    assert tcb.events[:3] == ["train_begin", "epoch_begin0", "batch_begin0"]
    assert "eval_end" in tcb.events and tcb.events[-1] == "train_end"
    _close(th["loss"], jh["loss"])
    assert [sorted(x) for x in tcb.logs] == [sorted(x) for x in jcb.logs]
    for a, b in zip(tcb.logs, jcb.logs):
        _close([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])
    assert sorted(tr) == sorted(jr) == ["acc", "loss"]
    _close([tr["loss"], tr["acc"]], [jr["loss"], jr["acc"]])
    assert [p.shape for p in tp] == [p.shape for p in jp]
    for a, b in zip(tp, jp):
        _close(a, b)


def test_lr_scheduler_callback_matches_jax():
    """fit appends the by-step LRScheduler callback; the scheduled lr
    reaches the update (loss = sum(out), so each SGD step moves w by the
    applied lr)."""
    ws = []
    for P, io, cb, net_fn in (
            (pt.optimizer, jio, JCallback,
             lambda: jnn.Sequential(jnn.Linear(1, 1, bias_attr=False))),
            (topt, tio, TCallback, None)):
        pt.seed(0)
        jnet = jnn.Sequential(jnn.Linear(1, 1, bias_attr=False))
        if P is pt.optimizer:
            net, model = jnet, JModel(jnet)
            sched = P.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
            model.prepare(optimizer=P.SGD(learning_rate=sched),
                          loss=lambda out, y: jnp.sum(out))
            weight = lambda: float(net[0].weight.value[0, 0])  # noqa: E731
        else:
            net = torch.nn.Sequential(torch.nn.Linear(1, 1, bias=False))
            with torch.no_grad():
                net[0].weight.copy_(torch.from_numpy(
                    np.asarray(jnet[0].weight.value).T))
            model = TModel(net)
            sched = P.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
            model.prepare(optimizer=P.SGD(
                learning_rate=sched, parameters=net.named_parameters()),
                loss=lambda out, y: out.sum())
            weight = lambda: float(net[0].weight[0, 0].detach())  # noqa: E731
        w = [weight()]

        class Track(cb):
            def on_train_batch_end(self, step, logs=None):
                w.append(weight())

        x = np.ones((3, 1), np.float32)
        model.fit(io.TensorDataset([x, x.copy()]), batch_size=1, epochs=1,
                  shuffle=False, verbose=0, callbacks=[Track()])
        ws.append((np.diff(w).tolist(), sched.last_epoch))
    (jd, je), (td, te) = ws
    _close(td, jd)
    _close(td, [-0.1, -0.05, -0.025])
    assert te == je == 3


def test_early_stopping_and_checkpoint_match_jax(tmp_path):
    jm, tm = _mlp_pair(metrics=False)
    stops = []
    for m, io, es in ((jm, jio, JES), (tm, tio, TES)):
        cb = es(monitor="loss", patience=0, baseline=0.0, mode="min")
        np.random.seed(3)
        m.fit(_toy(io), batch_size=16, epochs=10, verbose=0, callbacks=[cb],
              save_dir=str(tmp_path / io.__name__.split(".")[0]))
        stops.append((cb.stopped_epoch, m.stop_training, sorted(
            os.listdir(tmp_path / io.__name__.split(".")[0]))))
    assert stops[1] == stops[0]
    assert stops[1][0] == 0 and stops[1][2] == [
        "epoch_0.pdopt", "epoch_0.pdparams", "final.pdopt",
        "final.pdparams"]


def test_nonfinite_skip_budget_matches_jax():
    outs = []
    for io in (jio, tio):
        jm, tm = _mlp_pair(metrics=False, opt="sgd", lr=0.1)
        m = jm if io is jio else tm
        m.prepare(optimizer=m._optimizer, loss=m._loss,
                  nonfinite_skip_budget=2)
        rng = np.random.RandomState(4)
        x = rng.randn(6, 4).astype(np.float32)
        # nan inputs, not inf: XLA's CPU matmul at "highest" precision
        # splits an inf operand into parts and returns nan where torch
        # returns +-inf (and a finite tanh after it)
        x[2, 1] = np.nan
        x[4, 0] = np.nan
        y = (np.arange(6) % 2).astype(np.int64)
        logs = []
        cb = (JCallback if io is jio else TCallback)()
        cb.on_train_batch_end = lambda step, lg=None: logs.append(
            lg["nonfinite_skipped"])
        hist = m.fit(io.TensorDataset([x, y]), batch_size=1, shuffle=False,
                     verbose=0, callbacks=[cb])
        x[5, 2] = np.nan
        with pytest.raises(FloatingPointError):
            m.fit(io.TensorDataset([x, y]), batch_size=1, shuffle=False,
                  verbose=0)
        outs.append((hist["loss"], logs, m._nonfinite_skipped))
    (jl, jlogs, jn), (tl, tlogs, tn) = outs
    assert np.isnan(tl).tolist() == np.isnan(jl).tolist() == \
        [False, False, True, False, True, False]
    _close(np.nan_to_num(tl), np.nan_to_num(jl))
    assert tlogs == jlogs == [0, 0, 1, 1, 2, 2] and tn == jn == 3


# -- Model: gpt_tiny with its fused LM loss ------------------------------------
def _gpt_pair():
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    import paddle_tpu.distributed as jdist
    jdist.set_hybrid_communicate_group(None)
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jnet = JGPT(jgpt_tiny(**kw))
    r = np.random.RandomState(0)
    state = {k: ((1.0 + 0.1 * r.randn(*v.shape)) if k.endswith(
        ("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        else 0.1 * r.randn(*v.shape)).astype(np.float32)
        for k, v in sorted(jnet.state_dict().items())}
    jnet.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tnet = load_jax_state(GPTForCausalLM(gpt_tiny(**kw), device="cpu"),
                          state)
    jm, tm = JModel(jnet), TModel(tnet)
    jm.prepare(optimizer=pt.optimizer.AdamW(learning_rate=1e-3,
                                            weight_decay=0.01),
               loss=lambda out, y: out[0])
    tm.prepare(optimizer=topt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                    parameters=tnet.named_parameters()),
               loss=lambda out, y: out[0])
    return jm, tm


def test_gpt_tiny_fit_evaluate_predict_match_jax():
    """The network's inputs are ``(ids, labels)`` and the loss is the
    model's own fused LM loss, as the card's phase c2e runs GPT-125M."""
    jm, tm = _gpt_pair()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (6, 128)).astype(np.int64)
    runs = []
    for m, io in ((jm, jio), (tm, tio)):
        ds = io.TensorDataset([ids, ids, ids])
        hist = m.fit(ds, batch_size=2, shuffle=False, verbose=0)
        res = m.evaluate(ds, batch_size=3, verbose=0)
        logits = m.predict(io.TensorDataset([ids[:2], ids[:2]]),
                           batch_size=2)
        runs.append((hist["loss"], res["loss"], logits[0]))
    (jl, je, jp), (tl, te, tp) = runs
    _close(tl, jl, rtol=2e-5)
    assert tl[-1] < tl[0]
    _close(te, je, rtol=2e-5)
    assert tp.shape == jp.shape == (2, 128, 1024)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-4)


# -- save / load across packages ------------------------------------------------
def test_save_load_across_packages_both_ways(tmp_path):
    """``.pdparams`` / ``.pdopt`` in the JAX pickle format: each package
    loads the other's files, a bfloat16 parameter (O2) included, with
    every bit and every Adam slot unchanged."""
    jm, tm = _mlp_pair(metrics=False)
    pt.amp.decorate(jm.network, level="O2")
    tamp.decorate(tm.network, level="O2")
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    y = np.asarray([0, 1, 1, 0], np.int64)
    jm.train_batch([x], y)
    tm.train_batch([x], y)
    jm.save(str(tmp_path / "jax"))
    tm.save(str(tmp_path / "torch"))

    def bits(v):
        if torch.is_tensor(v):
            v = v.detach()
            return (v.view(torch.int16).numpy() if v.dtype == torch.bfloat16
                    else v.numpy())
        v = np.asarray(v)
        return v.view(np.int16) if v.dtype.name == "bfloat16" else v

    # JAX files into the port
    _jm2, tm2 = _mlp_pair(metrics=False)
    tamp.decorate(tm2.network, level="O2")
    tm2.train_batch([x], y)              # a state to be overwritten
    tm2.load(str(tmp_path / "jax"))
    for k, v in jm.network.state_dict().items():
        assert tm2.network.state_dict()[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(tm2.network.state_dict()[k]),
                                      bits(v))
    ost = tm2._optimizer.state_dict()["state"]
    assert int(ost["step"]) == int(jm._opt_state["step"])
    for name, slots in jm._opt_state["slots"].items():
        for k, v in slots.items():
            np.testing.assert_array_equal(ost["slots"][name][k].numpy(),
                                          np.asarray(v))
        np.testing.assert_array_equal(ost["master"][name].numpy(),
                                      np.asarray(jm._opt_state["master"][
                                          name]))
    # port files into the JAX package
    jm2, _tm2 = _mlp_pair(metrics=False)
    pt.amp.decorate(jm2.network, level="O2")
    jm2.load(str(tmp_path / "torch"))
    for k, v in tm.network.state_dict().items():
        got = jm2.network.state_dict()[k]
        assert got.dtype == jnp.bfloat16
        np.testing.assert_array_equal(bits(got), bits(v))
    raw = jframework.load(str(tmp_path / "torch.pdopt"))
    tstate = tm._optimizer.state_dict()["state"]
    assert int(raw["step"]) == int(tstate["step"])
    for name, slots in tstate["slots"].items():
        for k, v in slots.items():
            np.testing.assert_array_equal(np.asarray(raw["slots"][name][k]),
                                          v.numpy())
    # bfloat16 leaves read back as numpy float32 widenings, as in JAX
    np_state = tframework_io.load(str(tmp_path / "jax.pdparams"),
                                  return_numpy=True)
    assert all(v.dtype == np.float32 for v in np_state.values())


def test_flops_and_summary():
    _jm, tm = _mlp_pair(metrics=False)
    # two matmuls, 2 operations a multiply-add, batch 3
    assert tflops(tm.network, [3, 4]) == 2 * 3 * (4 * 8 + 8 * 2)
    assert tsummary(tm.network) == {"total_params": 58,
                                    "trainable_params": 58}
    assert tm.summary()["total_params"] == _jm.summary()["total_params"]


def test_port_unpickler_refuses_other_jax_classes(tmp_path):
    """The port reads the JAX bfloat16 marker by name and no other class
    of the JAX package (it never imports it to unpickle)."""
    import pickle
    path = str(tmp_path / "sched.pdparams")
    with open(path, "wb") as f:
        pickle.dump({"lr": pt.optimizer.lr.StepDecay(0.1, 2)}, f)
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        tframework_io.load(path)
