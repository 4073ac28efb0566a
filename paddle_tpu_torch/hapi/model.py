"""High-level Model API: the port of ``paddle_tpu/hapi/model.py``
(reference: python/paddle/hapi/model.py - Model:907, fit:1045, evaluate,
predict, save / load; a Keras-style train loop).

The JAX ``prepare()`` builds one jitted step; here a step is eager
PyTorch: zero the gradients, the network's forward under
``amp.auto_cast`` at the prepared level, the loss outside it, backward,
then the optimizer's ``step()``.  A step reads the card back once: the
loss, with the gradients' global norm beside it when a run supervisor is
attached (one host copy of both).

With a supervisor, or a ``nonfinite_skip_budget``, the decision to apply
an update is made on the host from that readback *before*
``optimizer.step()``: a skipped batch leaves parameters, slots and the
step count as they were.  The JAX step computes the update in the jitted
program and drops it; the outcome is the same state.  A step's
learning-rate override (the guard's back-off) is the optimizer's
``param_groups[0]["lr"]`` for that step only.

The state the supervisor checkpoints and rolls back is
``{"params": network.state_dict(), "opt": <the optimizer's state keyed
as the JAX state>, "rng": framework.random.get_state()}``; a state
without ``opt`` or ``rng`` (written by the JAX package) loads too.
"""
from __future__ import annotations

import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import amp as amp_mod
from ..convert import _to_tensor, optimizer_state_to_jax
from ..framework import io as fw_io
from ..framework import random as fw_random
from ..framework.debug import check_nan_inf_enabled
from ..framework.errors import UnimplementedError, enforce
from ..framework.log import vlog
from ..io import DataLoader
from ..metric import Metric, _host
from ..observability import memory as obs_memory
from ..observability.mfu import (flops_per_token, mfu,
                                 param_count, peak_flops_per_sec)
from ..observability.registry import get_registry
from ..observability.tracing import span
from ..utils.tree import tree_map

__all__ = ["Model"]


def _tuplify(x):
    return x if isinstance(x, (tuple, list)) else (x,)


def _clone(tree, device=None):
    """A copy of a state tree: tensors cloned (onto ``device`` when
    given), everything else as it is."""
    def copy(x):
        if not torch.is_tensor(x):
            return x
        x = x.detach()
        return x.to(device, copy=True) if device is not None else x.clone()
    return tree_map(copy, tree)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._loss = None
        self._optimizer = None
        self._metrics: List[Metric] = []
        self._prepared = False
        self._amp_level: Optional[str] = None
        self._amp_dtype = "bfloat16"
        self._nonfinite_budget: Optional[int] = None
        self._nonfinite_skipped = 0
        self._supervisor = None  # set by RunSupervisor.attach / fit()
        self.stop_training = False
        # telemetry: the last train_batch's dispatch / readback split and
        # the cached MFU accounting inputs
        self._last_batch_timing: Optional[dict] = None
        self._obs_n_params: Optional[int] = None
        self._obs_flops_token: Optional[float] = None
        self._obs_seq_len: Optional[int] = None
        self._obs_peak: Optional[float] = None
        self._obs_step = 0

    # -- setup ------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, nonfinite_skip_budget: Optional[int] = None):
        """``amp_configs``: an amp level (``"O1"`` / ``"O2"``; None or
        ``"O0"`` for none) or a dict with ``"level"`` and optionally
        ``"dtype"``; the forward then runs under ``amp.auto_cast``.

        ``nonfinite_skip_budget``: when set, a train batch whose loss
        comes back nan / inf is skipped (no parameter or optimizer
        update) up to that many times, counted in ``nonfinite_skipped``
        (in fit()'s batch logs); one more raises ``FloatingPointError``.
        None (default) applies the update whatever the loss."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = list(_tuplify(metrics)) if metrics is not None else []
        self._nonfinite_budget = (None if nonfinite_skip_budget is None
                                  else int(nonfinite_skip_budget))
        self._nonfinite_skipped = 0
        if isinstance(amp_configs, dict):
            level = amp_configs.get("level")
            self._amp_dtype = amp_configs.get("dtype", "bfloat16")
        else:
            level = amp_configs
        enforce(level in (None, "O0", "O1", "O2"),
                f"amp level must be O0, O1 or O2, got {level!r}")
        self._amp_level = None if level in (None, "O0") else level
        self._prepared = True

    # -- per-batch --------------------------------------------------------
    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        if p is not None:
            return p.device
        from ..device import resolve_device
        return resolve_device(None)

    @staticmethod
    def _as_tensor(x, device) -> torch.Tensor:
        """A batch field on ``device`` (float64 as float32, as JAX
        without x64)."""
        if not torch.is_tensor(x):
            a = np.asarray(x)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            x = _to_tensor(a, "cpu")
        return x.to(device, non_blocking=True)

    def _drop_grads(self) -> None:
        for p in self.network.parameters():
            p.grad = None

    def _forward_backward(self, data, with_norm: bool):
        """Forward (under auto_cast at the prepared level), the loss, and
        backward; with ``with_norm`` also the gradients' global norm as a
        float32 device scalar (float32 accumulation, so a bf16 overflow
        cannot hide in the statistic)."""
        *inputs, label = data
        self._drop_grads()
        if self._amp_level:
            with amp_mod.auto_cast(level=self._amp_level,
                                   dtype=self._amp_dtype):
                out = self.network(*inputs)
        else:
            out = self.network(*inputs)
        loss = self._loss(out, label)
        loss.backward()
        gnorm = None
        if with_norm:
            grads = [p.grad if p.grad.dtype == torch.float32
                     else p.grad.float()
                     for p in self.network.parameters() if p.grad is not None]
            gnorm = (torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))) if grads
                else torch.zeros((), device=loss.device))
        return loss, out, gnorm

    def _optimizer_step(self, lr_override: Optional[float]) -> None:
        """``optimizer.step()``, with ``lr_override`` as the parameter
        group's ``lr`` for this step only (the port's optimizers read
        it)."""
        opt = self._optimizer
        if lr_override is None:
            opt.step()
            return
        group = opt.param_groups[0]
        group["lr"] = lr_override
        try:
            opt.step()
        finally:
            del group["lr"]

    def _check_finite(self, loss: float) -> None:
        """``FLAGS_check_nan_inf``: raise naming every non-finite leaf of
        the loss and the gradients."""
        bad = [] if math.isfinite(loss) else ["loss"]
        for name, p in self.network.named_parameters():
            if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
                bad.append(f"grads/{name}")
        if bad:
            raise FloatingPointError(
                "nan/inf detected in train_batch: "
                + ", ".join(sorted(bad)[:10])
                + (f" (+{len(bad) - 10} more)" if len(bad) > 10 else ""))

    def _metric_values(self, out, label) -> list:
        values = []
        for m in self._metrics:
            r = m.compute(_host(out), _host(label))
            m.update(*(r if isinstance(r, tuple) else (r,)))
            values.append(m.accumulate())
        return values

    def train_batch(self, inputs, labels=None):
        enforce(self._prepared, "call prepare() first")
        self.network.train()
        dev = self._device()
        data = [self._as_tensor(x, dev) for x in
                (*_tuplify(inputs), *_tuplify(labels))]
        sup = self._supervisor
        lr_override = None
        if sup is not None and sup.guard.lr_scale != 1.0:
            # the divergence guard's LOWER_LR escalation: a sticky back-off
            # on top of whatever schedule is active
            lr_override = float(np.float32(
                self._optimizer.get_lr() * sup.guard.lr_scale))
        ig = sup.integrity if sup is not None else None
        if ig is not None and ig.enabled:
            if ig.replay_fn is None:
                ig.replay_fn = self._integrity_replay
            if ig.due(sup.gstep + 1):
                # the replay audit's stash: a clone of this step's
                # pre-state, taken only before a step that is checked
                ig.stash_replay(sup.gstep + 1, self._supervised_state(),
                                (data, lr_override))
        decide = sup is not None or self._nonfinite_budget is not None
        try:
            if sup is not None:
                # the armed region covers the step and the readback that
                # waits for it: where a hung card blocks
                with sup.watchdog.armed("train_batch"):
                    with span("dispatch") as sp_d:
                        loss, out, gnorm = self._forward_backward(
                            data, with_norm=True)
                    with span("readback") as sp_r:
                        loss_raw, gnorm_v = torch.stack(
                            [loss.detach().float().reshape(()),
                             gnorm]).tolist()
                        loss_v = sup.filter_loss(loss_raw)
                self._last_batch_timing = {"dispatch_s": sp_d.elapsed,
                                           "readback_s": sp_r.elapsed}
                action = sup.guard_step(loss_v, gnorm_v,
                                        amp_active=bool(self._amp_level))
                from ..supervisor.guard import GuardAction
                if action != GuardAction.OK:
                    # SKIP / LOWER_LR / ROLLBACK all leave this batch's
                    # update unapplied; ROLLBACK is latched on the
                    # supervisor for the driving loop to execute
                    self._drop_grads()
                    return loss_v, [m.accumulate() for m in self._metrics]
            else:
                with span("dispatch") as sp_d:
                    loss, out, _ = self._forward_backward(data,
                                                          with_norm=False)
                    if not decide:
                        self._optimizer_step(lr_override)
                with span("readback") as sp_r:
                    loss_v = float(loss.detach())
                self._last_batch_timing = {"dispatch_s": sp_d.elapsed,
                                           "readback_s": sp_r.elapsed}
        except Exception as e:
            # an allocator OOM kills the step and the evidence: emit the
            # last-known watermark table first
            if obs_memory.is_oom_error(e):
                obs_memory.oom_postmortem(error=e, step=(
                    sup.gstep if sup is not None else self._obs_step))
            raise
        if check_nan_inf_enabled():
            self._check_finite(loss_v)
        if self._nonfinite_budget is not None and not math.isfinite(loss_v):
            # skip-step: one bad batch degrades gracefully; exhausting the
            # budget fails loudly (a persistent nan is a bug, not noise)
            self._nonfinite_skipped += 1
            self._drop_grads()
            if self._nonfinite_skipped > self._nonfinite_budget:
                raise FloatingPointError(
                    f"non-finite loss ({loss_v}) exceeded the skip budget "
                    f"of {self._nonfinite_budget}")
            vlog(0, "hapi: non-finite loss (%s) - skipping update (%d/%d)",
                 loss_v, self._nonfinite_skipped, self._nonfinite_budget)
            return loss_v, [m.accumulate() for m in self._metrics]
        if decide:
            self._optimizer_step(lr_override)
        return loss_v, self._metric_values(out, data[-1])

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self._device()
        *inputs, label = [self._as_tensor(x, dev) for x in
                          (*_tuplify(inputs), *_tuplify(labels))]
        out = self.network(*inputs)
        loss = self._loss(out, label) if self._loss is not None else 0.0
        return float(loss), out

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        dev = self._device()
        return self.network(*[self._as_tensor(x, dev)
                              for x in _tuplify(inputs)])

    # -- loops ------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle=False, drop_last=False,
                num_workers=0):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, places=self._device(), batch_size=batch_size,
                          shuffle=shuffle, drop_last=drop_last,
                          num_workers=num_workers)

    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, shuffle: bool = True,
            num_workers: int = 0, verbose: int = 1, drop_last: bool = False,
            callbacks=None, supervisor=None):
        """``supervisor``: a :class:`paddle_tpu_torch.supervisor.
        RunSupervisor` wrapping this run in the health loop: the watchdog
        around every batch, heartbeats, the divergence guard (skip ->
        lower LR -> rollback) and budget-bounded rollback to the last
        committed checkpoint."""
        from ..optimizer import lr as lr_mod
        from .callbacks import (CallbackList, LRScheduler as LRSchedulerCB,
                                ModelCheckpoint, ProgBarLogger)
        train_loader = self._loader(train_data, batch_size, shuffle,
                                    drop_last, num_workers)
        cbs = CallbackList(list(callbacks or []))
        if not any(isinstance(c, ProgBarLogger) for c in cbs.callbacks):
            cbs.append(ProgBarLogger(log_freq=log_freq, verbose=verbose))
        if save_dir and not any(isinstance(c, ModelCheckpoint)
                                for c in cbs.callbacks):
            cbs.append(ModelCheckpoint(save_dir=save_dir))
        if (isinstance(getattr(self._optimizer, "_lr", None),
                       lr_mod.LRScheduler)
                and not any(isinstance(c, LRSchedulerCB)
                            for c in cbs.callbacks)):
            # paddle convention: fit drives per-step scheduling by default
            cbs.append(LRSchedulerCB(by_step=True))
        cbs.set_model(self)
        cbs.set_params({"epochs": epochs, "batch_size": batch_size,
                        "verbose": verbose, "save_dir": save_dir})
        self.stop_training = False
        history = {"loss": []}
        sup = supervisor
        if sup is not None:
            from ..supervisor.guard import GuardAction
            from ..supervisor.watchdog import StepTimeout
            sup.attach(self)
            if hasattr(self._optimizer, "_ensure_state"):
                # warm the optimizer state so every supervised checkpoint
                # (the rollback templates too) has one stable tree
                self._optimizer._ensure_state()
            sup.begin_run(initial_state=_clone(self._supervised_state(),
                                               device="cpu"))
        cbs.on_train_begin()
        try:
            for epoch in range(epochs):
                for m in self._metrics:
                    m.reset()
                cbs.on_epoch_begin(epoch)
                epoch_losses = []
                for step, (batch, data_s) in enumerate(
                        self._timed_batches(train_loader)):
                    cbs.on_train_batch_begin(step)
                    *inputs, label = batch
                    if sup is not None:
                        try:
                            with span("step") as sp_step:
                                loss, metrics = self.train_batch(inputs,
                                                                 label)
                        except StepTimeout:
                            # the watchdog fired: the step is dead, not the
                            # run; skip it, roll back when they repeat
                            if (sup.note_step_failure("step-timeout")
                                    == GuardAction.ROLLBACK):
                                self._supervised_rollback(sup)
                            cbs.on_train_batch_end(
                                step, {"loss": float("nan"),
                                       "supervisor": "step-timeout"})
                            if self.stop_training:
                                break
                            continue
                        good = sup.last_action in (None, GuardAction.OK)
                        if sup.pending_rollback:
                            self._supervised_rollback(sup)
                        elif sup.pending_resize is not None:
                            self._supervised_resize(sup)
                        elif sup.pending_integrity is not None:
                            # a desync verdict: majority members publish the
                            # resync offer, suspects climb the
                            # resync -> rollback ladder
                            self._supervised_integrity_heal(sup)
                        else:
                            # checkpoint only states a good update built
                            sup.note_step_ok(
                                self._supervised_state() if good else None)
                    else:
                        good = True
                        with span("step") as sp_step:
                            loss, metrics = self.train_batch(inputs, label)
                    self._record_step_telemetry(data_s, sp_step.elapsed,
                                                label, loss)
                    history["loss"].append(loss)
                    if good:
                        epoch_losses.append(loss)
                    logs = {"loss": loss}
                    if sup is not None and not good:
                        logs["supervisor"] = sup.last_action
                    if self._nonfinite_budget is not None:
                        logs["nonfinite_skipped"] = self._nonfinite_skipped
                    for m, v in zip(self._metrics, metrics):
                        logs[m.name()] = v[0] if isinstance(v, list) else v
                    cbs.on_train_batch_end(step, logs)
                    if self.stop_training:
                        break
                # with a skip guard on, skipped batches' nan losses are
                # left out of the epoch mean (they applied no update)
                _mean = (np.nanmean if self._nonfinite_budget is not None
                         else np.mean)
                epoch_logs = {"loss": float(_mean(epoch_losses))
                              if epoch_losses else float("nan")}
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    cbs.on_eval_begin()
                    eval_res = self.evaluate(eval_data,
                                             batch_size=batch_size,
                                             verbose=verbose)
                    cbs.on_eval_end(eval_res)
                    # eval metrics reach on_epoch_end (EarlyStopping
                    # monitors)
                    epoch_logs.update({f"eval_{k}" if k == "loss" else k: v
                                       for k, v in eval_res.items()})
                cbs.on_epoch_end(epoch, epoch_logs)
                if self.stop_training:
                    break
        except BaseException:
            if sup is not None:
                sup.end_run("failed")
                self._supervisor = None
            raise
        if sup is not None:
            sup.end_run("completed")
            self._supervisor = None
        cbs.on_train_end()
        return history

    # -- telemetry plumbing -------------------------------------------------
    @staticmethod
    def _timed_batches(loader):
        """Iterate ``loader`` yielding ``(batch, data_wait_seconds)``: the
        data-wait half of the per-step breakdown."""
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                with span("data_load"):
                    batch = next(it)
            except StopIteration:
                return
            yield batch, time.perf_counter() - t0

    def _record_step_telemetry(self, data_s: float, step_s: float, label,
                               loss) -> None:
        """One ``step`` record per train batch: wall time split into
        data-wait / dispatch / readback, tokens/s and live MFU against the
        card's peak (``observability/mfu.py``), emitted to whatever sinks
        are attached and accumulated in the registry's histograms."""
        try:
            reg = get_registry()
            timing = self._last_batch_timing or {}
            shape = tuple(getattr(label, "shape", np.shape(label)))
            tokens = max(1, int(np.prod(shape)) if shape else 1)
            seq_len = int(shape[-1]) if len(shape) >= 2 else None
            if self._obs_n_params is None:
                self._obs_n_params = param_count(
                    self.network.state_dict())
                self._obs_peak = peak_flops_per_sec()
            if self._obs_flops_token is None or seq_len != self._obs_seq_len:
                cfg = getattr(self.network, "config", None)
                self._obs_flops_token = flops_per_token(
                    self._obs_n_params,
                    num_layers=getattr(cfg, "num_layers", None),
                    hidden_size=getattr(cfg, "hidden_size", None),
                    seq_len=seq_len)
                self._obs_seq_len = seq_len
            total_s = max(1e-9, data_s + step_s)
            tps = tokens / total_s
            mfu_v = mfu(tps, self._obs_flops_token, self._obs_peak)
            compute_ms = timing.get("dispatch_s", 0.0) * 1e3
            readback_ms = timing.get("readback_s", 0.0) * 1e3
            reg.histogram("step.time_ms").observe(total_s * 1e3)
            reg.histogram("step.data_ms").observe(data_s * 1e3)
            reg.histogram("step.compute_ms").observe(compute_ms)
            reg.histogram("step.readback_ms").observe(readback_ms)
            reg.counter("step.count").inc()
            reg.counter("step.tokens").inc(tokens)
            reg.gauge("step.tokens_per_sec").set(tps)
            reg.gauge("step.mfu").set(mfu_v)
            sup = self._supervisor
            cur_step = sup.gstep if sup is not None else self._obs_step
            # where-is-it-now gauges for the status server's /statusz
            reg.gauge("step.current").set(cur_step)
            reg.gauge("step.loss").set(float(loss))
            # device-memory watermarks on their PTPU_MEM_SAMPLE_EVERY
            # cadence (a no-op off cadence and without a card)
            obs_memory.get_sampler().sample(cur_step)
            reg.emit("step",
                     step=cur_step,
                     step_time_ms=total_s * 1e3, data_ms=data_s * 1e3,
                     compute_ms=compute_ms, readback_ms=readback_ms,
                     tokens=tokens, tokens_per_sec=tps, mfu=mfu_v,
                     loss=float(loss))
            self._obs_step += 1
        except Exception as e:
            # telemetry must never take the training loop down with it
            vlog(1, "hapi: step telemetry failed: %r", e)

    # -- supervision plumbing -----------------------------------------------
    def _supervised_state(self):
        """The tree the run supervisor checkpoints and rolls back: the
        network's parameters and buffers, the optimizer's state once it
        exists (keyed as the JAX state), and the framework's random
        streams.  The tensors are the live ones, not copies."""
        state = {"params": dict(self.network.state_dict())}
        opt = self._optimizer
        if opt is not None and getattr(opt, "_step", None) is not None:
            state["opt"] = opt.state_dict()["state"]
        state["rng"] = fw_random.get_state()
        return state

    def _assign_params(self, params, strict: bool = False) -> None:
        own = self.network.state_dict()
        if strict:
            unexpected = sorted(set(params) - set(own))
            missing = sorted(set(own) - set(params))
            enforce(not unexpected and not missing,
                    f"state dict mismatch: unexpected {unexpected[:5]}, "
                    f"missing {missing[:5]}")
        with torch.no_grad():
            for name, value in params.items():
                if name not in own:
                    continue
                dst = own[name]
                src = _to_tensor(value, dst.device)
                enforce(tuple(src.shape) == tuple(dst.shape),
                        f"shape mismatch for {name}: {tuple(src.shape)} vs "
                        f"{tuple(dst.shape)}")
                dst.copy_(src)

    def _load_opt_state(self, opt_state) -> None:
        """Load a ``{"step", "slots", "master"}`` optimizer state, the
        port's or the JAX package's (slots and masters absent where a
        checkpoint held no leaf for them)."""
        opt = self._optimizer
        if opt is None or not hasattr(opt, "_names"):
            return
        slots = opt_state.get("slots") or {}
        masters = opt_state.get("master") or {}
        opt.set_state_dict({"state": {
            "step": opt_state["step"],
            "slots": {n: dict(slots.get(n) or {}) for n in opt._names},
            "master": {n: masters.get(n) for n in opt._names}}})

    def _load_supervised_state(self, state) -> None:
        self._assign_params(state["params"])
        if "opt" in state:
            self._load_opt_state(state["opt"])
        if "rng" in state:
            fw_random.set_state(state["rng"])

    def _supervised_rollback(self, sup, reason: Optional[str] = None
                             ) -> None:
        """Restore the last committed good step into the live model (the
        pristine initial state when nothing has been committed yet)."""
        state, _start = sup.perform_rollback(
            lambda: (sup.initial_state if sup.initial_state is not None
                     else self._supervised_state()),
            lambda: self._supervised_state(), reason)
        self._load_supervised_state(state)

    def _supervised_integrity_heal(self, sup) -> None:
        """Execute a latched state-integrity heal; the live model adopts
        whatever state the ladder lands on: the majority state (resync),
        a digest-verified checkpoint (rollback), or its own (offer)."""
        state, _start = sup.perform_integrity_heal(
            lambda: (sup.initial_state if sup.initial_state is not None
                     else self._supervised_state()),
            lambda: self._supervised_state(),
            self._supervised_state())
        self._load_supervised_state(state)

    def _integrity_replay(self, state, stashed):
        """Re-run one stashed step for the replay audit: the stashed
        pre-state (random streams included), the same inputs, the same
        learning rate.  The live model is stateful, so its state is set
        aside on the card, the step replayed in place, its result cloned,
        and the live state put back."""
        data, lr_override = stashed
        live = _clone(self._supervised_state())
        try:
            self._load_supervised_state(state)
            self._forward_backward(data, with_norm=False)
            self._optimizer_step(lr_override)
            return _clone(self._supervised_state())
        finally:
            self._drop_grads()
            self._load_supervised_state(live)

    def _supervised_resize(self, sup) -> None:
        raise UnimplementedError(
            "an elastic resize needs the JAX package's ElasticCoordinator, "
            "which comes with the port's multi-GPU slice")

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 1, num_workers: int = 0):
        loader = self._loader(eval_data, batch_size,
                              num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            *inputs, label = batch
            loss, out = self.eval_batch(inputs, label)
            losses.append(loss)
            for m in self._metrics:
                r = m.compute(_host(out), _host(label))
                m.update(*(r if isinstance(r, tuple) else (r,)))
        result = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            result[m.name()] = m.accumulate()
        if verbose:
            print("Eval:", result)  # noqa: print
        return result

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0):
        loader = self._loader(test_data, batch_size,
                              num_workers=num_workers)
        outs = []
        for batch in loader:
            inputs = batch[:-1] if isinstance(batch, (tuple, list)) and \
                len(batch) > 1 else _tuplify(batch)
            outs.append(_host(self.predict_batch(list(inputs))))
        return outs

    # -- io ---------------------------------------------------------------
    def save(self, path: str):
        """``path.pdparams`` (the network's state dict) and, once the
        optimizer has state, ``path.pdopt`` (a port optimizer's state
        keyed as the JAX state), in the JAX package's pickle format."""
        fw_io.save(self.network.state_dict(), path + ".pdparams")
        opt = self._optimizer
        if opt is not None and getattr(opt, "_step", None) is not None:
            fw_io.save(optimizer_state_to_jax(opt), path + ".pdopt")

    def load(self, path: str, reset_optimizer: bool = False):
        self._assign_params(fw_io.load(path + ".pdparams"), strict=True)
        if not reset_optimizer and os.path.exists(path + ".pdopt"):
            self._load_opt_state(fw_io.load(path + ".pdopt"))

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        lines, total = [], 0
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape))
            total += n
            lines.append(f"  {name:40s} {str(tuple(p.shape)):20s} {n}")
        out = "\n".join(lines) + f"\nTotal params: {total}"
        print(out)  # noqa: print
        return {"total_params": total}
