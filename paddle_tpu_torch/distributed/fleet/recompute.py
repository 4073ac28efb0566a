"""Activation recompute (gradient checkpointing): the port of
``paddle_tpu/distributed/fleet/recompute.py``.

``recompute(function, *args)`` runs ``function`` under
``torch.utils.checkpoint`` (``use_reentrant=False``): the activations
inside are not kept for backward but recomputed by replaying the forward.
Three things the replay must see as the forward saw them, which torch's
own state preservation (its default generators and ``torch.autocast``)
does not cover:

- the framework's random streams (``framework/random.py``): the dropout
  masks and the flash / fused-block hash-dropout seeds are drawn from
  them, so the replay restores the streams as they stood before the
  forward, then puts back the streams as it found them (the reference's
  ``RecomputeFunction`` does this with paddle's RNG state);
- the port's ``amp.auto_cast`` policy (``amp/state.py``), which is no
  longer active when the backward runs;
- with a ``policy``, which results to keep (torch's selective
  checkpointing).

``policy`` as the JAX package's ``jax.checkpoint`` policies: None / "full"
recompute everything; "dots_saveable" keeps every matrix product's output
(``mm``, ``addmm``, ``bmm``, ``baddbmm``); "dots_with_no_batch_dims_
saveable" keeps those without a batch dimension (``mm``, ``addmm``: the
linear layers, not the attention products); "everything_saveable" keeps
every result.  ``preserve_rng_state`` is accepted for parity: the streams
are always replayed (JAX's keys make it always true there too).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...amp import state as amp_state
from ...framework import random as fw_random
from ...framework.errors import enforce

__all__ = ["recompute", "recompute_wrapper", "POLICIES"]

_aten = torch.ops.aten
_NO_BATCH_DOTS = frozenset((_aten.mm.default, _aten.addmm.default))
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}

#: policy name -> the ops whose results are kept (None: keep none, "all":
#: keep every result)
POLICIES = {None: None, "full": None, "dots_saveable": _DOTS,
            "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
            "everything_saveable": "all"}


class _Replay:
    """The forward's state, captured when the forward starts (``capture``)
    and put in place around the replay (``replay``)."""

    def __init__(self):
        self.rng = None
        self.amp = None

    @contextlib.contextmanager
    def capture(self):
        self.rng = fw_random.get_state()
        self.amp = amp_state.current()
        yield

    @contextlib.contextmanager
    def replay(self):
        now = fw_random.get_state()
        fw_random.set_state(self.rng)
        prev = amp_state.push(self.amp.enabled, self.amp.level,
                              self.amp.dtype)
        try:
            yield
        finally:
            amp_state.pop(prev)
            fw_random.set_state(now)


def _keep(ops, ctx, op, *args, **kwargs):
    if ops == "all" or op in ops:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _contexts(policy: Optional[str]):
    """The (forward, recompute) context pair for ``checkpoint``."""
    state = _Replay()
    fwd, rec = [state.capture()], [state.replay()]
    ops = POLICIES[policy]
    if ops is not None:
        sac_fwd, sac_rec = create_selective_checkpoint_contexts(
            functools.partial(_keep, ops))
        fwd.append(sac_fwd)
        rec.append(sac_rec)
    return _chain(fwd), _chain(rec)


@contextlib.contextmanager
def _chain(contexts):
    with contextlib.ExitStack() as stack:
        for cm in contexts:
            stack.enter_context(cm)
        yield


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              policy: Optional[str] = None, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its activations for
    backward (they are recomputed), under ``policy`` (see the module
    docstring).  Without grad mode it is a plain call."""
    enforce(policy in POLICIES, f"unknown recompute policy {policy!r}; one "
            f"of {sorted(k for k in POLICIES if k)} or None")
    return checkpoint(function, *args, use_reentrant=False,
                      context_fn=functools.partial(_contexts, policy),
                      **kwargs)


def recompute_wrapper(function: Callable, policy: Optional[str] = None):
    """Decorator form: a forward or block function that always
    recomputes."""
    enforce(policy in POLICIES, f"unknown recompute policy {policy!r}")

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return recompute(function, *args, policy=policy, **kwargs)

    return wrapped
