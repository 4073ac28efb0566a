"""Mixture-of-Experts on one card: the port of the single-card part of
``paddle_tpu/distributed/moe.py`` (gating with capacity, the aux loss and
its collection, the stacked experts and the layer).

The gates keep the JAX package's one-hot formulation as public functions
(:func:`switch_gating`, :func:`gshard_gating`: ``(T, E, C)`` dispatch and
combine tensors), which are also the plain version the tests compare with.
:class:`MoELayer` computes the same thing by index instead: the masks,
slots, gates and aux come from the same arithmetic on ``(T, E)`` tensors
(:func:`route`), then each kept (token, choice) is copied into row ``e * C
+ slot`` of an ``(E * C + 1, H)`` buffer (dropped ones into the last row,
which no expert reads), and the output gathers each token's rows back,
``gate1 * out[e1, c1] + gate2 * out[e2, c2]``.  A ``(T, E, C)`` tensor at a
training row (T = 16384, E = 8, C = 8192) holds 1.07e9 elements, so the
one-hot form does not fit the card; the index form moves ``(T, E)`` and
``(E, C, H)`` tensors only, with no host sync and no data-dependent shape
(so a decode step with MoE layers captures as a CUDA graph).

The copy into the buffer is exact, as the one-hot product by 1.0 is; the
combine sums the same two products in float32 and rounds once to the
activation dtype, as a float32-accumulated contraction does.

``global_scatter`` / ``global_gather`` (the all-to-alls over the ``ep``
axis) come with the multi-GPU slice.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..framework.errors import enforce
from ..nn import functional as F
from ..nn.layer import Layer

__all__ = ["switch_gating", "gshard_gating", "limit_by_capacity", "route",
           "Routing", "MoELayer", "ExpertFFN", "collect_aux_losses"]


# ---------------------------------------------------------------------------
# Aux-loss collection: every MoELayer forward inside a
# ``collect_aux_losses()`` scope appends its load-balance loss to the
# scope's list (a thread-local list of scalars).
# ---------------------------------------------------------------------------
_aux_ctx = threading.local()


@contextlib.contextmanager
def collect_aux_losses():
    """``with collect_aux_losses() as aux: ...`` -- every MoELayer forward
    inside appends its load-balance loss to ``aux`` (a list of scalars)."""
    prev = getattr(_aux_ctx, "items", None)
    _aux_ctx.items = []
    try:
        yield _aux_ctx.items
    finally:
        _aux_ctx.items = prev


def _record_aux(value) -> bool:
    items: Optional[List[torch.Tensor]] = getattr(_aux_ctx, "items", None)
    if items is None:
        return False
    items.append(value)
    return True


# ---------------------------------------------------------------------------
# Gating
# ---------------------------------------------------------------------------
def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer ``idx`` (a comparison: no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _token_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of a (T, E) mask over tokens.  Summed along
    the inner dim of its (E, T) transpose: torch's scan over an outer dim
    runs one thread per column, nearly serial for E = 8 (2.5 ms a call at
    T = 16384 on the H100).  The values are integers below 2^24, exact in
    float32 in any order."""
    return torch.cumsum(mask.t().contiguous(), dim=1).t()


def limit_by_capacity(mask, capacity: int):
    """Zero out tokens beyond each expert's capacity and return their slot
    positions, first come first served along the token axis.

    mask: (T, E) {0, 1}.  Returns ``(kept_mask, positions)``, positions
    int32 in [0, capacity) where kept_mask is 1 and 0 elsewhere."""
    positions = _token_cumsum(mask) * mask - mask          # 0-based slot
    kept = mask * (positions < capacity)
    return kept, (positions * kept).to(torch.int32)


def _one_hot_dispatch(mask, positions, capacity: int):
    """(T, E) kept mask + slots -> (T, E, C) dispatch tensor."""
    return mask[:, :, None] * _one_hot(positions.long(), capacity)


class Routing(NamedTuple):
    """Where :func:`route` sends each token: per choice (the first, then
    GShard's second) the expert ``(T,)`` int64, the slot in that expert
    ``(T,)`` int64 (0 where dropped), whether it was kept ``(T,)`` float32
    {0, 1} and its combine weight ``(T,)`` float32; and the load-balance
    ``aux`` scalar."""
    expert: Tuple[torch.Tensor, ...]
    slot: Tuple[torch.Tensor, ...]
    kept: Tuple[torch.Tensor, ...]
    gate: Tuple[torch.Tensor, ...]
    aux: torch.Tensor


def _gate_masks(logits, capacity: int, gate: str):
    """The JAX gates' arithmetic on ``(T, E)`` tensors: per choice ``(idx
    (T,), kept mask (T, E), slots (T, E) int32, gate (T,))``, and the aux.
    ``argmax`` takes the first maximum, as ``jnp.argmax``; the slots are
    cumulative sums in token order (integers, exact in float32 below 2^24
    tokens)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    idx1 = torch.argmax(probs, dim=-1)
    mask1 = _one_hot(idx1, e)
    aux = e * torch.sum(mask1.mean(dim=0) * probs.mean(dim=0))
    kept1, pos1 = limit_by_capacity(mask1, capacity)
    gate1 = torch.sum(probs * mask1, dim=-1)
    if gate == "switch":
        return [(idx1, kept1, pos1, gate1)], aux
    idx2 = torch.argmax(probs * (1.0 - mask1), dim=-1)
    mask2 = _one_hot(idx2, e)
    # second choices are placed after every kept first choice of that expert
    first_counts = kept1.sum(dim=0, keepdim=True)
    pos2_raw = _token_cumsum(mask2) * mask2 - mask2 + first_counts
    kept2 = mask2 * (pos2_raw < capacity)
    pos2 = (pos2_raw * kept2).to(torch.int32)
    gate2 = torch.sum(probs * mask2, dim=-1)
    denom = torch.clamp_min(gate1 + gate2, 1e-9)
    return [(idx1, kept1, pos1, gate1 / denom),
            (idx2, kept2, pos2, gate2 / denom)], aux


def route(logits: torch.Tensor, capacity: int, gate: str = "gshard"
          ) -> Routing:
    """The gating of :func:`switch_gating` / :func:`gshard_gating` by
    index: the same kept flags, slots, gates and aux, differentiable in
    ``logits`` through the gates and the aux."""
    enforce(gate in _GATES, f"unknown gate {gate!r}; use {list(_GATES)}")
    choices, aux = _gate_masks(logits, capacity, gate)
    return Routing(tuple(idx for idx, _, _, _ in choices),
                   tuple(pos.sum(dim=-1).long() for _, _, pos, _ in choices),
                   tuple(kept.sum(dim=-1) for _, kept, _, _ in choices),
                   tuple(g for _, _, _, g in choices), aux)


def _one_hot_gating(logits, capacity: int, gate: str):
    choices, aux = _gate_masks(logits, capacity, gate)
    dispatch = combine = None
    for _, kept, pos, g in choices:
        d = _one_hot_dispatch(kept, pos, capacity)
        dispatch = d if dispatch is None else dispatch + d
        c = g[:, None, None] * d
        combine = c if combine is None else combine + c
    return dispatch, combine, aux


def switch_gating(logits, capacity: int):
    """Top-1 (Switch) gating with capacity.  Returns ``(dispatch (T, E, C),
    combine (T, E, C), aux)``; aux = E * sum_e frac_tokens_e *
    mean_prob_e (the Switch load-balance loss)."""
    return _one_hot_gating(logits, capacity, "switch")


def gshard_gating(logits, capacity: int):
    """Top-2 (GShard) gating with capacity; second choices queue behind
    every kept first choice of their expert, and the two gates are
    normalised to sum to 1."""
    return _one_hot_gating(logits, capacity, "gshard")


_GATES: Dict[str, Callable] = {"switch": switch_gating,
                               "gshard": gshard_gating}


# ---------------------------------------------------------------------------
# Expert + layer
# ---------------------------------------------------------------------------
class ExpertFFN(Layer):
    """E stacked FFN experts: ``w1`` (E, H, F), ``b1`` (E, 1, F), ``w2``
    (E, F, H), ``b2`` (E, 1, H).  The weights are cast to the input's
    dtype and each expert's rows go through two batched products (plain
    ``torch.matmul``, as the JAX package's einsums; no amp cast) around an
    exact gelu."""

    def __init__(self, num_experts: int, hidden_size: int, ffn_size: int,
                 std: float = 0.02, out_std: Optional[float] = None,
                 device=None):
        super().__init__()
        self.num_experts = num_experts
        e, h, f = num_experts, hidden_size, ffn_size
        self.w1 = nn.Parameter(torch.empty(e, h, f, device=device))
        self.b1 = nn.Parameter(torch.zeros(e, 1, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e, f, h, device=device))
        self.b2 = nn.Parameter(torch.zeros(e, 1, h, device=device))
        nn.init.normal_(self.w1, 0.0, std)
        nn.init.normal_(self.w2, 0.0, std if out_std is None else out_std)

    def forward(self, x):
        """x: (E, C, H) expert inputs -> (E, C, H)."""
        dt = x.dtype
        h = torch.matmul(x, self.w1.to(dt)) + self.b1.to(dt)
        h = F.gelu(h)
        return torch.matmul(h, self.w2.to(dt)) + self.b2.to(dt)


class MoELayer(Layer):
    """Mixture-of-experts FFN: gate -> capacity-limited dispatch by index
    -> :class:`ExpertFFN` -> combine by index (see the module docstring),
    then the residual dropout.  The load-balance aux reaches the training
    loss through an enclosing :func:`collect_aux_losses` scope (what
    ``GPTForCausalLM`` does) or the second output of
    :meth:`forward_with_aux`."""

    def __init__(self, hidden_size: int, ffn_size: int, num_experts: int,
                 *, gate: str = "gshard", capacity_factor: float = 2.0,
                 std: float = 0.02, out_std: Optional[float] = None,
                 dropout_p: float = 0.0, device=None):
        super().__init__()
        enforce(gate in _GATES, f"unknown gate {gate!r}; use {list(_GATES)}")
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        self.gate_type = gate
        self.dropout_p = float(dropout_p)
        self.gate_weight = nn.Parameter(torch.empty(hidden_size, num_experts,
                                                    device=device))
        nn.init.normal_(self.gate_weight, 0.0, 0.02)
        self.experts = ExpertFFN(num_experts, hidden_size, ffn_size, std=std,
                                 out_std=out_std, device=device)

    def capacity(self, tokens: int) -> int:
        k = 2 if self.gate_type == "gshard" else 1
        return max(1, int(math.ceil(
            tokens * self.capacity_factor * k / self.num_experts)))

    def route(self, x) -> Routing:
        """The routing of ``x`` (..., H) at the capacity of its token
        count."""
        xt = x.reshape(-1, x.shape[-1])
        logits = torch.matmul(xt.float(), self.gate_weight.float())
        return route(logits, self.capacity(xt.shape[0]), self.gate_type)

    def forward_with_aux(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, H) -> (out (B, S, H), aux scalar)."""
        b, s, h = x.shape
        xt = x.reshape(b * s, h)
        cap = self.capacity(b * s)
        r = self.route(x)
        e = self.num_experts
        dump = e * cap
        rows = [torch.where(k > 0, ex * cap + sl, dump)
                for ex, sl, k in zip(r.expert, r.slot, r.kept)]
        # exact copies: every kept (expert, slot) is written by one token
        buf = xt.new_zeros(dump + 1, h).index_add(
            0, torch.cat(rows), xt.repeat(len(rows), 1))
        out_e = self.experts(buf[:dump].view(e, cap, h)).reshape(dump, h)
        out_e = torch.cat([out_e, out_e.new_zeros(1, h)])
        out = None
        for row, k, g in zip(rows, r.kept, r.gate):
            w = (g * k).to(x.dtype).float()
            term = w[:, None] * out_e.index_select(0, row).float()
            out = term if out is None else out + term
        out = out.to(x.dtype).reshape(b, s, h)
        if self.dropout_p > 0.0:
            out = F.dropout(out, p=self.dropout_p, training=self.training)
        return out, r.aux

    def forward(self, x):
        out, aux = self.forward_with_aux(x)
        _record_aux(aux)
        return out
