"""GPT decoder-only transformer: the port of ``paddle_tpu/models/gpt.py``
for the training step (``model(input_ids, labels=labels)``, the cache-free
forward and the fused LM loss), for ``GPTForCausalLM.serving_step`` over a
paged KV cache and for ``GPTForCausalLM.generate`` over fixed-shape caches
(``make_caches``, ``generate_step``).

Same module tree, parameter names and (in, out) weight layout as the JAX
package, so ``state_dict`` keys carry over (``convert.py``).  Two block
paths, chosen by ``GPTConfig.use_fused_block`` as in the JAX package:

- unfused: ``x + attn(ln_1(x))`` then ``x + mlp(ln_2(x))``, plain PyTorch
  around the attention kernels (flash attention when
  ``use_pallas_attention``, paged decode when serving, the flash decode
  kernel for a single-token ``generate`` step with
  ``use_pallas_attention``);
- fused: K1 ``fused_ln_linear`` -> attention -> K2
  ``fused_linear_residual``, then K3 ``fused_ffn_block``; the attention is
  flash attention in the cache-free (training) forward
  (``fused_attention_block``), paged or fixed-cache decode attention over
  a cache.

Dtypes follow the JAX package: parameters stay float32 (bf16 after
``amp.decorate(level="O2")``); with ``dtype="bfloat16"`` the embeddings
are cast to bfloat16 (the residual stream) and the KV pages are bfloat16;
every op promotes as ``jnp`` does, and under ``amp.auto_cast`` the ops
cast as the JAX package's do.

``use_recompute`` replays each block's forward in the backward instead of
keeping its activations (``distributed/fleet/recompute.py``, under
``recompute_policy``), for both block paths, as the JAX package's
``GPTDecoderLayer.forward``.

With ``moe_num_experts > 0`` every ``moe_every``-th layer's FFN is a
:class:`~paddle_tpu_torch.distributed.moe.MoELayer` (switch or GShard
gating with capacity).  Those layers always take the unfused block, in
training and over either cache, while the dense layers of the same model
keep ``use_fused_block``; each MoE block returns its load-balance aux
beside its output (collected inside the block, so a recomputed block's
replay adds nothing), and the training loss adds ``moe_aux_weight`` times
their sum.  The cache paths route the step's rows at the capacity of that
step's token count, as the JAX layer does.

Under a hybrid group (``distributed.fleet.init``) the model holds this
rank's shard, as the JAX layers' ``PartitionSpec``s place it: each rank
keeps ``num_heads / mp`` heads (the qkv columns are head-major, head0
q|k|v, head1 q|k|v, ..., so a contiguous column block is whole heads), the
FFN's ``ffn / mp`` columns, the tied embedding's ``vocab / mp`` rows, and
under pp only its stage's layers (``gpt.h.<i>`` keep their global index;
stage 0 holds the embeddings, the last stage the final LN and the tied
table too; ``models/gpt_pipeline.py`` runs them).  The tied head and the
fused LM loss are vocab-parallel, attention dropout draws from the
model-parallel stream (``distributed/random.py``), and the fused block is
off, as the JAX ``_fused_block_ok`` turns it off under a mesh.

Not in these slices (ROADMAP): sequence and context parallelism; their
config fields raise when set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .. import _kernels
from ..device import resolve_device
from ..distributed import topology as topo
from ..distributed.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding, copy_to_mp,
                                     gather_from_mp)
from ..distributed.random import MODEL_PARALLEL_RNG, get_rng_state_tracker
from ..distributed.fleet.recompute import POLICIES, recompute
from ..distributed.moe import MoELayer, _record_aux, collect_aux_losses
from ..distributed.mp_ops import parallel_cross_entropy
from ..framework import random as fw_random
from ..framework.errors import UnimplementedError, enforce
from ..inference.kv_cache import PagedLayerCache
from ..inference.paged_attention import paged_attention
from ..nn import functional as F
from ..nn.layer import Layer, LayerList
from ..nn.layers import Dropout, LayerNorm
from ..ops.flash_attention import flash_attention, flash_attention_kvcache
from ..ops.fused import _lce_chunk, linear_softmax_cross_entropy
from ..ops.fused_block import (fused_attention_block,
                               fused_attention_block_kvcache,
                               fused_ffn_block, fused_linear_residual,
                               fused_ln_linear)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer",
           "GPTModel", "GPTForCausalLM", "shift_labels", "gpt_tiny",
           "gpt_125m", "gpt_350m", "gpt_1p3b", "gpt_6p7b"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def shift_labels(labels: torch.Tensor, ignore_index: int = -100):
    """Causal-LM label shift: position t is scored against token t+1; the
    last position gets ``ignore_index``."""
    shifted = torch.roll(labels, -1, dims=1)
    shifted[:, -1] = ignore_index
    return shifted


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304          # padded to a multiple of 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: Optional[int] = None   # default 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_recompute: bool = False
    # what recompute keeps: None / "full", "dots_saveable",
    # "dots_with_no_batch_dims_saveable", "everything_saveable"
    recompute_policy: Optional[str] = None
    use_pallas_attention: bool = False   # flash-attention kernels (ops/)
    # block-level fused execution (ops/fused_block.py): LN->QKV as K1, the
    # out-projection + residual as K2 and the whole FFN half as K3
    use_fused_block: bool = False
    dtype: str = "float32"               # activation dtype
    sequence_parallel: bool = False
    context_parallel: bool = False
    # MoE: 0 experts = dense FFN; moe_every=2 alternates dense / MoE as
    # GShard does, 1 makes every layer MoE
    moe_num_experts: int = 0
    moe_gate: str = "gshard"
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    moe_every: int = 2
    # memory-efficient LM loss (ops/fused.py linear_softmax_cross_entropy):
    # never builds the [B, S, V] logits
    fused_lm_loss: bool = True

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        enforce(self.hidden_size % self.num_heads == 0,
                "num_heads must evenly divide hidden_size")
        enforce(self.dtype in _DTYPES, f"unsupported dtype {self.dtype!r}")
        enforce(self.recompute_policy in POLICIES,
                f"unknown recompute_policy {self.recompute_policy!r}")
        for name in ("sequence_parallel", "context_parallel"):
            enforce(not getattr(self, name),
                    f"GPTConfig.{name} is not ported yet (ROADMAP Queue 1)",
                    exc=UnimplementedError)

    def is_moe_layer(self, index: int) -> bool:
        return (self.moe_num_experts > 0
                and index % self.moe_every == self.moe_every - 1)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class GPTAttention(Layer):
    """Causal self-attention, cache-free (training) or over the paged
    cache; qkv is one (h, 3h) GEMM in head-major column order (head0:
    q|k|v, head1: q|k|v, ...)."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        std = c.initializer_range
        mp = topo.axis_size("mp")
        enforce(c.num_heads % mp == 0,
                f"num_heads {c.num_heads} not divisible by the "
                f"model-parallel degree {mp}")
        self.local_heads = c.num_heads // mp
        self.qkv_proj = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                             std=std, gather_output=False,
                                             device=device)
        self.out_proj = RowParallelLinear(
            c.hidden_size, c.hidden_size,
            std=std / math.sqrt(2.0 * c.num_layers), input_is_parallel=True,
            device=device)
        self.resid_dropout = Dropout(c.hidden_dropout)

    def _split_qkv(self, qkv, b, s):
        c = self.config
        qkv = qkv.reshape(b, s, self.local_heads, 3, c.head_dim)
        q = qkv[:, :, :, 0].transpose(1, 2)           # (b, heads, s, d)
        k = qkv[:, :, :, 1].transpose(1, 2)
        v = qkv[:, :, :, 2].transpose(1, 2)
        return q, k, v

    def forward(self, x, cache=None):
        """Cache-free: the output.  With a cache (a :class:`PagedLayerCache`
        or the fixed-shape ``(k_buf, v_buf, used)`` triple of
        :meth:`GPTForCausalLM.make_caches`): ``(output, new_cache)``."""
        b, s, _ = x.shape
        q, k, v = self._split_qkv(self.qkv_proj(x), b, s)
        if cache is None:
            c = self.config
            with _head_stream():
                if c.use_pallas_attention:
                    # under mp the hash's batch*head salt counts this
                    # rank's heads only; the model-parallel stream's seed
                    # differs per mp rank, so the ranks' masks differ
                    out = flash_attention(q, k, v, causal=True,
                                          dropout_p=c.attention_dropout,
                                          training=self.training)
                else:
                    out = F.scaled_dot_product_attention(
                        q, k, v, is_causal=True,
                        dropout_p=c.attention_dropout,
                        training=self.training)
            out = out.transpose(1, 2).reshape(b, s, out.shape[1] * c.head_dim)
            return self.resid_dropout(self.out_proj(out))
        if isinstance(cache, PagedLayerCache):
            out, new_cache = self._paged_cache_forward(q, k, v, cache, b, s)
        else:
            out, new_cache = self._fixed_cache_forward(q, k, v, cache, b, s)
        return self.resid_dropout(self.out_proj(out)), new_cache

    def _fixed_cache_forward(self, q, k, v, cache, b, s):
        """Write this call's k/v at ``used`` (a 0-d int32 device tensor) in
        place, then attend: a single-token step with
        ``use_pallas_attention`` (``L % 8 == 0``, ``head_dim % 8 == 0``)
        runs the flash decode kernel over the first ``used + 1`` positions;
        otherwise SDPA with the additive mask ``cols <= used + arange(s)``.
        Returns the attention output and ``(k_buf, v_buf, used + s)``."""
        c = self.config
        k_buf, v_buf, used = cache
        used = torch.as_tensor(used, dtype=torch.int32, device=q.device)
        rows = used.long() + torch.arange(s, device=q.device)
        k_buf.index_copy_(2, rows, k.to(k_buf.dtype))
        v_buf.index_copy_(2, rows, v.to(v_buf.dtype))
        cap = k_buf.shape[2]
        if (c.use_pallas_attention and s == 1 and cap % 8 == 0
                and c.head_dim % 8 == 0):
            out = flash_attention_kvcache(q, k_buf, v_buf, used + 1)
        else:
            cols = torch.arange(cap, device=q.device)
            bias = torch.where(cols[None, :] <= rows[:, None],
                               torch.zeros((), device=q.device),
                               torch.full((), -1e9, device=q.device))
            out = F.scaled_dot_product_attention(
                q, k_buf, v_buf, attn_mask=bias[None, None].to(q.dtype),
                is_causal=False, dropout_p=0.0, training=False)
        out = out.transpose(1, 2).reshape(b, s, c.hidden_size)
        return out, (k_buf, v_buf, used + s)

    def _paged_cache_forward(self, q, k, v, cache: PagedLayerCache, b, s):
        """Write this call's k/v into the pages at ``cache.slot_mapping``,
        then attend: ``s == 1`` is the batched ragged decode over the block
        tables; ``s > 1`` is a prefill chunk whose context is the chunk
        itself (a causal in-chunk mask, pad columns masked by seq_lens)."""
        c = self.config
        new_k = k.transpose(1, 2).reshape(b * s, c.num_heads, c.head_dim)
        new_v = v.transpose(1, 2).reshape(b * s, c.num_heads, c.head_dim)
        slots = cache.slot_mapping.reshape(-1).long()
        # Pages are written in place (the JAX package builds new arrays).
        # Pad positions all land on the trailing sentinel row, which no
        # read touches.  A step that fails after this write leaves nothing
        # harmful: it only wrote its own sequences' slots at positions they
        # have not read yet, and every later read of a position follows a
        # fresh write of it by the step that owns it (decode writes its
        # position before attending; prefill rewrites the whole context).
        cache.k_pages.index_copy_(0, slots, new_k.to(cache.k_pages.dtype))
        cache.v_pages.index_copy_(0, slots, new_v.to(cache.v_pages.dtype))
        if s == 1:
            o = paged_attention(q[:, :, 0, :].contiguous(), cache.k_pages,
                                cache.v_pages, cache.block_tables,
                                cache.seq_lens, block_size=cache.block_size)
            out = o.to(q.dtype).reshape(b, 1, c.hidden_size)
        else:
            dev = q.device
            rows = torch.arange(s, device=dev)
            causal = rows[None, :] <= rows[:, None]                # (s, s)
            valid = rows[None, None, :] < cache.seq_lens.long()[:, None, None]
            bias = torch.where(causal[None] & valid,
                               torch.zeros((), device=dev),
                               torch.full((), -1e9, device=dev))
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias[:, None].to(q.dtype),
                is_causal=False, dropout_p=0.0, training=False)
            out = out.transpose(1, 2).reshape(b, s, c.hidden_size)
        return out, cache

    def fused_paged_forward(self, x, ln: LayerNorm, cache: PagedLayerCache):
        """Fused serving step: LN->QKV as K1, paged attention, out-proj +
        residual as K2.  Returns the residual-added block output."""
        c = self.config
        b, s, _ = x.shape
        qkv = fused_ln_linear(x, self.qkv_proj.weight, self.qkv_proj.bias,
                              ln.weight, ln.bias, epsilon=ln.epsilon)
        q, k, v = self._split_qkv(qkv, b, s)
        out, new_cache = self._paged_cache_forward(q, k, v, cache, b, s)
        y = fused_linear_residual(out, self.out_proj.weight,
                                  self.out_proj.bias, x,
                                  dropout_p=0.0, training=False)
        return y, new_cache


class GPTMLP(Layer):
    """h -> 4h -> h with exact gelu."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        self.fc_in = ColumnParallelLinear(c.hidden_size, c.ffn_hidden_size,
                                          std=c.initializer_range,
                                          gather_output=False, device=device)
        self.fc_out = RowParallelLinear(
            c.ffn_hidden_size, c.hidden_size,
            std=c.initializer_range / math.sqrt(2.0 * c.num_layers),
            input_is_parallel=True, device=device)
        self.dropout = Dropout(c.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x))))


class GPTDecoderLayer(Layer):
    """Pre-LN block, cache-free or over a cache (paged or fixed-shape).
    With ``config.is_moe_layer(index)`` the FFN is a :class:`MoELayer`."""

    def __init__(self, config: GPTConfig, index: int = 0, device=None):
        super().__init__()
        c = config
        self.config = c
        self.ln_1 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_epsilon,
                              device=device)
        self.attn = GPTAttention(c, device=device)
        self.ln_2 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_epsilon,
                              device=device)
        self._is_moe = c.is_moe_layer(index)
        if self._is_moe:
            self.mlp = MoELayer(
                c.hidden_size, c.ffn_hidden_size, c.moe_num_experts,
                gate=c.moe_gate, capacity_factor=c.moe_capacity_factor,
                dropout_p=c.hidden_dropout, std=c.initializer_range,
                out_std=c.initializer_range / math.sqrt(2.0 * c.num_layers),
                device=device)
        else:
            self.mlp = GPTMLP(c, device=device)

    def _fused_block_ok(self) -> bool:
        """The fused kernels cover the dense pre-LN block only, and a whole
        one: under a hybrid group (a rank's shard) the block is unfused,
        as the JAX package's is under a mesh."""
        return (self.config.use_fused_block and not self._is_moe
                and topo.get_mesh() is None)

    def _block_fused(self, x):
        """The cache-free fused block (training): the attention half as K1
        -> flash -> K2 with the attention and hidden dropouts, then K3 with
        the hidden dropout after ``+ b2`` (``dropout2``; ``dropout1``
        stays 0), as the JAX package's ``_block_fused``.  Returns ``(x,
        None)``: a dense block has no aux."""
        c = self.config
        a = self.attn
        x = fused_attention_block(
            x, a.qkv_proj.weight, a.qkv_proj.bias, a.out_proj.weight,
            a.out_proj.bias, self.ln_1.weight, self.ln_1.bias,
            num_heads=c.num_heads, causal=True,
            epsilon=c.layer_norm_epsilon, attn_dropout=c.attention_dropout,
            hidden_dropout=c.hidden_dropout, training=self.training)
        m = self.mlp
        x = fused_ffn_block(
            x, m.fc_in.weight, m.fc_in.bias, m.fc_out.weight, m.fc_out.bias,
            self.ln_2.weight, self.ln_2.bias, activation="gelu",
            dropout2=c.hidden_dropout, epsilon=c.layer_norm_epsilon,
            training=self.training)
        return x, None

    def _fused_cache_forward(self, x, cache):
        """Fused decode step over either kind of cache: the attention half
        (K1 -> paged or fixed-cache decode -> K2), then K3."""
        c = self.config
        if isinstance(cache, PagedLayerCache):
            x, new_cache = self.attn.fused_paged_forward(x, self.ln_1, cache)
        else:
            k_buf, v_buf, used = cache
            a = self.attn
            x, k_buf, v_buf = fused_attention_block_kvcache(
                x, a.qkv_proj.weight, a.qkv_proj.bias, a.out_proj.weight,
                a.out_proj.bias, self.ln_1.weight, self.ln_1.bias, k_buf,
                v_buf, used, num_heads=c.num_heads,
                epsilon=c.layer_norm_epsilon)
            new_cache = (k_buf, v_buf, used + x.shape[1])
        m = self.mlp
        x = fused_ffn_block(
            x, m.fc_in.weight, m.fc_in.bias, m.fc_out.weight, m.fc_out.bias,
            self.ln_2.weight, self.ln_2.bias, activation="gelu",
            dropout2=c.hidden_dropout, epsilon=c.layer_norm_epsilon,
            training=self.training)
        return x, new_cache

    def _block(self, x):
        """The cache-free unfused block: ``(x, aux)``, the MoE aux summed
        inside the block (None for a dense block), so it leaves a
        recomputed block as one of its outputs."""
        with collect_aux_losses() as aux_items:
            x = x + self.attn(self.ln_1(x))
            x = x + self.mlp(self.ln_2(x))
        return x, (sum(aux_items) if aux_items else None)

    def forward(self, x, cache=None):
        c = self.config
        if cache is None:
            block = self._block_fused if self._fused_block_ok() else \
                self._block
            if c.use_recompute:
                x, aux = recompute(block, x, policy=c.recompute_policy)
            else:
                x, aux = block(x)
            if self._is_moe:
                _record_aux(aux)
            return x
        if self._fused_block_ok():
            return self._fused_cache_forward(x, cache)
        h, new_cache = self.attn(self.ln_1(x), cache=cache)
        x = x + h
        x = x + self.mlp(self.ln_2(x))
        return x, new_cache


class _Absent(Layer):
    """The place of a decoder layer another pipeline stage holds."""

    def forward(self, x, cache=None):
        raise RuntimeError("this decoder layer lives on another pipeline "
                           "stage")


class GPTModel(Layer):
    """Embeddings + decoder stack + final LN.  Under a hybrid group with
    pp > 1 only this stage's part: the embeddings on the first stage,
    ``num_layers / pp`` layers (the others are placeholders without
    parameters), the final LN on the last stage, and the tied table on
    both end stages."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        pp, stage = topo.axis_size("pp"), topo.axis_rank("pp")
        enforce(c.num_layers % pp == 0,
                f"{c.num_layers} layers not divisible into {pp} stages")
        enforce(c.moe_num_experts == 0 or topo.get_mesh() is None,
                "MoE layers under a hybrid group come with expert "
                "parallelism (ROADMAP.md Queue 1 item 10)",
                exc=UnimplementedError)
        per = c.num_layers // pp
        self.stage_layers = range(stage * per, (stage + 1) * per)
        self.first_stage, self.last_stage = stage == 0, stage == pp - 1
        self.wte = (VocabParallelEmbedding(c.vocab_size, c.hidden_size,
                                           std=c.initializer_range,
                                           device=device)
                    if self.first_stage or self.last_stage else None)
        if self.wte is not None and pp > 1:
            # one tied table on two stages: the hybrid global norm counts
            # the first stage's copy only
            self.wte.weight.pp_tied = True
        if self.first_stage:
            self.wpe = nn.Parameter(torch.empty(c.max_position_embeddings,
                                                c.hidden_size, device=device))
            nn.init.normal_(self.wpe, 0.0, c.initializer_range)
        else:
            self.wpe = None
        self.drop = Dropout(c.hidden_dropout)
        self.h = LayerList([GPTDecoderLayer(c, i, device=device)
                            if i in self.stage_layers else _Absent()
                            for i in range(c.num_layers)])
        self.ln_f = (LayerNorm(c.hidden_size, epsilon=c.layer_norm_epsilon,
                               device=device) if self.last_stage else None)

    def embed(self, input_ids, position_offset=0):
        """The embeddings (``wte + wpe``, cast to the activation dtype,
        dropout) of the first stage."""
        c = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        off = torch.as_tensor(position_offset, device=dev).long()
        steps = torch.arange(s, device=dev)
        pos = off[:, None] + steps if off.dim() else off + steps
        x = self.wte(input_ids) + self.wpe[pos]
        if c.dtype != "float32":
            x = x.to(c.torch_dtype)
        return self.drop(x)

    def forward(self, input_ids, position_offset=0,
                caches: Optional[List[Any]] = None):
        """Hidden states ``(b, s, h)``, with the new caches when ``caches``
        are given.  ``position_offset`` is a scalar or a ``(b,)`` vector —
        every ragged-batch row decodes at its own position — as an int or a
        device tensor (read on the device: no host sync)."""
        enforce(self.first_stage and self.last_stage,
                "a pipeline stage runs through models.gpt_pipeline."
                "GPTPipeline (fleet.distributed_model), not forward")
        x = self.embed(input_ids, position_offset)
        if caches is None:
            for layer in self.h:
                x = layer(x)
            return self.ln_f(x)
        new_caches = []
        for i, layer in enumerate(self.h):
            x, kv = layer(x, cache=caches[i])
            new_caches.append(kv)
        x = self.ln_f(x)
        return x, new_caches


def _head_stream():
    """The model-parallel stream under mp (each rank's heads draw their
    own attention dropout), else no change."""
    tracker = get_rng_state_tracker()
    if topo.axis_size("mp") > 1 and tracker.has(MODEL_PARALLEL_RNG):
        return tracker.rng_state(MODEL_PARALLEL_RNG)
    return contextlib.nullcontext()


class GPTForCausalLM(Layer):
    """LM head tied to the embedding; the loss is the softmax cross-entropy
    against the shifted labels.  Parameters are made on ``device``
    (``cuda`` when none is given; the CPU only when asked)."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.gpt = GPTModel(config, device=self.device)
        self._gen_loop: Optional[_DecodeLoop] = None

    def forward(self, input_ids, labels=None):
        """Logits ``(b, s, vocab)`` when ``labels`` is None, else ``(loss,
        logits)``: the mean cross-entropy of position t against
        ``labels[:, t + 1]``, plus ``moe_aux_weight`` times the sum of the
        MoE layers' aux.  With ``fused_lm_loss`` and a sequence that a
        multiple of 128 divides, the loss comes from the chunked
        :func:`linear_softmax_cross_entropy` and the logits slot is None.
        Under mp the head is vocab-parallel (the logits gathered when no
        labels are given)."""
        c = self.config
        with collect_aux_losses() as aux_losses:
            hidden = self.gpt(input_ids)
        if labels is None:
            table = self.gpt.wte.weight.to(hidden.dtype)
            return gather_from_mp(torch.matmul(copy_to_mp(hidden),
                                               table.t()))
        loss, logits = self.lm_loss(hidden, shift_labels(labels))
        if aux_losses:
            loss = loss + c.moe_aux_weight * sum(aux_losses)
        return loss, logits

    def lm_loss(self, hidden, shifted, reduction: str = "mean"):
        """``(loss, logits)`` of the tied head on final hidden states
        against shifted labels: the chunked fused loss (logits None) when
        ``fused_lm_loss`` and the sequence allow it, else the logits
        (this rank's vocabulary block under mp) and their
        cross-entropy."""
        c = self.config
        table = self.gpt.wte.weight.to(hidden.dtype)
        if c.fused_lm_loss and _lce_chunk(hidden.shape[1]) is not None:
            return linear_softmax_cross_entropy(
                hidden, table, shifted, reduction=reduction), None
        logits = torch.matmul(copy_to_mp(hidden), table.t())
        return parallel_cross_entropy(logits.float(), shifted,
                                      reduction=reduction), logits

    def build_pipeline(self, num_stages: int, num_microbatches: int):
        """The pipeline wrapper of this stage (``fleet.distributed_model``
        returns it when pp > 1; reference fleet_base.py:1027)."""
        from .gpt_pipeline import GPTPipeline
        return GPTPipeline(self, num_stages, num_microbatches)

    @torch.no_grad()
    def generate_step(self, input_ids, caches, position_offset):
        """Single decode step over the fixed-shape caches of
        :meth:`make_caches` (the reference CacheKV path): the tied-head
        logits ``(b, 1, vocab)`` of the last position and the new caches.
        The buffers are written in place; each ``used`` comes back advanced
        as a new tensor.  ``position_offset`` may be a device tensor."""
        hidden, new_caches = self.gpt(input_ids,
                                      position_offset=position_offset,
                                      caches=caches)
        table = self.gpt.wte.weight.to(hidden.dtype)
        logits = torch.matmul(hidden[:, -1:], table.t())
        return logits, new_caches

    def serving_step(self, input_ids, caches, position_offset, last_index):
        """One serving-engine step over paged caches: run the stack, take
        the hidden state at ``last_index`` per row (the last real token of
        a padded prefill chunk; 0 for decode) and return its tied-head
        logits ``(b, vocab)`` with the caches."""
        hidden, new_caches = self.gpt(input_ids,
                                      position_offset=position_offset,
                                      caches=caches)
        b = hidden.shape[0]
        idx = torch.as_tensor(last_index, device=hidden.device).long()
        idx = idx.expand(b) if idx.dim() == 0 else idx
        h_last = hidden[torch.arange(b, device=hidden.device), idx]
        table = self.gpt.wte.weight.to(h_last.dtype)
        logits = torch.matmul(h_last, table.t())
        return logits, new_caches

    def make_caches(self, batch_size: int, max_length: int):
        """Fixed-shape KV caches, one ``(k_buf, v_buf, used)`` triple per
        layer: zeroed ``(batch, heads, max_length, head_dim)`` buffers in
        the activation dtype and ``used`` a 0-d int32 tensor, all on the
        model's device, so every decode step has the same shapes."""
        c = self.config
        shape = (batch_size, c.num_heads, max_length, c.head_dim)
        dev = self.device
        return [(torch.zeros(shape, dtype=c.torch_dtype, device=dev),
                 torch.zeros(shape, dtype=c.torch_dtype, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev))
                for _ in range(c.num_layers)]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None):
        """Autoregressive decoding over fixed-shape caches: the prompt as one
        prefill step, then one single-token step per new token (captured
        once as a CUDA graph on the card and replayed, see
        :meth:`_gen_step`).  ``temperature`` 0 is greedy; otherwise
        sampling, cut to the ``top_k`` largest logits when ``top_k > 0``.
        The sampling stream is seeded with ``seed``, else with one draw from
        ``generator``, else from the framework's stream (JAX's keys give
        other numbers, so sampled tokens are reproducible per seed but are
        not JAX's).  Rows that emit ``eos_token_id`` stay pinned to it, and
        decoding stops once every row has; without it the loop makes no
        host sync.  Returns the prompt and the new tokens, int32 ``(b,
        prompt_len + n)``."""
        c = self.config
        enforce(topo.get_mesh() is None,
                "generate runs on one card: a model built under a hybrid "
                "group holds one rank's shard")
        self.eval()
        ids = torch.as_tensor(input_ids).to(device=self.device,
                                            dtype=torch.int32)
        b, prompt_len = ids.shape
        if max_new_tokens <= 0:
            return ids
        total = prompt_len + max_new_tokens
        enforce(total <= c.max_position_embeddings,
                f"{total} positions exceed max_position_embeddings "
                f"({c.max_position_embeddings})")
        loop = self._gen_step(float(temperature), int(top_k), b, total)
        loop.reset(_sampling_seed(seed, generator) if temperature > 0.0
                   else 0)
        nxt = loop.prefill(self, ids)
        out = [ids, nxt[:, None]]
        finished = None if eos_token_id is None else nxt == eos_token_id
        for _ in range(1, max_new_tokens):
            nxt = loop.decode(self)
            if finished is not None:
                # finished rows stay pinned to EOS, and the pinned token is
                # what the next step reads
                nxt = torch.where(finished, torch.full_like(nxt, eos_token_id),
                                  nxt)
                loop.tokens.copy_(nxt[:, None])
                finished = finished | (nxt == eos_token_id)
            out.append(nxt[:, None])
            if finished is not None and bool(finished.all()):
                break
        return torch.cat(out, dim=1)

    def _gen_step(self, temperature: float, top_k: int, batch: int,
                  capacity: int) -> "_DecodeLoop":
        """The decode loop of one ``(batch, capacity, temperature, top_k)``:
        its caches, token buffer and sampling stream, and on the card the
        CUDA graph of its single-token step, captured at the first decode
        step and replayed after (the counterpart of the JAX package's
        cached ``jax.jit``).  The instance keeps the loop of the last key
        only: a loop holds caches for the whole batch's context, so a call
        with another key frees it and builds (and captures) its own."""
        key = (batch, capacity, temperature, top_k)
        if self._gen_loop is None or self._gen_loop.key != key:
            self._gen_loop = None                   # free the old caches
            self._gen_loop = _DecodeLoop(key,
                                         self.make_caches(batch, capacity))
        return self._gen_loop


def _sampling_seed(seed: Optional[int],
                   generator: Optional[torch.Generator]) -> int:
    if seed is not None:
        return int(seed)
    if generator is not None:
        return int(torch.randint(0, 2 ** 62, (), generator=generator,
                                 device=generator.device))
    return fw_random.draw_seed()


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            generator: torch.Generator) -> torch.Tensor:
    """Next tokens, int32 ``(b,)``, from float32 ``(b, vocab)`` logits:
    argmax when ``temperature <= 0``; otherwise Gumbel-max over
    ``logits / temperature`` (how ``jax.random.categorical`` draws), with
    every logit below the ``top_k``-th largest set to -inf."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth,
                             torch.full((), -math.inf, device=scaled.device),
                             scaled)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    return torch.argmax(scaled - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


class _DecodeLoop:
    """The state of :meth:`GPTForCausalLM.generate` for one ``(batch,
    capacity, temperature, top_k)``: the fixed-shape caches, a ``(b, 1)``
    int32 token buffer and a sampling generator on the model's device.

    A step reads its input from the caches and the buffer and leaves its
    result there: it writes k/v at ``used``, samples the next tokens into
    the buffer and advances every ``used`` in place, with the position
    offset read from ``used`` on the device.  So on the card the
    single-token step is captured once as a CUDA graph and every later
    step is a replay, with no Python and no host sync; the flash decode
    kernel reads the length the graph computed.  The generator is
    registered with the graph, so each replay draws fresh noise.  The
    first decode step runs eagerly on a side stream before the capture
    (it sets up what the capture needs: the kernel libraries, cuBLAS
    workspaces); a capture that fails raises.  Prefill runs eagerly, and
    on the CPU every step does.

    The model is passed to each step and never kept: the model owns its
    loop, so dropping the model frees the caches and the graph's pool.
    ``marks``, when a list, receives a recorded CUDA event before the
    prefill and after every step, for measurement scripts."""

    def __init__(self, key: Tuple[int, int, float, int],
                 caches: List[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]):
        self.key = key
        batch, _, self.temperature, self.top_k = key
        self.caches = caches
        device = caches[0][2].device
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=device)
        self.generator = torch.Generator(device=device)
        self.graph = None
        self.recorded: Dict[str, int] = {}
        self.marks: Optional[List[torch.cuda.Event]] = None

    def reset(self, seed: int) -> None:
        for k_buf, v_buf, used in self.caches:
            k_buf.zero_()
            v_buf.zero_()
            used.zero_()
        self.generator.manual_seed(seed)

    def _mark(self) -> None:
        if self.marks is not None:
            self.marks.append(torch.cuda.Event(enable_timing=True))
            self.marks[-1].record()

    def _step(self, model: GPTForCausalLM, chunk: torch.Tensor) -> None:
        logits, new_caches = model.generate_step(chunk, self.caches,
                                                 self.caches[0][2])
        nxt = _sample(logits[:, -1].float(), self.temperature, self.top_k,
                      self.generator)
        for (_, _, used), (_, _, new_used) in zip(self.caches, new_caches):
            used.copy_(new_used)
        self.tokens.copy_(nxt[:, None])

    def prefill(self, model: GPTForCausalLM,
                ids: torch.Tensor) -> torch.Tensor:
        self._mark()
        self._step(model, ids)
        self._mark()
        return self.tokens[:, 0].clone()

    def decode(self, model: GPTForCausalLM) -> torch.Tensor:
        if not self.tokens.is_cuda:
            self._step(model, self.tokens)
        elif self.graph is None:
            self._capture(model)
        else:
            _kernels.replay(self.graph, self.recorded)
        self._mark()
        return self.tokens[:, 0].clone()

    def _capture(self, model: GPTForCausalLM) -> None:
        """Capture the single-token step; one ``compile`` record of the
        compile tracker (function ``generate.decode_step``), keyed by the
        loop's ``(batch, capacity, temperature, top_k)``, so a capture
        for a new key is a retrace whose diff names what changed."""
        from ..observability.compilation import get_tracker
        t0 = time.perf_counter()
        dev = self.tokens.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step(model, self.tokens)     # this step, eagerly
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        self.recorded = _kernels.capture(
            graph, lambda: self._step(model, self.tokens))
        self.graph = graph
        get_tracker().observe("generate.decode_step", list(self.key),
                              arg_names=["batch", "capacity",
                                         "temperature", "top_k"],
                              wall_ms=(time.perf_counter() - t0) * 1e3)


# -- standard configs (the JAX package's table) ------------------------------
def _cfg(defaults: Dict[str, Any], kw: Dict[str, Any]) -> GPTConfig:
    return GPTConfig(**{**defaults, **kw})


def gpt_tiny(**kw) -> GPTConfig:
    return _cfg(dict(hidden_size=128, num_layers=2, num_heads=4,
                     max_position_embeddings=256, vocab_size=1024), kw)


def gpt_125m(**kw) -> GPTConfig:
    return _cfg(dict(hidden_size=768, num_layers=12, num_heads=12), kw)


def gpt_350m(**kw) -> GPTConfig:
    return _cfg(dict(hidden_size=1024, num_layers=24, num_heads=16), kw)


def gpt_1p3b(**kw) -> GPTConfig:
    return _cfg(dict(hidden_size=2048, num_layers=24, num_heads=16,
                     max_position_embeddings=2048), kw)


def gpt_6p7b(**kw) -> GPTConfig:
    return _cfg(dict(hidden_size=4096, num_layers=32, num_heads=32,
                     max_position_embeddings=2048), kw)
