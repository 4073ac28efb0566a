"""Weights and optimizer states from the JAX package into the port, and the
workloads that ``chip_smoke.py`` and the profilers drive.

The port keeps the JAX package's parameter names and layouts (Linear
weights are (in, out), the tied embedding is (vocab, hidden)), so a JAX
model's ``state_dict()`` converted to numpy maps key for key:

    np_state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    load_jax_state(torch_model, np_state)

A JAX optimizer state (``opt.init`` / ``apply_gradients``: ``step``,
``slots``, ``master``, keyed by the same names) maps onto the port
optimizer's ``state_dict`` with :func:`optimizer_state_from_jax` and back
with :func:`optimizer_state_to_jax`, so a JAX run's checkpoint resumes in
the port.  Nothing here imports JAX: the input is plain numpy.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .framework.errors import enforce

__all__ = ["state_dict_from_jax", "load_jax_state", "random_state",
           "serving_workload", "SERVING_SEED", "SERVING_ENGINE",
           "SERVING_NEW_TOKENS", "training_workload", "TRAINING_SEED",
           "TRAINING_BATCH", "TRAINING_SEQ", "fused_training_workload",
           "FUSED_TRAINING_DROPOUT", "generate_workload",
           "GENERATE_SEED", "GENERATE_BATCH", "GENERATE_PROMPT",
           "GENERATE_NEW_TOKENS", "init_random_", "pretraining_workload",
           "PRETRAINING_SEED", "PRETRAINING_BATCH", "PRETRAINING_SEQ",
           "PRETRAINING_WARMUP", "PRETRAINING_T_MAX",
           "bert_pretraining_workload", "BERT_BATCH", "BERT_SEQ",
           "BERT_MASK_RATE", "moe_training_workload",
           "optimizer_state_from_jax", "optimizer_state_to_jax",
           "resnet_training_workload", "lenet_training_workload",
           "VISION_SEED", "RESNET_BATCH", "RESNET_HW", "LENET_BATCH",
           "vision_training_workload", "VISION_BATCH", "VISION_HW",
           "transformer_training_workload", "translation_recipe",
           "TRANSFORMER_SEED", "TRANSFORMER_VOCAB", "TRANSFORMER_BATCH",
           "TRANSFORMER_SEQ", "program_state_from_jax", "shard_state",
           "gather_state", "MP_SPLIT"]


def state_dict_from_jax(np_state: Dict[str, np.ndarray],
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX ``state_dict`` held as numpy:
    same keys, same shapes, same dtypes, on ``device``.  None means
    ``cuda``, as for every entry point of the port
    (:func:`device.resolve_device`): without a card it raises
    ``UnavailableError``; pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for key, value in np_state.items():
        arr = np.ascontiguousarray(np.asarray(value))
        out[key] = torch.from_numpy(arr.copy()).to(dev)
    return out


# the parameters split over mp, by name suffix: the axis each rank takes a
# contiguous block of (the JAX layers' PartitionSpecs: ColumnParallelLinear
# P(None, 'mp'), RowParallelLinear P('mp', None), VocabParallelEmbedding
# P('mp', None)); every other parameter is whole on every mp rank
MP_SPLIT = {"wte.weight": 0, "qkv_proj.weight": 1, "qkv_proj.bias": 0,
            "out_proj.weight": 0, "fc_in.weight": 1, "fc_in.bias": 0,
            "fc_out.weight": 0}
_LAYER = re.compile(r"^gpt\.h\.(\d+)\.")


def _mp_axis(key: str) -> Optional[int]:
    for suffix, axis in MP_SPLIT.items():
        if key.endswith(suffix):
            return axis
    return None


def _on_stage(key: str, stage: int, pp: int, num_layers: int) -> bool:
    """Whether pipeline stage ``stage`` of ``pp`` holds ``key``: its
    uniform cut of the layers (the JAX ``stack_stage_params``), the
    embeddings on stage 0, the final LN on the last, the tied table on
    both."""
    m = _LAYER.match(key)
    if m:
        per = num_layers // pp
        return int(m.group(1)) // per == stage
    if key.startswith("gpt.wte."):
        return stage in (0, pp - 1)
    if key.startswith("gpt.wpe"):
        return stage == 0
    if key.startswith("gpt.ln_f."):
        return stage == pp - 1
    return True


def shard_state(state, *, mp_rank: int = 0, mp: int = 1, pp_rank: int = 0,
                pp: int = 1, device=None) -> Dict[str, torch.Tensor]:
    """One rank's shard of a whole GPT state (numpy arrays, as a JAX
    ``state_dict``, or tensors), for a model built under a hybrid group at
    coordinates (``mp_rank`` of ``mp``, stage ``pp_rank`` of ``pp``):
    the :data:`MP_SPLIT` parameters' ``mp_rank``-th block, the others
    whole, and only the keys the stage holds.  :func:`gather_state` is its
    inverse."""
    layers = {int(m.group(1)) for m in map(_LAYER.match, state) if m}
    num_layers = max(layers) + 1 if layers else 0
    enforce(num_layers % pp == 0,
            f"{num_layers} layers not divisible into {pp} stages")
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if not _on_stage(key, pp_rank, pp, num_layers):
            continue
        t = value if torch.is_tensor(value) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(value)))
        axis = _mp_axis(key)
        if axis is not None and mp > 1:
            enforce(t.shape[axis] % mp == 0,
                    f"{key}: axis {axis} of {tuple(t.shape)} not divisible "
                    f"by mp = {mp}")
            t = t.chunk(mp, dim=axis)[mp_rank]
        out[key] = t.detach().to(dev).contiguous().clone()
    return out


def gather_state(shards: Dict[Tuple[int, int], Dict[str, object]]
                 ) -> Dict[str, np.ndarray]:
    """The whole state of the shards of every rank of one data-parallel
    replica, ``{(pp_rank, mp_rank): state_dict}`` (tensors or arrays):
    the :data:`MP_SPLIT` blocks concatenated in mp order, every other
    parameter taken from its lowest (stage, mp rank)."""
    mp = 1 + max(m for _, m in shards)
    out: Dict[str, np.ndarray] = {}
    for (stage, m) in sorted(shards):
        for key, value in shards[(stage, m)].items():
            if key in out:
                continue
            axis = _mp_axis(key)
            if axis is None or mp == 1:
                out[key] = _numpy(value)
                continue
            out[key] = np.concatenate(
                [_numpy(shards[(stage, r)][key]) for r in range(mp)],
                axis=axis)
    return out


def _numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        value = value.detach().float().cpu() if value.dtype == \
            torch.bfloat16 else value.detach().cpu()
        return value.numpy()
    return np.asarray(value)


def load_jax_state(model: nn.Module, np_state: Dict[str, np.ndarray]
                   ) -> nn.Module:
    """Load a numpy JAX ``state_dict`` into ``model`` in place (strict: no
    key may be missing or extra, and shapes must agree).  Buffers come
    across with the parameters in their own dtypes: BatchNorm's running
    statistics, and a quantized model's int8 ``qweight``, ``wscale`` and
    ``in_scale`` (``Int8Linear`` / ``Int8Conv2D``) and fake-quant
    ``scale``s, when the port's model was quantized the same way."""
    own = model.state_dict()
    missing = sorted(set(own) - set(np_state))
    extra = sorted(set(np_state) - set(own))
    enforce(not missing and not extra,
            f"state_dict mismatch: missing={missing}, unexpected={extra}")
    for key, value in np_state.items():
        enforce(tuple(own[key].shape) == tuple(np.shape(value)),
                f"shape mismatch for {key}: {tuple(np.shape(value))} vs "
                f"{tuple(own[key].shape)}")
    device = next(iter(own.values())).device
    model.load_state_dict(state_dict_from_jax(np_state, device), strict=True)
    return model


def _jax_slot_state(src) -> Dict[str, np.ndarray]:
    """One slot of a JAX ``static.Program``'s ``_nn_layers`` as the port
    slot's ``state_dict``: a layer's own, a ``(weight, bias)`` pair of
    parameters, a lone parameter (``weight``), or ``data_norm``'s
    accumulators."""
    def arr(p):
        return np.asarray(getattr(p, "value", p))
    if hasattr(src, "state_dict"):
        return {k: arr(v) for k, v in src.state_dict().items()}
    if isinstance(src, tuple):
        return {k: arr(p) for k, p in zip(("weight", "bias"), src)
                if p is not None}
    if hasattr(src, "value"):
        return {"weight": arr(src)}
    return {k: arr(getattr(src, k)) for k in ("size", "sum", "square_sum")}


def program_state_from_jax(program, jax_program) -> None:
    """Carry a JAX ``static.Program``'s ``static.nn`` parameters into the
    port Program's slots, by slot name.  The port program must have run
    once (its layers are made at the first run), with the same helpers in
    the same order."""
    for slot, src in jax_program._nn_layers.items():
        dst = program._nn_layers.get(slot)
        enforce(dst is not None,
                f"slot {slot!r} is not in the port program (run it once "
                f"first; it has {sorted(program._nn_layers)})")
        load_jax_state(dst, _jax_slot_state(src))


SERVING_SEED = 1234
SERVING_ENGINE = {"max_seqs": 8, "kv_block_size": 16}
SERVING_NEW_TOKENS = 32


def serving_workload(device, *, dtype: str = "bfloat16",
                     use_fused_block: bool = True
                     ) -> Tuple[nn.Module, List[List[int]]]:
    """The serving workload that ``chip_smoke.py`` and ``profile_serving``
    drive: full-width GPT-125M (12 layers, h=768, vocab 50304, dropout 0)
    on ``device`` with :func:`random_state` weights of ``SERVING_SEED``, and
    8 prompts of seeded lengths in [16, 500].  Serve it with
    ``ServingEngine(model, **SERVING_ENGINE)``, ``SERVING_NEW_TOKENS``
    greedy tokens per prompt.  Returns ``(model, prompts)``: the same
    weights and prompts in every dtype."""
    from .models.gpt import GPTForCausalLM, gpt_125m
    cfg = gpt_125m(dtype=dtype, use_fused_block=use_fused_block,
                   hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(cfg, device=device)
    load_jax_state(model, random_state(model, SERVING_SEED))
    rng = np.random.default_rng(SERVING_SEED + 1)
    lengths = rng.integers(16, 501, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    return model, prompts


TRAINING_SEED = 0
TRAINING_BATCH = 8
TRAINING_SEQ = 2048


def training_workload(device, config=None, *, batch: int = TRAINING_BATCH,
                      seq_len: int = TRAINING_SEQ):
    """The training workload that ``chip_smoke.py`` drives, at the
    configuration of the JAX package's headline bench (``bench.py``
    ``main`` / ``_build``): GPT-125M at full width and depth with bf16
    activations, dropout 0, flash attention, ``max_position_embeddings=
    2048`` and the fused LM loss; :func:`random_state` weights of
    ``TRAINING_SEED`` on ``device``; ``AdamW(learning_rate=1e-4,
    weight_decay=0.01)``; ``ids`` then ``labels`` drawn by
    ``np.random.RandomState(0).randint(0, vocab, (batch, seq_len))``.
    ``config`` replaces the model configuration (the same weights and data
    rules at another size).  Returns ``(model, optimizer, ids, labels)``;
    run it with ``training.train_step``."""
    from .models.gpt import GPTForCausalLM, gpt_125m
    from .optimizer import AdamW
    cfg = config or gpt_125m(dtype="bfloat16", hidden_dropout=0.0,
                             attention_dropout=0.0,
                             use_pallas_attention=True,
                             max_position_embeddings=2048)
    model = GPTForCausalLM(cfg, device=device)
    load_jax_state(model, random_state(model, TRAINING_SEED))
    model.train()
    optimizer = AdamW(learning_rate=1e-4, weight_decay=0.01,
                      parameters=model.named_parameters())
    rng = np.random.RandomState(0)
    dev = model.device
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq_len))
                           ).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (batch, seq_len))).to(dev)
    return model, optimizer, ids, labels


FUSED_TRAINING_DROPOUT = 0.1


def fused_training_workload(device, *, batch: int = TRAINING_BATCH,
                            seq_len: int = TRAINING_SEQ):
    """The fused-block training workload: the fused leg of the JAX
    package's fused-block A/B (``bench.py`` ``_bench_fused_block_ab``,
    ``fused=True``), which it calls its realistic training configuration:
    GPT-125M at full width and depth, bf16 activations, flash attention,
    ``use_fused_block``, ``hidden_dropout = attention_dropout = 0.1``,
    ``max_position_embeddings = seq_len``, trained under bf16 O1 with
    ``AdamW(1e-4, weight_decay=0.01)``.  The weights, data and optimizer
    are those of :func:`training_workload`.  Each block runs K1 -> flash
    -> K2, then K3, under autograd.  Returns ``(model, optimizer, ids,
    labels)``; run it with ``training.train_step``."""
    from .models.gpt import gpt_125m
    cfg = gpt_125m(dtype="bfloat16", use_pallas_attention=True,
                   use_fused_block=True,
                   hidden_dropout=FUSED_TRAINING_DROPOUT,
                   attention_dropout=FUSED_TRAINING_DROPOUT,
                   max_position_embeddings=seq_len)
    return training_workload(device, cfg, batch=batch, seq_len=seq_len)


GENERATE_SEED = 4321
GENERATE_BATCH = 8
GENERATE_PROMPT = 512
GENERATE_NEW_TOKENS = 128


def generate_workload(device, *, dtype: str = "bfloat16",
                      use_fused_block: bool = False
                      ) -> Tuple[nn.Module, torch.Tensor]:
    """The ``generate`` workload that ``chip_smoke.py`` and
    ``profile_generate`` drive: full-width GPT-125M (12 layers, h=768, 12
    heads, vocab 50304, ``max_position_embeddings=1024``, dropout 0) on
    ``device`` with :func:`random_state` weights of ``GENERATE_SEED``, and
    a ``(GENERATE_BATCH, GENERATE_PROMPT)`` int32 prompt batch drawn by
    ``np.random.default_rng(GENERATE_SEED + 1)``.  Unfused means
    ``use_pallas_attention=True`` (the flash decode kernel in the unfused
    block); fused means ``use_fused_block=True``.  Decode
    ``GENERATE_NEW_TOKENS`` greedy tokens with ``model.generate``: a cache
    capacity of 640, a multiple of 8, so every single-token step takes the
    decode kernel.  Returns ``(model, prompts)``: the same weights and
    prompts in every dtype and variant."""
    from .models.gpt import GPTForCausalLM, gpt_125m
    cfg = gpt_125m(dtype=dtype, use_fused_block=use_fused_block,
                   use_pallas_attention=not use_fused_block,
                   hidden_dropout=0.0, attention_dropout=0.0,
                   max_position_embeddings=1024)
    model = GPTForCausalLM(cfg, device=device)
    load_jax_state(model, random_state(model, GENERATE_SEED))
    rng = np.random.default_rng(GENERATE_SEED + 1)
    prompts = rng.integers(0, cfg.vocab_size,
                           (GENERATE_BATCH, GENERATE_PROMPT)).astype(np.int32)
    return model, torch.from_numpy(prompts).to(model.device)


# the LayerNorm gains of the GPT and BERT models
_GAINS = ("ln_1.weight", "ln_2.weight", "ln_f.weight", "attn_ln.weight",
          "ffn_ln.weight", "layer_norm.weight", "transform_ln.weight")


def random_state(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random weights for ``model`` as a numpy ``state_dict`` in the
    JAX package's layout (what :func:`load_jax_state` takes): LayerNorm
    gains ``1 + 0.05 N(0, 1)``, every other parameter ``0.02 N(0, 1)``
    (the GPT and BERT configs' initializer range)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, p in model.state_dict().items():
        a = rng.standard_normal(tuple(p.shape), dtype=np.float32)
        out[key] = 1.0 + 0.05 * a if key.endswith(_GAINS) else 0.02 * a
    return out


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """The rule of :func:`random_state` (LayerNorm gains ``1 + 0.05 N(0,
    1)``, every other parameter ``0.02 N(0, 1)``), drawn in place on the
    model's device from a ``torch.Generator`` seeded with ``seed``: other
    numbers than :func:`random_state`'s, made on the card, where the
    host's numpy draw takes tens of seconds for a billion parameters."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for key, p in model.state_dict().items():
            a = torch.randn(p.shape, generator=gen, device=device,
                            dtype=torch.float32)
            p.copy_(1.0 + 0.05 * a if key.endswith(_GAINS) else 0.02 * a)
    return model


PRETRAINING_SEED = 13
PRETRAINING_BATCH = 4
PRETRAINING_SEQ = 2048
# the recipe's schedule, cut to a smoke's few steps (GPT-3: 375M tokens of
# warmup, cosine decay over 260B tokens)
PRETRAINING_WARMUP = 2
PRETRAINING_T_MAX = 8


def pretraining_workload(device, config=None, *, leg: str = "A",
                         batch: int = PRETRAINING_BATCH,
                         seq_len: int = PRETRAINING_SEQ):
    """GPT-3 1.3B pretraining on one card: ``gpt_1p3b`` at full width and
    depth (24 layers, h=2048, 16 heads, vocab 50304, 2048 positions) with
    bf16 activations, flash attention and ``use_recompute``, weights by
    :func:`init_random_` (``PRETRAINING_SEED``) on ``device``, and ``ids``
    then ``labels`` drawn by ``np.random.RandomState(0).randint(0, vocab,
    (batch, seq_len))``.

    - ``leg="A"``: the JAX bench's 1.3B full step (``bench.py``
      ``_bench_1p3b_fullstep``: dropout 0) under bf16 O1 with ``_build``'s
      ``AdamW(1e-4, weight_decay=0.01)``;
    - ``leg="B"``: the pretraining recipe of the GPT-3 paper's 1.3B row:
      dropout 0.1, ``amp.decorate`` O2 (bf16 parameters, float32 masters),
      a ``GradScaler`` that backs off at the first overflow,
      ``ClipGradByGlobalNorm(1.0)``, ``AdamW(beta2=0.95, epsilon=1e-8,
      weight_decay=0.1)`` on the 2-D weights only, and
      ``LinearWarmup(CosineAnnealingDecay(2e-4, PRETRAINING_T_MAX,
      eta_min=2e-5), PRETRAINING_WARMUP, 0, 2e-4)``.

    ``config`` replaces the model configuration (the same rules at another
    size).  Returns ``(model, optimizer, ids, labels, step_kwargs)``: run
    it with ``training.train_step(model, optimizer, ids, labels,
    **step_kwargs)``."""
    from . import amp
    from .models.gpt import GPTForCausalLM, gpt_1p3b
    from .optimizer import AdamW, ClipGradByGlobalNorm
    from .optimizer.lr import CosineAnnealingDecay, LinearWarmup
    enforce(leg in ("A", "B"), f"leg must be 'A' or 'B', got {leg!r}")
    drop = 0.0 if leg == "A" else 0.1
    cfg = config or gpt_1p3b(vocab_size=50304, hidden_dropout=drop,
                             attention_dropout=drop, use_recompute=True,
                             use_pallas_attention=True, dtype="bfloat16")
    model = init_random_(GPTForCausalLM(cfg, device=device),
                         PRETRAINING_SEED)
    model.train()
    if leg == "A":
        optimizer = AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=model.named_parameters())
        step_kwargs = {}
    else:
        two_d = {n for n, p in model.named_parameters() if p.dim() == 2}
        scheduler = LinearWarmup(
            CosineAnnealingDecay(2e-4, PRETRAINING_T_MAX, eta_min=2e-5),
            PRETRAINING_WARMUP, start_lr=0.0, end_lr=2e-4)
        optimizer = AdamW(learning_rate=scheduler, beta1=0.9, beta2=0.95,
                          epsilon=1e-8, weight_decay=0.1,
                          grad_clip=ClipGradByGlobalNorm(1.0),
                          parameters=model.named_parameters(),
                          apply_decay_param_fun=two_d.__contains__)
        model, optimizer = amp.decorate(model, optimizer, level="O2",
                                        dtype="bfloat16")
        step_kwargs = {"level": "O2", "scheduler": scheduler,
                       "scaler": amp.GradScaler(decr_every_n_nan_or_inf=1)}
    rng = np.random.RandomState(0)
    dev = model.device
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq_len))
                           ).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (batch, seq_len))).to(dev)
    return model, optimizer, ids, labels, step_kwargs


BERT_BATCH = 16
BERT_SEQ = 512
BERT_MASK_RATE = 0.15


def bert_pretraining_workload(device, config=None, *,
                              batch: int = BERT_BATCH,
                              seq_len: int = BERT_SEQ):
    """BERT-base pretraining as the JAX package's bench row
    (``bench.py`` ``_bench_bert_base``): ``bert_base`` at full width and
    depth (12 layers, h=768, 12 heads, vocab 30528) with bf16
    activations, dropout 0 and the non-causal flash attention, MLM with
    15% of positions masked plus NSP, ``AdamW(learning_rate=1e-4,
    weight_decay=0.01)`` under bf16 O1; :func:`random_state` weights of
    ``TRAINING_SEED`` on ``device``.  The data is the bench's, drawn in its
    order from ``np.random.RandomState(0)``: ``ids`` ``randint(0, vocab,
    (batch, seq_len))``, the mask ``rand(batch, seq_len) < 0.15``, MLM
    labels ``randint(0, vocab, (batch, seq_len))`` where masked and -100
    elsewhere, NSP labels ``randint(0, 2, (batch,))``.  ``config``
    replaces the model configuration.  Returns ``(model, optimizer, ids,
    inputs)``, ``inputs`` the labels as keywords: run it with
    ``training.train_step(model, optimizer, ids, **inputs)``."""
    from .models.bert import BertForPretraining, bert_base
    from .optimizer import AdamW
    cfg = config or bert_base(dtype="bfloat16", hidden_dropout=0.0,
                              attention_dropout=0.0,
                              use_pallas_attention=True)
    model = BertForPretraining(cfg, device=device)
    load_jax_state(model, random_state(model, TRAINING_SEED))
    model.train()
    optimizer = AdamW(learning_rate=1e-4, weight_decay=0.01,
                      parameters=model.named_parameters())
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq_len))
    mask = rng.rand(batch, seq_len) < BERT_MASK_RATE
    mlm = np.where(mask, rng.randint(0, cfg.vocab_size, (batch, seq_len)),
                   -100)
    nsp = rng.randint(0, 2, (batch,))
    dev = model.device
    inputs = {"mlm_labels": torch.from_numpy(mlm).to(dev),
              "nsp_labels": torch.from_numpy(nsp).to(dev)}
    return model, optimizer, torch.from_numpy(ids).to(dev), inputs


def moe_training_workload(device, config=None, *,
                          batch: int = TRAINING_BATCH,
                          seq_len: int = TRAINING_SEQ):
    """The MoE GPT of the JAX package's ``moe`` bench scenario
    (``paddle_tpu/bench/scenarios.py`` ``moe``): GPT-125M at full width
    and depth with 8 experts on every other layer (6 MoE layers), GShard
    top-2 gating at capacity factor 2.0, aux weight 0.01, bf16
    activations, flash attention, dropout 0, 2048 positions, B=8, S=2048;
    trained under bf16 O1 with ``AdamW(1e-4, weight_decay=0.01)``, the
    weights, data and optimizer of :func:`training_workload`.  Returns
    ``(model, optimizer, ids, labels)``; run it with
    ``training.train_step``."""
    from .models.gpt import gpt_125m
    cfg = config or gpt_125m(dtype="bfloat16", hidden_dropout=0.0,
                             attention_dropout=0.0,
                             use_pallas_attention=True,
                             max_position_embeddings=2048,
                             moe_num_experts=8, moe_every=2)
    return training_workload(device, cfg, batch=batch, seq_len=seq_len)


VISION_SEED = 0
RESNET_BATCH = 128
RESNET_HW = 224
LENET_BATCH = 64


def _vision_workload(make, device, batch: int, hw: int, channels: int,
                     num_classes: int, level: str):
    """The JAX vision rows' set-up (``bench.py`` ``_bench_resnet50``,
    ``scenarios.py`` ``_vision_train_payload``): the framework's streams
    seeded with ``VISION_SEED`` before the model draws its parameters from
    its own initializers, ``Momentum(learning_rate=0.1, momentum=0.9,
    weight_decay=1e-4)`` over every trainable parameter (BatchNorm's
    included), and one batch from ``np.random.RandomState(0)``: images
    ``randn(batch, channels, hw, hw) * 0.5`` as float32, then labels
    ``randint(0, num_classes, (batch,))``."""
    from .framework import random as fw_random
    from .optimizer import Momentum
    dev = resolve_device(device)
    fw_random.seed(VISION_SEED)
    model = make(dev)
    model.train()
    optimizer = Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                         parameters=model.named_parameters())
    rng = np.random.RandomState(0)
    images = (rng.randn(batch, channels, hw, hw) * 0.5).astype(np.float32)
    labels = rng.randint(0, num_classes, (batch,))
    return (model, optimizer, torch.from_numpy(images).to(dev),
            torch.from_numpy(labels).to(dev), {"level": level})


def resnet_training_workload(device=None, depth: int = 50,
                             batch: int = RESNET_BATCH, hw: int = RESNET_HW,
                             level: str = "O1"):
    """The JAX package's ResNet-50 ImageNet-config row (``bench.py``
    ``_bench_resnet50``; the ``resnet`` scenario): ``resnet<depth>``
    (``depth`` 18, 34, 50, 101 or 152) with 1000 classes on ``device``
    (None means ``cuda``), B=128 images of 224 x 224 under bf16
    ``level`` O1, Momentum with weight decay; see
    :func:`_vision_workload`.  Returns ``(model, optimizer, images,
    labels, step_kwargs)``: run it with ``training.classification_step(
    model, optimizer, images, labels, **step_kwargs)``."""
    from .vision import models
    make = {18: models.resnet18, 34: models.resnet34, 50: models.resnet50,
            101: models.resnet101, 152: models.resnet152}[depth]
    return _vision_workload(lambda dev: make(device=dev), device, batch, hw,
                            3, 1000, level)


def lenet_training_workload(device=None, batch: int = LENET_BATCH):
    """The JAX package's ``mnist`` row (``paddle_tpu/bench/scenarios.py``
    ``mnist``): ``LeNet`` with 10 classes, B=64 images of 1 x 28 x 28 in
    float32 without autocast (``level="O0"``), Momentum with weight decay,
    on ``device`` (None means ``cuda``); see :func:`_vision_workload`.  Returns ``(model, optimizer, images,
    labels, step_kwargs)`` for ``training.classification_step``."""
    from .vision.models import LeNet
    return _vision_workload(lambda dev: LeNet(device=dev), device, batch, 28,
                            1, 10, "O0")


VISION_BATCH = 128
# the families' ImageNet resolution where it is not 224 x 224
VISION_HW = {"inception_v3": 299}


def vision_training_workload(name: str, device=None, *,
                             batch: int = VISION_BATCH,
                             hw: Optional[int] = None, level: str = "O1",
                             **ctor_kw):
    """Any zoo family by its constructor's name (``"mobilenet_v2"``,
    ``"vgg16"``, ...; ``ctor_kw`` go to the constructor, e.g. ``scale`` or
    ``batch_norm``) with the JAX vision rows' set-up, as
    ``paddle_tpu/bench/scenarios.py`` ``_vision_train_payload`` applies it
    to any zoo model: see :func:`_vision_workload`.  ``hw`` defaults to
    the family's ImageNet resolution (224, 299 for ``inception_v3``); 1000
    classes unless ``num_classes`` says otherwise; bf16 ``level`` O1.
    Returns ``(model, optimizer, images, labels, step_kwargs)`` for
    ``training.classification_step``.  GoogLeNet returns three heads, which
    ``classification_step`` does not take."""
    from .vision import models
    make = getattr(models, name)
    classes = ctor_kw.get("num_classes", 1000)
    size = hw if hw is not None else VISION_HW.get(name, 224)
    return _vision_workload(lambda dev: make(device=dev, **ctor_kw), device,
                            batch, size, 3, classes, level)


TRANSFORMER_SEED = 0
TRANSFORMER_VOCAB = 30000     # WMT14's default dictionary
TRANSFORMER_BATCH = 32
TRANSFORMER_SEQ = 128


def transformer_training_workload(device=None, *,
                                  layers: Optional[int] = None,
                                  batch: int = TRANSFORMER_BATCH,
                                  seq_len: int = TRANSFORMER_SEQ,
                                  vocab: int = TRANSFORMER_VOCAB,
                                  dropout: float = 0.1):
    """Transformer-base translation training: the model of
    ``examples/seq2seq_translation.py`` (``models.translation.
    TranslationModel``) at ``nn.Transformer()``'s defaults (d_model 512, 8
    heads, 6 + 6 layers, FFN 2048, post-LN, dropout 0.1; Vaswani et al.
    2017, Table 3, "base") over ``vocab`` (WMT14's default 30000) with a
    position table of ``seq_len`` rows; ``layers`` cuts both stacks to that
    many.  Adam(beta1 0.9, beta2 0.98, epsilon 1e-9) under
    ``NoamDecay(d_model=512, warmup_steps=4000)``, the loss with label
    smoothing 0.1, bf16 O1.  Reduced from the paper: the batch
    (``batch`` x ``seq_len`` tokens a side against ~25,000) and the data,
    seeded ids from ``np.random.RandomState(TRANSFORMER_SEED)``: sources
    and targets in [3, vocab), the decoder input the target shifted right
    behind ``<s>`` (0).  Weights are drawn after
    ``framework.random.seed(TRANSFORMER_SEED)``.

    Returns ``(model, optimizer, (src, tgt_in, tgt_next), step_kwargs)``:
    run ``training.seq2seq_step(model, optimizer, src, tgt_in, tgt_next,
    **step_kwargs)``."""
    from .framework import random as fw_random
    from .models.translation import TranslationModel
    from .optimizer import Adam
    from .optimizer.lr import NoamDecay
    dev = resolve_device(device)
    fw_random.seed(TRANSFORMER_SEED)
    n = 6 if layers is None else layers
    model = TranslationModel(vocab, seq_len, num_encoder_layers=n,
                             num_decoder_layers=n, dropout=dropout,
                             device=dev)
    model.train()
    sched = NoamDecay(d_model=512, warmup_steps=4000)
    opt = Adam(learning_rate=sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
               parameters=model.named_parameters())
    rng = np.random.RandomState(TRANSFORMER_SEED)
    src = rng.randint(3, vocab, (batch, seq_len))
    tgt = rng.randint(3, vocab, (batch, seq_len))
    tgt_in = np.concatenate([np.zeros((batch, 1), np.int64), tgt[:, :-1]],
                            axis=1)
    data = tuple(torch.from_numpy(a.astype(np.int64)).to(dev)
                 for a in (src, tgt_in, tgt))
    return model, opt, data, {"level": "O1", "scheduler": sched,
                              "label_smoothing": 0.1}


RECIPE = {"vocab": 64, "length": 18, "d_model": 64, "nhead": 4,
          "layers": 2, "ffn": 128, "train_size": 2048, "gen_size": 8,
          "batch": 64, "lr": 3e-3, "epochs": 8, "beam": 3}


def translation_recipe(device=None, *, epochs: int = RECIPE["epochs"]):
    """``examples/seq2seq_translation.py`` on the port at its own size: a
    ``TranslationModel`` of vocab 64, 18 positions, d_model 64, 4 heads,
    2 + 2 layers, FFN 128, dropout 0, float32, trained by AdamW(3e-3) for
    ``epochs`` epochs over ``WMT14(dict_size=64, synthetic_size=2048)``
    through ``io.DataLoader`` (batch 64, shuffled, last batch dropped;
    ``np.random`` and the framework's streams seeded 0); then beam search
    (beam 3, the example's re-encoding cell) over the 8 ``gen`` items.
    Returns the first and last losses, every loss, and the exact matches
    of the best beam against the reference translations."""
    from .framework import random as fw_random
    from .io import DataLoader
    from .models.translation import TranslationModel, collate
    from .nn import BeamSearchDecoder, dynamic_decode
    from .optimizer import AdamW
    from .text import WMT14
    from .training import seq2seq_step
    r = RECIPE
    dev = resolve_device(device)
    np.random.seed(0)
    fw_random.seed(0)
    train = WMT14(mode="train", dict_size=r["vocab"],
                  synthetic_size=r["train_size"])
    gen = WMT14(mode="gen", dict_size=r["vocab"],
                synthetic_size=r["gen_size"])
    loader = DataLoader(train, places=dev, batch_size=r["batch"],
                        shuffle=True, drop_last=True,
                        collate_fn=lambda b: collate(b, r["length"]))
    model = TranslationModel(r["vocab"], r["length"], r["d_model"],
                             r["nhead"], r["layers"], r["layers"], r["ffn"],
                             dropout=0.0, device=dev)
    opt = AdamW(learning_rate=r["lr"], parameters=model.named_parameters())
    losses = []
    for _ in range(epochs):
        for src, tin, tnx in loader:
            losses.append(seq2seq_step(model, opt, src, tin, tnx,
                                       level="O0"))
    model.eval()
    exact, hyps = 0, []
    with torch.no_grad():
        for i in range(len(gen)):
            s, _, tn = gen[i]
            src = torch.from_numpy(np.pad(
                s, (0, r["length"] - len(s)),
                constant_values=2)[None]).to(dev)
            dec = BeamSearchDecoder(model.reencode_cell(), start_token=0,
                                    end_token=1, beam_size=r["beam"])
            seqs, _ = dynamic_decode(
                dec, inits={"src": src, "prefix": torch.zeros(
                    (1, 0), dtype=torch.int64, device=dev)},
                max_step_num=len(s) + 2)
            got = seqs[0, 0].cpu().numpy()[:len(tn)]
            hyps.append(got.tolist())
            exact += int(np.array_equal(got, tn))
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "exact": exact, "items": len(gen),
            "hypotheses": hyps}


def _to_tensor(value, device) -> torch.Tensor:
    """A numpy array (bfloat16 by its bits) or tensor as a tensor on
    ``device``."""
    if torch.is_tensor(value):
        return value.to(device)
    arr = np.ascontiguousarray(np.asarray(value))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def optimizer_state_from_jax(jax_state, optimizer) -> None:
    """Load a JAX optimizer state (``{"step", "slots", "master"}`` of numpy
    arrays, keyed by the parameter names the port optimizer was built with,
    e.g. as ``load_sharded`` of either package returns it) into the port
    ``optimizer``.  A None or absent master means the parameter has none."""
    dev = optimizer._params[0].device
    masters = jax_state.get("master") or {}
    optimizer.set_state_dict({"state": {
        "step": _to_tensor(jax_state["step"], dev),
        "slots": {n: {k: _to_tensor(v, dev)
                      for k, v in dict(jax_state["slots"].get(n) or {}
                                       ).items()}
                  for n in optimizer._names},
        "master": {n: None if masters.get(n) is None
                   else _to_tensor(masters[n], dev)
                   for n in optimizer._names}}})


def optimizer_state_to_jax(optimizer) -> Dict[str, object]:
    """The port optimizer's state as a JAX optimizer state of numpy arrays
    (``step`` int32, ``slots`` and ``master`` float32, None for a parameter
    without a master; a rule without slots gives ``()``, as the JAX
    ``_init_slot``), for the JAX ``apply_gradients`` or ``save_sharded``."""
    state = optimizer.state_dict()["state"]

    def host(t):
        return t.detach().cpu().numpy()
    return {"step": host(state["step"]),
            "slots": {n: ({k: host(v) for k, v in s.items()} if s else ())
                      for n, s in state["slots"].items()},
            "master": {n: None if m is None else host(m)
                       for n, m in state["master"].items()}}
