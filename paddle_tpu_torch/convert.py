"""Weights from the JAX package into the port.

The port keeps the JAX package's parameter names and layouts (Linear
weights are (in, out), the tied embedding is (vocab, hidden)), so a JAX
model's ``state_dict()`` converted to numpy maps key for key:

    np_state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    load_jax_state(torch_model, np_state)

Nothing here imports JAX: the input is plain numpy.
"""
from __future__ import annotations

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
           "GENERATE_NEW_TOKENS"]


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


def load_jax_state(model: nn.Module, np_state: Dict[str, np.ndarray]
                   ) -> nn.Module:
    """Load a numpy JAX ``state_dict`` into ``model`` in place (strict: no
    key may be missing or extra, and shapes must agree)."""
    own = model.state_dict()
    missing = sorted(set(own) - set(np_state))
    extra = sorted(set(np_state) - set(own))
    enforce(not missing and not extra,
            f"state_dict mismatch: missing={missing}, unexpected={extra}")
    for key, value in np_state.items():
        enforce(tuple(own[key].shape) == tuple(np.shape(value)),
                f"shape mismatch for {key}: {tuple(np.shape(value))} vs "
                f"{tuple(own[key].shape)}")
    device = next(model.parameters()).device
    model.load_state_dict(state_dict_from_jax(np_state, device), strict=True)
    return model


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
                      parameters=model.parameters())
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


def random_state(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random weights for ``model`` as a numpy ``state_dict`` in the
    JAX package's layout (what :func:`load_jax_state` takes): LayerNorm
    gains ``1 + 0.05 N(0, 1)``, every other parameter ``0.02 N(0, 1)``
    (the GPT configs' initializer range)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, p in model.state_dict().items():
        a = rng.standard_normal(tuple(p.shape), dtype=np.float32)
        is_gain = key.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        out[key] = 1.0 + 0.05 * a if is_gain else 0.02 * a
    return out
