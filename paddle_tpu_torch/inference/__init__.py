"""Serving: paged KV cache, continuous-batching scheduler, ragged paged
attention, the ServingEngine, and the ``paddle.inference`` facade (the
port of ``paddle_tpu/inference/__init__.py``).

The facade keeps the reference's call shapes (``Config`` /
``create_predictor`` / input handles / ``run()`` / output handles) over
the serving engine: ``Config.enable_continuous_batching`` plus
``set_decoder_model`` routes a predictor onto :class:`ServingEngine`, and
each batch row becomes a ragged engine request.  A ``Predictor`` over a
``jit.save`` artifact is not ported yet and raises (ROADMAP Queue 1 item
12: ``jit`` export).  :mod:`.fleet` is the serving fleet above the engine
(router, journal, replicas, autoscaler).
"""
from __future__ import annotations

import enum as _enum
from typing import Any, Dict, List, Optional

import numpy as np

from ..framework.errors import UnimplementedError, enforce
from .engine import CollectTimeout, ServingEngine
from .kv_cache import BlockAllocator, PagedKVCache, PagedLayerCache
from .paged_attention import (paged_attention, paged_attention_cuda,
                              paged_attention_reference)
from .scheduler import ContinuousBatchingScheduler

__all__ = ["Config", "Predictor", "EnginePredictor", "create_predictor",
           "DataType", "PlaceType", "PrecisionType", "get_version",
           "PredictorPool", "ServingEngine", "CollectTimeout",
           "BlockAllocator", "PagedKVCache", "PagedLayerCache",
           "ContinuousBatchingScheduler", "paged_attention",
           "paged_attention_cuda", "paged_attention_reference"]


class Config:
    """≙ paddle.inference.Config(model_dir)."""

    def __init__(self, model_dir: Optional[str] = None):
        self._model_dir = model_dir
        self._cb_enabled = False
        self._cb_max_seqs: Optional[int] = None
        self._cb_kv_block_size: Optional[int] = None
        self._decoder_model = None
        self._max_new_tokens = 32
        self._eos_token_id: Optional[int] = None
        self._pad_token_id: Optional[int] = None

    def set_model(self, model_dir: str) -> None:
        self._model_dir = model_dir

    def model_dir(self) -> str:
        return self._model_dir

    def disable_gpu(self) -> None:
        """Source-compatibility no-op: the engine runs on the device of
        the model given to :meth:`set_decoder_model`."""

    def enable_memory_optim(self) -> None:  # the caching allocator's job
        pass

    def switch_ir_optim(self, _=True) -> None:  # no pass pipeline to switch
        pass

    def enable_continuous_batching(self, max_seqs: Optional[int] = None,
                                   kv_block_size: Optional[int] = None
                                   ) -> None:
        """Route this config's predictor onto the paged-KV
        :class:`ServingEngine` (decoder models only — attach one with
        :meth:`set_decoder_model`)."""
        self._cb_enabled = True
        self._cb_max_seqs = max_seqs
        self._cb_kv_block_size = kv_block_size

    def continuous_batching_enabled(self) -> bool:
        return self._cb_enabled

    def set_decoder_model(self, model, max_new_tokens: int = 32,
                          eos_token_id: Optional[int] = None,
                          pad_token_id: Optional[int] = None) -> None:
        """Attach a decoder model (``GPTForCausalLM``) for the
        continuous-batching path."""
        self._decoder_model = model
        self._max_new_tokens = int(max_new_tokens)
        self._eos_token_id = eos_token_id
        self._pad_token_id = pad_token_id


class Predictor:
    """≙ AnalysisPredictor over a saved program.  The port has no
    ``jit.save`` artifact to load yet (ROADMAP Queue 1 item 12), so this
    raises; decoder models serve through ``enable_continuous_batching``."""

    def __init__(self, config: Config):
        raise UnimplementedError(
            "Predictor over a jit.save artifact is not ported (ROADMAP "
            "Queue 1 item 12); use Config.enable_continuous_batching() "
            "with set_decoder_model(model)")


class _Handle:
    def __init__(self, store: Dict[str, Any], name: str):
        self._store, self._name = store, name

    def copy_from_cpu(self, arr) -> None:
        self._store[self._name] = np.asarray(arr)

    def reshape(self, shape) -> None:  # source-compat no-op
        pass


class _OutHandle:
    def __init__(self, outputs: List[Any], idx: int):
        self._outputs, self._idx = outputs, idx

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._outputs[self._idx])


class EnginePredictor:
    """Reference predictor call shapes over the serving engine: a batch
    ``run()`` submits every row as a ragged request (trailing pad
    stripped), drives the engine to completion, and pads prompt +
    continuation back into one ``(batch, max_len)`` int64 output."""

    def __init__(self, config: Config):
        enforce(config._decoder_model is not None,
                "enable_continuous_batching needs set_decoder_model(model)")
        self._config = config
        self.engine = ServingEngine(config._decoder_model,
                                    max_seqs=config._cb_max_seqs,
                                    kv_block_size=config._cb_kv_block_size)
        self._input_names = ["input_ids"]
        self._inputs: Dict[str, Any] = {}
        self._outputs: List[Any] = []

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> _Handle:
        return _Handle(self._inputs, name)

    def run(self) -> None:
        cfg = self._config
        ids = np.asarray(self._inputs["input_ids"])
        enforce(ids.ndim == 2, f"input_ids must be (batch, len), "
                f"got {ids.shape}")
        prompts = []
        for row in ids:
            toks = [int(t) for t in row]
            if cfg._pad_token_id is not None:
                while toks and toks[-1] == cfg._pad_token_id:
                    toks.pop()
            prompts.append(toks)
        outs = self.engine.generate(prompts,
                                    max_new_tokens=cfg._max_new_tokens,
                                    eos_token_id=cfg._eos_token_id)
        full = [p + o for p, o in zip(prompts, outs)]
        width = max(len(f) for f in full)
        pad = cfg._pad_token_id if cfg._pad_token_id is not None else 0
        out = np.full((len(full), width), pad, np.int64)
        for i, f in enumerate(full):
            out[i, :len(f)] = f
        self._outputs = [out]

    def get_output_names(self) -> List[str]:
        return [f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name: str) -> _OutHandle:
        return _OutHandle(self._outputs, int(name.split("_")[-1]))


def create_predictor(config: Config):
    if config.continuous_batching_enabled():
        return EnginePredictor(config)
    return Predictor(config)


class DataType(_enum.Enum):
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    INT8 = "int8"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    BOOL = "bool"


class PlaceType(_enum.Enum):
    CPU = "cpu"
    GPU = "gpu"
    XPU = "xpu"
    UNK = "unk"


class PrecisionType(_enum.Enum):
    Float32 = "float32"
    Half = "float16"
    Int8 = "int8"


def get_version() -> str:
    from .. import __version__
    return __version__


class PredictorPool:
    """Reference PredictorPool(config, size): ``size`` independent
    predictors (each with its own engine and KV pool)."""

    def __init__(self, config: Config, size: int = 1):
        self._predictors = [create_predictor(config) for _ in range(size)]

    def retrive(self, idx: int):   # reference spelling
        return self._predictors[idx]

    retrieve = retrive


# -- the serving fleet (router, journal, replicas, autoscaler) --------------
from . import fleet  # noqa: E402

__all__ += ["fleet"]
