"""``paddle.callbacks``: the port of ``paddle_tpu/callbacks.py``, a
re-export of the ``hapi`` callback classes."""
from .hapi.callbacks import (  # noqa: F401
    Callback, CallbackList, EarlyStopping, LRScheduler, ModelCheckpoint,
    ProgBarLogger)

__all__ = ["Callback", "CallbackList", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger"]
