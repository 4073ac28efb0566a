"""High-level API: the port of ``paddle_tpu/hapi`` (reference:
python/paddle/hapi): ``Model`` with ``prepare`` / ``fit`` / ``evaluate`` /
``predict`` / ``save`` / ``load``, the callbacks, ``flops`` and
``summary``."""
from . import callbacks  # noqa: F401
from .flops import flops, summary  # noqa: F401
from .model import Model  # noqa: F401
from .callbacks import (Callback, CallbackList,  # noqa: F401
                        ProgBarLogger, ModelCheckpoint,
                        EarlyStopping, LRScheduler)
