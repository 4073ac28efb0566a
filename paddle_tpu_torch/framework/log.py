"""VLOG-style logging: the port's own copy of ``paddle_tpu/framework/
log.py`` (glog ``VLOG(n)``, fluid/log_helper.py).

``vlog(level, msg)`` emits when the log level is at least ``level``; level
0 is always on.  The level is the ``FLAGS_log_level`` environment variable
(0 when unset), the JAX package's flag, read on first use.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any, Optional

__all__ = ["LOG_LEVEL_ENV", "get_logger", "get_log_level", "vlog"]

LOG_LEVEL_ENV = "FLAGS_log_level"

_logger: Optional[logging.Logger] = None
_level: Optional[int] = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("paddle_tpu_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s [paddle_tpu_torch] %(levelname)s %(message)s"))
            logger.addHandler(h)
            logger.setLevel(logging.INFO)
            logger.propagate = False
        _logger = logger
    return _logger


def get_log_level() -> int:
    """The current verbosity; read from ``FLAGS_log_level`` on first use."""
    global _level
    if _level is None:
        _level = int(os.environ.get(LOG_LEVEL_ENV, "0"))
    return _level


def vlog(level: int, msg: str, *args: Any) -> None:
    """Emit ``msg % args`` when the log level is at least ``level``."""
    if get_log_level() >= level:
        get_logger().info(msg, *args)
