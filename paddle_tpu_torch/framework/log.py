"""VLOG-style logging: the port's own copy of ``paddle_tpu/framework/
log.py`` (glog ``VLOG(n)``, fluid/log_helper.py).

``vlog(level, msg)`` emits when the log level is at least ``level``; level
0 is always on.  The level is the ``log_level`` flag of
``framework/flags.py``: ``set_flags({"log_level": n})``, else the
``FLAGS_log_level`` environment variable, else 0.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Optional

from .flags import get_flag

__all__ = ["get_logger", "get_log_level", "vlog"]

_logger: Optional[logging.Logger] = None


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
    """The current verbosity: the ``log_level`` flag."""
    return int(get_flag("log_level"))


def vlog(level: int, msg: str, *args: Any) -> None:
    """Emit ``msg % args`` when the log level is at least ``level``."""
    if get_log_level() >= level:
        get_logger().info(msg, *args)
