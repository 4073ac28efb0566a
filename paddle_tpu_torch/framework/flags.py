"""Global flag registry: the port of ``paddle_tpu/framework/flags.py``
(reference platform/flags.cc ``PADDLE_DEFINE_EXPORTED_*``,
global_value_getter_setter.cc, the env parsing of platform/init.cc).

Flags are Python values in a process-global registry.  A flag's value is,
in order: the value :func:`set_flags` gave it; else the environment
variable ``FLAGS_<name>`` (read when the flag is read, so a variable set
after import counts too); else its default.

The port defines the JAX package's table except its two Pallas routing
flags, ``use_pallas_kernels`` and ``pallas_interpret_routing``: in the port
a tensor on the card always takes its kernel and a CPU tensor its plain
version, so :func:`set_flags` of either name raises ``UnimplementedError``
rather than accepting a value that would change nothing.
``dataloader_use_native`` defaults to True, as in the JAX package: a
``DataLoader`` with worker processes carries batches over the native
shared-memory ring (``io/native.py``).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

from .errors import UnimplementedError

__all__ = ["define_flag", "get_flags", "get_flag", "set_flags", "version"]

_lock = threading.Lock()
_defaults: Dict[str, Any] = {}
_set: Dict[str, Any] = {}
_version = 0

# the JAX package's routing flags, which the port refuses
_REFUSED = {
    "use_pallas_kernels": "a tensor on the card always takes its CUDA "
                          "kernel and a CPU tensor its plain version",
    "pallas_interpret_routing": "the port has no interpret mode: a CPU "
                                "tensor takes the plain version",
}


def version() -> int:
    """Monotone counter bumped by every :func:`define_flag` and
    :func:`set_flags`."""
    return _version


def _coerce(env_value: str, default: Any) -> Any:
    if isinstance(default, bool):
        return env_value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(env_value)
    if isinstance(default, float):
        return float(env_value)
    return env_value


def define_flag(name: str, default: Any, doc: str = "") -> None:
    """Register a flag (a second definition of a name is ignored)."""
    global _version
    with _lock:
        if name in _defaults:
            return
        _defaults[name] = default
        _version += 1


def get_flag(name: str) -> Any:
    if name in _set:
        return _set[name]
    default = _defaults[name]
    env = os.environ.get("FLAGS_" + name)
    return default if env is None else _coerce(env, default)


def get_flags(names=None) -> Dict[str, Any]:
    if names is None:
        names = list(_defaults)
    elif isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    global _version
    with _lock:
        for name in flags:
            if name in _REFUSED:
                raise UnimplementedError(
                    f"flag {name!r} is not supported by the PyTorch port: "
                    f"{_REFUSED[name]}")
            if name not in _defaults:
                raise KeyError(f"unknown flag {name!r}; define_flag it first")
        _set.update(flags)
        _version += 1


# ---------------------------------------------------------------------------
# Built-in flags (the JAX package's table, less the Pallas routing flags)
# ---------------------------------------------------------------------------
define_flag("check_nan_inf", False,
            "Per-step nan/inf scan of outputs/grads (reference "
            "operator.cc:1252 FLAGS_check_nan_inf).")
define_flag("benchmark", False, "Synchronize after each step for timing.")
define_flag("amp_dtype", "bfloat16", "Low-precision dtype for AMP.")
define_flag("dataloader_use_native", True,
            "DataLoader workers hand batches over the native shared-memory "
            "ring (io/native.py) instead of the multiprocessing queue.")
define_flag("log_level", 0, "VLOG-style verbosity (higher = chattier).")
