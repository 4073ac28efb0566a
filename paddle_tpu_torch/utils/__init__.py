"""``paddle.utils`` of the port: the port of ``paddle_tpu/utils/
__init__.py`` (reference python/paddle/utils: deprecated.py,
lazy_import.py ``try_import``, install_check.py ``run_check``,
``require_version``, ``unique_name``, ``cpp_extension``, ``download``),
with the host utilities the runtime shares (``fsio``, ``retry``,
``tree``)."""
from __future__ import annotations

import functools
import importlib
import warnings

from . import cpp_extension  # noqa: F401
from . import download  # noqa: F401
from . import fsio  # noqa: F401
from . import retry  # noqa: F401
from . import unique_name  # noqa: F401

__all__ = ["deprecated", "try_import", "run_check", "require_version",
           "cpp_extension", "unique_name", "download", "retry", "fsio"]


def deprecated(update_to: str = "", since: str = "", reason: str = ""):
    """Decorator emitting a ``DeprecationWarning`` on each call."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            msg = f"API {fn.__module__}.{fn.__name__} is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f", use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)
        return inner
    return wrap


def try_import(module_name: str, err_msg: str = ""):
    """Import ``module_name`` or raise an ``ImportError`` that says so."""
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"{module_name} is required but not installed "
                       f"({e}); this environment has no package installs — "
                       f"gate the feature instead") from e


def run_check() -> bool:
    """Install check: a (128, 128) product of ones on the current device
    (``cuda`` unless ``set_device("cpu")``; ``UnavailableError`` without a
    card), its entries and its sum checked, then a report line."""
    import torch

    from ..device import resolve_device
    from ..framework.errors import enforce

    dev = resolve_device(None)
    x = torch.ones((128, 128), dtype=torch.float32, device=dev)
    y = x @ x
    enforce(bool((y == 128.0).all()), "matmul sanity check failed")
    enforce(float(y.sum()) == 128.0 * 128 * 128,
            "matmul sum sanity check failed")
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"paddle_tpu_torch is installed successfully on {dev.type} "  # noqa: print
          f"({kind})")
    return True


def require_version(min_version: str, max_version=None):
    """Raise unless this package's version lies in [min_version,
    max_version]."""
    from .. import __version__

    def parse(v):
        return tuple(int(p) for p in str(v).split(".")[:3])

    cur = parse(__version__)
    if parse(min_version) > cur:
        raise Exception(
            f"installed version {__version__} < required {min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"installed version {__version__} > allowed {max_version}")
    return True
