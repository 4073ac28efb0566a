"""``paddle.hub``: the port of ``paddle_tpu/hub.py`` (reference
python/paddle/hub.py).  Only a local repository directory with a
``hubconf.py`` is served; a remote source raises (no network)."""
from __future__ import annotations

import importlib.util
import os
from typing import List

from .framework.errors import enforce

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"
_CACHE: dict = {}


def _load_hubconf(repo_dir: str, force_reload: bool = False):
    enforce(os.path.isdir(repo_dir),
            f"hub: remote sources need network egress (disabled); pass a "
            f"LOCAL repo directory (got {repo_dir!r})")
    path = os.path.join(repo_dir, _HUBCONF)
    enforce(os.path.exists(path), f"hub: no {_HUBCONF} in {repo_dir!r}")
    key = (os.path.abspath(path), os.path.getmtime(path))
    if not force_reload and key in _CACHE:
        return _CACHE[key]
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _CACHE[key] = mod
    return mod


def list(repo_dir: str, source: str = "local", force_reload: bool = False
         ) -> List[str]:
    """The entry points a local repository's ``hubconf.py`` exports."""
    mod = _load_hubconf(repo_dir, force_reload)
    return [n for n in dir(mod)
            if not n.startswith("_") and callable(getattr(mod, n))]


def help(repo_dir: str, model: str, source: str = "local",
         force_reload: bool = False) -> str:
    mod = _load_hubconf(repo_dir, force_reload)
    fn = getattr(mod, model, None)
    enforce(fn is not None, f"hub: no entrypoint {model!r} in {repo_dir!r}")
    return fn.__doc__ or ""


def load(repo_dir: str, model: str, *args, source: str = "local",
         force_reload: bool = False, **kwargs):
    mod = _load_hubconf(repo_dir, force_reload)
    fn = getattr(mod, model, None)
    enforce(fn is not None, f"hub: no entrypoint {model!r} in {repo_dir!r}")
    return fn(*args, **kwargs)
