"""``paddle.utils.download``: the port of ``paddle_tpu/utils/download.py``
(reference utils/download.py), local cache only.

A URL resolves to its basename under :data:`WEIGHTS_HOME`; a cached file
is returned (after an md5 check when one is given), and a missing one
raises with the place to provision it.  Nothing is fetched."""
from __future__ import annotations

import hashlib
import os

__all__ = ["get_weights_path_from_url"]

# the JAX package's cache: one provisioned file serves both packages
WEIGHTS_HOME = os.path.expanduser("~/.cache/paddle_tpu/weights")


def _md5check(path: str, md5sum: str) -> bool:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == md5sum


def get_weights_path_from_url(url: str, md5sum: str = None) -> str:
    """The cached file of ``url`` under ``WEIGHTS_HOME``; raises
    ``RuntimeError`` when it is not there or fails the md5 check."""
    fname = os.path.basename(url)
    path = os.path.join(WEIGHTS_HOME, fname)
    if os.path.exists(path):
        if md5sum and not _md5check(path, md5sum):
            raise RuntimeError(
                f"cached weights {path} fail the md5 check ({md5sum}); "
                "remove the file and re-provision it")
        return path
    raise RuntimeError(
        f"no network egress in this environment: provision {fname} "
        f"under {WEIGHTS_HOME} (from {url}) before calling "
        "get_weights_path_from_url")
