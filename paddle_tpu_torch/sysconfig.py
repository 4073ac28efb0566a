"""``paddle.sysconfig``: the port of ``paddle_tpu/sysconfig.py``
(reference python/paddle/sysconfig.py).  Custom host ops use the C ABI
(``utils.cpp_extension``), so the include directory is the port's native
helpers' (``io/_native``); their built libraries go to the kernels' build
directory."""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]


def get_include() -> str:
    """The directory of the port's native C / C++ sources."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "io", "_native")


def get_lib() -> str:
    """The directory the port's host libraries are built into."""
    from .utils.cpp_extension import get_build_directory
    return get_build_directory()
