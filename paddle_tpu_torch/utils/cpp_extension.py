"""Custom C++ / CUDA op loading: the port of ``paddle_tpu/utils/
cpp_extension.py`` (reference utils/cpp_extension/: ``load`` building a
shared library from sources, ``CppExtension`` / ``CUDAExtension`` /
``setup`` for the ahead-of-time build).

:func:`load` compiles host C / C++ sources with ``g++`` into one shared
library with a plain C interface and returns the ``ctypes`` handle (the
port's device kernels are built by ``_kernels.py``).  The library goes to
:func:`get_build_directory`, under the port's gitignored ``build/``
(``_kernels.BUILD_DIR``), at a path keyed by a digest of the sources and
flags: an unchanged source is loaded as it is, an edited one rebuilt.  A
build writes a private temporary file and renames it into place, so a
concurrent ``load`` never opens a half-written library.

:func:`custom_op` wraps an exported ``void f(const T* in, T* out, int64_t
n)`` as a tensor function (the input copied to the host, the result
copied back to the input's device), as the JAX ``pure_callback`` does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Callable, Sequence

import numpy as np
import torch

from ..framework.errors import enforce

__all__ = ["load", "custom_op", "get_build_directory", "CppExtension",
           "CUDAExtension", "setup"]

_CUDA_SUFFIXES = (".cu",)


def get_build_directory() -> str:
    """``PADDLE_TPU_EXTENSION_DIR`` if set, else ``extensions/`` under the
    kernels' build directory."""
    from .._kernels import BUILD_DIR
    d = os.environ.get("PADDLE_TPU_EXTENSION_DIR") or str(
        BUILD_DIR / "extensions")
    os.makedirs(d, exist_ok=True)
    return d


def load(name: str, sources: Sequence[str], extra_cxx_cflags=(),
         extra_ldflags=(), verbose: bool = False) -> ctypes.CDLL:
    """Compile ``sources`` into ``<build_dir>/<name>-<digest>.so`` unless
    it is there, and return the loaded ``ctypes`` handle."""
    enforce(len(sources) > 0, "cpp_extension.load needs at least one source")
    base = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"]
    h = hashlib.sha1()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join([*base[1:], *extra_cxx_cflags,
                       *extra_ldflags]).encode())
    so_path = os.path.join(get_build_directory(),
                           f"{name}-{h.hexdigest()[:12]}.so")
    if not os.path.exists(so_path):
        tmp_path = f"{so_path}.tmp.{os.getpid()}"
        cmd = [*base, *extra_cxx_cflags, *map(str, sources), "-o", tmp_path,
               *extra_ldflags]
        if verbose:
            print("compiling:", " ".join(cmd))  # noqa: print
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            enforce(proc.returncode == 0,
                    f"cpp_extension build failed:\n{proc.stderr}")
            os.replace(tmp_path, so_path)
        finally:
            if os.path.exists(tmp_path):   # a failed build leaves nothing
                os.unlink(tmp_path)
    return ctypes.CDLL(so_path)


_CTYPES = {
    np.float32: ctypes.c_float,
    np.float64: ctypes.c_double,
    np.int32: ctypes.c_int32,
    np.int64: ctypes.c_int64,
}


def custom_op(lib: ctypes.CDLL, symbol: str, dtype=np.float32) -> Callable:
    """Wrap ``void symbol(const T* in, T* out, int64_t n)`` as a function
    of one tensor (or array) returning a tensor of the same shape on the
    input's device.  It runs on the host and has no gradient."""
    fn = getattr(lib, symbol)
    np_dtype = np.dtype(dtype)
    ct = _CTYPES[np_dtype.type]
    fn.argtypes = [ctypes.POINTER(ct), ctypes.POINTER(ct), ctypes.c_int64]
    fn.restype = None

    def op(x):
        t = torch.as_tensor(x)
        host = np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np_dtype)
        out = np.empty_like(host)
        fn(host.ctypes.data_as(ctypes.POINTER(ct)),
           out.ctypes.data_as(ctypes.POINTER(ct)), ctypes.c_int64(host.size))
        return torch.from_numpy(out).to(t.device)

    op.__name__ = symbol
    return op


def CppExtension(sources, **kwargs):
    """A setuptools ``Extension`` of C++ sources (the ahead-of-time twin of
    :func:`load`); options by keyword (``include_dirs=``, ...)."""
    from setuptools import Extension
    name = kwargs.pop("name", "paddle_tpu_ext")
    kwargs.setdefault("language", "c++")
    return Extension(name, sources=list(sources), **kwargs)


def CUDAExtension(sources, **kwargs):
    """An extension with ``.cu`` sources, built by PyTorch's setuptools
    integration (``torch.utils.cpp_extension.CUDAExtension``); without a
    ``.cu`` source it is a :func:`CppExtension`.  (The JAX package refuses
    CUDA sources: its device kernels are Pallas.)"""
    if not any(str(s).endswith(_CUDA_SUFFIXES) for s in sources):
        return CppExtension(sources, **kwargs)
    from torch.utils.cpp_extension import CUDAExtension as _TorchCUDA
    name = kwargs.pop("name", "paddle_tpu_ext")
    return _TorchCUDA(name, list(sources), **kwargs)


def setup(**attrs):
    """``setuptools.setup`` for the extensions, with PyTorch's
    ``BuildExtension`` as ``build_ext`` (it drives ``nvcc`` for ``.cu``
    sources)."""
    import setuptools
    from torch.utils.cpp_extension import BuildExtension
    attrs.setdefault("ext_modules", [])
    attrs.setdefault("cmdclass", {}).setdefault("build_ext", BuildExtension)
    return setuptools.setup(**attrs)
