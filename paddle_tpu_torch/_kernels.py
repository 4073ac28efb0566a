"""Build, bind and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/paddle_tpu_torch/`` beside the package (listed in ``.gitignore``).
A library's file name carries a digest of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
all of them.  The libraries are loaded with ``ctypes``; nothing here
includes PyTorch's headers, which keeps a build to seconds.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on
anything but 0.  ``launches`` counts, per kernel, the calls in which a
wrapper launched it on the card: the wrappers add one right after a launch
and nowhere else.  Nothing here is imported or built until a kernel runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

from .framework.errors import UnavailableError, enforce

__all__ = ["KERNELS", "BUILD_DIR", "launches", "reset_launches", "build",
           "bind", "check", "dtype_code", "ptr", "stream", "sm_count",
           "ptxas_report", "require_cuda"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
             / "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("paged_decode", "ln_linear", "linear_residual", "ffn",
           "flash_fwd", "flash_dkdv", "flash_dq")

launches: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    enforce(os.path.exists(path),
            "nvcc was not found (PATH or /usr/local/cuda/bin); the CUDA "
            "kernels are built from csrc/ at first use", exc=UnavailableError)
    return path


def _library(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, object]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the wall seconds
    of the build (0.0 when nothing had to be compiled) and the names that
    were compiled; each compile's output is kept beside its library."""
    names = list(names)
    for name in names:
        enforce(name in KERNELS, f"unknown kernel {name!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = _library(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log))
    failed: List[str] = []
    for name, proc, tmp, out, log in jobs:
        if proc.wait() == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}:\n{log.read_text()}")
    enforce(not failed, "nvcc failed for " + "\n".join(failed),
            exc=RuntimeError)
    return {"seconds": time.perf_counter() - t0 if jobs else 0.0,
            "compiled": [j[0] for j in jobs]}


def ptxas_report(name: str) -> str:
    """The ``ptxas -v`` lines (registers, shared memory, spills) of the
    last compile of ``name``; empty when it was loaded from an old build."""
    log = _library(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "ptxas info" in line and ("Used" in line
                                                  or "spill" in line))


def bind(name: str, symbol: str, argtypes: Sequence):
    """The C function ``symbol`` of kernel library ``name`` (built and
    loaded on first use), with ``argtypes`` declared and an ``int``
    result."""
    fn = _fns.get(symbol)
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library(name)))
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise when a C entry point of ``name`` returned a CUDA error."""
    if rc != 0:
        msg = _libs[name].ptt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    """0 for float32, 1 for bfloat16: the dtype codes of csrc/common.cuh."""
    enforce(t.dtype in (torch.float32, torch.bfloat16),
            f"the CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return 1 if t.dtype == torch.bfloat16 else 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        enforce(t.is_cuda and t.device == dev,
                f"{name}: every operand must be on one CUDA device, got "
                f"{t.device} beside {dev}")
        enforce(t.is_contiguous(), f"{name}: operands must be contiguous")
    return dev
