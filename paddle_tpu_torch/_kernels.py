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
and nowhere else.  A CUDA graph is the one exception, handled here and
nowhere else: a capture runs the wrappers' Python but launches nothing, and
a replay launches the captured kernels without running any Python.  So
:func:`capture` takes the launches its wrappers counted back out of
``launches`` and returns them as the graph's record, and :func:`replay`
adds that record once per replay.  Nothing here is imported or built until
a kernel runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

from .framework.errors import UnavailableError, enforce

__all__ = ["KERNELS", "BUILD_DIR", "DEFAULT_BUILD_DIR", "launches",
           "reset_launches", "build", "bind", "check", "dtype_code", "ptr",
           "stream", "sm_count", "ptxas_functions", "sass_count",
           "require_cuda", "capture", "replay"]

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
                     / "paddle_tpu_torch")
# the persistent compile cache (observability/compilecache.py): the
# libraries of every earlier process, here unless PTPU_COMPILE_CACHE_DIR
# names another directory
BUILD_DIR = Path(os.environ.get("PTPU_COMPILE_CACHE_DIR", "").strip()
                 or DEFAULT_BUILD_DIR)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("paged_decode", "ln_linear", "ln_linear_mma", "ln_linear_stream",
           "ln_linear_tiled", "linear_residual", "linear_residual_mma",
           "linear_residual_stream", "linear_residual_tiled", "ffn",
           "ffn_mma", "ffn_stream", "ffn_tiled", "flash_fwd", "flash_dkdv",
           "flash_dq", "flash_decode")

launches: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def capture(graph, fn) -> Dict[str, int]:
    """Capture ``fn()`` into ``graph`` (a ``torch.cuda.CUDAGraph``) and
    return the launches its wrappers counted, per kernel: the graph's
    record.  The capture launched nothing, so they leave ``launches``."""
    before = dict(launches)
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        recorded = {n: launches[n] - before[n] for n in launches}
        launches.update(before)
    return {n: c for n, c in recorded.items() if c}


def replay(graph, recorded: Dict[str, int]) -> None:
    """Replay ``graph`` and count the launches of its record."""
    graph.replay()
    for name, count in recorded.items():
        launches[name] += count


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
    were compiled; each compile's output is kept beside its library.

    Each compiled library is one ``compile`` record of the compile
    tracker (function ``kernels.<name>``, its signature the library's
    file name, its wall ms from the start of the build to its ``nvcc``'s
    end); the libraries wanted and found built count as persistent-cache
    requests and hits."""
    from .observability.compilation import get_tracker
    from .observability.compilecache import maybe_enable_persistent_cache
    from .observability.registry import get_registry
    names = list(names)
    for name in names:
        enforce(name in KERNELS, f"unknown kernel {name!r}")
    maybe_enable_persistent_cache()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reg = get_registry()
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = _library(name)
        reg.counter("compile.persistent_cache_requests").inc()
        if out.exists():
            reg.counter("compile.persistent_cache_hits").inc()
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
            get_tracker().observe(f"kernels.{name}", [out.name],
                                  arg_names=["library"],
                                  wall_ms=(time.perf_counter() - t0) * 1e3)
        else:
            failed.append(f"{name}:\n{log.read_text()}")
    enforce(not failed, "nvcc failed for " + "\n".join(failed),
            exc=RuntimeError)
    return {"seconds": time.perf_counter() - t0 if jobs else 0.0,
            "compiled": [j[0] for j in jobs]}


def ptxas_functions(name: str) -> Dict[str, Dict[str, int]]:
    """Per function of the last compile of ``name`` (mangled name), from
    its ``ptxas -v`` lines: ``registers``, ``stack_frame``, ``spill_stores``
    and ``spill_loads`` (bytes).  Empty when it was loaded from an old
    build."""
    log = _library(name).with_suffix(".log")
    if not log.exists():
        return {}
    funcs: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([^' ]+)", line)
        if m:
            current = funcs.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            current["stack_frame"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return funcs


def sass_count(name: str, opcode: str) -> Dict[str, int]:
    """Per kernel function of the built library ``name`` (mangled name),
    the number of SASS instructions with ``opcode`` (``HMMA`` for the
    tensor cores' mma.sync), from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    enforce(os.path.exists(tool), "cuobjdump was not found (PATH or "
            "/usr/local/cuda/bin)", exc=UnavailableError)
    sass = subprocess.run([tool, "-sass", str(_library(name))],
                          capture_output=True, text=True, check=True).stdout
    counts: Dict[str, int] = {}
    current = None
    pattern = re.compile(rf"\b{re.escape(opcode)}\b")
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current is not None and pattern.search(line):
            counts[current] += 1
    return counts


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
