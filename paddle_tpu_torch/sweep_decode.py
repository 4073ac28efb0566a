"""Sweep the decode kernel's tuning constants on the card.

    python -m paddle_tpu_torch.sweep_decode

Builds ``csrc/flash_decode.cu`` once per variant of its three tuning
constants, each varied alone around the values in the source: ``kMaxSplits``
(blocks of a cluster at most) 2 / 4 / 8, ``kWarps`` (warps of a block) 4 / 8
and ``kUnroll`` (rows a row group keeps in flight) 4 / 5 / 8.  One ``nvcc``
per variant, all started together, into ``build/paddle_tpu_torch/sweep/``.
Each variant is held against :func:`flash_decode_reference` under the
tolerance of ``chip_smoke.py``'s decode check and timed at the generate
shape (B=8, H=12, d=64, L=640, float32 q over a bf16 cache) at lengths 80
and 576, beside ``scaled_dot_product_attention`` over the cache prefix: the
median of 25 CUDA-event times, the L2 flushed and the host hidden before
each launch, as ``chip_smoke.py`` times a kernel.  The source's own values
are timed first and again last, so the drift of the card over the sweep
shows.  Prints one JSON line per (variant, length) and the card's name and
power limit.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as TF

from . import _kernels
from .framework.errors import enforce
from .ops.flash_attention import flash_decode_reference

SOURCE = _kernels.CSRC / "flash_decode.cu"
SWEEP_DIR = _kernels.BUILD_DIR / "sweep"
CONSTANTS = ("kMaxSplits", "kWarps", "kUnroll")
VALUES = {"kMaxSplits": (2, 4, 8), "kWarps": (4, 8), "kUnroll": (4, 5, 8)}
B, H, D, L = 8, 12, 64, 640
LENGTHS = (80, 576)
SEED = 1234
SPIN_CYCLES = 2_000_000     # ~1 ms at the H100's 1.98 GHz boost clock

_CONST = re.compile(r"constexpr int (k\w+) = (\d+);")
_c, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def source_values(text: str) -> Dict[str, int]:
    """The tuning constants as the source sets them."""
    found = {m.group(1): int(m.group(2)) for m in _CONST.finditer(text)}
    return {name: found[name] for name in CONSTANTS}


def variant_source(text: str, values: Dict[str, int]) -> str:
    """``text`` with each constant of ``values`` set to its value."""
    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        enforce(n == 1, f"{name} is set {n} times in {SOURCE.name}")
    return text


def variants(base: Dict[str, int]) -> List[Dict[str, int]]:
    """The source's values first, then each constant varied alone, then
    the source's values again."""
    out = [dict(base)]
    for name in CONSTANTS:
        out += [{**base, name: v} for v in VALUES[name] if v != base[name]]
    return out + [dict(base)]


def tag(values: Dict[str, int]) -> str:
    return "s{kMaxSplits}w{kWarps}u{kUnroll}".format(**values)


def build(tags: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Compile each ``{tag: source}``, one ``nvcc`` each, all at once."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, text in tags.items():
        src = SWEEP_DIR / f"flash_decode_{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        jobs.append((name, lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
             str(_kernels.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in jobs:
        log = proc.communicate()[0]
        enforce(proc.returncode == 0, f"nvcc failed for {name}:\n{log}",
                exc=RuntimeError)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def launcher(lib: ctypes.CDLL):
    fn = lib.ptt_flash_decode
    fn.argtypes = [_p, _c, _p, _p, _c, _p, _p, _c, _c, _c, _c, _f, _p]
    fn.restype = _c
    lib.ptt_error_string.argtypes = [_c]
    lib.ptt_error_string.restype = ctypes.c_char_p
    pt, cd = _kernels.ptr, _kernels.dtype_code

    def run(q, k, v, length, out):
        b, h, sq, d = q.shape
        rc = fn(pt(q), cd(q), pt(k), pt(v), cd(k), pt(length), pt(out),
                b * h, sq, k.shape[2], d, d ** -0.5,
                _kernels.stream(q.device))
        enforce(rc == 0, f"flash_decode: error {rc} "
                f"({lib.ptt_error_string(rc).decode()})", exc=RuntimeError)
        return out
    return run


def time_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event milliseconds of ``fn()``, the 50 MB L2 flushed and
    a spin kernel queued before each launch (``chip_smoke.time_ms``)."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sweep() -> List[Dict[str, object]]:
    text = SOURCE.read_text()
    base = source_values(text)
    order = variants(base)
    libs = build({tag(v): variant_source(text, v) for v in order})
    rng = np.random.default_rng(SEED)

    def t(shape, dtype):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).cuda().to(dtype)

    q = t((B, H, 1, D), torch.float32)
    k, v = t((B, H, L, D), torch.bfloat16), t((B, H, L, D), torch.bfloat16)
    out = torch.empty_like(q)
    rows = []
    for n in LENGTHS:
        length = torch.tensor(n, dtype=torch.int32, device="cuda")
        ref = flash_decode_reference(q, k, v, length)
        # chip_smoke.py's decode tolerance: p rounded to bf16 against each
        # row group's own running max, sums in another order
        tol = 2.0 ** -8 * flash_decode_reference(q, k, v.float().abs(),
                                                 length) + 1e-5
        for i, values in enumerate(order):
            run = launcher(libs[tag(values)])
            run(q, k, v, length, out)
            torch.cuda.synchronize()
            err = float(((out - ref).abs() / tol).max())
            enforce(err <= 1.0, f"{tag(values)} at length {n}: err/tol "
                    f"{err}", exc=RuntimeError)
            rows.append({"variant": tag(values), **values,
                         "source": values == base, "order": i, "length": n,
                         "err_over_tol": err,
                         "ms": time_ms(lambda: run(q, k, v, length, out))})
        qb, ks, vs = q.to(torch.bfloat16), k[:, :, :n], v[:, :, :n]
        rows.append({"variant": "sdpa", "length": n, "ms": time_ms(
            lambda: TF.scaled_dot_product_attention(qb, ks, vs))})
    return rows


def main() -> int:
    enforce(torch.cuda.is_available(), "sweep_decode needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    for row in sweep():
        print(json.dumps(row), flush=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: " + smi.stderr.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
