"""Where the training step's time goes on the card.

    python -m paddle_tpu_torch.profile_training

Runs the training workload of ``chip_smoke.py`` (``convert.
training_workload``: full-width GPT-125M, bf16 O1, B=8, S=2048, flash
attention, the chunked LM loss, AdamW): 3 warm-up steps, 5 steps timed
without the profiler (host clock, each ending in the loss readback), then
3 steps under ``torch.profiler`` with CUDA activity.  Prints one JSON line:
the timed steps' ms; from the profiled steps, the device's busy time (the
union of kernel intervals) per step, the idle share, and the device time
per step by kernel name, largest first, and per group (each of the
three flash kernels, GEMMs, everything else).  Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List

import torch

from . import _kernels
from .convert import training_workload
from .profile_serving import _short, _union_us
from .training import train_step

WARMUP, TIMED, PROFILED = 3, 5, 3


def _group(name: str) -> str:
    if "(ours)" in name:
        return name.replace(" (ours)", "")      # flash_fwd / _dkdv / _dq
    low = name.lower()
    if any(key in low for key in ("gemm", "nvjet", "xmma", "cutlass")):
        return "GEMM (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile() -> Dict[str, object]:
    model, opt, ids, labels = training_workload(torch.device("cuda"))

    def steps(n: int) -> List[float]:
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            float(train_step(model, opt, ids, labels))
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    steps(WARMUP)
    timed = steps(TIMED)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(PROFILED)
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device events, less the annotation ranges the profiler also puts on
    # the device's timeline (the optimizer's step)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        per_name[_short(e.name)][0] += (t - s) / 1e3 / PROFILED
        per_name[_short(e.name)][1] += 1
    busy = _union_us(intervals) / 1e3 / PROFILED if kernels else None
    groups: Dict[str, float] = defaultdict(float)
    for name, (ms, _) in per_name.items():
        groups[_group(name)] += ms
    return {
        "device": torch.cuda.get_device_name(0),
        "model": "gpt_125m", "B": int(ids.shape[0]), "S": int(ids.shape[1]),
        "step_ms": timed, "step_ms_p50": statistics.median(timed),
        "profiled_step_ms": prof_wall / PROFILED,
        "device_busy_ms_per_step": busy,
        "device_idle_share": (1.0 - busy * PROFILED / prof_wall)
        if kernels else None,
        "groups_ms_per_step": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
        "kernels_ms_per_step": {
            k: {"ms": v[0], "launches": v[1] // PROFILED} for k, v in
            sorted(per_name.items(), key=lambda kv: -kv[1][0])[:25]},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    print(json.dumps(profile()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
