"""Where the serving path's time goes on the card.

    python -m paddle_tpu_torch.profile_serving

Serves ``convert.serving_workload`` (full-width GPT-125M, bf16 activations,
seeded random weights, 8 prompts of seeded lengths in [16, 500], 32 greedy
tokens each; the workload of ``chip_smoke.py``'s serving phase) to warm up,
then timed without the profiler, then once more under ``torch.profiler``
with CUDA activity; first with ``use_fused_block`` on, then off.  Prints one
JSON line per setting: from the timed run, wall time, generated tokens/s and
the host wall time of prefill and decode steps; from the profiled run
(slower: the profiler adds host time), its wall time, the device's busy time
(the union of kernel intervals), the idle share and the device time per
kernel name, largest first.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Dict, List

import torch

from . import _kernels
from .convert import SERVING_ENGINE, SERVING_NEW_TOKENS, serving_workload
from .inference import ServingEngine

_SHORT = {"paged_decode_kernel": "paged_decode (ours)",
          "ln_linear_kernel": "ln_linear (ours)",
          "linear_residual_kernel": "linear_residual (ours)",
          "ffn_finalize_kernel": "ffn finalize (ours)",
          "ffn_kernel": "ffn (ours)",
          "flash_fwd_kernel": "flash_fwd (ours)",
          "flash_dkdv_kernel": "flash_dkdv (ours)",
          "flash_dq_kernel": "flash_dq (ours)"}


def _short(name: str) -> str:
    for key, short in _SHORT.items():
        if key in name:
            return short
    return name[:80]


def _union_us(intervals: List[tuple]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile(fused: bool) -> Dict[str, object]:
    model, prompts = serving_workload(torch.device("cuda"),
                                      use_fused_block=fused)

    def run():
        eng = ServingEngine(model, **SERVING_ENGINE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=SERVING_NEW_TOKENS)
        torch.cuda.synchronize()
        return eng, out, time.perf_counter() - t0

    run()                                          # warm-up
    eng, out, wall = run()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, prof_wall = run()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        per_name[_short(e.name)][0] += (t - s) / 1e3
        per_name[_short(e.name)][1] += 1
    busy_ms = _union_us(intervals) / 1e3
    st = eng.stats()
    generated = sum(len(t) for t in out)
    return {
        "fused": fused, "device": torch.cuda.get_device_name(0),
        "prompt_lengths": [len(p) for p in prompts],
        "generated_tokens": generated,
        "wall_ms": wall * 1e3, "generated_tokens_per_s": generated / wall,
        "prefill_ms_p50": st["step_ms"]["prefill"]["p50"],
        "decode_step_ms_p50": st["step_ms"]["decode"]["p50"],
        "profiled_wall_ms": prof_wall * 1e3,
        "device_busy_ms": busy_ms if kernels else None,
        "device_idle_share": (1.0 - busy_ms / (prof_wall * 1e3)) if kernels
        else None,
        "kernels_ms": {k: {"ms": v[0], "count": v[1]} for k, v in
                       sorted(per_name.items(), key=lambda kv: -kv[1][0])},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    for fused in (True, False):
        print(json.dumps(profile(fused)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
