"""Where the time of ``GPTForCausalLM.generate`` goes on the card.

    python -m paddle_tpu_torch.profile_generate

Decodes ``convert.generate_workload`` (full-width GPT-125M, bf16
activations, seeded random weights, 8 prompts of 512 tokens, 128 greedy
tokens each; the workload of ``chip_smoke.py``'s generate phase) once to
warm up (the first call captures the decode step's CUDA graph), once timed
without the profiler, then once more under ``torch.profiler`` with CUDA
activity; first unfused (``use_pallas_attention``), then fused
(``use_fused_block``).  Prints one JSON line per variant: from the timed
run, wall time, generated tokens/s, the prefill's and the decode steps'
CUDA-event milliseconds (:func:`timed_generate`); from the profiled run
(the profiler adds host time), its wall time, the device's busy time (the
union of kernel intervals), the idle share and the device time per kernel
name, largest first.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from . import _kernels
from .convert import GENERATE_NEW_TOKENS, generate_workload
from .framework.errors import enforce
from .profile_serving import _short, _union_us


def timed_generate(model, prompts: torch.Tensor, new_tokens: int
                   ) -> Tuple[torch.Tensor, List[float]]:
    """``model.generate(prompts, new_tokens)`` (greedy) with a CUDA event
    at each step boundary of its decode loop: the tokens and each step's
    milliseconds, prefill first.  A call with the same batch, length and
    sampling must have run before (it builds the loop and captures its
    graph), so that this one only replays."""
    loop = model._gen_loop
    b, plen = prompts.shape
    enforce(loop is not None and loop.key == (b, plen + new_tokens, 0.0, 0),
            "timed_generate: run generate once first with the same shapes")
    loop.marks = []
    try:
        out = model.generate(prompts, max_new_tokens=new_tokens)
    finally:
        marks, loop.marks = loop.marks, None
    marks[-1].synchronize()
    return out, [a.elapsed_time(z) for a, z in zip(marks, marks[1:])]


def profile(fused: bool) -> Dict[str, object]:
    model, prompts = generate_workload(torch.device("cuda"),
                                       use_fused_block=fused)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(prompts, max_new_tokens=GENERATE_NEW_TOKENS)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run()                                          # warm-up and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, steps = timed_generate(model, prompts, GENERATE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall = run()
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
    generated = out.shape[0] * (out.shape[1] - prompts.shape[1])
    return {
        "fused": fused, "device": torch.cuda.get_device_name(0),
        "batch": prompts.shape[0], "prompt_len": prompts.shape[1],
        "generated_tokens": generated,
        "wall_ms": wall * 1e3, "generated_tokens_per_s": generated / wall,
        "prefill_ms": steps[0],
        "decode_step_ms_p50": statistics.median(steps[1:]),
        "decode_steps": len(steps) - 1,
        "profiled_wall_ms": prof_wall * 1e3,
        "device_busy_ms": busy_ms if kernels else None,
        "device_idle_share": (1.0 - busy_ms / (prof_wall * 1e3)) if kernels
        else None,
        "kernels_ms": {k: {"ms": v[0], "count": v[1]} for k, v in
                       sorted(per_name.items(), key=lambda kv: -kv[1][0])},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_generate: needs a CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    for fused in (False, True):
        print(json.dumps(profile(fused)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
