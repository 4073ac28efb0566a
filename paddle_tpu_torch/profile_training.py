"""Where the training step's time goes on the card.

    python -m paddle_tpu_torch.profile_training [--workload NAME]

Runs one of the training workloads of ``chip_smoke.py`` (``convert.py``):
``training`` (the default; ``training_workload``: full-width GPT-125M,
bf16 O1, B=8, S=2048, flash attention, the chunked LM loss, AdamW),
``fused`` (``fused_training_workload``: the same with ``use_fused_block``
and dropout 0.1), ``pretraining-a`` and ``pretraining-b``
(``pretraining_workload`` legs A and B: full-width GPT-3 1.3B with
recompute at B=4, S=2048; A under O1 at dropout 0, B the recipe: O2,
GradScaler, clipping, AdamW with decay selection, the warmup-cosine
schedule, dropout 0.1), ``bert`` (``bert_pretraining_workload``:
full-width BERT-base, MLM + NSP, bf16 O1, B=16, S=512, the non-causal
flash attention), ``moe`` (``moe_training_workload``: GPT-125M with 8
experts on every other layer, GShard top-2, bf16 O1, B=8, S=2048),
``resnet50`` (``resnet_training_workload``: ResNet-50, B=128, 224 x 224,
bf16 O1, Momentum; ``training.classification_step``), ``mobilenet_v2``
(``vision_training_workload("mobilenet_v2")``: MobileNetV2 at scale 1.0
with the same set-up; its depthwise convolutions fall into the
convolution group), ``lenet``
(``lenet_training_workload``: LeNet, B=64, float32) and ``transformer``
(``transformer_training_workload``: Transformer-base translation over a
vocabulary of 30000, B=32, S=128 a side, bf16 O1, dropout 0.1, Adam under
``NoamDecay``, label smoothing 0.1; ``training.seq2seq_step``): 3
warm-up steps, 5 steps timed without the profiler (host clock, each
ending in the loss readback), then 3 steps under ``torch.profiler`` with
CUDA activity.  Prints one JSON line: the timed steps' ms and the peak
device memory; from the profiled steps, the device's busy time (the union
of kernel intervals) per step, the idle share, and the device time per
step by kernel name, largest first, and per group (each of the port's
kernels, GEMMs, everything else; for the vision workloads the cuDNN
convolutions, layout transposes, batch norm, pooling, GEMMs, the
optimizer's step and the other elementwise work; for the Transformer the
GEMMs, the optimizer's step and the rest).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List

import torch

from . import _kernels
from .convert import (bert_pretraining_workload, fused_training_workload,
                      lenet_training_workload, moe_training_workload,
                      pretraining_workload, resnet_training_workload,
                      training_workload, transformer_training_workload,
                      vision_training_workload)
from .profile_serving import _short, _union_us
from .training import classification_step, seq2seq_step, train_step

WARMUP, TIMED, PROFILED = 3, 5, 3


def _group(name: str) -> str:
    if "(ours)" in name:
        return name.replace(" (ours)", "")      # flash_fwd, ..., ffn
    low = name.lower()
    if any(key in low for key in ("gemm", "nvjet", "xmma", "cutlass")):
        return "GEMM (cuBLAS)"
    return "other (elementwise, reductions, copies)"


# the vision workloads' groups, by kernel name (first match); kernels that
# run inside the optimizer's step are "optimizer" whatever their name
_VISION_GROUPS = (
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "convolve",
                             "conv2d", "conv_", "cudnn", "implicit",
                             "depthwise", "grouped")),
    ("pooling", ("pool",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
)


def _vision_group(name: str) -> str:
    low = name.lower()
    for group, keys in _VISION_GROUPS:
        if any(key in low for key in keys):
            return group
    return "other elementwise (relu, residual adds, casts, loss)"


WORKLOADS = ("training", "fused", "pretraining-a", "pretraining-b", "bert",
             "moe", "resnet50", "mobilenet_v2", "lenet", "transformer")
VISION = {"resnet50": resnet_training_workload,
          "mobilenet_v2": lambda device: vision_training_workload(
              "mobilenet_v2", device),
          "lenet": lenet_training_workload}
MODELS = {"pretraining-a": "gpt_1p3b", "pretraining-b": "gpt_1p3b",
          "bert": "bert_base", "moe": "gpt_125m, 8 experts every 2nd layer",
          "resnet50": "resnet50", "mobilenet_v2": "mobilenet_v2",
          "lenet": "LeNet",
          "transformer": "transformer_base, vocab 30000"}


def _workload(name: str, device):
    """``(model, optimizer, ids, labels, step_kwargs)`` of a workload (for
    the vision ones, the images in place of ids; for the Transformer the
    source ids, and the decoder inputs and labels as ``labels``)."""
    if name == "transformer":
        model, opt, (src, tgt_in, tgt_next), kw = \
            transformer_training_workload(device)
        return model, opt, src, (tgt_in, tgt_next), kw
    if name in VISION:
        return VISION[name](device)
    if name.startswith("pretraining-"):
        return pretraining_workload(device, leg=name[-1].upper())
    if name == "bert":
        model, opt, ids, inputs = bert_pretraining_workload(device)
        return model, opt, ids, None, inputs
    make = {"fused": fused_training_workload,
            "moe": moe_training_workload}.get(name, training_workload)
    return (*make(device), {})


def profile(workload: str = "training") -> Dict[str, object]:
    model, opt, ids, labels, kw = _workload(workload, torch.device("cuda"))
    vision = workload in VISION
    step_fn = classification_step if vision else train_step
    if workload == "transformer":
        def step_fn(model, opt, src, labels, **kw):
            return seq2seq_step(model, opt, src, *labels, **kw)
    torch.cuda.reset_peak_memory_stats()

    def steps(n: int) -> List[float]:
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            float(step_fn(model, opt, ids, labels, **kw))
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
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events
               if not getattr(e, "is_user_annotation", False)]
    # the optimizer's step as the profiler annotates it on the device
    opt_ranges = [(e.time_range.start, e.time_range.end) for e in events
                  if getattr(e, "is_user_annotation", False)
                  and "Optimizer.step" in e.name]
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    groups: Dict[str, float] = defaultdict(float)
    intervals = []
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        name = _short(e.name)
        per_name[name][0] += (t - s) / 1e3 / PROFILED
        per_name[name][1] += 1
        if any(a <= s < b for a, b in opt_ranges) and (
                vision or workload == "transformer"):
            group = f"optimizer ({type(opt).__name__} step)"
        elif not vision:
            group = _group(name)
        else:
            group = _vision_group(e.name)
        groups[group] += (t - s) / 1e3 / PROFILED
    busy = _union_us(intervals) / 1e3 / PROFILED if kernels else None
    cfg = getattr(model, "config", None)
    return {
        "device": torch.cuda.get_device_name(0),
        "workload": workload,
        "model": MODELS.get(workload, "gpt_125m"),
        "B": int(ids.shape[0]),
        **({"image": list(ids.shape[1:])} if vision
           else {"S": int(ids.shape[1])}),
        "use_fused_block": getattr(cfg, "use_fused_block", False),
        "use_recompute": getattr(cfg, "use_recompute", False),
        "amp": kw.get("level", "O1"),
        "dropout": (model.core.encoder.layers[0].dropout1.p
                    if workload == "transformer"
                    else getattr(cfg, "hidden_dropout", 0.0)),
        "step_ms": timed, "step_ms_p50": statistics.median(timed),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", choices=WORKLOADS, default="training",
                        help="fused: the fused-block leg (K1 -> flash -> "
                        "K2, K3; dropout 0.1); pretraining-a / -b: GPT-3 "
                        "1.3B with recompute, legs A and B; bert: BERT-base "
                        "MLM + NSP; moe: the MoE GPT-125M; resnet50 / "
                        "lenet: the vision rows; mobilenet_v2: MobileNetV2 "
                        "with their set-up; transformer: "
                        "Transformer-base translation")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    print(json.dumps(profile(args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
