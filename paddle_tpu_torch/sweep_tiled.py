"""Sweep the depth split of the tiled kernels' passes on the card.

    python -m paddle_tpu_torch.sweep_tiled

The register-blocked float32 kernels (``csrc/tiled.cuh``) split each 64 x
128 output tile's depth over a cluster of ``ops.fused_block._tiled_splits``
blocks.  For each pass at GPT-125M's widths (h = 768, ffn = 3072, bf16 x):
``ln_linear_tiled`` (2304 columns over h), ``ffn_tiled``'s up pass (3072
columns over h) and down pass (768 columns over ffn), and
``linear_residual_tiled`` (768 columns over 768), the whole call is timed
with that pass's depth chunks set to each of 1-8 (the other pass of K3 at
the rule's), at N = 64, 128, 256, 512 and 1024, after a check against its
plain version (1e-4 for a float32 output, one bf16 unit for a bf16 one).
Median of 25 CUDA-event times, the L2 flushed and the host hidden before
each launch (``sweep_decode.time_ms``, as ``chip_smoke.py`` times a
kernel).  Prints one JSON line per (pass, N, split), with the rule's split
marked, and the card's name and power limit.  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
from typing import Dict, List

import numpy as np
import torch

from . import _kernels
from .framework.errors import enforce
from .ops import fused_block as fb
from .sweep_decode import time_ms

H, FFN, COLS, EPS, SEED = 768, 3072, 2304, 1e-5, 1234
ROWS = (64, 128, 256, 512, 1024)
SPLITS = range(1, 9)
# pass -> the (depth, columns) of its W
PASSES = {"ln_linear_tiled": (H, COLS), "ffn_tiled up": (H, FFN),
          "ffn_tiled down": (FFN, H), "linear_residual_tiled": (H, H)}


def sweep() -> List[Dict[str, object]]:
    rng = np.random.default_rng(SEED)

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).cuda().to(dtype)

    g, beta = t((H,), std=0.1, mean=1.0), t((H,), std=0.1)
    w_qkv, b_qkv = t((H, COLS), std=0.02), t((COLS,), std=0.02)
    w_out, b_out = t((H, H), std=0.02), t((H,), std=0.02)
    w1, b1 = t((H, FFN), std=0.02), t((FFN,), std=0.02)
    w2, b2 = t((FFN, H), std=0.02), t((H,), std=0.02)
    rule = fb._tiled_splits
    sms = _kernels.sm_count(torch.device("cuda"))
    rows = []
    try:
        for n in ROWS:
            x = t((n, H), torch.bfloat16)
            calls = {
                "ln_linear_tiled": (
                    lambda: fb.ln_linear_tiled_cuda(x, w_qkv, b_qkv, g, beta,
                                                    EPS),
                    lambda: fb.ln_linear_reference(x, w_qkv, b_qkv, g, beta,
                                                   EPS)),
                "ffn_tiled up": (
                    lambda: fb.ffn_tiled_cuda(x, w1, b1, w2, b2, g, beta,
                                              epsilon=EPS),
                    lambda: fb.ffn_reference(x, w1, b1, w2, b2, g, beta,
                                             epsilon=EPS)),
                "linear_residual_tiled": (
                    lambda: fb.linear_residual_tiled_cuda(x, w_out, b_out,
                                                          x),
                    lambda: fb.linear_residual_reference(x, w_out, b_out,
                                                         x))}
            calls["ffn_tiled down"] = calls["ffn_tiled up"]
            for name, (kernel, plain) in calls.items():
                depth, cols = PASSES[name]
                ref = plain()
                tol = (1e-4 if ref.dtype == torch.float32 else
                       float(ref.float().abs().max()) * 2.0 ** -7)
                for split in SPLITS:
                    fb._tiled_splits = (
                        lambda s, m, k, c, split=split, depth=depth,
                        cols=cols: split if (k, c) == (depth, cols)
                        else rule(s, m, k, c))
                    out = kernel()
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max())
                    enforce(err <= tol, f"{name} N={n} split {split}: "
                            f"|kernel - plain| {err} > {tol}",
                            exc=RuntimeError)
                    rows.append({"pass": name, "N": n, "split": split,
                                 "rule": split == rule(sms, n, depth, cols),
                                 "max_abs_err": err, "ms": time_ms(kernel)})
                    fb._tiled_splits = rule
    finally:
        fb._tiled_splits = rule
    return rows


def main() -> int:
    enforce(torch.cuda.is_available(), "sweep_tiled needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
