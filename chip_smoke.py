#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
H100.  Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints no
``ok`` line):

  (a) build   the CUDA kernels from paddle_tpu_torch/csrc/ (one nvcc per
              source, in parallel) into build/paddle_tpu_torch/; the bf16
              flash forward, dK/dV and dQ kernels must hold HMMA (mma.sync)
              instructions in their SASS (cuobjdump -sass) and ptxas must
              report no spill stores or loads for their d=64
              instantiations; the decode kernel's registers, spills and
              cluster split at the generate shape are logged, and the
              paged-decode kernel's at the serving table width;
  (b) kernels each kernel at its path's shapes and dtypes against its
              plain PyTorch version on the card, with a stated tolerance;
              times by CUDA events (median, L2 flushed, the host's launch
              path hidden behind a spin kernel).  The flash kernels
              at the training shape (B=8, H=12, S=2048, d=64, bf16, causal),
              plus a dropout case (B=2, H=4, S=512, p=0.1) and a ragged one
              (sq=136, sk=200) that are checked but not timed; paged decode
              at the serving shape (timed), then untimed at every edge of
              its cluster split, other table widths, all four q / page
              dtype pairs, d = 32 and 128 and rows that share blocks, and
              two launches must give the same bits;
  (c) serving GPT-125M at full width (12 layers, h=768, 12 heads, vocab
              50304, bf16 activations, use_fused_block) with seeded random
              weights loaded through convert.py, served by ServingEngine:
              8 ragged prompts x 32 greedy tokens.  Every kernel's launch
              counter is zeroed just before this run and must be > 0 after.
              Beforehand, a float32 run on a small input is held against
              the same model on the CPU (plain versions): tokens identical,
              logits within 1e-3;
  (c2) training one training step (bf16 O1, AdamW) of GPT-125M at full
              width and depth, S=2048, B=8, with flash attention and the
              chunked LM loss (convert.training_workload): 3 warm-up and 10
              timed steps on one batch, the loss read back in each step.
              The flash kernels' counters are zeroed just before these 13
              steps and must read 12 x 13 after.  Beforehand, a float32
              step of a gpt_tiny-sized model (S=256) on the card is held
              against the same step on the CPU: loss and every gradient;
  (c2b) fused training  the fused-block leg (convert.
              fused_training_workload: the same model, weights and data with
              use_fused_block and hidden / attention dropout 0.1, bf16 O1):
              each block K1 -> flash (attention dropout in the kernel) -> K2
              (hidden dropout in the kernel), then K3 (dropout after + b2 in
              the kernel), backward by recompute of the plain compositions
              plus the flash backward kernels.  13 steps as in (c2); the
              counters of the six kernels are zeroed just before and must
              read 12 x 13 after; the loss must be finite and fall.  The
              unfused step's p50 of (c2) is printed beside it.  Beforehand,
              K2 and K3 with dropout against their plain versions at N=8
              (K3's multi-group exit), 4096 and 16384 (the training shape,
              timed at p=0.1 and p=0): values within the stated tolerance,
              and with a residual of 2^-40 of the addend the dropped
              elements (those equal to the residual) are exactly the hash
              mask's; K1 timed at N=16384; and a float32 gpt_tiny fused
              training step on the card against the CPU (loss, every
              gradient, the loss after one AdamW step);
  (c3) generate GPTForCausalLM.generate at full width (convert.
              generate_workload: B=8, prompt 512, 128 greedy tokens, bf16),
              unfused (use_pallas_attention) and fused (use_fused_block):
              prefill ms, decode-step p50 ms (CUDA events), generated
              tokens/s, each the median of 3 timed calls after a capturing
              one.  The counters are zeroed just before the timed calls;
              flash_decode must read 12 x their decode steps, and in the
              fused run K1-K3 > 0.  Beforehand, a float32 run on a
              small input is held against the same model on the CPU
              (tokens identical, generate_step logits within 1e-3), and the
              flash decode kernel against its plain version at B=8, H=12,
              d=64, L=640 (phase b: every length, the split edges among
              them, eagerly and under one captured graph's replays), and
              K1-K3 at the prefill's 4096 rows;
              sampled decoding (temperature, top_k, seed) under graph
              replay is held against an eager loop on the float32 model.
              Afterwards an eager loop of generate_step must give the
              CUDA-graph run's tokens;
  (d) the kernel list as one JSON line;
  (e) the card's name and power limit from nvidia-smi.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or outside a checkout of the repository, it exits non-zero.  It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM float32 on the CUDA cores (no tensor
# cores): K1-K3 and paged decode multiply float32 parameters at full float32
# precision, as the JAX package does, so this is their matching peak
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense: the flash
# kernels' products take bf16 operands, as the TPU kernels' MXU passes do

PEAK_F32 = "bytes at 3.35 TB/s; float32 operations at 67 TFLOP/s"
PEAK_BF16 = "bytes at 3.35 TB/s; bf16 operations at 989 TFLOP/s"

SEED = 1234
SERVING_KERNELS = ("paged_decode", "ln_linear", "linear_residual", "ffn")
TRAINING_KERNELS = ("flash_fwd", "flash_dkdv", "flash_dq")
FUSED_TRAINING_KERNELS = ("ln_linear", "linear_residual", "ffn",
                          *TRAINING_KERNELS)
GENERATE_KERNELS = ("flash_decode",)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, root)
    import numpy as np
    from paddle_tpu_torch import _kernels

    # exact float32 products for every reference on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- (a) build -----------------------------------------------------------
    built = _kernels.build()
    log(f"build: {built['seconds']:.2f} s, compiled {built['compiled']}")
    for name in _kernels.KERNELS:
        for fn, props in _kernels.ptxas_functions(name).items():
            log(f"  {name}: {fn}: {props}")
    design = check_design(_kernels)

    # -- (b) each kernel against its plain version ---------------------------
    results = check_kernels(torch, np, dev)

    check_dropout(torch, np, dev, results)
    results.update(check_flash(torch, np, dev))
    results.update(check_flash_decode(torch, np, dev, _kernels))
    for name, d in design.items():
        results[name]["design"] = d

    # -- (c) serving ---------------------------------------------------------
    serving = serve(torch, np, dev, _kernels)

    # -- (c2) training -------------------------------------------------------
    training = train(torch, np, dev, _kernels)
    torch.cuda.empty_cache()

    # -- (c2b) fused-block training ------------------------------------------
    fused_training = train_fused(torch, np, dev, _kernels,
                                 training["step_ms_p50"])
    torch.cuda.empty_cache()

    # -- (c3) generate -------------------------------------------------------
    generating = generate(torch, np, dev, _kernels)

    # -- (d) kernel list: launches from the path each kernel belongs to ------
    for r in results.values():
        path = (training if r["name"] in TRAINING_KERNELS else
                generating if r["name"] in GENERATE_KERNELS else serving)
        r["launches"] = path["launches"][r["name"]]
        require(r["launches"] > 0,
                f"{r['name']}: no launch on its main path")
        if r["name"] in FUSED_TRAINING_KERNELS:
            r["launches_fused_training"] = \
                fused_training["launches"][r["name"]]
        log(json.dumps({"kernel": r["name"], "kernel_ms": r["ms"],
                        **{k: v for k, v in r.items() if k != "name"}}))
    log(json.dumps({"kernels": list(results.values())}))

    # -- (e) card line and the result line ------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# (a) the tensor-core design of the bf16 flash kernels
# ---------------------------------------------------------------------------
# library: the bf16 kernel's name in it (one instantiation per head dim of
# ops/flash_attention.py _HEAD_DIMS)
MMA_KERNELS = {"flash_fwd": "flash_fwd_mma", "flash_dkdv": "flash_dkdv_mma",
               "flash_dq": "flash_dq_mma"}
MMA_HEAD_DIMS = 4
# the decode kernel's instantiation on the generate path: float32 q over a
# bf16 cache, d=64 (8 vectors of 16 bytes a row)
DECODE_TIMED_FN = "flash_decode_kernelIf13__nv_bfloat16Li8E"
# the paged-decode kernel's on the serving path (K1 returns float32 q; the
# pages are bf16), and the serving shape's block table
PAGED_TIMED_FN = "paged_decode_kernelIf13__nv_bfloat16Li8E"
PAGED_WIDTH, PAGED_BS = 64, 16


def check_design(_kernels):
    """Every bf16 instantiation of the flash forward, dK/dV and dQ kernels
    runs mma.sync on the tensor cores (HMMA in its SASS), and the training
    path's d=64 instantiation spills no registers.  Logs the decode
    kernel's registers and spills per instantiation and its cluster split
    at the generate shape's capacity."""
    from paddle_tpu_torch.ops import flash_attention as fa
    out = {}
    for lib, fn in MMA_KERNELS.items():
        hmma = {f: c for f, c in _kernels.sass_count(lib, "HMMA").items()
                if fn in f}
        require(len(hmma) == MMA_HEAD_DIMS and all(hmma.values()),
                f"{lib}: HMMA per bf16 instantiation {hmma}: not every one "
                "runs on the tensor cores")
        d64 = {f: p for f, p in _kernels.ptxas_functions(lib).items()
               if f"{fn}ILi64E" in f}
        require(len(d64) == 1, f"{lib}: no ptxas report for {fn}<64>")
        (props,) = d64.values()
        require(props.get("spill_stores") == 0
                and props.get("spill_loads") == 0,
                f"{lib}: {fn}<64> spills: {props}")
        (h64,) = [c for f, c in hmma.items() if f"{fn}ILi64E" in f]
        out[lib] = {"kernel": f"{fn}<64>", "hmma": h64,
                    "hmma_per_head_dim": sorted(hmma.values()),
                    "registers": props.get("registers"),
                    "spill_stores": props["spill_stores"],
                    "spill_loads": props["spill_loads"]}
        log(f"design {lib}: {fn}<64> has {h64} HMMA instructions "
            f"({sorted(hmma.values())} over the {MMA_HEAD_DIMS} head dims), "
            f"{props.get('registers')} registers, 0 spill stores")

    decode = _kernels.ptxas_functions("flash_decode")
    for fn, props in decode.items():
        if "flash_decode_kernel" in fn:
            log(f"design flash_decode: {fn}: {props}")
    timed = [p for f, p in decode.items() if DECODE_TIMED_FN in f]
    splits, chunk = fa._flash_decode_split(DECODE_CAP)
    out["flash_decode"] = {
        "kernel": "flash_decode_kernel<float, bf16, 8>",
        "registers": timed[0].get("registers") if timed else None,
        "spill_stores": timed[0].get("spill_stores") if timed else None,
        "spill_loads": timed[0].get("spill_loads") if timed else None,
        "cap": DECODE_CAP, "cluster": splits, "positions_per_block": chunk,
        "blocks": 8 * 12 * splits}
    log(f"design flash_decode: at L={DECODE_CAP} a cluster of {splits} "
        f"blocks per (batch*head, query row), {chunk} positions each "
        f"({8 * 12 * splits} blocks at B=8, H=12); timed instantiation "
        f"{timed[0] if timed else 'not in the ptxas log'}")

    from paddle_tpu_torch.inference.paged_attention import (
        _paged_decode_split)
    paged = _kernels.ptxas_functions("paged_decode")
    for fn, props in paged.items():
        if "paged_decode_kernel" in fn:
            log(f"design paged_decode: {fn}: {props}")
    timed = [p for f, p in paged.items() if PAGED_TIMED_FN in f]
    splits, per = _paged_decode_split(PAGED_WIDTH, PAGED_BS)
    out["paged_decode"] = {
        "kernel": "paged_decode_kernel<float, bf16, 8>",
        "registers": timed[0].get("registers") if timed else None,
        "spill_stores": timed[0].get("spill_stores") if timed else None,
        "spill_loads": timed[0].get("spill_loads") if timed else None,
        "table_width": PAGED_WIDTH, "block_size": PAGED_BS,
        "cluster": splits, "entries_per_block": per,
        "blocks": 8 * 12 * splits}
    log(f"design paged_decode: a table of {PAGED_WIDTH} entries of "
        f"{PAGED_BS} positions split across a cluster of {splits} blocks "
        f"of {per} entries per (row, head) ({8 * 12 * splits} blocks at "
        f"B=8, H=12); timed instantiation "
        f"{timed[0] if timed else 'not in the ptxas log'}")
    return out


# ---------------------------------------------------------------------------
# (b) kernels
# ---------------------------------------------------------------------------
SPIN_CYCLES = 2_000_000     # ~1 ms at the H100's 1.98 GHz boost clock


def time_ms(torch, fn, reps: int = 25) -> float:
    """Median of per-launch CUDA-event times, with the 50 MB L2 flushed
    before each launch (the serving path finds every layer's weights
    cold).  A spin kernel queued after the flush keeps the card busy while
    the host runs the wrapper's Python and queues the launch, so the events
    time the work on the card, not the host's way to it (a decode step
    replays its kernels from a CUDA graph, with no host in between)."""
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


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bf16_tol(ref) -> float:
    """One bfloat16 unit in the last place at the top of ``ref``'s range:
    kernel and plain version both sum in float32 (in different orders) and
    round once to bfloat16, so a value next to a rounding boundary may land
    one unit apart; a wrong tile or index is off by far more."""
    return float(ref.float().abs().max()) * 2.0 ** -7


def compare(torch, name, out, ref, tol):
    """max |out - ref| and the err/tol of the element nearest its limit.  A
    float tolerance holds for every element; a tensor one is per element,
    and the tolerance reported is that of the element nearest its limit."""
    require(out.shape == ref.shape and out.dtype == ref.dtype,
            f"{name}: kernel gives {tuple(out.shape)} {out.dtype}, plain "
            f"{tuple(ref.shape)} {ref.dtype}")
    require(bool(torch.isfinite(out.float()).all()), f"{name}: nonfinite")
    diff = (out.float() - ref.float()).abs()
    tol_t = torch.as_tensor(tol, device=diff.device).expand_as(diff)
    worst = int((diff / tol_t).argmax())
    err_over_tol = float(diff.flatten()[worst] / tol_t.flatten()[worst])
    require(err_over_tol <= 1.0,
            f"{name}: |kernel - plain| {float(diff.flatten()[worst])} > tol "
            f"{float(tol_t.flatten()[worst])} at element {worst}")
    return {"max_abs_err": float(diff.max()),
            "tol": float(tol_t.flatten()[worst]),
            "err_over_tol": err_over_tol}


def measure(torch, name, kernel, plain, tol_fn, work, peak=F32_FLOPS,
            timed=True):
    """Kernel against plain on the same inputs.  ``kernel`` and ``plain``
    return a tensor or a tuple of tensors; ``tol_fn(ref)`` gives the
    tolerance of each (a tuple for a tuple).  Times both when ``timed``."""
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    tols = tol_fn(ref)
    tols = tols if isinstance(ref, tuple) else (tols,)
    parts = [compare(torch, f"{name}[{i}]", o, r, t)
             for i, (o, r, t) in enumerate(zip(outs, refs, tols))]
    res = dict(max(parts, key=lambda r: r["err_over_tol"]))
    res["max_abs_err"] = max(r["max_abs_err"] for r in parts)
    b_ms, b_by = bound(*work, peak=peak)
    res.update(bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(torch, kernel) if timed else None,
               plain_ms=time_ms(torch, plain) if timed else None)
    return res


def check_kernels(torch, np, dev):
    from paddle_tpu_torch.inference.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    from paddle_tpu_torch.ops import fused_block as fb
    rng = np.random.default_rng(SEED)

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).to(dev).to(dtype)

    h, ffn, eps = 768, 3072, 1e-5
    g, beta = t((h,), std=0.1, mean=1.0), t((h,), std=0.1)
    w_qkv, b_qkv = t((h, 3 * h), std=0.02), t((3 * h,), std=0.02)
    w_out, b_out = t((h, h), std=0.02), t((h,), std=0.02)
    w1, b1 = t((h, ffn), std=0.02), t((ffn,), std=0.02)
    w2, b2 = t((ffn, h), std=0.02), t((h,), std=0.02)
    # float32 sums of 768-3072 products in another order than cuBLAS: the
    # kernel and plain results differ by ~1e-6; 1e-4 leaves margin while a
    # wrong tile, index or epilogue is off by 1e-2 or more
    f32_tol = lambda ref: 1e-4  # noqa: E731

    results = {}
    shapes = {}
    # decode rows; the serving engine's largest prefill bucket; the rows of
    # the generate prefill (8 prompts x 512 tokens)
    for n in (8, 512, 4096):
        x_res = t((n, h), torch.bfloat16)          # bf16 residual stream
        attn = t((n, h))                            # float32 attention out
        shapes[n] = {
            "ln_linear": measure(
                torch, f"ln_linear N={n}",
                lambda: fb.ln_linear_cuda(x_res, w_qkv, b_qkv, g, beta, eps),
                lambda: fb.ln_linear_reference(x_res, w_qkv, b_qkv, g, beta,
                                               eps),
                f32_tol,
                (nbytes(x_res, w_qkv, b_qkv, g, beta) + n * 3 * h * 4,
                 2.0 * n * h * 3 * h)),
            "linear_residual": measure(
                torch, f"linear_residual N={n}",
                lambda: fb.linear_residual_cuda(attn, w_out, b_out, x_res),
                lambda: fb.linear_residual_reference(attn, w_out, b_out,
                                                     x_res),
                bf16_tol,
                (nbytes(attn, w_out, b_out, x_res) + n * h * 2,
                 2.0 * n * h * h)),
            "ffn": measure(
                torch, f"ffn N={n}",
                lambda: fb.ffn_cuda(x_res, w1, b1, w2, b2, g, beta,
                                    epsilon=eps),
                lambda: fb.ffn_reference(x_res, w1, b1, w2, b2, g, beta,
                                         epsilon=eps),
                bf16_tol,
                (nbytes(x_res, w1, b1, w2, b2, g, beta) + n * h * 2,
                 4.0 * n * h * ffn)),
        }
        # K3's device-memory scratch: one float32 (N, h) partial per cluster
        # group when there is more than one, beside the (N, ffn) float32
        # intermediate that the fusion keeps on chip
        groups, cluster = fb._ffn_grid(dev, n, h, ffn)
        shapes[n]["ffn"].update(
            groups=groups, cluster=cluster,
            scratch_bytes=groups * n * h * 4 if groups > 1 else 0,
            intermediate_bytes=n * ffn * 4)
        require(shapes[n]["ffn"]["scratch_bytes"]
                < shapes[n]["ffn"]["intermediate_bytes"],
                f"ffn N={n}: the partials outgrow the intermediate")
        for name, r in shapes[n].items():
            log(f"check {name} N={n}: max_abs_err {r['max_abs_err']:.3e} "
                f"<= tol {r['tol']:.3e}; {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"by {r['bound_by']})")

    replaces = {
        "ln_linear": "paddle_tpu/ops/fused_block.py:178",
        "linear_residual": "paddle_tpu/ops/fused_block.py:267",
        "ffn": "paddle_tpu/ops/fused_block.py:363",
    }
    for name, line in replaces.items():
        dec = shapes[8][name]
        # the error of the shape nearest its limit, beside its tolerance
        worst = max((shapes[n][name] for n in shapes),
                    key=lambda r: r["err_over_tol"])
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu", "replaces": line,
            "launches": 0,
            "max_abs_err": worst["max_abs_err"], "tol": worst["tol"],
            "err_over_tol": worst["err_over_tol"],
            "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": None, "peak": PEAK_F32,
            "shapes": {f"N={n}": dict(shapes[n][name]) for n in shapes}}

    # paged decode at the 125M serving shape: B=8, H=12, d=64, block 16,
    # 64 blocks per row (1024 positions), ragged lengths with one empty row
    B, H, D, bs, per_row = 8, 12, 64, PAGED_BS, PAGED_WIDTH
    nblocks = B * per_row
    lens_np = np.array([0, 1, 17, 100, 333, 512, 777, 1024], np.int32)
    perm = rng.permutation(nblocks).astype(np.int32).reshape(B, per_row)
    q = t((B, H, D))
    kp = t((nblocks * bs + 1, H, D), torch.bfloat16)
    vp = t((nblocks * bs + 1, H, D), torch.bfloat16)
    tables = torch.from_numpy(perm).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    ctx = int(lens_np.sum())
    # the kernel rounds p to the page dtype (bf16) before the PV product,
    # as the TPU kernel does, while the plain version keeps p in float32
    # (both normalise by the sum of the unrounded p): each p moves by at
    # most 2^-9 relative, so output element (b, h, e) moves by at most
    # 2^-9 * sum_i p_i |v_i[e]| / sum_i p_i -- the plain version run on |v|.
    # The stated tolerance is twice that, per element, plus 1e-5 for float32
    # sums in another order; a dropped or misread block moves a row by far
    # more than its own bound, however long the row
    pd_bound = paged_attention_reference(q, kp, vp.abs(), tables, lens, bs)
    pd_tol = lambda ref: pd_bound * 2.0 ** -8 + 1e-5  # noqa: E731
    r = measure(
        torch, "paged_decode",
        lambda: paged_attention_cuda(q, kp, vp, tables, lens, bs),
        lambda: paged_attention_reference(q, kp, vp, tables, lens, bs),
        pd_tol,
        (nbytes(q, tables, lens) + q.numel() * 4 + 2 * ctx * H * D * 2,
         4.0 * ctx * H * D))
    out = paged_attention_cuda(q, kp, vp, tables, lens, bs)
    require(float(out[0].abs().max()) == 0.0, "paged_decode: len-0 row "
            "is not zero")
    log(f"check paged_decode B={B}: max_abs_err {r['max_abs_err']:.3e} <= "
        f"tol {r['tol']:.3e}; {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
        f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    results["paged_decode"] = {
        "name": "paged_decode", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_decode.cu",
        "replaces": "paddle_tpu/inference/paged_attention.py:113",
        "launches": 0, "max_abs_err": r["max_abs_err"], "tol": r["tol"],
        "err_over_tol": r["err_over_tol"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "peak": PEAK_F32}
    results["paged_decode"].update(check_paged_cases(torch, np, dev))
    return results


# table widths of the untimed paged cases: the serving width (4 blocks of
# 16 entries), one split (4 entries), splits that do not divide the width
# (13 = 5 + 5 + 3); every length one before, at and one after each split
# edge, 0, 1 and the full width, plus a row sharing the full-width row's
# blocks up to half its length (a shared prompt prefix)
PAGED_CASE_WIDTHS = (PAGED_WIDTH, 4, 13)
PAGED_CASE_DIMS = (64, 32, 128)


def check_paged_cases(torch, np, dev):
    """(b) paged decode, untimed, over the cases of PAGED_CASE_WIDTHS x the
    four q / page dtype pairs at d=64 and float32 q over bf16 pages at
    d=32 and 128, under the timed check's tolerance (plus one bf16 unit of
    the output for bf16 q); then two launches at the serving width must
    give the same bits."""
    from paddle_tpu_torch.inference.paged_attention import (
        _paged_decode_split, paged_attention_cuda, paged_attention_reference)
    rng = np.random.default_rng(SEED + 5)
    H, bs = 12, PAGED_BS
    f32, bf16 = torch.float32, torch.bfloat16
    splits, per = _paged_decode_split(PAGED_WIDTH, bs)
    edges = {r * per * bs + o for r in range(1, splits) for o in (-1, 0, 1)}
    require(splits > 1 and edges == {255, 256, 257, 511, 512, 513, 767, 768,
                                     769},
            f"paged_decode: the split at width {PAGED_WIDTH} ({splits} "
            f"blocks of {per} entries) is not the expected 4 x 16")
    require(_paged_decode_split(4, bs)[0] == 1
            and _paged_decode_split(13, bs) == (3, 5),
            "paged_decode: the split of widths 4 and 13 is not 1 and 3 x 5")

    def inputs(width, d, qdtype, pdtype):
        sp, pe = _paged_decode_split(width, bs)
        lens = sorted({0, 1, 17, width * bs} | {
            r * pe * bs + o for r in range(1, sp) for o in (-1, 0, 1)})
        b = len(lens) + 1
        nb = b * width
        q = torch.from_numpy(rng.standard_normal(
            (b, H, d), dtype=np.float32)).to(dev).to(qdtype)
        kp, vp = (torch.from_numpy(rng.standard_normal(
            (nb * bs + 1, H, d), dtype=np.float32)).to(dev).to(pdtype)
            for _ in range(2))
        perm = rng.permutation(nb).astype(np.int32).reshape(b, width)
        perm[-1] = perm[-2]                  # shares the full-width row's
        tables = torch.from_numpy(perm).to(dev)
        lens = torch.tensor([*lens, width * bs // 2 + 3], dtype=torch.int32,
                            device=dev)
        return q, kp, vp, tables, lens

    cases = {}
    combos = [(w, 64, qd, pd) for w in PAGED_CASE_WIDTHS
              for qd, pd in ((f32, bf16), (bf16, bf16), (f32, f32),
                             (bf16, f32))]
    combos += [(PAGED_WIDTH, d, f32, bf16) for d in PAGED_CASE_DIMS[1:]]
    for width, d, qdtype, pdtype in combos:
        q, kp, vp, tables, lens = inputs(width, d, qdtype, pdtype)
        out = paged_attention_cuda(q, kp, vp, tables, lens, bs)
        ref = paged_attention_reference(q, kp, vp, tables, lens, bs)
        bound_pv = paged_attention_reference(q.float(), kp, vp.abs(),
                                             tables, lens, bs)
        torch.cuda.synchronize()
        # the timed check's tolerance (2^-8 of the attention over |v|, per
        # element, for bf16 pages; float32 pages differ by summation order
        # only), plus one bf16 unit of the output for bf16 q
        tol = (bound_pv * 2.0 ** -8 if pdtype == bf16 else 0.0) + 1e-5
        if qdtype == bf16:
            tol = tol + 2.0 ** -7 * ref.float().abs()
        tag = (f"width {width}, d={d}, q {str(qdtype).split('.')[-1]}, "
               f"pages {str(pdtype).split('.')[-1]}")
        cases[tag] = compare(torch, f"paged_decode {tag}", out.float(),
                             ref.float(), tol)
        require(float(out[0].abs().max()) == 0.0,
                f"paged_decode {tag}: the length-0 row is not zero")
        if (width, d, qdtype, pdtype) == (PAGED_WIDTH, 64, f32, bf16):
            again = paged_attention_cuda(q, kp, vp, tables, lens, bs)
            torch.cuda.synchronize()
            require(torch.equal(out, again),
                    "paged_decode: two launches give different bits")
    worst = max(cases.values(), key=lambda r: r["err_over_tol"])
    log(f"check paged_decode cases: {len(cases)} (widths "
        f"{list(PAGED_CASE_WIDTHS)} x 4 dtype pairs at d=64, d "
        f"{list(PAGED_CASE_DIMS[1:])}; lengths at every split edge, 0, 1, "
        f"full, a shared-prefix row), worst err/tol "
        f"{worst['err_over_tol']:.3f}; two launches equal bit for bit")
    return {"cases": len(cases), "cases_worst_err_over_tol":
            worst["err_over_tol"], "repeat_bits_equal": True}


FLASH_CASES = {
    # tag: (B, H, sq, sk, d, dropout_p, dtype, timed); "train" is the shape
    # of the training step and the one timed; "train-dropout" is the fused
    # leg's (attention dropout 0.1: hash salts b*h up to 95, rows to 2047)
    "train": (8, 12, 2048, 2048, 64, 0.0, "bfloat16", True),
    "train-dropout": (8, 12, 2048, 2048, 64, 0.1, "bfloat16", False),
    "dropout": (2, 4, 512, 512, 64, 0.1, "bfloat16", False),
    "ragged": (2, 4, 136, 200, 64, 0.0, "bfloat16", False),
    "ragged-f32": (2, 4, 136, 200, 32, 0.0, "float32", False),
}


def visible_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs under the bottom-right causal mask: the work the
    data needs (the kernels skip whole tiles above the diagonal)."""
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def check_flash(torch, np, dev):
    """(b) the flash kernels against their plain versions: the training
    shape (timed, with SDPA as the library yardstick), the same shape with
    the fused leg's attention dropout, a small dropout case and ragged
    sq != sk cases (checked only)."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(SEED + 2)
    seed = 987654321

    def t(shape, dtype):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def fwd_tol(q, k, v, p, dtype):
        # per element.  bf16: the kernel's online softmax rounds p to bf16
        # against a running max, the plain version against the row's max
        # (2^-9 relative each), so an output moves by at most 2^-8 times
        # the same attention over |v|; both round the float32 result once
        # more (one bf16 unit, 2^-7 relative).  float32: summation order
        # only, 1e-5 of the range.  lse: float32 sums of exact products on
        # both sides, 1e-5 relative
        def tol(ref):
            out, lse = ref
            lse_tol = 1e-5 * max(1.0, float(lse.abs().max()))
            if dtype == torch.float32:
                return 1e-5 * max(1.0, float(out.abs().max())), lse_tol
            abs_pv, _ = fa.flash_fwd_reference(q.float(), k.float(),
                                               v.float().abs(), seed, None,
                                               True, p)
            return (2.0 ** -8 * abs_pv + 2.0 ** -7 * out.float().abs()
                    + 1e-6, lse_tol)
        return tol

    def bwd_tol(dtype):
        # kernel and plain round pd and ds at the same points, from float32
        # values that differ by summation order only; the sums are rounded
        # once to the output dtype: one unit at the top of the range (bf16)
        # or 1e-5 of it (float32)
        def tol(ref):
            refs = ref if isinstance(ref, tuple) else (ref,)
            f = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            out = tuple(f * max(1e-30, float(r.float().abs().max()))
                        for r in refs)
            return out if isinstance(ref, tuple) else out[0]
        return tol

    per = {"flash_fwd": {}, "flash_dkdv": {}, "flash_dq": {}}
    library = {}
    for tag, (b, h, sq, sk, d, p, dtype, timed) in FLASH_CASES.items():
        dtype = getattr(torch, dtype)
        bh = b * h
        q, k, v = t((bh, sq, d), dtype), t((bh, sk, d), dtype), \
            t((bh, sk, d), dtype)
        do = t((bh, sq, d), dtype)
        out, lse = fa.flash_fwd_reference(q, k, v, seed, None, True, p)
        delta = (do.float() * out.float()).sum(-1)
        pairs = visible_pairs(sq, sk) * bh
        io = nbytes(q, k, v, do, lse, delta)
        per["flash_fwd"][tag] = measure(
            torch, f"flash_fwd {tag}",
            lambda: fa.flash_fwd_cuda(q, k, v, seed, None, True, p),
            lambda: fa.flash_fwd_reference(q, k, v, seed, None, True, p),
            fwd_tol(q, k, v, p, dtype),
            (nbytes(q, k, v, out, lse), 4.0 * d * pairs), BF16_FLOPS, timed)
        per["flash_dkdv"][tag] = measure(
            torch, f"flash_dkdv {tag}",
            lambda: fa.flash_dkdv_cuda(q, k, v, do, lse, delta, seed, None,
                                       True, p),
            lambda: fa.flash_dkdv_reference(q, k, v, do, lse, delta, seed,
                                            None, True, p),
            bwd_tol(dtype), (io + nbytes(k, v), 8.0 * d * pairs), BF16_FLOPS,
            timed)
        per["flash_dq"][tag] = measure(
            torch, f"flash_dq {tag}",
            lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta, seed, None,
                                     True, p),
            lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, seed,
                                          None, True, p),
            bwd_tol(dtype), (io + nbytes(q), 6.0 * d * pairs), BF16_FLOPS,
            timed)
        for name in per:
            r = per[name][tag]
            timing = (f"; {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})"
                      if timed else "")
            log(f"check {name} {tag} (B={b}, H={h}, sq={sq}, sk={sk}, d={d}, "
                f"p={p}, {str(dtype).split('.')[-1]}): max_abs_err "
                f"{r['max_abs_err']:.3e}, err/tol {r['err_over_tol']:.3f}"
                f"{timing}")
        if timed:
            # the library yardstick, never called by the port: SDPA forward,
            # and its forward + backward less the forward (the backward
            # computes dK, dV and dQ together)
            q4, k4, v4, do4 = (x.view(b, h, -1, d) for x in (q, k, v, do))
            sdpa = TF.scaled_dot_product_attention
            library["fwd"] = time_ms(
                torch, lambda: sdpa(q4, k4, v4, is_causal=True))
            qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))

            def fwd_bwd():
                o = sdpa(qg, kg, vg, is_causal=True)
                torch.autograd.grad(o, (qg, kg, vg), do4)
            library["bwd"] = time_ms(torch, fwd_bwd) - library["fwd"]
            log(f"library: SDPA forward {library['fwd']:.4f} ms, backward "
                f"{library['bwd']:.4f} ms (dK, dV and dQ together)")
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()

    replaces = {"flash_fwd": ("paddle_tpu/ops/flash_attention.py:149", "fwd"),
                "flash_dkdv": ("paddle_tpu/ops/flash_attention.py:254",
                               "bwd"),
                "flash_dq": ("paddle_tpu/ops/flash_attention.py:312", "bwd")}
    results = {}
    for name, (line, lib) in replaces.items():
        train_r = per[name]["train"]
        worst = max(per[name].values(), key=lambda r: r["err_over_tol"])
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu", "replaces": line,
            "launches": 0, "max_abs_err": worst["max_abs_err"],
            "tol": worst["tol"], "err_over_tol": worst["err_over_tol"],
            "ms": train_r["ms"], "plain_ms": train_r["plain_ms"],
            "bound_ms": train_r["bound_ms"], "bound_by": train_r["bound_by"],
            "library_ms": library[lib],
            "library": ("scaled_dot_product_attention forward" if lib == "fwd"
                        else "scaled_dot_product_attention backward (dK, dV "
                        "and dQ together)"),
            "peak": PEAK_BF16,
            "shape": "B=8, H=12, S=2048, d=64, bf16, causal",
            "cases": {tag: {"max_abs_err": r["max_abs_err"],
                            "err_over_tol": r["err_over_tol"]}
                      for tag, r in per[name].items()}}
    return results


DECODE_CAP = 640
# 40: all but the first block idle; 159 / 160 / 161, 319 / 320 / 321 and
# 479 / 480 / 481: one before, at and one after the first position of each
# block but the first of the cluster split at L=640 (4 blocks of 160
# positions; checked against the kernel's split below)
DECODE_LENGTHS = (0, 1, 40, 63, 64, 65, 159, 160, 161, 319, 320, 321, 479,
                  480, 481, 577, 640)
DECODE_TIMED_LENGTH = 576


def check_flash_decode(torch, np, dev, _kernels):
    """(b) the flash decode kernel against its plain version at the generate
    shape (B=8, H=12, d=64, L=640, bf16 cache): every length of
    DECODE_LENGTHS, q in float32 (the main path's: K1 and the unfused qkv
    projection return float32) and in bf16, sq 1 and 2; the same lengths
    under replays of one captured launch, bit for bit equal to eager
    launches; timed at length 576 with float32 q, with SDPA over the cache
    prefix as the library yardstick."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(SEED + 3)
    B, H, D, L = 8, 12, 64, DECODE_CAP
    splits, chunk = fa._flash_decode_split(L)
    edges = {b * chunk + o for b in range(1, splits) for o in (-1, 0, 1)}
    require(splits > 1 and edges <= set(DECODE_LENGTHS),
            f"flash_decode: the split at L={L} ({splits} blocks of {chunk}) "
            f"has edges {sorted(edges)} that DECODE_LENGTHS misses")

    def t(shape, dtype):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    k, v = t((B, H, L, D), torch.bfloat16), t((B, H, L, D), torch.bfloat16)
    cases = {}
    for qdtype in (torch.float32, torch.bfloat16):
        for sq in (1, 2):
            q = t((B, H, sq, D), qdtype)
            for n in DECODE_LENGTHS:
                length = torch.tensor(n, dtype=torch.int32, device=dev)
                out = fa.flash_decode_cuda(q, k, v, length)
                ref = fa.flash_decode_reference(q, k, v, length)
                torch.cuda.synchronize()
                # per element: the kernel rounds p to bf16 against the
                # running max of a 32-position chunk, the plain version
                # against the row's max (2^-9 relative each), so an element
                # moves by at most 2^-8 times the same attention over |v|;
                # a bf16 output is rounded once more (2^-7 relative); 1e-5
                # for float32 sums in another order.  A dropped or misread
                # chunk moves a row by far more
                abs_pv = fa.flash_decode_reference(q.float(), k,
                                                   v.float().abs(), length)
                tol = 2.0 ** -8 * abs_pv + 1e-5
                if qdtype == torch.bfloat16:
                    tol = tol + 2.0 ** -7 * ref.float().abs()
                tag = f"q {str(qdtype).split('.')[-1]}, sq={sq}, len={n}"
                cases[tag] = compare(torch, f"flash_decode {tag}", out, ref,
                                     tol)
                if n == 0:
                    require(float(out.abs().max()) == 0.0,
                            f"flash_decode {tag}: length 0 is not zero")
    # one captured launch serves every length (the kernel reads it from
    # device memory), and repeats bit for bit
    q = t((B, H, 1, D), torch.float32)
    length = torch.zeros((), dtype=torch.int32, device=dev)
    graph, held = torch.cuda.CUDAGraph(), {}
    recorded = _kernels.capture(
        graph, lambda: held.update(out=fa.flash_decode_cuda(q, k, v, length)))
    require(recorded == {"flash_decode": 1},
            f"flash_decode: the capture recorded {recorded}")
    for n in DECODE_LENGTHS:
        length.fill_(n)
        _kernels.replay(graph, recorded)
        replayed = held["out"].clone()
        _kernels.replay(graph, recorded)
        eager = fa.flash_decode_cuda(q, k, v, length)
        torch.cuda.synchronize()
        require(torch.equal(replayed, held["out"])
                and torch.equal(replayed, eager),
                f"flash_decode: len={n}: two replays and an eager launch "
                "differ")
    del graph
    worst = max(cases.values(), key=lambda r: r["err_over_tol"])
    log(f"check flash_decode graph replay: one capture, lengths "
        f"{list(DECODE_LENGTHS)}, two replays each equal an eager launch "
        "bit for bit")
    log(f"check flash_decode (B={B}, H={H}, d={D}, L={L}, bf16 cache): "
        f"{len(cases)} cases (q float32 / bf16, sq 1 / 2, lengths "
        f"{list(DECODE_LENGTHS)}), max_abs_err "
        f"{max(r['max_abs_err'] for r in cases.values()):.3e}, worst "
        f"err/tol {worst['err_over_tol']:.3f}")

    n = DECODE_TIMED_LENGTH
    q = t((B, H, 1, D), torch.float32)
    length = torch.tensor(n, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: fa.flash_decode_cuda(q, k, v, length))
    plain_ms = time_ms(torch,
                       lambda: fa.flash_decode_reference(q, k, v, length))
    # the bytes this length needs: q, the first n rows of K and V of every
    # (batch, head), the length and the float32 output; float32 products
    b_ms, b_by = bound(nbytes(q, length) + q.numel() * 4
                       + 2 * B * H * n * D * k.element_size(),
                       4.0 * B * H * n * D, F32_FLOPS)
    qb, ks, vs = q.to(torch.bfloat16), k[:, :, :n], v[:, :, :n]
    library_ms = time_ms(
        torch, lambda: TF.scaled_dot_product_attention(qb, ks, vs))
    log(f"time flash_decode (len {n}, float32 q): {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by})")
    return {"flash_decode": {
        "name": "flash_decode", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_decode.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:499",
        "launches": 0, "max_abs_err": max(r["max_abs_err"]
                                          for r in cases.values()),
        "tol": worst["tol"], "err_over_tol": worst["err_over_tol"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "library": f"scaled_dot_product_attention over the first {n} "
                   "positions (bf16 q, non-causal)",
        "peak": PEAK_F32,
        "shape": f"B={B}, H={H}, d={D}, L={L}, length {n}, float32 q over "
                 "a bf16 cache",
        "cluster": splits, "positions_per_block": chunk,
        "cases": len(cases)}}


# ---------------------------------------------------------------------------
# (c) serving
# ---------------------------------------------------------------------------
def serve(torch, np, dev, _kernels):
    from paddle_tpu_torch.convert import (SERVING_ENGINE, SERVING_NEW_TOKENS,
                                          serving_workload)
    from paddle_tpu_torch.inference import ServingEngine

    # reference on a small input: float32 on the card (kernels) against the
    # same weights on the CPU (plain versions)
    m_gpu, prompts = serving_workload(dev, dtype="float32")
    m_cpu, _ = serving_workload("cpu", dtype="float32")
    small = [prompts[0][:5], prompts[1][:23]]
    outs = []
    for m in (m_gpu, m_cpu):
        eng = ServingEngine(m, **SERVING_ENGINE, max_model_len=64,
                            capture_logits=True)
        rids = [eng.submit(p, max_new_tokens=4) for p in small]
        eng.run()
        outs.append([eng.collect(r) for r in rids])
    for a, b in zip(*outs):
        require(a["tokens"] == b["tokens"],
                f"float32 reference: card tokens {a['tokens']} != CPU "
                f"{b['tokens']}")
        err = max(float(np.abs(x - y).max())
                  for x, y in zip(a["logits"], b["logits"]))
        # float32 through 12 layers in another summation order: ~1e-5
        require(err <= 1e-3, f"float32 reference: logits differ by {err}")
    log(f"reference: float32 card vs CPU on {len(small)} prompts, tokens "
        f"identical, logits max_abs_err {err:.3e} <= 1e-3")
    del m_gpu, m_cpu

    model, prompts = serving_workload(dev)
    cfg = model.config
    require(cfg.dtype == "bfloat16" and cfg.use_fused_block
            and cfg.num_layers == 12 and cfg.hidden_size == 768
            and cfg.num_heads == 12 and cfg.vocab_size == 50304,
            "not the full-width bf16 fused GPT-125M")

    # warm-up (lazy CUDA and library set-up), logits checked for shape and
    # finiteness
    warm = ServingEngine(model, **SERVING_ENGINE, max_model_len=64,
                         capture_logits=True)
    wr = [warm.submit(p, max_new_tokens=4) for p in small]
    warm.run()
    for rid in wr:
        res = warm.collect(rid)
        for row in res["logits"]:
            require(row.shape == (cfg.vocab_size,)
                    and bool(np.isfinite(row).all()),
                    "bf16 warm-up: logits not finite / wrong shape")

    eng = ServingEngine(model, **SERVING_ENGINE)
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=SERVING_NEW_TOKENS)
            for p in prompts]
    steps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    results = [eng.collect(r) for r in rids]
    for res in results:
        require(len(res["tokens"]) == SERVING_NEW_TOKENS,
                f"{res['request_id']}: {len(res['tokens'])} tokens")
        require(all(0 <= tok < cfg.vocab_size for tok in res["tokens"]),
                f"{res['request_id']}: token outside the vocabulary")
    for name in SERVING_KERNELS:
        require(launches[name] > 0,
                f"{name}: launched 0 times on the serving path")
    st = eng.stats()
    require(st["kv_blocks"]["used"] == 0 and st["kv_blocks"]["leaked"] == 0,
            f"KV blocks not returned: {st['kv_blocks']}")
    generated = sum(len(r["tokens"]) for r in results)
    line = {"serving": {
        "model": "gpt_125m", "dtype": "bfloat16", "use_fused_block": True,
        "requests": len(results),
        "prompt_lengths": [len(p) for p in prompts],
        "generated_tokens": generated, "steps": steps,
        "wall_s": wall, "generated_tokens_per_s": generated / wall,
        "decode_step_ms_p50": st["step_ms"]["decode"]["p50"],
        "decode_steps": st["step_ms"]["decode"]["count"],
        "prefill_ms_p50": st["step_ms"]["prefill"]["p50"],
        "prefills": st["step_ms"]["prefill"]["count"],
        "ttft_ms_p50": st["slo"]["ttft_ms"]["p50"],
        "tpot_ms_p50": st["slo"]["tpot_ms"]["p50"],
        "launches": launches}}
    log(json.dumps(line))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# (c2) training
# ---------------------------------------------------------------------------
WARMUP_STEPS, TIMED_STEPS = 3, 10


def tiny_reference(torch, dev, cfg, what):
    """A float32 gpt_tiny-sized training step (S=256, no autocast) on the
    card (kernels) against the same weights and data on the CPU (plain
    versions): the loss, every gradient, and the loss after one AdamW
    step."""
    from paddle_tpu_torch.convert import training_workload
    runs = []
    for device in (dev, "cpu"):
        m, opt, ids, labels = training_workload(device, cfg, batch=2,
                                                seq_len=256)
        loss, _ = m(ids, labels=labels)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        opt.step()
        with torch.no_grad():
            loss2, _ = m(ids, labels=labels)
        runs.append((loss.item(), grads, loss2.item()))
    (l_gpu, g_gpu, l2_gpu), (l_cpu, g_cpu, l2_cpu) = runs
    # float32 end to end with exact products on both sides (TF32 off):
    # summation order only, ~1e-6 relative; the bounds leave a 10x margin
    # and a wrong kernel, mask or product is off by far more
    for tag, a, b in (("loss", l_gpu, l_cpu), ("loss after step", l2_gpu,
                                               l2_cpu)):
        require(abs(a - b) <= 1e-5 * abs(b),
                f"float32 {what} reference: {tag} {a} on the card, {b} on "
                "the CPU")
    worst = 0.0
    for name, ref in g_cpu.items():
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        err = float((g_gpu[name] - ref).abs().max())
        require(err <= tol, f"float32 {what} reference: grad {name} "
                f"differs by {err} > {tol}")
        worst = max(worst, err / tol)
    log(f"{what} reference: float32 gpt_tiny (S=256) card vs CPU, loss "
        f"{l_gpu:.6f} vs {l_cpu:.6f}, {len(g_cpu)} gradients within 1e-4 "
        f"of their range + 1e-6 (worst err/tol {worst:.3f}), loss after one "
        f"AdamW step {l2_gpu:.6f} vs {l2_cpu:.6f}")


def timed_steps(torch, np, _kernels, model, opt, ids, labels, kernels,
                what):
    """WARMUP_STEPS + TIMED_STEPS training steps on one batch, each ending
    in the loss readback, with every launch counter zeroed just before:
    each of ``kernels`` must launch once per layer and step, and the loss
    must be finite and fall.  Returns the fields of the JSON line."""
    from paddle_tpu_torch.training import train_step
    cfg = model.config
    b, s = ids.shape
    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = train_step(model, opt, ids, labels)
        losses.append(float(loss))      # the readback ends the step
        times.append(time.perf_counter() - t0)
    launches = dict(_kernels.launches)
    for name in kernels:
        require(launches[name] == cfg.num_layers * steps,
                f"{name}: {launches[name]} launches in {steps} {what} "
                f"steps, not {cfg.num_layers} per step")
    require(all(np.isfinite(losses)), f"nonfinite {what} loss: {losses}")
    require(losses[-1] < losses[0],
            f"the {what} loss did not fall on the repeated batch: {losses}")
    step_ms = [x * 1e3 for x in times[WARMUP_STEPS:]]
    p50 = statistics.median(step_ms)
    tokens_per_s = b * s / (p50 / 1e3)
    n_params = sum(p.numel() for p in model.parameters())
    # paddle_tpu/observability/mfu.py flops_per_token: 6N for the matmuls
    # plus the causal attention term 12 L h S / 2
    flops_per_token = (6.0 * n_params
                       + 12.0 * cfg.num_layers * cfg.hidden_size * s / 2.0)
    return {
        "model": "gpt_125m", "dtype": "bfloat16", "amp": "O1",
        "optimizer": "AdamW(learning_rate=1e-4, weight_decay=0.01)",
        "B": b, "S": s, "params": n_params,
        "steps": {"warmup": WARMUP_STEPS, "timed": TIMED_STEPS},
        "step_ms_p50": p50, "step_ms": step_ms,
        "tokens_per_s": tokens_per_s,
        "flops_per_token": flops_per_token,
        "mfu": tokens_per_s * flops_per_token / BF16_FLOPS,
        "mfu_peak": "989 TFLOP/s bf16 dense",
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}


def train(torch, np, dev, _kernels):
    from paddle_tpu_torch.convert import training_workload
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.ops import fused

    tiny_reference(torch, dev, gpt_tiny(hidden_dropout=0.0,
                                        attention_dropout=0.0,
                                        use_pallas_attention=True),
                   "training")
    model, opt, ids, labels = training_workload(dev)
    cfg = model.config
    require(cfg.dtype == "bfloat16" and cfg.use_pallas_attention
            and not cfg.use_fused_block and cfg.fused_lm_loss
            and cfg.num_layers == 12 and cfg.hidden_size == 768
            and cfg.num_heads == 12 and cfg.vocab_size == 50304
            and tuple(ids.shape) == (8, 2048),
            "not the full-width bf16 GPT-125M training step at B=8, S=2048")
    line = timed_steps(torch, np, _kernels, model, opt, ids, labels,
                       TRAINING_KERNELS, "training")
    line["lm_head_products"] = ("bf16 mm, float32 out" if fused._MM_OUT_DTYPE
                                else "float32 mm of widened bf16")
    log(json.dumps({"training": line}))
    return {"launches": line["launches"], "step_ms_p50": line["step_ms_p50"]}


# ---------------------------------------------------------------------------
# (c2b) fused-block training
# ---------------------------------------------------------------------------
DROP_ROWS = (8, 4096, 16384)     # decode rows (K3: several cluster groups),
# the generate prefill's rows, the training shape (B=8 x S=2048; one group,
# whose float32 sum goes through the finalize kernel, which applies drop2)
DROP_P = 0.1
# a residual this small next to the addend (|y| ~ 0.1-1) never absorbs a
# kept value, and a dropped one leaves it bit for bit; K3's LN is
# scale-free given an epsilon below such rows' variance (~2^-80)
TINY, TINY_EPS = 2.0 ** -40, 1e-30


def check_dropout(torch, np, dev, results):
    """(c2b) K2 and K3 with the hash dropout against their plain versions,
    at the fused training path's dtypes (bf16 O1: bf16 activations and
    weights, float32 biases and LN parameters; so the bound takes the bf16
    peak, whatever the kernels multiply in) and p=0.1 (K2's dropout, K3's
    dropout2); K3's dropout1 (off on the path) in float32 at N=4096.  Per N
    the values hold within one bf16 unit, and with a residual of 2^-40 the
    dropped elements are exactly the complement of the hash mask, for the
    kernel and the plain version.  Timed at N=16384, at p=0.1 and p=0."""
    from paddle_tpu_torch.ops import fused_block as fb
    rng = np.random.default_rng(SEED + 7)
    bf16 = torch.bfloat16

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).to(dev).to(dtype)

    h, ffn, eps, seed = 768, 3072, 1e-5, 20260417
    g, beta = t((h,), std=0.1, mean=1.0), t((h,), std=0.1)
    w_out, b_out = t((h, h), bf16, std=0.02), t((h,), std=0.02)
    w1, b1 = t((h, ffn), bf16, std=0.02), t((ffn,), std=0.02)
    w2, b2 = t((ffn, h), bf16, std=0.02), t((h,), std=0.02)
    salt = fb._SALT_RESID
    out = {"linear_residual": {}, "ffn": {}}

    def zero_set(name, n, kernel, plain, base, salt_, p):
        keep = fb._keep_mask(seed, salt_, torch.arange(n, device=dev)[:, None],
                             torch.arange(h, device=dev)[None, :], p)
        for who, fn in (("kernel", kernel), ("plain", plain)):
            got = fn()
            torch.cuda.synchronize()
            require(torch.equal(got == base, ~keep),
                    f"{name} N={n}: the {who}'s dropped elements are not the "
                    f"hash mask's ({int(((got == base) != ~keep).sum())} "
                    "differ)")
        return int((~keep).sum())

    for n in DROP_ROWS:
        x_res = t((n, h), bf16)
        attn = t((n, h), bf16)
        tiny = (x_res.float() * TINY).to(bf16)
        timed = n == DROP_ROWS[-1]
        k2 = measure(
            torch, f"linear_residual N={n} p={DROP_P}",
            lambda: fb.linear_residual_cuda(attn, w_out, b_out, x_res, seed,
                                            DROP_P),
            lambda: fb.linear_residual_reference(attn, w_out, b_out, x_res,
                                                 seed, DROP_P),
            bf16_tol,
            (nbytes(attn, w_out, b_out, x_res) + n * h * 2, 2.0 * n * h * h),
            BF16_FLOPS, timed)
        k2["dropped"] = zero_set(
            "linear_residual", n,
            lambda: fb.linear_residual_cuda(attn, w_out, b_out, tiny, seed,
                                            DROP_P),
            lambda: fb.linear_residual_reference(attn, w_out, b_out, tiny,
                                                 seed, DROP_P),
            tiny, salt, DROP_P)
        k3 = measure(
            torch, f"ffn N={n} dropout2={DROP_P}",
            lambda: fb.ffn_cuda(x_res, w1, b1, w2, b2, g, beta, seed, "gelu",
                                0.0, DROP_P, eps),
            lambda: fb.ffn_reference(x_res, w1, b1, w2, b2, g, beta, seed,
                                     "gelu", 0.0, DROP_P, eps),
            bf16_tol,
            (nbytes(x_res, w1, b1, w2, b2, g, beta) + n * h * 2,
             4.0 * n * h * ffn), BF16_FLOPS, timed)
        k3["dropped"] = zero_set(
            "ffn", n,
            lambda: fb.ffn_cuda(tiny, w1, b1, w2, b2, g, beta, seed, "gelu",
                                0.0, DROP_P, TINY_EPS),
            lambda: fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, seed,
                                     "gelu", 0.0, DROP_P, TINY_EPS),
            tiny, fb._SALT_FFN2, DROP_P)
        k3["groups"], k3["cluster"] = fb._ffn_grid(dev, n, h, ffn)
        require((k3["groups"] > 1) == (n == 8),
                f"ffn N={n}: {k3['groups']} cluster groups; the checks need "
                "several at N=8 and one at the larger shapes")
        if timed:
            # what the hash costs: the launch at p=0 and at p, alternated
            # twice after the timing above; each is the mean of its two
            for r, p0, p in (
                    (k2, lambda: fb.linear_residual_cuda(
                        attn, w_out, b_out, x_res),
                     lambda: fb.linear_residual_cuda(
                         attn, w_out, b_out, x_res, seed, DROP_P)),
                    (k3, lambda: fb.ffn_cuda(
                        x_res, w1, b1, w2, b2, g, beta, epsilon=eps),
                     lambda: fb.ffn_cuda(
                         x_res, w1, b1, w2, b2, g, beta, seed, "gelu", 0.0,
                         DROP_P, eps))):
                ab = [time_ms(torch, fn) for fn in (p0, p, p0, p)]
                r["ms_p0"] = (ab[0] + ab[2]) / 2
                r["ms_alternated"] = (ab[1] + ab[3]) / 2
        out["linear_residual"][f"N={n}"] = k2
        out["ffn"][f"N={n}"] = k3
        for name in out:
            r = out[name][f"N={n}"]
            timing = (f"; {r['ms']:.4f} ms at p={DROP_P} (alternated with "
                      f"p=0: {r['ms_alternated']:.4f} against "
                      f"{r['ms_p0']:.4f} ms; plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})"
                      if timed else "")
            log(f"check {name} N={n} p={DROP_P} (bf16): max_abs_err "
                f"{r['max_abs_err']:.3e}, err/tol {r['err_over_tol']:.3f}; "
                f"{r['dropped']} dropped elements equal to the hash mask's, "
                f"kernel and plain{timing}")
        del x_res, attn, tiny

    # K1 at the training shape, for the kernel table beside K2 and K3 (no
    # dropout; bf16 weights under O1, so a bf16 output)
    n = DROP_ROWS[-1]
    x_res = t((n, h), bf16)
    w_qkv, b_qkv = t((h, 3 * h), bf16, std=0.02), t((3 * h,), std=0.02)
    k1 = measure(
        torch, f"ln_linear N={n} (bf16)",
        lambda: fb.ln_linear_cuda(x_res, w_qkv, b_qkv, g, beta, eps),
        lambda: fb.ln_linear_reference(x_res, w_qkv, b_qkv, g, beta, eps),
        bf16_tol, (nbytes(x_res, w_qkv, b_qkv, g, beta) + n * 3 * h * 2,
                   2.0 * n * h * 3 * h), BF16_FLOPS)
    log(f"check ln_linear N={n} (bf16): max_abs_err {k1['max_abs_err']:.3e}, "
        f"err/tol {k1['err_over_tol']:.3f}; {k1['ms']:.4f} ms (plain "
        f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms by "
        f"{k1['bound_by']})")
    results["ln_linear"]["training_shape"] = {
        "shape": f"N={n}, bf16 O1", "peak": PEAK_BF16, **{k: k1[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "err_over_tol")}}
    del x_res

    # dropout1 (after the activation, over the global ffn column), off on
    # the training path: float32 operands, where one misplaced element of
    # the (N, ffn) mask moves the output far past the tolerance
    n = 4096
    x32 = t((n, h))
    f32w = [a.float() for a in (w1, b1, w2, b2)]
    k3d1 = measure(
        torch, "ffn N=4096 dropout1=0.2 dropout2=0.1 (float32)",
        lambda: fb.ffn_cuda(x32, *f32w, g, beta, seed, "gelu", 0.2, DROP_P,
                            eps),
        lambda: fb.ffn_reference(x32, *f32w, g, beta, seed, "gelu", 0.2,
                                 DROP_P, eps),
        lambda ref: 1e-4, (0, 0), timed=False)
    log(f"check ffn N={n} dropout1=0.2 dropout2={DROP_P} (float32): "
        f"max_abs_err {k3d1['max_abs_err']:.3e} <= 1e-4")
    out["ffn"]["N=4096, dropout1=0.2, float32"] = k3d1

    for name, per in out.items():
        worst = max(per.values(), key=lambda r: r["err_over_tol"])
        train_r = per[f"N={DROP_ROWS[-1]}"]
        results[name]["dropout"] = {
            "p": DROP_P, "seed": seed,
            "shapes": per, "worst_err_over_tol": worst["err_over_tol"],
            "zero_sets": "identical to the hash mask, kernel and plain"}
        results[name]["training_shape"] = {
            "shape": f"N={DROP_ROWS[-1]}, bf16 O1, p={DROP_P}",
            "peak": PEAK_BF16,
            "ms": train_r["ms"], "ms_p0": train_r["ms_p0"],
            "ms_alternated": train_r["ms_alternated"],
            "plain_ms": train_r["plain_ms"], "bound_ms": train_r["bound_ms"],
            "bound_by": train_r["bound_by"]}


def train_fused(torch, np, dev, _kernels, unfused_p50):
    from paddle_tpu_torch.convert import fused_training_workload
    from paddle_tpu_torch.models.gpt import gpt_tiny

    # as in (c2), with the card's K1-K3 and flash kernels and the recompute
    # backward against the CPU's plain versions (the card's attention is the
    # flash kernel, the CPU's the plain top-left composition: equal when
    # q_len == kv_len)
    tiny_reference(torch, dev, gpt_tiny(hidden_dropout=0.0,
                                        attention_dropout=0.0,
                                        use_pallas_attention=True,
                                        use_fused_block=True),
                   "fused training")
    model, opt, ids, labels = fused_training_workload(dev)
    cfg = model.config
    require(cfg.dtype == "bfloat16" and cfg.use_pallas_attention
            and cfg.use_fused_block and cfg.hidden_dropout == 0.1
            and cfg.attention_dropout == 0.1 and cfg.num_layers == 12
            and cfg.hidden_size == 768 and cfg.num_heads == 12
            and cfg.vocab_size == 50304 and tuple(ids.shape) == (8, 2048),
            "not the full-width bf16 fused GPT-125M training leg at B=8, "
            "S=2048, dropout 0.1")
    line = timed_steps(torch, np, _kernels, model, opt, ids, labels,
                       FUSED_TRAINING_KERNELS, "fused training")
    line = {"use_fused_block": True, "hidden_dropout": cfg.hidden_dropout,
            "attention_dropout": cfg.attention_dropout, **line,
            "unfused_step_ms_p50": unfused_p50}
    log(json.dumps({"fused_training": line}))
    return {"launches": line["launches"], "step_ms_p50": line["step_ms_p50"]}


# ---------------------------------------------------------------------------
# (c3) generate
# ---------------------------------------------------------------------------
FUSED_KERNELS = ("ln_linear", "linear_residual", "ffn")
GENERATE_CALLS = 3      # timed calls per variant; their medians are reported


def eager_decode(torch, model, prompts, new_tokens):
    """Greedy decoding by an eager loop of ``generate_step`` (no CUDA graph):
    tokens and each step's CUDA-event ms, prefill first."""
    b, plen = prompts.shape
    caches = model.make_caches(b, plen + new_tokens)
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    chunk, out = prompts, [prompts]
    for _ in range(new_tokens):
        logits, caches = model.generate_step(chunk, caches, caches[0][2])
        chunk = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
        out.append(chunk)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    events[-1].synchronize()
    return torch.cat(out, dim=1), [a.elapsed_time(z) for a, z
                                   in zip(events, events[1:])]


SAMPLE_TEMPERATURE, SAMPLE_TOP_K = 0.8, 5


def eager_sample(torch, model, prompts, new_tokens, temperature, top_k,
                 seed):
    """Sampled decoding by an eager loop of ``generate_step`` with the
    sampler of ``generate`` and a generator seeded as ``generate`` seeds
    its own: the tokens, and whether every token was among the ``top_k``
    largest logits of its step."""
    from paddle_tpu_torch.models.gpt import _sample
    b, plen = prompts.shape
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    caches = model.make_caches(b, plen + new_tokens)
    chunk, out, in_top_k = prompts, [prompts], True
    for _ in range(new_tokens):
        logits, caches = model.generate_step(chunk, caches, caches[0][2])
        step = logits[:, -1].float()
        nxt = _sample(step, temperature, top_k, gen)
        kth = torch.topk(step, top_k, dim=-1).values[:, -1]
        in_top_k &= bool((step.gather(1, nxt.long()[:, None])[:, 0]
                          >= kth).all())
        chunk = nxt[:, None]
        out.append(chunk)
    return torch.cat(out, dim=1), in_top_k


def check_sampling(torch, model, prompts, greedy, fused):
    """Sampled ``generate`` on the card, where the decode step is a graph
    replay: the capturing call and a replaying call with one seed give the
    same tokens, which are those of an eager loop with a generator of that
    seed (each replay draws fresh noise from the registered generator) and
    lie among each step's top-k logits; another seed gives other tokens;
    ``top_k=1`` gives the greedy tokens."""
    new = greedy.shape[1] - prompts.shape[1]
    kw = dict(max_new_tokens=new, temperature=SAMPLE_TEMPERATURE,
              top_k=SAMPLE_TOP_K)
    first = model.generate(prompts, seed=7, **kw)            # captures
    again = model.generate(prompts, seed=7, **kw)            # replays
    other = model.generate(prompts, seed=8, **kw)
    eager, in_top_k = eager_sample(torch, model, prompts, new,
                                   SAMPLE_TEMPERATURE, SAMPLE_TOP_K, 7)
    one = model.generate(prompts, seed=7, **{**kw, "top_k": 1})
    require(torch.equal(first, again), f"sampling (fused={fused}): the "
            "capturing and the replaying call differ with one seed")
    require(torch.equal(first, eager), f"sampling (fused={fused}): graph "
            f"replays {first.tolist()} != eager loop {eager.tolist()}")
    require(in_top_k, f"sampling (fused={fused}): a token outside the "
            f"top {SAMPLE_TOP_K}")
    require(not torch.equal(first, other), f"sampling (fused={fused}): "
            "seeds 7 and 8 give the same tokens")
    require(torch.equal(one, greedy), f"sampling (fused={fused}): top_k=1 "
            "differs from greedy")
    log(f"sampling (fused={fused}, float32, temperature "
        f"{SAMPLE_TEMPERATURE}, top_k {SAMPLE_TOP_K}): capture and replay "
        "identical per seed and equal to an eager loop, every token in the "
        "top k, another seed differs, top_k=1 equals greedy")


def generate(torch, np, dev, _kernels):
    from paddle_tpu_torch.convert import (GENERATE_NEW_TOKENS,
                                          generate_workload)
    from paddle_tpu_torch.profile_generate import timed_generate

    # reference on a small input: float32 on the card (kernels, CUDA graph)
    # against the same weights on the CPU (plain versions, eager)
    for fused in (False, True):
        m_gpu, prompts = generate_workload(dev, dtype="float32",
                                           use_fused_block=fused)
        m_cpu, _ = generate_workload("cpu", dtype="float32",
                                     use_fused_block=fused)
        small = prompts[:2, :16].cpu()
        toks = [m.generate(small.to(m.device), max_new_tokens=8).cpu()
                for m in (m_gpu, m_cpu)]
        require(torch.equal(toks[0], toks[1]),
                f"float32 generate reference (fused={fused}): card tokens "
                f"{toks[0].tolist()} != CPU {toks[1].tolist()}")
        logits = []
        for m in (m_gpu, m_cpu):
            ids = small.to(m.device)
            caches = m.make_caches(2, 24)
            l0, caches = m.generate_step(ids, caches, 0)
            nxt = l0[:, -1].argmax(-1).to(torch.int32)[:, None]
            l1, _ = m.generate_step(nxt, caches, caches[0][2])
            logits.append((l0.cpu(), l1.cpu()))
        err = max(float((a - b).abs().max())
                  for a, b in zip(*logits))
        # float32 through 12 layers in another summation order: ~1e-5
        require(err <= 1e-3, f"float32 generate reference (fused={fused}): "
                f"generate_step logits differ by {err}")
        log(f"generate reference (fused={fused}): float32 card vs CPU, 2 x "
            f"16 prompt, 8 greedy tokens identical; prefill and first "
            f"decode-step logits max_abs_err {err:.3e} <= 1e-3")
        check_sampling(torch, m_gpu, small.to(dev), toks[0].to(dev), fused)
        del m_gpu, m_cpu
    torch.cuda.empty_cache()

    variants, total = {}, {name: 0 for name in _kernels.KERNELS}
    for fused in (False, True):
        tag = "fused" if fused else "unfused"
        model, prompts = generate_workload(dev, use_fused_block=fused)
        cfg = model.config
        require(cfg.dtype == "bfloat16" and cfg.num_layers == 12
                and cfg.hidden_size == 768 and cfg.num_heads == 12
                and cfg.vocab_size == 50304
                and cfg.use_fused_block == fused
                and cfg.use_pallas_attention == (not fused)
                and tuple(prompts.shape) == (8, 512),
                f"not the full-width bf16 GPT-125M generate workload "
                f"({tag})")
        b, plen = prompts.shape
        # warm-up: the first call captures the decode step's graph
        warm = model.generate(prompts, max_new_tokens=GENERATE_NEW_TOKENS)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        calls = []              # (tokens, step ms, wall s) per timed call
        for _ in range(GENERATE_CALLS):
            t0 = time.perf_counter()
            out, steps = timed_generate(model, prompts, GENERATE_NEW_TOKENS)
            torch.cuda.synchronize()
            calls.append((out, steps, time.perf_counter() - t0))
        launches = dict(_kernels.launches)
        decode_steps = GENERATE_NEW_TOKENS - 1
        require(all(torch.equal(c[0], out) for c in calls),
                f"generate ({tag}): the timed calls disagree")
        prefill = statistics.median(c[1][0] for c in calls)
        step_p50 = statistics.median(
            statistics.median(c[1][1:]) for c in calls)
        wall = statistics.median(c[2] for c in calls)
        require(tuple(out.shape) == (b, plen + GENERATE_NEW_TOKENS)
                and bool(((out >= 0) & (out < cfg.vocab_size)).all())
                and torch.equal(out[:, :plen], prompts),
                f"generate ({tag}): bad output {tuple(out.shape)}")
        require(torch.equal(out, warm),
                f"generate ({tag}): the capturing call and the replaying "
                "call disagree")
        require(launches["flash_decode"]
                == cfg.num_layers * decode_steps * GENERATE_CALLS,
                f"flash_decode ({tag}): {launches['flash_decode']} launches "
                f"in {GENERATE_CALLS} x {decode_steps} decode steps, not "
                f"{cfg.num_layers} per step")
        for name in FUSED_KERNELS:
            require((launches[name] > 0) == fused,
                    f"{name} ({tag}): {launches[name]} launches")
        eager, eager_steps = eager_decode(torch, model, prompts,
                                          GENERATE_NEW_TOKENS)
        require(torch.equal(eager, out),
                f"generate ({tag}): the eager generate_step loop gives "
                "other tokens than the CUDA-graph run")
        for name in total:
            total[name] += launches[name]
        variants[tag] = {
            "use_fused_block": fused, "use_pallas_attention": not fused,
            "calls": GENERATE_CALLS, "prefill_ms": prefill,
            "decode_step_ms_p50": step_p50,
            "decode_steps": decode_steps, "wall_s": wall,
            "per_call": [{"prefill_ms": c[1][0],
                          "decode_step_ms_p50": statistics.median(c[1][1:]),
                          "wall_s": c[2]} for c in calls],
            "generated_tokens": b * GENERATE_NEW_TOKENS,
            "generated_tokens_per_s": b * GENERATE_NEW_TOKENS / wall,
            "eager_prefill_ms": eager_steps[0],
            "eager_decode_step_ms_p50": statistics.median(eager_steps[1:]),
            "graph_vs_eager_tokens": "identical",
            "launches": {k: v for k, v in launches.items() if v}}
        log(f"generate ({tag}): prefill {prefill:.3f} ms, decode step p50 "
            f"{variants[tag]['decode_step_ms_p50']:.4f} ms (CUDA graph) vs "
            f"{variants[tag]['eager_decode_step_ms_p50']:.4f} ms (eager "
            f"loop, same tokens), "
            f"{variants[tag]['generated_tokens_per_s']:.1f} tok/s")
        del model, warm, out, eager, calls
        torch.cuda.empty_cache()
    log(json.dumps({"generate": {
        "model": "gpt_125m", "dtype": "bfloat16", "B": 8, "prompt_len": 512,
        "new_tokens": GENERATE_NEW_TOKENS, "variants": variants}}))
    return {"launches": total}


if __name__ == "__main__":
    sys.exit(main())
