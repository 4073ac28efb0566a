#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
H100.  Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints no
``ok`` line):

  (a) build   the CUDA kernels from paddle_tpu_torch/csrc/ (one nvcc per
              source, in parallel) into build/paddle_tpu_torch/;
  (b) kernels each kernel at its path's shapes and dtypes against its
              plain PyTorch version on the card, with a stated tolerance;
              times by CUDA events (median, L2 flushed).  The flash kernels
              at the training shape (B=8, H=12, S=2048, d=64, bf16, causal),
              plus a dropout case (B=2, H=4, S=512, p=0.1) and a ragged one
              (sq=136, sk=200) that are checked but not timed;
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
        for line in _kernels.ptxas_report(name).splitlines():
            log(f"  {name}: {line.strip()}")

    # -- (b) each kernel against its plain version ---------------------------
    results = check_kernels(torch, np, dev)

    results.update(check_flash(torch, np, dev))

    # -- (c) serving ---------------------------------------------------------
    serving = serve(torch, np, dev, _kernels)

    # -- (c2) training -------------------------------------------------------
    training = train(torch, np, dev, _kernels)

    # -- (d) kernel list: launches from the path each kernel belongs to ------
    for r in results.values():
        path = training if r["name"] in TRAINING_KERNELS else serving
        r["launches"] = path["launches"][r["name"]]
        require(r["launches"] > 0,
                f"{r['name']}: no launch on its main path")
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
# (b) kernels
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int = 25) -> float:
    """Median of per-launch CUDA-event times, with the 50 MB L2 flushed
    before each launch (the serving path finds every layer's weights
    cold)."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
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
    for n in (8, 512):                   # decode rows; largest prefill bucket
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
                lambda: fb.ffn_cuda(x_res, w1, b1, w2, b2, g, beta, "gelu",
                                    eps),
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
    B, H, D, bs, per_row = 8, 12, 64, 16, 64
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
    return results


FLASH_CASES = {
    # tag: (B, H, sq, sk, d, dropout_p, dtype, timed); "train" is the shape
    # of the training step and the one timed
    "train": (8, 12, 2048, 2048, 64, 0.0, "bfloat16", True),
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
    shape (timed, with SDPA as the library yardstick), a dropout case and
    a ragged sq != sk case (checked only)."""
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


def train(torch, np, dev, _kernels):
    from paddle_tpu_torch.convert import training_workload
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.training import train_step

    # reference on a small model: float32 on the card (kernels) against the
    # same weights and data on the CPU (plain versions), one step (forward,
    # backward, AdamW) without autocast, then the next step's loss
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   use_pallas_attention=True)
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
    for what, a, b in (("loss", l_gpu, l_cpu), ("loss after step", l2_gpu,
                                                l2_cpu)):
        require(abs(a - b) <= 1e-5 * abs(b),
                f"float32 training reference: {what} {a} on the card, {b} "
                f"on the CPU")
    worst = 0.0
    for name, ref in g_cpu.items():
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        err = float((g_gpu[name] - ref).abs().max())
        require(err <= tol, f"float32 training reference: grad {name} "
                f"differs by {err} > {tol}")
        worst = max(worst, err / tol)
    log(f"training reference: float32 gpt_tiny (S=256) card vs CPU, loss "
        f"{l_gpu:.6f} vs {l_cpu:.6f}, {len(g_cpu)} gradients within 1e-4 "
        f"of their range + 1e-6 (worst err/tol {worst:.3f}), loss after one "
        f"AdamW step {l2_gpu:.6f} vs {l2_cpu:.6f}")

    model, opt, ids, labels = training_workload(dev)
    cfg = model.config
    require(cfg.dtype == "bfloat16" and cfg.use_pallas_attention
            and not cfg.use_fused_block and cfg.fused_lm_loss
            and cfg.num_layers == 12 and cfg.hidden_size == 768
            and cfg.num_heads == 12 and cfg.vocab_size == 50304
            and tuple(ids.shape) == (8, 2048),
            "not the full-width bf16 GPT-125M training step at B=8, S=2048")
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
    for name in TRAINING_KERNELS:
        require(launches[name] == cfg.num_layers * steps,
                f"{name}: {launches[name]} launches in {steps} steps, not "
                f"{cfg.num_layers} per step")
    require(all(np.isfinite(losses)), f"nonfinite loss: {losses}")
    require(losses[-1] < losses[0],
            f"the loss did not fall on the repeated batch: {losses}")
    step_ms = [x * 1e3 for x in times[WARMUP_STEPS:]]
    p50 = statistics.median(step_ms)
    tokens_per_s = b * s / (p50 / 1e3)
    n_params = sum(p.numel() for p in model.parameters())
    # paddle_tpu/observability/mfu.py flops_per_token: 6N for the matmuls
    # plus the causal attention term 12 L h S / 2
    flops_per_token = (6.0 * n_params
                       + 12.0 * cfg.num_layers * cfg.hidden_size * s / 2.0)
    line = {"training": {
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
        "lm_head_products": ("bf16 mm, float32 out" if fused._MM_OUT_DTYPE
                             else "float32 mm of widened bf16"),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}}
    log(json.dumps(line))
    return {"launches": launches}


if __name__ == "__main__":
    sys.exit(main())
