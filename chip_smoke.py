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
              instantiations; likewise every instantiation of the
              tensor-core K1-K3 of bf16 weights (ln_linear_mma: two
              hidden sizes; linear_residual_mma: two hidden sizes x
              dropout; ffn_mma: two hidden sizes x drop1) must hold HMMA
              and the h=768 ones must not spill, with their registers and
              shared memory a block logged; both instantiations of the
              weight-streaming K2 / K3 of float32 weights
              (linear_residual_stream, ffn_stream) must neither spill nor
              keep a stack frame, and their grid at GPT-125M for N = 1,
              8, 16, 32, 64 is logged (cluster size, blocks, bytes in flight
              and shared memory a block, K3's scratch, the clusters the
              card holds at once); K1's float32 kernels
              (ln_linear_stream, ln_linear_tiled) must neither spill nor
              keep a stack frame, with the stream grid at N = 8 and 64 and
              the tiled kernel's shared memory and depth split logged; so
              must every instantiation of K3's and K2's tiled kernels
              (ffn_tiled: up pass by x dtype x drop1, down pass by drop2;
              linear_residual_tiled: x dtype x dropout), with their
              registers, shared memory a block and depth splits at N =
              128, 512, 4096 logged; the decode
              kernel's registers, spills and cluster split at the generate
              shape are logged, and the paged-decode kernel's at the
              serving table width;
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
              two launches must give the same bits; the weight-streaming
              K3 (ffn_stream) and K2 (linear_residual_stream) of float32
              weights at every N from 1 to the larger of
              fused_block._FFN_STREAM_MAX_ROWS and _RESID_STREAM_MAX_ROWS
              (each route takes them up to its own), at N=8 also with
              float32 x / r and with dropout (dropped elements the hash
              mask's, a bias left out rejected, two calls bit-identical),
              timed at N = 1, 8, 16,
              32, 64 against the SIMT kernel they replace there and the
              plain version, alternated (each faster than both at N=8, or
              the phase fails); K1 of float32 weights (h=768, 2304
              columns, bf16 x) through its route: ln_linear_stream at every
              N from 1 to _LN_STREAM_MAX_ROWS, ln_linear_tiled at N = 128,
              512, 4096 and a ragged tile (300 rows x 200 columns), both
              with float32 x too, within 1e-4 of the plain version, b left
              out rejected, two calls bit-identical; timed at N = 1, 8, 16,
              32, 48, 64, 128, 512, 4096 alternated with the SIMT ln_linear
              and the plain version (both float32 routes at 16-128: the
              numbers that set the route's bound), the route's kernel
              faster than the SIMT one at N=8 and 4096, or the phase
              fails; ln_linear_tiled's outputs at N = 128, 512, 4096
              bit-identical to the kernel's before its body moved into
              csrc/tiled.cuh (sha256, LN_TILED_DIGESTS); K3's and K2's
              tiled kernels (ffn_tiled, linear_residual_tiled; float32
              weights, bf16 residual) through their routes at N = 33, 65,
              128, 300 (ragged), 512, 4096 with bf16 and float32 x, with
              dropout at N = 300 and 512 (the addend with a residual of
              2^-40 within one bf16 unit, its dropped elements the hash
              mask's, a K3 without b1 and a K2 without b rejected, drop1's
              mask with W2 the identity, two calls bit-identical); timed at
              N = 16, 32, 48, 64, 96, 128, 512, 4096 alternated with the
              SIMT kernel and the plain version (the stream kernel too up
              to 128: the numbers that set each route's bound), each tiled
              kernel faster than its SIMT kernel at N = 512 and 4096, or
              the phase fails;
  (c) serving GPT-125M at full width (12 layers, h=768, 12 heads, vocab
              50304, bf16 activations, use_fused_block) with seeded random
              weights loaded through convert.py, served by ServingEngine:
              8 ragged prompts x 32 greedy tokens.  Every kernel's launch
              counter is zeroed just before this run and must be > 0 after
              (ln_linear_mma, linear_residual_mma and ffn_mma, the
              bf16-weight K1-K3, and the SIMT ln_linear, linear_residual
              and ffn must not launch: serving multiplies float32
              weights); the rows of every K1-K3 call are recorded: the
              decode steps' 8 rows take ffn_stream,
              linear_residual_stream and ln_linear_stream once per layer,
              and ffn_tiled, linear_residual_tiled and ln_linear_tiled
              exactly the layer calls of the prefill buckets above their
              bounds (12 x those buckets).
              Beforehand, a float32 run on a small input is held against
              the same model on the CPU (plain versions): tokens identical,
              logits within 1e-3;
  (c1b) serving lifecycle  the same workload through the engine's
              request lifecycle.  (i) bf16, NaN guard on, a run_dir:
              request 2 raises on its decode steps (bisection probes run
              paged decode and the stream K1-K3 on pad rows), request 5
              gives NaN logits, request 6 is cancelled after its 4th
              token, the clock passes request 7's deadline mid-run, and
              the pool is defragmented whenever a finish leaves it
              non-compact: requests 0, 1, 3 and 4 must give (c)'s tokens
              exactly, every reason must be the one set, two quarantine
              records must be on disk, and the allocator must balance;
              the probes' kernel launches and the defrag moves are logged.
              (ii) float32: an uninterrupted run, then request 3 hangs on
              a decode step under a watchdog of 20x that run's slowest
              step (and at least 1 s), recovered by preempting the running
              set, then drain(timeout=) mid-run and resume() in a fresh
              engine: every request must finish with the uninterrupted
              tokens (else the first differing position and the top-2
              logit margin there are printed), watchdog_restarts == 1.
              (iii) a StatusServer on port 0 over the bf16 engine:
              /healthz 200 then 503 "draining" after begin_drain, /statusz's
              resilience section equal to stats(), /metrics with serve_
              series.  (iv) Config().enable_continuous_batching(8, 16),
              set_decoder_model(model, 32), create_predictor, run(): the
              output rows must be the prompts + (c)'s tokens.  (v) the
              host ms p50 of a decode step with the guard, a registry with
              a JSONL sink and request tracing on, against the engine with
              all three off, alternated in one process.  (i b, run after
              iii) the NaN guard on the card: no fault seam, a
              serving_step hook makes request 1's logits NaN on one decode
              step; it must end "poisoned" with no bisection probe, the
              others must give (c)'s tokens, and no tensor of vocab width
              may reach the host.  (vi) the host time of a prefill and a
              decode step of the engine as a user gets it, split into the
              parts the lifecycle added (reaper, gauges, spans, step
              guard, registry calls) and the rest;
  (c1c) serving fleet  the fleet (paddle_tpu_torch.inference.fleet) over
              the float32 serving workload (convert.serving_workload:
              GPT-125M at full width and depth, SERVING_SEED weights, the
              8 prompts, SERVING_ENGINE), 64 greedy tokens a stream, every
              stream held token for token against one uninterrupted
              float32 engine on the card (else the first differing
              position, the reference's top-2 logit margin there and the
              rows of the prefill that rebuilt the stream are printed).
              (i) in process: two LocalReplica engines under a Router, the
              replica serving stream 0 stopped once it has 3 tokens
              (failovers >= 1, fleet.failovers counted, the survivor
              leak-free); a second such fleet drains replica 0 with
              timeout 0 (fleet.migrations == the streams migrated); paged
              decode and the stream and tiled K1-K3 must launch in this
              part.  (ii) SIGKILL drill (fleet.drills.sigkill_drill): two
              ReplicaManager workers on the card (both pids among
              nvidia-smi's compute apps, or, where nvidia-smi cannot see
              this pid namespace, each worker holding the card's device
              file and the compute apps' memory grown by at least both
              workers' weights), replica 0 SIGKILLed once it
              holds an unfinished stream with 2 or more tokens: kill.fired
              == 1, failovers >= 1, the survivor leak-free, /statusz
              states dead == 1.  (iii) rolling upgrade: no stream dropped
              or cut short, 2 restarts, both replicas healthy.  (iv) router
              crash: a child process's journaling router SIGKILLed
              mid-stream over ragged lengths (36..64), a fresh
              Router(recover=run_dir) finishes every stream with the
              workers it found (zero restarts), 0 live journal files and
              0 leaked blocks.  Each worker's handshake seconds, each
              drill's wall seconds and the accepted tokens at the kill are
              printed; one JSON line per part;
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
              (hidden dropout in the kernel), then K3, all three on the
              tensor cores (ln_linear_mma, linear_residual_mma, ffn_mma:
              O1 casts their GEMM operands to bf16; K3's dropout after
              + b2 in the kernel), backward by recompute of the plain
              compositions plus the flash backward kernels.  13 steps as
              in (c2); the counters of the six kernels are zeroed just
              before and must read 12 x 13 after, the SIMT ln_linear,
              linear_residual and ffn and the float32 routes
              (ln_linear_stream, ln_linear_tiled and the stream K2 / K3)
              0; the loss must be finite and fall.
              The unfused step's p50 of (c2) is printed beside it.
              Beforehand, K1 (ln_linear_mma, h=768, 2304 columns), K2
              (linear_residual_mma) and K3 (ffn_mma) with dropout against
              their plain versions at N=8 (K3's multi-group exit through
              the finalize kernel), 4096 and 16384 (the training shape),
              each timed, K2 and K3 at N=16384 also at p=0: values within
              one bf16 unit of their range, K1 with b left out rejected by
              that check; with a residual of 2^-40 of the addend, the
              addend alone (the projection, the FFN; K2 and K3 at p=0.1
              and p=0) within one bf16 unit of its own range, a K2 with b
              and a K3 with b1 left out rejected by that check, and the
              dropped elements (those equal to the residual) exactly the
              hash mask's; ffn_mma's dropout1 mask exact at N=4096 (W2 the
              identity); the float32 routes' K2 dropout and K3 dropout1
              (linear_residual_tiled, ffn_tiled) at N=4096; and a float32
              gpt_tiny fused training step on the card against the CPU
              (loss, every gradient, the loss after one AdamW step; its
              K1-K3 take the tiled kernels);
  (c3) generate GPTForCausalLM.generate at full width (convert.
              generate_workload: B=8, prompt 512, 128 greedy tokens, bf16),
              unfused (use_pallas_attention) and fused (use_fused_block):
              prefill ms, decode-step p50 ms (CUDA events), generated
              tokens/s, each the median of 3 timed calls after a capturing
              one.  The counters are zeroed just before the timed calls;
              flash_decode must read 12 x their decode steps, and in the
              fused run ffn_stream, linear_residual_stream and
              ln_linear_stream 12 x the decode steps, ffn_tiled,
              linear_residual_tiled and ln_linear_tiled 12 x the prefills
              (float32 weights; the SIMT ln_linear, linear_residual and
              ffn, ln_linear_mma, linear_residual_mma and ffn_mma 0).
              Beforehand, a float32 run on a
              small input is held against the same model on the CPU
              (tokens identical, generate_step logits within 1e-3), and the
              flash decode kernel against its plain version at B=8, H=12,
              d=64, L=640 (phase b: every length, the split edges among
              them, eagerly and under one captured graph's replays), and
              the tiled K1-K3 at the prefill's 4096 rows;
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
SERVING_KERNELS = ("paged_decode", "linear_residual_stream", "ffn_stream",
                   "ln_linear_stream", "ln_linear_tiled",
                   "linear_residual_tiled", "ffn_tiled")
# the redesigned kernels of float32 weights, launched by serving and
# generate and by no training path: the weight-streaming K1-K3 at a few
# rows (the decode steps, and serving's prefill buckets up to each route's
# bound, fused_block._LN_STREAM_MAX_ROWS, _RESID_STREAM_MAX_ROWS and
# _FFN_STREAM_MAX_ROWS) and the register-blocked K1-K3 above them
F32_KERNELS = ("linear_residual_stream", "ffn_stream", "ln_linear_stream",
               "ln_linear_tiled", "linear_residual_tiled", "ffn_tiled")
TRAINING_KERNELS = ("flash_fwd", "flash_dkdv", "flash_dq")
# the SIMT K1-K3: since the stream and tiled routes, launched by no path
FUSED_KERNELS = ("ln_linear", "linear_residual", "ffn")
# the tensor-core K1-K3 of bf16 weights: launched by no other path
FUSED_ONLY_KERNELS = ("ln_linear_mma", "linear_residual_mma", "ffn_mma")
FUSED_TRAINING_KERNELS = (*FUSED_ONLY_KERNELS, *TRAINING_KERNELS)
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
    design.update(check_stream_design(torch, _kernels, dev))
    design.update(check_ln_linear_design(_kernels, dev))
    design.update(check_tiled_design(_kernels, dev))

    # -- (b) each kernel against its plain version ---------------------------
    results = check_kernels(torch, np, dev)

    check_stream(torch, np, dev, results)
    check_ln_linear(torch, np, dev, results)
    check_tiled(torch, np, dev, results)
    check_dropout(torch, np, dev, results)
    results.update(check_flash(torch, np, dev))
    results.update(check_flash_decode(torch, np, dev, _kernels))
    for name, d in design.items():
        results[name]["design"] = d

    # -- (c) serving ---------------------------------------------------------
    serving = serve(torch, np, dev, _kernels)

    # -- (c1b) the serving lifecycle -------------------------------------------
    serve_lifecycle(torch, np, dev, _kernels, root, serving["tokens"])
    torch.cuda.empty_cache()

    # -- (c1c) the serving fleet -----------------------------------------------
    serve_fleet(torch, np, dev, _kernels, root)
    torch.cuda.empty_cache()

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
                generating if r["name"] in GENERATE_KERNELS else
                fused_training if r["name"] in FUSED_ONLY_KERNELS else
                serving)
        r["launches"] = path["launches"][r["name"]]
        require(r["launches"] > 0,
                f"{r['name']}: no launch on its main path")
        if r["name"] in FUSED_TRAINING_KERNELS:
            r["launches_fused_training"] = \
                fused_training["launches"][r["name"]]
        if r["name"] in F32_KERNELS:
            r["launches_generate"] = generating["launches"][r["name"]]
            require(r["launches_generate"] > 0,
                    f"{r['name']}: no launch on the generate path")
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
# the tensor-core K1-K3 of bf16 weights: library (its kernel is
# <library>_kernel, its shared memory a block ptt_<library>_smem) ->
# (instantiations per hidden size of ops/fused_block.py _MMA_HIDDEN, what
# the log says of the grid); the training path's h
MMA_FUSED = {
    "ln_linear_mma": (1, "one block per 64-row tile and SM, column tiles "
                         "of 256"),
    "linear_residual_mma": (2, "128 x 128 tiles, two blocks an SM; without "
                               "and with dropout"),
    "ffn_mma": (2, "a cluster of 2 blocks per 64 rows; without and with "
                   "drop1"),
}
MMA_FUSED_H = 768


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
    for lib in MMA_FUSED:
        out[lib] = check_mma_fused_design(_kernels, lib)

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


def check_mma_fused_design(_kernels, lib):
    """Every instantiation of a tensor-core K1-K3 library holds HMMA
    (mma.sync) in its SASS, and the h=768 ones (the training path's) spill
    nothing; their registers and the shared memory a block takes are
    logged."""
    import ctypes
    from paddle_tpu_torch.ops import fused_block as fb
    per_h, grid = MMA_FUSED[lib]
    fn = f"{lib}_kernel"
    hmma = {f: c for f, c in _kernels.sass_count(lib, "HMMA").items()
            if fn in f}
    want = len(fb._MMA_HIDDEN) * per_h
    require(len(hmma) == want and all(hmma.values()),
            f"{lib}: HMMA per instantiation {hmma}: not all {want} run on "
            "the tensor cores")
    tag = f"{fn}ILi{MMA_FUSED_H}E"
    props = {f: p for f, p in _kernels.ptxas_functions(lib).items()
             if tag in f}
    require(len(props) == per_h, f"{lib}: {len(props)} ptxas reports for "
            f"h={MMA_FUSED_H}, not {per_h}")
    for f, p in props.items():
        require(p.get("spill_stores") == 0 and p.get("spill_loads") == 0,
                f"{lib}: {f} spills: {p}")
    smem_fn = _kernels.bind(lib, f"ptt_{lib}_smem", [ctypes.c_int])
    smem = {h: smem_fn(h) for h in fb._MMA_HIDDEN}
    regs = sorted(p.get("registers") for p in props.values())
    h768 = sorted(c for f, c in hmma.items() if tag in f)
    log(f"design {lib}: {len(hmma)} instantiations, HMMA each "
        f"{sorted(hmma.values())}; h={MMA_FUSED_H}: {h768} HMMA, "
        f"registers {regs}, 0 spills; dynamic shared memory a block "
        f"{smem} bytes (h: bytes); {grid}")
    return {"kernel": f"{fn}<{MMA_FUSED_H}>", "hmma": h768[0],
            "hmma_per_instantiation": sorted(hmma.values()),
            "registers": regs, "spill_stores": 0, "spill_loads": 0,
            "smem_bytes": smem, "grid": grid}


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
    rng = np.random.default_rng(SEED)

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).to(dev).to(dtype)

    results = {}
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


# ---------------------------------------------------------------------------
# (b) the weight-streaming K2 / K3 of float32 weights at the decode rows
# ---------------------------------------------------------------------------
# library -> its kernel function (two instantiations: without and with
# dropout) and the TPU kernel it replaces at a few rows
STREAM_KERNELS = {
    "ffn_stream": ("ffn_stream_kernel", "paddle_tpu/ops/fused_block.py:363"),
    "linear_residual_stream": ("linear_residual_stream_kernel",
                               "paddle_tpu/ops/fused_block.py:267"),
}
STREAM_TIMED = 8                    # the decode rows of serving and generate
STREAM_SWEEP = (1, 8, 16, 32, 64)   # rows alternated against the SIMT kernels
STREAM_DROP = (0.2, 0.1)            # K3's dropout1 / dropout2; K2's is the 2nd


def check_stream_design(torch, _kernels, dev):
    """ptxas's registers and spills of both instantiations of each stream
    kernel (none may spill or keep a stack frame), and the grid of each at
    GPT-125M's widths for every N of STREAM_SWEEP: cluster size, blocks,
    bytes in flight a block (its whole weight share), dynamic shared memory
    a block (the library's count, which must equal the wrapper's) and K3's
    scratch."""
    import ctypes
    from paddle_tpu_torch.ops import fused_block as fb
    h, ffn = 768, 3072
    out = {}
    for lib, (fn, _) in STREAM_KERNELS.items():
        props = {f: p for f, p in _kernels.ptxas_functions(lib).items()
                 if fn in f}
        require(len(props) == 2, f"{lib}: {len(props)} ptxas reports for "
                f"{fn}, not 2")
        for f, p in props.items():
            # a stack frame is an array the compiler left in local memory
            require(p.get("spill_stores") == 0 and p.get("spill_loads") == 0
                    and p.get("stack_frame") == 0,
                    f"{lib}: {f} spills or keeps a stack frame: {p}")
        out[lib] = {"kernel": f"{fn}<dropout: false, true>",
                    "registers": sorted(p.get("registers")
                                        for p in props.values()),
                    "spill_stores": 0, "spill_loads": 0, "stack_frame": 0,
                    "grids": {}}
    resident = fb._ffn_stream_resident(dev)
    k3_smem = _kernels.bind("ffn_stream", "ptt_ffn_stream_smem",
                            [ctypes.c_int, ctypes.c_int])
    k2_smem = _kernels.bind("linear_residual_stream",
                            "ptt_linear_residual_stream_smem",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    sms = _kernels.sm_count(dev)
    for n in STREAM_SWEEP:
        cluster, groups, per, rows = fb._ffn_stream_grid(resident, n, h, ffn)
        smem = k3_smem(h, per)
        require(smem == fb._ffn_stream_smem(h, per),
                f"ffn_stream: the library's {smem} bytes of shared memory "
                f"a block, the wrapper's {fb._ffn_stream_smem(h, per)}")
        out["ffn_stream"]["grids"][f"N={n}"] = {
            "cluster": cluster, "groups": groups, "ffn_columns_a_block": per,
            "rows_a_launch": rows, "launches": -(-n // rows),
            "blocks": -(-ffn // per),
            "bytes_in_flight_a_block": 2 * h * per * 4,
            "smem_bytes": smem, "scratch_bytes": groups * rows * h * 4,
            "weight_bytes": 2 * h * ffn * 4}
        cl, width, depth = fb._stream_gemm_grid(sms, n, h, h)
        smem = k2_smem(n, width, depth)
        require(smem == fb._stream_gemm_smem(n, width, depth),
                "linear_residual_stream: the library's and the wrapper's "
                "shared memory a block differ")
        out["linear_residual_stream"]["grids"][f"N={n}"] = {
            "cluster": cl, "columns_a_tile": width, "depth_a_block": depth,
            "blocks": cl * -(-h // width),
            "bytes_in_flight_a_block": depth * width * 4, "smem_bytes": smem}
    out["ffn_stream"]["resident_clusters"] = dict(resident)
    for lib, d in out.items():
        log(f"design {lib}: registers {d['registers']}, 0 spills; "
            + "; ".join(f"{k}: {v}" for k, v in d["grids"].items()))
    log(f"design ffn_stream: clusters the card holds at once, one block an "
        f"SM, by cluster size: {dict(resident)}")
    return out


def check_stream(torch, np, dev, results):
    """The weight-streaming K3 (ffn_stream) and K2 (linear_residual_stream)
    of float32 weights at GPT-125M's widths, on serving's dtypes (a bf16
    residual stream; K2's x the float32 attention output), against their
    plain versions at every N up to the larger route bound and at the
    rows of STREAM_SWEEP: float32 tolerance for a float32
    output, one bf16 unit for a bf16 one.  At N=8 also with float32 x / r,
    with dropout (the addend with a residual of 2^-40 within one bf16 unit
    of its range, its dropped elements exactly the hash mask's, and a K3
    without b1 / a K2 without b rejected by that check), two calls
    bit-identical, and the launches counted per call.  Timed: at every N
    of STREAM_SWEEP the stream kernel, the SIMT kernel and the plain
    version alternated."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.ops import fused_block as fb
    rng = np.random.default_rng(SEED + 12)
    bf16 = torch.bfloat16

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).to(dev).to(dtype)

    h, ffn, eps, seed = 768, 3072, 1e-5, 20260512
    g, beta = t((h,), std=0.1, mean=1.0), t((h,), std=0.1)
    w_out, b_out = t((h, h), std=0.02), t((h,), std=0.02)
    w1, b1 = t((h, ffn), std=0.02), t((ffn,), std=0.02)
    w2, b2 = t((ffn, h), std=0.02), t((h,), std=0.02)
    tol = lambda ref: 1e-4 if ref.dtype == torch.float32 else \
        bf16_tol(ref)  # noqa: E731
    limits = {"ffn_stream": fb._FFN_STREAM_MAX_ROWS,
              "linear_residual_stream": fb._RESID_STREAM_MAX_ROWS}

    def k3(x, d=(0.0, 0.0), e=eps, b1_=b1, kernel=fb.ffn_cuda):
        return lambda: kernel(x, w1, b1_, w2, b2, g, beta, seed, "gelu",
                              *d, e)

    def k3_plain(x, d=(0.0, 0.0), e=eps):
        return lambda: fb.ffn_reference(x, w1, b1, w2, b2, g, beta, seed,
                                        "gelu", *d, e)

    def k2(x, r, p=0.0, b=b_out, kernel=fb.linear_residual_cuda):
        return lambda: kernel(x, w_out, b, r, seed, p)

    def k2_plain(x, r, p=0.0):
        return lambda: fb.linear_residual_reference(x, w_out, b_out, r, seed,
                                                    p)

    def k3_work(n, x):
        return (nbytes(x, w1, b1, w2, b2, g, beta) + n * h * x.element_size(),
                4.0 * n * h * ffn)

    def k2_work(n, x, r):
        return (nbytes(x, w_out, b_out, r) + n * h * r.element_size(),
                2.0 * n * h * h)

    def values(name, kernel, plain):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        return compare(torch, name, out, ref, tol(ref))

    # every N up to the larger bound through the stream wrappers, ragged
    # rows and launches included; the route takes each up to its own bound
    worst = {"ffn_stream": None, "linear_residual_stream": None}
    for n in range(1, max(limits.values()) + 1):
        x_res, attn = t((n, h), bf16), t((n, h))
        require((fb.ffn_route(w1, w2, n) == "ffn_stream")
                == (n <= limits["ffn_stream"])
                and (fb.linear_residual_route(attn, w_out)
                     == "linear_residual_stream")
                == (n <= limits["linear_residual_stream"]),
                f"float32 weights at N={n}: the routes do not take the "
                "stream kernels up to their bounds")
        for name, r in (("ffn_stream", values(
                            f"ffn_stream N={n}",
                            k3(x_res, kernel=fb.ffn_stream_cuda),
                            k3_plain(x_res))),
                        ("linear_residual_stream", values(
                            f"linear_residual_stream N={n}",
                            k2(attn, x_res,
                               kernel=fb.linear_residual_stream_cuda),
                            k2_plain(attn, x_res)))):
            if worst[name] is None or r["err_over_tol"] > \
                    worst[name]["err_over_tol"]:
                worst[name] = dict(r, N=n)
    log(f"check ffn_stream / linear_residual_stream: every N in "
        f"1..{max(limits.values())} (bf16 residual) within tolerance; the "
        f"routes take them up to {limits['ffn_stream']} / "
        f"{limits['linear_residual_stream']} rows; worst err/tol "
        f"{worst['ffn_stream']['err_over_tol']:.3f} at N="
        f"{worst['ffn_stream']['N']} / "
        f"{worst['linear_residual_stream']['err_over_tol']:.3f} at N="
        f"{worst['linear_residual_stream']['N']}")

    out = {"ffn_stream": {}, "linear_residual_stream": {}}
    n = STREAM_TIMED
    x_res, attn = t((n, h), bf16), t((n, h))
    x32, r32 = t((n, h)), t((n, h))
    tiny = (x_res.float() * TINY).to(bf16)
    d1, d2 = STREAM_DROP
    # values with float32 x / r, and with dropout
    k3r = {"f32": values("ffn_stream N=8 float32", k3(x32), k3_plain(x32)),
           "dropout": values(f"ffn_stream N=8 dropout {d1}/{d2}",
                             k3(x_res, (d1, d2)), k3_plain(x_res, (d1, d2)))}
    k2r = {"f32": values("linear_residual_stream N=8 float32", k2(attn, r32),
                         k2_plain(attn, r32)),
           "dropout": values(f"linear_residual_stream N=8 p={d2}",
                             k2(attn, x_res, d2), k2_plain(attn, x_res, d2))}
    # the addend with a residual of 2^-40: its dropped elements are the hash
    # mask's; a K3 without b1 and a K2 without b fall outside one bf16 unit
    rows_t, cols_t = (torch.arange(n, device=dev)[:, None],
                      torch.arange(h, device=dev)[None, :])
    for name, got, want, salt, p, bad in (
            ("ffn_stream", k3(tiny, (d1, d2), TINY_EPS)(),
             k3_plain(tiny, (d1, d2), TINY_EPS)(), fb._SALT_FFN2, d2,
             k3(tiny, (d1, d2), TINY_EPS, torch.zeros_like(b1))()),
            ("linear_residual_stream", k2(attn, tiny, d2)(),
             k2_plain(attn, tiny, d2)(), fb._SALT_RESID, d2,
             k2(attn, tiny, d2, torch.zeros_like(b_out))())):
        torch.cuda.synchronize()
        res = compare(torch, f"{name} N={n} (the addend)", got, want,
                      bf16_tol(want))
        keep = fb._keep_mask(seed, salt, rows_t, cols_t, p)
        for who, o in (("kernel", got), ("plain", want)):
            require(torch.equal(o == tiny, ~keep), f"{name}: the {who}'s "
                    "dropped elements are not the hash mask's")
        res["dropped"] = int((~keep).sum())
        fault = float((bad.float() - want.float()).abs().max()) \
            / bf16_tol(want)
        require(fault > 1.0, f"{name}: the addend check passes a kernel "
                f"without its bias (err/tol {fault:.3f})")
        res["bias_fault_err_over_tol"] = fault
        (k3r if name == "ffn_stream" else k2r)["addend"] = res
    # two calls give the same bits, one launch each at 8 rows
    for name, fn in (("ffn_stream", k3(x_res, (d1, d2))),
                     ("linear_residual_stream", k2(attn, x_res, d2))):
        before = _kernels.launches[name]
        a, b = fn(), fn()
        torch.cuda.synchronize()
        require(torch.equal(a, b), f"{name}: two calls differ")
        require(_kernels.launches[name] == before + 2,
                f"{name}: {_kernels.launches[name] - before} launches in "
                "two calls")
    log(f"check ffn_stream N={n}: float32 x err/tol "
        f"{k3r['f32']['err_over_tol']:.3f}; dropout {d1}/{d2} err/tol "
        f"{k3r['dropout']['err_over_tol']:.3f}; the addend err/tol "
        f"{k3r['addend']['err_over_tol']:.3f}, {k3r['addend']['dropped']} "
        "dropped elements equal to the hash mask's, kernel and plain; "
        f"without b1: {k3r['addend']['bias_fault_err_over_tol']:.3f}, "
        "rejected; two calls bit-identical")
    log(f"check linear_residual_stream N={n}: float32 r err/tol "
        f"{k2r['f32']['err_over_tol']:.3f}; p={d2} err/tol "
        f"{k2r['dropout']['err_over_tol']:.3f}; the addend err/tol "
        f"{k2r['addend']['err_over_tol']:.3f}, {k2r['addend']['dropped']} "
        "dropped elements equal to the hash mask's, kernel and plain; "
        f"without b: {k2r['addend']['bias_fault_err_over_tol']:.3f}, "
        "rejected; two calls bit-identical")

    # timings: stream against SIMT (and plain at N=8), alternated
    sweep = {"ffn_stream": {}, "linear_residual_stream": {}}
    for n in STREAM_SWEEP:
        xn, an = t((n, h), bf16), t((n, h))
        fns = {"ffn_stream": (k3(xn, kernel=fb.ffn_stream_cuda),
                              k3(xn, kernel=fb.ffn_simt_cuda),
                              k3_plain(xn)),
               "linear_residual_stream": (
                   k2(an, xn, kernel=fb.linear_residual_stream_cuda),
                   k2(an, xn, kernel=fb.linear_residual_simt_cuda),
                   k2_plain(an, xn))}
        for name, fns_n in fns.items():
            row = dict(zip(("ms", "simt_ms", "plain_ms"),
                           alternate(torch, fns_n)))
            work = (k3_work(n, xn) if name == "ffn_stream"
                    else k2_work(n, an, xn))
            row["bound_ms"], row["bound_by"] = bound(*work)
            row["route_takes_it"] = n <= limits[name]
            sweep[name][f"N={n}"] = row
            log(f"time {name} N={n}: {row['ms']:.4f} ms against the SIMT "
                f"kernel's {row['simt_ms']:.4f} ms and the plain version's "
                f"{row['plain_ms']:.4f} ms (alternated; bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']}); the route "
                f"takes it: {n <= limits[name]}")
    for name, r in (("ffn_stream", k3r), ("linear_residual_stream", k2r)):
        line = STREAM_KERNELS[name][1]
        timed = sweep[name][f"N={STREAM_TIMED}"]
        require(timed["ms"] < min(timed["simt_ms"], timed["plain_ms"]),
                f"{name}: {timed['ms']:.4f} ms at N={STREAM_TIMED}, not "
                f"faster than the SIMT kernel's {timed['simt_ms']:.4f} and "
                f"the plain version's {timed['plain_ms']:.4f}")
        err = max((worst[name], r["f32"], r["dropout"]),
                  key=lambda v: v["err_over_tol"])
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu", "replaces": line,
            "launches": 0, "max_abs_err": err["max_abs_err"],
            "tol": err["tol"], "err_over_tol": err["err_over_tol"],
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": None, "peak": PEAK_F32,
            "simt_ms": timed["simt_ms"],
            "shape": f"N={STREAM_TIMED}, h={h}"
                     + (f", ffn={ffn}" if name == "ffn_stream" else "")
                     + ", float32 weights, bf16 residual",
            "checks": r, "sweep": sweep[name],
            "max_rows": limits[name]}


# ---------------------------------------------------------------------------
# (a), (b) K1's float32 routes: ln_linear_stream at the decode rows,
# ln_linear_tiled above them
# ---------------------------------------------------------------------------
# library -> its kernel function and instantiations (the tiled kernel's:
# float32 and bf16 x)
LN_KERNELS = {"ln_linear_stream": ("ln_linear_stream_kernel", 1),
              "ln_linear_tiled": ("ln_linear_tiled_kernel", 2)}
LN_REPLACES = "paddle_tpu/ops/fused_block.py:178"
LN_SWEEP = (1, 8, 16, 32, 48, 64, 128, 512, 4096)   # rows timed, alternated
# rows at which both float32 routes are timed: the numbers that set the
# route's bound (fused_block._LN_STREAM_MAX_ROWS)
LN_CROSSOVER = (16, 32, 48, 64, 128)
LN_TILED_CHECKED = (128, 512, 4096)           # the tiled kernel's values
# the rows of each kernel's entry in the kernel line: the decode rows,
# serving's largest prefill bucket
LN_TIMED = {"ln_linear_stream": 8, "ln_linear_tiled": 512}


def check_ln_linear_design(_kernels, dev):
    """ptxas's registers, spills and stack frame of K1's two float32 kernels
    (neither may spill or keep a stack frame); ln_linear_stream's grid at
    GPT-125M's QKV projection for N = 8 and 64 (cluster, blocks, bulk
    copies and bytes in flight a block, shared memory: the library's count,
    which must equal the wrapper's), ln_linear_tiled's shared memory a
    block and its depth split at the rows of LN_SWEEP that it takes."""
    import ctypes
    from paddle_tpu_torch.ops import fused_block as fb
    h, cols = 768, 2304
    out = {}
    for lib, (fn, count) in LN_KERNELS.items():
        props = {f: p for f, p in _kernels.ptxas_functions(lib).items()
                 if fn in f}
        require(len(props) == count, f"{lib}: {len(props)} ptxas reports "
                f"for {fn}, not {count}")
        for f, p in props.items():
            require(p.get("spill_stores") == 0 and p.get("spill_loads") == 0
                    and p.get("stack_frame") == 0,
                    f"{lib}: {f} spills or keeps a stack frame: {p}")
        out[lib] = {"kernel": fn,
                    "registers": sorted(p.get("registers")
                                        for p in props.values()),
                    "spill_stores": 0, "spill_loads": 0, "stack_frame": 0}
    sms = _kernels.sm_count(dev)
    smem_fn = _kernels.bind("ln_linear_stream", "ptt_ln_linear_stream_smem",
                            [ctypes.c_int] * 3)
    grids = {}
    for n in sorted({8, fb._LN_STREAM_MAX_ROWS, 64}):
        cluster, width, depth = fb._stream_gemm_grid(sms, n, h, cols)
        smem = smem_fn(n, width, depth)
        require(smem == fb._stream_gemm_smem(n, width, depth),
                f"ln_linear_stream: the library's {smem} bytes of shared "
                "memory a block, not the wrapper's")
        grids[f"N={n}"] = {
            "cluster": cluster, "columns_a_tile": width,
            "depth_a_block": depth, "blocks": cluster * -(-cols // width),
            "bulk_copies_a_block": depth,
            "bytes_in_flight_a_block": depth * width * 4, "smem_bytes": smem}
    out["ln_linear_stream"]["grids"] = grids
    smem = _kernels.bind("ln_linear_tiled", "ptt_ln_linear_tiled_smem",
                         [ctypes.c_int])(h)
    require(smem == fb._tiled_smem(h), f"ln_linear_tiled: the library's "
            f"{smem} bytes of shared memory a block, the wrapper's "
            f"{fb._tiled_smem(h)}")
    out["ln_linear_tiled"].update(
        smem_bytes=smem,
        tile=f"{fb._TILED_ROWS} x {fb._TILED_COLS} a block of 128 threads, "
             f"8 x 8 a thread, {fb._TILED_DEPTH}-deep slabs of W and x in a "
             "3-stage cp.async ring, 3 blocks an SM",
        depth_split={f"N={n}": fb._tiled_splits(sms, n, h, cols)
                     for n in LN_SWEEP if n > fb._LN_STREAM_MAX_ROWS})
    for lib, d in out.items():
        log(f"design {lib}: {d['registers']} registers, 0 spills, no stack "
            "frame; " + "; ".join(f"{k}: {v}" for k, v in d.items()
                                   if k in ("grids", "smem_bytes", "tile",
                                            "depth_split")))
    return out


def check_ln_linear(torch, np, dev, results):
    """K1 on float32 weights at GPT-125M's QKV projection (h=768, 2304
    columns; serving's dtypes: a bf16 residual stream, float32 w, b, g,
    beta) against its plain version within 1e-4 (float32 sums in another
    order than cuBLAS, ~1e-6 apart; a wrong tile, index or epilogue is off
    by 1e-2 or more): ln_linear_stream, through the route, at every N from
    1 to _LN_STREAM_MAX_ROWS, one launch a call, and at N=8 with float32 x;
    ln_linear_tiled through the route at the rows of LN_TILED_CHECKED, at
    300 rows x 200 columns (ragged row and column tiles) and with float32 x;
    b left out rejected by that check (err/tol above 1); two calls
    bit-identical.  Timed at every N of LN_SWEEP: the route's kernel, the
    SIMT ln_linear and the plain version (and at LN_CROSSOVER both float32
    routes) alternated, each checked against the plain version first; the
    route's kernel must beat the SIMT one at N=8 and at N=4096."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.ops import fused_block as fb
    rng = np.random.default_rng(SEED + 13)
    bf16 = torch.bfloat16

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).to(dev).to(dtype)

    h, cols, eps, tol = 768, 2304, 1e-5, 1e-4
    limit = fb._LN_STREAM_MAX_ROWS
    g, beta = t((h,), std=0.1, mean=1.0), t((h,), std=0.1)
    w, b = t((h, cols), std=0.02), t((cols,), std=0.02)

    def k1(kernel, x, w_=w, b_=b):
        return lambda: kernel(x, w_, b_, g, beta, eps)

    def plain(x, w_=w, b_=b):
        return lambda: fb.ln_linear_reference(x, w_, b_, g, beta, eps)

    def values(name, fn, ref):
        out = fn()
        torch.cuda.synchronize()
        return compare(torch, name, out, ref, tol)

    def routed(name, x, w_=w, b_=b):
        """One call through ln_linear_cuda: the route's kernel, launched
        once, within tol of the plain version."""
        require(fb.ln_linear_route(w_, x.shape[0]) == name,
                f"{name}: float32 w at N={x.shape[0]}, {tuple(w_.shape)} "
                "takes another route")
        before = dict(_kernels.launches)
        r = values(f"{name} N={x.shape[0]} {x.dtype} {tuple(w_.shape)}",
                   k1(fb.ln_linear_cuda, x, w_, b_), plain(x, w_, b_)())
        launched = {q: _kernels.launches[q] - before[q]
                    for q in (*LN_KERNELS, "ln_linear", "ln_linear_mma")}
        require(launched == {q: int(q == name) for q in launched},
                f"{name}: launches {launched} in one call")
        return r

    checks = {"ln_linear_stream": {}, "ln_linear_tiled": {}}
    worst = {}

    def keep(name, key, r):
        checks[name][key] = r
        if name not in worst or r["err_over_tol"] > \
                worst[name]["err_over_tol"]:
            worst[name] = dict(r, case=key)

    for n in range(1, limit + 1):
        keep("ln_linear_stream", f"N={n}", routed("ln_linear_stream",
                                                  t((n, h), bf16)))
    keep("ln_linear_stream", "N=8 float32 x",
         routed("ln_linear_stream", t((8, h))))
    for n in LN_TILED_CHECKED:
        keep("ln_linear_tiled", f"N={n}", routed("ln_linear_tiled",
                                                 t((n, h), bf16)))
    keep("ln_linear_tiled", "N=512 float32 x",
         routed("ln_linear_tiled", t((512, h))))
    w200, b200 = w[:, :200].contiguous(), b[:200].contiguous()
    keep("ln_linear_tiled", "N=300, 200 columns",
         routed("ln_linear_tiled", t((300, h), bf16), w200, b200))
    for name, n in (("ln_linear_stream", 8), ("ln_linear_stream", limit),
                    ("ln_linear_tiled", 128), ("ln_linear_tiled", 512)):
        x = t((n, h), bf16)
        kernel = getattr(fb, f"{name}_cuda")
        ref = plain(x)()
        bad = k1(kernel, x, b_=torch.zeros_like(b))()
        fault = float((bad - ref).abs().max()) / tol
        require(fault > 1.0, f"{name} N={n}: the check passes a kernel "
                f"without its bias (err/tol {fault:.3f})")
        a, a2 = k1(kernel, x)(), k1(kernel, x)()
        torch.cuda.synchronize()
        require(torch.equal(a, a2), f"{name} N={n}: two calls differ")
        checks[name][f"N={n} without b"] = {"err_over_tol": fault}
    for name, d in checks.items():
        log(f"check {name}: "
            f"{', '.join(k for k in d if not k.endswith('without b'))} "
            f"within {tol} of the plain version"
            f" (worst err/tol {worst[name]['err_over_tol']:.3f} at "
            f"{worst[name]['case']}); b left out rejected ("
            + ", ".join(f"{k[:-10]}: err/tol {v['err_over_tol']:.1f}"
                        for k, v in d.items() if k.endswith("without b"))
            + "); two calls bit-identical")

    # timings, alternated: the route's kernel (both float32 routes at
    # LN_CROSSOVER), the SIMT kernel it replaced and the plain version,
    # each held against the plain version first
    sweep = {}
    for n in LN_SWEEP:
        x = t((n, h), bf16)
        fns = {}
        if n <= limit or n in LN_CROSSOVER:
            fns["stream_ms"] = k1(fb.ln_linear_stream_cuda, x)
        if n > limit or n in LN_CROSSOVER:
            fns["tiled_ms"] = k1(fb.ln_linear_tiled_cuda, x)
        fns["simt_ms"] = k1(fb.ln_linear_simt_cuda, x)
        ref = plain(x)()
        errs = {key: values(f"{key[:-3]} N={n}", fn, ref)["max_abs_err"]
                for key, fn in fns.items()}
        fns["plain_ms"] = plain(x)
        row = dict(zip(fns, alternate(torch, list(fns.values()))))
        row["route"] = fb.ln_linear_route(w, n)
        row["ms"] = row["stream_ms" if n <= limit else "tiled_ms"]
        row["max_abs_err"] = errs
        row["bound_ms"], row["bound_by"] = bound(
            nbytes(x, w, b, g, beta) + n * cols * 4, 2.0 * n * h * cols)
        if n > limit:
            row["depth_split"] = fb._tiled_splits(_kernels.sm_count(dev), n,
                                                  h, cols)
        sweep[f"N={n}"] = row
        log(f"time ln_linear N={n}: "
            + ", ".join(f"{k[:-3]} {row[k]:.4f} ms" for k in fns)
            + f" (alternated; bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}); the route takes {row['route']}")
    for n in (8, 4096):
        row = sweep[f"N={n}"]
        require(row["ms"] < row["simt_ms"],
                f"{row['route']}: {row['ms']:.4f} ms at N={n}, not faster "
                f"than the SIMT ln_linear's {row['simt_ms']:.4f}")
    for name, n in LN_TIMED.items():
        row = sweep[f"N={n}"]
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu",
            "replaces": LN_REPLACES, "launches": 0,
            "max_abs_err": worst[name]["max_abs_err"],
            "tol": worst[name]["tol"],
            "err_over_tol": worst[name]["err_over_tol"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "peak": PEAK_F32, "simt_ms": row["simt_ms"],
            "shape": f"N={n}, h={h}, cols={cols}, float32 w, bf16 x",
            "checks": checks[name],
            "sweep": {k: v for k, v in sweep.items()
                      if f"{name[len('ln_linear_'):]}_ms" in v},
            "max_rows": limit}


# ---------------------------------------------------------------------------
# (a), (b) K3's and K2's register-blocked routes of float32 weights above
# the stream bounds (ffn_tiled, linear_residual_tiled), and K1's tiled
# kernel's bits, all on the GEMM body of csrc/tiled.cuh
# ---------------------------------------------------------------------------
# library -> (kernel function, instantiations) of ptxas's report: K3's up
# pass by x's dtype x drop1, its down pass by drop2; K2 by x's dtype x drop
TILED_KERNELS = {
    "ffn_tiled": (("ffn_tiled_up_kernel", 4), ("ffn_tiled_down_kernel", 2)),
    "linear_residual_tiled": (("linear_residual_tiled_kernel", 4),),
}
TILED_REPLACES = {"ffn_tiled": "paddle_tpu/ops/fused_block.py:363",
                  "linear_residual_tiled": "paddle_tpu/ops/fused_block.py:267"}
TILED_CHECKED = (33, 65, 128, 300, 512, 4096)   # values, through the route
# rows timed, alternated with the SIMT kernel and the plain version; at
# TILED_CROSSOVER the stream kernel too (the numbers that set the route's
# bounds, fused_block._FFN_STREAM_MAX_ROWS and _RESID_STREAM_MAX_ROWS)
TILED_SWEEP = (16, 32, 48, 64, 96, 128, 512, 4096)
TILED_CROSSOVER = (16, 32, 48, 64, 96, 128)
TILED_TIMED = 512             # serving's largest prefill bucket: the line's
TILED_BEATS_SIMT = (512, 4096)
TILED_DROP = (0.2, 0.1)       # K3's dropout1 / dropout2; K2's is the 2nd
# K1's tiled kernel before its body moved into csrc/tiled.cuh (commit
# 5f23eac), on an H100 (132 SMs): sha256 of its float32 outputs on the
# inputs of ln_tiled_bits, by "N/depth chunks"
LN_TILED_DIGESTS = {
    "128/8":
        "10de3339e824f4fb51a6003142835c864bda4591c7cc4f447c7c789b41833a47",
    "512/2":
        "89d6ef01f1781d8b4c0b38ace245e15944ebb9cbba9ed303c625d75a6e764373",
    "4096/1":
        "8763990511c0277644506966efc74dbfa2698c063bbc814c7610aaeaee80ad1e"}


def ln_tiled_bits(torch, np, dev):
    """sha256 of ln_linear_tiled's outputs at GPT-125M's QKV projection
    (h=768, 2304 columns, bf16 x) for N = 128, 512 and 4096 on seeded
    inputs, by "N/depth chunks" (the split decides the order of the
    sums)."""
    import hashlib
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.ops import fused_block as fb
    rng = np.random.default_rng(SEED + 15)

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).to(dev).to(dtype)

    h, cols = 768, 2304
    g, beta = t((h,), std=0.1, mean=1.0), t((h,), std=0.1)
    w, b = t((h, cols), std=0.02), t((cols,), std=0.02)
    out = {}
    for n in (128, 512, 4096):
        y = fb.ln_linear_tiled_cuda(t((n, h), torch.bfloat16), w, b, g, beta,
                                    1e-5)
        split = fb._tiled_splits(_kernels.sm_count(dev), n, h, cols)
        out[f"{n}/{split}"] = hashlib.sha256(
            y.cpu().numpy().tobytes()).hexdigest()
    return out


def check_tiled_design(_kernels, dev):
    """ptxas's registers, spills and stack frame of every instantiation of
    ffn_tiled and linear_residual_tiled (none may spill or keep a stack
    frame), their shared memory a block (the libraries' counts, which must
    equal the wrappers') and their depth splits at GPT-125M's widths for N
    = 128, 512 and 4096."""
    import ctypes
    from paddle_tpu_torch.ops import fused_block as fb
    h, ffn = 768, 3072
    out = {}
    for lib, fns in TILED_KERNELS.items():
        props = _kernels.ptxas_functions(lib)
        regs = {}
        for fn, count in fns:
            got = {f: p for f, p in props.items() if fn in f}
            require(len(got) == count, f"{lib}: {len(got)} ptxas reports "
                    f"for {fn}, not {count}")
            for f, p in got.items():
                require(p.get("spill_stores") == 0
                        and p.get("spill_loads") == 0
                        and p.get("stack_frame") == 0,
                        f"{lib}: {f} spills or keeps a stack frame: {p}")
            regs[fn] = sorted(p.get("registers") for p in got.values())
        out[lib] = {"registers": regs, "spill_stores": 0, "spill_loads": 0,
                    "stack_frame": 0}
    k3 = _kernels.bind("ffn_tiled", "ptt_ffn_tiled_smem",
                       [ctypes.c_int, ctypes.c_int])
    k2 = _kernels.bind("linear_residual_tiled",
                       "ptt_linear_residual_tiled_smem", [])()
    require(k3(h, 0) == fb._tiled_smem(h) and k3(h, 1) == k2
            == fb._tiled_raw_smem(),
            f"ffn_tiled / linear_residual_tiled: the libraries' shared "
            f"memory a block ({k3(h, 0)}, {k3(h, 1)}, {k2}) is not the "
            f"wrappers' ({fb._tiled_smem(h)}, {fb._tiled_raw_smem()})")
    sms = _kernels.sm_count(dev)
    out["ffn_tiled"].update(
        smem_bytes={"up": k3(h, 0), "down": k3(h, 1)},
        depth_split={f"N={n}": {"up": fb._tiled_splits(sms, n, h, ffn),
                                "down": fb._tiled_splits(sms, n, ffn, h)}
                     for n in (128, 512, 4096)},
        scratch_bytes={f"N={n}": n * ffn * 4 for n in (128, 512, 4096)})
    out["linear_residual_tiled"].update(
        smem_bytes=k2,
        depth_split={f"N={n}": fb._tiled_splits(sms, n, h, h)
                     for n in (128, 512, 4096)})
    for lib, d in out.items():
        log(f"design {lib}: registers {d['registers']}, 0 spills, no stack "
            f"frame; shared memory a block {d['smem_bytes']}; depth split "
            f"{d['depth_split']}"
            + (f"; scratch {d['scratch_bytes']}" if "scratch_bytes" in d
               else ""))
    return out


def check_tiled(torch, np, dev, results):
    """ffn_tiled and linear_residual_tiled of float32 weights at GPT-125M's
    widths, on serving's and generate's dtypes (a bf16 residual stream; K2's
    x the attention output in the cache dtype, bf16, or float32), against
    their plain versions: through the route at every N of TILED_CHECKED
    (one launch a call, none of the other K2 / K3 kernels), with float32 x
    too; float32 tolerance 1e-4 for a float32 output, one bf16 unit for a
    bf16 one.  With dropout (K3 0.2 / 0.1, K2 0.1) at N = 300 and 512:
    values, the addend with a residual of 2^-40 within one bf16 unit of its
    range and its dropped elements exactly the hash mask's, a K3 without b1
    and a K2 without b rejected by that check; drop1's mask exactly (W2 the
    identity); two calls bit-identical.  Timed at every N of TILED_SWEEP:
    the tiled kernel, the SIMT kernel and the plain version (and at
    TILED_CROSSOVER the stream kernel) alternated, each held against the
    plain version first; each tiled kernel must beat its SIMT kernel at
    TILED_BEATS_SIMT.  K1's tiled kernel: its outputs' digests equal
    LN_TILED_DIGESTS."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.ops import fused_block as fb
    rng = np.random.default_rng(SEED + 14)
    bf16 = torch.bfloat16

    def t(shape, dtype=torch.float32, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(a).to(dev).to(dtype)

    bits = ln_tiled_bits(torch, np, dev)
    require(bits == {k: LN_TILED_DIGESTS.get(k) for k in bits},
            f"ln_linear_tiled: outputs {bits} are not the bits of the kernel "
            f"before tiled.cuh {LN_TILED_DIGESTS}")
    log(f"check ln_linear_tiled: outputs at N/depth chunks {sorted(bits)} "
        "bit-identical to the kernel before tiled.cuh (sha256)")

    h, ffn, eps, seed = 768, 3072, 1e-5, 20261017
    g, beta = t((h,), std=0.1, mean=1.0), t((h,), std=0.1)
    w_out, b_out = t((h, h), std=0.02), t((h,), std=0.02)
    w1, b1 = t((h, ffn), std=0.02), t((ffn,), std=0.02)
    w2, b2 = t((ffn, h), std=0.02), t((h,), std=0.02)
    tol = lambda ref: 1e-4 if ref.dtype == torch.float32 else \
        bf16_tol(ref)  # noqa: E731
    k3_names = ("ffn", "ffn_mma", "ffn_stream", "ffn_tiled")
    k2_names = ("linear_residual", "linear_residual_mma",
                "linear_residual_stream", "linear_residual_tiled")

    def k3(x, d=(0.0, 0.0), e=eps, b1_=b1, w2_=w2, b2_=b2,
           kernel=fb.ffn_cuda):
        return lambda: kernel(x, w1, b1_, w2_, b2_, g, beta, seed, "gelu",
                              *d, e)

    def k3_plain(x, d=(0.0, 0.0), e=eps, w2_=w2, b2_=b2):
        return lambda: fb.ffn_reference(x, w1, b1, w2_, b2_, g, beta, seed,
                                        "gelu", *d, e)

    def k2(x, r, p=0.0, b=b_out, kernel=fb.linear_residual_cuda):
        return lambda: kernel(x, w_out, b, r, seed, p)

    def k2_plain(x, r, p=0.0):
        return lambda: fb.linear_residual_reference(x, w_out, b_out, r, seed,
                                                    p)

    def values(name, kernel, plain):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        return compare(torch, name, out, ref, tol(ref))

    checks = {"ffn_tiled": {}, "linear_residual_tiled": {}}

    def routed(name, names, key, kernel, plain):
        """One call through the route: ``name`` launched once and no other
        kernel of ``names``, within tol of the plain version."""
        before = dict(_kernels.launches)
        r = values(f"{name} {key}", kernel, plain)
        launched = {q: _kernels.launches[q] - before[q] for q in names}
        require(launched == {q: int(q == name) for q in names},
                f"{name} {key}: launches {launched} in one call")
        checks[name][key] = r

    for n in TILED_CHECKED:
        x_res, attn = t((n, h), bf16), t((n, h))
        require(fb.ffn_route(w1, w2, n) == "ffn_tiled"
                and fb.linear_residual_route(attn, w_out)
                == "linear_residual_tiled",
                f"float32 weights at N={n} do not take the tiled kernels")
        routed("ffn_tiled", k3_names, f"N={n} bf16 x", k3(x_res),
               k3_plain(x_res))
        routed("ffn_tiled", k3_names, f"N={n} float32 x", k3(attn),
               k3_plain(attn))
        routed("linear_residual_tiled", k2_names, f"N={n} bf16 x, bf16 r",
               k2(attn.to(bf16), x_res), k2_plain(attn.to(bf16), x_res))
        routed("linear_residual_tiled", k2_names,
               f"N={n} float32 x, bf16 r", k2(attn, x_res),
               k2_plain(attn, x_res))
    n = 512
    attn, r32 = t((n, h)), t((n, h))
    routed("linear_residual_tiled", k2_names, f"N={n} float32 x, float32 r",
           k2(attn, r32), k2_plain(attn, r32))

    # dropout: values, the addend with a residual of 2^-40 (its dropped
    # elements are the hash mask's; a K3 without b1 and a K2 without b fall
    # outside one bf16 unit), drop1's mask with W2 the identity, and two
    # calls bit-identical
    d1, d2 = TILED_DROP
    eye, zero = torch.eye(ffn, h, device=dev), torch.zeros(h, device=dev)
    for n in (300, 512):
        x_res, attn = t((n, h), bf16), t((n, h), bf16)
        tiny = (x_res.float() * TINY).to(bf16)
        rows_t, cols_t = (torch.arange(n, device=dev)[:, None],
                          torch.arange(h, device=dev)[None, :])
        routed("ffn_tiled", k3_names, f"N={n} dropout {d1}/{d2}",
               k3(x_res, (d1, d2)), k3_plain(x_res, (d1, d2)))
        routed("linear_residual_tiled", k2_names, f"N={n} p={d2}",
               k2(attn, x_res, d2), k2_plain(attn, x_res, d2))
        for name, got, want, salt, bad in (
                ("ffn_tiled", k3(tiny, (d1, d2), TINY_EPS)(),
                 k3_plain(tiny, (d1, d2), TINY_EPS)(), fb._SALT_FFN2,
                 k3(tiny, (d1, d2), TINY_EPS, torch.zeros_like(b1))()),
                ("linear_residual_tiled", k2(attn, tiny, d2)(),
                 k2_plain(attn, tiny, d2)(), fb._SALT_RESID,
                 k2(attn, tiny, d2, torch.zeros_like(b_out))())):
            torch.cuda.synchronize()
            res = compare(torch, f"{name} N={n} (the addend)", got, want,
                          bf16_tol(want))
            keep = fb._keep_mask(seed, salt, rows_t, cols_t, d2)
            for who, o in (("kernel", got), ("plain", want)):
                require(torch.equal(o == tiny, ~keep), f"{name} N={n}: the "
                        f"{who}'s dropped elements are not the hash mask's")
            res["dropped"] = int((~keep).sum())
            fault = float((bad.float() - want.float()).abs().max()) \
                / bf16_tol(want)
            require(fault > 1.0, f"{name} N={n}: the addend check passes a "
                    f"kernel without its bias (err/tol {fault:.3f})")
            res["bias_fault_err_over_tol"] = fault
            checks[name][f"N={n} the addend"] = res
        got = k3(tiny, (0.3, 0.0), TINY_EPS, w2_=eye, b2_=zero)()
        want = k3_plain(tiny, (0.3, 0.0), TINY_EPS, w2_=eye, b2_=zero)()
        torch.cuda.synchronize()
        res = compare(torch, f"ffn_tiled N={n} dropout1 (W2 the identity)",
                      got, want, bf16_tol(want))
        keep = fb._keep_mask(seed, fb._SALT_FFN1, rows_t, cols_t, 0.3)
        for who, o in (("kernel", got), ("plain", want)):
            require(torch.equal(o == tiny, ~keep), f"ffn_tiled N={n}: the "
                    f"{who}'s dropout1 elements are not the hash mask's")
        res["dropped"] = int((~keep).sum())
        checks["ffn_tiled"][f"N={n} dropout1 mask"] = res
        for name, fn in (("ffn_tiled", k3(x_res, (d1, d2))),
                         ("linear_residual_tiled", k2(attn, x_res, d2))):
            a, b = fn(), fn()
            torch.cuda.synchronize()
            require(torch.equal(a, b), f"{name} N={n}: two calls differ")
        del x_res, attn, tiny
    worst = {name: max(({**r, "case": key} for key, r in d.items()),
                       key=lambda r: r["err_over_tol"])
             for name, d in checks.items()}
    for name, d in checks.items():
        adds = [r for k, r in d.items() if k.endswith("the addend")]
        log(f"check {name}: {len(d)} cases within tolerance of the plain "
            f"version (worst err/tol {worst[name]['err_over_tol']:.3f} at "
            f"{worst[name]['case']}); the addend's dropped elements equal "
            f"the hash mask's ({', '.join(str(r['dropped']) for r in adds)})"
            ", a bias left out rejected (err/tol "
            + ", ".join(f"{r['bias_fault_err_over_tol']:.1f}" for r in adds)
            + "); two calls bit-identical")

    # timings, alternated: the tiled kernel, the SIMT kernel it replaced
    # and the plain version (and at TILED_CROSSOVER the stream kernel),
    # each held against the plain version first
    sweep = {"ffn_tiled": {}, "linear_residual_tiled": {}}
    sms = _kernels.sm_count(dev)
    for n in TILED_SWEEP:
        xn, an = t((n, h), bf16), t((n, h), bf16)
        cases = {
            "ffn_tiled": (
                {"tiled_ms": k3(xn, kernel=fb.ffn_tiled_cuda),
                 "stream_ms": k3(xn, kernel=fb.ffn_stream_cuda),
                 "simt_ms": k3(xn, kernel=fb.ffn_simt_cuda)},
                k3_plain(xn),
                (nbytes(xn, w1, b1, w2, b2, g, beta) + n * h * 2,
                 4.0 * n * h * ffn),
                {"up": fb._tiled_splits(sms, n, h, ffn),
                 "down": fb._tiled_splits(sms, n, ffn, h)},
                fb.ffn_route(w1, w2, n)),
            "linear_residual_tiled": (
                {"tiled_ms": k2(an, xn, kernel=fb.linear_residual_tiled_cuda),
                 "stream_ms": k2(an, xn,
                                 kernel=fb.linear_residual_stream_cuda),
                 "simt_ms": k2(an, xn, kernel=fb.linear_residual_simt_cuda)},
                k2_plain(an, xn),
                (nbytes(an, w_out, b_out, xn) + n * h * 2, 2.0 * n * h * h),
                fb._tiled_splits(sms, n, h, h),
                fb.linear_residual_route(an, w_out))}
        for name, (fns, plain, work, split, route) in cases.items():
            if n not in TILED_CROSSOVER:
                del fns["stream_ms"]
            ref = plain()
            errs = {key: values(f"{name[:-6]} {key[:-3]} N={n}", fn,
                                lambda: ref)["max_abs_err"]
                    for key, fn in fns.items()}
            fns["plain_ms"] = plain
            row = dict(zip(fns, alternate(torch, list(fns.values()))))
            row["ms"] = row["tiled_ms"]
            row["route"] = route
            row["max_abs_err"] = errs
            row["bound_ms"], row["bound_by"] = bound(*work)
            row["depth_split"] = split
            sweep[name][f"N={n}"] = row
            log(f"time {name[:-6]} N={n}: "
                + ", ".join(f"{k[:-3]} {row[k]:.4f} ms" for k in fns)
                + f" (alternated; bound {row['bound_ms']:.4f} ms by "
                f"{row['bound_by']}; depth split {split}); the route takes "
                f"{route}")
    for name in sweep:
        for n in TILED_BEATS_SIMT:
            row = sweep[name][f"N={n}"]
            require(row["tiled_ms"] < row["simt_ms"],
                    f"{name}: {row['tiled_ms']:.4f} ms at N={n}, not faster "
                    f"than the SIMT kernel's {row['simt_ms']:.4f}")
        row = sweep[name][f"N={TILED_TIMED}"]
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu",
            "replaces": TILED_REPLACES[name], "launches": 0,
            "max_abs_err": worst[name]["max_abs_err"],
            "tol": worst[name]["tol"],
            "err_over_tol": worst[name]["err_over_tol"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "peak": PEAK_F32, "simt_ms": row["simt_ms"],
            "shape": f"N={TILED_TIMED}, h={h}"
                     + (f", ffn={ffn}" if name == "ffn_tiled" else "")
                     + ", float32 weights, bf16 residual"
                     + (", bf16 x" if name != "ffn_tiled" else ""),
            "checks": checks[name], "sweep": sweep[name]}
    results["ln_linear_tiled"]["bits"] = bits


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
# the K1-K3 wrappers of float32 weights whose calls' rows the serving run
# records: each tiled kernel must take only N above its route's bound
# (fused_block._FFN_STREAM_MAX_ROWS, _RESID_STREAM_MAX_ROWS,
# _LN_STREAM_MAX_ROWS), the weight-streaming kernel the rest
ROW_RECORDED = ("ffn_tiled_cuda", "linear_residual_tiled_cuda",
                "ffn_stream_cuda", "linear_residual_stream_cuda",
                "ln_linear_tiled_cuda", "ln_linear_stream_cuda")


def record_rows(module, names):
    """Wrap ``module``'s functions ``names`` so that each call's rows (its
    first argument's first dimension) are recorded: ``(rows, restore)``,
    rows a dict of lists by name, restore() putting the functions back.
    The wrappers launch what they launched; the launch counters are
    untouched."""
    rows = {name: [] for name in names}
    originals = {name: getattr(module, name) for name in names}

    def recorder(name, fn):
        def call(x, *args, **kwargs):
            rows[name].append(int(x.shape[0]))
            return fn(x, *args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(module, name, recorder(name, fn))
    return rows, lambda: [setattr(module, n, f) for n, f in originals.items()]


def serve(torch, np, dev, _kernels):
    from paddle_tpu_torch.convert import (SERVING_ENGINE, SERVING_NEW_TOKENS,
                                          serving_workload)
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import fused_block as fb

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
    rows, restore = record_rows(fb, ROW_RECORDED)
    try:
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=SERVING_NEW_TOKENS)
                for p in prompts]
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launches)
    finally:
        restore()
    results = [eng.collect(r) for r in rids]
    for res in results:
        require(len(res["tokens"]) == SERVING_NEW_TOKENS,
                f"{res['request_id']}: {len(res['tokens'])} tokens")
        require(all(0 <= tok < cfg.vocab_size for tok in res["tokens"]),
                f"{res['request_id']}: token outside the vocabulary")
    for name in SERVING_KERNELS:
        require(launches[name] > 0,
                f"{name}: launched 0 times on the serving path")
    for name in (*FUSED_ONLY_KERNELS, *FUSED_KERNELS):
        require(launches[name] == 0, f"{name}: {launches[name]} launches on "
                "the serving path (float32 weights take the stream and tiled "
                "routes)")
    st = eng.stats()
    require(st["kv_blocks"]["used"] == 0 and st["kv_blocks"]["leaked"] == 0,
            f"KV blocks not returned: {st['kv_blocks']}")
    # the decode steps ((max_seqs, 1): 8 rows) take the stream kernels, once
    # per layer each; the tiled K1-K3 take only prefill buckets above their
    # bounds, once per layer each: K1-K3 see every step's rows once a layer,
    # so each tiled kernel launches 12 x the steps above its bound
    decodes = st["step_ms"]["decode"]["count"]
    steps_rows = sorted(rows["ln_linear_tiled_cuda"]
                        + rows["ln_linear_stream_cuda"])
    for tiled, stream, limit in (
            ("ffn_tiled_cuda", "ffn_stream_cuda", fb._FFN_STREAM_MAX_ROWS),
            ("linear_residual_tiled_cuda", "linear_residual_stream_cuda",
             fb._RESID_STREAM_MAX_ROWS),
            ("ln_linear_tiled_cuda", "ln_linear_stream_cuda",
             fb._LN_STREAM_MAX_ROWS)):
        require(rows[tiled] and min(rows[tiled]) > limit,
                f"serving: {tiled} took rows {sorted(set(rows[tiled]))}, not "
                f"only N > {limit}")
        require(rows[stream] and max(rows[stream]) <= limit
                and rows[stream].count(
                    SERVING_ENGINE["max_seqs"]) == cfg.num_layers * decodes,
                f"serving: {stream} took rows {sorted(set(rows[stream]))}; "
                f"{cfg.num_layers} x {decodes} decode steps expected")
        require(sorted(rows[tiled] + rows[stream]) == steps_rows,
                f"serving: {tiled} and {stream} did not take every step's "
                "rows once a layer")
        above = sum(1 for r in steps_rows if r > limit)
        name = tiled[:-len("_cuda")]
        require(launches[name] == len(rows[tiled]) == above
                and above % cfg.num_layers == 0,
                f"serving: {name} launched {launches[name]} times, for "
                f"{above} layer calls above {limit} rows")
    row_counts = {name: {str(n): r.count(n) for n in sorted(set(r))}
                  for name, r in rows.items()}
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
        "launches": launches, "k1_k3_calls_by_rows": row_counts}}
    log(json.dumps(line))
    return {"launches": launches, "tokens": [r["tokens"] for r in results]}


# ---------------------------------------------------------------------------
# (c1b) the serving lifecycle
# ---------------------------------------------------------------------------
LIFE_RAISE, LIFE_NAN, LIFE_CANCEL, LIFE_DEADLINE = 2, 5, 6, 7
LIFE_CANCEL_AFTER = 4     # request 6's tokens when it is cancelled
LIFE_DEADLINE_AT = 8      # request 7's tokens when the clock passes its deadline
LIFE_HANG = 3             # the float32 request whose decode step hangs
LIFE_DECODES_BEFORE_DRAIN = 4   # decode steps after the recovery's prefills
PROBED_KERNELS = ("paged_decode", "ln_linear_stream", "linear_residual_stream",
                  "ffn_stream")
GUARD_PAIRS = 5           # alternations of guard on / off in (v)
LIFE_NAN_ON_CARD = 1      # the request whose logits (i b) makes NaN
LIFE_NAN_ON_CARD_AT = 3   # its tokens when that decode step runs
ACCOUNT_RUNS = 3          # runs of the workload that (vi) accounts


class NullRegistry:
    """A registry that records nothing: the engine with its metrics off."""

    class _Instrument:
        def inc(self, n=1.0):
            pass

        def set(self, v):
            pass

        def observe(self, v):
            pass

    _inst = _Instrument()

    def counter(self, name):
        return self._inst

    gauge = histogram = counter

    def emit(self, kind, ts=None, **fields):
        pass


def http_get(url):
    """(status, body) of a GET, 4xx / 5xx included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def seq_output(eng, rid):
    if rid in eng.sched.finished:
        return eng.sched.finished[rid].output
    for seq in list(eng.sched.running) + list(eng.sched.waiting):
        if seq.request_id == rid:
            return seq.output
    raise RuntimeError(f"{rid}: unknown to the engine")


def lifecycle_bf16(torch, np, _kernels, model, prompts, clean, work):
    """(i): the faults, cancel, deadline and defrag on the bf16 workload."""
    from paddle_tpu_torch.convert import SERVING_ENGINE, SERVING_NEW_TOKENS
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    from paddle_tpu_torch.testing import faults

    clk = faults.expire_clock()
    raise_inj = faults.poison_request(LIFE_RAISE, "raise", kinds=("decode",))
    nan_inj = faults.poison_request(LIFE_NAN, "nan")

    def fault(engine, kind, request_ids, logits):
        raise_inj(engine, kind, request_ids, logits)
        return nan_inj(engine, kind, request_ids, logits)

    run_dir = os.path.join(work, "bf16")
    eng = ServingEngine(model, **SERVING_ENGINE, nan_guard=True,
                        run_dir=run_dir, clock=clk, step_fault=fault,
                        registry=MetricsRegistry())
    probes = {"calls": 0, "launches": {name: 0 for name in _kernels.launches}}
    real_probe = eng._probe

    def probe(seqs, rng):
        before = dict(_kernels.launches)
        try:
            return real_probe(seqs, rng)
        finally:
            probes["calls"] += 1
            for name, n in _kernels.launches.items():
                probes["launches"][name] += n - before[name]

    eng._probe = probe
    _kernels.reset_launches()
    rids = [eng.submit(p, max_new_tokens=SERVING_NEW_TOKENS,
                       deadline_ms=1000.0 if i == LIFE_DEADLINE else None)
            for i, p in enumerate(prompts)]
    moves, renumbered_decodes, cancelled, expired = 0, 0, False, False
    t0 = time.perf_counter()
    while eng.has_work():
        finished = len(eng.sched.finished)
        decodes = len(eng._step_ms["decode"])
        eng.step()
        if moves:
            renumbered_decodes += len(eng._step_ms["decode"]) - decodes
        if (not cancelled and len(seq_output(eng, rids[LIFE_CANCEL]))
                >= LIFE_CANCEL_AFTER):
            require(eng.cancel(rids[LIFE_CANCEL]),
                    "lifecycle: request 6 could not be cancelled")
            cancelled = True
        if (not expired and len(seq_output(eng, rids[LIFE_DEADLINE]))
                >= LIFE_DEADLINE_AT):
            clk.advance(2.0)              # past its 1 s deadline
            expired = True
        if len(eng.sched.finished) > finished and eng.defrag():
            moves += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    reasons = [eng.sched.finished[r].finish_reason for r in rids]
    want = ["max_new_tokens"] * len(rids)
    want[LIFE_RAISE] = want[LIFE_NAN] = "poisoned"
    want[LIFE_CANCEL], want[LIFE_DEADLINE] = "cancelled", "deadline"
    require(reasons == want, f"lifecycle: reasons {reasons}, want {want}")
    tokens = [list(eng.sched.finished[r].output) for r in rids]
    for i in (0, 1, 3, 4):
        require(tokens[i] == clean[i],
                f"lifecycle: request {i}'s tokens {tokens[i]} differ from "
                f"the uninterrupted run's {clean[i]}")
    require(tokens[LIFE_CANCEL] == clean[LIFE_CANCEL][:LIFE_CANCEL_AFTER],
            f"lifecycle: cancelled request kept {tokens[LIFE_CANCEL]}")
    require(tokens[LIFE_DEADLINE] == clean[LIFE_DEADLINE][:LIFE_DEADLINE_AT],
            f"lifecycle: expired request kept {tokens[LIFE_DEADLINE]}")
    qdir = os.path.join(run_dir, "serve", "replica-0", "quarantine")
    records = sorted(os.listdir(qdir))
    require(len(records) == 2, f"lifecycle: quarantine records {records}")
    kinds = sorted(json.load(open(os.path.join(qdir, f)))["step_kind"]
                   for f in records)
    leak = eng.cache.leak_report()
    require(leak["balanced"] and leak["leaked_blocks"] == 0
            and leak["num_used"] == 0, f"lifecycle: leak report {leak}")
    require(raise_inj.fired > 1 and probes["calls"] > 0,
            f"lifecycle: {probes['calls']} probes, the raise fired "
            f"{raise_inj.fired} times")
    for name in PROBED_KERNELS:
        require(probes["launches"][name] > 0,
                f"lifecycle: {name} launched 0 times in the probes")
    for name in SERVING_KERNELS:
        require(launches[name] > 0,
                f"lifecycle: {name} launched 0 times in the phase")
    require(moves > 0 and renumbered_decodes > 0,
            f"lifecycle: {moves} defrag moves, {renumbered_decodes} decode "
            "steps on renumbered tables")
    return eng, {"reasons": reasons, "quarantine_records": records,
                 "quarantine_step_kinds": kinds, "probes": probes["calls"],
                 "raise_fired": raise_inj.fired,
                 "probe_launches": {k: v for k, v in
                                    probes["launches"].items() if v},
                 "defrag_moves": moves,
                 "decode_steps_on_renumbered_tables": renumbered_decodes,
                 "launches": launches, "wall_s": wall,
                 "resilience": eng.stats()["resilience"]}


def lifecycle_status(eng):
    """(iii): /healthz, /statusz and /metrics over the (i) engine."""
    srv = eng.start_status_server(port=0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, body = http_get(base + "/healthz")
        require(code == 200 and json.loads(body)["ok"],
                f"status: /healthz {code} {body}")
        code, body = http_get(base + "/statusz")
        require(code == 200, f"status: /statusz {code}")
        page = json.loads(body)["serving"]["resilience"]
        require(page == json.loads(json.dumps(eng.stats()["resilience"])),
                f"status: /statusz resilience {page} != stats()")
        code, metrics = http_get(base + "/metrics")
        series = sorted({ln.split("{")[0].split(" ")[0]
                         for ln in metrics.splitlines()
                         if ln.startswith("paddle_tpu_serve_")})
        require(code == 200 and series, "status: /metrics has no serve_ "
                "series")
        eng.begin_drain()
        code, body = http_get(base + "/healthz")
        require(code == 503 and json.loads(body)["state"] == "draining",
                f"status: /healthz after begin_drain {code} {body}")
    finally:
        eng.stop()
    return {"healthz_after_drain": [code, json.loads(body)["state"]],
            "statusz_resilience": page, "metrics_serve_series": len(series)}


def lifecycle_predictor(np, model, prompts, clean):
    """(iv): the paddle.inference facade over the engine."""
    from paddle_tpu_torch.convert import SERVING_NEW_TOKENS
    from paddle_tpu_torch.inference import Config, create_predictor

    pad = model.config.vocab_size - 1
    require(all(p[-1] != pad for p in prompts),
            "predictor: a prompt ends with the pad id")
    cfg = Config()
    cfg.enable_continuous_batching(8, 16)
    cfg.set_decoder_model(model, SERVING_NEW_TOKENS, pad_token_id=pad)
    pred = create_predictor(cfg)
    ids = np.full((len(prompts), max(len(p) for p in prompts)), pad,
                  np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(ids)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    for i, (p, toks) in enumerate(zip(prompts, clean)):
        full = p + toks
        require(out[i, :len(full)].tolist() == full
                and (out[i, len(full):] == pad).all(),
                f"predictor: row {i} is not prompt + the serve phase's tokens")
    return {"output_shape": list(out.shape)}


def lifecycle_guard_cost(model, prompts, clean, work):
    """(v): host ms of a decode step with the NaN guard, a registry with a
    JSONL sink and request tracing on, against the engine with all three
    off, alternated in one process."""
    from paddle_tpu_torch.convert import SERVING_ENGINE, SERVING_NEW_TOKENS
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    from paddle_tpu_torch.observability.sinks import MetricsWriter

    def run(on):
        os.environ["PTPU_TRACE_REQUESTS"] = "1" if on else "0"
        if on:
            reg = MetricsRegistry()
            reg.add_sink(MetricsWriter(os.path.join(work, "metrics"),
                                       worker_id=0))
        else:
            reg = NullRegistry()
        eng = ServingEngine(model, **SERVING_ENGINE, nan_guard=on,
                            registry=reg)
        rids = [eng.submit(p, max_new_tokens=SERVING_NEW_TOKENS)
                for p in prompts]
        ms = []
        while eng.has_work():
            n = len(eng._step_ms["decode"])
            t = time.perf_counter()
            eng.step()
            dt = time.perf_counter() - t
            if len(eng._step_ms["decode"]) > n:
                ms.append(dt * 1e3)
        require([eng.collect(r)["tokens"] for r in rids] == clean,
                f"guard cost: tokens changed with the guard {on}")
        return ms

    prior = os.environ.get("PTPU_TRACE_REQUESTS")
    runs = {True: [], False: []}
    try:
        for _ in range(GUARD_PAIRS):
            for on in (True, False):
                runs[on].append(run(on))
    finally:
        if prior is None:
            os.environ.pop("PTPU_TRACE_REQUESTS", None)
        else:
            os.environ["PTPU_TRACE_REQUESTS"] = prior
    on = [statistics.median(r) for r in runs[True]]
    off = [statistics.median(r) for r in runs[False]]
    return {"decode_step_host_ms_p50_on": on,
            "decode_step_host_ms_p50_off": off,
            "on_minus_off_ms": statistics.median(on) - statistics.median(off),
            "decode_steps_a_run": len(runs[True][0])}


def lifecycle_nan_on_card(torch, model, prompts, clean, work):
    """(i b): the NaN guard on the card.  No fault seam and no logits
    capture, so the guard reduces isfinite(logits).all(-1) on the device
    and reads the row flags back with the tokens.  A serving_step hook
    makes request 1's logits NaN on one decode step: it must end
    "poisoned" with no bisection probe, the others must give (c)'s tokens,
    and no tensor of vocab width may be copied to the host."""
    from paddle_tpu_torch.convert import SERVING_ENGINE, SERVING_NEW_TOKENS
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability.registry import MetricsRegistry

    vocab = model.config.vocab_size
    run_dir = os.path.join(work, "nan_on_card")
    eng = ServingEngine(model, **SERVING_ENGINE, nan_guard=True,
                        run_dir=run_dir, registry=MetricsRegistry())
    batch = {"seqs": None}
    probes = []
    poisoned = []
    copied = []
    real_apply, real_probe = eng._apply_decode, eng._probe

    def apply_decode(seqs):
        batch["seqs"] = seqs
        try:
            return real_apply(seqs)
        finally:
            batch["seqs"] = None

    def probe(seqs, rng):
        probes.append(len(seqs))
        return real_probe(seqs, rng)

    def serving_step(ids, caches, positions, last_index):
        logits, caches = real_step(ids, caches, positions, last_index)
        for i, s in enumerate(batch["seqs"] or ()):
            if (not poisoned and s.request_id == target
                    and len(s.output) == LIFE_NAN_ON_CARD_AT):
                logits = logits.clone()
                logits[i] = float("nan")
                poisoned.append(i)
        return logits, caches

    def spy(self, *a, **kw):
        copied.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    eng._apply_decode, eng._probe = apply_decode, probe
    real_step, real_cpu = model.serving_step, torch.Tensor.cpu
    rids = [eng.submit(p, max_new_tokens=SERVING_NEW_TOKENS) for p in prompts]
    target = rids[LIFE_NAN_ON_CARD]
    model.serving_step, torch.Tensor.cpu = serving_step, spy
    try:
        eng.run()
    finally:
        del model.serving_step
        torch.Tensor.cpu = real_cpu
    reasons = [eng.sched.finished[r].finish_reason for r in rids]
    want = ["max_new_tokens"] * len(rids)
    want[LIFE_NAN_ON_CARD] = "poisoned"
    require(reasons == want, f"nan on card: reasons {reasons}, want {want}")
    require(len(poisoned) == 1 and not probes,
            f"nan on card: poisoned {poisoned}, probes of {probes} rows")
    require(list(eng.quarantined) == [target]
            and "nonfinite" in eng.quarantined[target]["error"]
            and eng.quarantined[target]["step_kind"] == "decode",
            f"nan on card: quarantined {eng.quarantined}")
    tokens = [list(eng.sched.finished[r].output) for r in rids]
    for i, toks in enumerate(tokens):
        want_toks = (clean[i][:LIFE_NAN_ON_CARD_AT]
                     if i == LIFE_NAN_ON_CARD else clean[i])
        require(toks == want_toks, f"nan on card: request {i}'s tokens "
                f"{toks} differ from {want_toks}")
    wide = [shape for shape in copied if vocab in shape]
    require(copied and not wide,
            f"nan on card: logits copied to the host {wide}")
    records = os.listdir(os.path.join(eng.serve_dir(), "quarantine"))
    require(records == [f"{target}.json"],
            f"nan on card: quarantine records {records}")
    leak = eng.cache.leak_report()
    require(leak["balanced"] and leak["num_used"] == 0,
            f"nan on card: leak report {leak}")
    return {"poisoned_row": poisoned[0], "probes": len(probes),
            "host_copies": len(copied),
            "host_copy_shapes": sorted(set(copied)),
            "quarantine_records": records}


class HostAccount:
    """Host time (time.perf_counter_ns) spent in named functions; a call
    inside another accounted call counts to the outer.  The parts it wraps
    are host Python that waits on nothing, so their wall time is their
    CPU time unless the thread is preempted; the thread CPU clock can tick
    as coarsely as 10 ms, too coarse for parts of a few microseconds."""

    def __init__(self):
        self.ns = {}
        self._depth = 0

    def wrap(self, name, fn):
        def timed(*a, **kw):
            if self._depth:
                return fn(*a, **kw)
            self._depth += 1
            t = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.ns[name] = (self.ns.get(name, 0)
                                 + time.perf_counter_ns() - t)
                self._depth -= 1
        return timed

    def wrap_cm(self, name, factory):
        """The same for a context manager: its enter and exit count."""
        import contextlib

        @contextlib.contextmanager
        def timed(*a, **kw):
            cm = self.wrap(name, factory)(*a, **kw)
            self.wrap(name, cm.__enter__)()
            try:
                yield
            except BaseException as e:
                if not self.wrap(name, cm.__exit__)(type(e), e,
                                                    e.__traceback__):
                    raise
            else:
                self.wrap(name, cm.__exit__)(None, None, None)
        return timed


def lifecycle_host_account(model, prompts, clean):
    """(vi): where a step's host time goes in the engine as a user gets it
    (the process registry, tracing as the environment says, no guard):
    the parts this slice added (reaper, gauges, spans, the step guard,
    counters / histograms / events) against the whole step, for prefill
    and decode steps, over ACCOUNT_RUNS runs."""
    from paddle_tpu_torch.convert import SERVING_ENGINE, SERVING_NEW_TOKENS
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability import registry as registry_mod
    from paddle_tpu_torch.observability import requesttrace

    acc = HostAccount()
    patched = [(requesttrace, name) for name in
               ("emit_span", "emit_decode_span", "emit_stall_span")]
    patched += [(registry_mod.Counter, "inc"), (registry_mod.Gauge, "set"),
                (registry_mod.Histogram, "observe"),
                (registry_mod.MetricsRegistry, "emit")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patched]
    for obj, name, fn in saved:
        setattr(obj, name, acc.wrap("spans" if obj is requesttrace
                                    else "registry", fn))
    steps = {"prefill": [], "decode": []}
    parts = {"prefill": {}, "decode": {}}
    try:
        for _ in range(ACCOUNT_RUNS):
            eng = ServingEngine(model, **SERVING_ENGINE)
            eng._reap = acc.wrap("reap", eng._reap)
            eng._update_gauges = acc.wrap("gauges", eng._update_gauges)
            eng._step_guard = acc.wrap_cm("guard", eng._step_guard)
            rids = [eng.submit(p, max_new_tokens=SERVING_NEW_TOKENS)
                    for p in prompts]
            while eng.has_work():
                n = {k: len(v) for k, v in eng._step_ms.items()}
                before = dict(acc.ns)
                t = time.perf_counter_ns()
                eng.step()
                dt = time.perf_counter_ns() - t
                kind = next((k for k in steps
                             if len(eng._step_ms[k]) > n[k]), None)
                if kind is None:
                    continue
                steps[kind].append(dt)
                for k, v in acc.ns.items():
                    parts[kind][k] = (parts[kind].get(k, 0)
                                      + v - before.get(k, 0))
            require([eng.collect(r)["tokens"] for r in rids] == clean,
                    "host account: tokens changed")
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    line = {"runs": ACCOUNT_RUNS, "tracing": requesttrace.tracing_enabled()}
    for kind, ns in steps.items():
        per_step_us = {k: v / len(ns) / 1e3
                       for k, v in sorted(parts[kind].items())}
        line[kind] = {"steps": len(ns), "parts_us": per_step_us,
                      "added_us": sum(per_step_us.values()),
                      "step_us_mean": sum(ns) / len(ns) / 1e3,
                      "step_us_p50": statistics.median(ns) / 1e3}
    return line


def lifecycle_f32(np, prompts, work, dev):
    """(ii): hang recovery, then drain / resume, float32, token-exact."""
    from paddle_tpu_torch.convert import (SERVING_ENGINE, SERVING_NEW_TOKENS,
                                          serving_workload)
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    from paddle_tpu_torch.testing import faults

    model, _ = serving_workload(dev, dtype="float32")
    ref = ServingEngine(model, **SERVING_ENGINE, capture_logits=True,
                        registry=MetricsRegistry())
    rr = [ref.submit(p, max_new_tokens=SERVING_NEW_TOKENS) for p in prompts]
    step_s = []
    while ref.has_work():
        t = time.perf_counter()
        ref.step()                      # ends in the tokens' host copy
        step_s.append(time.perf_counter() - t)
    ref_out = [ref.collect(r) for r in rr]
    clean = [o["tokens"] for o in ref_out]
    decode_ms = ref.stats()["step_ms"]["decode"]["p50"]
    timeout = max(1.0, 20.0 * max(step_s))
    inj = faults.poison_request(LIFE_HANG, "hang", seconds=60.0 + timeout,
                                kinds=("decode",))
    eng = ServingEngine(model, **SERVING_ENGINE, step_timeout=timeout,
                        step_fault=inj, run_dir=os.path.join(work, "f32"),
                        registry=MetricsRegistry())
    rids = [eng.submit(p, max_new_tokens=SERVING_NEW_TOKENS)
            for p in prompts]
    t0 = time.perf_counter()
    while eng.watchdog_restarts == 0:
        require(eng.has_work(), "f32: the hang never fired")
        eng.step()
    recovery_s = time.perf_counter() - t0
    require(not eng.sched.running and eng.cache.allocator.num_used == 0,
            "f32: hang recovery left a running set or blocks")
    decodes = 0
    while decodes < LIFE_DECODES_BEFORE_DRAIN:
        n = len(eng._step_ms["decode"])
        eng.step()
        decodes += len(eng._step_ms["decode"]) - n
    drain_s = 5 * decode_ms / 1e3
    report = eng.drain(timeout=drain_s)
    require(report["spilled"] > 0, f"f32: drain spilled nothing {report}")
    fresh = ServingEngine(model, **SERVING_ENGINE, registry=MetricsRegistry())
    resumed = fresh.resume(report["spill_path"])
    fresh.run()
    tokens = []
    for i, rid in enumerate(rids):
        src = fresh if rid in resumed else eng
        rec = src.sched.finished[rid]
        require(rec.finish_reason == "max_new_tokens",
                f"f32: {rid} ended {rec.finish_reason}")
        tokens.append(list(rec.output))
        if tokens[i] != clean[i]:
            j = next(k for k, (a, b) in enumerate(zip(tokens[i], clean[i]))
                     if a != b)
            top = np.sort(ref_out[i]["logits"][j])[-2:]
            log(json.dumps({"f32_token_flip": {
                "request": i, "position": j, "got": tokens[i][j],
                "want": clean[i][j],
                "top2_margin": float(top[1] - top[0])}}))
            require(False, f"f32: {rid} differs from the uninterrupted run "
                    f"at token {j}")
    require(eng.watchdog_restarts == 1 and inj.fired == 1,
            f"f32: {eng.watchdog_restarts} watchdog restarts, the hang "
            f"fired {inj.fired} times")
    leak = fresh.cache.leak_report()
    require(leak["balanced"] and leak["num_used"] == 0,
            f"f32: leak report {leak}")
    return {"step_timeout_s": timeout, "slowest_step_ms": max(step_s) * 1e3,
            "recovery_s": recovery_s, "drain_timeout_s": drain_s,
            "drain": {k: report[k] for k in ("finished", "spilled",
                                             "timed_out")},
            "resumed": len(resumed), "watchdog_restarts":
            eng.watchdog_restarts}


def serve_lifecycle(torch, np, dev, _kernels, root, clean):
    import shutil
    from paddle_tpu_torch.convert import serving_workload

    work = os.path.join(root, "build", "serve_lifecycle")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model, prompts = serving_workload(dev)
    line = {}
    eng, line["bf16"] = lifecycle_bf16(torch, np, _kernels, model, prompts,
                                       clean, work)
    line["status"] = lifecycle_status(eng)
    del eng
    line["nan_on_card"] = lifecycle_nan_on_card(torch, model, prompts, clean,
                                                work)
    line["predictor"] = lifecycle_predictor(np, model, prompts, clean)
    line["guard_cost"] = lifecycle_guard_cost(model, prompts, clean, work)
    line["host_account"] = lifecycle_host_account(model, prompts, clean)
    del model
    torch.cuda.empty_cache()
    line["float32"] = lifecycle_f32(np, prompts, work, dev)
    log(json.dumps({"serving_resilience": line}))


# ---------------------------------------------------------------------------
# (c1c) the serving fleet
# ---------------------------------------------------------------------------
FLEET_NEW_TOKENS = 64     # tokens a stream (the router-crash drill's ragged
# lengths end here: 36..64)
FLEET_STOP_AFTER = 3      # stream 0's tokens when its replica is stopped (i)


class RecordSink:
    """A registry sink that keeps every record."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)

    def flush(self):
        pass

    def close(self):
        pass


def fleet_explainer(np, what, prompts, ref_out, sink):
    """The drills' ``explain(stream, tokens)``: print where a stream left
    the reference, the reference's top-2 logit margin there, and the rows
    of each prefill that rebuilt the stream (prompt + accepted tokens but
    the pending one), read from the router's fleet.dispatch records."""
    def explain(i, got):
        want = ref_out[i]["tokens"]
        j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        margin = None
        if j < len(want):
            top = np.sort(ref_out[i]["logits"][j])[-2:]
            margin = float(top[1] - top[0])
        rid = f"fleet-{i}"
        rebuilt = [len(prompts[i]) + r["resumed_at"] - 1
                   for r in sink.records
                   if r.get("kind") == "fleet.dispatch"
                   and r.get("request_id") == rid and r.get("resumed_at")]
        log(json.dumps({"fleet_token_flip": {
            "part": what, "stream": i, "position": j,
            "got": got[j] if j < len(got) else None,
            "want": want[j] if j < len(want) else None,
            "top2_margin": margin, "rebuild_prefill_rows": rebuilt}}))
    return explain


def fleet_in_process(torch, np, _kernels, model, prompts, ref_out, run_dir):
    """(i): failover and drain migration of in-process replicas (sharing
    ``run_dir``: each spills under its own replica-<i> namespace)."""
    from paddle_tpu_torch.convert import SERVING_ENGINE
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.fleet import LocalReplica, Router, drills
    from paddle_tpu_torch.observability.registry import MetricsRegistry

    want = [o["tokens"] for o in ref_out]

    def local_fleet():
        reg = MetricsRegistry()
        sink = reg.add_sink(RecordSink())
        reps = [LocalReplica(ServingEngine(model, **SERVING_ENGINE,
                                           registry=reg, replica_id=i,
                                           run_dir=run_dir),
                             replica_id=i) for i in range(2)]
        return reps, reg, sink, Router(reps, registry=reg)

    def exact(what, router, rids, sink):
        outs = [router.collect(r, timeout=300) for r in rids]
        drills.check_exact(f"fleet (i) {what}", [o["tokens"] for o in outs],
                           want, fleet_explainer(np, what, prompts, ref_out,
                                                 sink))
        require(all(o["finish_reason"] == "max_new_tokens" for o in outs),
                f"fleet (i) {what}: reasons "
                f"{[o['finish_reason'] for o in outs]}")

    _kernels.reset_launches()
    t0 = time.perf_counter()
    reps, reg, sink, router = local_fleet()
    rids = [router.submit(p, max_new_tokens=FLEET_NEW_TOKENS)
            for p in prompts]
    while len(router.journals[rids[0]].tokens) < FLEET_STOP_AFTER:
        router.pump()
    victim = router.journals[rids[0]].replica_id
    moved = sum(1 for r in rids if router.journals[r].replica_id == victim
                and not router.journals[r].finished)
    reps[victim].engine._state = "stopped"       # no drain, no spill
    exact("failover", router, rids, sink)
    counted = reg.snapshot()["fleet.failovers"]["value"]
    require(router.failovers >= 1 and counted == router.failovers,
            f"fleet (i): {router.failovers} failovers, {counted} counted")
    survivor = reps[1 - victim].engine.cache.leak_report()
    require(survivor["leaked_blocks"] == 0 and survivor["num_used"] == 0,
            f"fleet (i): survivor leak report {survivor}")
    failover = {"victim": victim, "streams_on_victim": moved,
                "failovers": router.failovers, "survivor_leak": survivor,
                "wall_s": time.perf_counter() - t0}
    del reps, router

    t0 = time.perf_counter()
    reps, reg, sink, router = local_fleet()
    rids = [router.submit(p, max_new_tokens=FLEET_NEW_TOKENS)
            for p in prompts]
    router.pump()
    migrated = router.drain_replica(0, timeout=0.0)
    require(not any(router.journals[r].replica_id == 0
                    and not router.journals[r].finished for r in rids),
            "fleet (i): streams left on the drained replica")
    exact("migration", router, rids, sink)
    counted = reg.snapshot().get("fleet.migrations", {}).get("value", 0.0)
    require(migrated > 0 and router.migrations == migrated == counted,
            f"fleet (i): {migrated} migrated, router {router.migrations}, "
            f"{counted} counted")
    leaks = [rep.engine.cache.leak_report() for rep in reps]
    require(all(lk["leaked_blocks"] == 0 and lk["num_used"] == 0
                for lk in leaks), f"fleet (i): leak reports {leaks}")
    launches = dict(_kernels.launches)
    for name in SERVING_KERNELS:
        require(launches[name] > 0,
                f"fleet (i): {name} launched 0 times in the part")
    return {"failover": failover,
            "migration": {"migrated": migrated,
                          "wall_s": time.perf_counter() - t0},
            "launches": {n: launches[n] for n in SERVING_KERNELS}}


def compute_apps():
    """``nvidia-smi``'s compute apps: {pid: used MiB}."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, mib = (f.strip() for f in line.split(","))
        apps[int(pid)] = apps.get(int(pid), 0) + int(mib)
    return apps


def card_devices(pid):
    """The card's device files (``/dev/nvidia<N>``) that ``pid`` holds
    open: a process with a CUDA context on the card has one."""
    import re
    fd_dir = f"/proc/{pid}/fd"
    held = set()
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            held.add(target)
    return sorted(held)


def serve_fleet(torch, np, dev, _kernels, root):
    import dataclasses
    import shutil
    from paddle_tpu_torch.convert import (SERVING_ENGINE, SERVING_SEED,
                                          serving_workload)
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.fleet import ReplicaManager, drills
    from paddle_tpu_torch.observability.registry import MetricsRegistry

    work = os.path.join(root, "build", "serve_fleet")
    shutil.rmtree(work, ignore_errors=True)
    model, prompts = serving_workload(dev, dtype="float32")
    spec = {"seed": SERVING_SEED,
            "config": dataclasses.asdict(model.config),
            "engine": dict(SERVING_ENGINE), "device": "cuda"}

    # the reference: one uninterrupted float32 engine, with its logits
    t0 = time.perf_counter()
    ref = ServingEngine(model, **SERVING_ENGINE, capture_logits=True,
                        registry=MetricsRegistry())
    rr = [ref.submit(p, max_new_tokens=FLEET_NEW_TOKENS) for p in prompts]
    ref.run()
    ref_out = [ref.collect(r) for r in rr]
    want = [o["tokens"] for o in ref_out]
    ref_s = time.perf_counter() - t0
    del ref

    line = {"reference_s": ref_s,
            "in_process": fleet_in_process(
                torch, np, _kernels, model, prompts, ref_out,
                os.path.join(work, "in_process"))}
    log(json.dumps({"serving_fleet_in_process": line}))
    weights_mib = sum(t.numel() * t.element_size()
                      for t in model.state_dict().values()) / 2 ** 20
    del model
    torch.cuda.empty_cache()

    # every worker's handshake: spawn to its ready line
    handshakes = []
    spawn = ReplicaManager._spawn

    def timed_spawn(self, idx):
        t = time.perf_counter()
        replica = spawn(self, idx)
        handshakes.append({"replica": idx, "pid": replica.process.pid,
                           "handshake_s": time.perf_counter() - t})
        log(json.dumps({"fleet_worker_handshake": handshakes[-1]}))
        return replica

    def run(name, fn, **kw):
        run_dir = os.path.join(work, name)
        os.makedirs(run_dir)
        reg = MetricsRegistry()
        sink = reg.add_sink(RecordSink())
        first = len(handshakes)
        ev = fn(run_dir, spec, prompts, FLEET_NEW_TOKENS, reference=want,
                registry=reg,
                explain=fleet_explainer(np, name, prompts, ref_out, sink),
                **kw)
        ev["handshakes"] = handshakes[first:]
        log(json.dumps({f"serving_fleet_{name}": ev}))
        return ev

    def on_card(mgr):
        # each worker must hold a CUDA context on the card.  nvidia-smi
        # names a process by its pid outside this pid namespace, so in a
        # container it may list none of the workers' pids (one H100 host
        # showed every process as pid 1): then each worker
        # must hold the card's device file open, and the compute apps'
        # memory must have grown by at least both workers' weights
        apps = compute_apps()
        pids = [rep.process.pid for rep in mgr.replicas]
        held = {p: card_devices(p) for p in pids}
        grew = sum(apps.values()) - sum(apps_before.values())
        listed = all(p in apps for p in pids)
        log(json.dumps({"fleet_compute_apps": {
            "workers": pids, "nvidia_smi_mib": apps,
            "nvidia_smi_mib_before": apps_before, "grew_mib": grew,
            "weights_mib_a_worker": weights_mib, "listed": listed,
            "device_files": held}}))
        require(listed or (all(held.values())
                           and grew >= 2 * weights_mib),
                f"fleet (ii): workers {pids} not shown on the card: "
                f"nvidia-smi {apps} (before {apps_before}), device files "
                f"{held}")

    ReplicaManager._spawn = timed_spawn
    try:
        apps_before = compute_apps()
        sig = run("sigkill", drills.sigkill_drill, on_start=on_card)
        require(sig["kill_fired"] == 1 and sig["failovers"] >= 1
                and sig["survivor_leaked_blocks"] == 0
                and sig["statusz_states"].get("dead") == 1,
                f"fleet (ii): {sig}")
        up = run("rolling_upgrade", drills.rolling_upgrade)
        require(up["dropped"] == 0 and up["restarts"] == 2
                and up["statusz_states"] == {"healthy": 2},
                f"fleet (iii): {up}")
        crash = run("router_crash", drills.router_crash_drill)
        require(crash["worker_restarts"] == 0 and crash["journal_live"] == 0
                and crash["leaked_blocks"] == 0
                and crash["recovered"]["streams"] == len(prompts),
                f"fleet (iv): {crash}")
    finally:
        ReplicaManager._spawn = spawn
    log(json.dumps({"serving_fleet": {
        "streams": len(prompts), "new_tokens": FLEET_NEW_TOKENS,
        "handshake_s": [h["handshake_s"] for h in handshakes],
        "wall_s": {"sigkill": sig["wall_s"],
                   "rolling_upgrade": up["wall_s"],
                   "router_crash": crash["wall_s"]},
        "accepted_at_kill": [a["accepted"] for a in sig["at_kill"]],
        "token_exact": [sig["token_exact"], up["token_exact"],
                        crash["token_exact"]]}}))


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
DROP_ROWS = (8, 4096, 16384)     # decode rows (K3: several cluster groups,
# summed by the finalize kernel), the generate prefill's rows, the training
# shape (B=8 x S=2048; one group)
DROP_P = 0.1
# a residual this small next to the addend (|y| ~ 0.1-1) never absorbs a
# kept value, and a dropped one leaves it bit for bit; K3's LN is
# scale-free given an epsilon below such rows' variance (~2^-80)
TINY, TINY_EPS = 2.0 ** -40, 1e-30


def alternate(torch, fns):
    """Each of ``fns`` timed twice in turns (a, b, ..., a, b, ...): the mean
    of its two medians, in the order given."""
    times = [time_ms(torch, fn) for fn in (*fns, *fns)]
    k = len(fns)
    return [(times[i] + times[i + k]) / 2 for i in range(k)]


def check_dropout(torch, np, dev, results):
    """(c2b) the tensor-core K1-K3 of the fused training path's dtypes (bf16
    O1: bf16 activations and weights, float32 biases and LN parameters; so
    the bound takes the bf16 peak) against their plain versions at every N
    of DROP_ROWS, timed: K1 (ln_linear_mma) at h=768, 2304 columns; K2
    (linear_residual_mma) and K3 (ffn_mma) with their hash dropout at
    p=0.1.  Per N the outputs hold within one bf16 unit of their range;
    then, with a residual of 2^-40 of the addend, the addend alone (the
    projection, the FFN; K2 and K3 at p=0.1 and p=0) holds within one bf16
    unit of its own range, and the dropped elements (equal to the residual)
    are exactly the complement of the hash mask, for the kernel and the
    plain version.  Planted faults the checks must reject: K1 with b left
    out (the value check), K2 with b and K3 with b1 left out (the addend
    check).  At N=16384 K2 and K3 alternated with p=0.  ffn_mma's dropout1
    mask exactly at N=4096; the float32 routes' K2 dropout and K3
    dropout1 (ffn_tiled, linear_residual_tiled) within float32 sums."""
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
    w_qkv, b_qkv = t((h, 3 * h), bf16, std=0.02), t((3 * h,), std=0.02)
    require(fb.ffn_route(w1, w2, DROP_ROWS[0]) == "ffn_mma",
            "K3 with bf16 O1 weights does not route to ffn_mma")
    require(all(fb.ln_linear_route(w_qkv, n) == "ln_linear_mma"
                for n in DROP_ROWS),
            "K1 with bf16 O1 weights does not route to ln_linear_mma")
    salt = fb._SALT_RESID
    out = {"ln_linear_mma": {}, "linear_residual_mma": {}, "ffn_mma": {}}

    def addend_check(name, n, kernel, plain, base, salt_, p, cols=h):
        """Kernel and plain with the residual ``base`` of 2^-40: their
        outputs are the addend rounded to bf16, held within one bf16 unit
        of its own range (a residual of unit size would set that unit 5-10
        times larger); with p > 0 the elements equal to ``base`` are
        exactly the dropped ones of the hash mask."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        res = compare(torch, f"{name} N={n} p={p} (the addend)", got, want,
                      bf16_tol(want))
        if p > 0.0:
            keep = fb._keep_mask(seed, salt_,
                                 torch.arange(n, device=dev)[:, None],
                                 torch.arange(cols, device=dev)[None, :], p)
            for who, o in (("kernel", got), ("plain", want)):
                dropped = o == base
                require(torch.equal(dropped, ~keep),
                        f"{name} N={n}: the {who}'s dropped elements are not "
                        f"the hash mask's ({int((dropped != ~keep).sum())} "
                        "differ)")
            res["dropped"] = int((~keep).sum())
        return res

    def rejected(name, n, bad, want, what):
        """err/tol of a planted fault against the plain output; it must
        exceed 1."""
        r = float((bad.float() - want.float()).abs().max()) / bf16_tol(want)
        require(r > 1.0, f"{name} N={n}: the check passes {name} with {what} "
                f"left out (err/tol {r:.3f})")
        return r

    def k2(x, r, p=DROP_P, b=b_out):
        return lambda: fb.linear_residual_cuda(x, w_out, b, r, seed, p)

    def k2_plain(x, r, p=DROP_P):
        return lambda: fb.linear_residual_reference(x, w_out, b_out, r, seed,
                                                    p)

    def k3(x, p=DROP_P, e=eps, b1_=b1):
        return lambda: fb.ffn_cuda(x, w1, b1_, w2, b2, g, beta, seed, "gelu",
                                   0.0, p, e)

    def k3_plain(x, p=DROP_P, e=eps):
        return lambda: fb.ffn_reference(x, w1, b1, w2, b2, g, beta, seed,
                                        "gelu", 0.0, p, e)

    for n in DROP_ROWS:
        x_res = t((n, h), bf16)
        attn = t((n, h), bf16)
        tiny = (x_res.float() * TINY).to(bf16)
        timed = n == DROP_ROWS[-1]
        require(fb.linear_residual_route(attn, w_out)
                == "linear_residual_mma", "K2 with bf16 O1 operands does "
                "not route to linear_residual_mma")
        k1r = measure(
            torch, f"ln_linear_mma N={n}",
            lambda: fb.ln_linear_cuda(x_res, w_qkv, b_qkv, g, beta, eps),
            lambda: fb.ln_linear_reference(x_res, w_qkv, b_qkv, g, beta,
                                           eps),
            bf16_tol, (nbytes(x_res, w_qkv, b_qkv, g, beta) + n * 3 * h * 2,
                       2.0 * n * h * 3 * h), BF16_FLOPS)
        k1r["b_fault_err_over_tol"] = rejected(
            "ln_linear_mma", n,
            fb.ln_linear_cuda(x_res, w_qkv, torch.zeros_like(b_qkv), g, beta,
                              eps),
            fb.ln_linear_reference(x_res, w_qkv, b_qkv, g, beta, eps), "b")
        k1r["splits"] = fb._mma_splits(dev, -(-n // fb._MMA_LN_ROWS),
                                       -(-3 * h // fb._MMA_LN_COLS))
        k2r = measure(
            torch, f"linear_residual_mma N={n} p={DROP_P}", k2(attn, x_res),
            k2_plain(attn, x_res), bf16_tol,
            (nbytes(attn, w_out, b_out, x_res) + n * h * 2, 2.0 * n * h * h),
            BF16_FLOPS)
        k2r["addend"] = addend_check(
            "linear_residual_mma", n, k2(attn, tiny), k2_plain(attn, tiny),
            tiny, salt, DROP_P)
        k2r["addend_p0"] = addend_check(
            "linear_residual_mma", n, k2(attn, tiny, 0.0),
            k2_plain(attn, tiny, 0.0), tiny, None, 0.0)
        k2r["b_fault_err_over_tol"] = rejected(
            "linear_residual_mma", n, k2(attn, tiny, b=torch.zeros_like(
                b_out))(), k2_plain(attn, tiny)(), "b")
        k3r = measure(
            torch, f"ffn_mma N={n} dropout2={DROP_P}", k3(x_res),
            k3_plain(x_res), bf16_tol,
            (nbytes(x_res, w1, b1, w2, b2, g, beta) + n * h * 2,
             4.0 * n * h * ffn), BF16_FLOPS)
        k3r["addend"] = addend_check(
            "ffn_mma", n, k3(tiny, e=TINY_EPS), k3_plain(tiny, e=TINY_EPS),
            tiny, fb._SALT_FFN2, DROP_P)
        k3r["addend_p0"] = addend_check(
            "ffn_mma", n, k3(tiny, 0.0, TINY_EPS),
            k3_plain(tiny, 0.0, TINY_EPS), tiny, None, 0.0)
        k3r["b1_fault_err_over_tol"] = rejected(
            "ffn_mma", n, k3(tiny, e=TINY_EPS, b1_=torch.zeros_like(b1))(),
            k3_plain(tiny, e=TINY_EPS)(), "b1")
        k3r["groups"] = fb._ffn_mma_groups(dev, n, h, ffn)
        require((k3r["groups"] > 1) == (n == 8),
                f"ffn_mma N={n}: {k3r['groups']} cluster groups; the checks "
                "need several at N=8 and one at the larger shapes")
        if timed:
            # what the hash costs: p=0 against p, alternated twice after the
            # timing above; each is the mean of its two
            k2r["ms_p0"], k2r["ms_alternated"] = alternate(
                torch, (k2(attn, x_res, 0.0), k2(attn, x_res)))
            k3r["ms_p0"], k3r["ms_alternated"] = alternate(
                torch, (k3(x_res, 0.0), k3(x_res)))
        out["ln_linear_mma"][f"N={n}"] = k1r
        out["linear_residual_mma"][f"N={n}"] = k2r
        out["ffn_mma"][f"N={n}"] = k3r
        for name in out:
            r = out[name][f"N={n}"]
            timing = (f"; {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
            if timed and name != "ln_linear_mma":
                timing += (f"; alternated with p=0: {r['ms_alternated']:.4f}"
                           f" against {r['ms_p0']:.4f} ms")
            if name == "ln_linear_mma":
                checks = (f"; with b left out: err/tol "
                          f"{r['b_fault_err_over_tol']:.3f}, rejected; "
                          f"{r['splits']} blocks per 64-row tile")
            else:
                fault = "b1" if name == "ffn_mma" else "b"
                checks = (
                    f"; the addend alone (residual 2^-40): max_abs_err "
                    f"{r['addend']['max_abs_err']:.3e}, err/tol "
                    f"{r['addend']['err_over_tol']:.3f} (p=0: "
                    f"{r['addend_p0']['err_over_tol']:.3f}; with {fault} "
                    f"left out: {r[fault + '_fault_err_over_tol']:.3f}, "
                    f"rejected); {r['addend']['dropped']} dropped elements "
                    "equal to the hash mask's, kernel and plain")
            log(f"check {name} N={n} (bf16"
                f"{'' if name == 'ln_linear_mma' else f', p={DROP_P}'}): "
                f"max_abs_err {r['max_abs_err']:.3e}, err/tol "
                f"{r['err_over_tol']:.3f}{checks}{timing}")
        del x_res, attn, tiny

    # ffn_mma's dropout1 (after the activation, over the global ffn column;
    # off on the training path): with W2 the (ffn, h) identity and b2 = 0
    # the output is x + the activation of the ffn columns below h, so with
    # a tiny residual the elements equal to it are exactly the dropped ones
    # (gelu is 0 only at 0)
    n = 4096
    tiny = (t((n, h)) * TINY).to(bf16)
    eye, zero = torch.eye(ffn, h, dtype=bf16, device=dev), torch.zeros(
        h, device=dev)
    d1 = addend_check(
        "ffn_mma dropout1", n,
        lambda: fb.ffn_cuda(tiny, w1, b1, eye, zero, g, beta, seed, "gelu",
                            0.2, 0.0, TINY_EPS),
        lambda: fb.ffn_reference(tiny, w1, b1, eye, zero, g, beta, seed,
                                 "gelu", 0.2, 0.0, TINY_EPS),
        tiny, fb._SALT_FFN1, 0.2)
    log(f"check ffn_mma N={n} dropout1=0.2 (bf16, W2 the identity): "
        f"err/tol {d1['err_over_tol']:.3f}; {d1['dropped']} dropped "
        f"activations of the first {h} ffn columns equal to the hash mask's, "
        "kernel and plain")
    del tiny, eye

    # the float32 routes' K2 dropout and K3 dropout1 (float32 operands, as
    # a float32 training step multiplies: ffn_tiled and
    # linear_residual_tiled), where one misplaced element of the mask moves
    # the output far past the tolerance
    n = 4096
    x32 = t((n, h))
    f32w = [a.float() for a in (w1, b1, w2, b2)]
    require(fb.ffn_route(f32w[0], f32w[2], n) == "ffn_tiled"
            and fb.linear_residual_route(x32, w_out.float())
            == "linear_residual_tiled",
            "K2 / K3 with float32 operands do not route to the tiled kernels")
    k2d = measure(
        torch, f"linear_residual_tiled N={n} p={DROP_P} (float32)",
        lambda: fb.linear_residual_cuda(x32, w_out.float(), b_out, x32, seed,
                                        DROP_P),
        lambda: fb.linear_residual_reference(x32, w_out.float(), b_out, x32,
                                             seed, DROP_P),
        lambda ref: 1e-4, (0, 0), timed=False)
    k3d1 = measure(
        torch, "ffn_tiled N=4096 dropout1=0.2 dropout2=0.1 (float32)",
        lambda: fb.ffn_cuda(x32, *f32w, g, beta, seed, "gelu", 0.2, DROP_P,
                            eps),
        lambda: fb.ffn_reference(x32, *f32w, g, beta, seed, "gelu", 0.2,
                                 DROP_P, eps),
        lambda ref: 1e-4, (0, 0), timed=False)
    log(f"check linear_residual_tiled N={n} p={DROP_P} (float32): "
        f"max_abs_err {k2d['max_abs_err']:.3e} <= 1e-4; ffn_tiled N={n} "
        f"dropout1=0.2 dropout2={DROP_P} (float32): max_abs_err "
        f"{k3d1['max_abs_err']:.3e} <= 1e-4")
    results["linear_residual_tiled"]["dropout"] = {
        "p": DROP_P, "seed": seed,
        "shapes": {f"N={n}, float32": k2d}}
    results["ffn_tiled"]["dropout"] = {
        "p": DROP_P, "seed": seed,
        "shapes": {"N=4096, dropout1=0.2, float32": k3d1}}

    train = f"N={DROP_ROWS[-1]}"
    shapes = {
        "ln_linear_mma": f"{train}, h={h}, cols={3 * h}, bf16 O1 (bf16 x, W; "
                         "float32 b, g, beta)",
        "linear_residual_mma": f"{train}, {h} x {h}, bf16 O1 (bf16 x, W, r; "
                               f"float32 b), p={DROP_P}",
        "ffn_mma": f"{train}, h={h}, ffn={ffn}, bf16 O1 (bf16 x, W1, W2; "
                   f"float32 b1, b2, g, beta), dropout2={DROP_P}"}
    for name, per in out.items():
        worst = max(per.values(), key=lambda r: r["err_over_tol"])
        train_r = per[train]
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu",
            "replaces": MMA_REPLACES[name], "launches": 0,
            "max_abs_err": worst["max_abs_err"], "tol": worst["tol"],
            "err_over_tol": worst["err_over_tol"],
            "ms": train_r["ms"], "plain_ms": train_r["plain_ms"],
            "bound_ms": train_r["bound_ms"], "bound_by": train_r["bound_by"],
            "library_ms": None, "peak": PEAK_BF16, "shape": shapes[name],
            **{k: train_r[k] for k in ("ms_p0", "ms_alternated")
               if k in train_r},
            "shapes": per}
        if name != "ln_linear_mma":
            results[name]["zero_sets"] = ("identical to the hash mask, "
                                          "kernel and plain")
    results["ffn_mma"]["dropout1"] = d1


# the TPU kernel each tensor-core K1-K3 replaces where its weights are bf16
MMA_REPLACES = {"ln_linear_mma": "paddle_tpu/ops/fused_block.py:178",
                "linear_residual_mma": "paddle_tpu/ops/fused_block.py:267",
                "ffn_mma": "paddle_tpu/ops/fused_block.py:363"}


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
    for name in (*FUSED_KERNELS, *F32_KERNELS):
        require(line["launches"][name] == 0, f"fused training: {name} "
                f"launched {line['launches'][name]} times; under O1 the bf16 "
                "operands of K1-K3 take the tensor-core kernels")
    line = {"use_fused_block": True, "hidden_dropout": cfg.hidden_dropout,
            "attention_dropout": cfg.attention_dropout, **line,
            "unfused_step_ms_p50": unfused_p50}
    log(json.dumps({"fused_training": line}))
    return {"launches": line["launches"], "step_ms_p50": line["step_ms_p50"]}


# ---------------------------------------------------------------------------
# (c3) generate
# ---------------------------------------------------------------------------
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
        # fused: the decode steps' 8 rows take the stream K1-K3, the
        # prefill's 4096 the tiled K1-K3, once per layer each; the SIMT
        # K1-K3 never
        for name, per_call in (("ffn_stream", decode_steps),
                               ("linear_residual_stream", decode_steps),
                               ("ln_linear_stream", decode_steps),
                               ("ffn_tiled", 1), ("linear_residual_tiled", 1),
                               ("ln_linear_tiled", 1), ("ffn", 0),
                               ("linear_residual", 0), ("ln_linear", 0)):
            want = cfg.num_layers * per_call * GENERATE_CALLS if fused else 0
            require(launches[name] == want, f"{name} ({tag}): "
                    f"{launches[name]} launches, not {want}")
        for name in FUSED_ONLY_KERNELS:
            require(launches[name] == 0, f"{name} ({tag}): {launches[name]} "
                    "launches (float32 weights take the float32 routes)")
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
