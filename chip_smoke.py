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
  (c1d) traced serving  request tracing, the run doctor and the Layer
              machinery on the card, with PTPU_TRACE_REQUESTS=1.  (i) the
              float32 serving workload (c1c's) on two in-process replicas
              of 4 streams each under a journaling Router, the router and
              each replica streaming to its own worker-<i>.jsonl, the
              replica of stream 0 stopped at its 3rd token: every stream
              token for token against one uninterrupted engine of the same
              settings, paged decode and the stream and tiled K1-K3
              launched; then from the run directory alone assemble_run
              gives one complete trace a request, coverage >= 0.95, no
              orphan span and a trace across both replicas,
              tail_latency_attribution and doctor.diagnose both name
              failover_recompute, and the Chrome trace parses back; the
              seconds of assemble_run and diagnose; then a decode step's
              wall ms p50 traced and untraced, alternated, and the span
              emission's own ms a step.  (ii) convert.training_workload's
              step (GPT-125M, bf16 O1, flash attention, B=8, S=2048)
              through model.apply(variables, ids, labels), variables the
              model's own parameters and buffers, gradients by
              torch.autograd.grad: the loss and every gradient equal to
              the module's own forward and backward bit for bit (a
              gradient the module does not reproduce bit for bit in a
              second run of its own is held within that run's distance
              and listed), the three flash kernels launched, the buffers
              unchanged; a forward
              post-hook replaces the logits; set_state_dict of
              convert.random_state's JAX-format weights round-trips.
              (iii) fleet.drills.trace_drill with both workers on the
              card.  One JSON line per part and a traced_serving line;
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
  (c2c) pretraining  GPT-3 1.3B (convert.pretraining_workload: 24 x 2048,
              16 heads, vocab 50304, recompute, flash attention, B=4,
              S=2048, weights drawn on the card):
              (1) the flash forward, dK/dV and dQ kernels at the 1.3B
              attention shape (B=4, H=16, S=2048, d=128, bf16, causal) at
              p=0 and p=0.1 against their plain versions with the (b)
              tolerances, timed, with SDPA forward and backward beside
              them, and the d=128 instantiations' ptxas registers and
              spills logged in (a);
              (2) leg A, the JAX bench's 1.3B full step (bf16 O1, dropout
              0, AdamW(1e-4, 0.01)): 2 warm-up and 5 timed steps, step p50,
              tokens/s, MFU and peak memory; the first loss within 1 of
              ln 50304; the counters zeroed before and read after: 48
              flash forward launches a step (24, and 24 replays), 24 dK/dV,
              24 dQ;
              (3) one forward + backward of leg A's model without
              recompute, under "full" and under "dots_saveable": peak
              memory above rest ordered full < dots_saveable <= none, and
              "full"'s gradients within one bf16 unit of each gradient's
              range of no recompute's;
              (4) leg B, the recipe (dropout 0.1, O2 master weights, a
              GradScaler, ClipGradByGlobalNorm(1.0), AdamW with decay on
              the 2-D weights, warmup then cosine): 4 steps whose lr is the
              schedule's host value, the global norm before clipping
              logged, bf16 parameters and float32 masters; then a step
              with an inf in one gradient (a hook): parameters, masters,
              slots and the step count unchanged bit for bit, the scale
              halved; then recompute's gradients against no recompute's
              under one seed, bit for bit (the random streams' replay);
              (5) resume at full width and 2 layers: 4 steps straight
              against 2 steps, save_sharded (parameters, masters, slots,
              step, schedule, scaler, random streams; an mlh32/1 stamp), a
              fresh model and optimizer, load_sharded, 2 steps: the same
              losses bit for bit; checkpoint bytes, save and load seconds;
              a shard cut by one byte raises CheckpointCorruption; the
              host seconds of convert.random_state for that model logged;
              (6) a float32 gpt_tiny step with use_recompute on the card
              against the CPU (loss, every gradient, the loss after one
              AdamW step);
  (c2d) BERT-base pretraining and the MoE GPT: (1) the flash forward,
              dK/dV and dQ kernels non-causal at BERT-base's attention
              shape (B=16, H=12, S=512, d=64, bf16; every tile visible)
              against their plain versions with the (b) tolerances,
              timed with SDPA non-causal beside them, and ragged
              non-causal cases (sq=136 / sk=200 both ways, bf16 and
              float32) checked; (2) a float32 bert_tiny MLM + NSP step on
              the card against the CPU (loss, every gradient, the loss
              after one AdamW step); (3) BERT-base pretraining
              (convert.bert_pretraining_workload: 12 x 768, vocab 30528,
              15% MLM + NSP, bf16 O1, AdamW, B=16, S=512) for 3 warm-up
              and 10 timed steps: step p50, sequences/s, tokens/s, MFU
              (6N + 12 L h S), peak memory, 12 launches of each flash
              kernel a step; (4) a float32 gpt_tiny MoE step (4 experts
              every 2nd layer, capacity factor 0.75: assignments dropped)
              card vs CPU, then the MoE GPT-125M (convert.
              moe_training_workload: 8 experts every 2nd layer, GShard
              top-2, capacity factor 2.0, bf16 O1, B=8, S=2048) for 3 +
              10 steps: p50, tokens/s, MFU as the JAX moe row defines it
              (6N over every expert, flagged) and over the parameters a
              token runs, peak memory, 12 flash launches of each kernel
              a step, each MoE layer's dropped share and aux at the last
              step, and one MoE layer's forward at the full row, which
              must grow peak memory by less than one float32 (T, E, C)
              tensor (4.29 GB); (5) a float32 gpt_tiny MoE model through
              generate on the card (captured decode graph) gives the
              CPU's greedy tokens;
  (c2e) supervised training through hapi.Model: GPT-125M at
              training_workload's configuration (full width and depth,
              bf16 O1, flash, the fused LM loss, AdamW, B=8, S=2048) on
              seeded token batches from the port's DataLoader (inputs
              (ids, labels)): (1) fit over 8 batches gives train_step's
              losses over the same batches bit for bit, 12 launches of
              each flash kernel a step (the counters zeroed just before
              the fit), both step p50s and the fit's span totals; (4a) a
              supervised fit saving every 4 steps (each save's call and
              commit seconds and bytes) and (2a) one saving nothing
              (the supervised p50); (2) diverge_after(4, "spike",
              count=4) gives skip, skip, LR back-off, rollback onto step
              4 and a completed run with finite losses; (3) a hung
              readback: StepTimeout, the step skipped, the run completed;
              (4) a child process SIGKILLed after step 6 and a second one
              resuming on the same run_dir from its newest committed
              step: the losses of (4a) bit for bit; (5) three supervised
              2-layer Models under IntegrityGuard(every=2, expected=3,
              action="resync") and a bit flipped in worker 1's
              state: the desync names worker 1 and the leaf, worker 1
              heals from the majority's offer, three equal fingerprints
              after; the stash's clone bytes and ms;
  (c2f) vision (convert.resnet_training_workload / lenet_training_
              workload, training.classification_step; no kernel of the
              port: the eight launch 0 times, counters zeroed before and
              read after the phase): (1) float32 card against CPU from the
              same numpy weights (resnet50 at B=4, 64 x 64; LeNet at B=8):
              the loss, the logits, every gradient, the BatchNorm buffers
              after one Momentum step and the eval logits after it, each
              within 1e-4 of its range plus 16 x the CPU's own float32
              distance from a float64 CPU run (small-batch BatchNorm
              amplifies rounding); (2) ResNet-50 at the JAX row's size (B=128,
              224 x 224, bf16 O1, Momentum with weight decay, one
              resident batch): 3 warm-up and 10 timed steps in NCHW, then
              as many in channels_last, each step to the loss readback;
              finite losses, the last NCHW one below the first; step p50,
              img/s, MFU (img/s x 3 x 4.089 GFLOP / the bf16 peak of
              observability/mfu.py) and peak memory of each layout; (3)
              LeNet at the mnist row's size (B=64, float32): step p50 and
              img/s; (4) the image-classification recipe (the synthetic
              MNIST, ToTensor + Normalize, SmallNet, Adam over
              CosineAnnealingDecay, 10 epochs of Model.fit over
              DataLoader(shuffle=True)): evaluate's acc > 0.9.  (1) also
              locates the card's distance for ResNet-50: the same step
              in float64 on the card, and in float32 under cuDNN's
              deterministic algorithms and without cuDNN, each one's
              distance from the float64 CPU run logged;
  (c2g) the encoder-decoder Transformer (models/translation.py
              over nn.Transformer; convert.transformer_training_workload,
              translation_recipe, training.seq2seq_step): (1) float32
              card against CPU at full width, 2 + 2 layers, vocab 30000,
              B=4, S=64: the loss, the logits and every gradient within
              4 x the CPU float32 run's own distance from a float64 CPU
              run; (2) Transformer-base (6 + 6 layers, d_model 512, vocab
              30000, B=32, S=128 a side, bf16 O1, dropout 0.1, Adam under
              NoamDecay, label smoothing 0.1): 3 warm-up and 10 timed
              steps, step p50, source and target tokens/s, MFU and peak
              memory; (3) beam search on the decoder cache (B=8 sources
              of 32, beam 4, at most 48 steps): float32 2 + 2 layers on
              the card gives the CPU's ids, then full width under bf16 O1,
              ms a step; (4) the translation recipe: loss from above
              0.05 to below it, beam search exact on 8 of 8; (5)
              rotary=True in the fused blocks at GPT-125M width: the
              training block (B=8, S=2048, bf16 O1, dropout 0.1, forward
              and backward) and a float32 decode step at L=640 against
              their plain compositions on the card, each kernel of both
              launched (the counters zeroed before each call); (6)
              incubate's FusedTransformerEncoderLayer at BERT-base width
              against a plain TransformerEncoderLayer with its weights.
              (1)-(4) and (6) launch none of the eight kernels;
  (c2h) the rest of the vision zoo and the detection ops (vision/models,
              vision/ops.py, convert.vision_training_workload; none of the
              eight kernels: the counters are zeroed before the phase and
              must read 0 after it): (1) every family's default
              constructor at full width and 1000 classes (alexnet at 224
              x 224, vgg16 with batch_norm, squeezenet1_1 at 96,
              mobilenet_v1, mobilenet_v2, mobilenet_v3_large and _small,
              shufflenet_v2_x1_0, densenet121 at 64, googlenet and
              inception_v3 at 128), one Momentum step at B=4 with Dropout
              at p=0 (GoogLeNet: the sum of its three heads'
              cross-entropies) on the card and on the CPU from the same
              numpy weights: the same step in float64 on the card within
              1e-9 of each tensor's range of the float64 CPU run; in
              float32 the loss, the logits and the BatchNorm buffers
              within c2f's bound, and each gradient's and the eval
              logits' distance reported against it; (2) each family but
              GoogLeNet through vision_training_workload (B=128, 224 x
              224, InceptionV3 299 x 299, bf16 O1, Momentum with weight
              decay), MobileNetV2 also in channels_last: 3 warm-up and 10
              timed steps, step p50, img/s, peak memory and MFU (img/s x
              3 x hapi.flops' forward FLOPs / 989 TFLOP/s; MobileNetV2's
              count about 0.6 GFLOP and within 1% of a count by hand),
              finite losses, MobileNetV2's falling; (3) the detection ops
              in float32 on the card against a float64 CPU anchor, each
              value and gradient within 4 x the CPU float32 run's distance
              from it plus 1e-6 of its range, at published detector
              shapes: roi_align (7 x 7, and 14 x 14 for the mask head) and
              roi_pool over Mask R-CNN R50-FPN's P2 map (2, 256, 200, 336)
              with 512 boxes an image, psroi_pool at R-FCN's 21 x 7 x 7
              channels, nms over 6000 RPN proposals at IoU 0.7 and over
              1000 boxes in 80 categories with top_k 100 (indices equal
              the CPU's), yolo_box and yolo_loss on YOLOv3's three heads
              at 608 x 608 (80 classes, 50 padded boxes), deform_conv2d
              v2 at a DCNv2 ResNet-50 stage-5 conv; each op's ms (CUDA
              events; nms by the host clock); one vision_zoo JSON line;
  (c2i) recurrent layers, CTC and the rest of nn (nn/rnn.py, the rest of
              nn/functional.py, _functional_ext.py, layers.py,
              layers_ext.py and utils.py; none of the eight kernels: the
              counters are zeroed before the phase and must read 0 after
              it): (1) the PTB word-level LSTM language model (Zaremba et
              al. 2014, medium: H=650, dropout 0.5; large: H=1500, 0.65;
              Embedding(10000) -> 2-layer LSTM -> Linear(10000), B=20, 35
              unrolled steps, the state carried and detached, SGD lr 1
              with the global norm clipped at 5 / 10): the medium step at
              p=0 on the card and on the CPU from the same weights, the
              loss, logits, carried (h, c) and every gradient, gated on
              float64 as c2h (1) (the float64 card run within 1e-9 of each
              range; float32 forward within c2f's bound, float32 gradients
              reported); 3 warm-up and 10 timed steps of each size at its
              dropout: step p50, words/s, peak memory, kernels a step and
              the device's idle share (torch.profiler), the loss falling
              over the timed steps, and the 2-layer LSTM's forward and
              backward alone against cuDNN's (torch.nn.LSTM); (2) a
              DeepSpeech2-shaped stack (3 bidirectional GRU layers of
              1024 over 161-bin frames, Linear(2048, 29), log_softmax,
              ctc_loss; B=16, 200-400 frames through sequence_length,
              labels of 40-100): card against CPU at B=4 and 40-80 frames
              (the loss, log-probs and the gradients by every weight, the
              frames and the log-probs) by the same gate; step p50 and
              kernels a step, ctc_loss's forward and backward ms against
              torch.nn.functional.ctc_loss's (equal losses); (3) DCGAN at
              64 x 64 (ngf = ndf = 64, z 100, Adam(2e-4, 0.5), B=128),
              plain and with D's convolutions under spectral_norm: card
              against CPU at B=4 by the same gate, then a D and a G step's
              p50, img/s and peak memory; (4) every case of
              paddle_tpu_torch/testing/nn_cases.py (the CPU parity tests'
              tables) on the card in float32: values and gradients within
              4 x the CPU float32 run's distance from its float64 run plus
              1e-6 of the range, integers exact; the random ops by their
              statistics; one nn_rest JSON line;
  (c2j) the paddle tensor API (paddle_tpu_torch's top level,
              tensor_ops.py, linalg, fft, signal; none of the eight
              kernels: the counters are zeroed before the phase and must
              read 0 after it): (1) all 276 entries of the op registry
              (paddle_tpu_torch/ops/spec.py) in float32 on the card against
              the port's CPU float64 run and the numpy reference at each
              entry's rtol / atol, the gradient of sum(fn) by every
              grad_wrt argument by autograd on the card against the CPU
              float64 one at grad_rtol / grad_atol, and the bf16 sweep on
              the card (within 0.1 of the output's scale of the card's
              float32 result; matrix_rank has no bf16 form and is named as
              skipped); the worst entries by err / limit; (2)
              DeepSpeech2's linear spectrogram front end through
              paddle_tpu_torch.signal and the top-level math:
              log1p(|stft(x)|^2) of B=16 seeded 4 s utterances at 16 kHz
              (Hann window 320, hop 160: 161 bins x 401 frames) and its
              gradient by x, card against CPU by c2g (1)'s rule, the istft
              round trip's error, the forward's and backward's ms; (3)
              linalg at GPT-3 1.3B's width (2048 x 2048 float32: cholesky,
              solve, inv, qr, svd, eigh, lstsq, lu / lu_unpack, det /
              slogdet, matrix_rank), each held by its residual computed in
              float64 from the card's factors within n x float32 eps, the
              singular values, eigenvalues, determinant and rank against
              the float64 CPU run's, each op's ms; (4) 31 top-level ops at
              GPT-125M's activation shape (8, 2048, 768) float32: card
              against CPU by c2g (1)'s rule (integer results exact), each
              op's ms (CUDA events) beside its bytes bound (bytes read and
              written over 3.35 TB/s); one tensor_api JSON line with each
              part's seconds and the phase's;
  (c2k) deploy  export and deployment: (1) GPT-125M at full width
              (float32, use_fused_block, use_pallas_attention, the generate
              workload's seeded weights) through jit.save with a dynamic
              batch (InputSpec([None, 512], "int32")), then
              create_predictor(Config(path)) in a child process (the
              registered ops imported before torch.export.load) at batches
              1, 4 and 8: the exported graph holds ptpu::ln_linear,
              linear_residual, ffn and flash_fwd; each run launches
              ln_linear_tiled, linear_residual_tiled, ffn_tiled and
              flash_fwd 12 times and nothing else; the logits bit for bit
              the eager model's on the card (sha256 of the whole tensor),
              row 0 within 1e-3 of the float64 plain route on the CPU;
              run ms against the eager forward's, the artifact's bytes,
              save and load seconds; (2) PTQ of the unfused GPT-125M's 48
              linears (4 seeded calibration batches of (8, 512),
              Int8Linear on torch._int_mm): each linear shape's int32
              accumulation equal to the CPU's, top-1 agreement with the
              float32 logits, int8 against float32 ms, the int8 artifact
              equal to the eager int8 model; (3) PTQ of ResNet-50 (NCHW,
              float32, B=16, 224^2, 2 calibration batches) with
              Int8Conv2D: the 7x7 stem's and a 3x3 conv's int32
              accumulation equal to the CPU's, top-1 agreement, ms; (4) a
              LeNet-shaped static program (static.nn conv2d / batch_norm
              / fc) on (64, 1, 28, 28) through save_inference_model ->
              load_inference_model -> Executor.run, equal to the
              program's own eval run; (5) the compile tracker: a record
              for every library phase (a) compiled, three generate
              captures at batches 1, 2, 4 with two retraces naming
              ``batch``, /statusz's compile filled; one deploy JSON line;
  (c2l) the long tail on the training workload (GPT-125M, B=8, S=2048,
              bf16 O1) and beside it: (1) ASP, the embeddings excluded,
              every other weight pruned 2:4 (mask_1d), 5 steps under the
              decorated AdamW (the flash kernels 12 launches a step), the
              zero pattern and 2:4 kept, three masks recomputed on the
              host bit for bit; (2) LookAhead (k=5, alpha 0.5) 10 steps,
              its slow weights the blend of snapshots and the fast ones
              equal to them bit for bit at steps 5 and 10; ModelAverage 10
              steps, average() within 1e-5 of the float64 replay of its
              recurrence, apply / restore exact; DistributedFusedLamb 5
              steps, each within 1e-5 of a float64 plain LAMB from the
              same state and gradients; (3) the profiler (make_scheduler)
              over the fused float32 serving engine's prefills and 8
              decode steps and 2 training steps: the exported chrome
              trace names every kernel the counters saw (paged decode,
              the stream and tiled K1-K3, the flash kernels) as often,
              each with device time, the RecordEvent ranges, summary(),
              the decode step's ms with and without the profiler; (4)
              FLAGS_dataloader_use_native with 2 workers feeds Model.fit
              4 steps over the ring (its counter 4), the ring's batches
              the queue's byte for byte, batches/s of both; (5)
              WordPiece over a 30,522-entry vocabulary and 100k words,
              the native core's ids the Python path's, tokens/s of both;
              (6) every distribution's log_prob / entropy / KL on the
              card against float64 on the CPU, sample moments of 10^6
              draws within 4 standard errors; a 4096 x 4096 sparse
              matrix at 1 %, COO and CSR: matmul with (4096, 768),
              masked_matmul, softmax and attention against dense float64
              on the CPU, each op's ms; (7) run_check and a
              cpp_extension host op on the card; one long_tail JSON line
              with the card's name and power limit;
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
import math
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
    # each phase's wall seconds, logged as one line before the kernel list
    phase_s, since = {}, [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        phase_s[phase] = now - since[0]
        since[0] = now

    from paddle_tpu_torch import _kernels
    done("import")

    # exact float32 products for every reference on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if len(sys.argv) == 3 and sys.argv[1] == "--c2e-child":
        return c2e_child(json.loads(sys.argv[2]))   # (c2e 4)'s processes
    if len(sys.argv) == 3 and sys.argv[1] == "--c2k-child":
        return c2k_child(json.loads(sys.argv[2]))   # (c2k 1)'s predictor
    if len(sys.argv) == 3 and sys.argv[1] == "--c2l-child":
        return c2l_child(json.loads(sys.argv[2]))   # (c2l 3)'s window

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
    done("a_build")

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
    done("b_kernels")

    # -- (c) serving ---------------------------------------------------------
    serving = serve(torch, np, dev, _kernels)
    done("c_serving")

    # -- (c1b) the serving lifecycle -------------------------------------------
    serve_lifecycle(torch, np, dev, _kernels, root, serving["tokens"])
    torch.cuda.empty_cache()
    done("c1b_lifecycle")

    # -- (c1c) the serving fleet -----------------------------------------------
    serve_fleet(torch, np, dev, _kernels, root)
    torch.cuda.empty_cache()
    done("c1c_fleet")

    # -- (c1d) traced serving, Layer.apply, the trace drill --------------------
    traced_serving(torch, np, dev, _kernels, root)
    torch.cuda.empty_cache()
    done("c1d_traced")

    # -- (c2) training -------------------------------------------------------
    training = train(torch, np, dev, _kernels)
    torch.cuda.empty_cache()
    done("c2_training")

    # -- (c2b) fused-block training ------------------------------------------
    fused_training = train_fused(torch, np, dev, _kernels,
                                 training["step_ms_p50"])
    torch.cuda.empty_cache()
    done("c2b_fused")

    # -- (c2c) GPT-3 1.3B pretraining ---------------------------------------
    d128 = check_flash_d128(torch, np, dev)
    per_step = pretrain(torch, np, dev, _kernels, root)
    for name, cases in d128.items():
        results[name]["d128"] = {
            **cases, "launches_per_step_pretraining": per_step[name]}
    torch.cuda.empty_cache()
    done("c2c_pretraining")

    # -- (c2d) BERT-base pretraining and the MoE GPT --------------------------
    for name, entry in bert_moe(torch, np, dev, _kernels).items():
        results[name]["noncausal"] = entry
    torch.cuda.empty_cache()
    done("c2d_bert_moe")

    # -- (c2e) supervised training through hapi.Model ------------------------
    hapi = supervised_training(torch, np, dev, _kernels, root)
    for name in TRAINING_KERNELS:
        results[name]["launches_per_step_hapi_fit"] = hapi["per_step"][name]
    torch.cuda.empty_cache()
    done("c2e_hapi")

    # -- (c2f) vision: LeNet, ResNet-50 and the image-classification recipe --
    vision(torch, np, dev, _kernels)
    torch.cuda.empty_cache()
    done("c2f_vision")

    # -- (c2g) the encoder-decoder Transformer --------------------------------
    rotary = translation(torch, np, dev, _kernels)
    for name, n in rotary.items():
        results[name]["launches_rotary"] = n
    torch.cuda.empty_cache()
    done("c2g_translation")

    # -- (c2h) the rest of the vision zoo and the detection ops ----------------
    vision_zoo(torch, np, dev, _kernels)
    torch.cuda.empty_cache()
    done("c2h_vision_zoo")

    # -- (c2i) recurrent layers, CTC and the rest of nn ----------------------
    nn_rest(torch, np, dev, _kernels)
    torch.cuda.empty_cache()
    done("c2i_nn_rest")

    # -- (c2j) the paddle tensor API ------------------------------------------
    tensor_api(torch, np, dev, _kernels)
    torch.cuda.empty_cache()
    done("c2j_tensor_api")

    # -- (c2k) export and deployment ------------------------------------------
    deployed = deploy(torch, np, dev, _kernels, root, built)
    for b, run in deployed["gpt"]["runs"].items():
        for name, n in run["launches"].items():
            results[name].setdefault("launches_per_predictor_run", {})[b] = n
    torch.cuda.empty_cache()
    done("c2k_deploy")

    # -- (c2l) the long tail ----------------------------------------------------
    long_tail(torch, np, dev, _kernels, root)
    torch.cuda.empty_cache()
    done("c2l_long_tail")

    # -- (c3) generate -------------------------------------------------------
    generating = generate(torch, np, dev, _kernels)
    done("c3_generate")
    log(json.dumps({"phase_seconds": phase_s}))

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
    log(card_line())
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
        d128 = [p for f, p in _kernels.ptxas_functions(lib).items()
                if f"{fn}ILi128E" in f]
        require(len(d128) == 1, f"{lib}: no ptxas report for {fn}<128>")
        (h128,) = [c for f, c in hmma.items() if f"{fn}ILi128E" in f]
        out[lib] = {"kernel": f"{fn}<64>", "hmma": h64,
                    "hmma_per_head_dim": sorted(hmma.values()),
                    "registers": props.get("registers"),
                    "spill_stores": props["spill_stores"],
                    "spill_loads": props["spill_loads"],
                    # the 1.3B path's instantiation: logged, not required
                    # to be free of spills
                    "d128": {"kernel": f"{fn}<128>", "hmma": h128,
                             **{k: d128[0].get(k) for k in (
                                 "registers", "spill_stores", "spill_loads",
                                 "stack_frame")}}}
        log(f"design {lib}: {fn}<64> has {h64} HMMA instructions "
            f"({sorted(hmma.values())} over the {MMA_HEAD_DIMS} head dims), "
            f"{props.get('registers')} registers, 0 spill stores; "
            f"{fn}<128>: {out[lib]['d128']}")
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


def flash_cases(torch, np, dev, cases, causal=True):
    """The flash forward, dK/dV and dQ kernels against their plain versions
    at each case of ``cases`` (see ``FLASH_CASES``), causal or not; a timed
    case is timed with SDPA forward and backward beside it as the library
    yardstick.  Returns the measurements by kernel and case, and the SDPA
    ms by case ({"fwd", "bwd"})."""
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
                                               causal, p)
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
    for tag, (b, h, sq, sk, d, p, dtype, timed) in cases.items():
        dtype = getattr(torch, dtype)
        bh = b * h
        q, k, v = t((bh, sq, d), dtype), t((bh, sk, d), dtype), \
            t((bh, sk, d), dtype)
        do = t((bh, sq, d), dtype)
        out, lse = fa.flash_fwd_reference(q, k, v, seed, None, causal, p)
        delta = (do.float() * out.float()).sum(-1)
        pairs = (visible_pairs(sq, sk) if causal else sq * sk) * bh
        io = nbytes(q, k, v, do, lse, delta)
        per["flash_fwd"][tag] = measure(
            torch, f"flash_fwd {tag}",
            lambda: fa.flash_fwd_cuda(q, k, v, seed, None, causal, p),
            lambda: fa.flash_fwd_reference(q, k, v, seed, None, causal, p),
            fwd_tol(q, k, v, p, dtype),
            (nbytes(q, k, v, out, lse), 4.0 * d * pairs), BF16_FLOPS, timed)
        per["flash_dkdv"][tag] = measure(
            torch, f"flash_dkdv {tag}",
            lambda: fa.flash_dkdv_cuda(q, k, v, do, lse, delta, seed, None,
                                       causal, p),
            lambda: fa.flash_dkdv_reference(q, k, v, do, lse, delta, seed,
                                            None, causal, p),
            bwd_tol(dtype), (io + nbytes(k, v), 8.0 * d * pairs), BF16_FLOPS,
            timed)
        per["flash_dq"][tag] = measure(
            torch, f"flash_dq {tag}",
            lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta, seed, None,
                                     causal, p),
            lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, seed,
                                          None, causal, p),
            bwd_tol(dtype), (io + nbytes(q), 6.0 * d * pairs), BF16_FLOPS,
            timed)
        for name in per:
            r = per[name][tag]
            timing = (f"; {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})"
                      if timed else "")
            log(f"check {name} {tag} (B={b}, H={h}, sq={sq}, sk={sk}, d={d}, "
                f"p={p}, {str(dtype).split('.')[-1]}, "
                f"{'causal' if causal else 'non-causal'}): max_abs_err "
                f"{r['max_abs_err']:.3e}, err/tol {r['err_over_tol']:.3f}"
                f"{timing}")
        if timed:
            # the library yardstick, never called by the port: SDPA forward,
            # and its forward + backward less the forward (the backward
            # computes dK, dV and dQ together)
            q4, k4, v4, do4 = (x.view(b, h, -1, d) for x in (q, k, v, do))
            sdpa = TF.scaled_dot_product_attention
            # SDPA's own dropout draws another mask: its time at p > 0 is
            # a yardstick of the work, not of these values
            lib = {"fwd": time_ms(torch, lambda: sdpa(
                q4, k4, v4, is_causal=causal, dropout_p=p))}
            qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))

            def fwd_bwd():
                o = sdpa(qg, kg, vg, is_causal=causal, dropout_p=p)
                torch.autograd.grad(o, (qg, kg, vg), do4)
            lib["bwd"] = time_ms(torch, fwd_bwd) - lib["fwd"]
            library[tag] = lib
            log(f"library ({tag}): SDPA forward {lib['fwd']:.4f} ms, "
                f"backward {lib['bwd']:.4f} ms (dK, dV and dQ together)")
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return per, library


FLASH_REPLACES = {
    "flash_fwd": ("paddle_tpu/ops/flash_attention.py:149", "fwd"),
    "flash_dkdv": ("paddle_tpu/ops/flash_attention.py:254", "bwd"),
    "flash_dq": ("paddle_tpu/ops/flash_attention.py:312", "bwd")}


def check_flash(torch, np, dev):
    """(b) the flash kernels against their plain versions: the training
    shape (timed, with SDPA as the library yardstick), the same shape with
    the fused leg's attention dropout, a small dropout case and ragged
    sq != sk cases (checked only)."""
    per, library = flash_cases(torch, np, dev, FLASH_CASES)
    library = library["train"]
    results = {}
    for name, (line, lib) in FLASH_REPLACES.items():
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


# the 1.3B pretraining path's attention (c2c (1)): B=4, H=16, S=2048, d=128,
# without dropout (leg A) and with the recipe's 0.1 (leg B)
PRETRAIN_FLASH_CASES = {
    "1p3b": (4, 16, 2048, 2048, 128, 0.0, "bfloat16", True),
    "1p3b-dropout": (4, 16, 2048, 2048, 128, 0.1, "bfloat16", True),
}


def check_flash_d128(torch, np, dev):
    """(c2c 1) the flash kernels at the 1.3B attention shape, against their
    plain versions with the (b) tolerances, timed with SDPA beside them.
    Returns, per kernel, each case's numbers."""
    per, library = flash_cases(torch, np, dev, PRETRAIN_FLASH_CASES)
    out = {}
    for name, (_, lib) in FLASH_REPLACES.items():
        out[name] = {
            tag: {"shape": "B=4, H=16, S=2048, d=128, bf16, causal, "
                           f"p={PRETRAIN_FLASH_CASES[tag][5]}",
                  **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "max_abs_err", "tol",
                                       "err_over_tol")},
                  "library_ms": library[tag][lib]}
            for tag, r in per[name].items()}
    return out


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
# (c1d) traced serving, the Layer machinery, the trace drill
# ---------------------------------------------------------------------------
# a replica holds 4 streams: the survivor is full with its own when the
# victims arrive, so their recompute waits behind it, as in the drill
TRACE_MAX_SEQS = 4
TRACE_COST_ROUNDS, TRACE_COST_TOKENS = 3, 16


def traced_fleet(torch, np, _kernels, model, prompts, run_dir):
    """(i): two in-process replicas under a journaling router, each
    process part (router, replica 0, replica 1) streaming its records to
    its own worker-<i>.jsonl, the replica of stream 0 stopped once it has
    FLEET_STOP_AFTER tokens; then the run directory alone is assembled,
    attributed, diagnosed and exported."""
    from paddle_tpu_torch.convert import SERVING_ENGINE
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.fleet import LocalReplica, Router, drills
    from paddle_tpu_torch.observability import doctor, requesttrace
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    from paddle_tpu_torch.observability.sinks import (MetricsWriter,
                                                      metrics_dir)

    engine_kw = {**SERVING_ENGINE, "max_seqs": TRACE_MAX_SEQS}
    ref = ServingEngine(model, **engine_kw, registry=MetricsRegistry())
    want = ref.generate(prompts, max_new_tokens=FLEET_NEW_TOKENS)
    del ref
    regs = [MetricsRegistry() for _ in range(3)]
    writers = [reg.add_sink(MetricsWriter(metrics_dir(run_dir), worker_id=i))
               for i, reg in enumerate(regs)]
    reps = [LocalReplica(ServingEngine(model, **engine_kw,
                                       registry=regs[i + 1], replica_id=i,
                                       run_dir=run_dir), replica_id=i)
            for i in range(2)]
    router = Router(reps, registry=regs[0], run_dir=run_dir)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [router.submit(p, max_new_tokens=FLEET_NEW_TOKENS)
            for p in prompts]
    while len(router.journals[rids[0]].tokens) < FLEET_STOP_AFTER:
        router.pump()
    victim = router.journals[rids[0]].replica_id
    reps[victim].engine._state = "stopped"       # no drain, no spill
    outs = [router.collect(r, timeout=300) for r in rids]
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    for reg, w in zip(regs, writers):
        reg.remove_sink(w)                       # flush and close
    exact = drills.check_exact("traced fleet", [o["tokens"] for o in outs],
                               want, None)
    require(router.failovers >= 1, "c1d (i): no failover")
    for name in SERVING_KERNELS:
        require(launches[name] > 0,
                f"c1d (i): {name} launched 0 times in the part")

    t = time.perf_counter()
    result = requesttrace.assemble_run(run_dir)
    assemble_s = time.perf_counter() - t
    traces = result["traces"]
    require(len(traces) == len(rids) == result["complete"]
            and {tr["request_id"] for tr in traces} == set(rids),
            f"c1d (i): {result['complete']} complete of {len(traces)} "
            f"traces for {len(rids)} requests")
    require(not result["orphan_spans"],
            f"c1d (i): orphan spans {result['orphan_spans']}")
    coverage = min(tr["coverage"] for tr in traces)
    require(coverage >= 0.95, f"c1d (i): coverage floor {coverage}")
    stitched = sum(1 for tr in traces
                   if {"replica-0", "replica-1"} <= set(tr["procs"]))
    require(stitched >= 1, "c1d (i): no trace across both replicas")
    attrib = requesttrace.tail_latency_attribution(traces)
    require(attrib is not None
            and attrib["dominant"] == "failover_recompute",
            f"c1d (i): tail attribution {attrib}")
    t = time.perf_counter()
    diagnosis = doctor.diagnose(run_dir)
    diagnose_s = time.perf_counter() - t
    tail = [f for f in diagnosis["findings"] if f["kind"] == "tail_latency"]
    require(tail and tail[0]["data"]["dominant"] == "failover_recompute",
            f"c1d (i): doctor findings "
            f"{[(f['kind'], f['title']) for f in diagnosis['findings']]}")
    chrome = os.path.join(run_dir, "trace_chrome.json")
    events = requesttrace.export_chrome_trace(chrome, traces)
    with open(chrome) as f:
        require(len(json.load(f)["traceEvents"]) == events > 0,
                "c1d (i): the Chrome trace does not parse back")
    return {"streams": len(rids), "token_exact": exact,
            "failovers": router.failovers, "wall_s": wall_s,
            "traces": len(traces), "coverage_min": coverage,
            "stitched_across_replicas": stitched,
            "wal_matched": result["wal_matched"],
            "tail_dominant": attrib["dominant"],
            "tail_p99_ms": attrib["p99_ms"],
            "tail_median_ms": attrib["median_ms"],
            "doctor_findings": [f["kind"] for f in diagnosis["findings"]],
            "chrome_events": events, "assemble_s": assemble_s,
            "diagnose_s": diagnose_s,
            "launches": {n: launches[n] for n in SERVING_KERNELS}}


def trace_cost(torch, model, prompts):
    """The host cost of tracing a step: one engine traced (a registry with
    a sink, request tracing on) and untraced (the same registry, tracing
    off), alternated, each step's wall ms (the step reads its tokens
    back) and the span emission's own seconds a step (its meter)."""
    from paddle_tpu_torch.convert import SERVING_ENGINE
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability import requesttrace
    from paddle_tpu_torch.observability.registry import MetricsRegistry

    steps = {"traced": [], "untraced": []}
    emission = []
    for _ in range(TRACE_COST_ROUNDS):
        for mode in ("traced", "untraced"):
            os.environ["PTPU_TRACE_REQUESTS"] = \
                "1" if mode == "traced" else "0"
            reg = MetricsRegistry()
            reg.add_sink(RecordSink())
            eng = ServingEngine(model, **SERVING_ENGINE, registry=reg)
            for p in prompts:
                eng.submit(p, max_new_tokens=TRACE_COST_TOKENS)
            eng.step()                             # the prefills
            requesttrace.emission_cost.start()
            n = 0
            while eng.has_work():
                t = time.perf_counter()
                eng.step()
                steps[mode].append((time.perf_counter() - t) * 1e3)
                n += 1
            requesttrace.emission_cost.stop()
            if mode == "traced":
                emission.append(requesttrace.emission_cost.seconds * 1e3
                                / max(1, n))
    p50 = {k: statistics.median(v) for k, v in steps.items()}
    return {"step_ms_p50": p50,
            "traced_minus_untraced_ms": p50["traced"] - p50["untraced"],
            "emission_ms_a_step": emission, "rounds": TRACE_COST_ROUNDS}


def layer_apply(torch, np, dev, _kernels):
    """(ii): the training step of convert.training_workload (GPT-125M,
    bf16 O1, flash attention) through ``model.apply(variables, ids,
    labels)`` with gradients by ``torch.autograd.grad``, against the
    module's own forward and backward; a forward post-hook; and
    ``set_state_dict`` of convert's JAX-format weights."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import (TRAINING_SEED, random_state,
                                          training_workload)
    from paddle_tpu_torch.nn import Layer

    model, _, ids, labels = training_workload(dev)
    require(isinstance(model, Layer), "c1d (ii): the model is no Layer")
    names = [n for n, _ in model.named_parameters()]
    variables = {**dict(model.named_parameters()),
                 **dict(model.named_buffers())}
    buffers = {n: b.clone() for n, b in model.named_buffers()}

    def step(fn):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = fn()
        return loss, torch.autograd.grad(loss,
                                         [variables[n] for n in names])

    ref_loss, ref_grads = step(lambda: model(ids, labels=labels))
    # the module against itself: a gradient it does not reproduce bit for
    # bit (an atomic accumulation) is held within its own repeat distance
    again_loss, again = step(lambda: model(ids, labels=labels))
    spread = {n: (g - r).abs().max().item()
              for n, g, r in zip(names, again, ref_grads)
              if not torch.equal(g, r)}
    require(torch.equal(again_loss, ref_loss),
            "c1d (ii): the module's loss is not reproducible")
    del again
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t = time.perf_counter()
    loss, grads = step(lambda: model.apply(variables, ids, labels))
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t
    launches = {k: _kernels.launches[k] for k in TRAINING_KERNELS}
    require(all(v > 0 for v in launches.values()),
            f"c1d (ii): flash launches {launches}")
    differ = [n for n, g, r in zip(names, grads, ref_grads)
              if not torch.equal(g, r)
              and (n not in spread
                   or (g - r).abs().max().item() > spread[n])]
    require(torch.equal(loss, ref_loss) and not differ,
            f"c1d (ii): loss {loss.item()} vs {ref_loss.item()}, "
            f"gradients differing: {differ[:5]} ({len(differ)})")
    require(all(torch.equal(b, buffers[n])
                for n, b in model.named_buffers()),
            "c1d (ii): apply changed a buffer")
    model.eval()
    with torch.no_grad():
        x = ids[:1, :128]
        plain = model(x)
        handle = model.register_forward_post_hook(
            lambda layer, args, out: out + 1.0)
        hooked = model(x)
        handle.remove()
        require(torch.equal(hooked, plain + 1.0)
                and torch.equal(model(x), plain),
                "c1d (ii): the post-hook did not replace the logits")
    state = random_state(model, TRAINING_SEED + 1)
    model.set_state_dict(state)
    back = model.state_dict()
    require(set(back) == set(state)
            and all(torch.equal(back[k], torch.from_numpy(v).to(
                back[k].device, back[k].dtype)) for k, v in state.items()),
            "c1d (ii): set_state_dict did not round-trip")
    return {"loss": loss.item(), "gradients": len(grads),
            "bit_exact": len(grads) - len(spread),
            "module_not_reproducible": spread, "apply_s": apply_s,
            "launches": launches, "buffers": len(buffers)}


def traced_serving(torch, np, dev, _kernels, root):
    import shutil
    from paddle_tpu_torch.convert import serving_workload
    from paddle_tpu_torch.inference.fleet import drills

    work = os.path.join(root, "build", "traced_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    before = os.environ.get("PTPU_TRACE_REQUESTS")
    t0 = time.perf_counter()
    try:
        os.environ["PTPU_TRACE_REQUESTS"] = "1"
        model, prompts = serving_workload(dev, dtype="float32")
        fleet = traced_fleet(torch, np, _kernels, model, prompts,
                             os.path.join(work, "fleet"))
        log(json.dumps({"traced_serving_fleet": fleet}))
        cost = trace_cost(torch, model, prompts)
        log(json.dumps({"traced_serving_cost": cost}))
    finally:
        if before is None:
            os.environ.pop("PTPU_TRACE_REQUESTS", None)
        else:
            os.environ["PTPU_TRACE_REQUESTS"] = before
    del model
    torch.cuda.empty_cache()
    applied = layer_apply(torch, np, dev, _kernels)
    log(json.dumps({"layer_apply": applied}))
    torch.cuda.empty_cache()
    drill = drills.trace_drill(os.path.join(work, "drill"), device="cuda")
    log(json.dumps({"trace_drill": drill}))
    log(json.dumps({"traced_serving": {
        "wall_s": time.perf_counter() - t0,
        "assemble_s": fleet["assemble_s"],
        "diagnose_s": fleet["diagnose_s"],
        "drill_assemble_s": drill["assemble_s"],
        "drill_diagnose_s": drill["diagnose_s"],
        "trace_step_ms_p50": cost["step_ms_p50"],
        "emission_ms_a_step": cost["emission_ms_a_step"]}}))


# ---------------------------------------------------------------------------
# (c2) training
# ---------------------------------------------------------------------------
WARMUP_STEPS, TIMED_STEPS = 3, 10


def tiny_reference(torch, dev, cfg, what, make=None,
                   shape="gpt_tiny (S=256)"):
    """A float32 training step at a tiny size (no autocast) on the card
    (kernels) against the same weights and data on the CPU (plain
    versions): the loss, every gradient, and the loss after one AdamW
    step.  ``make(device)`` gives ``(model, optimizer, ids, inputs)``, the
    model called as ``model(ids, **inputs)``; by default
    ``training_workload`` of ``cfg`` at B=2, S=256 with its labels."""
    from paddle_tpu_torch.convert import training_workload

    def gpt(device):
        m, opt, ids, labels = training_workload(device, cfg, batch=2,
                                                seq_len=256)
        return m, opt, ids, {"labels": labels}
    runs = []
    for device in (dev, "cpu"):
        m, opt, ids, inputs = (make or gpt)(device)
        loss, _ = m(ids, **inputs)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        opt.step()
        with torch.no_grad():
            loss2, _ = m(ids, **inputs)
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
    log(f"{what} reference: float32 {shape} card vs CPU, loss "
        f"{l_gpu:.6f} vs {l_cpu:.6f}, {len(g_cpu)} gradients within 1e-4 "
        f"of their range + 1e-6 (worst err/tol {worst:.3f}), loss after one "
        f"AdamW step {l2_gpu:.6f} vs {l2_cpu:.6f}")


def timed_steps(torch, np, _kernels, model, opt, ids, labels, kernels,
                what, *, inputs=None, causal=True, model_name="gpt_125m"):
    """WARMUP_STEPS + TIMED_STEPS training steps on one batch (``labels``,
    or the keyword ``inputs`` of a BERT step), each ending in the loss
    readback, with every launch counter zeroed just before: each of
    ``kernels`` must launch once per layer and step, and the loss must be
    finite and fall.  Returns the fields of the JSON line; MFU counts the
    attention term without the causal halving when ``causal`` is False."""
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
        loss = train_step(model, opt, ids, labels, **(inputs or {}))
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
    # plus the attention term 12 L h S, halved when causal
    attn = 12.0 * cfg.num_layers * cfg.hidden_size * s
    flops_per_token = 6.0 * n_params + (attn / 2.0 if causal else attn)
    return {
        "model": model_name, "dtype": "bfloat16", "amp": "O1",
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
# (c2c) GPT-3 1.3B pretraining
# ---------------------------------------------------------------------------
PRETRAIN_WARMUP, PRETRAIN_TIMED = 2, 5     # leg A's steps
PRETRAIN_B_STEPS = 4                       # leg B's steps before the inf
PRETRAIN_SEED = 2024                       # the framework's streams
RESUME_LAYERS, RESUME_STEPS = 2, 4         # (5): full width, 2 layers
INF_PARAM = "gpt.h.0.mlp.fc_in.weight"     # (4): the gradient made inf


def grads_of(model):
    return {n: p.grad for n, p in model.named_parameters()}


def flops_per_token(cfg, n_params, s):
    """paddle_tpu/observability/mfu.py flops_per_token: 6N for the matmuls
    plus the causal attention term 12 L h S / 2 (recompute not counted)."""
    return 6.0 * n_params + 12.0 * cfg.num_layers * cfg.hidden_size * s / 2.0


def pretrain_leg_a(torch, np, dev, _kernels):
    """(c2c 2) leg A: 2 warm-up and 5 timed steps; the loss near ln V; the
    flash launches a step: 48 forward (24 + 24 replays), 24 dK/dV, 24
    dQ."""
    from paddle_tpu_torch.convert import pretraining_workload
    from paddle_tpu_torch.training import train_step
    model, opt, ids, labels, kw = pretraining_workload(dev, leg="A")
    cfg = model.config
    require(cfg.num_layers == 24 and cfg.hidden_size == 2048
            and cfg.num_heads == 16 and cfg.vocab_size == 50304
            and cfg.max_position_embeddings == 2048 and cfg.use_recompute
            and cfg.recompute_policy is None and cfg.use_pallas_attention
            and not cfg.use_fused_block and cfg.dtype == "bfloat16"
            and cfg.hidden_dropout == 0.0 and tuple(ids.shape) == (4, 2048)
            and kw == {}, "not the full-width GPT-3 1.3B leg A at B=4, "
            "S=2048")
    b, s = ids.shape
    steps = PRETRAIN_WARMUP + PRETRAIN_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(train_step(model, opt, ids, labels, **kw)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_kernels.launches)
    per_step = {"flash_fwd": 2 * cfg.num_layers, "flash_dkdv": cfg.num_layers,
                "flash_dq": cfg.num_layers}
    for name, want in per_step.items():
        require(launches[name] == want * steps,
                f"pretraining leg A: {name} launched {launches[name]} times "
                f"in {steps} steps, not {want} a step")
    for name in (*FUSED_KERNELS, *FUSED_ONLY_KERNELS, *F32_KERNELS):
        require(launches[name] == 0, f"pretraining leg A: {name} launched")
    require(all(np.isfinite(losses)), f"leg A: nonfinite loss {losses}")
    ln_v = float(np.log(cfg.vocab_size))
    # random ids under 0.02-scaled weights: logits of std ~0.9 add ~0.4
    require(abs(losses[0] - ln_v) < 1.0,
            f"leg A: first loss {losses[0]} is not near ln V = {ln_v}")
    require(losses[-1] < losses[0], f"leg A: the loss did not fall {losses}")
    p50 = statistics.median(times[PRETRAIN_WARMUP:])
    n_params = sum(p.numel() for p in model.parameters())
    tok_s = b * s / (p50 / 1e3)
    fpt = flops_per_token(cfg, n_params, s)
    line = {"leg": "A", "model": "gpt_1p3b", "params": n_params,
            "B": b, "S": s, "amp": "O1", "recompute": "full",
            "optimizer": "AdamW(learning_rate=1e-4, weight_decay=0.01)",
            "steps": {"warmup": PRETRAIN_WARMUP, "timed": PRETRAIN_TIMED},
            "step_ms_p50": p50, "step_ms": times[PRETRAIN_WARMUP:],
            "tokens_per_s": tok_s, "flops_per_token": fpt,
            "mfu": tok_s * fpt / BF16_FLOPS,
            "mfu_peak": "989 TFLOP/s bf16 dense",
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss_first": losses[0], "ln_vocab": ln_v, "losses": losses,
            "flash_launches_per_step": {n: launches[n] // steps
                                        for n in per_step}}
    log(f"pretraining leg A: step p50 {p50:.2f} ms, {tok_s:.0f} tokens/s, "
        f"MFU {line['mfu']:.4f}, peak {line['peak_memory_gb']:.2f} GB, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (ln V {ln_v:.4f}); "
        f"flash launches a step {line['flash_launches_per_step']}")
    return model, ids, labels, line


def recompute_at_work(torch, model, ids, labels):
    """(c2c 3) one forward + backward of leg A's model without recompute,
    under "full" and under "dots_saveable": the peak memory above the
    resting state is ordered full < dots_saveable <= none, and "full"'s
    gradients agree with no recompute's within the flash kernels' backward
    tolerance (one bf16 unit of each gradient's range)."""
    from paddle_tpu_torch import amp
    cfg = model.config
    peaks, ref = {}, None
    worst = 0.0
    for policy in ("full", "none", "dots_saveable"):
        cfg.use_recompute = policy != "none"
        cfg.recompute_policy = None if policy == "none" else policy
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        resting = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = model(ids, labels=labels)
        loss.backward()
        torch.cuda.synchronize()
        peaks[policy] = (torch.cuda.max_memory_allocated() - resting) / 1e9
        if policy == "full":
            ref = {n: g.clone() for n, g in grads_of(model).items()}
        elif policy == "none":
            for n, g in grads_of(model).items():
                tol = 2.0 ** -7 * max(1e-30, float(g.abs().max()))
                err = float((ref[n] - g).abs().max())
                require(err <= tol, f"recompute: grad {n} of 'full' differs "
                        f"from no recompute by {err} > {tol}")
                worst = max(worst, err / tol)
            del ref
    cfg.use_recompute, cfg.recompute_policy = True, None
    model.zero_grad(set_to_none=True)
    require(peaks["full"] < peaks["dots_saveable"] <= peaks["none"],
            f"recompute: peak memory above rest not ordered full < "
            f"dots_saveable <= none: {peaks}")
    line = {"peak_gb_above_rest": peaks,
            "full_vs_none_grad_worst_err_over_tol": worst}
    log(f"recompute at work: peak above rest {peaks} GB; 'full' against no "
        f"recompute: every gradient within one bf16 unit of its range "
        f"(worst err/tol {worst:.3f})")
    return line


def snapshot(opt, model):
    sd = opt.state_dict()["state"]
    return {"params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "step": sd["step"].clone(),
            "master": {n: m.clone() for n, m in sd["master"].items()},
            "slots": {n: {k: v.clone() for k, v in s.items()}
                      for n, s in sd["slots"].items()}}


def same_state(torch, a, b):
    return (torch.equal(a["step"], b["step"])
            and all(torch.equal(a["params"][n], b["params"][n])
                    for n in a["params"])
            and all(torch.equal(a["master"][n], b["master"][n])
                    for n in a["master"])
            and all(torch.equal(a["slots"][n][k], b["slots"][n][k])
                    for n in a["slots"] for k in a["slots"][n]))


def pretrain_leg_b(torch, np, dev):
    """(c2c 4) leg B, the recipe: each step's lr is the schedule's host
    value, the global norm before clipping is logged, masters float32 and
    parameters bf16; a step whose gradient holds an inf (a hook) leaves
    parameters, masters, slots and the step count bit for bit and halves
    the scale; with dropout 0.1, recompute's gradients equal no
    recompute's bit for bit under the same seeds (the streams' replay)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import (PRETRAINING_T_MAX,
                                          PRETRAINING_WARMUP,
                                          pretraining_workload)
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    from paddle_tpu_torch.training import train_step
    fw_random.seed(PRETRAIN_SEED)
    model, opt, ids, labels, kw = pretraining_workload(dev, leg="B")
    cfg, scaler = model.config, kw["scaler"]
    require(cfg.num_layers == 24 and cfg.hidden_size == 2048
            and cfg.hidden_dropout == cfg.attention_dropout == 0.1
            and cfg.use_recompute and kw["level"] == "O2"
            and tuple(ids.shape) == (4, 2048), "not the 1.3B leg B recipe")
    plan = LinearWarmup(CosineAnnealingDecay(2e-4, PRETRAINING_T_MAX,
                                             eta_min=2e-5),
                        PRETRAINING_WARMUP, start_lr=0.0, end_lr=2e-4)
    steps = []
    for i in range(PRETRAIN_B_STEPS):
        t0 = time.perf_counter()
        loss = float(train_step(model, opt, ids, labels, **kw))
        ms = (time.perf_counter() - t0) * 1e3
        want = float(plan(i))
        require(opt.last_lr == want, f"leg B step {i}: lr {opt.last_lr} "
                f"!= the schedule's {want}")
        norm = float(opt._grad_clip.last_norm)
        require(np.isfinite(loss) and np.isfinite(norm),
                f"leg B step {i}: loss {loss}, norm {norm}")
        steps.append({"loss": loss, "lr": opt.last_lr, "grad_norm": norm,
                      "ms": ms})
    masters = opt.state_dict()["state"]["master"]
    require(all(p.dtype == torch.bfloat16 for p in model.parameters())
            and all(masters[n].dtype == torch.float32
                    for n, _ in model.named_parameters()),
            "leg B: parameters must be bf16 and masters float32")
    require(int(opt.state_dict()["state"]["step"]) == PRETRAIN_B_STEPS,
            "leg B: the step count")

    # an inf in one gradient: the step is skipped on the card
    before = snapshot(opt, model)
    scale = scaler.get_loss_scaling()
    param = dict(model.named_parameters())[INF_PARAM]

    def poison(g):
        g = g.clone()
        g.view(-1)[0] = float("inf")
        return g
    hook = param.register_hook(poison)
    loss = float(train_step(model, opt, ids, labels, **kw))
    hook.remove()
    after = snapshot(opt, model)
    require(same_state(torch, before, after), "leg B: the step with an inf "
            "gradient changed parameters, masters, slots or the step count")
    require(scaler.get_loss_scaling() == scale / 2,
            f"leg B: scale {scaler.get_loss_scaling()} after the inf, not "
            f"{scale / 2}")
    del before, after
    torch.cuda.empty_cache()

    # the streams' replay: recompute against no recompute, one seed
    grads = {}
    for rc in (True, False):
        cfg.use_recompute = rc
        model.zero_grad(set_to_none=True)
        fw_random.seed(PRETRAIN_SEED + 1)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss_rc, _ = model(ids, labels=labels)
        loss_rc.backward()
        if rc:
            grads = {n: g.clone() for n, g in grads_of(model).items()}
        else:
            differ = [n for n, g in grads_of(model).items()
                      if not torch.equal(g, grads[n])]
            require(not differ, f"leg B: dropout 0.1 gradients under "
                    f"recompute differ from no recompute's: {differ[:4]}")
    cfg.use_recompute = True
    model.zero_grad(set_to_none=True)
    line = {"leg": "B", "model": "gpt_1p3b", "amp": "O2",
            "dropout": cfg.hidden_dropout, "recompute": "full",
            "optimizer": "AdamW(beta2=0.95, epsilon=1e-8, weight_decay=0.1 "
                         "on 2-D weights), ClipGradByGlobalNorm(1.0)",
            "schedule": f"LinearWarmup({PRETRAINING_WARMUP}) then "
                        f"CosineAnnealingDecay(2e-4, T_max="
                        f"{PRETRAINING_T_MAX}, eta_min=2e-5)",
            "steps": steps, "inf_step": {"loss": loss, "skipped": True,
                                         "scale_before": scale,
                                         "scale_after":
                                         scaler.get_loss_scaling()},
            "dropout_replay": "recompute grads == no-recompute grads, bit "
                              "for bit"}
    log(f"pretraining leg B: lr {[s['lr'] for s in steps]} (the schedule's "
        f"host values), global norm before clipping "
        f"{[round(s['grad_norm'], 4) for s in steps]}, losses "
        f"{[round(s['loss'], 4) for s in steps]}; the inf step kept every "
        f"parameter, master and slot bit for bit, scale {scale} -> "
        f"{scaler.get_loss_scaling()}; dropout 0.1 recompute gradients equal "
        f"no recompute's bit for bit")
    return line


def resume_run(torch, dev, cfg, stop_after=None, ckpt=None):
    """Leg B's recipe on ``cfg`` from the framework seed: RESUME_STEPS steps
    straight, or ``stop_after`` steps then a checkpoint under ``ckpt`` and
    the rest in a fresh model and optimizer loaded from it.  Returns the
    losses and the checkpoint's numbers."""
    from paddle_tpu_torch.convert import init_random_, pretraining_workload
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed.fingerprint import (DEFAULT_EXCLUDE,
                                                          TreeFingerprint)
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.training import train_step
    fw_random.seed(PRETRAIN_SEED)
    model, opt, ids, labels, kw = pretraining_workload(dev, cfg, leg="B")
    losses = []
    for _ in range(stop_after or RESUME_STEPS):
        losses.append(float(train_step(model, opt, ids, labels, **kw)))
    if stop_after is None:
        return losses, None
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "scaler": kw["scaler"].state_dict(),
             "rng": fw_random.get_state()}
    stamp = {**TreeFingerprint().digest(state).meta(),
             "exclude": list(DEFAULT_EXCLUDE)}
    t0 = time.perf_counter()
    ck.save_sharded(state, ckpt, integrity=stamp)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(ckpt) for f in fs)
    del model, opt, kw, state
    torch.cuda.empty_cache()
    # a fresh model (other weights) and optimizer, then the checkpoint
    model, opt, ids, labels, kw = pretraining_workload(dev, cfg, leg="B")
    init_random_(model, PRETRAIN_SEED + 99)
    fw_random.seed(PRETRAIN_SEED + 99)
    t0 = time.perf_counter()
    loaded = ck.load_sharded(ckpt)
    model.load_state_dict(loaded["model"])
    opt.set_state_dict(loaded["optimizer"])
    kw["scaler"].load_state_dict(loaded["scaler"])
    fw_random.set_state(loaded["rng"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for _ in range(RESUME_STEPS - stop_after):
        losses.append(float(train_step(model, opt, ids, labels, **kw)))
    return losses, {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                    "tree_digest": stamp["tree"]}


def resume(torch, dev, root):
    """(c2c 5) save / resume at full width and 2 layers: 4 steps straight
    against 2 steps, a checkpoint (parameters, masters, slots, step,
    scheduler, scaler, the framework's streams, with an mlh32/1 stamp), a
    fresh model and optimizer loaded from it and 2 more steps: steps 3-4
    give the same losses bit for bit; a shard cut by one byte raises
    CheckpointCorruption."""
    import shutil
    from paddle_tpu_torch.convert import random_state
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    cfg = gpt_1p3b(num_layers=RESUME_LAYERS, vocab_size=50304,
                   use_recompute=True, use_pallas_attention=True,
                   dtype="bfloat16")
    ckpt = os.path.join(root, "build", "pretraining_resume_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        straight, _ = resume_run(torch, dev, cfg)
        torch.cuda.empty_cache()
        resumed, numbers = resume_run(torch, dev, cfg, RESUME_STEPS // 2,
                                      ckpt)
        require(resumed == straight, f"resume: losses {resumed} != the "
                f"straight run's {straight} (bit for bit)")
        shard = os.path.join(ckpt, "model__gpt.wte.weight", "shard-p0-0.npy")
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) - 1)
        try:
            ck.load_sharded(ckpt)
        except ck.CheckpointCorruption as e:
            caught = str(e)
        else:
            raise RuntimeError("resume: a truncated shard loaded")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # what the host's numpy draw of convert.random_state would cost: the
    # 1.3B workloads draw on the card (convert.init_random_) instead
    model = GPTForCausalLM(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    random_state(model, 0)
    host_draw_s = time.perf_counter() - t0
    del model
    line = {"layers": RESUME_LAYERS, "hidden": cfg.hidden_size,
            "vocab": cfg.vocab_size, "steps": RESUME_STEPS,
            "losses": straight, "resumed_losses": resumed,
            "bit_identical": True, "checkpoint_bytes": numbers["bytes"],
            "save_s": numbers["save_s"], "load_s": numbers["load_s"],
            "tree_digest": numbers["tree_digest"],
            "truncated_shard": caught[:160],
            "random_state_s": host_draw_s, "random_state_params": n_params}
    log(f"convert.random_state on the host: {host_draw_s:.2f} s for "
        f"{n_params} parameters")
    log(f"resume: losses {straight} straight and {resumed} across the "
        f"checkpoint, bit for bit; {numbers['bytes']} bytes, save "
        f"{numbers['save_s']:.2f} s, load {numbers['load_s']:.2f} s "
        f"(verified CRCs and digest {numbers['tree_digest']}); a shard cut "
        "by one byte raised CheckpointCorruption")
    return line


def pretrain(torch, np, dev, _kernels, root):
    from paddle_tpu_torch.models.gpt import gpt_tiny
    # (6) the card against the CPU with recompute on
    tiny_reference(torch, dev, gpt_tiny(hidden_dropout=0.0,
                                        attention_dropout=0.0,
                                        use_pallas_attention=True,
                                        use_recompute=True),
                   "recompute training")
    model, ids, labels, leg_a = pretrain_leg_a(torch, np, dev, _kernels)
    leg_a["recompute_at_work"] = recompute_at_work(torch, model, ids,
                                                   labels)
    del model
    torch.cuda.empty_cache()
    leg_b = pretrain_leg_b(torch, np, dev)
    torch.cuda.empty_cache()
    resumed = resume(torch, dev, root)
    log(json.dumps({"pretraining": {"leg_a": leg_a, "leg_b": leg_b,
                                    "resume": resumed}}))
    return leg_a["flash_launches_per_step"]


# ---------------------------------------------------------------------------
# (c2d) BERT-base pretraining and the MoE GPT
# ---------------------------------------------------------------------------
# the flash kernels non-causal, BERT's attention: the bench row's shape
# (timed; every tile visible), and ragged lengths both ways (checked)
BERT_FLASH_CASES = {
    "bert": (16, 12, 512, 512, 64, 0.0, "bfloat16", True),
    "ragged": (2, 4, 136, 200, 64, 0.0, "bfloat16", False),
    "ragged-long-q": (2, 4, 200, 136, 64, 0.0, "bfloat16", False),
    "ragged-f32": (2, 4, 136, 200, 32, 0.0, "float32", False),
}
# the tiny MoE card-vs-CPU step: 4 experts on every other layer at a
# capacity factor that drops assignments (512 tokens x 2 choices into 4 x
# 192 slots)
MOE_TINY = dict(moe_num_experts=4, moe_every=2, moe_capacity_factor=0.75)
MOE_GEN_PROMPT, MOE_GEN_NEW = (4, 24), 16


def check_flash_noncausal(torch, np, dev):
    """(c2d 1) the flash kernels non-causal at BERT-base's attention shape
    (B=16, H=12, S=512, d=64, bf16; timed, SDPA beside them) and ragged,
    against their plain versions with the (b) tolerances."""
    per, library = flash_cases(torch, np, dev, BERT_FLASH_CASES,
                               causal=False)
    out = {}
    for name, (_, lib) in FLASH_REPLACES.items():
        r = per[name]["bert"]
        worst = max(per[name].values(), key=lambda x: x["err_over_tol"])
        out[name] = {
            "shape": "B=16, H=12, S=512, d=64, bf16, non-causal",
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            **{k: worst[k] for k in ("max_abs_err", "tol", "err_over_tol")},
            "library_ms": library["bert"][lib],
            "cases": {tag: {"max_abs_err": x["max_abs_err"],
                            "err_over_tol": x["err_over_tol"]}
                      for tag, x in per[name].items()}}
    return out


def train_bert(torch, np, dev, _kernels):
    """(c2d 2-3) a float32 bert_tiny step card vs CPU, then BERT-base
    pretraining (convert.bert_pretraining_workload) timed: 12 launches of
    each flash kernel a step."""
    from paddle_tpu_torch.convert import bert_pretraining_workload
    from paddle_tpu_torch.models.bert import bert_tiny
    tiny = bert_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                     use_pallas_attention=True)
    tiny_reference(torch, dev, None, "BERT", shape="bert_tiny (S=128)",
                   make=lambda device: bert_pretraining_workload(
                       device, tiny, batch=2, seq_len=128))
    model, opt, ids, inputs = bert_pretraining_workload(dev)
    cfg = model.config
    require(cfg.num_layers == 12 and cfg.hidden_size == 768
            and cfg.num_heads == 12 and cfg.vocab_size == 30528
            and cfg.dtype == "bfloat16" and cfg.use_pallas_attention
            and cfg.hidden_dropout == 0.0 and cfg.attention_dropout == 0.0
            and tuple(ids.shape) == (16, 512)
            and set(inputs) == {"mlm_labels", "nsp_labels"},
            "not the full-width BERT-base pretraining step at B=16, S=512")
    masked = float((inputs["mlm_labels"] != -100).float().mean())
    line = timed_steps(torch, np, _kernels, model, opt, ids, None,
                       TRAINING_KERNELS, "BERT", inputs=inputs, causal=False,
                       model_name="bert_base")
    line["sequences_per_s"] = ids.shape[0] / (line["step_ms_p50"] / 1e3)
    line["masked_share"] = masked
    line["flash_launches_per_step"] = {
        n: line["launches"][n] // (WARMUP_STEPS + TIMED_STEPS)
        for n in TRAINING_KERNELS}
    log(f"BERT-base: step p50 {line['step_ms_p50']:.2f} ms, "
        f"{line['sequences_per_s']:.1f} sequences/s, "
        f"{line['tokens_per_s']:.0f} tokens/s, MFU {line['mfu']:.4f}, peak "
        f"{line['peak_memory_gb']:.2f} GB, loss {line['loss_first']:.4f} -> "
        f"{line['loss_last']:.4f}; flash launches a step "
        f"{line['flash_launches_per_step']}")
    del model, opt
    return line


def moe_layers(model):
    return [(i, layer.mlp) for i, layer in enumerate(model.gpt.h)
            if layer._is_moe]


def route_stats(torch, model, run):
    """Run ``run()`` with each MoE layer's input and gate weight kept (a
    forward hook: a reference and an (H, E) copy, no routing work), then
    route those inputs again: per MoE layer, the share of dropped
    assignments and the aux of that forward."""
    kept = {}
    hooks = [mlp.register_forward_hook(
        lambda mod, args, out, i=i: kept.__setitem__(
            i, (args[0].detach(), mod.gate_weight.detach().clone())))
        for i, mlp in moe_layers(model)]
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    from paddle_tpu_torch.distributed.moe import route
    stats = {}
    with torch.no_grad():
        for i, mlp in moe_layers(model):
            x, w = kept[i]
            xt = x.reshape(-1, x.shape[-1])
            r = route(xt.float() @ w.float(), mlp.capacity(xt.shape[0]),
                      mlp.gate_type)
            assigned = len(r.kept) * xt.shape[0]
            stats[f"layer {i}"] = {
                "capacity": mlp.capacity(xt.shape[0]),
                "dropped_share": 1.0 - float(sum(k.sum() for k in r.kept))
                / assigned,
                "aux": float(r.aux)}
    return result, stats


def moe_layer_growth(torch, model, ids):
    """Peak memory growth over one MoE layer's forward at the full row
    under O1, with grad (what the training step keeps): it must stay below
    one float32 (T, E, C) tensor of the one-hot formulation."""
    from paddle_tpu_torch import amp
    _, mlp = moe_layers(model)[0]
    b, s = ids.shape
    t, e = b * s, mlp.num_experts
    c = mlp.capacity(t)
    one_hot_bytes = 4 * t * e * c
    x = torch.randn((b, s, model.config.hidden_size), device=ids.device,
                    dtype=torch.bfloat16, requires_grad=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out, _ = mlp.forward_with_aux(x)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    require(bool(torch.isfinite(out.float()).all()), "MoE layer: nonfinite")
    require(growth < one_hot_bytes,
            f"MoE layer forward grew peak memory by {growth} bytes, not "
            f"below one float32 (T, E, C) tensor ({one_hot_bytes})")
    del out, x
    return {"T": t, "E": e, "C": c, "peak_growth_gb": growth / 1e9,
            "held_for_backward_gb": held / 1e9,
            "one_hot_tec_f32_gb": one_hot_bytes / 1e9}


def moe_generate(torch, np, dev, _kernels):
    """(c2d 5) a float32 gpt_tiny MoE model through ``generate`` on the
    card (its decode step captured as a CUDA graph and replayed) gives the
    CPU's greedy tokens."""
    from paddle_tpu_torch.convert import load_jax_state, random_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   use_pallas_attention=True, **MOE_TINY)
    state = random_state(GPTForCausalLM(cfg, device="cpu"), SEED)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, MOE_GEN_PROMPT).astype(np.int32)
    outs = []
    for device in (dev, "cpu"):
        m = load_jax_state(GPTForCausalLM(cfg, device=device), state)
        _kernels.reset_launches()
        outs.append(m.generate(prompts, max_new_tokens=MOE_GEN_NEW).cpu())
        if device == dev:
            require(m._gen_loop.graph is not None,
                    "MoE generate: the decode step was not captured")
            decode = _kernels.launches["flash_decode"]
            require(decode > 0, "MoE generate: no flash_decode launch")
    require(torch.equal(outs[0], outs[1]),
            f"MoE generate: card tokens {outs[0].tolist()} != CPU "
            f"{outs[1].tolist()}")
    log(f"MoE generate: float32 gpt_tiny, 4 experts every 2nd layer, "
        f"{MOE_GEN_PROMPT[0]} x {MOE_GEN_NEW} greedy tokens under the "
        f"captured decode graph equal the CPU's ({decode} flash_decode "
        f"launches in the eager steps)")
    return {"tokens_equal": True, "shape": list(MOE_GEN_PROMPT),
            "new_tokens": MOE_GEN_NEW}


def train_moe(torch, np, dev, _kernels):
    """(c2d 4) a float32 gpt_tiny MoE step card vs CPU with dropped
    assignments, the MoE GPT-125M (convert.moe_training_workload) timed,
    one MoE layer's memory growth at the full row, then ``generate``."""
    from paddle_tpu_torch.convert import moe_training_workload
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.training import train_step
    tiny_cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                        use_pallas_attention=True, **MOE_TINY)

    def tiny(device):
        m, opt, ids, labels = moe_training_workload(device, tiny_cfg,
                                                    batch=2, seq_len=256)
        return m, opt, ids, {"labels": labels}
    tiny_reference(torch, dev, None, "MoE", make=tiny,
                   shape="gpt_tiny MoE (S=256)")
    m, _, ids, labels = tiny(dev)
    with torch.no_grad():
        _, tiny_stats = route_stats(torch, m, lambda: m(ids, **labels))
    require(all(v["dropped_share"] > 0 for v in tiny_stats.values()),
            f"MoE reference: no assignment dropped {tiny_stats}")
    del m

    model, opt, ids, labels = moe_training_workload(dev)
    cfg = model.config
    require(cfg.num_layers == 12 and cfg.hidden_size == 768
            and cfg.num_heads == 12 and cfg.vocab_size == 50304
            and cfg.moe_num_experts == 8 and cfg.moe_every == 2
            and cfg.moe_gate == "gshard" and cfg.moe_capacity_factor == 2.0
            and cfg.dtype == "bfloat16" and cfg.use_pallas_attention
            and cfg.hidden_dropout == 0.0 and tuple(ids.shape) == (8, 2048)
            and len(moe_layers(model)) == 6,
            "not the full-width MoE GPT-125M at B=8, S=2048")
    line, stats = route_stats(torch, model, lambda: timed_steps(
        torch, np, _kernels, model, opt, ids, labels, TRAINING_KERNELS,
        "MoE", model_name="gpt_125m, 8 experts every 2nd layer"))
    n_params = line["params"]
    expert = sum(p.numel() for p in moe_layers(model)[0][1].experts
                 .parameters()) // cfg.moe_num_experts
    # each token runs 2 of the 8 experts of a MoE layer
    active = n_params - len(moe_layers(model)) * (cfg.moe_num_experts - 2) \
        * expert
    attn = 12.0 * cfg.num_layers * cfg.hidden_size * ids.shape[1] / 2.0
    line["mfu_definition"] = ("the JAX moe row's (paddle_tpu/bench/"
                              "scenarios.py:122-124): 6N over all "
                              "parameters, all 8 experts of each MoE layer "
                              "counted though a token runs 2, plus 12 L h S "
                              "/ 2; it overstates the work a token does")
    line["active_params"] = active
    line["mfu_active_params"] = (line["tokens_per_s"] * (6.0 * active + attn)
                                 / BF16_FLOPS)
    line["moe_layers_last_step"] = stats
    line["flash_launches_per_step"] = {
        n: line["launches"][n] // (WARMUP_STEPS + TIMED_STEPS)
        for n in TRAINING_KERNELS}
    line["moe_layer_forward"] = moe_layer_growth(torch, model, ids)
    log(f"MoE GPT-125M: step p50 {line['step_ms_p50']:.2f} ms, "
        f"{line['tokens_per_s']:.0f} tokens/s, MFU {line['mfu']:.4f} (the "
        f"JAX row's 6N over all experts; {line['mfu_active_params']:.4f} "
        f"over the {active} parameters a token runs), peak "
        f"{line['peak_memory_gb']:.2f} GB, loss {line['loss_first']:.4f} -> "
        f"{line['loss_last']:.4f}; flash launches a step "
        f"{line['flash_launches_per_step']}; last step {stats}; one MoE "
        f"layer's forward {line['moe_layer_forward']}")
    del model, opt
    torch.cuda.empty_cache()
    line["generate"] = moe_generate(torch, np, dev, _kernels)
    return line


def bert_moe(torch, np, dev, _kernels):
    """(c2d) BERT-base pretraining and the MoE GPT.  Returns the
    non-causal flash cases and each workload's flash launches a step."""
    noncausal = check_flash_noncausal(torch, np, dev)
    torch.cuda.empty_cache()
    bert = train_bert(torch, np, dev, _kernels)
    torch.cuda.empty_cache()
    moe = train_moe(torch, np, dev, _kernels)
    log(json.dumps({"bert_moe": {"bert": bert, "moe": moe}}))
    for name in TRAINING_KERNELS:
        noncausal[name]["launches_per_step_bert"] = \
            bert["flash_launches_per_step"][name]
        noncausal[name]["launches_per_step_moe"] = \
            moe["flash_launches_per_step"][name]
    return noncausal


# ---------------------------------------------------------------------------
# (c2e) supervised training through hapi.Model
# ---------------------------------------------------------------------------
C2E_SEED = 19            # the token batches' numpy stream
C2E_B, C2E_S = 8, 2048   # convert.training_workload's batch
C2E_BATCHES = 8          # (1) fit, and train_step over the same batches
C2E_WARMUP = 2           # steps left out of the step p50s
C2E_SAVE_EVERY = 4       # RunSupervisor(save_interval_steps=)
C2E_REF_BATCHES = 10     # (4) the uninterrupted supervised run
C2E_KILL_AT = 6          # (4) the step after which the child is SIGKILLed
C2E_SUP_BATCHES = 12     # (2) the divergence ladder
C2E_DIVERGE_AT = 4       # (2) diverge_after's first step (4 spikes)
C2E_HANG_BATCHES = 5     # (3) the watchdog drill
C2E_HANG_AT = 2          # (3) the step whose readback hangs
C2E_INT_LAYERS = 2       # (5) the integrity drill's depth (full width)
C2E_INT_STEPS = 6
C2E_INT_EVERY = 2
C2E_FLIP_STEP = 4
C2E_FLIP_LEAF = "params/gpt.h.0.attn.qkv_proj.weight"
C2E_NOTE_ORDER = (0, 2, 1)   # (5) the order the workers note their steps
C2E_LADDER = ["divergence_skip", "divergence_skip", "lr_backoff",
              "divergence_rollback", "rollback"]


def lm_loss(out, labels):
    """The model's own fused LM loss, computed in its forward from the
    ``labels`` input (no (B, S, V) logits are built)."""
    return out[0]


def c2e_spec(cfg=None, device="cuda", batch=C2E_B, seq=C2E_S):
    from dataclasses import asdict
    from paddle_tpu_torch.models.gpt import gpt_125m
    cfg = cfg or gpt_125m(dtype="bfloat16", hidden_dropout=0.0,
                          attention_dropout=0.0, use_pallas_attention=True,
                          max_position_embeddings=2048)
    return {"config": asdict(cfg), "device": str(device), "batch": batch,
            "seq": seq}


def c2e_model(spec, layers=None):
    """``convert.training_workload``'s model and AdamW (seeded weights) in
    a ``Model`` prepared with the fused LM loss under bf16 O1."""
    from paddle_tpu_torch.convert import training_workload
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models.gpt import GPTConfig
    kw = dict(spec["config"])
    if layers is not None:
        kw["num_layers"] = layers
    model, opt, _ids, _labels = training_workload(
        spec["device"], GPTConfig(**kw), batch=1, seq_len=spec["seq"])
    m = Model(model)
    m.prepare(optimizer=opt, loss=lm_loss, amp_configs="O1")
    return m


def c2e_data(np, spec, n):
    rng = np.random.RandomState(C2E_SEED)
    shape = (n * spec["batch"], spec["seq"])
    vocab = spec["config"]["vocab_size"]
    return rng.randint(0, vocab, shape), rng.randint(0, vocab, shape)


def c2e_loader(spec, data, lo, hi):
    """Batches ``lo .. hi - 1`` as ``(ids, labels, labels)``: the network's
    inputs ``(ids, labels)`` and the label, served by the port's DataLoader
    (pinned, copied on a side stream)."""
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    ids, labels = data
    b = spec["batch"]
    rows = slice(lo * b, hi * b)
    return DataLoader(TensorDataset([ids[rows], labels[rows], labels[rows]]),
                      places=spec["device"], batch_size=b, shuffle=False)


def c2e_timer():
    from paddle_tpu_torch.hapi import Callback

    class Timer(Callback):
        """Host wall time between consecutive ``on_train_batch_end``s: one
        whole fit step (data wait, step, readback, telemetry)."""

        def __init__(self):
            super().__init__()
            self.t = []

        def on_train_begin(self, logs=None):
            self.t = [time.perf_counter()]

        def on_train_batch_end(self, step, logs=None):
            self.t.append(time.perf_counter())

        def ms(self):
            return [(b - a) * 1e3 for a, b in zip(self.t, self.t[1:])]
    return Timer()


def c2e_save_log(mgr):
    """Record each checkpoint save of ``mgr``: the call's seconds (the
    device-to-host copy and staging; the writes run on a thread), the
    seconds to its commit, and the bytes committed."""
    saves = []
    save, commit = mgr.save, mgr._commit

    def timed_save(step, state, use_async=True):
        rec = {"step": step, "t0": time.perf_counter()}
        saves.append(rec)
        save(step, state, use_async=use_async)
        rec["call_s"] = time.perf_counter() - rec["t0"]

    def timed_commit(step, stage):
        commit(step, stage)
        rec = next(r for r in saves if r["step"] == step)
        rec["commit_s"] = time.perf_counter() - rec["t0"]
        path = mgr._path(step)
        rec["bytes"] = sum(os.path.getsize(os.path.join(d, f))
                           for d, _, fs in os.walk(path) for f in fs)

    mgr.save, mgr._commit = timed_save, timed_commit
    return saves


def c2e_supervisor(run_dir, **kw):
    from paddle_tpu_torch.supervisor import RunSupervisor
    kw.setdefault("save_interval_steps", C2E_SAVE_EVERY)
    kw.setdefault("heartbeat_secs", 60.0)
    return RunSupervisor(run_dir, sigterm_handler=False, **kw)


def c2e_sync(torch, spec):
    if spec["device"] != "cpu":
        torch.cuda.synchronize()


def c2e_p50(ms):
    return statistics.median(ms[C2E_WARMUP:])


def c2e_fit_vs_train_step(torch, np, spec, _kernels):
    """(1) fit over C2E_BATCHES batches without a supervisor, against
    training.train_step over the same batches on a second model built
    alike: the losses, the flash launches of the fit and both step
    p50s."""
    from paddle_tpu_torch.convert import training_workload
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.training import train_step
    from paddle_tpu_torch.observability.tracing import span_tree_totals
    data = c2e_data(np, spec, C2E_BATCHES)
    m = c2e_model(spec)
    timer = c2e_timer()
    c2e_sync(torch, spec)
    span_tree_totals(reset=True)
    _kernels.reset_launches()
    hist = m.fit(c2e_loader(spec, data, 0, C2E_BATCHES), verbose=0,
                 callbacks=[timer])
    launches = dict(_kernels.launches)
    spans = span_tree_totals(reset=True)
    del m
    model, opt, _, _ = training_workload(
        spec["device"], GPTConfig(**spec["config"]), batch=1,
        seq_len=spec["seq"])
    b = spec["batch"]
    batches = [(torch.from_numpy(data[0][i * b:(i + 1) * b]).to(
        spec["device"]), torch.from_numpy(data[1][i * b:(i + 1) * b]).to(
        spec["device"])) for i in range(C2E_BATCHES)]
    plain_losses, plain_ms = [], []
    for ids, labels in batches:
        t0 = time.perf_counter()
        plain_losses.append(float(train_step(model, opt, ids, labels)))
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    del model, opt, batches
    return {"losses": hist["loss"], "train_step_losses": plain_losses,
            "fit_ms": timer.ms(), "train_step_ms": plain_ms,
            "launches": launches, "spans": spans}


def c2e_supervision_cost(np, spec, m, run_dir):
    """(2a) the same fit under a RunSupervisor that saves no checkpoint in
    the run: the guard, the norm, the readback before the step and the
    per-step bookkeeping, without a checkpoint writer in flight."""
    from paddle_tpu_torch.observability.tracing import span_tree_totals
    data = c2e_data(np, spec, C2E_BATCHES)
    sup = c2e_supervisor(run_dir, save_interval_steps=10 ** 9)
    timer = c2e_timer()
    span_tree_totals(reset=True)
    hist = m.fit(c2e_loader(spec, data, 0, C2E_BATCHES), verbose=0,
                 supervisor=sup, callbacks=[timer])
    require(all(np.isfinite(hist["loss"])) and sup.report.counts().get(
        "run_end") == 1, f"c2e supervision cost: {hist['loss']}")
    return {"step_ms": timer.ms(), "spans": span_tree_totals(reset=True)}


def c2e_reference(torch, np, spec, run_dir):
    """(4a) the supervised fit over C2E_REF_BATCHES batches with no fault:
    the losses a resumed run must reproduce, the supervised step times and
    each checkpoint save's seconds and bytes.  Returns the model too."""
    from paddle_tpu_torch.hapi import Callback
    data = c2e_data(np, spec, C2E_REF_BATCHES)
    m = c2e_model(spec)
    sup = c2e_supervisor(run_dir)
    saves = c2e_save_log(sup.elastic)
    timer = c2e_timer()
    writing = []

    class Writing(Callback):
        """Whether a save's writer thread was still running at the end of
        each step."""

        def on_train_batch_end(self, step, logs=None):
            pending = sup.elastic._pending
            writing.append(pending is not None and not pending.done())

    hist = m.fit(c2e_loader(spec, data, 0, C2E_REF_BATCHES), verbose=0,
                 supervisor=sup, callbacks=[timer, Writing()])
    sup.elastic.wait()
    kinds = sup.report.counts()
    require(not any(k in kinds for k in C2E_LADDER + ["step_failure"]),
            f"c2e reference: a fault-free supervised run recorded {kinds}")
    return m, {"losses": hist["loss"], "supervised_ms": timer.ms(),
               "writer_in_flight": writing,
               "saves": [{k: v for k, v in s.items() if k != "t0"}
                         for s in saves]}


def c2e_divergence(np, spec, m, run_dir):
    """(2) the divergence ladder: diverge_after(C2E_DIVERGE_AT, "spike",
    count=4) under the default guard must give skip, skip, LR back-off,
    rollback onto the newest committed step, and a completed run with
    finite losses."""
    from paddle_tpu_torch.testing import faults
    data = c2e_data(np, spec, C2E_SUP_BATCHES)
    sup = c2e_supervisor(run_dir)
    saves = c2e_save_log(sup.elastic)
    sup.inject_loss(faults.diverge_after(C2E_DIVERGE_AT, mode="spike",
                                         count=4))
    hist = m.fit(c2e_loader(spec, data, 0, C2E_SUP_BATCHES), verbose=0,
                 supervisor=sup)
    sup.elastic.wait()
    kinds = [e["kind"] for e in sup.report.events]
    ladder = [k for k in kinds if k in C2E_LADDER]
    require(ladder == C2E_LADDER,
            f"c2e divergence: the ladder was {ladder}, not {C2E_LADDER}")
    (rb,) = sup.report.of_kind("rollback")
    require(rb["restored_step"] == C2E_SAVE_EVERY
            and rb["start_step"] == C2E_SAVE_EVERY + 1,
            f"c2e divergence: rolled back onto {rb}, not step "
            f"{C2E_SAVE_EVERY}, the newest committed")
    (end,) = sup.report.of_kind("run_end")
    require(end["status"] == "completed" and all(
        np.isfinite(hist["loss"])) and len(hist["loss"]) == C2E_SUP_BATCHES,
        f"c2e divergence: run {end['status']}, losses {hist['loss']}")
    return {"ladder": ladder, "rollback": {k: rb[k] for k in (
        "reason", "restored_step", "start_step")},
        "lr_scale": sup.guard.lr_scale, "losses": hist["loss"],
        "saves": [{k: v for k, v in s.items() if k != "t0"}
                  for s in saves]}


def c2e_hang(np, spec, m, run_dir, watchdog_secs):
    """(3) a hung readback (faults.hang in one step's loss): the watchdog
    raises StepTimeout, the step is skipped, the run completes."""
    from paddle_tpu_torch.testing import faults
    data = c2e_data(np, spec, C2E_HANG_BATCHES)
    sup = c2e_supervisor(run_dir, watchdog_secs=watchdog_secs)
    hung = []

    def hang_once(step, loss):
        if step == C2E_HANG_AT and not hung:
            hung.append(time.perf_counter())
            faults.hang(60.0)
        return loss

    sup.inject_loss(hang_once)
    t0 = time.perf_counter()
    hist = m.fit(c2e_loader(spec, data, 0, C2E_HANG_BATCHES), verbose=0,
                 supervisor=sup)
    wall = time.perf_counter() - t0
    counts = sup.report.counts()
    (end,) = sup.report.of_kind("run_end")
    require(counts.get("watchdog_timeout") == 1
            and counts.get("step_failure") == 1
            and "rollback" not in counts and end["status"] == "completed"
            and len(hist["loss"]) == C2E_HANG_BATCHES - 1
            and all(np.isfinite(hist["loss"])),
            f"c2e hang: events {counts}, run {end['status']}, losses "
            f"{hist['loss']}")
    return {"watchdog_secs": watchdog_secs, "events": counts,
            "losses": hist["loss"], "fit_s": wall}


def c2e_child(spec):
    """A child process of (4) (``chip_smoke.py --c2e-child '<spec>'``):
    mode "kill" runs the supervised fit and SIGKILLs itself after step
    C2E_KILL_AT, once the step-C2E_SAVE_EVERY checkpoint is committed;
    mode "resume" restores the newest committed checkpoint of the same
    run_dir through ``ElasticTrainState.restore_or`` and fits the
    remaining batches, printing their losses as one JSON line."""
    import numpy as np
    from paddle_tpu_torch.hapi import Callback
    from paddle_tpu_torch.testing import faults
    data = c2e_data(np, spec, C2E_REF_BATCHES)
    m = c2e_model(spec)
    sup = c2e_supervisor(spec["run_dir"])
    if spec["mode"] == "kill":
        class Kill(Callback):
            def on_train_batch_end(self, step, logs=None):
                if sup.gstep >= C2E_KILL_AT:
                    sup.elastic.wait()
                    faults.sigkill_at(C2E_KILL_AT)(sup.gstep)

        m.fit(c2e_loader(spec, data, 0, C2E_REF_BATCHES), verbose=0,
              supervisor=sup, callbacks=[Kill()])
        return 1    # not reached: the callback kills the process
    m._optimizer._ensure_state()
    state, start = sup.elastic.restore_or(lambda: None, m._supervised_state)
    require(start > 0, "c2e resume: no committed checkpoint to resume")
    m._load_supervised_state(state)
    sup.gstep = start - 1          # the committed step's number
    hist = m.fit(c2e_loader(spec, data, start - 1, C2E_REF_BATCHES),
                 verbose=0, supervisor=sup)
    print(json.dumps({"c2e_resume": {"from_step": start - 1,
                                     "losses": hist["loss"]}}), flush=True)
    return 0


def c2e_kill_and_resume(spec, run_dir, reference):
    """(4) SIGKILL and resume: a child process dies by SIGKILL after step
    C2E_KILL_AT; a second one on the same run_dir resumes from the newest
    committed step; its losses must be the uninterrupted run's, bit for
    bit."""
    import shutil
    from paddle_tpu_torch.distributed.elastic import committed_checkpoints
    shutil.rmtree(run_dir, ignore_errors=True)
    script = os.path.abspath(__file__)
    out = {}
    for mode in ("kill", "resume"):
        child = dict(spec, mode=mode, run_dir=run_dir)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, script, "--c2e-child",
                               json.dumps(child)], capture_output=True,
                              text=True, timeout=600)
        out[f"{mode}_s"] = time.perf_counter() - t0
        if mode == "kill":
            require(proc.returncode == -9,
                    f"c2e kill: the child exited {proc.returncode}, not by "
                    f"SIGKILL: {proc.stderr[-2000:]}")
            out["committed"] = [os.path.basename(p) for p in
                                committed_checkpoints(os.path.join(
                                    run_dir, "checkpoints"))]
            continue
        require(proc.returncode == 0,
                f"c2e resume: the child exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        line = next(json.loads(x) for x in proc.stdout.splitlines()
                    if x.startswith('{"c2e_resume"'))["c2e_resume"]
        out.update(line)
    start = out["from_step"]
    require(out["losses"] == reference[start:],
            f"c2e resume: losses from step {start} {out['losses']} != the "
            f"uninterrupted run's {reference[start:]} (bit for bit)")
    shutil.rmtree(run_dir, ignore_errors=True)
    return out


def c2e_integrity(torch, np, spec, run_dir):
    """(5) three supervised Models in one process (full width, C2E_INT_
    LAYERS layers) under IntegrityGuard(every=C2E_INT_EVERY, expected=3,
    action="resync"); faults.bitflip flips one bit of worker 1's
    C2E_FLIP_LEAF after step C2E_FLIP_STEP.  The desync verdict must name
    worker 1 and that leaf, worker 1 must heal from the majority's offer,
    and the three fingerprints must be equal afterwards."""
    import shutil
    from paddle_tpu_torch.distributed.fingerprint import TreeFingerprint
    from paddle_tpu_torch.supervisor.integrity import IntegrityGuard
    from paddle_tpu_torch.testing import faults
    shutil.rmtree(run_dir, ignore_errors=True)
    workers = []
    for i in range(3):
        m = c2e_model(spec, layers=C2E_INT_LAYERS)
        guard = IntegrityGuard(run_dir, worker_id=i, every=C2E_INT_EVERY,
                               expected=3, action="resync",
                               resync_timeout=60.0)
        sup = c2e_supervisor(run_dir, worker_id=i, expected_workers=3,
                             integrity=guard, save_interval_steps=1000,
                             report_path=os.path.join(
                                 run_dir, f"report-{i}.json"))
        m._supervisor = sup
        m._optimizer._ensure_state()
        workers.append((m, sup))
    fault = faults.bitflip(C2E_FLIP_LEAF, bit=13, step=C2E_FLIP_STEP,
                           worker=1)
    ids, labels = c2e_data(np, spec, C2E_INT_STEPS)
    b = spec["batch"]
    named = None
    for step in range(1, C2E_INT_STEPS + 1):
        x = torch.from_numpy(ids[(step - 1) * b:step * b]).to(spec["device"])
        y = torch.from_numpy(labels[(step - 1) * b:step * b]).to(
            spec["device"])
        for i, (m, sup) in enumerate(workers):
            m.train_batch([x, y], y)
            m._load_supervised_state(fault(step, m._supervised_state(),
                                           worker=i))
        # worker 1 notes its step last: a check that runs before every
        # member published votes on the boards it finds, and a 1-1 split
        # there latches an ambiguous verdict (a rollback, not a resync),
        # in the JAX guard as in the port's
        for i in C2E_NOTE_ORDER:
            m, sup = workers[i]
            sup.note_step_ok(m._supervised_state())
        for m, sup in workers:
            sup.recheck_integrity()
        pending = [sup.pending_integrity for _, sup in workers]
        if any(p is not None for p in pending) and named is None:
            verdict = next(p for p in pending if p is not None)
            fp = [sup.integrity.last_fingerprint for _, sup in workers]
            named = {"step": verdict["step"],
                     "suspects": verdict["suspects"],
                     "leaves": fp[1].diff(fp[0])}
        suspects = {w for p in pending if p is not None
                    for w in p["suspects"]}
        for heal_suspects in (False, True):
            for i, (m, sup) in enumerate(workers):
                if (sup.pending_integrity is not None
                        and (i in suspects) == heal_suspects):
                    m._supervised_integrity_heal(sup)
    require(named == {"step": C2E_FLIP_STEP, "suspects": [1],
                      "leaves": [C2E_FLIP_LEAF]},
            f"c2e integrity: the desync verdict was {named}")
    heals = workers[1][1].report.of_kind("integrity.heal")
    require([h["action"] for h in heals] == ["resync"],
            f"c2e integrity: worker 1's heals {heals}")
    finals = [TreeFingerprint().digest(m._supervised_state()).hex()
              for m, _ in workers]
    require(len(set(finals)) == 1 and all(
        sup.integrity.last_verdict.ok for _, sup in workers),
        f"c2e integrity: fingerprints after the heal {finals}")
    # the stash's cost: one clone of a worker's pre-state on the card
    ig = workers[0][1].integrity
    c2e_sync(torch, spec)
    t0 = time.perf_counter()
    ig.stash_replay(C2E_INT_STEPS + 1, workers[0][0]._supervised_state(),
                    None)
    c2e_sync(torch, spec)
    stash_ms = (time.perf_counter() - t0) * 1e3
    out = {"verdict": named, "audit": heals[0]["audit"]["verdict"],
           "fingerprint": finals[0], "stash_bytes": ig.stash_bytes,
           "stash_ms": stash_ms,
           "offers": sum(h["action"] == "offer" for _, sup in workers
                         for h in sup.report.of_kind("integrity.heal"))}
    del workers
    shutil.rmtree(run_dir, ignore_errors=True)
    return out


def supervised_training(torch, np, dev, _kernels, root):
    """(c2e) GPT-125M at full width and depth trained through
    ``hapi.Model.fit``: (1) against train_step, (4a) supervised, (2) the
    divergence ladder, (3) the watchdog, (4) SIGKILL and resume, (5) the
    integrity drill.  Returns the fit's flash launches."""
    spec = c2e_spec(device=dev)
    cfg = spec["config"]
    require(cfg["num_layers"] == 12 and cfg["hidden_size"] == 768
            and cfg["vocab_size"] == 50304 and cfg["dtype"] == "bfloat16"
            and cfg["use_pallas_attention"] and not cfg["use_fused_block"]
            and cfg["fused_lm_loss"],
            "c2e: not the full-width bf16 GPT-125M training configuration")
    runs = os.path.join(root, "build", "c2e_runs")
    one = c2e_fit_vs_train_step(torch, np, spec, _kernels)
    torch.cuda.empty_cache()
    same = one["losses"] == one["train_step_losses"]
    require(same, f"c2e fit: losses {one['losses']} != train_step's "
            f"{one['train_step_losses']} over the same batches (both take "
            "the same route, so bit for bit)")
    require(all(np.isfinite(one["losses"])), f"c2e fit: {one['losses']}")
    for name in TRAINING_KERNELS:
        require(one["launches"][name] == 12 * C2E_BATCHES,
                f"c2e fit: {name} launched {one['launches'][name]} times in "
                f"{C2E_BATCHES} steps, not 12 a step")
    fit_p50, plain_p50 = c2e_p50(one["fit_ms"]), c2e_p50(one["train_step_ms"])
    m, ref = c2e_reference(torch, np, spec, os.path.join(runs, "reference"))
    saving_p50 = c2e_p50(ref["supervised_ms"])
    cost = c2e_supervision_cost(np, spec, m, os.path.join(runs, "cost"))
    sup_p50 = c2e_p50(cost["step_ms"])
    div = c2e_divergence(np, spec, m, os.path.join(runs, "divergence"))
    watchdog_secs = max(2.0, 20.0 * plain_p50 / 1e3)
    hang = c2e_hang(np, spec, m, os.path.join(runs, "hang"), watchdog_secs)
    del m
    torch.cuda.empty_cache()
    resume = c2e_kill_and_resume(spec, os.path.join(runs, "sigkill"),
                                 ref["losses"])
    integrity = c2e_integrity(torch, np, spec, os.path.join(runs,
                                                            "integrity"))
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(runs, ignore_errors=True)
    per_step = {k: one["launches"][k] / C2E_BATCHES for k in TRAINING_KERNELS}
    line = {"model": "gpt_125m", "B": C2E_B, "S": C2E_S, "amp": "O1",
            "fit": {"losses": one["losses"],
                    "train_step_losses": one["train_step_losses"],
                    "bit_identical_to_train_step": same,
                    "step_ms": one["fit_ms"], "step_ms_p50": fit_p50,
                    "train_step_ms": one["train_step_ms"],
                    "train_step_ms_p50": plain_p50,
                    "host_ms_per_step": fit_p50 - plain_p50,
                    "spans": one["spans"],
                    "flash_launches_per_step": per_step},
            "supervised": {"step_ms": cost["step_ms"],
                           "step_ms_p50": sup_p50,
                           "over_unsupervised_ms": sup_p50 - fit_p50,
                           "spans": cost["spans"]},
            "supervised_saving_every_4": {
                "step_ms": ref["supervised_ms"],
                "step_ms_p50": saving_p50,
                "writer_in_flight": ref["writer_in_flight"],
                "saves": ref["saves"], "losses": ref["losses"]},
            "divergence": div, "hang": hang, "sigkill_resume": resume,
            "integrity": integrity}
    log(json.dumps({"supervised_training": line}))
    log(f"supervised training: fit p50 {fit_p50:.2f} ms against train_step "
        f"{plain_p50:.2f} ms, supervised {sup_p50:.2f} ms ({saving_p50:.2f} "
        f"saving every {C2E_SAVE_EVERY} steps); saves "
        f"{[(s['bytes'], round(s['call_s'], 3), round(s['commit_s'], 2)) for s in ref['saves']]}"
        f"; ladder {div['ladder']} onto step {div['rollback']['restored_step']}"
        f"; watchdog skip in {hang['fit_s']:.2f} s; resume from step "
        f"{resume['from_step']} bit for bit; integrity {integrity['verdict']}"
        f" healed ({integrity['audit']}), stash {integrity['stash_bytes']} "
        f"bytes in {integrity['stash_ms']:.2f} ms")
    return {"launches": one["launches"], "per_step": per_step}


# ---------------------------------------------------------------------------
# (c2f) vision
# ---------------------------------------------------------------------------
RESNET50_FWD_FLOPS = 4.089e9    # a ResNet-50 forward at 224 x 224, an
# image (bench.py _bench_resnet50); a training step counts it 3 times


def cudnn_mode(torch, mode):
    """(deterministic, benchmark, enabled) of ``torch.backends.cudnn`` for
    a card run of (c2f 1): the defaults, cuDNN's deterministic algorithms,
    or no cuDNN (PyTorch's native convolutions: im2col and cuBLAS
    products, and its native batch norm)."""
    return {"default": (False, False, True),
            "deterministic": (True, False, True),
            "native": (False, False, False)}[mode]


def heads(name, out):
    """``{name: out}``, or one entry a head of a model with several
    (GoogLeNet's main, aux1 and aux2)."""
    if isinstance(out, tuple):
        return {name if i == 0 else f"{name} aux{i}": t.detach()
                for i, t in enumerate(out)}
    return {name: out.detach()}


def gate_runs(runs, name, phase, float64_gate,
              reported=("grad ", "eval logits")):
    """The bounds of :func:`vision_card_vs_cpu` over ``runs`` ("card",
    "cpu", "cpu64" and, with ``float64_gate``, "card64": each a dict of
    float64 CPU tensors by name): each card float32 tensor within 1e-4
    of the float64 CPU run's range plus 16 x the CPU float32 run's own
    distance from it; with ``float64_gate`` the card's float64 run within
    1e-9 of each range (plus 1e-12 of the largest gradient range), and
    the tensors named ``reported*`` only reported against the float32
    bound.  Returns ``(worst err / bound, the five largest relative
    distances, the reported tensors over their bound, the float64 worst
    err / bound)``."""
    worst, table, over = 0.0, [], []
    for k, ref in runs["cpu64"].items():
        scale = float(ref.abs().max())
        own = float((runs["cpu"][k] - ref).abs().max())
        bound = 1e-4 * scale + 16.0 * own + 1e-12
        err = float((runs["card"][k] - ref).abs().max())
        table.append((err / max(scale, 1e-30), own / max(scale, 1e-30), k))
        if float64_gate and k.startswith(reported) and err > bound:
            over.append((err / bound, k, err, own, scale))
            continue
        require(err <= bound, f"{phase} {name}: {k} on the card is {err} "
                f"from the float64 CPU run, bound {bound} (the CPU's "
                f"float32 run: {own}; range {scale})")
        worst = max(worst, err / bound)
    table.sort(reverse=True)
    over.sort(reverse=True)
    gate64 = None
    if float64_gate:
        ref = runs["cpu64"]
        floor = 1e-12 * max([float(v.abs().max()) for k, v in ref.items()
                             if k.startswith("grad ")] + [0.0])
        gate64 = 0.0
        for k, r in ref.items():
            err = float((runs["card64"][k] - r).abs().max())
            bound = 1e-9 * float(r.abs().max()) + floor
            require(err <= bound, f"{phase} {name}: {k} in float64 on the "
                    f"card is {err} from the float64 CPU run, bound {bound}")
            gate64 = max(gate64, err / bound)
    return worst, table[:5], over, gate64


def vision_card_vs_cpu(torch, np, dev, name, make, batch, hw, channels,
                       classes, diagnose=False, prepare=None, loss_fn=None,
                       phase="c2f (1)", float64_gate=False):
    """(c2f 1): one float32 training step of ``make(device)`` on the card
    and on the CPU from the same numpy weights and data, and a float64 CPU
    run as the anchor: for each compared tensor the card must lie within
    1e-4 of the anchor's range plus 16 x the CPU float32 run's own
    distance from the anchor (small-batch BatchNorm amplifies float32
    rounding, by another constant in each convolution algorithm: cuDNN's
    float32 ones against oneDNN's).  Returns the worst err / bound and the
    worst tensors.

    With ``diagnose`` three more card runs locate the card's distance: the
    same step in float64 on the card (its distance from the float64 CPU
    run is the card's arithmetic apart from float32 rounding), and float32
    under cuDNN's deterministic algorithms and without cuDNN.  For each
    run: the worst distance from the anchor over all tensors and over
    layer4's convolution gradients, each a share of the tensor's
    range.  ``prepare(model)`` runs after the weights are loaded (c2h:
    Dropout at p=0); ``loss_fn(logits, labels)`` replaces the
    cross-entropy (c2h: GoogLeNet's three heads).

    ``float64_gate`` (c2h): the same step in float64 on the card must lie
    within 1e-9 of each tensor's range of the float64 CPU run (plus 1e-12
    of the largest gradient range: the noise of tensors that are zero in
    exact arithmetic), so the card computes the CPU's function; the
    float32 bound above then holds the loss, the logits and the BatchNorm
    buffers (the forward), and the float32 distance of each gradient and
    of the eval logits after the step (which move with the gradients) is
    reported against it: the card's float32 convolutions and reductions
    (cuDNN's and PyTorch's CUDA kernels) sum in another order than
    oneDNN's and, where a gradient is a large cancellation, land further
    than 16 x the CPU's distance from float64 (PERF.md §6)."""
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    fw_random.seed(SEED)
    weights = {k: v.numpy() for k, v in make("cpu").state_dict().items()}
    rng = np.random.RandomState(SEED)
    x = (rng.randn(batch, channels, hw, hw) * 0.5).astype(np.float32)
    y = rng.randint(0, classes, (batch,))
    runs = {}
    plan = [("card", dev, torch.float32, "default"),
            ("cpu", "cpu", torch.float32, "default"),
            ("cpu64", "cpu", torch.float64, "default")]
    if float64_gate and not diagnose:
        plan.append(("card64", dev, torch.float64, "default"))
    if diagnose:
        plan += [("card64", dev, torch.float64, "default"),
                 ("card_deterministic", dev, torch.float32, "deterministic"),
                 ("card_native", dev, torch.float32, "native")]
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.enabled)
    for tag, device, dtype, mode in plan:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.enabled) = cudnn_mode(torch, mode)
        m = make(device)
        load_jax_state(m, weights)
        m = m.to(dtype)
        opt = Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                       parameters=m.named_parameters(),
                       multi_precision=False)
        xt = torch.from_numpy(x).to(device, dtype)
        yt = torch.from_numpy(y).to(device)
        m.train()
        if prepare is not None:
            prepare(m)
        logits = m(xt)
        loss = (loss_fn or F.cross_entropy)(logits, yt)
        loss.backward()
        out = {"loss": loss.detach().reshape(1), **heads("logits", logits)}
        out.update({f"grad {k}": p.grad for k, p in m.named_parameters()})
        opt.step()
        out.update({f"buffer {k}": b for k, b in m.named_buffers()})
        m.eval()
        with torch.no_grad():
            out.update(heads("eval logits", m(xt)))
        runs[tag] = {k: v.detach().double().cpu() for k, v in out.items()}
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.enabled) = saved
    worst, table, over, gate64 = gate_runs(runs, name, phase, float64_gate)
    diagnosis = {}
    if diagnose:
        ref = runs["cpu64"]
        layer4 = [k for k in ref if k.startswith("grad layer4")
                  and "conv" in k]

        def rel(run, keys):
            return max(float((run[k] - ref[k]).abs().max())
                       / max(float(ref[k].abs().max()), 1e-30)
                       for k in keys)
        diagnosis = {tag: {"worst_relative": rel(runs[tag], ref),
                           "layer4_conv_grads": rel(runs[tag], layer4)}
                     for tag, *_ in plan if tag != "cpu64"}
    return {"model": name, "B": batch, "hw": hw, "tensors": len(runs["cpu"]),
            "diagnosis": diagnosis,
            "loss_card": float(runs["card"]["loss"][0]),
            "loss_cpu": float(runs["cpu"]["loss"][0]),
            "loss_cpu64": float(runs["cpu64"]["loss"][0]),
            "worst_err_over_bound": worst,
            **({"float64_worst_err_over_bound": gate64,
                "float32_grads_and_eval_over_bound": len(over),
                # (err / bound, tensor, err, the CPU's, range), largest 3
                "float32_grads_and_eval_worst": over[:3]}
               if float64_gate else {}),
            # (card's distance from float64 / range, the CPU float32
            # run's / range, tensor), the largest five
            "worst_relative": table}


def vision_timed(torch, np, model, opt, images, labels, kw, what):
    """WARMUP_STEPS + TIMED_STEPS classification steps on one resident
    batch, each to the loss readback: finite losses; the fields of the
    JSON line."""
    from paddle_tpu_torch.training import classification_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(classification_step(model, opt, images, labels,
                                                **kw)))
        times.append(time.perf_counter() - t0)
    require(all(np.isfinite(losses)), f"nonfinite {what} loss: {losses}")
    step_ms = [t * 1e3 for t in times[WARMUP_STEPS:]]
    p50 = statistics.median(step_ms)
    return {"step_ms_p50": p50, "step_ms": step_ms,
            "img_per_s": images.shape[0] / (p50 / 1e3),
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def small_net(torch, tnn, device):
    """The image-classification recipe's SmallNet on the port's layers."""
    class SmallNet(torch.nn.Module):
        def __init__(self, num_classes=10):
            super().__init__()
            self.features = tnn.Sequential(
                tnn.Conv2D(1, 8, 3, padding=1, device=device), tnn.ReLU(),
                tnn.MaxPool2D(2),
                tnn.Conv2D(8, 16, 3, padding=1, device=device), tnn.ReLU(),
                tnn.MaxPool2D(2))
            self.head = tnn.Sequential(
                tnn.Flatten(), tnn.Linear(16 * 7 * 7, num_classes,
                                          device=device))

        def forward(self, x):
            return self.head(self.features(x))
    return SmallNet()


def vision_recipe(torch, np, dev):
    """(c2f 4): ``examples/image_classification.py``'s recipe on the
    port."""
    from paddle_tpu_torch import metric, nn, optimizer
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import MNIST
    np.random.seed(0)
    fw_random.seed(0)
    plain = T.Compose([T.ToTensor(), T.Normalize([0.5], [0.5])])
    train = MNIST(mode="train", transform=plain, synthetic_size=2048)
    test = MNIST(mode="test", transform=plain, synthetic_size=512)
    net = small_net(torch, nn, dev)
    model = Model(net)
    sched = optimizer.lr.CosineAnnealingDecay(3e-3, T_max=160)
    model.prepare(optimizer.Adam(learning_rate=sched,
                                 parameters=net.named_parameters()),
                  nn.CrossEntropyLoss(), metric.Accuracy())
    t0 = time.perf_counter()
    hist = model.fit(DataLoader(train, batch_size=128, shuffle=True,
                                places=dev), epochs=10, verbose=0)
    fit_s = time.perf_counter() - t0
    res = model.evaluate(DataLoader(test, batch_size=256, places=dev),
                         verbose=0)
    require(res["acc"] > 0.9, f"the recipe's accuracy {res['acc']} <= 0.9")
    return {"epochs": 10, "batches": len(hist["loss"]), "fit_s": fit_s,
            "loss_first": hist["loss"][0], "loss_last": hist["loss"][-1],
            "eval": res}


def vision(torch, np, dev, _kernels):
    from paddle_tpu_torch.convert import (lenet_training_workload,
                                          resnet_training_workload)
    from paddle_tpu_torch.observability.mfu import DEVICE_SPECS
    from paddle_tpu_torch.vision.models import LeNet, resnet50
    t_phase = time.perf_counter()
    reference = [
        vision_card_vs_cpu(torch, np, dev, "resnet50",
                           lambda d: resnet50(device=d), 4, 64, 3, 1000,
                           diagnose=True),
        vision_card_vs_cpu(torch, np, dev, "LeNet",
                           lambda d: LeNet(device=d), 8, 28, 1, 10)]
    for r in reference:
        log(f"vision reference: float32 {r['model']} B={r['B']} "
            f"{r['hw']}x{r['hw']} card vs CPU, loss {r['loss_card']:.6f} vs "
            f"{r['loss_cpu']:.6f}, {r['tensors']} tensors within bound "
            f"(worst err/bound {r['worst_err_over_bound']:.3f})")
        for tag, d in r["diagnosis"].items():
            log(f"  {r['model']} {tag}: worst distance from float64 "
                f"{d['worst_relative']:.3e} of a range, layer4's conv "
                f"gradients {d['layer4_conv_grads']:.3e}")
    _kernels.reset_launches()
    model, opt, images, labels, kw = resnet_training_workload(dev)
    require(tuple(images.shape) == (128, 3, 224, 224)
            and kw == {"level": "O1"} and model.num_classes == 1000
            and len(model.layer3) == 6,
            "not the JAX row's ResNet-50 at B=128, 224 x 224, O1")
    peak = DEVICE_SPECS["h100"]["bf16_tflops"] * 1e12
    nchw = vision_timed(torch, np, model, opt, images, labels, kw,
                        "ResNet-50")
    require(nchw["loss_last"] < nchw["loss_first"],
            f"the ResNet-50 loss did not fall: {nchw['losses']}")
    model = model.to(memory_format=torch.channels_last)
    images = images.contiguous(memory_format=torch.channels_last)
    nhwc = vision_timed(torch, np, model, opt, images, labels, kw,
                        "ResNet-50 channels_last")
    for line in (nchw, nhwc):
        line["mfu"] = line["img_per_s"] * 3 * RESNET50_FWD_FLOPS / peak
    del model, opt, images, labels
    torch.cuda.empty_cache()
    lenet = vision_timed(torch, np, *lenet_training_workload(dev), "LeNet")
    recipe = vision_recipe(torch, np, dev)
    launches = dict(_kernels.launches)
    require(not any(launches.values()),
            f"the vision path launched a kernel of the port: {launches}")
    log(json.dumps({"vision": {
        "reference": reference,
        "resnet50": {"B": 128, "hw": 224, "amp": "O1", "dtype": "bfloat16",
                     "optimizer": "Momentum(0.1, 0.9, weight_decay=1e-4)",
                     "flops_per_img_fwd": RESNET50_FWD_FLOPS,
                     "mfu_peak": "989 TFLOP/s bf16 dense",
                     "nchw": nchw, "channels_last": nhwc},
        "lenet": {"B": 64, "hw": 28, "dtype": "float32", **lenet},
        "recipe": recipe, "launches": launches,
        "phase_s": time.perf_counter() - t_phase}}))


# ---------------------------------------------------------------------------
# (c2h) the rest of the vision zoo and the detection ops
# ---------------------------------------------------------------------------
# (1): every family's default constructor at full width and 1000 classes,
# one float32 Momentum step at B=4 at the smallest resolution each takes in
# tests/test_vision_zoo.py
ZOO_CHECK = (("alexnet", {}, 224), ("vgg16", {"batch_norm": True}, 64),
             ("squeezenet1_1", {}, 96), ("mobilenet_v1", {}, 64),
             ("mobilenet_v2", {}, 64), ("mobilenet_v3_large", {}, 64),
             ("mobilenet_v3_small", {}, 64), ("shufflenet_v2_x1_0", {}, 64),
             ("densenet121", {}, 64), ("googlenet", {}, 128),
             ("inception_v3", {}, 128))
ZOO_CHECK_B = 4
# (2): vision_training_workload at B=128 and the family's ImageNet size
# (GoogLeNet's three heads do not fit classification_step's one logits)
ZOO_TIMED = tuple((n, kw) for n, kw, _ in ZOO_CHECK if n != "googlenet")
MOBILENET_V2_FWD = (0.55e9, 0.65e9)   # ~0.3 G multiply-adds an image
# (3): detector shapes.  Mask R-CNN R50-FPN: the P2 map (stride 4 of 800 x
# 1333), boxes of the sizes FPN assigns to P2 (under 112 px a side)
MASKRCNN = {"x": (2, 256, 200, 336), "scale": 0.25, "image": (800, 1333),
            "box_side": (16, 112), "boxes": 512, "mask_boxes": 128}
# R-FCN (ResNet-101, stride 16 of 600 x 1000): 21 classes x 7 x 7
RFCN = {"x": (2, 21 * 49, 38, 63), "scale": 1 / 16, "image": (600, 1000),
        "boxes": 300, "out": 7}
NMS_RPN = {"boxes": 6000, "iou": 0.7}
NMS_DET = {"boxes": 1000, "classes": 80, "iou": 0.5, "top_k": 100}
# YOLOv3 at 608 x 608: three heads, the standard anchors, 80 classes
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = ((19, [6, 7, 8], 32), (38, [3, 4, 5], 16), (76, [0, 1, 2], 8))
YOLO = {"N": 2, "gt": 50, "real": 20, "classes": 80, "img": 608,
        "conf": 0.01, "ignore": 0.7}
# DCNv2 ResNet-50 stage 5: a 3 x 3 conv of 512 channels at 1/32 of 800 x
# 1333
DCN = {"x": (2, 512, 25, 42), "out": 512}


def zoo_dropout_off(model):
    """Every Dropout of ``model`` at p=0 (c2h (1): masks differ between
    the card and the CPU)."""
    from paddle_tpu_torch.nn.layers import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def zoo_loss(logits, labels):
    """The cross-entropy, summed over GoogLeNet's three heads."""
    from paddle_tpu_torch.nn import functional as F
    if isinstance(logits, tuple):
        return sum(F.cross_entropy(t, labels) for t in logits)
    return F.cross_entropy(logits, labels)


def zoo_card_vs_cpu(torch, np, dev):
    from paddle_tpu_torch.vision import models
    out = []
    for name, kw, hw in ZOO_CHECK:
        t0 = time.perf_counter()
        r = vision_card_vs_cpu(
            torch, np, dev, name,
            lambda d, name=name, kw=kw: getattr(models, name)(device=d, **kw),
            ZOO_CHECK_B, hw, 3, 1000, prepare=zoo_dropout_off,
            loss_fn=zoo_loss, phase="c2h (1)", float64_gate=True)
        r["seconds"] = time.perf_counter() - t0
        log(f"c2h (1) {name}{'_bn' if kw else ''} B={ZOO_CHECK_B} {hw}x{hw}: "
            f"float64 card within 1e-9 (worst err/bound "
            f"{r['float64_worst_err_over_bound']:.3f}); float32 forward and "
            f"buffers within c2f's bound (worst {r['worst_err_over_bound']:.3f}"
            f"), {r['float32_grads_and_eval_over_bound']} of {r['tensors']} "
            f"float32 gradients / eval logits over it "
            f"{r['float32_grads_and_eval_worst'][:1]}; loss "
            f"{r['loss_card']:.6f} vs {r['loss_cpu']:.6f} "
            f"({r['seconds']:.1f} s)")
        out.append(r)
    return out


def hand_flops(torch, model, hw):
    """Forward FLOPs of one ``hw`` x ``hw`` image counted by hand: 2 x
    Cout x Cin / groups x kh x kw x Ho x Wo for each Conv2D (its output
    size read by a hook) and 2 x in x out for each Linear."""
    from paddle_tpu_torch.nn.layers import Conv2D, Linear
    total = [0]

    def conv(m, _, out):
        o, i, kh, kw = m.weight.shape
        total[0] += 2 * o * i * kh * kw * out.shape[-2] * out.shape[-1]

    def linear(m, _, out):
        total[0] += 2 * m.weight.shape[0] * m.weight.shape[1]
    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D)
                                     else linear)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, hw, hw,
                              device=next(model.parameters()).device))
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return total[0]


def zoo_timed(torch, np, dev):
    """(2): each family's bf16 O1 training at B=128 and its ImageNet size,
    MobileNetV2 also in channels_last."""
    from paddle_tpu_torch.convert import VISION_HW, vision_training_workload
    from paddle_tpu_torch.hapi import flops
    lines = {}
    for name, kw in ZOO_TIMED:
        model, opt, images, labels, step_kw = vision_training_workload(
            name, dev, **kw)
        hw = VISION_HW.get(name, 224)
        require(tuple(images.shape) == (128, 3, hw, hw)
                and step_kw == {"level": "O1"} and model.num_classes == 1000,
                f"c2h (2) {name}: not B=128, {hw} x {hw}, O1, 1000 classes")
        fwd = flops(model, (1, 3, hw, hw))
        if name == "mobilenet_v2":
            lo, hi = MOBILENET_V2_FWD
            hand = hand_flops(torch, model, hw)
            require(lo < fwd < hi and abs(fwd - hand) <= 0.01 * hand,
                    f"c2h (2): MobileNetV2's forward counts {fwd} FLOPs by "
                    f"hapi.flops and {hand} by hand, not both about 0.6 G "
                    "(0.3 G multiply-adds)")
            log(f"c2h (2) MobileNetV2 forward: {fwd} FLOPs by hapi.flops, "
                f"{hand} by hand")
        layouts = [("nchw", model, images)]
        if name == "mobilenet_v2":
            layouts.append(("channels_last", None, None))
        for layout, m, x in layouts:
            if layout == "channels_last":
                m = model.to(memory_format=torch.channels_last)
                x = images.contiguous(memory_format=torch.channels_last)
            line = vision_timed(torch, np, m, opt, x, labels, step_kw,
                                f"{name} {layout}")
            line["flops_fwd_per_img"] = fwd
            line["mfu"] = line["img_per_s"] * 3 * fwd / BF16_FLOPS
            key = name + ("_bn" if kw else "") + (
                "" if layout == "nchw" else "_channels_last")
            lines[key] = line
            log(f"c2h (2) {key}: B=128 {hw}x{hw} bf16 O1, step p50 "
                f"{line['step_ms_p50']:.2f} ms, {line['img_per_s']:.0f} "
                f"img/s, MFU {line['mfu']:.4f} ({fwd / 1e9:.3f} GFLOP a "
                f"forward), peak {line['peak_memory_gb']:.2f} GB, loss "
                f"{line['loss_first']:.4f} -> {line['loss_last']:.4f}")
        if name == "mobilenet_v2":
            ls = lines["mobilenet_v2"]
            require(ls["loss_last"] < ls["loss_first"],
                    f"c2h (2): the MobileNetV2 loss did not fall: "
                    f"{ls['losses']}")
        del model, opt, images, labels
        torch.cuda.empty_cache()
    return lines


def detection_compare(torch, np, dev, name, fn, inputs, grad_of, seed):
    """(3): ``fn(*tensors)`` in float32 on the card and on the CPU and in
    float64 on the CPU from the same numpy ``inputs``; the value and the
    gradients of sum(value * g) (g seeded) with respect to the inputs
    named in ``grad_of``.  Each tensor on the card within 4 x the CPU
    float32 run's distance from float64 plus 1e-6 of its range.  Returns
    the worst err / bound and the card's ms of the value (forward) and of
    the value with its gradients."""
    runs = {}
    for tag, device, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64)):
        ts = {k: torch.from_numpy(v).to(
            device=device, dtype=dtype if v.dtype.kind == "f" else None)
            for k, v in inputs.items()}
        for k in grad_of:
            ts[k].requires_grad_()
        out = fn(**ts)
        g = np.random.RandomState(seed).randn(*out.shape)
        (out * torch.from_numpy(g).to(device, out.dtype)).sum().backward()
        runs[tag] = {"value": out.detach().double().cpu(),
                     **{f"grad {k}": ts[k].grad.double().cpu()
                        for k in grad_of}}
    worst = 0.0
    for k, ref in runs["cpu64"].items():
        scale = float(ref.abs().max())
        own = float((runs["cpu"][k] - ref).abs().max())
        bound = 4.0 * own + 1e-6 * scale + 1e-30
        err = float((runs["card"][k] - ref).abs().max())
        require(err <= bound, f"c2h (3) {name}: {k} on the card is {err} "
                f"from the float64 CPU run, bound {bound} (the CPU's float32 "
                f"run: {own}; range {scale})")
        worst = max(worst, err / bound)
    ts = {k: torch.from_numpy(v).to(
        device=dev, dtype=torch.float32 if v.dtype.kind == "f" else None)
        for k, v in inputs.items()}

    def forward():
        with torch.no_grad():
            fn(**ts)

    def both():
        for k in grad_of:
            ts[k].requires_grad_()
            ts[k].grad = None
        fn(**ts).sum().backward()
    return {"worst_err_over_bound": worst, "ms": time_ms(torch, forward, 5),
            "ms_with_grads": time_ms(torch, both, 5),
            "tensors": len(runs["card"])}


def rois(np, rng, n_img, per_img, image, side):
    """``per_img`` boxes (x1, y1, x2, y2) an image, sides uniform in
    ``side`` pixels, inside the image."""
    h, w = image
    bw = rng.uniform(*side, (n_img * per_img, 1))
    bh = rng.uniform(*side, (n_img * per_img, 1))
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    return np.concatenate([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def nms_boxes(np, rng, n, image, objects):
    """RPN-like proposals: ``n`` boxes jittered around ``objects`` seeded
    objects of a ``image`` frame, uniform scores."""
    h, w = image
    ow = rng.uniform(32, 400, (objects, 1))
    oh = rng.uniform(32, 400, (objects, 1))
    ox = rng.uniform(0, w - ow)
    oy = rng.uniform(0, h - oh)
    obj = np.concatenate([ox, oy, ox + ow, oy + oh], 1)
    pick = rng.randint(0, objects, n)
    size = np.concatenate([ow, oh, ow, oh], 1)[pick]
    boxes = obj[pick] + rng.randn(n, 4) * 0.1 * size
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    return boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def detection_ops(torch, np, dev):
    from paddle_tpu_torch.vision import ops
    rng = np.random.RandomState(SEED)
    out = {}
    m = MASKRCNN
    x = rng.randn(*m["x"]).astype(np.float32)
    n_img = m["x"][0]
    boxes = rois(np, rng, n_img, m["boxes"], m["image"], m["box_side"])
    mask_boxes = rois(np, rng, n_img, m["mask_boxes"], m["image"],
                      m["box_side"])
    for name, fn, b, size in (
            ("roi_align_7x7", ops.roi_align, boxes, 7),
            ("roi_align_14x14", ops.roi_align, mask_boxes, 14),
            ("roi_pool_7x7", ops.roi_pool, boxes, 7)):
        per = b.shape[0] // n_img
        out[name] = detection_compare(
            torch, np, dev, name,
            lambda x, boxes, fn=fn, size=size, per=per: fn(
                x, boxes, [per] * n_img, size, m["scale"]),
            {"x": x, "boxes": b}, ("x",), SEED + len(out))
        out[name]["shape"] = {"x": list(m["x"]), "boxes": int(b.shape[0]),
                              "output": size}
    r = RFCN
    xr = rng.randn(*r["x"]).astype(np.float32)
    br = rois(np, rng, r["x"][0], r["boxes"], r["image"], (32, 400))
    out["psroi_pool"] = detection_compare(
        torch, np, dev, "psroi_pool",
        lambda x, boxes: ops.psroi_pool(x, boxes, [r["boxes"]] * r["x"][0],
                                        r["out"], r["scale"]),
        {"x": xr, "boxes": br}, ("x",), SEED + 7)
    out["psroi_pool"]["shape"] = {"x": list(r["x"]),
                                  "boxes": int(br.shape[0]),
                                  "output": r["out"]}
    out.update(detection_nms(torch, np, dev, rng))
    out.update(detection_yolo(torch, np, dev, rng))
    d = DCN
    n, c, h, w = d["x"]
    out["deform_conv2d_v2"] = detection_compare(
        torch, np, dev, "deform_conv2d_v2",
        lambda x, offset, weight, mask: ops.deform_conv2d(
            x, offset, weight, None, 1, 1, 1, mask=mask),
        {"x": rng.randn(n, c, h, w).astype(np.float32),
         "offset": (rng.randn(n, 18, h, w) * 2).astype(np.float32),
         "weight": (rng.randn(d["out"], c, 3, 3) / np.sqrt(c * 9)).astype(
             np.float32),
         "mask": rng.uniform(0, 1, (n, 9, h, w)).astype(np.float32)},
        ("x", "offset", "weight", "mask"), SEED + 9)
    out["deform_conv2d_v2"]["shape"] = {"x": list(d["x"]), "out": d["out"],
                                        "kernel": 3}
    for name, r in out.items():
        log(f"c2h (3) {name}: {json.dumps(r)}")
    return out


def detection_nms(torch, np, dev, rng):
    """(3) nms: the card's kept indices equal the CPU's; host-clock ms of
    the call (it ends in the kept mask's readback)."""
    from paddle_tpu_torch.vision import ops
    out = {}
    b, s = nms_boxes(np, rng, NMS_RPN["boxes"], MASKRCNN["image"], 150)
    b2, s2 = nms_boxes(np, rng, NMS_DET["boxes"], MASKRCNN["image"], 60)
    cats = rng.randint(0, NMS_DET["classes"], NMS_DET["boxes"])
    cases = {
        "nms_rpn": (b, dict(iou_threshold=NMS_RPN["iou"], scores=s)),
        "nms_detections": (b2, dict(
            iou_threshold=NMS_DET["iou"], scores=s2, category_idxs=cats,
            categories=list(range(NMS_DET["classes"])),
            top_k=NMS_DET["top_k"]))}
    for name, (boxes, kw) in cases.items():
        def call(device):
            args = {k: (torch.from_numpy(v).to(device)
                        if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()}
            return ops.nms(torch.from_numpy(boxes).to(device), **args)
        cpu = call("cpu")
        card = call(dev)
        require(card.device.type == "cuda" and card.dtype == torch.int64,
                f"c2h (3) {name}: indices {card.dtype} on {card.device}")
        require(torch.equal(card.cpu(), cpu),
                f"c2h (3) {name}: the card kept {card.tolist()[:20]}... "
                f"({card.numel()}), the CPU {cpu.tolist()[:20]}... "
                f"({cpu.numel()})")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"boxes": int(boxes.shape[0]), "kept": int(cpu.numel()),
                     "ms": statistics.median(times), "exact": True,
                     **{k: v for k, v in kw.items()
                        if k in ("iou_threshold", "top_k")}}
    return out


def detection_yolo(torch, np, dev, rng):
    """(3) yolo_box and yolo_loss on YOLOv3's three heads at 608 x 608."""
    from paddle_tpu_torch.vision import ops
    y = YOLO
    n, cls = y["N"], y["classes"]
    gt = np.zeros((n, y["gt"], 4), np.float32)
    k = y["real"]
    gt[:, :k, :2] = rng.uniform(0.05, 0.95, (n, k, 2))
    gt[:, :k, 2:] = rng.uniform(0.02, 0.6, (n, k, 2))
    labels = np.zeros((n, y["gt"]), np.int64)
    labels[:, :k] = rng.randint(0, cls, (n, k))
    img = np.full((n, 2), y["img"], np.float32)
    out = {}
    for grid, mask, stride in YOLO_HEADS:
        x = (rng.randn(n, 3 * (5 + cls), grid, grid) * 0.5).astype(
            np.float32)
        anchors = [v for i in mask for v in YOLO_ANCHORS[2 * i:2 * i + 2]]
        for part in (0, 1):
            out[f"yolo_box_{grid}_{'boxes' if part == 0 else 'scores'}"] = \
                detection_compare(
                    torch, np, dev, f"yolo_box {grid}",
                    lambda x, img, part=part, anchors=anchors, stride=stride:
                    ops.yolo_box(x, img, anchors, cls, y["conf"], stride)[
                        part], {"x": x, "img": img}, ("x",), SEED + grid)
        out[f"yolo_loss_{grid}"] = detection_compare(
            torch, np, dev, f"yolo_loss {grid}",
            lambda x, gt, labels, mask=mask, stride=stride: ops.yolo_loss(
                x, gt, labels, YOLO_ANCHORS, mask, cls, y["ignore"], stride),
            {"x": x, "gt": gt, "labels": labels}, ("x",), SEED + grid + 1)
        out[f"yolo_loss_{grid}"]["shape"] = {"x": [n, 3 * (5 + cls), grid,
                                                   grid], "gt": y["gt"],
                                             "real": k}
    return out


def vision_zoo(torch, np, dev, _kernels):
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    check = zoo_card_vs_cpu(torch, np, dev)
    t_check = time.perf_counter() - t_phase
    timed = zoo_timed(torch, np, dev)
    t_timed = time.perf_counter() - t_phase - t_check
    detection = detection_ops(torch, np, dev)
    launches = dict(_kernels.launches)
    require(not any(launches.values()),
            f"c2h launched a kernel of the port: {launches}")
    log(json.dumps({"vision_zoo": {
        "card_vs_cpu": check, "timed": {
            "B": 128, "amp": "O1", "dtype": "bfloat16",
            "optimizer": "Momentum(0.1, 0.9, weight_decay=1e-4)",
            "mfu_peak": "989 TFLOP/s bf16 dense",
            "flops": "hapi.flops of the model at one image (2 a "
                     "multiply-add; grouped convolutions at Cin/groups)",
            **timed},
        "detection": detection, "launches": launches,
        "phase_s": time.perf_counter() - t_phase,
        "parts_s": {"card_vs_cpu": t_check, "timed": t_timed,
                    "detection": time.perf_counter() - t_phase - t_check
                    - t_timed}}}))


# ---------------------------------------------------------------------------
# (c2i) recurrent layers, CTC and the rest of nn
# ---------------------------------------------------------------------------
# Zaremba et al. 2014 (arXiv:1409.2329), the PTB word-level LSTM language
# model, "medium" and "large": 2 layers, 35 unrolled steps, B=20, SGD lr 1
# with the gradient's global norm clipped, weights uniform in +-init
PTB = {"medium": {"H": 650, "p": 0.5, "init": 0.05, "clip": 5.0},
       "large": {"H": 1500, "p": 0.65, "init": 0.04, "clip": 10.0}}
PTB_VOCAB, PTB_B, PTB_T = 10000, 20, 35
# a DeepSpeech2-shaped stack (Amodei et al. 2016, arXiv:1512.02595) without
# its convolutional front end: 3 bidirectional GRU layers over 161-bin
# spectrogram frames, 28 characters + the CTC blank; (1) checks at a cut
# batch and length, full widths
DS2 = {"B": 16, "frames": (200, 400), "labels": (40, 100), "H": 1024,
       "layers": 3, "feat": 161, "chars": 29}
DS2_CHECK = {"B": 4, "frames": (40, 80), "labels": (10, 20)}
# DCGAN at 64 x 64 (Radford et al. 2016, arXiv:1511.06434) with the
# reference implementation's widths; Adam(2e-4, beta1 0.5)
DCGAN = {"B": 128, "nz": 100, "ngf": 64, "ndf": 64, "nc": 3}
DS2_WARMUP, DS2_TIMED = 1, 3   # a step takes seconds (the loop's launches)
DCGAN_CHECK_B = 4
C2I_PROFILED = 2


def wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host wall ms of ``fn()`` to a synchronize, after one warm
    call: what a launch-bound loop costs its caller."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_steps(torch, step, n=C2I_PROFILED):
    """``n`` calls of ``step`` under torch.profiler, tracing the device
    only (the host's operator events of a DeepSpeech2 step, 145,000
    kernels, take the profiler a minute to process): device kernels (and
    memsets / copies) a call, device-busy ms a call (the union of their
    intervals) and the device's idle share of the profiled wall time."""
    from paddle_tpu_torch.profile_serving import _union_us
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels]) / 1e3
    return {"kernels_per_step": len(kernels) / n,
            "device_busy_ms_per_step": busy / n,
            "profiled_ms_per_step": wall / n,
            "device_idle_share": 1.0 - busy / wall if kernels else None}


def c2i_runs(torch, dev, one_run):
    """``one_run(device, dtype)`` (a dict of tensors) on the card and the
    CPU in float32 and float64, as float64 CPU tensors: the runs of
    :func:`gate_runs`."""
    runs = {}
    for tag, device, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64),
                               ("card64", dev, torch.float64)):
        runs[tag] = {k: v.detach().double().cpu()
                     for k, v in one_run(device, dtype).items()}
    return runs


def c2i_gate(torch, dev, name, one_run):
    """(c2i 1-3): c2h's float64 gate over ``one_run``; the float32
    forward within c2f's bound, the float32 gradients reported."""
    worst, table, over, gate64 = gate_runs(
        c2i_runs(torch, dev, one_run), name, "c2i", True,
        reported=("grad ",))
    return {"float64_worst_err_over_bound": gate64,
            "float32_forward_worst_err_over_bound": worst,
            "float32_grads_over_bound": len(over),
            "float32_grads_worst": over[:3], "worst_relative": table}


def ptb_tokens(np, n):
    """A seeded stream of n PTB-vocabulary ids: Zipf-distributed, and half
    of the ids follow their predecessor by a fixed map (something for the
    LSTM to learn)."""
    rng = np.random.RandomState(SEED)
    zipf = 1.0 / np.arange(1, PTB_VOCAB + 1)
    toks = rng.choice(PTB_VOCAB, n, p=zipf / zipf.sum())
    follow = rng.rand(n) < 0.5
    for i in range(1, n):
        if follow[i]:
            toks[i] = (toks[i - 1] * 7 + 3) % PTB_VOCAB
    return toks


def ptb_model(torch, cfg, device, p):
    """Embedding(10000, H) -> dropout -> LSTM(H, H, 2 layers, dropout p)
    -> dropout -> Linear(H, 10000), every weight uniform in +-init from a
    seeded generator."""
    from paddle_tpu_torch import nn as tnn

    class PTBLanguageModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            h = cfg["H"]
            self.embedding = tnn.Embedding(PTB_VOCAB, h, device=device)
            self.lstm = tnn.LSTM(h, h, num_layers=2, dropout=p,
                                 device=device)
            self.drop = tnn.Dropout(p)
            self.head = tnn.Linear(h, PTB_VOCAB, device=device)

        def forward(self, ids, state):
            out, state = self.lstm(self.drop(self.embedding(ids)), state)
            return self.head(self.drop(out)), state
    model = PTBLanguageModel()
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        for w in model.parameters():
            w.uniform_(-cfg["init"], cfg["init"], generator=gen)
    return model


def ptb_check(torch, np, dev):
    """(c2i 1) the medium model's step at p=0: loss, logits, every
    gradient and the carried (h, c), card against CPU."""
    import copy
    from paddle_tpu_torch.nn import functional as F
    cfg = PTB["medium"]
    base = ptb_model(torch, cfg, "cpu", 0.0)
    toks = ptb_tokens(np, PTB_B * (PTB_T + 1))
    data = toks.reshape(PTB_B, PTB_T + 1)
    rng = np.random.RandomState(SEED + 1)
    h0 = rng.randn(2, PTB_B, cfg["H"]) * 0.1
    c0 = rng.randn(2, PTB_B, cfg["H"]) * 0.1

    def one_run(device, dtype):
        m = copy.deepcopy(base).to(device, dtype)
        ids = torch.from_numpy(data[:, :-1]).to(device)
        labels = torch.from_numpy(data[:, 1:]).to(device)
        state = (torch.from_numpy(h0).to(device, dtype),
                 torch.from_numpy(c0).to(device, dtype))
        logits, (h, c) = m(ids, state)
        loss = F.cross_entropy(logits.reshape(-1, PTB_VOCAB),
                               labels.reshape(-1))
        loss.backward()
        return {"loss": loss.reshape(1), "logits": logits, "h": h, "c": c,
                **{f"grad {k}": w.grad for k, w in m.named_parameters()}}
    return c2i_gate(torch, dev, "ptb medium", one_run)


def ptb_timed(torch, np, dev, size):
    """(c2i 1) WARMUP_STEPS + TIMED_STEPS truncated-BPTT steps at the
    published dropout, the state carried and detached; then the LSTM
    stack's forward and backward alone, the port's loop against cuDNN's
    (``torch.nn.LSTM``, the ``torch._VF.lstm`` route) on the same input."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD, ClipGradByGlobalNorm
    cfg = PTB[size]
    model = ptb_model(torch, cfg, dev, cfg["p"])
    model.train()
    opt = SGD(learning_rate=1.0, parameters=model.named_parameters(),
              grad_clip=ClipGradByGlobalNorm(cfg["clip"]))
    steps = WARMUP_STEPS + TIMED_STEPS + C2I_PROFILED
    data = torch.from_numpy(ptb_tokens(np, PTB_B * (steps * PTB_T + 1))
                            ).to(dev)
    n = PTB_B * steps * PTB_T
    ids_all = data[:n].reshape(PTB_B, -1)
    lab_all = data[1:n + 1].reshape(PTB_B, -1)
    z = torch.zeros(2, PTB_B, cfg["H"], device=dev)
    carried = [(z, z)]
    cursor = [0]

    def step():
        i = cursor[0]
        cursor[0] += 1
        sl = slice(i * PTB_T, (i + 1) * PTB_T)
        logits, state = model(ids_all[:, sl], carried[0])
        loss = F.cross_entropy(logits.reshape(-1, PTB_VOCAB),
                               lab_all[:, sl].reshape(-1))
        opt.clear_grad()
        loss.backward()
        opt.step()
        carried[0] = tuple(s.detach() for s in state)
        return loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step().detach()))
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profile_steps(torch, step)
    require(all(np.isfinite(losses)), f"c2i (1) {size}: losses {losses}")
    timed = losses[WARMUP_STEPS:]
    require(timed[-1] < timed[0], f"c2i (1) {size}: the loss did not fall "
            f"over the timed steps: {timed}")
    p50 = statistics.median(times[WARMUP_STEPS:])
    # the two-layer LSTM alone, forward and backward at the step's shape
    h = cfg["H"]
    x = torch.randn(PTB_B, PTB_T, h, device=dev, requires_grad=True)
    lib = torch.nn.LSTM(h, h, num_layers=2, dropout=cfg["p"],
                        batch_first=True).to(dev)

    def port_lstm():
        out, _ = model.lstm(x)
        out.sum().backward()

    def cudnn_lstm():
        out, _ = lib(x)
        out.sum().backward()
    line = {"H": h, "dropout": cfg["p"], "B": PTB_B, "T": PTB_T,
            "clip": cfg["clip"], "step_ms_p50": p50,
            "step_ms": times[WARMUP_STEPS:],
            "words_per_s": PTB_B * PTB_T / (p50 / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss_first": timed[0], "loss_last": timed[-1], "losses": losses,
            **prof,
            "lstm_fwd_bwd_ms": wall_ms(torch, port_lstm),
            "cudnn_lstm_fwd_bwd_ms": wall_ms(torch, cudnn_lstm)}
    log(f"c2i (1) PTB {size} (H={h}, p={cfg['p']}): step p50 "
        f"{p50:.2f} ms, {line['words_per_s']:.0f} words/s, "
        f"{prof['kernels_per_step']:.0f} kernels a step, device idle "
        f"{prof['device_idle_share']:.3f}, peak {line['peak_memory_gb']:.2f}"
        f" GB, loss {timed[0]:.4f} -> {timed[-1]:.4f}; the LSTM alone "
        f"{line['lstm_fwd_bwd_ms']:.2f} ms, cuDNN's "
        f"{line['cudnn_lstm_fwd_bwd_ms']:.2f} ms")
    return line


def ds2_model(torch, device):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn import functional as F

    class DeepSpeech2Rnn(torch.nn.Module):
        """3 bidirectional GRU layers over spectrogram frames, then
        Linear(2H, 29) and log_softmax; the convolutional front end is
        cut."""

        def __init__(self):
            super().__init__()
            self.rnn = tnn.GRU(DS2["feat"], DS2["H"],
                               num_layers=DS2["layers"],
                               direction="bidirect", device=device)
            self.head = tnn.Linear(2 * DS2["H"], DS2["chars"], device=device)

        def forward(self, feats, lengths):
            out, _ = self.rnn(feats, sequence_length=lengths)
            return F.log_softmax(self.head(out), axis=-1)
    fw_random_seed(SEED)
    return DeepSpeech2Rnn()


def fw_random_seed(value):
    from paddle_tpu_torch.framework import random as fw_random
    fw_random.seed(value)


def ds2_data(np, b, frames, labels):
    """Seeded features (B, T, 161) with ragged frame counts (the longest
    row at the top of ``frames``) and 1..28 labels of ragged lengths."""
    rng = np.random.RandomState(SEED + 2)
    lengths = rng.randint(frames[0], frames[1] + 1, b)
    lengths[0] = frames[1]
    feats = rng.randn(b, frames[1], DS2["feat"]).astype(np.float32)
    lab_len = rng.randint(labels[0], labels[1] + 1, b)
    lab = rng.randint(1, DS2["chars"], (b, labels[1]))
    return feats, lengths, lab, lab_len


def ds2_loss(torch, model, feats, lengths, lab, lab_len):
    from paddle_tpu_torch.nn import functional as F
    log_probs = model(feats, lengths).transpose(0, 1)
    return F.ctc_loss(log_probs, lab, lengths, lab_len), log_probs


def ds2_check(torch, np, dev):
    """(c2i 2) at the cut batch and length: the loss, the log-probs and
    the gradients with respect to every weight, the features and the
    log-probs, card against CPU."""
    import copy
    base = ds2_model(torch, "cpu")
    arrays = ds2_data(np, DS2_CHECK["B"], DS2_CHECK["frames"],
                      DS2_CHECK["labels"])

    def one_run(device, dtype):
        m = copy.deepcopy(base).to(device, dtype)
        feats, lengths, lab, lab_len = [torch.from_numpy(a).to(device)
                                        for a in arrays]
        feats = feats.to(dtype).requires_grad_()
        loss, log_probs = ds2_loss(torch, m, feats, lengths, lab, lab_len)
        log_probs.retain_grad()
        loss.backward()
        return {"loss": loss.reshape(1), "log_probs": log_probs,
                "grad log_probs": log_probs.grad, "grad features": feats.grad,
                **{f"grad {k}": w.grad for k, w in m.named_parameters()}}
    return c2i_gate(torch, dev, "deepspeech2", one_run)


def ds2_timed(torch, np, dev):
    """(c2i 2) DS2_WARMUP + DS2_TIMED steps at B=16, 200-400 frames: step
    ms p50 and kernels a step; the port's ctc_loss forward and backward
    against torch's on the step's log-probs."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, Momentum
    model = ds2_model(torch, dev)
    opt = Momentum(learning_rate=5e-4, momentum=0.99, use_nesterov=True,
                   parameters=model.named_parameters(),
                   grad_clip=ClipGradByGlobalNorm(400.0))
    feats, lengths, lab, lab_len = [torch.from_numpy(a).to(dev) for a in
                                    ds2_data(np, DS2["B"], DS2["frames"],
                                             DS2["labels"])]

    def step():
        loss, _ = ds2_loss(torch, model, feats, lengths, lab, lab_len)
        opt.clear_grad()
        loss.backward()
        opt.step()
        return loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(DS2_WARMUP + DS2_TIMED):
        t0 = time.perf_counter()
        losses.append(float(step().detach()))
        times.append((time.perf_counter() - t0) * 1e3)
    require(all(np.isfinite(losses)), f"c2i (2): losses {losses}")
    prof = profile_steps(torch, step, 1)
    with torch.no_grad():
        lp = model(feats, lengths).transpose(0, 1).contiguous()
    lp.requires_grad_()

    def port_ctc():
        F.ctc_loss(lp, lab, lengths, lab_len).backward()

    def torch_ctc():
        torch.nn.functional.ctc_loss(lp, lab, lengths, lab_len).backward()
    with torch.no_grad():
        port_v = float(F.ctc_loss(lp, lab, lengths, lab_len))
        lib_v = float(torch.nn.functional.ctc_loss(lp, lab, lengths,
                                                   lab_len))
    require(abs(port_v - lib_v) <= 1e-4 * abs(lib_v), f"c2i (2): ctc_loss "
            f"{port_v} against torch's {lib_v}")
    p50 = statistics.median(times[DS2_WARMUP:])
    line = {"B": DS2["B"], "frames": list(DS2["frames"]),
            "label_lengths": list(DS2["labels"]), "H": DS2["H"],
            "step_ms_p50": p50, "step_ms": times[DS2_WARMUP:],
            "frames_per_s": float(lengths.sum()) / (p50 / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses, **prof,
            "ctc_loss": port_v, "ctc_loss_torch": lib_v,
            "ctc_fwd_bwd_ms": wall_ms(torch, port_ctc),
            "ctc_torch_fwd_bwd_ms": wall_ms(torch, torch_ctc)}
    log(f"c2i (2) DeepSpeech2-shaped B={DS2['B']}: step p50 {p50:.2f} ms, "
        f"{prof['kernels_per_step']:.0f} kernels a step, device idle "
        f"{prof['device_idle_share']:.3f}, peak "
        f"{line['peak_memory_gb']:.2f} GB; ctc_loss {line['ctc_fwd_bwd_ms']:.2f}"
        f" ms forward and backward, torch's {line['ctc_torch_fwd_bwd_ms']:.2f}"
        f" ms (loss {port_v:.6f} vs {lib_v:.6f})")
    return line


def dcgan_models(torch, device, sn):
    """The DCGAN generator and discriminator at 64 x 64 from the port's
    layers, weights N(0, 0.02) (BatchNorm scales N(1, 0.02)) from a
    seeded generator; ``sn`` wraps D's convolutions in spectral_norm."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn.utils import spectral_norm
    nz, g, d, nc = DCGAN["nz"], DCGAN["ngf"], DCGAN["ndf"], DCGAN["nc"]

    def up(i, o, s, p, last=False):
        conv = tnn.Conv2DTranspose(i, o, 4, s, p, bias_attr=False,
                                   device=device)
        return [conv, tnn.Tanh()] if last else [
            conv, tnn.BatchNorm2D(o, device=device), tnn.ReLU()]

    def down(i, o, bn=True):
        conv = tnn.Conv2D(i, o, 4, 2, 1, bias_attr=False, device=device)
        return [conv] + ([tnn.BatchNorm2D(o, device=device)] if bn else []) \
            + [tnn.LeakyReLU(0.2)]
    fw_random_seed(SEED)
    G = tnn.Sequential(*up(nz, g * 8, 1, 0), *up(g * 8, g * 4, 2, 1),
                       *up(g * 4, g * 2, 2, 1), *up(g * 2, g, 2, 1),
                       *up(g, nc, 2, 1, last=True))
    D = tnn.Sequential(*down(nc, d, bn=False), *down(d, d * 2),
                       *down(d * 2, d * 4), *down(d * 4, d * 8),
                       tnn.Conv2D(d * 8, 1, 4, 1, 0, bias_attr=False,
                                  device=device), tnn.Sigmoid())
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        for name, w in list(G.named_parameters()) + list(
                D.named_parameters()):
            if w.dim() == 4:
                w.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("weight"):
                w.normal_(1.0, 0.02, generator=gen)
    if sn:
        for m in D:
            if isinstance(m, tnn.Conv2D):
                spectral_norm(m)
    return G, D


def gan_losses(torch, G, D, real, z):
    """D's loss on real and detached fake images, then G's through D."""
    from paddle_tpu_torch import nn as tnn
    bce = tnn.BCELoss()
    b = real.shape[0]
    ones = torch.ones(b, dtype=real.dtype, device=real.device)
    fake = G(z)
    d_real = D(real).reshape(-1)
    d_fake = D(fake.detach()).reshape(-1)
    err_d = bce(d_real, ones) + bce(d_fake, torch.zeros_like(ones))
    return fake, d_real, d_fake, err_d, lambda: bce(D(fake).reshape(-1),
                                                    ones)


def dcgan_check(torch, np, dev, sn):
    """(c2i 3) at B=4: the fake images, D's outputs and both losses, D's
    gradients from its loss and G's from its own, card against CPU."""
    import copy
    G0, D0 = dcgan_models(torch, "cpu", sn)
    rng = np.random.RandomState(SEED + 3)
    real = rng.uniform(-1, 1, (DCGAN_CHECK_B, DCGAN["nc"], 64, 64))
    z = rng.randn(DCGAN_CHECK_B, DCGAN["nz"], 1, 1)

    def one_run(device, dtype):
        G = copy.deepcopy(G0).to(device, dtype)
        D = copy.deepcopy(D0).to(device, dtype)
        fake, d_real, d_fake, err_d, g_loss = gan_losses(
            torch, G, D, torch.from_numpy(real).to(device, dtype),
            torch.from_numpy(z).to(device, dtype))
        err_d.backward()
        out = {"fake": fake, "d_real": d_real, "d_fake": d_fake,
               "err_d": err_d.reshape(1),
               **{f"grad D.{k}": w.grad.clone()
                  for k, w in D.named_parameters()}}
        D.zero_grad()
        err_g = g_loss()
        err_g.backward()
        out["err_g"] = err_g.reshape(1)
        out.update({f"grad G.{k}": w.grad for k, w in G.named_parameters()})
        return out
    return c2i_gate(torch, dev, "dcgan" + ("_sn" if sn else ""), one_run)


def dcgan_timed(torch, np, dev, sn):
    from paddle_tpu_torch.optimizer import Adam
    G, D = dcgan_models(torch, dev, sn)
    opt_g = Adam(learning_rate=2e-4, beta1=0.5,
                 parameters=G.named_parameters())
    opt_d = Adam(learning_rate=2e-4, beta1=0.5,
                 parameters=D.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b = DCGAN["B"]
    real = torch.rand(b, DCGAN["nc"], 64, 64, generator=gen,
                      device=dev) * 2 - 1

    def step():
        z = torch.randn(b, DCGAN["nz"], 1, 1, generator=gen, device=dev)
        _, _, _, err_d, g_loss = gan_losses(torch, G, D, real, z)
        opt_d.clear_grad()
        err_d.backward()
        opt_d.step()
        err_g = g_loss()
        opt_g.clear_grad()
        err_g.backward()
        opt_g.step()
        return err_d, err_g
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        err_d, err_g = step()
        losses.append((float(err_d.detach()), float(err_g.detach())))
        times.append((time.perf_counter() - t0) * 1e3)
    require(bool(np.isfinite(losses).all()), f"c2i (3): losses {losses}")
    p50 = statistics.median(times[WARMUP_STEPS:])
    prof = profile_steps(torch, step, 1)
    line = {"B": b, "spectral_norm": sn, "step_ms_p50": p50,
            "step_ms": times[WARMUP_STEPS:],
            "img_per_s": b / (p50 / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses_d_g": losses, **prof}
    log(f"c2i (3) DCGAN{' + spectral_norm' if sn else ''} B={b}: D + G "
        f"step p50 {p50:.2f} ms, {line['img_per_s']:.0f} img/s, device "
        f"idle {prof['device_idle_share']:.3f}, peak "
        f"{line['peak_memory_gb']:.2f} GB")
    return line


def c2i_case_run(torch, np, case, layer, device, dtype, built=None):
    """One case of ``testing/nn_cases`` on ``device`` in ``dtype``: its
    outputs and the gradients of sum(out[0] * ct) by its float inputs
    (and a layer's parameters), as float64 / int64 CPU tensors."""
    import copy
    from paddle_tpu_torch.nn import functional as F

    def conv(a):
        if isinstance(a, (np.ndarray, np.generic)):
            t = torch.from_numpy(np.array(a)).to(device)
            return t.to(dtype) if t.is_floating_point() else t
        return a
    if layer:
        mod = copy.deepcopy(built).to(device, dtype)
        args = [conv(a) for a in case.inputs]
        kw = dict(case.call)
        fn = mod
    else:
        args = [conv(a) for a in case.args]
        kw = {k: conv(v) if isinstance(v, np.ndarray) else v
              for k, v in case.kwargs.items()}
        fn = getattr(F, case.fn)
    for i in case.grad:
        args[i].requires_grad_()
    out = fn(*args, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    res = {f"out {i}": o.detach() for i, o in enumerate(outs)}
    if case.grad:
        ct = np.asarray(np.random.RandomState(99).randn(*outs[0].shape))
        (outs[0] * torch.from_numpy(ct).to(device, outs[0].dtype)
         ).sum().backward()
        res.update({f"grad input {i}": args[i].grad for i in case.grad})
        if layer:
            res.update({f"grad {k}": w.grad
                        for k, w in mod.named_parameters()})
    return {k: (v.double() if v.is_floating_point() else v).cpu()
            for k, v in res.items()}


def nn_cases_on_card(torch, np, dev):
    """(c2i 4) every case of the CPU parity tests' tables on the card in
    float32 against the CPU's float64: each value and gradient within 4 x
    the CPU float32 run's distance from float64 plus 1e-6 of its range
    (c2g (1)'s rule), integer outputs exact.  Every miss is collected
    before the phase fails."""
    import inspect
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.testing.nn_cases import (functional_cases,
                                                   layer_cases)
    worst, misses, n = {}, [], 0
    tables = [(c, False, None) for c in functional_cases()]
    for c in layer_cases():
        cls = getattr(tnn, c.cls)
        kw = dict(c.kwargs)
        if "device" in inspect.signature(cls.__init__).parameters:
            kw["device"] = "cpu"
        fw_random_seed(SEED)
        tables.append((c, True, cls(*c.args, **kw)))
    for case, layer, built in tables:
        runs = {tag: c2i_case_run(torch, np, case, layer, d, t, built)
                for tag, d, t in (("card", dev, torch.float32),
                                  ("cpu", "cpu", torch.float32),
                                  ("cpu64", "cpu", torch.float64))}
        ratio = 0.0
        for k, ref in runs["cpu64"].items():
            got = runs["card"][k]
            n += 1
            if not ref.is_floating_point():
                if not torch.equal(got, ref):
                    misses.append((case.name, k, "integer output differs"))
                continue
            if got.numel() == 0:
                continue
            scale = float(ref.abs().max())
            own = float((runs["cpu"][k] - ref).abs().max())
            err = float((got - ref).abs().max())
            bound = 4.0 * own + 1e-6 * scale + 1e-30
            if not err <= bound:
                misses.append((case.name, k, err, own, scale))
            ratio = max(ratio, err / bound)
        worst[case.name] = ratio
    misses.sort(key=lambda m: str(m))
    for m in misses:
        log(f"c2i (4) miss: {m}")
    require(not misses, f"c2i (4): {len(misses)} of {n} tensors outside "
            f"c2g (1)'s bound: {misses[:8]}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
    log(f"c2i (4) {len(tables)} cases, {n} tensors on the card within "
        f"c2g (1)'s bound; the closest {top}")
    return {"cases": len(tables), "tensors": n, "closest": top}


def random_ops_on_card(torch, dev):
    """(c2i 4) the random ops on the card by their statistics, as the CPU
    tests hold them: channel dropout's whole channels and keep rate, alpha
    dropout's dropped value, rate and moments, gumbel-softmax's one-hot
    rows and frequencies."""
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = 0.3
    x = torch.rand(64, 64, 3, 2, generator=gen, device=dev) + 0.5
    flat = F.dropout2d(x, p=p, generator=gen).reshape(64, 64, -1)
    dropped = (flat == 0).all(-1)
    kept = torch.isclose(flat, x.reshape_as(flat) / (1 - p)).all(-1)
    rate = float(kept.float().mean())
    require(bool((dropped | kept).all()) and abs(rate - 0.7) < 4 * (
        0.21 / 4096) ** 0.5, f"c2i (4) dropout2d: keep rate {rate}")
    q = 0.2
    neg = -1.6732632423543772 * 1.0507009873554805
    a = (1 - q + q * neg ** 2) ** -0.5
    y = F.alpha_dropout(torch.randn(400_000, generator=gen, device=dev),
                        p=q, generator=gen)
    drop_rate = float(torch.isclose(y, torch.tensor(
        a * neg - a * q * neg, device=dev)).float().mean())
    mean, var = float(y.mean()), float(y.var())
    require(abs(drop_rate - q) < 0.005 and abs(mean) < 0.01
            and abs(var - (1 - (q * neg * a) ** 2)) < 0.01,
            f"c2i (4) alpha_dropout: rate {drop_rate}, mean {mean}, "
            f"var {var}")
    probs = torch.tensor([0.6, 0.3, 0.1], device=dev)
    g = F.gumbel_softmax(probs.log().expand(20000, 3).contiguous(),
                         hard=True, generator=gen)
    onehot = torch.nn.functional.one_hot(g.argmax(-1), 3).float()
    freq = onehot.mean(0)
    require(float((g - onehot).abs().max()) <= 1e-6
            and float((freq - probs).abs().max()) < 0.015,
            f"c2i (4) gumbel_softmax: frequencies {freq.tolist()}")
    return {"dropout2d_keep_rate": rate, "alpha_dropout": {
        "drop_rate": drop_rate, "mean": mean, "var": var},
        "gumbel_frequencies": freq.tolist()}


def nn_rest(torch, np, dev, _kernels):
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    parts, line = {}, {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t0
        log(f"c2i {name}: {parts[name]:.1f} s")
        torch.cuda.empty_cache()
        return out
    line["ptb_check"] = part("ptb_check", lambda: ptb_check(torch, np, dev))
    log(f"c2i (1) PTB medium card vs CPU: {json.dumps(line['ptb_check'])}")
    line["ptb"] = {size: part(f"ptb_{size}", lambda size=size: ptb_timed(
        torch, np, dev, size)) for size in PTB}
    line["deepspeech2_check"] = part(
        "deepspeech2_check", lambda: ds2_check(torch, np, dev))
    log(f"c2i (2) DeepSpeech2-shaped card vs CPU: "
        f"{json.dumps(line['deepspeech2_check'])}")
    line["deepspeech2"] = part("deepspeech2",
                               lambda: ds2_timed(torch, np, dev))
    for sn in (False, True):
        key = "dcgan_sn" if sn else "dcgan"
        line[f"{key}_check"] = part(f"{key}_check", lambda sn=sn: dcgan_check(
            torch, np, dev, sn))
        log(f"c2i (3) {key} card vs CPU: {json.dumps(line[f'{key}_check'])}")
        line[key] = part(key, lambda sn=sn: dcgan_timed(torch, np, dev, sn))
    line["cases"] = part("cases", lambda: nn_cases_on_card(torch, np, dev))
    line["random_ops"] = part("random_ops",
                              lambda: random_ops_on_card(torch, dev))
    launches = dict(_kernels.launches)
    require(not any(launches.values()),
            f"c2i launched a kernel of the port: {launches}")
    line.update({"launches": launches, "parts_s": parts,
                 "phase_s": time.perf_counter() - t_phase})
    log(json.dumps({"nn_rest": line}))
    return line


# ---------------------------------------------------------------------------
# (c2j) the paddle tensor API
# ---------------------------------------------------------------------------
# DeepSpeech2's linear spectrogram (Amodei et al. 2016, arXiv:1512.02595:
# 20 ms windows, 10 ms hop at 16 kHz) over 4 s utterances: the c2i DS2
# stack's 161 bins and longest input
C2J_AUDIO = {"B": 16, "samples": 64_000, "n_fft": 320, "hop": 160}
C2J_LINALG_N = 2048                 # GPT-3 1.3B's hidden width
C2J_OPS_SHAPE = (8, 2048, 768)      # GPT-125M's activations, B=8, S=2048
C2J_LINALG_TOL = C2J_LINALG_N * 2.0 ** -23   # n x float32 eps (gamma_n)


def _c2j_ratio(np, got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|) (numpy's allclose rule; 1 is
    the entry's limit), by element; shapes must agree."""
    if isinstance(want, list):
        return max(_c2j_ratio(np, g, w, rtol, atol)
                   for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    require(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    if want.size == 0:
        return 0.0
    g = got.astype(np.complex128 if np.iscomplexobj(got) else np.float64)
    w = want.astype(np.complex128 if np.iscomplexobj(want) else np.float64)
    both_nan = np.isnan(np.abs(g)) & np.isnan(np.abs(w))
    same_inf = np.isinf(np.abs(w)) & (g == w)
    err = np.where(both_nan | same_inf, 0.0, np.abs(g - w))
    lim = atol + rtol * np.where(np.isfinite(np.abs(w)), np.abs(w), 0.0)
    return float(np.nanmax(np.where(np.isnan(err), np.inf, err / lim)))


def c2j_registry(torch, np, dev):
    """(c2j 1) every entry of the op registry on the card in float32
    against the port's CPU float64 run and the numpy reference, at the
    entry's rtol / atol; the gradient of sum(fn) by every grad_wrt argument
    by autograd on the card against the CPU float64 one at grad_rtol /
    grad_atol; the bf16 sweep on the card (within 0.1 of the output's
    scale of the card's float32 result).  Every miss is collected before
    the phase fails."""
    from paddle_tpu_torch.ops.spec import registry, run

    specs = registry()
    misses, skipped, worst = [], [], {}
    n_out = n_grad = n_bf16 = 0
    for spec in specs:
        name = spec.name
        try:
            args = spec.sample(np.random.RandomState(0))
            card = run(spec, args, dev, torch.float32)
            cpu64 = run(spec, args, "cpu", torch.float64)
            ref = np.asarray(spec.ref(*[np.asarray(a) for a in args]))
            r = max(_c2j_ratio(np, card, cpu64, spec.rtol, spec.atol),
                    _c2j_ratio(np, card, ref, spec.rtol, spec.atol))
            worst[name] = r
            n_out += 1
            if not r <= 1.0:
                misses.append((name, "output", r))
            if spec.grad_wrt:
                gargs = spec.sample(np.random.RandomState(1))
                for i in spec.grad_wrt:
                    gc = run(spec, gargs, dev, torch.float32, grad_at=i)
                    g64 = run(spec, gargs, "cpu", torch.float64, grad_at=i)
                    rg = _c2j_ratio(np, gc, g64, spec.grad_rtol,
                                    spec.grad_atol)
                    worst[f"{name} grad {i}"] = rg
                    n_grad += 1
                    if not rg <= 1.0:
                        misses.append((name, f"grad {i}", rg))
            bargs = spec.sample(np.random.RandomState(2))
            if spec.bf16 and all(np.issubdtype(np.asarray(a).dtype,
                                               np.floating) for a in bargs):
                if name == "linalg.matrix_rank":
                    skipped.append((name, "bf16: no bfloat16 form (a "
                                    "rounding of the input changes the "
                                    "rank)"))
                    continue
                f32 = np.asarray(run(spec, bargs, dev, torch.float32),
                                 np.float32)
                b16 = np.asarray(run(spec, bargs, dev, torch.bfloat16),
                                 np.float32)
                scale = max(1.0, float(np.max(np.abs(f32))))
                rb = float(np.max(np.abs(b16 - f32))) / scale / 0.1
                worst[f"{name} bf16"] = rb
                n_bf16 += 1
                if not rb < 1.0:
                    misses.append((name, "bf16", rb))
        except Exception as e:     # noqa: BLE001 (collected, then raised)
            misses.append((name, "raised", f"{type(e).__name__}: {e}"[:300]))
    for m in misses:
        log(f"c2j (1) miss: {m}")
    for s in skipped:
        log(f"c2j (1) skipped: {s}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
    log(f"c2j (1) {len(specs)} entries: {n_out} outputs, {n_grad} "
        f"gradients, {n_bf16} bf16 runs on the card; worst err/limit "
        f"{top}")
    require(len(specs) == 276, f"c2j (1): {len(specs)} registry entries")
    require(not misses, f"c2j (1): {len(misses)} misses: {misses[:6]}")
    return {"entries": len(specs), "outputs": n_out, "gradients": n_grad,
            "bf16": n_bf16, "skipped": skipped,
            "worst": [[k, v] for k, v in top]}


def _c2j_gate(torch, got, cpu32, cpu64):
    """c2g (1)'s rule: the card within 4 x the CPU float32 run's distance
    from the float64 anchor plus 1e-6 of the anchor's range."""
    got, cpu32 = got.detach().double().cpu(), cpu32.detach().double()
    cpu64 = cpu64.detach().double()
    scale = float(cpu64.abs().max())
    own = float((cpu32 - cpu64).abs().max())
    err = float((got - cpu64).abs().max())
    lim = 4.0 * own + 1e-6 * scale + 1e-30
    return {"err": err, "cpu32_err": own, "limit": lim,
            "err_over_limit": err / lim}


def c2j_frontend(torch, np, dev):
    """(c2j 2) DeepSpeech2's spectrogram front end through the tensor API:
    log1p(|stft(x)|^2) of B=16 seeded 4 s utterances (Hann window of 320,
    hop 160, centre padding: 161 bins x 401 frames), and its gradient by x
    against a seeded cotangent, card against the CPU by c2g (1)'s rule; the
    istft round trip's error; the forward's and the backward's ms."""
    import paddle_tpu_torch as pt
    a = C2J_AUDIO
    rng = np.random.RandomState(SEED + 7)
    x_np = (0.1 * rng.randn(a["B"], a["samples"])).astype(np.float32)
    k = np.arange(a["n_fft"])
    w_np = (0.5 - 0.5 * np.cos(2 * np.pi * k / a["n_fft"])).astype(np.float32)
    frames = 1 + a["samples"] // a["hop"]
    g_np = rng.rand(a["B"], a["n_fft"] // 2 + 1, frames).astype(np.float32)

    def feats(x, w):
        spec = pt.signal.stft(x, a["n_fft"], a["hop"], window=w)
        return pt.log1p(pt.abs(spec) ** 2)

    runs = {}
    for tag, device, dt in (("card", dev, torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        x = torch.as_tensor(x_np, dtype=dt, device=device).requires_grad_()
        w = torch.as_tensor(w_np, dtype=dt, device=device)
        f = feats(x, w)
        (gx,) = torch.autograd.grad((f * torch.as_tensor(
            g_np, dtype=dt, device=device)).sum(), x)
        runs[tag] = (f.detach(), gx)
    require(tuple(runs["card"][0].shape) == (a["B"], a["n_fft"] // 2 + 1,
                                             frames),
            f"c2j (2): features {tuple(runs['card'][0].shape)}")
    out = {"features": _c2j_gate(torch, *(r[0] for r in (
        runs["card"], runs["cpu"], runs["cpu64"]))),
        "grad_x": _c2j_gate(torch, *(r[1] for r in (
            runs["card"], runs["cpu"], runs["cpu64"])))}
    for key, gate in out.items():
        require(gate["err_over_limit"] <= 1.0 and np.isfinite(gate["err"]),
                f"c2j (2) {key}: {gate}")
    x = torch.as_tensor(x_np, device=dev)
    w = torch.as_tensor(w_np, device=dev)
    spec = pt.signal.stft(x, a["n_fft"], a["hop"], window=w)
    y = pt.signal.istft(spec, a["n_fft"], a["hop"], window=w,
                        length=a["samples"])
    rt = float((y - x).abs().max() / x.abs().max())
    require(rt < 1e-5, f"c2j (2) istft round trip: {rt}")
    xg = x.clone().requires_grad_()
    loss = (feats(xg, w) * torch.as_tensor(g_np, device=dev)).sum()
    out.update({
        "shape": [a["B"], a["n_fft"] // 2 + 1, frames],
        "istft_round_trip_rel_err": rt,
        "forward_ms": time_ms(torch, lambda: feats(x, w), reps=10),
        "backward_ms": time_ms(torch, lambda: torch.autograd.grad(
            loss, xg, retain_graph=True), reps=10)})
    log(f"c2j (2) front end: {json.dumps(out)}")
    return out


def c2j_linalg(torch, np, dev):
    """(c2j 3) linalg at 2048 x 2048 in float32 on the card, each result
    held by its residual, computed in float64 from the card's factors,
    within n x float32 eps (gamma_n, the a-priori backward-error bound);
    the singular values, eigenvalues, determinant and rank against the
    float64 CPU run's (the determinant of a matrix of condition number
    below 10, within 10 gamma_n); each op's ms (CUDA events, median of
    3).  A is a seeded Gaussian matrix, S = A A^T / n + I (symmetric
    positive definite, condition number about 5), M = I + A / (4 sqrt n)."""
    import paddle_tpu_torch as pt
    n = C2J_LINALG_N
    rng = np.random.RandomState(SEED + 8)
    A = torch.as_tensor(rng.randn(n, n).astype(np.float32), device=dev)
    B = torch.as_tensor(rng.randn(n, 16).astype(np.float32), device=dev)
    R = torch.as_tensor(rng.randn(n // 2, n).astype(np.float32), device=dev)
    eye = torch.eye(n, device=dev)
    S = A @ A.T / n + eye
    M = eye + A / (4 * n ** 0.5)
    low = S[:, :n // 2] @ R                      # rank n / 2
    eye64 = eye.double()
    tol = C2J_LINALG_TOL
    fro = torch.linalg.matrix_norm
    rows = {}

    def d(t):
        return t.double()

    def rel(a, b):
        return float(fro(a - b) / fro(b))

    def backward_err(a, x, b):
        return float(fro(d(a) @ d(x) - d(b)) / (fro(d(a)) * fro(d(x))))

    misses = []

    def row(name, fn, resid, limit=tol, **extra):
        out = fn()
        r = resid(out)
        rows[name] = {"ms": time_ms(torch, fn, reps=3), "residual": r,
                      "limit": limit, **extra}
        if not r <= limit:
            misses.append((name, r, limit))
        return out

    row("cholesky", lambda: pt.linalg.cholesky(S),
        lambda L: rel(d(L) @ d(L).T, d(S)))
    row("solve", lambda: pt.linalg.solve(A, B),
        lambda X: backward_err(A, X, B))
    row("inv", lambda: pt.linalg.inv(S),
        lambda X: backward_err(S, X, eye64))
    row("qr", lambda: pt.linalg.qr(A),
        lambda qr: max(rel(d(qr[0]) @ d(qr[1]), d(A)),
                       float(fro(d(qr[0]).T @ d(qr[0]) - eye64)) / n ** 0.5))
    s64 = torch.linalg.svdvals(A.double().cpu())
    usv = row("svd", lambda: pt.linalg.svd(A),
              lambda usv: rel((d(usv[0]) * d(usv[1])) @ d(usv[2]), d(A)))
    sv_err = float((usv[1].double().cpu() - s64).abs().max() / s64[0])
    rows["svd"]["singular_values_rel_err"] = sv_err
    if not sv_err <= tol:
        misses.append(("singular values", sv_err, tol))
    w64 = torch.linalg.eigvalsh(S.double().cpu())
    wv = row("eigh", lambda: pt.linalg.eigh(S),
             lambda wv: rel(d(S) @ d(wv[1]), d(wv[1]) * d(wv[0])))
    ev_err = float((wv[0].double().cpu() - w64).abs().max()
                   / w64.abs().max())
    rows["eigh"]["eigenvalues_rel_err"] = ev_err
    if not ev_err <= tol:
        misses.append(("eigenvalues", ev_err, tol))
    row("lstsq", lambda: pt.linalg.lstsq(S, B),
        lambda out: backward_err(S, out[0], B))

    def plu_err(plu):
        p, l, u = plu
        return rel(d(p) @ d(l) @ d(u), d(A))
    lu, piv = row("lu", lambda: pt.linalg.lu(A),
                  lambda out: plu_err(pt.linalg.lu_unpack(*out)))
    row("lu_unpack", lambda: pt.linalg.lu_unpack(lu, piv), plu_err)
    M64 = M.double().cpu()
    det64 = float(torch.linalg.det(M64))
    ld64 = float(torch.linalg.slogdet(M64)[1])
    row("det", lambda: pt.linalg.det(M),
        lambda v: abs(float(v) - det64) / abs(det64), limit=10 * tol,
        det64=det64)
    row("slogdet", lambda: pt.linalg.slogdet(M),
        lambda v: abs(float(v[1]) - ld64), limit=10 * tol,
        logabsdet64=ld64)
    # the float64 rank at float32's tolerance: the float32 product is of
    # exact rank n / 2 only up to its rounding
    rank64 = int(torch.linalg.matrix_rank(low.double().cpu(), rtol=tol))
    rows["matrix_rank"] = {
        "ms": time_ms(torch, lambda: pt.linalg.matrix_rank(low), reps=3),
        "rank": int(pt.linalg.matrix_rank(low)), "cpu64_rank": rank64,
        "rank_of_S": int(pt.linalg.matrix_rank(S))}
    if not (rows["matrix_rank"]["rank"] == rank64 == n // 2
            and rows["matrix_rank"]["rank_of_S"] == n):
        misses.append(("matrix_rank", rows["matrix_rank"]))
    log(f"c2j (3) linalg at {n}: {json.dumps(rows)}")
    require(not misses, f"c2j (3) beyond the bound: {misses}")
    return rows


def c2j_ops(torch, np, dev):
    """(c2j 4) about thirty top-level ops at GPT-125M's activation shape
    (8, 2048, 768) float32: each on the card against the CPU by c2g (1)'s
    rule (integer results exact), its ms by CUDA events and its bytes
    bound (each input read once and the output written once, over 3.35
    TB/s: gather and index_select read the rows they pick, tril the lower
    triangle; a view moves no bytes)."""
    import paddle_tpu_torch as pt
    rng = np.random.RandomState(SEED + 9)
    shape = C2J_OPS_SHAPE
    host = {"x": rng.randn(*shape).astype(np.float32),
            "y": rng.randn(*shape).astype(np.float32),
            "idx": rng.randint(0, shape[1], 1024).astype(np.int64)}
    host["p"] = np.abs(host["x"]) + 0.5
    ops = [
        ("exp", lambda m, v: m.exp(v["x"])),
        ("log", lambda m, v: m.log(v["p"])),
        ("tanh", lambda m, v: m.tanh(v["x"])),
        ("sigmoid", lambda m, v: m.sigmoid(v["x"])),
        ("erf", lambda m, v: m.erf(v["x"])),
        ("add", lambda m, v: m.add(v["x"], v["y"])),
        ("multiply", lambda m, v: m.multiply(v["x"], v["y"])),
        ("divide", lambda m, v: m.divide(v["x"], v["p"])),
        ("maximum", lambda m, v: m.maximum(v["x"], v["y"])),
        ("pow", lambda m, v: m.pow(v["p"], 1.5)),
        ("where", lambda m, v: m.where(v["x"] > 0, v["x"], v["y"])),
        ("clip", lambda m, v: m.clip(v["x"], -0.5, 0.5)),
        ("sum", lambda m, v: m.sum(v["x"], axis=-1)),
        ("mean", lambda m, v: m.mean(v["x"], axis=-1)),
        ("max", lambda m, v: m.max(v["x"], axis=-1)),
        ("logsumexp", lambda m, v: m.logsumexp(v["x"], axis=-1)),
        ("cumsum", lambda m, v: m.cumsum(v["x"], axis=-1)),
        ("std", lambda m, v: m.std(v["x"], axis=-1)),
        ("var", lambda m, v: m.var(v["x"], axis=-1)),
        ("argmax", lambda m, v: m.argmax(v["x"], axis=-1)),
        ("topk", lambda m, v: m.topk(v["x"], 8, axis=-1)[0]),
        ("sort", lambda m, v: m.sort(v["x"], axis=-1)),
        ("transpose", lambda m, v: m.transpose(v["x"], (0, 2, 1))),
        ("reshape", lambda m, v: m.reshape(v["x"], (-1, shape[-1]))),
        ("concat", lambda m, v: m.concat([v["x"], v["y"]], axis=-1)),
        ("split", lambda m, v: m.split(v["x"], 3, axis=-1)[1]),
        ("gather", lambda m, v: m.gather(v["x"], v["idx"], axis=1)),
        ("index_select", lambda m, v: m.index_select(v["x"], v["idx"],
                                                     axis=1)),
        ("flip", lambda m, v: m.flip(v["x"], -1)),
        ("roll", lambda m, v: m.roll(v["x"], 7, axis=-1)),
        ("tril", lambda m, v: m.tril(v["x"])),
    ]
    card = {k: torch.as_tensor(a, device=dev) for k, a in host.items()}
    cpu = {k: torch.as_tensor(a) for k, a in host.items()}
    cpu64 = {k: (t.double() if t.is_floating_point() else t)
             for k, t in cpu.items()}
    used = {"exp": ("x",), "log": ("p",), "tanh": ("x",), "sigmoid": ("x",),
            "erf": ("x",), "add": ("x", "y"), "multiply": ("x", "y"),
            "divide": ("x", "p"), "maximum": ("x", "y"), "pow": ("p",),
            "where": ("x", "y"), "gather": ("x", "idx"),
            "index_select": ("x", "idx"), "concat": ("x", "y")}
    rows = []
    for name, fn in ops:
        got = fn(pt, card)
        want32, want64 = fn(pt, cpu), fn(pt, cpu64)
        view = got.untyped_storage().data_ptr() in {
            t.untyped_storage().data_ptr() for t in card.values()}
        if got.is_floating_point():
            gate = _c2j_gate(torch, got, want32, want64)
        else:
            same = torch.equal(got.cpu(), want32)
            gate = {"err": 0.0 if same else float("inf"),
                    "err_over_limit": 0.0 if same else float("inf")}
        out_bytes = got.numel() * got.element_size()
        if view:
            moved = 0
        elif name in ("gather", "index_select"):   # the picked rows only
            moved = 2 * out_bytes + nbytes(card["idx"])
        elif name == "tril":                       # the lower triangle
            moved = out_bytes + int(torch.ones(
                shape[-2:], device=dev).tril().sum()) * shape[0] * 4
        else:
            moved = nbytes(*(card[k] for k in used.get(name, ("x",)))) \
                + out_bytes
        rows.append({"op": name, "ms": time_ms(torch, lambda: fn(pt, card),
                                               reps=10),
                     "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                     "view": bool(view), "err": gate["err"],
                     "err_over_limit": gate["err_over_limit"]})
        require(gate["err_over_limit"] <= 1.0, f"c2j (4) {name}: {gate}")
    for r in rows:
        log(f"c2j (4) {json.dumps(r)}")
    return rows


def tensor_api(torch, np, dev, _kernels):
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    parts, line = {}, {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t0
        log(f"c2j {name}: {parts[name]:.1f} s")
        torch.cuda.empty_cache()
        return out
    line["registry"] = part("registry", lambda: c2j_registry(torch, np, dev))
    line["frontend"] = part("frontend", lambda: c2j_frontend(torch, np, dev))
    line["linalg"] = part("linalg", lambda: c2j_linalg(torch, np, dev))
    line["ops"] = part("ops", lambda: c2j_ops(torch, np, dev))
    launches = dict(_kernels.launches)
    require(not any(launches.values()),
            f"c2j launched a kernel of the port: {launches}")
    line.update({"launches": launches, "parts_s": parts,
                 "phase_s": time.perf_counter() - t_phase})
    log(json.dumps({"tensor_api": line}))
    return line


# ---------------------------------------------------------------------------
# (c2g) the encoder-decoder Transformer
# ---------------------------------------------------------------------------
# the kernels of the rotary fused blocks (5): a bf16 O1 training block (K1
# and K2 on the tensor cores, the three flash kernels) and a float32 decode
# step (K1 and K2 streaming float32 weights, flash decode)
ROTARY_TRAINING_KERNELS = ("ln_linear_mma", "linear_residual_mma",
                           *TRAINING_KERNELS)
ROTARY_DECODE_KERNELS = ("ln_linear_stream", "linear_residual_stream",
                         "flash_decode")
ROTARY_KERNELS = (*ROTARY_TRAINING_KERNELS, *ROTARY_DECODE_KERNELS)
XLATE_CHECK = {"layers": 2, "batch": 4, "seq": 64}    # (1)
XLATE_BEAM = {"batch": 8, "src_len": 32, "beam": 4, "max_steps": 48}   # (3)
ROTARY_SHAPE = {"B": 8, "S": 2048, "h": 768, "heads": 12, "p": 0.1}    # (5)
ROTARY_DECODE = {"B": 8, "L": 640, "used": 575}                        # (5)
INCUBATE_SHAPE = {"B": 16, "S": 512, "h": 768, "heads": 12, "ffn": 3072}


def transformer_matmul_flops(model, b, s_src, s_tgt):
    """Training FLOPs of one step of a ``TranslationModel``: 6 x the matmul
    weights each token passes through (source tokens: every encoder
    projection and FFN weight and the decoder's cross-attention k / v
    projections, which read the memory; target tokens: the decoder's
    self-attention, cross-attention q / out and FFN weights and the head),
    plus 3 x the forward score and value products (2 x 2 x d_model x q x
    k a batch row) of every self- and cross-attention, counted whole (the
    decoder's additive causal mask computes every score)."""
    core = model.core
    d = core.d_model
    enc = sum(p.numel() for n, p in core.encoder.named_parameters()
              if n.endswith("weight") and "norm" not in n)
    dec = sum(p.numel() for n, p in core.decoder.named_parameters()
              if n.endswith("weight") and "norm" not in n)
    cross_kv = sum(p.numel() for n, p in core.decoder.named_parameters()
                   if ".cross_attn.k_proj.weight" in n
                   or ".cross_attn.v_proj.weight" in n)
    head = model.head.weight.numel()
    src_w, tgt_w = enc + cross_kv, dec - cross_kv + head
    n_enc, n_dec = len(core.encoder.layers), len(core.decoder.layers)
    attn = 3 * 4 * d * b * (n_enc * s_src * s_src
                            + n_dec * (s_tgt * s_tgt + s_tgt * s_src))
    return {"source_weights": src_w, "target_weights": tgt_w,
            "matmul": 6.0 * (src_w * b * s_src + tgt_w * b * s_tgt),
            "attention": float(attn),
            "total": 6.0 * (src_w * b * s_src + tgt_w * b * s_tgt) + attn}


def translation_card_vs_cpu(torch, np, dev):
    """(c2g 1): one float32 training step of the full-width translation
    model cut to 2 + 2 layers (vocab 30000, dropout 0) on the card and on
    the CPU from the same weights and ids, and a float64 CPU run as the
    anchor: the loss, the logits and every gradient on the card within 4 x
    the CPU float32 run's own distance from the anchor (never less than
    one float32 unit, 2^-23, of the tensor's range; the key biases'
    gradients, zero in exact arithmetic, never less than the CPU's
    distance on the same projection's weight gradient).  Reports the
    worst tensors; fails listing every tensor over its bound."""
    from paddle_tpu_torch.convert import (TRANSFORMER_VOCAB,
                                          load_jax_state,
                                          transformer_training_workload)
    from paddle_tpu_torch.models.translation import TranslationModel
    from paddle_tpu_torch.nn import functional as F
    c = XLATE_CHECK
    base, _, _, _ = transformer_training_workload(
        "cpu", layers=c["layers"], batch=1, seq_len=c["seq"], dropout=0.0)
    weights = {k: v.numpy() for k, v in base.state_dict().items()}
    del base
    rng = np.random.RandomState(SEED)
    src = rng.randint(3, TRANSFORMER_VOCAB, (c["batch"], c["seq"]))
    tgt = rng.randint(3, TRANSFORMER_VOCAB, (c["batch"], c["seq"]))
    tin = np.concatenate([np.zeros((c["batch"], 1), np.int64),
                          tgt[:, :-1]], axis=1)
    runs = {}
    for tag, device, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64)):
        m = TranslationModel(TRANSFORMER_VOCAB, c["seq"],
                             num_encoder_layers=c["layers"],
                             num_decoder_layers=c["layers"], dropout=0.0,
                             device=device)
        load_jax_state(m, weights)
        m = m.to(dtype).train()
        ids = [torch.from_numpy(a).to(device) for a in (src, tin, tgt)]
        logits = m(ids[0], ids[1])
        loss = F.cross_entropy(logits, ids[2], label_smoothing=0.1)
        loss.backward()
        out = {"loss": loss.detach().reshape(1), "logits": logits.detach()}
        out.update({f"grad {k}": p.grad for k, p in m.named_parameters()})
        runs[tag] = {k: v.detach().double().cpu() for k, v in out.items()}
        del m, logits, loss, out
    def own_of(k):
        return float((runs["cpu"][k] - runs["cpu64"][k]).abs().max())
    table, over = [], []
    for k, ref in runs["cpu64"].items():
        scale = float(ref.abs().max())
        own = own_of(k)
        floor = 2.0 ** -23 * scale
        if k.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax is invariant to a shift
            # shared by every key): rounding noise in every run, held to
            # the noise of the same projection's weight gradient
            floor = max(floor, own_of(k[:-len("bias")] + "weight"))
        bound = 4.0 * max(own, floor) + 1e-30
        err = float((runs["card"][k] - ref).abs().max())
        table.append((err / bound, err / max(scale, 1e-30),
                      own / max(scale, 1e-30), k))
        if err > bound:
            over.append((k, err, bound, own, scale))
    table.sort(reverse=True)
    require(not over, f"c2g (1): {len(over)} tensors on the card lie "
            f"beyond 4 x the CPU float32 run's distance from float64 "
            f"(tensor, card err, bound, CPU err, range): {over[:8]}")
    return {"layers": c["layers"], "B": c["batch"], "S": c["seq"],
            "vocab": TRANSFORMER_VOCAB, "tensors": len(table),
            "loss_card": float(runs["card"]["loss"][0]),
            "loss_cpu": float(runs["cpu"]["loss"][0]),
            "loss_cpu64": float(runs["cpu64"]["loss"][0]),
            "worst_err_over_bound": table[0][0],
            # (err / bound, card's distance / range, the CPU's / range,
            # tensor), the largest five
            "worst": table[:5]}


def translation_step(torch, np, dev, _kernels):
    """(c2g 2): the full-width Transformer-base step (convert.
    transformer_training_workload): WARMUP_STEPS + TIMED_STEPS steps of
    training.seq2seq_step, each to its loss readback; finite losses near
    ln V at the start."""
    from paddle_tpu_torch.convert import transformer_training_workload
    from paddle_tpu_torch.training import seq2seq_step
    model, opt, (src, tin, tnx), kw = transformer_training_workload(dev)
    core = model.core
    require(core.d_model == 512 and core.nhead == 8
            and len(core.encoder.layers) == 6
            and len(core.decoder.layers) == 6
            and core.encoder.layers[0].linear1.weight.shape == (512, 2048)
            and core.encoder.layers[0].dropout1.p == 0.1
            and model.vocab == 30000 and tuple(src.shape) == (32, 128)
            and kw["level"] == "O1" and kw["label_smoothing"] == 0.1,
            "not the Transformer-base workload at vocab 30000, B=32, "
            "S=128, O1, dropout 0.1, label smoothing 0.1")
    b, s = src.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(seq2seq_step(model, opt, src, tin, tnx, **kw))
        times.append((time.perf_counter() - t0) * 1e3)
    require(all(np.isfinite(losses)), f"c2g (2): nonfinite loss {losses}")
    step_ms = times[WARMUP_STEPS:]
    p50 = statistics.median(step_ms)
    flops = transformer_matmul_flops(model, b, s, s)
    line = {"model": "transformer_base", "vocab": model.vocab,
            "params": sum(p.numel() for p in model.parameters()),
            "B": b, "S_src": s, "S_tgt": s, "amp": "O1", "dropout": 0.1,
            "label_smoothing": 0.1,
            "optimizer": "Adam(beta1 0.9, beta2 0.98, epsilon 1e-9), "
                         "NoamDecay(d_model=512, warmup_steps=4000)",
            "steps": {"warmup": WARMUP_STEPS, "timed": TIMED_STEPS},
            "step_ms_p50": p50, "step_ms": step_ms,
            "src_tokens_per_s": b * s / (p50 / 1e3),
            "tgt_tokens_per_s": b * s / (p50 / 1e3),
            "flops_per_step": flops,
            "mfu": flops["total"] / (p50 / 1e3) / BF16_FLOPS,
            "mfu_peak": "989 TFLOP/s bf16 dense",
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ln_vocab": float(np.log(model.vocab)), "losses": losses}
    del model, opt
    return line


def translation_beam(torch, np, dev):
    """(c2g 3): beam search on the incremental decoder cache
    (TranslationModel.cached_cell) over B sources of seeded ids: float32
    at 2 + 2 layers on the card and on the CPU from the same weights (ids
    equal; where they differ, the top-2 total margin of the first step
    that differs is reported and the phase fails), then full width under
    bf16 O1, timed (wall time over the steps, each step reading back
    whether every beam has finished)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import (TRANSFORMER_VOCAB,
                                          load_jax_state,
                                          transformer_training_workload)
    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
    c = XLATE_BEAM
    rng = np.random.RandomState(SEED + 7)
    src_np = rng.randint(3, TRANSFORMER_VOCAB, (c["batch"], c["src_len"]))

    def search(model, device, record=None):
        src = torch.from_numpy(src_np).to(device)
        cell = model.cached_cell()
        if record is not None:
            def cell(tok, state, inner=cell):
                logits, new = inner(tok, state)
                record.append(logits.float().cpu())
                return logits, new
        memory = model.encode(src)
        dec = BeamSearchDecoder(cell, start_token=0, end_token=1,
                                beam_size=c["beam"])
        return dynamic_decode(dec, inits={
            "memory": memory, "cache": model.empty_cache(src.shape[0],
                                                         memory)},
            max_step_num=c["max_steps"])

    small, _, _, _ = transformer_training_workload(
        "cpu", layers=2, batch=1, dropout=0.0)
    weights = {k: v.numpy() for k, v in small.state_dict().items()}
    outs, logs = {}, {}
    for tag, device in (("card", dev), ("cpu", "cpu")):
        m, _, _, _ = transformer_training_workload(
            device, layers=2, batch=1, dropout=0.0)
        load_jax_state(m, weights)
        m.eval()
        logs[tag] = []
        with torch.no_grad():
            ids, lp = search(m, device, logs[tag])
        outs[tag] = (ids.cpu(), lp.cpu())
        del m
    same = torch.equal(outs["card"][0], outs["cpu"][0])
    margin = None
    if not same:
        # the first step at which a row's best token differs, and the
        # smallest top-2 log-prob margin of the CPU's rows there
        steps = min(len(logs["card"]), len(logs["cpu"]))
        step = next((t for t in range(steps)
                     if not torch.equal(logs["card"][t].argmax(-1),
                                        logs["cpu"][t].argmax(-1))),
                    steps - 1)
        top2 = torch.topk(torch.log_softmax(logs["cpu"][step], -1), 2,
                          dim=-1).values
        margin = {"step": step,
                  "min_top2_margin": float((top2[:, 0] - top2[:, 1]).min())}
    require(same, f"c2g (3): float32 beam search at 2 + 2 layers: the "
            f"card's ids differ from the CPU's ({margin})")
    lp_err = float((outs["card"][1] - outs["cpu"][1]).abs().max())

    model, _, _, _ = transformer_training_workload(dev, dropout=0.0)
    model.eval()
    with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
        search(model, dev)                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, lp = search(model, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = ids.shape[2]
    require(tuple(ids.shape[:2]) == (c["batch"], c["beam"])
            and bool(((ids >= 0) & (ids < model.vocab)).all())
            and bool(torch.isfinite(lp).all()),
            f"c2g (3): bad beam search output {tuple(ids.shape)}")
    del model
    return {"B": c["batch"], "src_len": c["src_len"], "beam": c["beam"],
            "max_steps": c["max_steps"],
            "float32_2x2": {"ids_equal": same, "steps": outs["cpu"][0]
                            .shape[2], "log_prob_max_abs_err": lp_err},
            "full_width_bf16_o1": {"steps": steps, "wall_s": wall,
                                   "ms_per_step": wall * 1e3 / steps}}


def translation_recipe_check(torch, np, dev):
    """(c2g 4): convert.translation_recipe on the card: the loss falls from
    above 0.05 to below it, and beam search is exact on 8 of 8."""
    from paddle_tpu_torch.convert import translation_recipe
    t0 = time.perf_counter()
    out = translation_recipe(dev)
    out["seconds"] = time.perf_counter() - t0
    require(out["loss_last"] < 0.05 < out["loss_first"],
            f"c2g (4): recipe losses {out['loss_first']} -> "
            f"{out['loss_last']}, not from above 0.05 to below it")
    require(out["exact"] == out["items"] == 8,
            f"c2g (4): beam search exact on {out['exact']} of "
            f"{out['items']}: {out['hypotheses']}")
    out.pop("losses")
    return out


def plain_rotary_block(torch, fb, amp_state, x, qkv_w, qkv_b, out_w, out_b,
                       g, beta, heads, p, seed):
    """fused_attention_block(rotary=True)'s plain composition on the same
    device: K1's and K2's plain versions under the same O1 casts, the
    plain rope and _attention_ref (hash dropout of the same seed)."""
    b, s, h = x.shape
    d = h // heads
    _, w = amp_state.cast_for_op("linear", x, qkv_w)
    qkv = fb.ln_linear_reference(x.reshape(-1, h), w, qkv_b, g, beta, 1e-5)
    q, k, v = fb._split_heads(qkv, b, s, heads, d)
    q, k = fb._apply_rope(q, k, 10000.0)
    out = fb._attention_ref(q, k, v, d ** -0.5, True, p, seed)
    a, w2 = amp_state.cast_for_op("linear", out.reshape(b, s, h), out_w)
    y = fb.linear_residual_reference(a.reshape(-1, h), w2, out_b,
                                     x.reshape(-1, h), seed, p,
                                     fb._SALT_RESID)
    return y.reshape(b, s, h)


def rotary_blocks(torch, np, dev, _kernels):
    """(c2g 5): rotary=True in the fused blocks at GPT-125M width.
    Training: fused_attention_block at B=8, S=2048, bf16 O1, dropout 0.1,
    forward and backward, against its plain composition on the card (one
    bf16 unit at the top of each tensor's range, c2b's bound).  Decode: one
    float32 fused_attention_block_kvcache step at L=640 with 575 cached
    positions against the plain composition (1e-4 of the range).  The
    counters are zeroed just before each fused call and read after it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import state as amp_state
    from paddle_tpu_torch.ops import fused_block as fb
    c = ROTARY_SHAPE
    b, s, h, heads, p = c["B"], c["S"], c["h"], c["heads"], c["p"]
    rng = np.random.default_rng(SEED + 11)

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(
            np.float32)).to(dev)
    params = [t(h, 3 * h, std=0.02), t(3 * h, std=0.02), t(h, h, std=0.02),
              t(h, std=0.02), 1 + t(h, std=0.1), t(h, std=0.1)]
    x0, ct = t(b, s, h), t(b, s, h)
    seed = 424242
    runs, launches = {}, {}
    for tag in ("fused", "plain"):
        ps = [q.clone().requires_grad_() for q in params]
        x = x0.clone().requires_grad_()
        torch.cuda.synchronize()
        _kernels.reset_launches()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            if tag == "fused":
                y = fb.fused_attention_block(
                    x, *ps, num_heads=heads, attn_dropout=p,
                    hidden_dropout=p, rotary=True, seed=seed)
            else:
                y = plain_rotary_block(torch, fb, amp_state, x, *ps, heads,
                                       p, seed)
        y.backward(ct)
        torch.cuda.synchronize()
        launches[tag] = dict(_kernels.launches)
        runs[tag] = [y.detach(), x.grad] + [q.grad for q in ps]
        del y, x, ps
        torch.cuda.empty_cache()
    names = ["out", "grad x", "grad qkv_w", "grad qkv_b", "grad out_w",
             "grad out_b", "grad ln_scale", "grad ln_bias"]
    train_cmp = {n: compare(torch, f"c2g (5) rotary block {n}", a, r,
                            bf16_tol(r))
                 for n, a, r in zip(names, runs["fused"], runs["plain"])}
    for name in ROTARY_TRAINING_KERNELS:
        require(launches["fused"][name] > 0,
                f"c2g (5): {name} did not launch in the rotary block")
    require(not any(launches["plain"].values()),
            f"c2g (5): the plain composition launched {launches['plain']}")
    del runs

    c = ROTARY_DECODE
    bd, cap, used = c["B"], c["L"], c["used"]
    d = h // heads
    xs = t(bd, 1, h)
    kb, vb = t(bd, heads, cap, d), t(bd, heads, cap, d)
    outs = {}
    for tag in ("fused", "plain"):
        k_buf, v_buf = kb.clone(), vb.clone()
        _kernels.reset_launches()
        with torch.no_grad():
            if tag == "fused":
                y, k_buf, v_buf = fb.fused_attention_block_kvcache(
                    xs, *params, k_buf, v_buf, used, num_heads=heads,
                    rotary=True)
            else:
                qkv = fb.ln_linear_reference(xs.reshape(-1, h), params[0],
                                             params[1], params[4],
                                             params[5], 1e-5)
                q, k, v = fb._split_heads(qkv, bd, 1, heads, d)
                q, k = fb._apply_rope(q, k, 10000.0)
                k_buf[:, :, used] = k[:, 0]
                v_buf[:, :, used] = v[:, 0]
                scores = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2),
                                      k_buf[:, :, :used + 1]) * d ** -0.5
                o = torch.einsum("bhqk,bhkd->bhqd",
                                 torch.softmax(scores, -1),
                                 v_buf[:, :, :used + 1])
                y = fb.linear_residual_reference(
                    o.transpose(1, 2).reshape(bd, h), params[2], params[3],
                    xs.reshape(bd, h)).reshape(bd, 1, h)
        torch.cuda.synchronize()
        launches[f"decode {tag}"] = dict(_kernels.launches)
        outs[tag] = (y, k_buf, v_buf)
    decode_cmp = {n: compare(torch, f"c2g (5) rotary decode {n}", a, r,
                             1e-4 * float(r.abs().max()) + 1e-6)
                  for n, a, r in zip(("out", "k cache", "v cache"),
                                     outs["fused"], outs["plain"])}
    for name in ROTARY_DECODE_KERNELS:
        require(launches["decode fused"][name] > 0,
                f"c2g (5): {name} did not launch in the rotary decode step")
    counts = {n: launches["fused"][n] for n in ROTARY_TRAINING_KERNELS}
    counts.update({n: launches["decode fused"][n]
                   for n in ROTARY_DECODE_KERNELS})
    return {"training": {"B": b, "S": s, "h": h, "heads": heads,
                         "amp": "O1", "dropout": p,
                         "worst_err_over_tol": max(
                             r["err_over_tol"] for r in train_cmp.values()),
                         "tensors": train_cmp},
            "decode": {"B": bd, "L": cap, "used": used, "dtype": "float32",
                       "worst_err_over_tol": max(
                           r["err_over_tol"] for r in decode_cmp.values()),
                       "tensors": decode_cmp},
            "launches": counts}


def incubate_layers(torch, np, dev):
    """(c2g 6): incubate's FusedTransformerEncoderLayer at BERT-base width
    (768, 12 heads, FFN 3072, gelu, post-LN, B=16, S=512, float32, dropout
    0) against a plain TransformerEncoderLayer carrying its weights, forward
    and backward on the card: each tensor within 1e-4 of its range;
    forward + backward ms of each (CUDA events, median of 5)."""
    from paddle_tpu_torch import incubate, nn
    from paddle_tpu_torch.framework import random as fw_random
    c = INCUBATE_SHAPE
    h = c["h"]
    fw_random.seed(SEED)
    fused = incubate.nn.FusedTransformerEncoderLayer(
        h, c["heads"], c["ffn"], dropout_rate=0.0, activation="gelu",
        device=dev)
    plain = nn.TransformerEncoderLayer(h, c["heads"], c["ffn"], dropout=0.0,
                                       activation="gelu", device=dev)
    sd = fused.state_dict()
    w, bias = sd["fused_attn.qkv_proj.weight"], sd["fused_attn.qkv_proj.bias"]
    mapped = {f"self_attn.out_proj.{k}": sd[f"fused_attn.out_proj.{k}"]
              for k in ("weight", "bias")}
    for dst, src in (("norm1", "fused_attn.norm"), ("norm2", "ffn.norm"),
                     ("linear1", "ffn.linear1"), ("linear2", "ffn.linear2")):
        for k in ("weight", "bias"):
            mapped[f"{dst}.{k}"] = sd[f"{src}.{k}"]
    for i, n in enumerate("qkv"):
        mapped[f"self_attn.{n}_proj.weight"] = w[:, i * h:(i + 1) * h]
        mapped[f"self_attn.{n}_proj.bias"] = bias[i * h:(i + 1) * h]
    plain.load_state_dict(mapped)
    rng = np.random.default_rng(SEED + 13)
    x0 = torch.from_numpy(rng.standard_normal(
        (c["B"], c["S"], h)).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal(
        (c["B"], c["S"], h)).astype(np.float32)).to(dev)
    res, ms = {}, {}
    for tag, layer in (("fused", fused), ("plain", plain)):
        x = x0.clone().requires_grad_()
        y = layer(x)
        y.backward(ct)
        res[tag] = [y.detach(), x.grad]
        res[tag + " params"] = {n: q.grad.clone()
                                for n, q in layer.named_parameters()}

        def fwd_bwd(layer=layer):
            xx = x0.clone().requires_grad_()
            layer(xx).backward(ct)
        ms[tag] = time_ms(torch, fwd_bwd, reps=5)
        layer.zero_grad(set_to_none=True)
    cmp = {n: compare(torch, f"c2g (6) incubate {n}", a, r,
                      1e-4 * float(r.abs().max()) + 1e-6)
           for n, a, r in zip(("out", "grad x"), res["fused"],
                              res["plain"])}
    pf, pp = res["fused params"], res["plain params"]
    gw = pf["fused_attn.qkv_proj.weight"]
    pairs = [(f"self_attn.{n}_proj.weight",
              gw[:, i * h:(i + 1) * h].contiguous())
             for i, n in enumerate("qkv")]
    pairs += [(dst, pf[src]) for dst, src in (
        ("linear1.weight", "ffn.linear1.weight"),
        ("linear2.weight", "ffn.linear2.weight"),
        ("norm1.weight", "fused_attn.norm.weight"),
        ("norm2.bias", "ffn.norm.bias"))]
    for dst, got in pairs:
        ref = pp[dst]
        cmp[f"grad {dst}"] = compare(torch, f"c2g (6) incubate grad {dst}",
                                     got, ref,
                                     1e-4 * float(ref.abs().max()) + 1e-6)
    return {**c, "dtype": "float32", "fwd_bwd_ms": ms,
            "worst_err_over_tol": max(r["err_over_tol"]
                                      for r in cmp.values()),
            "tensors": cmp}


def translation(torch, np, dev, _kernels):
    """(c2g) the encoder-decoder Transformer: (1) card against CPU, (2) the
    full-width Transformer-base step, (3) beam search, (4) the recipe, (5)
    rotary in the fused blocks, (6) the incubate layers.  (1)-(4) and (6)
    run plain PyTorch and cuBLAS: the eight kernels must launch 0 times
    there (counters zeroed before, read after).  Returns the rotary
    launches by kernel."""
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    check = translation_card_vs_cpu(torch, np, dev)
    log(f"translation reference: float32 {check['layers']} + "
        f"{check['layers']} layers, vocab {check['vocab']}, B={check['B']}, "
        f"S={check['S']}: card vs CPU loss {check['loss_card']:.6f} vs "
        f"{check['loss_cpu']:.6f} (float64 {check['loss_cpu64']:.6f}), "
        f"{check['tensors']} tensors within 4 x the CPU's float32 distance "
        f"(worst err/bound {check['worst_err_over_bound']:.3f})")
    torch.cuda.empty_cache()
    step = translation_step(torch, np, dev, _kernels)
    log(f"translation step (Transformer-base, B=32, S=128 a side, O1): p50 "
        f"{step['step_ms_p50']:.2f} ms, {step['src_tokens_per_s']:.0f} "
        f"source + {step['tgt_tokens_per_s']:.0f} target tokens/s, MFU "
        f"{step['mfu']:.4f}, peak {step['peak_memory_gb']:.2f} GB, loss "
        f"{step['losses'][0]:.4f} -> {step['losses'][-1]:.4f}")
    torch.cuda.empty_cache()
    beam = translation_beam(torch, np, dev)
    log(f"translation beam search: float32 2 + 2 layers card ids == CPU "
        f"ids ({beam['float32_2x2']['steps']} steps); full width bf16 O1 "
        f"{beam['full_width_bf16_o1']['ms_per_step']:.3f} ms a step over "
        f"{beam['full_width_bf16_o1']['steps']} steps (B=8, beam 4)")
    torch.cuda.empty_cache()
    recipe = translation_recipe_check(torch, np, dev)
    log(f"translation recipe: {len(recipe['hypotheses'])} items, loss "
        f"{recipe['loss_first']:.4f} -> {recipe['loss_last']:.4f}, exact "
        f"{recipe['exact']}/{recipe['items']} in {recipe['seconds']:.1f} s")
    incubate = incubate_layers(torch, np, dev)
    log(f"incubate FusedTransformerEncoderLayer (BERT-base width, B=16, "
        f"S=512, float32) vs plain layer: worst err/tol "
        f"{incubate['worst_err_over_tol']:.3f}; fwd+bwd "
        f"{incubate['fwd_bwd_ms']['fused']:.2f} ms vs "
        f"{incubate['fwd_bwd_ms']['plain']:.2f} ms")
    launches = dict(_kernels.launches)
    require(not any(launches.values()),
            f"c2g: the Transformer path launched a kernel of the port: "
            f"{launches}")
    torch.cuda.empty_cache()
    rotary = rotary_blocks(torch, np, dev, _kernels)
    log(f"rotary fused blocks: training (B=8, S=2048, h=768, O1, dropout "
        f"0.1) worst err/tol {rotary['training']['worst_err_over_tol']:.3f}"
        f"; decode (float32, L=640) worst err/tol "
        f"{rotary['decode']['worst_err_over_tol']:.3f}; launches "
        f"{rotary['launches']}")
    torch.cuda.empty_cache()
    log(json.dumps({"translation": {
        "reference": check, "step": step, "beam_search": beam,
        "recipe": recipe, "rotary": rotary, "incubate": incubate,
        "phase_s": time.perf_counter() - t_phase}}))
    return rotary["launches"]


# ---------------------------------------------------------------------------
# (c2k) export and deployment
# ---------------------------------------------------------------------------
C2K_SEQ = 512
C2K_BATCHES = (1, 4, 8)
C2K_TIMED = 5            # timed runs per batch, after one warm run
# the kernels a float32 fused GPT forward at more than 32 rows launches
# through the artifact's registered ops, and how many a run of GPT-125M
C2K_KERNELS = ("ln_linear_tiled", "linear_residual_tiled", "ffn_tiled",
               "flash_fwd")
C2K_LAYERS = 12
C2K_POSITIONS = (0, 255, 511)     # logits compared position by position
C2K_F32_TOL = 1e-3                # the serving phases' float32 logits bound
C2K_CAL = {"gpt": (4, 8), "resnet": (2, 16)}     # (calibration batches, B)
C2K_GEN_BATCHES = (1, 2, 4)


class _Records:
    """A registry sink that keeps the records of some kinds."""

    def __init__(self, kinds):
        self.kinds, self.records = set(kinds), []

    def write(self, record):
        if record.get("kind") in self.kinds:
            self.records.append(record)

    def flush(self):
        pass

    def close(self):
        pass


def c2k_model(torch, dev, fused: bool, dtype="float32"):
    """GPT-125M at full width and depth, the generate workload's seeded
    weights (convert.GENERATE_SEED), the fused block or the flash
    attention; eval."""
    from paddle_tpu_torch.convert import (GENERATE_SEED, load_jax_state,
                                          random_state)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_125m
    cfg = gpt_125m(dtype=dtype, use_fused_block=fused,
                   use_pallas_attention=True, hidden_dropout=0.0,
                   attention_dropout=0.0, max_position_embeddings=1024)
    model = GPTForCausalLM(cfg, device=dev)
    load_jax_state(model, random_state(model, GENERATE_SEED))
    return model.eval()


def c2k_ids(np, batch: int, seed: int):
    return np.random.default_rng(seed).integers(
        0, 50304, (batch, C2K_SEQ)).astype(np.int32)


def c2k_digest(np, a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def c2k_child(spec):
    """The artifact in a fresh process: ``create_predictor(Config(path))``
    (jit.load registers the kernels' ops before ``torch.export.load``),
    a warm run, then ``C2K_TIMED`` timed runs per batch; each batch's
    launches in one run, the full logits' sha256 and the logits at
    ``C2K_POSITIONS`` (saved beside the artifact)."""
    import numpy as np
    import torch
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.inference import Config, create_predictor
    t0 = time.perf_counter()
    pred = create_predictor(Config(spec["path"]))
    out = {"load_s": time.perf_counter() - t0, "runs": {}}
    targets = {str(n.target) for n in pred._layer.program.graph.nodes
               if n.op == "call_function"}
    out["ops"] = sorted(t for t in targets if t.startswith("ptpu."))
    ids = np.load(spec["ids"])
    for b in spec["batches"]:
        handle = pred.get_input_handle("input_ids")
        handle.copy_from_cpu(ids[:b])
        pred.run()                                  # warm
        torch.cuda.synchronize()
        _kernels.reset_launches()
        pred.run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in _kernels.launches.items() if v}
        ms = []
        for _ in range(C2K_TIMED):
            t1 = time.perf_counter()
            pred.run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        logits = pred.get_output_handle("output_0").copy_to_cpu()
        np.save(os.path.join(spec["out"], f"logits_{b}.npy"),
                logits[:, list(C2K_POSITIONS)])
        out["runs"][b] = {"launches": launches, "ms": ms,
                          "sha256": c2k_digest(np, logits),
                          "finite": bool(np.isfinite(logits).all())}
    print(json.dumps({"c2k_child": out}), flush=True)
    return 0


def c2k_gpt_artifact(torch, np, dev, _kernels, root):
    """(1) GPT-125M, fused block, float32: jit.save, then the predictor in
    a child process at batches 1, 4, 8 against the eager model on the card
    (bit for bit) and the float64 plain route on the CPU (row 0 within the
    serving phases' float32 bound); launches per Predictor.run."""
    from paddle_tpu_torch import jit
    model = c2k_model(torch, dev, fused=True)
    path = os.path.join(root, "build", "c2k", "gpt125m")
    os.makedirs(path, exist_ok=True)
    ids = c2k_ids(np, max(C2K_BATCHES), SEED + 26)
    np.save(os.path.join(path, "ids.npy"), ids)
    t0 = time.perf_counter()
    jit.save(model, path, [jit.InputSpec([None, C2K_SEQ], "int32",
                                         name="input_ids")])
    save_s = time.perf_counter() - t0
    sizes = {"model.pt2": os.path.getsize(os.path.join(path, "model.pt2")),
             "params": sum(os.path.getsize(os.path.join(d, f))
                           for d, _, fs in os.walk(os.path.join(path,
                                                                "params"))
                           for f in fs)}
    child = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py"), "--c2k-child",
         json.dumps({"path": path, "ids": os.path.join(path, "ids.npy"),
                     "batches": list(C2K_BATCHES), "out": path})],
        capture_output=True, text=True, timeout=600)
    require(child.returncode == 0,
            f"c2k child failed ({child.returncode}): {child.stderr[-3000:]}")
    res = json.loads([l for l in child.stdout.splitlines()
                      if l.startswith('{"c2k_child"')][-1])["c2k_child"]
    require(sorted(res["ops"]) == sorted(
        f"{op.replace('::', '.')}.default"
        for op in ("ptpu::ln_linear", "ptpu::linear_residual", "ptpu::ffn",
                   "ptpu::flash_fwd")),
            f"the exported graph's registered ops: {res['ops']}")
    runs = {}
    for b in C2K_BATCHES:
        r = res["runs"][str(b)]
        require(r["finite"], f"batch {b}: non-finite artifact logits")
        want = {k: C2K_LAYERS for k in C2K_KERNELS}
        require(r["launches"] == want,
                f"batch {b}: launches per Predictor.run {r['launches']}, "
                f"expected {want}")
        x = torch.from_numpy(ids[:b]).to(dev)
        with torch.no_grad():
            eager = model(x)
            eager_ms = wall_ms(torch, lambda: model(x), C2K_TIMED)
        eager_np = eager.cpu().numpy()
        got = np.load(os.path.join(path, f"logits_{b}.npy"))
        err = float(np.abs(got - eager_np[:, list(C2K_POSITIONS)]).max())
        same = r["sha256"] == c2k_digest(np, eager_np)
        # the same kernels on the same inputs: bit for bit
        require(same and err == 0.0,
                f"batch {b}: artifact logits differ from the eager model "
                f"(max_abs_err {err:.3e} at the sampled positions)")
        runs[b] = {"run_ms_p50": statistics.median(r["ms"]),
                   "eager_ms_p50": eager_ms,
                   "launches": r["launches"], "bit_identical": same}
        if b == 1:
            row0 = got[0]
    del model, eager
    torch.cuda.empty_cache()
    # the float64 plain route: the unfused model (SDPA keeps float64) on
    # the CPU with the same weights
    ref = c2k_model(torch, "cpu", fused=False).double()
    ref.config.use_pallas_attention = False
    with torch.no_grad():
        f64 = ref(torch.from_numpy(ids[:1]))[0, list(C2K_POSITIONS)].numpy()
    err64 = float(np.abs(row0 - f64).max())
    require(err64 <= C2K_F32_TOL,
            f"artifact vs float64 plain route: {err64:.3e} > {C2K_F32_TOL}")
    line = {"save_s": save_s, "load_s": res["load_s"], "bytes": sizes,
            "runs": runs, "max_abs_err_f64": err64, "ops": res["ops"]}
    for b, r in runs.items():
        log(f"c2k (1) batch {b}: Predictor.run {r['run_ms_p50']:.3f} ms "
            f"(eager forward {r['eager_ms_p50']:.3f} ms), bit-identical to "
            f"eager, launches {r['launches']}")
    log(f"c2k (1) save {save_s:.2f} s, load {res['load_s']:.2f} s (child), "
        f"model.pt2 {sizes['model.pt2']} B, params/ {sizes['params']} B; "
        f"row 0 vs float64 plain route {err64:.3e} <= {C2K_F32_TOL}")
    return line


def c2k_exact(torch, layer, x):
    """The int32 accumulation of ``layer`` (an Int8Linear / Int8Conv2D) on
    ``x`` on the card and on a CPU copy: must be equal."""
    import copy
    card = layer.accumulate(x)
    cpu = copy.deepcopy(layer).cpu().accumulate(x.cpu())
    require(card.dtype == torch.int32 and torch.equal(card.cpu(), cpu),
            f"{type(layer).__name__}: int32 accumulation differs from the "
            f"CPU's by {int((card.cpu() - cpu).abs().max())}")
    return list(card.shape)


def c2k_ptq_gpt(torch, np, dev, root):
    """(2) PTQ of the unfused GPT-125M's linears: 4 seeded calibration
    batches of (8, 512), Int8Linear, eager and through an artifact; each
    linear shape's int32 accumulation equal to the CPU's."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import quantization as Q
    model = c2k_model(torch, dev, fused=False)
    n_cal, b = C2K_CAL["gpt"]
    x = torch.from_numpy(c2k_ids(np, b, SEED + 27)).to(dev)
    with torch.no_grad():
        want = model(x)
    with torch.no_grad():
        f32_ms = wall_ms(torch, lambda: model(x))
    Q.PostTrainingQuantization().quantize(
        model, [torch.from_numpy(c2k_ids(np, b, SEED + 28 + i)).to(dev)
                for i in range(n_cal)])
    Q.PostTrainingQuantization().convert(model)
    int8 = [m for m in model.modules() if isinstance(m, Q.Int8Linear)]
    require(len(int8) == 4 * C2K_LAYERS, f"{len(int8)} Int8Linear layers")
    with torch.no_grad():
        got = model(x)
    require(bool(torch.isfinite(got).all()), "int8 GPT: non-finite logits")
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    with torch.no_grad():
        int8_ms = wall_ms(torch, lambda: model(x))
    rng = np.random.default_rng(SEED + 29)
    shapes = {}
    h = model.gpt.h[0]
    for name, layer in (("qkv", h.attn.qkv_proj), ("out", h.attn.out_proj),
                        ("fc_in", h.mlp.fc_in), ("fc_out", h.mlp.fc_out)):
        k = layer.qweight.shape[0]
        xin = torch.from_numpy(rng.standard_normal((b * C2K_SEQ, k))
                               .astype(np.float32)).to(dev)
        shapes[name] = c2k_exact(torch, layer, xin)
    path = os.path.join(root, "build", "c2k", "gpt125m_int8")
    jit.save(model, path, [jit.InputSpec([None, C2K_SEQ], "int32",
                                         name="input_ids")])
    loaded = jit.load(path)
    art = loaded(x[:2])
    err = float((art - got[:2]).abs().max())
    require(err == 0.0, f"int8 artifact differs from eager by {err:.3e}")
    line = {"top1_agreement": agree, "int8_ms": int8_ms, "f32_ms": f32_ms,
            "exact_shapes": shapes, "artifact_bit_identical": True}
    log(f"c2k (2) GPT-125M PTQ: {len(int8)} Int8Linear, int32 accumulation "
        f"= CPU for {shapes}; top-1 agreement with float32 {agree:.4f}; "
        f"forward B={b} S={C2K_SEQ} int8 {int8_ms:.3f} ms vs float32 "
        f"{f32_ms:.3f} ms; artifact = eager")
    return line


def c2k_ptq_resnet(torch, np, dev):
    """(3) PTQ of ResNet-50 (NCHW, float32, B=16, 224^2, 2 calibration
    batches) with Int8Conv2D; the 7x7 stem's and a 3x3 conv's int32
    accumulation equal to the CPU's."""
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.vision.models import resnet50
    fw_random.seed(SEED)
    model = resnet50(device=dev).eval()
    n_cal, b = C2K_CAL["resnet"]
    rng = np.random.RandomState(SEED + 30)

    def images(n):
        return torch.from_numpy((rng.randn(n, 3, 224, 224) * 0.5)
                                .astype(np.float32)).to(dev)
    x = images(b)
    with torch.no_grad():
        want = model(x)
    with torch.no_grad():
        f32_ms = wall_ms(torch, lambda: model(x))
    ptq = Q.PostTrainingQuantization()
    ptq.quantize(model, [images(b) for _ in range(n_cal)])
    ptq.convert(model)
    convs = [m for m in model.modules() if isinstance(m, Q.Int8Conv2D)]
    with torch.no_grad():
        got = model(x)
    require(bool(torch.isfinite(got).all()), "int8 ResNet-50: non-finite")
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    with torch.no_grad():
        int8_ms = wall_ms(torch, lambda: model(x))
    stem = c2k_exact(torch, model.conv1, x[:2])
    mid = torch.from_numpy(rng.randn(2, 64, 56, 56).astype(np.float32))
    conv3 = c2k_exact(torch, model.layer1[0].conv2, mid.to(dev))
    line = {"int8_convs": len(convs), "top1_agreement": agree,
            "int8_ms": int8_ms, "f32_ms": f32_ms,
            "exact": {"stem_7x7": stem, "layer1.0.conv2_3x3": conv3}}
    log(f"c2k (3) ResNet-50 PTQ: {len(convs)} Int8Conv2D (unfold + int8 "
        f"GEMM), int32 accumulation = CPU on the stem {stem} and a 3x3 "
        f"{conv3}; top-1 agreement {agree:.4f}; B={b} int8 {int8_ms:.3f} ms "
        f"vs float32 {f32_ms:.3f} ms")
    return line


def c2k_static(torch, np, dev, root):
    """(4) a LeNet-shaped static program (conv2d, batch_norm, fc) on (64,
    1, 28, 28): save_inference_model -> load_inference_model ->
    Executor.run on the card equal to the program's own eval run."""
    import paddle_tpu_torch.static as st
    from paddle_tpu_torch.framework import random as fw_random
    fw_random.seed(SEED)

    def lenet(x):
        h = st.nn.conv2d(x, 6, 5, padding=2, act="relu")
        h = st.nn.batch_norm(h)
        h = st.nn.conv2d(h, 16, 5, stride=2, act="relu")
        h = st.nn.fc(h, 120, activation="relu")
        return {"logits": st.nn.fc(st.nn.fc(h, 84, activation="relu"), 10)}
    prog = st.Program("lenet").set_fn(lenet)
    exe = st.Executor(st.cuda_places()[0])
    x = np.random.RandomState(SEED + 31).randn(64, 1, 28, 28).astype(
        np.float32)
    exe.run(prog, feed={"x": x})                  # builds the layers
    want = exe.run(prog.clone(for_test=True), feed={"x": x})[0]
    path = os.path.join(root, "build", "c2k", "lenet_static")
    st.save_inference_model(path, [st.data("x", [None, 1, 28, 28])],
                            None, exe, program=prog)
    loaded, feeds, _ = st.load_inference_model(path, exe)
    require(feeds == ["x"], f"feed names {feeds}")
    got = exe.run(loaded, feed={"x": x})[0]
    err = float(np.abs(got - want).max())
    require(err <= 1e-5 * max(1.0, float(np.abs(want).max())),
            f"static program artifact differs by {err:.3e}")
    log(f"c2k (4) static LeNet program (64, 1, 28, 28): artifact vs the "
        f"program's eval run max_abs_err {err:.3e} (slots "
        f"{sorted(prog._nn_layers)})")
    return {"max_abs_err": err, "slots": sorted(prog._nn_layers)}


def c2k_tracker(torch, np, dev, _kernels, built):
    """(5) every library compiled in phase a has a compile record (or, on
    a warm cache, every wanted library was a hit); generate at three batch
    sizes: three captures, two retraces naming ``batch``; /statusz's
    compile filled."""
    from paddle_tpu_torch.observability import compilation, monitor
    from paddle_tpu_torch.observability.registry import get_registry
    tr = compilation.get_tracker()
    for name in built["compiled"]:
        st = tr.stats(f"kernels.{name}")
        require(st["traces"] >= 1, f"no compile record for {name}: {st}")
    snap = get_registry().snapshot()
    hits = snap.get("compile.persistent_cache_hits", {}).get("value", 0)
    wanted = snap.get("compile.persistent_cache_requests",
                      {}).get("value", 0)
    require(len(built["compiled"]) + hits >= len(_kernels.KERNELS),
            f"build records: compiled {built['compiled']}, hits {hits}")
    model = c2k_model(torch, dev, fused=True)
    compilation.reset_tracker()
    sink = get_registry().add_sink(_Records(("compile",)))
    try:
        prompts = torch.from_numpy(c2k_ids(np, max(C2K_GEN_BATCHES),
                                           SEED + 32)[:, :16]).to(dev)
        for b in C2K_GEN_BATCHES:
            model.generate(prompts[:b], max_new_tokens=8)   # capacity 24
    finally:
        get_registry().remove_sink(sink)
    st = tr.stats("generate.decode_step")
    require(st["traces"] == 3 and st["retraces"] == 2,
            f"generate captures: {st}")
    recs = [r for r in sink.records
            if r.get("function") == "generate.decode_step"]
    changed = [[c["arg"] for c in r["changed"]] for r in recs
               if r["retrace"]]
    require(changed == [["batch"], ["batch"]],
            f"retrace diffs name {changed}")
    page = monitor.StatusServer(registry=get_registry()).statusz()
    require(page["compile"] is not None, "/statusz compile is None")
    line = {"compiled": built["compiled"], "cache_hits": hits,
            "cache_requests": wanted, "generate": st,
            "diffs": [r["changed"] for r in recs if r["retrace"]],
            "statusz_compile": page["compile"]}
    log(f"c2k (5) tracker: {len(built['compiled'])} library compiles "
        f"recorded, cache hits {hits} of {wanted}; generate at batches "
        f"{C2K_GEN_BATCHES}: {st}, diffs {line['diffs']}; /statusz compile "
        f"{page['compile']}")
    return line


def deploy(torch, np, dev, _kernels, root, built):
    """(c2k): (1) the GPT-125M artifact through the predictor in a child
    process, (2) PTQ of GPT-125M, (3) PTQ of ResNet-50, (4) a static
    program's inference model, (5) the compile tracker."""
    import shutil
    t_phase = time.perf_counter()
    parts, line = {}, {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t0
        log(f"c2k {name}: {parts[name]:.1f} s")
        torch.cuda.empty_cache()
        return out
    line["tracker"] = part("tracker", lambda: c2k_tracker(torch, np, dev,
                                                          _kernels, built))
    line["gpt"] = part("gpt", lambda: c2k_gpt_artifact(torch, np, dev,
                                                       _kernels, root))
    line["ptq_gpt"] = part("ptq_gpt", lambda: c2k_ptq_gpt(torch, np, dev,
                                                          root))
    line["ptq_resnet"] = part("ptq_resnet",
                              lambda: c2k_ptq_resnet(torch, np, dev))
    line["static"] = part("static", lambda: c2k_static(torch, np, dev, root))
    shutil.rmtree(os.path.join(root, "build", "c2k"), ignore_errors=True)
    line.update({"parts_s": parts, "phase_s": time.perf_counter() - t_phase})
    log(json.dumps({"deploy": line}, default=str))
    return line


# ---------------------------------------------------------------------------
# (c2l) the long tail
# ---------------------------------------------------------------------------
C2L_B, C2L_S = 8, 2048          # convert.training_workload's batch
C2L_ASP_STEPS, C2L_LA_STEPS, C2L_MA_STEPS, C2L_LAMB_STEPS = 5, 10, 10, 5
C2L_LA_K, C2L_LA_ALPHA = 5, 0.5
C2L_MA = dict(average_window_rate=0.5, min_average_window=2,
              max_average_window=4)
C2L_DECODES = 8                 # profiled decode steps of the serving engine
C2L_PROFILED_TRAIN = 2          # profiled training steps
C2L_OPENER_ROWS = 128           # the K1 launch that opens the window
C2L_OPENER_WIDTHS = (768, 2304)  # GPT-125M's LN -> qkv: h, 3 h
C2L_COST_RUNS, C2L_COST_DECODES = 4, 32   # pairs of runs, decodes a run
C2L_EDGE_WINDOWS = 8            # short windows per tracer, edges probed
C2L_LOADER_BATCHES = 4          # Model.fit steps over the ring
C2L_LOADER_TIMED = 400          # batches a transport is timed over
C2L_LOADER_MADE = 50            # batches made in the main process, timed
C2L_VOCAB, C2L_WORDS = 30522, 100_000
C2L_DRAWS = 1_000_000
C2L_SPARSE_N, C2L_SPARSE_DENSITY, C2L_SPARSE_D = 4096, 0.01, 768
C2L_ATTN_D = 64
# float32 on the card against float64 on the CPU: lgamma / digamma and
# the sums are float32, ~1e-6 of a value; a wrong formula is off by far more
C2L_DIST_TOL = 2e-5
# sparse products in float32 against float64 (inner sums of 41-768 terms,
# no TF32): within 1e-5 of the result's range
C2L_SPARSE_TOL = 1e-5
# a float32 LAMB step against float64 (the trust ratios' norms summed in
# float32 over up to 38.6M elements): within 1e-5 of each weight's range
C2L_LAMB_TOL = 1e-5
# ModelAverage's float32 streaming sum against the float64 replay of the
# same recurrence over the same snapshots
C2L_MA_TOL = 1e-5
C2L_EXCLUDED = ["gpt.wte", "gpt.wpe"]     # ASP: the two embeddings
# the kernel counter -> a substring of the __global__ function that each of
# its counted launches runs once (ffn_tiled's up and down passes, ffn_stream
# and its finalize kernel: the first of each pair)
C2L_TRACE_NAMES = {
    "paged_decode": "paged_decode_kernel",
    "ln_linear": "ln_linear_kernel",
    "ln_linear_mma": "ln_linear_mma_kernel",
    "ln_linear_stream": "ln_linear_stream_kernel",
    "ln_linear_tiled": "ln_linear_tiled_kernel",
    "linear_residual": "linear_residual_kernel",
    "linear_residual_mma": "linear_residual_mma_kernel",
    "linear_residual_stream": "linear_residual_stream_kernel",
    "linear_residual_tiled": "linear_residual_tiled_kernel",
    "ffn": "ffn_kernel",
    "ffn_mma": "ffn_mma_kernel",
    "ffn_stream": "ffn_stream_kernel",
    "ffn_tiled": "ffn_tiled_up_kernel",
    "flash_fwd": "flash_fwd_",
    "flash_dkdv": "flash_dkdv_",
    "flash_dq": "flash_dq_",
    "flash_decode": "flash_decode_kernel",
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def c2l_flash(launches, steps, layers):
    """The three flash training kernels launched once a layer a step and
    nothing else of the eight but them."""
    for name in TRAINING_KERNELS:
        require(launches[name] == layers * steps,
                f"{name}: {launches[name]} launches in {steps} steps, not "
                f"{layers} a step")
    other = {n: c for n, c in launches.items()
             if c and n not in TRAINING_KERNELS}
    require(not other, f"training steps launched {other}")
    return {n: launches[n] for n in TRAINING_KERNELS}


def c2l_workload(dev):
    from paddle_tpu_torch.convert import training_workload
    return training_workload(dev, None, batch=C2L_B, seq_len=C2L_S)


def c2l_steps(torch, _kernels, model, opt, ids, labels, n):
    """``n`` train_steps with the counters zeroed just before them; the
    losses (each finite) and the launches."""
    from paddle_tpu_torch.training import train_step
    _kernels.reset_launches()
    losses = [float(train_step(model, opt, ids, labels)) for _ in range(n)]
    launches = dict(_kernels.launches)
    require(all(math.isfinite(x) for x in losses),
            f"a loss is not finite: {losses}")
    return losses, launches


def c2l_asp(torch, np, dev, _kernels, model, ids, labels):
    """(1) ASP: the embeddings excluded, every other weight pruned 2:4
    (mask_1d), C2L_ASP_STEPS steps under the decorated AdamW; the pattern
    kept, three masks recomputed on the host bit for bit."""
    from paddle_tpu_torch.incubate import sparsity
    from paddle_tpu_torch.optimizer import AdamW
    sparsity.reset_excluded_layers()
    sparsity.reset_masks()
    sparsity.set_excluded_layers(C2L_EXCLUDED)
    named = dict(model.named_parameters())
    picked = [n for n in named if n.endswith("qkv_proj.weight")][:1] + \
        [n for n in named if n.endswith("fc1.weight")][:1] + \
        [n for n in named if n.endswith("out_proj.weight")][-1:]
    host = {n: named[n].detach().float().cpu().numpy() for n in picked}
    t0 = time.perf_counter()
    masks = sparsity.prune_model(model, 2, 4, "mask_1d")
    prune_s = time.perf_counter() - t0
    require(set(picked) <= set(masks) and not any(
        n.startswith(tuple(C2L_EXCLUDED)) for n in masks),
        f"pruned set: {sorted(masks)}")
    for n in picked:
        again = sparsity.create_mask(host[n], sparsity.MaskAlgo.MASK_1D, 2, 4)
        require(again.dtype == masks[n].dtype
                and np.array_equal(again, masks[n]),
                f"{n}: the host mask differs from prune_model's")
    zero0 = {n: named[n] == 0 for n in masks}
    for n, m in masks.items():
        want = torch.from_numpy(m == 0).to(dev)
        require(torch.equal(zero0[n], want), f"{n}: step-0 zeros != mask")
    opt = sparsity.decorate(AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=model.named_parameters()))
    losses, launches = c2l_steps(torch, _kernels, model, opt, ids, labels,
                                 C2L_ASP_STEPS)
    flash = c2l_flash(launches, C2L_ASP_STEPS,
                      model.config.num_layers)
    for n in masks:
        require(torch.equal(named[n] == 0, zero0[n]),
                f"{n}: the zero pattern moved in training")
        require(sparsity.check_sparsity(named[n], n=2, m=4),
                f"{n}: not 2:4 after training")
    for n in picked:   # the trained weights give the same masks again
        require(np.array_equal(sparsity.create_mask(
            named[n], sparsity.MaskAlgo.MASK_1D, 2, 4), masks[n]),
            f"{n}: the trained weight's mask differs")
    density = float(np.mean([sparsity.calculate_density(masks[n])
                             for n in picked]))
    sparsity.reset_masks()
    sparsity.reset_excluded_layers()
    return {"pruned": len(masks), "prune_s": prune_s, "losses": losses,
            "launches": flash, "density": density}


def c2l_lookahead(torch, np, _kernels, model, ids, labels):
    """(2a) LookAhead over AdamW: at each k-th step the slow weights are
    slow + alpha (fast - slow) of snapshots taken around the inner step,
    and the fast weights equal them, bit for bit."""
    from paddle_tpu_torch.incubate import LookAhead
    from paddle_tpu_torch.optimizer import AdamW
    la = LookAhead(AdamW(learning_rate=1e-4, weight_decay=0.01,
                         parameters=model.named_parameters()),
                   alpha=C2L_LA_ALPHA, k=C2L_LA_K)
    inner_step = la.inner.step
    snaps = {}

    def spy(*a, **kw):
        inner_step(*a, **kw)
        if la.step_count + 1 == snaps.get("at"):
            snaps["fast"] = {n: p.detach().float().clone()
                             for n, p in zip(la.inner._names,
                                             la.inner._params)}

    la.inner.step = spy
    checked = []

    def before(i):
        if i % C2L_LA_K == 0:
            snaps["at"] = i
            snaps["slow"] = ({n: s.clone() for n, s in la.slow.items()}
                             if la.slow is not None else None)

    def check(i):
        slow0 = snaps["slow"]
        for n, p in zip(la.inner._names, la.inner._params):
            want = slow0[n] + C2L_LA_ALPHA * (snaps["fast"][n] - slow0[n])
            require(torch.equal(la.slow[n], want),
                    f"LookAhead step {i}: slow {n} is not the blend")
            require(torch.equal(p.detach(), la.slow[n].to(p.dtype)),
                    f"LookAhead step {i}: fast {n} != slow")
        checked.append(i)

    losses = []
    _kernels.reset_launches()
    for i in range(1, C2L_LA_STEPS + 1):
        from paddle_tpu_torch.training import train_step
        before(i)
        losses.append(float(train_step(model, la, ids, labels)))
        if i % C2L_LA_K == 0:
            check(i)
    launches = dict(_kernels.launches)
    require(all(np.isfinite(losses)), f"LookAhead losses {losses}")
    require(checked == list(range(C2L_LA_K, C2L_LA_STEPS + 1, C2L_LA_K)),
            f"LookAhead syncs checked at {checked}")
    return {"losses": losses, "synced_at": checked,
            "launches": c2l_flash(launches, C2L_LA_STEPS,
                                  model.config.num_layers)}


def c2l_model_average(torch, np, _kernels, model, ids, labels):
    """(2b) ModelAverage over AdamW: average() against the float64 replay
    of the growing-window recurrence over the weights after each step;
    apply() swaps it in and restore gives back the exact weights."""
    from paddle_tpu_torch.incubate import ModelAverage
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.training import train_step
    ma = ModelAverage(AdamW(learning_rate=1e-4, weight_decay=0.01,
                            parameters=model.named_parameters()), **C2L_MA)
    names, params = ma.inner._names, ma.inner._params
    ref = {n: torch.zeros_like(p, dtype=torch.float64)
           for n, p in zip(names, params)}
    losses = []
    _kernels.reset_launches()
    for t in range(1, C2L_MA_STEPS + 1):
        losses.append(float(train_step(model, ma, ids, labels)))
        w = min(max(np.ceil(C2L_MA["average_window_rate"] * t),
                    C2L_MA["min_average_window"]),
                C2L_MA["max_average_window"])
        keep = 1.0 - 1.0 / w if t > w else 1.0
        for n, p in zip(names, params):
            ref[n].mul_(keep).add_(p.detach().double())
    launches = dict(_kernels.launches)
    require(all(np.isfinite(losses)), f"ModelAverage losses {losses}")
    t = C2L_MA_STEPS
    w = min(max(np.ceil(C2L_MA["average_window_rate"] * t),
                C2L_MA["min_average_window"]),
            C2L_MA["max_average_window"])
    eff = max(min(t, w), 1.0)
    avg = ma.average()
    worst = 0.0
    for n in names:
        want = ref[n] / eff
        err = float((avg[n].double() - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        worst = max(worst, err / scale)
    require(worst <= C2L_MA_TOL,
            f"ModelAverage: average() {worst:.3e} of a range from the "
            f"float64 replay (> {C2L_MA_TOL})")
    trained = {n: p.detach().clone() for n, p in zip(names, params)}
    with ma.apply():
        for n, p in zip(names, params):
            require(torch.equal(p.detach(), avg[n]),
                    f"ModelAverage.apply: {n} is not the average")
    for n, p in zip(names, params):
        require(torch.equal(p.detach(), trained[n]),
                f"ModelAverage: restore did not give back {n}")
    return {"losses": losses, "window": float(w), "max_rel_err": worst,
            "launches": c2l_flash(launches, C2L_MA_STEPS,
                                  model.config.num_layers)}


def lamb64(torch, w, m, v, g, t, lr, b1, b2, eps, wd, decay):
    """One float64 LAMB step of one parameter (the plain rule)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    upd = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
    if decay:
        upd = upd + wd * w
    pn, un = float(w.norm()), float(upd.norm())
    ratio = pn / un if pn > 0 and un > 0 else 1.0
    return w - lr * ratio * upd, m, v


def c2l_lamb(torch, np, _kernels, model, ids, labels):
    """(2c) DistributedFusedLamb on one card (one flat float32 master,
    trust ratio per segment, global-norm clip, decay excluded from biases
    and norms): every step against a float64 plain LAMB on the same
    (clipped) gradients from the same state."""
    from paddle_tpu_torch.incubate.optimizer import DistributedFusedLamb
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm
    from paddle_tpu_torch.training import train_step

    def excluded(name):
        return name.endswith(".bias") or ".ln_" in name or "ln_f" in name

    kw = dict(learning_rate=1e-3, lamb_weight_decay=0.01, beta1=0.9,
              beta2=0.999, epsilon=1e-6)
    lamb = DistributedFusedLamb(
        parameters=model.named_parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0),
        exclude_from_weight_decay_fn=excluded, **kw)
    step_impl = lamb.step
    worst = [0.0]
    sizes = [p.numel() for p in lamb._params]

    def checked_step(grads=None):
        st = lamb._state
        if st is not None:
            offs = np.cumsum([0] + sizes)
            w0 = [st["master"][a:b].double().clone()
                  for a, b in zip(offs, offs[1:])]
            m0 = [st["moment1"][a:b].double().clone()
                  for a, b in zip(offs, offs[1:])]
            v0 = [st["moment2"][a:b].double().clone()
                  for a, b in zip(offs, offs[1:])]
            t = int(st["step"]) + 1
        else:
            w0 = [p.detach().double().reshape(-1).clone()
                  for p in lamb._params]
            m0 = [torch.zeros_like(w) for w in w0]
            v0 = [torch.zeros_like(w) for w in w0]
            t = 1
        g = [p.grad.double().reshape(-1) for p in lamb._params]
        gnorm = float(torch.sqrt(sum((x * x).sum() for x in g)))
        g = [x * min(1.0, 1.0 / max(gnorm, 1e-12)) for x in g]
        step_impl(grads)
        offs = np.cumsum([0] + sizes)
        master = lamb._state["master"]
        for a, b, name, w, m, v, gg in zip(offs, offs[1:], lamb._names, w0,
                                           m0, v0, g):
            want, _, _ = lamb64(torch, w, m, v, gg, t, kw["learning_rate"],
                                kw["beta1"], kw["beta2"], kw["epsilon"],
                                kw["lamb_weight_decay"], not excluded(name))
            err = float((master[a:b].double() - want).abs().max())
            worst[0] = max(worst[0], err / max(float(want.abs().max()),
                                               1e-30))
        for p, a, b in zip(lamb._params, offs, offs[1:]):
            require(torch.equal(p.detach().reshape(-1),
                                master[a:b].to(p.dtype)),
                    "LAMB: a parameter is not its master segment")

    lamb.step = checked_step
    losses = []
    _kernels.reset_launches()
    for _ in range(C2L_LAMB_STEPS):
        losses.append(float(train_step(model, lamb, ids, labels)))
    launches = dict(_kernels.launches)
    require(all(np.isfinite(losses)), f"LAMB losses {losses}")
    require(worst[0] <= C2L_LAMB_TOL,
            f"DistributedFusedLamb: {worst[0]:.3e} of a range from the "
            f"float64 LAMB (> {C2L_LAMB_TOL})")
    require(int(lamb._state["step"]) == C2L_LAMB_STEPS, "LAMB step count")
    return {"losses": losses, "max_rel_err": worst[0],
            "flat_elements": int(lamb._state["master"].numel()),
            "launches": c2l_flash(launches, C2L_LAMB_STEPS,
                                  model.config.num_layers)}


def c2l_trace_kernels(trace):
    """Kernel events of a chrome trace: counts and device us by counter
    name (C2L_TRACE_NAMES), and the unmatched kernels' total."""
    counts, dur, other = {}, {}, 0
    for e in trace.get("traceEvents", []):
        if str(e.get("cat", "")).lower() != "kernel":
            continue
        name = e.get("name", "")
        hit = [k for k, sub in C2L_TRACE_NAMES.items() if sub in name]
        if not hit:
            other += 1
            continue
        key = max(hit, key=lambda k: len(C2L_TRACE_NAMES[k]))   # longest
        counts[key] = counts.get(key, 0) + 1
        dur[key] = dur.get(key, 0.0) + float(e.get("dur", 0.0))
    return counts, dur, other


def c2l_profiler(torch, np, dev, _kernels, work, train):
    """(3) the profiler over the fused float32 serving engine (a prefill
    through the tiled K1-K3, C2L_DECODES decode steps through paged decode
    and the stream K1-K3) and C2L_PROFILED_TRAIN training steps (the flash
    kernels), one window of make_scheduler; its chrome trace read back:
    every kernel the counters saw, as often and with device time; the
    RecordEvent ranges; the summary; the decode step's ms with and without
    the profiler."""
    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.convert import SERVING_ENGINE, serving_workload
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.training import train_step
    model, prompts = serving_workload(dev, dtype="float32")
    t_model, t_opt, ids, labels = train

    def engine(decodes=C2L_DECODES):
        eng = ServingEngine(model, **SERVING_ENGINE)
        for p in prompts:
            eng.submit(p, max_new_tokens=decodes + 1)
        return eng

    def steps(eng, after=None):
        """Every engine step to the end: (kind, host ms) each."""
        out = []
        while eng.has_work():
            before = {k: len(v) for k, v in eng._step_ms.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with P.RecordEvent("c2l_serve_step"):
                eng.step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            kind = [k for k, v in eng._step_ms.items()
                    if len(v) > before.get(k, 0)]
            out.append((kind[0] if kind else "idle", ms))
            if after is not None:
                after()
        return out

    steps(engine())                                   # warm
    plain = steps(engine())
    n_steps = len(plain)
    decodes = [ms for k, ms in plain if k == "decode"]
    require(len(decodes) == C2L_DECODES,
            f"{len(decodes)} decode steps, not {C2L_DECODES}: {plain}")
    out_dir = os.path.join(work, "trace")
    prof = P.Profiler(
        targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU],
        scheduler=P.make_scheduler(closed=1, ready=1,
                                   record=n_steps + C2L_PROFILED_TRAIN,
                                   repeat=1),
        on_trace_ready=P.export_chrome_tracing(out_dir, "c2l"))
    opener = c2l_k1_opener(torch, dev)
    P.profiler_summary(reset=True)
    prof.start()                                      # step 0: closed
    eng = engine()
    prof.step()                                       # step 1: ready
    _kernels.reset_launches()
    prof.step()                                       # recording
    opener()            # the window's first kernel: a counted K1 launch
    steps(eng, after=prof.step)
    for _ in range(C2L_PROFILED_TRAIN):
        with P.RecordEvent("c2l_train_step"):
            loss = float(train_step(t_model, t_opt, ids, labels))
        require(np.isfinite(loss), f"profiled training loss {loss}")
        prof.step()
    prof.stop()
    launches = dict(_kernels.launches)
    require(prof.current_state == P.ProfilerState.CLOSED, "profiler open")
    files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    require(len(files) == 1, f"trace files {files}")
    t0 = time.perf_counter()
    trace = P.load_profiler_result(os.path.join(out_dir, files[0]))
    load_s = time.perf_counter() - t0
    counts, dur, other = c2l_trace_kernels(trace)
    unrecorded = P.unrecorded_launches(trace)
    # the window's first launch on the host timeline (the device clock
    # may place a set-up kernel's record inside the window)
    records = P.launch_records(trace)
    first = (records[0][1] or {}) if records else {}
    if dev.type == "cuda":
        require(C2L_TRACE_NAMES[opener.kernel] in first.get("name", ""),
                f"trace: the window's first launch ran {first.get('name')}, "
                f"not the counted {opener.kernel} launch that opened it")
    seen = {n: c for n, c in launches.items() if c}
    for name, c in seen.items():
        require(counts.get(name, 0) == c,
                f"trace: {name} {counts.get(name, 0)} kernels, the counter "
                f"{c} ({unrecorded} launches of the window have no device "
                "record)")
        require(dur.get(name, 0.0) > 0.0, f"trace: {name} has no device time")
    extra = {n: c for n, c in counts.items() if not launches.get(n)}
    require(not extra, f"trace: kernels the counters did not see: {extra}")
    if dev.type == "cuda":
        for name in ("paged_decode", "ln_linear_stream",
                     "linear_residual_stream", "ffn_stream",
                     "ln_linear_tiled", "linear_residual_tiled", "ffn_tiled",
                     *TRAINING_KERNELS):
            require(seen.get(name, 0) > 0, f"profiled window: no {name}")
    # the host ranges (on the card each also has a gpu_user_annotation
    # twin on the device timeline)
    ranges = [e.get("name") for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"]
    require(ranges.count("c2l_serve_step") == n_steps
            and ranges.count("c2l_train_step") == C2L_PROFILED_TRAIN,
            f"trace: RecordEvent ranges {ranges.count('c2l_serve_step')} / "
            f"{ranges.count('c2l_train_step')}, not {n_steps} / "
            f"{C2L_PROFILED_TRAIN}")
    text = prof.summary()
    require("c2l_serve_step" in text and "c2l_train_step" in text,
            "summary() lacks the ranges")
    log("c2l (3) profiler summary (top lines):")
    for line in text.splitlines()[:12]:
        log("  " + line)
    cost = c2l_profiler_cost(P, engine, steps)
    del model
    return {"launches": seen, "first_kernel": first.get("name"),
            "unrecorded_launches": unrecorded,
            "trace_kernels": counts,
            "trace_device_ms": {n: d / 1e3 for n, d in dur.items()},
            "other_kernels": other, "trace_bytes": os.path.getsize(
                os.path.join(out_dir, files[0])),
            "load_s": load_s, "engine_steps": n_steps, "cost": cost}


def c2l_k1_opener(torch, dev):
    """A call of the tiled K1 wrapper at GPT-125M's first K1 (LN, then the
    qkv projection) on C2L_OPENER_ROWS rows of seeded inputs, made and the
    kernel bound here, so that the call launches nothing but the counted
    kernel."""
    from paddle_tpu_torch.ops import fused_block as fb
    h, cols = C2L_OPENER_WIDTHS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    x, w, b, g, beta = (torch.randn(shape, generator=gen, device=dev)
                        for shape in ((C2L_OPENER_ROWS, h), (h, cols),
                                      (cols,), (h,), (h,)))
    w.mul_(0.02)

    def opener():
        if dev.type == "cuda":
            fb.ln_linear_tiled_cuda(x, w, b, g, beta, 1e-5)

    opener()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    opener.kernel = "ln_linear_tiled"
    return opener


def c2l_child(spec):
    """(3)'s profiled window in a fresh process (``chip_smoke.py
    --c2l-child '<spec>'``) on a fresh training workload: the tracer
    drops more of a window's first device records the longer a process
    has run under load, and the edge probe measures that in the smoke's
    own process."""
    import numpy as np
    import torch
    from paddle_tpu_torch import _kernels
    dev = torch.device("cuda", 0)
    train = c2l_workload(dev)
    out = c2l_profiler(torch, np, dev, _kernels, spec["work"], train)
    print(json.dumps({"c2l_child": out}, default=str), flush=True)
    return 0


def c2l_profiled(torch, np, dev, _kernels, work, root):
    """(3): the profiled window in a child process (:func:`c2l_child`),
    then the edge probe here."""
    from paddle_tpu_torch import profiler as P
    child = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py"), "--c2l-child",
         json.dumps({"work": work})],
        capture_output=True, text=True, timeout=900)
    require(child.returncode == 0,
            f"c2l child failed ({child.returncode}): {child.stderr[-3000:]}")
    lines = child.stdout.splitlines()
    for line in lines:
        if line.startswith("c2l (3)") or line.startswith("  "):
            log(line)
    out = json.loads([line for line in lines
                      if line.startswith('{"c2l_child"')][-1])["c2l_child"]
    out["edges"] = c2l_trace_edges(torch, P, dev, c2l_k1_opener(torch, dev),
                                   work)
    return out


def c2l_trace_edges(torch, P, dev, opener, work):
    """The tracer's dropped device records at a window's opening:
    C2L_EDGE_WINDOWS short windows, each of three counted K1 launches and
    three of torch's own kernels 1 ms apart with nothing before them,
    recorded by torch.profiler.profile alone and by the port's Profiler
    (an empty READY step, so its set-up's own kernels are all that precede
    the window); the windows that lost a record and the launches lost."""
    if dev.type != "cuda":
        return None
    y = torch.zeros(1024, device=dev)

    def body():
        for i in range(6):
            opener() if i % 2 == 0 else y.add_(1.0)
            time.sleep(1e-3)

    def plain(path):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)

    def port(path):
        prof = P.Profiler(scheduler=P.make_scheduler(
            closed=1, ready=1, record=1, repeat=1),
            on_trace_ready=lambda p: p.export(path))
        prof.start()
        prof.step()
        prof.step()
        body()
        prof.step()
        prof.stop()

    out = {}
    for name, run in (("torch_profile", plain), ("port_profiler", port)):
        lost = []
        for i in range(C2L_EDGE_WINDOWS):
            path = os.path.join(work, f"edge_{name}_{i}.json")
            run(path)
            with open(path) as f:
                lost.append(P.unrecorded_launches(json.load(f)))
            os.remove(path)
        out[name] = {"windows": C2L_EDGE_WINDOWS,
                     "windows_with_loss": sum(1 for n in lost if n),
                     "launches_lost": sum(lost),
                     "launches": 6 * C2L_EDGE_WINDOWS}
    return out


def c2l_profiler_cost(P, engine, steps):
    """The profiler's cost a decode step: C2L_COST_RUNS pairs of engine
    runs of C2L_COST_DECODES decode steps, plain then under a recording
    window that holds every step of the run (no export), each run's
    decode-step median; resolved when every profiled run's median lies
    above every plain run's."""
    plain, profiled = [], []
    for _ in range(C2L_COST_RUNS):
        run = steps(engine(C2L_COST_DECODES))
        plain.append(statistics.median(ms for k, ms in run
                                       if k == "decode"))
        prof = P.Profiler(scheduler=P.make_scheduler(
            closed=0, ready=1, record=len(run), repeat=1))
        prof.start()
        eng = engine(C2L_COST_DECODES)
        prof.step()
        run = steps(eng, after=prof.step)
        prof.stop()
        profiled.append(statistics.median(ms for k, ms in run
                                          if k == "decode"))
    return {"decode_ms_runs": plain, "decode_ms_runs_profiled": profiled,
            "decode_ms_p50": statistics.median(plain),
            "decode_ms_p50_profiled": statistics.median(profiled),
            "overhead": statistics.median(profiled)
            / statistics.median(plain) - 1.0,
            "resolved": min(profiled) > max(plain)}


def c2l_token_dataset(np, n, vocab):
    from paddle_tpu_torch.io import Dataset

    class Tokens(Dataset):
        """Seeded (ids, labels, labels) rows of C2L_S tokens."""

        def __len__(self):
            return n

        def __getitem__(self, i):
            r = np.random.RandomState(SEED + 7919 * i)
            ids = r.randint(0, vocab, C2L_S).astype(np.int64)
            labels = r.randint(0, vocab, C2L_S).astype(np.int64)
            return ids, labels, labels

    return Tokens()


def c2l_native_loader(torch, np, dev, _kernels, model):
    """(4) the native shared-memory ring: FLAGS_dataloader_use_native=1, a
    DataLoader with 2 workers and shared memory over seeded token rows
    feeds Model.fit of the training model for C2L_LOADER_BATCHES steps;
    its batches equal the queue transport's byte for byte, the ring's
    counter equals the batches; batches/s of both transports."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.optimizer import AdamW
    prev = os.environ.get("FLAGS_dataloader_use_native")
    os.environ["FLAGS_dataloader_use_native"] = "1"
    try:
        vocab = model.config.vocab_size
        ds = c2l_token_dataset(np, C2L_LOADER_BATCHES * C2L_B, vocab)

        def host_batches(native):
            set_flags({"dataloader_use_native": native})
            dl = DataLoader(ds, batch_size=C2L_B, num_workers=2,
                            use_shared_memory=True, to_device=False)
            return list(dl), dl.ring_batches

        set_flags({"dataloader_use_native": True})
        loader = DataLoader(ds, batch_size=C2L_B, num_workers=2,
                            use_shared_memory=True, places=dev)
        m = Model(model)
        m.prepare(optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=model.named_parameters()),
                  loss=lm_loss, amp_configs="O1")
        _kernels.reset_launches()
        hist = m.fit(loader, epochs=1, verbose=0)
        launches = dict(_kernels.launches)
        require(loader.ring_batches == C2L_LOADER_BATCHES,
                f"fit: {loader.ring_batches} ring batches of "
                f"{C2L_LOADER_BATCHES}")
        losses = [float(x) for x in hist["loss"]]
        require(len(losses) >= 1 and all(np.isfinite(losses)),
                f"fit losses {losses}")
        ring, n_ring = host_batches(True)
        queued, n_queue = host_batches(False)
        require(n_ring == len(ring) == C2L_LOADER_BATCHES and n_queue == 0,
                f"ring {n_ring} / queue {n_queue} batches")
        for a, b in zip(ring, queued):
            for x, y in zip(a, b):
                require(x.dtype == y.dtype and x.shape == y.shape
                        and x.tobytes() == y.tobytes(),
                        "a ring batch differs from the queue's")
        rates = c2l_loader_rates(np, set_flags, DataLoader, vocab)
    finally:
        set_flags({"dataloader_use_native": True})
        if prev is None:
            os.environ.pop("FLAGS_dataloader_use_native", None)
        else:
            os.environ["FLAGS_dataloader_use_native"] = prev
    return {"fit_losses": losses, "ring_batches": loader.ring_batches,
            "launches": c2l_flash(launches, C2L_LOADER_BATCHES,
                                  model.config.num_layers), **rates}


def c2l_loader_rates(np, set_flags, DataLoader, vocab):
    """Each transport's warm batches/s, ring and queue alternated twice:
    C2L_LOADER_TIMED batches over 2 workers, the clock running from the
    first batch's arrival to the last's (the workers' start-up and the
    shutdown outside it; the wait for the first batch reported apart);
    beside them the main process's own ms to make and collate a batch's
    rows, which bounds 2 workers at 2 / that."""
    from paddle_tpu_torch.io import default_collate_fn
    timed = c2l_token_dataset(np, C2L_LOADER_TIMED * C2L_B, vocab)
    rates, first = {}, {}
    for name, native in (("ring", True), ("queue", False),
                         ("ring_again", True), ("queue_again", False)):
        set_flags({"dataloader_use_native": native})
        dl = DataLoader(timed, batch_size=C2L_B, num_workers=2,
                        use_shared_memory=True, to_device=False)
        t0 = time.perf_counter()
        stamps = [time.perf_counter() for _ in dl]
        n = len(stamps)
        require(n == C2L_LOADER_TIMED, f"{name}: {n} batches")
        require(dl.ring_batches == (n if native else 0),
                f"{name}: ring counter {dl.ring_batches} of {n}")
        rates[name] = (n - 1) / (stamps[-1] - stamps[0])
        first[name] = stamps[0] - t0
    make = []
    for i in range(C2L_LOADER_MADE):
        t0 = time.perf_counter()
        default_collate_fn([timed[C2L_B * i + j] for j in range(C2L_B)])
        make.append((time.perf_counter() - t0) * 1e3)
    return {"batches_per_s": rates, "first_batch_s": first,
            "make_batch_ms_p50": statistics.median(make)}


def c2l_vocab_corpus(np):
    """A seeded WordPiece vocabulary of C2L_VOCAB entries and a corpus of
    about C2L_WORDS words (whole words, words with a continuation piece,
    unknown strings, punctuation, capitals)."""
    rng = np.random.RandomState(SEED)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    singles = letters + list("0123456789")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [chr(c) for c in range(33, 127) if not chr(c).isalnum()]
    vocab += singles + ["##" + c for c in singles]
    seen = set(vocab)
    words, pieces = [], []
    while len(vocab) < C2L_VOCAB:
        w = "".join(rng.choice(letters, rng.randint(2, 9)))
        cont = rng.rand() < 0.3
        tok = "##" + w if cont else w
        if tok in seen:
            continue
        seen.add(tok)
        vocab.append(tok)
        (pieces if cont else words).append(w)
    out = []
    for _ in range(C2L_WORDS):
        r = rng.rand()
        if r < 0.6:
            out.append(words[rng.randint(len(words))])
        elif r < 0.85:
            out.append(words[rng.randint(len(words))]
                       + pieces[rng.randint(len(pieces))])
        elif r < 0.93:
            out.append("".join(rng.choice(letters, rng.randint(3, 14)))
                       .capitalize())
        else:
            out.append(words[rng.randint(len(words))]
                       + rng.choice(list(",.!?;:'")))
    lines = [" ".join(out[i:i + 20]) for i in range(0, len(out), 20)]
    return vocab, lines


def c2l_wordpiece(np):
    """(5) WordPiece: the port's native core (built from
    text/_native/wordpiece.c) against its Python path, ids equal; tokens/s
    of both."""
    from paddle_tpu_torch.text import WordPieceTokenizer
    vocab, lines = c2l_vocab_corpus(np)
    t0 = time.perf_counter()
    native = WordPieceTokenizer(vocab, use_native=True)
    build_s = time.perf_counter() - t0
    python = WordPieceTokenizer(vocab, use_native=False)
    require(native.uses_native and not python.uses_native,
            "the native core did not load")
    out, rate = {}, {}
    for name, tok in (("native", native), ("python", python)):
        t0 = time.perf_counter()
        out[name] = tok.encode_batch(lines)
        dt = time.perf_counter() - t0
        rate[name] = sum(len(x) for x in out[name]) / dt
    require(out["native"] == out["python"], "native ids != Python ids")
    n_ids = sum(len(x) for x in out["native"])
    unk = sum(x.count(native.unk_id) for x in out["native"])
    return {"vocab": len(vocab), "words": C2L_WORDS, "ids": n_ids,
            "unk_share": unk / n_ids, "tokens_per_s": rate,
            "build_s": build_s}


def c2l_dist_cases(np, seed):
    """(name, make(D, T), value) of every distribution, the parameters
    drawn once from ``seed`` (``T`` puts an array on a device in a
    dtype)."""
    rng = np.random.RandomState(seed)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)
    probs = u(0.05, 1.0, 64, 7)
    probs /= probs.sum(-1, keepdims=True)
    counts = rng.multinomial(9, [1 / 7] * 7, 64).astype(np.float32)
    nl, ns = u(-2, 2, 4096), u(0.3, 3, 4096)
    ul, uh = u(-3, 0, 4096), u(0.5, 3, 4096)
    logits = u(-3, 3, 512, 50)
    bp = u(0.05, 0.95, 4096)
    ba, bb = u(0.3, 6, 4096), u(0.3, 6, 4096)
    conc = u(0.3, 5, 256, 6)
    il, iscale = u(-1, 1, 64, 32), u(0.5, 2, 64, 32)
    tl, ts, al, asc = (u(-1, 1, 1024), u(0.5, 1, 1024), u(0, 1, 1024),
                       u(1, 2, 1024))
    return [
        ("Normal", lambda D, T: D.Normal(T(nl), T(ns)), u(-4, 4, 4096)),
        ("Uniform", lambda D, T: D.Uniform(T(ul), T(uh)), u(0, 0.45, 4096)),
        ("Categorical", lambda D, T: D.Categorical(T(logits)),
         rng.randint(0, 50, 512)),
        ("Bernoulli", lambda D, T: D.Bernoulli(T(bp)),
         (rng.rand(4096) < 0.5).astype(np.float32)),
        ("Beta", lambda D, T: D.Beta(T(ba), T(bb)), u(0.02, 0.98, 4096)),
        ("Dirichlet", lambda D, T: D.Dirichlet(T(conc)),
         np.full((256, 6), 1 / 6, np.float32)),
        ("Multinomial", lambda D, T: D.Multinomial(9, T(probs)), counts),
        ("Independent", lambda D, T: D.Independent(
            D.Normal(T(il), T(iscale)), 1), u(-2, 2, 64, 32)),
        ("Transformed", lambda D, T: D.TransformedDistribution(
            D.Normal(T(tl), T(ts)),
            [D.ExpTransform(), D.AffineTransform(T(al), T(asc))]),
         u(1.5, 6, 1024)),
    ]


def c2l_distribution(torch, np, dev):
    """(6a) every distribution on the card (float32) against float64 on
    the CPU: log_prob, entropy, the six registered KL pairs; sample moments
    of C2L_DRAWS draws within 4 standard errors."""
    from paddle_tpu_torch import distribution as D

    def close(name, card, ref):
        c, r = card.detach().double().cpu(), ref.detach().double()
        fin = torch.isfinite(r)
        require(torch.equal(torch.isfinite(c), fin), f"{name}: non-finite")
        err = float(((c - r).abs() / (1 + r.abs()))[fin].max()) \
            if bool(fin.any()) else 0.0
        require(err <= C2L_DIST_TOL, f"{name}: {err:.3e} > {C2L_DIST_TOL}")
        return err

    def on(device, dtype):
        return lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)

    errs = {}
    cases = c2l_dist_cases(np, SEED + 3)
    for name, make, value in cases:
        card = make(D, on(dev, torch.float32))
        cpu = make(D, on("cpu", torch.float64))
        ints = name == "Categorical"
        lp = close(f"{name}.log_prob",
                   card.log_prob(torch.as_tensor(value).to(
                       dev, torch.int64 if ints else torch.float32)),
                   cpu.log_prob(torch.as_tensor(value).to(
                       "cpu", torch.int64 if ints else torch.float64)))
        errs[name] = {"log_prob": lp}
        if name != "Transformed":
            errs[name]["entropy"] = close(f"{name}.entropy", card.entropy(),
                                          cpu.entropy())
    # the registered KL pairs: p and q of one family at the parameters of
    # two seeds (Uniform: q's support holding p's, so the value is finite)
    p_cases = {n: mk for n, mk, _ in cases}
    q_cases = {n: mk for n, mk, _ in c2l_dist_cases(np, SEED + 11)}
    for name in ("Normal", "Categorical", "Bernoulli", "Beta", "Dirichlet"):
        errs[name]["kl"] = close(
            f"kl({name})",
            D.kl_divergence(p_cases[name](D, on(dev, torch.float32)),
                            q_cases[name](D, on(dev, torch.float32))),
            D.kl_divergence(p_cases[name](D, on("cpu", torch.float64)),
                            q_cases[name](D, on("cpu", torch.float64))))
    lo = np.random.RandomState(SEED + 5).uniform(-1, 0, 512).astype(
        np.float32)

    def uniform_kl(T):
        return D.kl_divergence(D.Uniform(T(lo), T(lo + 1.0)),
                               D.Uniform(T(lo - 0.5), T(lo + 3.0)))
    errs["Uniform"]["kl"] = close("kl(Uniform)",
                                  uniform_kl(on(dev, torch.float32)),
                                  uniform_kl(on("cpu", torch.float64)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    z = {}

    def moments(name, s, mean, var):
        s = s.double()
        se = torch.sqrt(torch.as_tensor(var, dtype=torch.float64,
                                        device=s.device) / s.shape[0])
        zz = float(((s.mean(0) - torch.as_tensor(
            mean, dtype=torch.float64, device=s.device)).abs() / se).max())
        require(zz < 4.0, f"{name}: sample mean {zz:.2f} standard errors off")
        z[name] = zz

    T = on(dev, torch.float32)
    n = C2L_DRAWS
    moments("Normal", D.Normal(T([0.5, -1.0]), T([1.0, 2.0])).sample(
        (n,), generator=gen), [0.5, -1.0], [1.0, 4.0])
    moments("Uniform", D.Uniform(T([0.0, -2.0]), T([1.0, 4.0])).sample(
        (n,), generator=gen), [0.5, 1.0], [1 / 12, 3.0])
    moments("Bernoulli", D.Bernoulli(T([0.2, 0.7])).sample(
        (n,), generator=gen), [0.2, 0.7], [0.16, 0.21])
    p = np.array([0.1, 0.2, 0.3, 0.4])
    moments("Categorical", torch.nn.functional.one_hot(
        D.Categorical(probs=T(p)).sample((n,), generator=gen), 4),
        p, p * (1 - p))
    a, b = np.array([2.0, 0.5]), np.array([3.0, 0.5])
    moments("Beta", D.Beta(T(a), T(b)).sample((n,), generator=gen),
            a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1)))
    c = np.array([1.0, 2.0, 3.0])
    moments("Dirichlet", D.Dirichlet(T(c)).sample((n,), generator=gen),
            c / 6, c * (6 - c) / (36 * 7))
    q = np.array([0.2, 0.3, 0.5])
    moments("Multinomial", D.Multinomial(10, T(q)).sample(
        (n,), generator=gen), 10 * q, 10 * q * (1 - q))
    return {"max_err": errs, "sample_z": z}


def c2l_sparse(torch, np, dev):
    """(6b) a (C2L_SPARSE_N, C2L_SPARSE_N) sparse matrix at
    C2L_SPARSE_DENSITY, COO and CSR, on the card (float32): matmul with a
    dense (N, C2L_SPARSE_D), masked_matmul, the row softmax and
    sparse.nn.functional.attention, each against dense float64 on the
    CPU, each op's ms (CUDA events)."""
    from paddle_tpu_torch import sparse as S
    n, d, hd = C2L_SPARSE_N, C2L_SPARSE_D, C2L_ATTN_D
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    keep = torch.rand((n, n), generator=gen, device=dev) < C2L_SPARSE_DENSITY
    idx = keep.nonzero().t().contiguous()
    nnz = idx.shape[1]
    vals = torch.randn(nnz, generator=gen, device=dev)
    dense_r = torch.randn((n, d), generator=gen, device=dev)
    a = torch.randn((n, d), generator=gen, device=dev) / d ** 0.5
    b = torch.randn((d, n), generator=gen, device=dev)
    q, k, v = (torch.randn((n, hd), generator=gen, device=dev)
               for _ in range(3))
    # the float64 CPU references, from the same numbers
    idx_c, vals_c = idx.cpu(), vals.double().cpu()
    dense64 = torch.zeros((n, n), dtype=torch.float64)
    dense64[idx_c[0], idx_c[1]] = vals_c
    ref_mm = dense64 @ dense_r.double().cpu()
    a64, b64 = a.double().cpu(), b.double().cpu()
    ref_sddmm = (a64[idx_c[0]] * b64[:, idx_c[1]].t()).sum(1)
    masked = torch.full((n, n), -torch.inf, dtype=torch.float64)
    masked[idx_c[0], idx_c[1]] = vals_c
    ref_soft = torch.softmax(masked, dim=1)[idx_c[0], idx_c[1]]
    q64, k64, v64 = q.double().cpu(), k.double().cpu(), v.double().cpu()
    scores = torch.full((n, n), -torch.inf, dtype=torch.float64)
    scores[idx_c[0], idx_c[1]] = ((q64 * hd ** -0.5) @ k64.t())[
        idx_c[0], idx_c[1]]
    ref_attn = torch.nan_to_num(torch.softmax(scores, dim=1), nan=0.0) @ v64
    del dense64, masked, scores

    def err(out, ref):
        o = out.detach().double().cpu()
        return float((o - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1e-30)

    line = {"nnz": int(nnz), "n": n}
    for layout in ("coo", "csr"):
        x = S.sparse_coo_tensor(idx, vals, (n, n))
        if layout == "csr":
            x = x.to_sparse_csr()
        require(x.nnz() == nnz and x.layout == layout and x.device == dev,
                f"{layout}: built wrong")
        ops = {
            "matmul": (lambda: S.matmul(x, dense_r),
                       lambda o: err(o, ref_mm)),
            "masked_matmul": (lambda: S.masked_matmul(a, b, x),
                              lambda o: err(o.to_sparse_coo().values()
                                            if layout == "coo"
                                            else o.csr_values(), ref_sddmm)),
            "softmax": (lambda: S.softmax(x),
                        lambda o: err(o.csr_values(), ref_soft)),
            "attention": (lambda: S.nn.functional.attention(q, k, v, x),
                          lambda o: err(o, ref_attn)),
        }
        res = {}
        for name, (fn, check) in ops.items():
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            e = check(out)
            require(e <= C2L_SPARSE_TOL,
                    f"sparse {layout} {name}: {e:.3e} of the range from "
                    f"float64 (> {C2L_SPARSE_TOL})")
            ms = time_ms(torch, fn, reps=10) if dev.type == "cuda" else None
            res[name] = {"max_rel_err": e, "ms": ms}
        line[layout] = res
    return line


C2L_HOST_OP = r'''
#include <stdint.h>
extern "C" void c2l_scale_add(const float* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = 3.0f * in[i] + 0.5f;
}
'''


def c2l_utils(torch, dev, work):
    """(7) utils.run_check() on the card, and cpp_extension.load of a small
    host op, called on a card tensor."""
    import contextlib
    import io
    from paddle_tpu_torch import utils
    from paddle_tpu_torch.utils import cpp_extension
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        require(utils.run_check() is True, "run_check failed")
    require(f"on {dev.type}" in text.getvalue(),
            f"run_check said {text.getvalue()!r}")
    src = os.path.join(work, "c2l_scale_add.cc")
    with open(src, "w") as f:
        f.write(C2L_HOST_OP)
    t0 = time.perf_counter()
    lib = cpp_extension.load("c2l_scale_add", [src])
    build_s = time.perf_counter() - t0
    op = cpp_extension.custom_op(lib, "c2l_scale_add")
    x = torch.arange(4096, dtype=torch.float32, device=dev) / 7.0
    y = op(x)
    require(y.device == x.device and torch.equal(y, 3.0 * x + 0.5),
            "the host op's result is wrong")
    return {"run_check": text.getvalue().strip(), "load_s": build_s,
            "library": os.path.basename(lib._name)}


def long_tail(torch, np, dev, _kernels, root):
    """(c2l): (1) ASP, (2) LookAhead, ModelAverage and DistributedFusedLamb
    on the training workload, (3) the profiler, (4) the native loader, (5)
    WordPiece, (6) distribution and sparse, (7) run_check and
    cpp_extension."""
    import shutil
    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "c2l")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    parts, line = {}, {}

    def part(name, fn, kernels_free=False):
        t0 = time.perf_counter()
        if kernels_free:
            _kernels.reset_launches()
        out = fn()
        if kernels_free:
            used = {n: c for n, c in _kernels.launches.items() if c}
            require(not used, f"c2l {name}: launched {used}")
        parts[name] = time.perf_counter() - t0
        log(f"c2l {name}: {parts[name]:.1f} s")
        log(json.dumps({f"c2l_{name}": out}, default=str))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    model, _opt, ids, labels = c2l_workload(dev)
    del _opt
    line["asp"] = part("asp", lambda: c2l_asp(torch, np, dev, _kernels,
                                              model, ids, labels))
    line["lookahead"] = part("lookahead", lambda: c2l_lookahead(
        torch, np, _kernels, model, ids, labels))
    line["model_average"] = part("model_average", lambda: c2l_model_average(
        torch, np, _kernels, model, ids, labels))
    line["lamb"] = part("lamb", lambda: c2l_lamb(torch, np, _kernels, model,
                                                 ids, labels))
    line["profiler"] = part("profiler", lambda: c2l_profiled(
        torch, np, dev, _kernels, work, root))
    line["native_loader"] = part("native_loader", lambda: c2l_native_loader(
        torch, np, dev, _kernels, model))
    del model, ids, labels
    line["wordpiece"] = part("wordpiece", lambda: c2l_wordpiece(np),
                             kernels_free=True)
    line["distribution"] = part("distribution", lambda: c2l_distribution(
        torch, np, dev), kernels_free=True)
    line["sparse"] = part("sparse", lambda: c2l_sparse(torch, np, dev),
                          kernels_free=True)
    line["utils"] = part("utils", lambda: c2l_utils(torch, dev, work),
                         kernels_free=True)
    shutil.rmtree(work, ignore_errors=True)
    line.update({"parts_s": parts, "phase_s": time.perf_counter() - t_phase,
                 "card": card_line()})
    log(json.dumps({"long_tail": line}, default=str))
    return line


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
