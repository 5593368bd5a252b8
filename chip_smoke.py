#!/usr/bin/env python3
"""Chip smoke run of vdx_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU
    python3 chip_smoke.py --only frame_shards   # build, then phase 28 alone
    python3 chip_smoke.py --only mesh_axes      # build, then phase 29 alone

Phases, one flushed line each with its seconds:
  1. environment: torch, CUDA, nvidia-smi name and power limit, the SM
     count and clocks.max.sm (the exponential unit's rate in the bounds)
  2. build: one nvcc -c per vdx_torch/csrc/*.cu, started together, then a
     link (cached by source hash)
  3. kernels against their plain PyTorch versions at the main path's
     shapes: K1 (staticmax flash attention) and K4 (running max) on the
     wgmma + TMA kernel, K2 (one-pass cluster GroupNorm) and K3
     (streaming GroupNorm), each GN row on the kernel the launch plan
     gives its shape; kernel, plain and library times (CUDA events)
     beside each bound; the 2560-channel GN shapes that the first GN
     dispatch refused ([32,1024,2560] bf16, [32,576,2560] fp32), driven
     once through ops.groupnorm with the counters reset; the new sites
     of phases 14 and 15 (K1 at [64,4096,8,40] and [64,1024,8,80], GN at
     the batch's UNet and motion shapes and every VAE encoder GN site);
     the families' new sites (K1 at head dim 64: [32,1024,5,64] for
     ModelScope, [50,9216,5,64], [50,2304,10,64] and [50,576,20,64] for
     SVD; GN at the UNet3D, SVD UNet, temporal decoder and encoder shapes);
     then one [gn] line a path (a UNet call, a decode chunk and an encode
     chunk at 512 and 768, a two-video UNet call at 512): every
     GroupNorm of it through ops.groupnorm with the counters reset, its
     launches against the plan, the summed kernel, bound and
     F.group_norm ms (scripts/bench_gn_torch.py); the timed calls check
     the plan's K2 and K3 counts
  4. init: full-width random weights generated on the card; the seeded
     initial noise (vdx_torch.core.rng) on the card against the CPU
  5. warm-up: the workload at 2 steps
  6. reference: one denoiser evaluation at the workload's first-step
     input, kernel path against the plain versions swapped in; forward
     hooks keep q, k, v of the first motion-module attn1 at each level
     and count the temporal attention calls per level
  7. the timed call: AnimateDiff text-to-video at SD-1.5 width, 16 frames
     512x512, 25 DDIM steps, CFG 7.5, bf16, through
     AnimateDiffPipeline.__call__; launch counters reset just before it,
     read as the decode starts and again at its end, and checked
  8. warm-up of the 768x768 path: the pipeline's default sampler (Euler)
     at 2 steps
  9. reference at 768x768: one denoiser evaluation at the first Euler
     step's input, kernel path against the same call with only K4 swapped
     for its plain version; q, k, v kept as in 6
 10. the 768x768 timed call: 16 frames, 25 Euler steps (the pipeline's
     default sampler), CFG 7.5, bf16; counters as in 7 (K1 at levels 0
     and 1, K4 at level 2)
 11. every sampler at 512x512, 3 steps, through __call__
 12. the temporal family (K6, K7, K8, K9) at the eight motion-module
     sites kept in 6 and 9 ([P, 16, 8, D], P = 8192..288): driven once
     per site and entry point with the counters reset (K6 through
     ops.attention.dot_product_attention(impl="blockdiag"), K7, K8, K9
     through their kernels' functions), then each against its plain
     version, timed beside its bound, SDPA on the same views and the
     eager xla_bf16p path that impl="auto" runs at those sites today
     (bf16 K6-K8 on the tensor-core kernel, K9 on the SIMT kernel)
 13. the attention forms: flash_attention_dt in vdx's exp_impl forms
     exp, exp2, fastexp2, noexp, mxu_only (K1'), staticaug (K5) and
     staticmax (K1) at [32,4096,8,40], [32,576,8,160] and [32,576,8,256],
     and K4 (flash_attention) at [32,576,8,256], all on the wgmma + TMA
     pipeline, each driven through the chained loop of the attention
     micro-benchmark (scripts/bench_attn_torch.py, K = 16) with the
     counters reset, then against its plain version, timed beside its
     bound and a library call (SDPA; two matmuls for mxu_only; none for
     noexp)
 14. a prompt batch: a second full-width pipeline from the same seed,
     built with guidance_rescale=0.7 and FreeU at its defaults; two prompts
     with seeds [1234, 4321], 25 DDIM steps under a per-step guidance
     schedule of 25 entries (8.5 to 6.5), output_type="device": each
     video's noise against rng.normal(its seed) bit for bit, one UNet
     evaluation of the batch (UNet batch 64) split per video against the
     two single-video evaluations (rel-L2 bar REL_L2_TOL), launches per
     UNet call against the plan, then the timed call (seconds, s/video,
     peak memory; counters as in 7)
 15. video2video: phase 7's 16 frames at strength 0.6 (15 of the 25 DDIM
     steps run): one encode chunk on K2/K3 against their plain versions
     (REL_L2_TOL) with its launches against the plan, then the timed call
     with the encode's, the denoise loop's and the decode's launches
     checked
 16. the request knobs at 512x512, 6 DDIM steps, latents out: skip mode at
     threshold 0 (every step evaluated, latents equal to the plain call's)
     and at a threshold that skips (fewer evaluations), progress called
     once per evaluation, dispatch_steps=2 and variable_steps=8 equal to
     the plain call, attn_impl="xla" launching no K1
 17. PAB: phase 7's call under PABConfig() (spatial 2, temporal 4, cross
     6, warm-up 2, cool-down 2): the cache's bytes per attention type,
     the timed call (K1 on the 15 spatial refresh steps only: 150
     launches; K2/K3 as phase 7), every interval 1 against phase 7's
     launches and latents (torch.equal), dispatch_steps=5 against the
     monolithic PAB call (torch.equal)
 18. context windows: 32 frames at 512x512 under ContextConfig() (windows
     of 16 at starts 0, 8, 16, pyramid weights, FreeNoise): the FreeNoise
     draw on the card against the CPU (bits and permutations exact,
     normals within RNG_TOL), one windowed UNet evaluation against the
     plain K1/K2/K3 (REL_L2_TOL) with 3 UNet calls' launches, then the
     timed call (K1 750 launches)
 19. LoRA: a rank-8 peft adapter over every default target of the UNet
     from seeded factors, written by the port's .safetensors writer and
     loaded at scale 0.8: every merged weight against the plain fp32
     merge on the CPU, one UNet evaluation on K1/K2/K3, scale 0 and
     unload_lora against the pristine weights (torch.equal)
 20. checkpoints: the weights as diffusers-named files (the SD-1.5 UNet
     without its motion keys, the motion adapter, the VAE, the text
     tower) through from_pretrained into a second pipeline (every tensor
     and one UNet evaluation torch.equal), then save_checkpoint and
     load_checkpoint the same way; the files (about 3 GB) live under
     vdx_torch/_build/smoke_files/ only while their phase runs
 21. the study: the grid plan's CFG sweep of corgi_beach
     (vdx_torch.harness.plan_grid_search), its configs at CFG 5.0 and
     9.0 at the plan's size (16 frames 512x512, 25 steps, the pipeline's
     sampler), each alone through generate_video(output_type="device"),
     then both as one batch through harness.generate_batch (UNet batch
     64, K1 10 a step, GN launches against the plan; each video's rows of
     the first UNet call, x and context, and t equal to its single call's
     bit for bit), the batch's frames
     against the single calls' (rel-L2 REL_L2_TOL, F8's bar in phase
     14, and nearer its own config's call than the other's); measure_video on
     the card (LPIPSMetric on the card, the native flow built in this run
     on the host) against the port's CPU computation of the same frames
     (STUDY_REL, STUDY_LPIPS_REL); save_metrics and save_summary into
     vdx_torch/_build/smoke_files/study/, read back in the reference's
     key order; seconds per video, peak memory, measure_video's seconds
     by part
 22. serving: the 512 main path over HTTP on phase 7's modules (a DDIM
     sibling pipeline with a ProgressRelay), GenerationServer on
     127.0.0.1 at an ephemeral port, each request on its own http.client
     connection from a worker thread: GET /healthz (device "cuda"); the
     PNG codec (vdx_torch.io.png) timed on phase 7's 16 frames, its own
     files and Paeth-filtered ones; POST /generate three times (phase 7's
     request first: within one uint8 level of phase 7's direct call);
     BatchingGenerationService with the three queued and one 10-step
     request before its worker starts (2 batches, sizes 3 and 1; the
     batch's denoise launches against the plan at UNet batch 96; each
     video within REL_L2_TOL of its own sync request and nearer it than
     the others; seconds per video, peak memory); POST /jobs with
     progress polled up to 25 steps, the result against the sync route,
     a second JobManager recovering the journal as done without running
     it; POST /v2v with phase 7's frames at strength 0.6 against phase
     15's direct call (REL_L2_TOL); a ForwardTracer over one 512 UNet
     forward (every submodule that runs a forward recorded; K1/K2/K3
     launches equal to the untraced forward's)
 23. ModelScope: TextToVideoMSPipeline at full width (UNet3D at
     UNet3DConfig.modelscope(), the ViT-H text tower, the SD VAE; bf16,
     seeded random weights, no all-zero kernel), after phase 22's
     pipelines are freed: the GN sites of a UNet3D call and a decode chunk
     ([gn] lines, launches against the plan), a warm-up, one denoiser
     evaluation against the plain K1 and K2/K3 (REL_L2_TOL; K1 5 a UNet
     call at [32, 1024, 5, 64], head dim 64 on the DP = 80 instance), the
     timed call: 16 frames 256x256, 25 DDIM steps, CFG 7.5 (K1 125, K2/K3
     by the plan; seconds a video, frames/s, peak memory)
 24. SVD: SVDImg2VidPipeline at full width (SVDUNetConfig.svd(), CLIP
     ViT-H vision, the VAE encoder and the temporal decoder; bf16) on
     phase 7's first frame resized to 576x1024 (Pillow's BILINEAR, as the
     server resizes): the GN sites of a UNet call, a 5-frame decode chunk
     and the image's encode ([gn] lines), a 2-step warm-up, one denoiser
     evaluation against the plain versions (K1 15 a UNet call at
     [50, 9216, 5, 64], [50, 2304, 10, 64] and [50, 576, 20, 64]), the
     timed call: 25 frames, 25 EDM steps, decode_chunk 5 (K1 375 in the
     denoise loop only, K2/K3 by the plan in the encode, the loop and the
     decode; the split between them from CUDA events; peak memory), then
     one POST /img2vid through a GenerationServer with the port's
     Img2VidService, its frames within one uint8 level of the direct
     call's
 25. Latte: LattePipeline at full width (LatteConfig.xl(), the SD VAE, the
     CLIP ViT-L text tower; bf16, seeded random weights, no all-zero
     kernel, the adaLN gates and final_proj included), after phase 24's
     pipeline is freed: the GN sites of a decode chunk ([gn] line), a
     2-step warm-up, one DiT evaluation against the plain K1 (REL_L2_TOL;
     K1 14 a call at [32, 1024, 16, 72], head dim 72 on the DP = 80
     instance, no GroupNorm), the timed call: 16 frames 512x512, 50 DDIM
     steps, CFG 7.5 (K1 700, K2/K3 by the plan in the decode; seconds a
     video, frames/s, peak memory)
 26. CogVideoX: CogVideoXPipeline at full width (CogVideoXConfig.b2(),
     T5Config.xxl(), CausalVAEConfig.cogvideox(); bf16,
     offload_text_encoder=True), after phase 25's pipeline is freed: the GN
     sites of the causal decode in spatial tiles of 40 ([gn] line), a
     2-step warm-up, one DiT evaluation against the plain K1 (REL_L2_TOL;
     K1 30 a call at [2, 17776, 30, 64], the plain version over one head
     at a time), the timed call with the prompt cache cleared: 49 frames
     480x720, 50 DDIM steps (v-prediction), CFG 6.0,
     decode_spatial_tile=40 (K1 1500, K2/K3 by the plan in the decode),
     its seconds split by CUDA events into the T5 encode with its host
     round trip, the denoise loop and the decode, and the peaks of the
     encode, the denoise loop and the decode
 27. training: vdx_torch.parallel.train on AnimateDiff's UNetMotion at
     SD-1.5 width (bf16, seeded random weights), after phase 26's
     pipeline is freed: two synthetic 20-frame videos written as PNGs and
     read back through vdx_torch.data (clips of 16 at 256x256, batch 2),
     VAE-encoded on the card (K2/K3); (a) one batch (UNet batch 16) and
     key: loss and whole gradient with the kernels (K1 5 a forward at
     [16,1024,8,40], K2 and K3; their autograd Functions' backward) against
     plain_versions("K1", "K2/K3") (loss rel 1e-2, gradient rel-L2 5e-2);
     forward + backward of the Functions against SDPA and group_norm; (b)
     four make_train_step(remat=True, grad_accum=2, ema_decay=0.999) steps
     at constant lr and (c) four rank-8 LoRA steps, the first of each a
     warm-up: s a step, peak memory, every loss, the weights' and the
     adapter's movement, the launches in the forwards (hooks on the main
     thread), the recomputes (the rest of the step's) and the Functions'
     backward
 28. frame sharding (vdx_torch.parallel) on a one-rank NCCL mesh, the
     sharded code at one rank against the local path (bf16, seeded random
     weights): (a) UNetMotion at 16 frames 512x512, phase 6's input,
     through make_frame_sharded_unet with seq_impl "ulysses" and "ring",
     and ring with 14 real frames of 16 against the local 14-frame call
     (rel-L2 5e-2 each; K1 as the local call, K2 + K3 one fewer per motion
     module: the motion GN's statistics over the global frame axis run
     eager, as vdx routes them to XLA; ms per evaluation, and ms of the
     motion GroupNorms alone on K2/K3 and on the sharded statistics); (b)
     the SVD UNet at 25 frames 576x1024 through make_frame_sharded_svd_unet
     (the halo path; two GroupNorms per temporal resblock off the
     kernels); (c) Latte-XL at 16 frames 512x512 with temporal_impl
     "ulysses:frames";
     (d) the timed 512 DDIM call local, then with the pipeline's denoiser
     swapped for the one-rank Ulysses sharded apply (the pipeline's
     frame-sharded path: shard-local decode, frames gathered): the first
     step's eps against the local evaluation (5e-2), frames, seconds,
     peak, launches by stage
 29. the rest of the mesh (bf16, seeded random weights, a one-rank NCCL
     mesh): (a) phase 18's call (32 frames at 512x512, ContextConfig(),
     25 DDIM steps) through the sequential windows and through
     make_windowed_apply(mesh=) over the one-rank frames axis (the
     pipeline's window-parallel path swapped in): latents and frames
     equal bit for bit, the window evaluations counted by wrapper, the
     denoise launches equal (K1 750), seconds and peaks; (b)
     run_batched_experiments on two grid configs at 512 (25 DDIM) with
     and without mesh=make_mesh(1, 1, 1): every PNG, GIF and config.json
     byte for byte, s a video, launches; (d) K1 at the local heads of
     2-way tensor parallelism, [32,4096,4,40] and [32,1024,4,80], against
     its plain version, SDPA and its bound; (e) two processes on the one
     card in a gloo group (NCCL refuses two ranks on one card) run the
     UNetMotion at 512 cut by tensor_parallel over a 1x1x2 mesh: eps
     against the local call (5e-2), K1 10 a call at the local heads; (c)
     phase 27's training setting through make_mesh_train_step:
     param_sharding_rules all replicated at one rank, the batch through
     prefetch_to_device(sharding=...) as DTensors, the first step against
     make_train_step's from the same state and key (loss rel 1e-2,
     gradient rel-L2 5e-2, the updated parameters nearer the single-card
     step's than that step's own update), then three timed mesh steps (s
     a step: median and spread, peak, K1 launches in the forwards and
     recomputes and the Function's backward)
Phase 3 also checks the wgmma + TMA pipeline at its edges (Sq and Skv off
the tiles, Skv under one tile, q/k/v as views into one fused projection,
rows whose every scaled logit is below -46; every form at each head-dim
instance, D = 168, 200 and 256 on the DP = 256 one, fastexp2 and noexp
over several periods, noexp with Skv not a multiple of the period), the
template at its routes (K4 at D = 20 and 252; every form on rows 8 bytes
past 16-byte alignment), K1/K4 with fp32 operands, every exp_impl form in
fp32 at ragged key counts, and K6-K9 at D = 160 with 16, 24 and 32 frames,
on strided and unaligned views and in fp32; every counter of
kernels.flash_attention.launch_counts() has to take a launch there. Bounds: the largest of the operations over the peak
rate, the bytes over the memory rate and, for attention, the exp2 calls
over 16 a clock per SM at clocks.max.sm, and for fastexp2 the cubic's
instructions (counted from the SASS by scripts/sass_forms.py) at their
pipes' rates (a report, not a check). Then the kernels JSON line (each
row's launches from the run of its own path), the nvidia-smi line and,
last, the contract line {"ok": true, "device": ...}.

Any failure raises and ends the run with a non-zero exit; a hang ends
with a stack trace (faulthandler). TF32 is off for every comparison
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32
= False). Nothing is written outside vdx_torch/_build/.
"""

from __future__ import annotations

import contextlib
import faulthandler
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
from functools import partial

# a hang ends with a stack trace well before any outer time limit (1200 s
# for the whole run); the run, build included, takes about eight and a
# half minutes on an H100
HANG_BUDGET_S = 900
ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM published peaks at 700 W: bf16 dense tensor cores,
# fp32 outside the tensor cores, HBM3
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_BYTES_S = 3.35e12
# SM clocks a second (the SM count times clocks.max.sm, both read on the
# card in phase 1); exp2 calls run at 16 a clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0)
SM_CLOCKS_PER_S = {"rate": None}
EXP2_PER_CLOCK = 16
WORKLOAD = dict(
    negative_prompt="bad quality, blurry, distorted",
    num_frames=16, height=512, width=512, guidance_scale=7.5,
    decode_chunk=8, seed=1234, output_type="np",
)
WORKLOAD_768 = dict(WORKLOAD, height=768, width=768)  # default scheduler
PROMPT = "a corgi walking on the beach, sunset lighting, high quality"
TIMED_STEPS = 25
SAMPLER_STEPS = 3
# fp32 operands: both sides sum fp32 products (up to ~10^3 terms) in
# different orders, ~1e-6 apart on O(1) outputs; 1e-4 leaves margin and
# still catches any bf16 rounding (~4e-3).
FP32_TOL = 1e-4
# [B, S, C] of the 2560-channel GN rows (CFG batch 2 x 16 frames)
GN2560_SHAPES = ((32, 1024, 2560), (32, 576, 2560))
# phase 14: two prompts with their own seeds and a per-step guidance
# schedule of 25 entries around 7.5
BATCH_PROMPTS = (PROMPT, "a red panda eating bamboo in the snow, soft light")
BATCH_SEEDS = (1234, 4321)
# phases 14 and 15 hold a path's result against another form of the same
# computation (the batch split per video against two single-video
# evaluations, an encode chunk on K2/K3 against their plain versions): the
# same bf16 weights and inputs, but other kernels or other cuBLAS/cuDNN
# algorithms round otherwise, and each flip compounds over the network,
# as in phases 6 and 9 (PERF.md section 2's bar)
REL_L2_TOL = 5e-2
V2V_STRENGTH = 0.6  # phase 15: 15 of 25 DDIM steps
KNOB_STEPS = 6  # phase 16
# the seeded noise on the card against the CPU: the same int64 threefry
# bits; the fp32 erfinv polynomial's log1p and sqrt may round differently
# on the two (a few ulps of values up to ~6, ulp 4.8e-7)
RNG_TOL = 4e-6
# phase 18: 32 frames in windows of 16 at stride 8 (starts 0, 8, 16)
CONTEXT_FRAMES = 32
# phase 19: a rank-8 peft adapter over every default target, at scale 0.8
LORA_RANK, LORA_SCALE = 8, 0.8
# scratch files of phases 19 and 20 (about 3 GB), deleted after each;
# phase 21's metric JSON files stay under SCRATCH / "study"
SCRATCH = ROOT / "vdx_torch" / "_build" / "smoke_files"
# phase 21: the grid plan's CFG sweep of corgi_beach, two of its configs
STUDY_CFGS = (5.0, 9.0)
# the plan's size; a CPU rehearsal replaces it (dataclasses.replace)
STUDY_OVERRIDE: dict = {}
# measure_video on the card against the port's CPU computation of the
# same frames: MSE, PSNR, flicker and warp error (fp32 means in other
# summation orders), each value relative; a spread (std, variance) at
# the bar of its mean or squared mean, since nearly equal values cancel
# their agreeing bits
STUDY_REL = 1e-5
# LPIPS and the score: five fp32 convolution stages, cuDNN (TF32 off)
# against oneDNN
STUDY_LPIPS_REL = 1e-4
# phase 22: three requests of one static key (phase 7's call first), then
# one at 10 steps; each request on its own HTTP connection and thread
SERVE_REQUESTS = (
    {"prompt": PROMPT, "seed": 1234},
    {"prompt": BATCH_PROMPTS[1], "seed": 4321, "guidance_scale": 6.0},
    {"prompt": "birds flying across a blue sky, nature documentary",
     "seed": 77, "guidance_scale": 9.0},
)
SERVE_OTHER = {"prompt": PROMPT, "seed": 5, "num_inference_steps": 10}
# phase 23: ModelScope (BASELINE.json configs[0]) at 16 frames 256x256,
# DDIM (the pipeline's default), CFG 7.5; K1 at level 0 only (1024
# tokens, D = 64: two down and three up sites), level 1 (256 tokens) eager
MS_CALL = dict(negative_prompt=WORKLOAD["negative_prompt"], num_frames=16,
               height=256, width=256, guidance_scale=7.5, decode_chunk=8,
               seed=1234, output_type="np")
MS_K1_PER_CALL = 5
# phase 24: SVD (BASELINE.json configs[2]) at 25 frames 576x1024, EDM
# (the pipeline's default), decode_chunk 5; K1 at levels 0-2 (9216, 2304
# and 576 tokens, D = 64), five sites each; the mid block (144 tokens)
# and every temporal and cross attention eager
SVD_CALL = dict(num_frames=25, height=576, width=1024, decode_chunk=5,
                seed=1234, output_type="np")
SVD_FPS = 7
SVD_K1_PER_CALL = 15
# phase 25: Latte (BASELINE.json configs[4]) as vdx's family bench runs it
# (scripts/bench_families.py:80-101): 16 frames 512x512, 50 DDIM steps,
# CFG 7.5; K1 at the 14 spatial blocks (1024 tokens, D = 72), the
# temporal blocks (16 frames) and the cross-attention (77 keys) eager
LATTE_PROMPT = "a dog running through a meadow"
LATTE_CALL = dict(negative_prompt="low quality", num_frames=16, height=512,
                  width=512, guidance_scale=7.5, decode_chunk=8, seed=1234,
                  output_type="np")
FAMILY_STEPS = 50
LATTE_K1_PER_CALL = 14
# phase 26: CogVideoX-2B (BASELINE.json configs[3]) as vdx's family bench
# runs it (scripts/bench_families.py:104-139): 49 frames 480x720, 50 DDIM
# steps, CFG 6.0, T5-XXL offloaded, the causal decode in tiles of 40
# latent pixels; K1 at the 30 joint attentions (226 text + 13 x 30 x 45
# video tokens, D = 64)
COG_PROMPT = "a sailboat gliding across a calm lake at dawn"
COG_CALL = dict(num_frames=49, height=480, width=720, guidance_scale=6.0,
                decode_spatial_tile=40, seed=1234, output_type="np")
COG_K1_PER_CALL = 30
# phase 27: training at full width, AnimateDiff's motion-module training
# setting (Guo et al. 2023, arXiv:2307.04725: WebVid clips of 16 frames at
# 256x256): two synthetic videos of 20 frames written as PNGs, clips of
# 16, UNet batch 16 a micro-batch; K1 at level 0 only (1024 tokens: 2 down
# and 3 up sites), level 1 (256 tokens) eager
TRAIN_VIDEOS, TRAIN_VIDEO_FRAMES, TRAIN_SIZE, TRAIN_CLIP = 2, 20, 256, 16
TRAIN_BATCH = 2
TRAIN_STEPS = 4  # each kind; the first is a warm-up, not timed
TRAIN_LR = 1e-4  # constant: every step moves the weights
TRAIN_EMA = 0.999
TRAIN_LORA_RANK = 8
TRAIN_K1_PER_CALL = 5
# the step's K1 and GN shapes, for the Functions' forward + backward
TRAIN_ATTN_SHAPE = (16, 1024, 8, 40)
TRAIN_GN_SHAPES = ((16, 1024, 320), (1, 16384, 320))
# the kernel path against the plain versions on one batch and key: the
# loss within 1e-2 relative, the whole gradient within 5e-2 rel-L2 (bf16
# forward and backward; PERF.md section 2's bar for a UNet evaluation)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-2, 5e-2
# pipeline keyword overrides by family ("ms", "svd", "latte", "cog",
# "train"); a CPU rehearsal gives tiny configs, the fp32 policy and
# device="cpu" ("frame_shards": {"pipe": those kwargs, "policy", "svd" and
# "latte": the configs})
FAMILY_BUILD: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(flops: float, nbytes: float, peak: float, exps: float = 0.0,
          alu_clocks: float = 0.0):
    """Least time for the work: the largest of operations over the peak
    rate for their type, bytes (inputs read once, outputs written once)
    over the memory rate, exp2 calls over the special-function units'
    rate, and ``alu_clocks`` SM clocks of FMA and integer pipe work over
    every SM. -> (ms, which term sets it: "operations", "bytes", "exp2"
    or "alu"; the kernels line reports exp2 and alu as "operations")."""
    sm = SM_CLOCKS_PER_S["rate"]
    terms = {"operations": flops / peak, "bytes": nbytes / H100_BYTES_S,
             "exp2": exps / (EXP2_PER_CLOCK * sm) if exps else 0.0,
             "alu": alu_clocks / sm if alu_clocks else 0.0}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term


def ptxas_summary(text: str) -> str:
    """One entry per kernel instantiation from nvcc's ``-Xptxas -v``."""
    import re

    out, name, spill = [], None, ""
    for line in text.splitlines():
        # the kernel's name follows its length in the mangled symbol
        m = re.search(r"entry function '.*?(?<=\d)((?:flash|gn|temporal)_\w+?_kernel)"
                      r"(I[^v]*)?", line)
        if m:
            name = m.group(1) + (m.group(2) or "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)}r spill {spill}")
            name = None
    return "; ".join(out)


def bf16_tol(ref) -> float:
    """One bf16 ulp at the largest reference magnitude: both sides compute
    in fp32 and round once to bf16, so summation order flips a last bit."""
    return 2.0 ** -7 * max(1.0, ref.float().abs().max().item())


ATTN_PATH_LABEL = {"batch": "512x512", "serve": "512x512",
                   "ms": "ModelScope 256x256", "svd": "SVD 576x1024",
                   "latte": "Latte-XL 512x512", "cog": "CogVideoX-2B 480x720",
                   "train": "training 256x256",
                   "tp": "512x512, a rank of 2-way tensor parallelism"}


def attention_row(dev, gen, kname, shape, path, site, one_slice) -> dict:
    """One attention kernel row (phase 3's, and phase 29's local heads):
    the kernel at the full shape, held against its plain version on the
    first two batch entries (or one (b, h) slice), timed beside the plain
    version, SDPA and its bound."""
    import torch
    import torch.nn.functional as F

    from vdx_torch.kernels import flash_attention as KA

    B, S, H, D = shape

    def randn(shape, mean=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) + mean).to(dtype)

    static = dict(exp_impl="staticmax")
    t0 = time.time()
    fn, plain = ((partial(KA.flash_attention_dt, **static),
                  partial(KA.flash_attention_dt_plain, **static))
                 if kname == "K1" else
                 (KA.flash_attention, KA.flash_attention_plain))
    q, k, v = (randn((B, S, H, D)) for _ in range(3))
    scale = D ** -0.5
    before = KA.launch_counts()
    out = fn(q, k, v, scale=scale)
    # the launch on the counter the routing rule names (K1 at D = 64
    # on the DP = 80 instance's "K1", K4 on "K4"), and on no other
    counter = KA.counter_for("staticmax" if kname == "K1" else None,
                             q.dtype, D, True)
    moved = {n: c - before[n] for n, c in KA.launch_counts().items()
             if c != before[n]}
    if moved != {counter: 1}:
        raise SystemExit(f"{kname} [{B},{S},{H},{D}]: launches {moved}, "
                         f"expected one on {counter!r}")
    # the plain version on two batch entries, or on one (b, h) slice
    # where two entries' scores would not fit (75 GB at 17,776 tokens)
    sl = (slice(0, 1), slice(None), slice(0, 1)) if one_slice == "head" \
        else (slice(0, 2),)
    ref = plain(q[sl], k[sl], v[sl], scale=scale)
    err = (out[sl].float() - ref.float()).abs()
    tol = bf16_tol(ref)
    del ref

    def plain_full():
        if one_slice == "head":
            plain(q[sl], k[sl], v[sl], scale=scale)
            return
        for i in range(0, 2 if one_slice else B, 2):
            plain(q[i:i + 2], k[i:i + 2], v[i:i + 2], scale=scale)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = cuda_ms(lambda: fn(q, k, v, scale=scale))
    times = {"head": B * H, True: B // 2, False: 1}[one_slice]
    plain_ms = cuda_ms(plain_full, reps=3, warmup=1) * times
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           scale=scale))
    b_ms, b_by = bound(4.0 * B * H * S * S * D, 4 * q.numel() * 2,
                       H100_BF16_FLOPS, float(B * H * S * S))  # one exp2 a score
    label = {"K1": "flash_attention_dt staticmax",
             "K4": "flash_attention running-max"}[kname]
    return dict(
        name=f"{kname} {label} [{B},{S},{H},{D}] ({site}, "
             f"{ATTN_PATH_LABEL.get(path, f'{path}x{path}')})",
        kernel=kname, path=path,
        stage="step" if path == "train" else "denoise", route="cuda",
        source="vdx_torch/csrc/flash_attention_sm90.cu",
        replaces=("vdx/kernels/flash_attention.py:204" if kname == "K1"
                  else "vdx/kernels/flash_attention.py:135"),
        max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
        tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="F.scaled_dot_product_attention", bound_ms=b_ms,
        bound_by=b_by, seconds=time.time() - t0,
        note=(f"plain_ms: one (b, h) slice timed, times {B * H}"
              if one_slice == "head" else
              f"plain_ms: one two-entry slice timed, times {B // 2}"
              if one_slice else ""))


def check_kernels(dev):
    """Phase 3: each kernel on the full main-path shape of its path (the
    512x512 DDIM call or the 768x768 Euler call), its plain version on the
    first two batch entries (the plain K1 at the full level-0 batch would
    hold a 17 GB score tensor at 512, 87 GB at 768)."""
    import torch
    import torch.nn.functional as F

    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import groupnorm as KG

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(shape, mean=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) + mean).to(dtype)

    attn_cases = (  # (kernel, shape, path, site, plain timed on one slice)
        ("K1", (32, 4096, 8, 40), "512", "level-0 self-attn", False),
        ("K1", (32, 1024, 8, 80), "512", "level-1 self-attn", False),
        ("K1", (32, 9216, 8, 40), "768", "level-0 self-attn", True),
        ("K1", (32, 2304, 8, 80), "768", "level-1 self-attn", True),
        ("K4", (32, 576, 8, 160), "768", "level-2 self-attn", False),
        # a two-prompt batch doubles the UNet batch (phase 14)
        ("K1", (64, 4096, 8, 40), "batch", "level-0 self-attn, 2 videos", True),
        ("K1", (64, 1024, 8, 80), "batch", "level-1 self-attn, 2 videos", False),
        # the server's batch of three requests: UNet batch 96 (phase 22)
        ("K1", (96, 4096, 8, 40), "serve", "level-0 self-attn, 3 served videos",
         True),
        ("K1", (96, 1024, 8, 80), "serve", "level-1 self-attn, 3 served videos",
         False),
        # the families' head dim 64 on the DP = 80 instance (16 columns
        # padded): ModelScope's level 0 (phase 23), SVD's levels 0-2 at
        # CFG 2 x 25 frames (phase 24)
        ("K1", (32, 1024, 5, 64), "ms", "level-0 self-attn", False),
        ("K1", (50, 9216, 5, 64), "svd", "level-0 self-attn", True),
        ("K1", (50, 2304, 10, 64), "svd", "level-1 self-attn", True),
        ("K1", (50, 576, 20, 64), "svd", "level-2 self-attn", False),
        # the DiTs (phases 25-26): Latte-XL's spatial blocks at D = 72 (8
        # columns padded on the DP = 80 instance), CogVideoX-2B's joint
        # attention over 17,776 tokens (neither tail a tile multiple;
        # the plain version over one head)
        ("K1", (32, 1024, 16, 72), "latte", "spatial self-attn", False),
        ("K1", (2, 17776, 30, 64), "cog", "joint attention", "head"),
        # a training micro-batch at 256x256 (phase 27): UNet batch 16
        ("K1", (16, 1024, 8, 40), "train", "level-0 self-attn, a training "
         "micro-batch", False),
    )
    for kname, shape, path, site, one_slice in attn_cases:
        rows.append(attention_row(dev, gen, kname, shape, path, site, one_slice))
        torch.cuda.empty_cache()

    # the launch plan: K2 where a cluster holds a stripe with two CTAs an
    # SM (the 768 level-0 resnet GN: a 1.47 MB stripe on 16 CTAs), K3
    # where not (the 768 level-0 motion GN, a 47 MB stripe)
    if KG.gn_plan(32, 9216, 320, 32, 2).route != "K2" \
            or KG.gn_plan(2, 147456, 320, 32, 2).route != "K3":
        raise SystemExit("GN plan: [32, 9216, 320] bf16 should go to K2, "
                         "[2, 147456, 320] to K3")
    bf16, fp32 = torch.bfloat16, torch.float32
    gpu_ms = load_script("bench_gn_torch").gpu_ms
    gn_cases = (  # (kernel, shape, dtype, eps, silu, where, path, stage)
        ("K2", (32, 4096, 320), bf16, 1e-5, True,
         "UNet level-0 resnet GN-SiLU", "512", "denoise"),
        ("K2", (32, 4096, 960), bf16, 1e-5, True,
         "UNet up-block-3 resnet GN-SiLU, 960 channels", "512", "denoise"),
        ("K3", (2, 65536, 320), bf16, 1e-6, False,
         "level-0 motion-module GN", "512", "denoise"),
        ("K3", (8, 262144, 128), bf16, 1e-6, True,
         "VAE decoder GN-SiLU at 512x512", "512", "decode"),
        ("K2", (32, 9216, 320), bf16, 1e-5, True,
         "UNet level-0 resnet GN-SiLU at 768x768", "768", "denoise"),
        ("K3", (32, 9216, 960), bf16, 1e-5, True,
         "UNet up-block-3 resnet GN-SiLU at 768x768 (a 16-CTA stripe, "
         "one CTA an SM: K3 by the plan)", "768", "denoise"),
        ("K3", (2, 147456, 320), bf16, 1e-6, False,
         "level-0 motion-module GN at 768x768", "768", "denoise"),
        ("K3", (8, 589824, 128), bf16, 1e-6, True,
         "VAE decoder GN-SiLU at 768x768", "768", "decode"),
        ("K3", (8, 589824, 256), bf16, 1e-6, True,
         "VAE decoder GN-SiLU at 768x768, 256 channels (4.8 GB)", "768",
         "decode"),
        # the up-block-1 resnet GN: 1024x1024 in bf16, 768x768 under the
        # fp32 policy (both over the first GN kernels' slab gate)
        ("K2", GN2560_SHAPES[0], bf16, 1e-5, True,
         "up-block-1 resnet GN-SiLU at 1024x1024", "gn2560", "dispatch"),
        ("K2", GN2560_SHAPES[1], fp32, 1e-5, True,
         "up-block-1 resnet GN-SiLU at 768x768, fp32", "gn2560", "dispatch"),
        # a two-prompt batch at 512 (phase 14): UNet batch 64, motion GN
        # batch 4 (K3's chunks a sample: 132, one a CTA of the 528 target)
        ("K2", (64, 4096, 320), bf16, 1e-5, True,
         "UNet level-0 resnet GN-SiLU, 2 videos", "batch", "denoise"),
        ("K3", (4, 65536, 320), bf16, 1e-6, False,
         "level-0 motion-module GN, 2 videos", "batch", "denoise"),
        ("K3", (4, 16384, 640), bf16, 1e-6, False,
         "level-1 motion-module GN, 2 videos", "batch", "denoise"),
        ("K2", (4, 4096, 1280), bf16, 1e-6, False,
         "level-2 motion-module GN, 2 videos", "batch", "denoise"),
        # the server's batch of three requests at 512 (phase 22): UNet
        # batch 96, motion GN batch 6
        ("K2", (96, 4096, 320), bf16, 1e-5, True,
         "UNet level-0 resnet GN-SiLU, 3 served videos", "serve", "denoise"),
        ("K3", (6, 65536, 320), bf16, 1e-6, False,
         "level-0 motion-module GN, 3 served videos", "serve", "denoise"),
        # every GN site of the VAE encoder at 512x512 (phase 15), 8 frames
        ("K3", (8, 262144, 128), bf16, 1e-6, True,
         "VAE encoder down-0 GN-SiLU", "v2v", "encode"),
        ("K3", (8, 65536, 128), bf16, 1e-6, True,
         "VAE encoder down-1 first GN-SiLU", "v2v", "encode"),
        ("K3", (8, 65536, 256), bf16, 1e-6, True,
         "VAE encoder down-1 GN-SiLU", "v2v", "encode"),
        ("K3", (8, 16384, 256), bf16, 1e-6, True,
         "VAE encoder down-2 first GN-SiLU", "v2v", "encode"),
        ("K3", (8, 16384, 512), bf16, 1e-6, True,
         "VAE encoder down-2 GN-SiLU", "v2v", "encode"),
        ("K2", (8, 4096, 512), bf16, 1e-6, True,
         "VAE encoder down-3, mid and out GN-SiLU", "v2v", "encode"),
        ("K2", (8, 4096, 512), bf16, 1e-6, False,
         "VAE encoder mid-attention GN", "v2v", "encode"),
        # ModelScope at 256x256 (phase 23): the level-0 resnet GN, and the
        # TemporalConv GN over 16 frames and space
        ("K2", (32, 1024, 320), bf16, 1e-5, True,
         "UNet3D level-0 resnet GN-SiLU", "ms", "denoise"),
        ("K3", (2, 16384, 320), bf16, 1e-5, True,
         "UNet3D level-0 TemporalConv GN-SiLU, 16 frames", "ms", "denoise"),
        # SVD at 576x1024 (phase 24): the spatial resnet GN at UNet batch
        # 50, the temporal resblock's GN over 25 frames, the temporal
        # decoder's GNs by 5-frame chunk and the conditioning image's
        # encode
        ("K2", (50, 9216, 320), bf16, 1e-5, True,
         "SVD level-0 spatial resnet GN-SiLU", "svd", "denoise"),
        ("K3", (2, 230400, 320), bf16, 1e-5, True,
         "SVD level-0 temporal resblock GN-SiLU, 25 frames", "svd", "denoise"),
        ("K3", (1, 2949120, 128), bf16, 1e-5, True,
         "SVD temporal decoder tnorm GN-SiLU, 5 frames at 576x1024", "svd",
         "decode"),
        ("K3", (5, 589824, 128), bf16, 1e-6, True,
         "SVD temporal decoder spatial GN-SiLU at 576x1024", "svd", "decode"),
        ("K3", (1, 589824, 128), bf16, 1e-6, True,
         "VAE encoder down-0 GN-SiLU, the SVD image at 576x1024", "svd",
         "encode"),
        # Latte's SD VAE decode chunk at 512x512 (phase 25)
        ("K3", (8, 262144, 128), bf16, 1e-6, True,
         "VAE decoder GN-SiLU at 512x512, Latte's decode", "latte", "decode"),
        # CogVideoX's causal decode in 40x40-latent tiles (phase 26): the
        # GNs span the tile's 13, then 26 and 52 frames
        ("K3", (1, 20800, 512), bf16, 1e-6, True,
         "causal VAE decoder 512-channel GN-SiLU, 13 frames x 40x40", "cog",
         "decode"),
        ("K3", (1, 1331200, 256), bf16, 1e-6, True,
         "causal VAE decoder 256-channel GN-SiLU, 52 frames x 160x160", "cog",
         "decode"),
        ("K3", (1, 5324800, 128), bf16, 1e-6, True,
         "causal VAE decoder 128-channel GN-SiLU, 52 frames x 320x320", "cog",
         "decode"),
        # a training micro-batch at 256x256 (phase 27): the level-0 resnet
        # GN at UNet batch 16, the level-0 motion GN over its 16 frames
        ("K2", (16, 1024, 320), bf16, 1e-5, True,
         "UNet level-0 resnet GN-SiLU, a training micro-batch", "train",
         "step"),
        ("K3", (1, 16384, 320), bf16, 1e-6, False,
         "level-0 motion-module GN, a training micro-batch", "train", "step"),
    )
    for kname, (B, S, C), dtype, eps, silu, where, path, stage in gn_cases:
        t0 = time.time()
        fn = KG.fused_group_norm if kname == "K2" else KG.fused_group_norm_2phase
        plan = KG.gn_plan(B, S, C, 32, dtype.itemsize)
        if plan.route != kname:  # the row's kernel is the one its path runs
            raise SystemExit(f"GN plan: {[B, S, C]} goes to {plan.route}, "
                             f"not {kname}")
        x = randn((B, S, C), mean=0.5, dtype=dtype)
        scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
        kw = dict(num_groups=32, eps=eps, with_silu=silu)
        out = fn(x, scale, bias, **kw)
        ref = KG.group_norm_moments_plain(x[:2], scale, bias, **kw)
        err = (out[:2].float() - ref.float()).abs()
        tol = bf16_tol(ref) if dtype == bf16 else FP32_TOL
        xt = x.view(B, S, C).transpose(1, 2)  # [B, C, S] view for F.group_norm

        def library():
            y = F.group_norm(xt, 32, scale.to(x.dtype), bias.to(x.dtype), eps)
            return F.silu(y) if silu else y

        # a GN launch takes 0.01-2.5 ms, near the host's time to make one:
        # the kernel and library calls are timed queued behind a sleep
        # kernel (bench_gn_torch.gpu_ms), so the host's share does not show
        ms = gpu_ms(lambda: fn(x, scale, bias, **kw))
        plain_ms = cuda_ms(lambda: KG.group_norm_moments_plain(x, scale, bias, **kw))
        lib_ms = gpu_ms(library, reps=4)
        # ~8 fp32 operations per element (two moments, affine, SiLU)
        b_ms, b_by = bound(8.0 * x.numel(),
                                   2 * x.numel() * x.element_size(),
                                   H100_FP32_FLOPS)
        rows.append(dict(
            name=f"{kname} {fn.__name__} [{B},{S},{C}] {str(dtype)[6:]} "
                 f"({where})",
            kernel=kname, path=path, stage=stage, route="cuda",
            source="vdx_torch/csrc/groupnorm.cu",
            replaces=("vdx/kernels/groupnorm.py:117" if kname == "K2"
                      else "vdx/kernels/groupnorm.py:205"),
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
            tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library="F.group_norm" + (" + F.silu" if silu else ""),
            bound_ms=b_ms, bound_by=b_by,
            seconds=time.time() - t0,
            note=(f"cluster {plan.cluster} x {plan.rows_per_cta} rows, "
                  f"stripe {plan.stripe_channels} channels"
                  if kname == "K2" else
                  f"{plan.n_chunks} chunks of {plan.rows_per_chunk} rows")
            + "; ms and library_ms queued behind a sleep kernel"))
        del x, out, ref, xt
        torch.cuda.empty_cache()

    for r in rows:
        log(f"[kernels] {r['name']}: max_abs_err={r['max_abs_err']:.3e} "
            f"mean_abs_err={r['mean_abs_err']:.3e} tol={r['tol']:.3e} "
            f"(bf16: one ulp at max|plain|, fp32: {FP32_TOL}; fp32 sums in "
            f"another order) "
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} ({r['library']}) "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"{r['note'] + ' ' if r['note'] else ''}{r['seconds']:.1f}s")
    bad = [r["name"] for r in rows if not r["max_abs_err"] <= r["tol"]]
    before = KA.launch_counts()
    bad += check_sm90_edges(dev)
    bad += check_attention_edges(dev)
    edges = {n: c - before[n] for n, c in KA.launch_counts().items()}
    bad += check_temporal_edges(dev)
    log(f"[kernels] edge launches by counter: {edges}")
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    idle = [n for n, c in edges.items() if not c]
    if idle:
        raise SystemExit(f"routes never launched at the edges: {idle}")
    return rows, edges


def check_sm90_edges(dev):
    """The wgmma + TMA kernel (csrc/flash_attention_sm90.cu) in both forms
    at its edges, each launch counted on it (K1 in
    flash_attention_dt.launches, K4 in flash_attention.launches): Sq and
    Skv off the query and key tiles at each instance's head dim (D = 168,
    200 and 256 on the DP = 256 instance), Skv under one tile, q/k/v as views into one fused [B, S, 3, H, D]
    projection, staticmax at D = 160, and at D = 40 two rows whose every
    scaled logit is below -46 (about -95: p underflows to 0 and the row is
    zeros; about -53: p is subnormal, as in the plain version). K1 is
    held to kernels.flash_attention.plain_err_tol, K4 to the same bar
    against flash_attention_plain. -> the names of the cases that fail."""
    import torch

    from vdx_torch.kernels import flash_attention as KA

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(form, B, Sq, Skv, H, D, fused)
             for form in ("K1", "K4")
             for B, Sq, Skv, H, D, fused in (
                 (2, 300, 333, 3, 40, False), (2, 300, 333, 3, 80, False),
                 (2, 300, 333, 3, 160, False), (1, 64, 70, 2, 40, False),
                 (1, 200, 100, 2, 160, False), (2, 640, 640, 4, 40, True),
                 (2, 577, 577, 8, 80, True), (2, 600, 600, 2, 160, True),
                 # DP = 256 (one consumer warpgroup): D = 168, 200, 256,
                 # Skv under one 64-key tile, fused-projection views
                 (2, 300, 333, 3, 168, False), (2, 300, 333, 3, 200, False),
                 (2, 300, 333, 3, 256, False), (1, 65, 50, 2, 256, False),
                 (2, 600, 600, 2, 256, True))]
    cases.append(("K1 below -46", 2, 256, 300, 2, 40, False))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    bad = []
    for form, B, Sq, Skv, H, D, fused in cases:
        if fused:
            qkv = randn(B, Sq, 3, H, D)
            q, k, v = qkv.unbind(dim=2)
        else:
            q, k, v = randn(B, Sq, H, D), randn(B, Skv, H, D), randn(B, Skv, H, D)
        if form == "K1 below -46":
            # k > 0, so a row of q at -8 (-4.5) scores about -95 (-53)
            k = (k.float().abs() + 0.5).to(torch.bfloat16)
            q[:, 0], q[:, 1] = -8.0, -4.5
        scale = D ** -0.5
        static = form.startswith("K1")
        counter = KA.flash_attention_dt if static else KA.flash_attention
        n0 = counter.launches
        if static:
            out = KA.flash_attention_dt(q, k, v, scale=scale, exp_impl="staticmax")
            err, _, tol, mag = KA.plain_err_tol(out, q, k, v, scale=scale,
                                                exp_impl="staticmax")
        else:
            out = KA.flash_attention(q, k, v, scale=scale)
            ref = KA.flash_attention_plain(q, k, v, scale=scale)
            err = (out.float() - ref.float()).abs().max().item()
            mag = ref.float().abs().max().item()
            tol = bf16_tol(ref)
        torch.cuda.synchronize()
        launched = counter.launches - n0
        name = (f"{form} sm90 [{B},{Sq}/{Skv},{H},{D}]"
                + (" fused-projection views" if fused else ""))
        extra = ""
        if form == "K1 below -46":
            extra = (f" row -95 max|out|={out[:, 0].float().abs().max().item():.3e}"
                     f" row -53 max|out|={out[:, 1].float().abs().max().item():.3e}")
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"max|plain|={mag:.3e} launches on the kernel {launched}{extra}")
        if not (err <= tol and launched == 1):
            bad.append(name)
    return bad


def check_attention_edges(dev):
    """K4 at shapes off the main path (D % 8 != 0 at 20 and 252, D = 256,
    a multi-tile ragged Skv) in bf16, K1/K4 with fp32 operands, and every
    form of flash_attention_dt: in bf16 on the wgmma + TMA pipeline at
    ragged Sq and Skv at each head-dim instance (DP = 48, 80, 128, 160 and
    256, the last at D = 168, 200 and 256), fastexp2 and noexp over
    several periods with Skv a multiple of the period and not, K5 on rows
    whose every scaled logit is below -46 (D = 40 and 256); on the
    template (" template" counters, "K1 static") on rows 8 bytes past
    16-byte alignment at D = 40, 160 and 256; in fp32 (the SIMT kernel) at
    a ragged Skv. Each against its plain version with
    KA.plain_err_tol, each launch counted once on the counter
    KA.counter_for names and on no other; -> the names of the cases that
    fail."""
    import torch

    from vdx_torch.kernels import flash_attention as KA

    gen = torch.Generator(device=dev).manual_seed(1)
    bad = []

    def operands(dtype, B, Sq, Skv, H, D, aligned=True):
        """q, k, v; unaligned: views whose base is 8 bytes past a 16-byte
        boundary (every row then starts off it)."""
        def one(S):
            shape, n = (B, S, H, D), B * S * H * D
            if aligned:
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            flat = torch.randn(n + 4, generator=gen, device=dev).to(dtype)
            return flat[8 // flat.element_size():][:n].view(shape)
        return one(Sq), one(Skv), one(Skv)

    def counted(name, want, before):
        """The launch landed on counter ``want`` once, on no other."""
        after = KA.launch_counts()
        moved = {n: after[n] - c for n, c in before.items() if after[n] != c}
        if moved != {want: 1}:
            log(f"[kernels] edge {name}: launches {moved}, expected {want} 1")
            bad.append(name + " (counter)")

    cases = (  # (kernel, dtype, B, Sq, Skv, H, D)
        ("K4", torch.bfloat16, 2, 300, 300, 2, 20),
        ("K4", torch.bfloat16, 2, 300, 700, 2, 252),
        ("K4", torch.bfloat16, 2, 300, 700, 2, 256),
        ("K4", torch.bfloat16, 2, 1000, 1000, 2, 160),
        ("K1", torch.float32, 2, 1024, 1024, 2, 40),
        ("K1", torch.float32, 2, 1024, 1024, 2, 80),
        ("K4", torch.float32, 2, 576, 576, 8, 160),
        ("K4", torch.float32, 2, 300, 300, 2, 20),
    )
    static = dict(exp_impl="staticmax")
    for kname, dtype, B, Sq, Skv, H, D in cases:
        fn, plain = ((partial(KA.flash_attention_dt, **static),
                      partial(KA.flash_attention_dt_plain, **static))
                     if kname == "K1" else
                     (KA.flash_attention, KA.flash_attention_plain))
        q, k, v = operands(dtype, B, Sq, Skv, H, D)
        before = KA.launch_counts()
        out = fn(q, k, v, scale=D ** -0.5)
        name = f"{kname} {str(dtype)[6:]} [{B},{Sq}/{Skv},{H},{D}]"
        counted(name, KA.counter_for("staticmax" if kname == "K1" else None,
                                     dtype, D, True), before)
        ref = plain(q, k, v, scale=D ** -0.5)
        err = (out.float() - ref.float()).abs().max().item()
        fp32 = dtype == torch.float32
        tol = FP32_TOL if fp32 else bf16_tol(ref)
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            + ("(fp32: sums of up to 10^3 products in another order)" if fp32
               else "(one bf16 ulp at max|plain|)"))
        if not err <= tol:
            bad.append(name)
    bf16, fp32 = torch.bfloat16, torch.float32
    # (form, dtype, B, Sq, Skv, H, D, block_k, aligned rows, below -46)
    # the wgmma + TMA pipeline: ragged Sq and Skv at each instance (D =
    # 168, 200 and 256 on DP = 256)
    form_cases = [(form, bf16, 2, 300, Skv, 3, D, 1024, True, False)
                  for form in KA.EXP_IMPLS
                  for Skv, D in ((300, 40), (333, 80), (333, 128), (700, 160),
                                 (333, 168), (700, 200), (700, 256))]
    # fastexp2 and noexp over several periods of 256 keys at each
    # instance: Skv = 1100, not a multiple of the period (noexp runs to
    # 1280, its padded keys entering l), and Skv = 1024, a multiple (no
    # padded keys)
    form_cases += [(form, dtype, 2, Sq, Skv, 2, D, 256, True, False)
                   for form in ("fastexp2", "noexp")
                   for dtype, Sq, Skv, D in (
                       *((bf16, 200, 1100, D) for D in (40, 80, 128, 160, 256)),
                       *((dtype, 300, 1024, D) for dtype in (bf16, fp32)
                         for D in (40, 160, 256)))]
    form_cases += [("noexp", bf16, 2, 300, 300, 2, 40, 128, True, False),
                   ("noexp", bf16, 2, 300, 1100, 2, 256, 1024, True, False),
                   ("staticaug", bf16, 2, 256, 300, 2, 40, 1024, True, True),
                   ("staticaug", bf16, 2, 256, 300, 2, 256, 1024, True, True)]
    # the template: every form on rows the pipeline does not take
    form_cases += [(form, bf16, 2, 300, Skv, 2, D, 1024, False, False)
                   for form in KA.EXP_IMPLS
                   for Skv, D in ((333, 40), (700, 160), (333, 256))]
    # fp32: the SIMT kernel
    form_cases += [(form, fp32, 2, 300, Skv, 2, D, 1024, True, False)
                   for form in KA.EXP_IMPLS for Skv, D in ((300, 40), (700, 160))]
    for form, dtype, B, Sq, Skv, H, D, block_k, aligned, below in form_cases:
        q, k, v = operands(dtype, B, Sq, Skv, H, D, aligned)
        if below:
            # k > 0, so a row of q at -8 (-4.5) scores about -95 (-53)
            k = (k.float().abs() + 0.5).to(dtype)
            q[:, 0], q[:, 1] = -8.0, -4.5
        kw = dict(scale=D ** -0.5, exp_impl=form, block_k=block_k)
        want = KA.counter_for(form, dtype, D, aligned)
        name = (f"{form} ({want}) {str(dtype)[6:]} "
                f"[{B},{Sq}/{Skv},{H},{D}] block_k {block_k}"
                + ("" if aligned else " rows 8 bytes past 16-byte alignment")
                + (" rows below -46" if below else ""))
        before = KA.launch_counts()
        out = KA.flash_attention_dt(q, k, v, **kw)
        counted(name, want, before)
        err, _, tol, mag = KA.plain_err_tol(out, q, k, v, **kw)
        extra = ""
        if below:
            extra = (f" row -95 max|out|={out[:, 0].float().abs().max().item():.3e}"
                     f" row -53 max|out|={out[:, 1].float().abs().max().item():.3e}")
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"max|plain|={mag:.3e} (KA.plain_err_tol){extra}")
        if not err <= tol:
            bad.append(name)
    return bad


def check_temporal_edges(dev):
    """K6-K9 (csrc/temporal_attention.cu) at their edges: bf16 K6-K8 on
    the tensor-core kernel and K9 on the SIMT kernel at D = 160 with 16, 24
    and 32 frames (one and two m16 row tiles), at the site head dims 40
    and 80, on q/k/v views into one fused [P, F, 3, H, D] projection and on
    rows 8 bytes past 16-byte alignment (element staging), K9 at
    D % 8 != 0, and fp32 K6, K7, K9 (the SIMT kernel). Each against its
    plain version (one bf16 ulp at max|plain|; fp32 FP32_TOL), each launch
    counted once on its own wrapper. -> the names of the cases that fail."""
    import torch

    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import temporal_attention_cp as KT

    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, fp32 = torch.bfloat16, torch.float32
    kernels = {  # name -> (wrapper, plain, mode)
        "K6": (KA.flash_attention_blockdiag, KA.flash_attention_blockdiag_plain,
               "blockdiag"),
        "K7": (KA.flash_attention_blockdiag_tc,
               KA.flash_attention_blockdiag_tc_plain, "tc"),
        "K8": (KA.flash_attention_blockdiag_tc2,
               KA.flash_attention_blockdiag_tc_plain, "tc"),
        "K9": (KT.temporal_attention_cp, KT.temporal_attention_cp_plain, "cp")}
    cases = [(kname, bf16, 300, F, 8, 160, "contiguous")
             for kname in kernels for F in (16, 24, 32)]
    cases += [(kname, bf16, 500, 16, 8, D, "contiguous")
              for kname in ("K6", "K9") for D in (40, 80)]
    cases += [(kname, bf16, 200, 16, 8, 160, layout)
              for kname in ("K6", "K7", "K9")
              for layout in ("fused-projection views",
                             "rows 8 bytes past 16-byte alignment")]
    cases += [("K9", bf16, 64, 16, 2, 20, "contiguous")]
    cases += [(kname, fp32, 200, 16, 8, 160, "contiguous")
              for kname in ("K6", "K7", "K9")]
    bad = []
    for kname, dtype, P, F, H, D, layout in cases:
        fn, plain, mode = kernels[kname]
        if layout.startswith("fused"):
            q, k, v = torch.randn((P, F, 3, H, D), generator=gen,
                                  device=dev).to(dtype).unbind(dim=2)
        else:
            n = P * F * H * D
            # 8 bytes in elements
            shift = 64 // torch.finfo(dtype).bits if layout.startswith("rows") else 0
            flat = torch.randn(3 * n + shift, generator=gen, device=dev).to(dtype)
            q, k, v = (flat[shift + i * n:shift + (i + 1) * n].view(P, F, H, D)
                       for i in range(3))
        scale = D ** -0.5
        kw = ({"block_p": 1} if kname == "K9" else
              {"block": math.lcm(128, F), **({"heads": H} if kname != "K6" else {})})
        n0 = fn.launches
        out = fn(q, k, v, scale=scale, **kw)
        torch.cuda.synchronize()
        launched = fn.launches - n0
        ref = plain(q, k, v, scale=scale)
        err = (out.float() - ref.float()).abs().max().item()
        tol = bf16_tol(ref) if dtype == bf16 else FP32_TOL
        name = (f"{kname} {KA.temporal_kernel_for(mode, dtype)} "
                f"{str(dtype)[6:]} [{P},{F},{H},{D}] {layout}")
        log(f"[kernels] edge {name}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"launches {launched}")
        if not (err <= tol and launched == 1):
            bad.append(name)
    return bad


@contextlib.contextmanager
def plain_versions(*kernels: str):
    """Swap the plain PyTorch versions in for the named kernels (of K1,
    K2/K3, K4) on CUDA tensors (the references of phases 6, 9 and 27 only;
    the package itself has no such path). Under grad the plain versions
    are differentiated by autograd itself, GroupNormFn included."""
    import torch

    import vdx_torch.ops.attention as A
    import vdx_torch.ops.groupnorm as G
    from vdx_torch.kernels.flash_attention import (flash_attention_dt_plain,
                                                   flash_attention_plain)
    from vdx_torch.kernels.groupnorm import group_norm_moments_plain

    def attn(q, k, v, *, scale, exp_impl, block_k, **_):
        # batch slices of two keep the score tensor small; where two
        # entries' scores pass 2^30 elements (CogVideoX's 17,776 tokens),
        # one entry and as many heads as fit
        B, Sq, H = q.shape[:3]
        per = (1 << 30) // (Sq * k.shape[1])
        bs, hs = (2, H) if 2 * H <= per else (1, max(1, min(H, per)))
        plain = partial(flash_attention_dt_plain, scale=scale,
                        exp_impl=exp_impl, block_k=block_k)
        return torch.cat([
            torch.cat([plain(q[i:i + bs, :, h:h + hs], k[i:i + bs, :, h:h + hs],
                             v[i:i + bs, :, h:h + hs])
                       for h in range(0, H, hs)], dim=2)
            for i in range(0, B, bs)])

    def gn(x, num_groups, scale, bias, eps=1e-5, with_silu=True):
        B, C = x.shape[0], x.shape[-1]
        y = group_norm_moments_plain(x.reshape(B, -1, C), scale, bias,
                                     num_groups=num_groups, eps=eps,
                                     with_silu=with_silu)
        return y.reshape(x.shape)

    class GNPlain:
        """GroupNormFn's stand-in under grad: the plain version, which
        autograd differentiates itself (phase 27's plain path)."""

        backward_calls = 0  # none: autograd runs the plain version's own

        @staticmethod
        def apply(x, scale, bias, num_groups, eps, with_silu):
            return gn(x, num_groups, scale, bias, eps, with_silu)

    swaps = {"K1": [(A, "flash_attention_dt", attn)],
             "K2/K3": [(G, "group_norm_silu_cuda", gn),
                       (G, "GroupNormFn", GNPlain)],
             "K4": [(A, "flash_attention", flash_attention_plain)]}
    saved = [(mod, attr, getattr(mod, attr)) for k in kernels
             for mod, attr, _ in swaps[k]]
    for k in kernels:
        for mod, attr, fn in swaps[k]:
            setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def counters():
    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels.groupnorm import (fused_group_norm,
                                             fused_group_norm_2phase)
    from vdx_torch.kernels.temporal_attention_cp import temporal_attention_cp

    return {"K1": KA.flash_attention_dt, "K2": fused_group_norm,
            "K3": fused_group_norm_2phase, "K4": KA.flash_attention,
            "K6": KA.flash_attention_blockdiag,
            "K7": KA.flash_attention_blockdiag_tc,
            "K8": KA.flash_attention_blockdiag_tc2,
            "K9": temporal_attention_cp}


def form_counters() -> dict:
    """Every flash attention count but K1's and K4's on the wgmma + TMA
    pipeline, by KA.counter_for's names: K1' per form and K5 on that
    pipeline, and off it (the template and SIMT kernels) each form's
    " template" name, staticmax as "K1 static" and K4 as "K4 template"."""
    from vdx_torch.kernels import flash_attention as KA

    return {n: c for n, c in KA.launch_counts().items() if n not in ("K1", "K4")}


def reset_counters() -> None:
    from vdx_torch.kernels import flash_attention as KA

    for fn in counters().values():
        fn.launches = 0
    forms = KA.flash_attention_dt.form_launches
    for name in forms:
        forms[name] = 0
    KA.flash_attention.template_launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()} | form_counters()


def counted_run(pipe, fn, stage_ms=None):
    """``fn()`` with the counters reset just before it and read again as
    the pipeline's conditioning ends (its VAE encode: video2video's clip,
    SVD's image) and as its decode starts (Python reads, no synchronise),
    which split each kernel's launches between the encode, the denoise
    loop and the decode. The seconds run to a synchronise after ``fn``
    (output_type="device" returns before the card is done). A dict
    ``stage_ms`` gets each stage's device ms from CUDA events recorded at
    the same marks. -> (result, seconds, seconds until ``fn`` returned,
    launches by stage, peak bytes)"""
    import torch

    marks, events = {}, {}
    decode, encode, prep = pipe._decode, pipe._encode, pipe._prepare_cond

    def mark(name):
        marks[name] = read_counters()
        if stage_ms is not None:
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

    def counted_prep(*args, **kw):
        out = prep(*args, **kw)
        mark("encode")
        return out

    def counted_encode(video, chunk):
        z = encode(video, chunk)
        mark("encode")
        return z

    def counted_decode(latents, chunk, **opts):
        mark("decode")
        return decode(latents, chunk, **opts)

    pipe._decode, pipe._encode = counted_decode, counted_encode
    pipe._prepare_cond = counted_prep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    mark("start")
    t0 = time.time()
    try:
        out = fn()
        returned = time.time() - t0
        mark("end")
        torch.cuda.synchronize()
    finally:
        del pipe._decode, pipe._encode, pipe._prepare_cond
    secs = time.time() - t0
    launches = read_counters()
    enc = marks.get("encode", dict.fromkeys(launches, 0))
    by_stage = {"encode": enc,
                "denoise": {k: marks["decode"][k] - enc[k] for k in launches},
                "decode": {k: n - marks["decode"][k] for k, n in launches.items()}}
    if stage_ms is not None:
        e_enc = events.get("encode", events["start"])
        stage_ms.update(
            encode=events["start"].elapsed_time(e_enc),
            denoise=e_enc.elapsed_time(events["decode"]),
            decode=events["decode"].elapsed_time(events["end"]))
    return out, secs, returned, by_stage, torch.cuda.max_memory_allocated()


def timed_call(pipe, label: str, prompt=PROMPT, keep=None, **kw):
    """One __call__ through :func:`counted_run`. -> (seconds, frames: video
    0 as numpy, or the [B, F, H, W, 3] device tensor, latents finite,
    launches by stage, peak bytes); ``keep["latents"]`` gets the latents
    when ``keep`` is a dict."""
    import torch

    out, secs, returned, by_stage, peak = counted_run(
        pipe, lambda: pipe(prompt, **kw))
    launches = {k: by_stage["encode"][k] + by_stage["denoise"][k] + n
                for k, n in by_stage["decode"].items()}
    lat_finite = bool(torch.isfinite(out.latents).all())
    if keep is not None:
        keep["latents"] = out.latents
    frames = out.frames if torch.is_tensor(out.frames) else out.frames[0]
    n_frames = math.prod(frames.shape[:-3])  # [B, F] on the card, [F] numpy
    log(f"[{label}] {kw['num_inference_steps']} "
        f"{(kw.get('scheduler') or pipe.scheduler).upper()} steps + decode: "
        f"{secs:.3f}s (returned after {returned:.3f}s) "
        f"frames/s={n_frames / secs:.4f} "
        f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB) "
        f"launches={launches} encode={by_stage['encode']} "
        f"denoise={by_stage['denoise']} "
        f"decode={by_stage['decode']} frames {tuple(frames.shape)} {frames.dtype} "
        f"min={int(frames.min())} max={int(frames.max())} "
        f"mean={float(frames.float().mean() if torch.is_tensor(frames) else frames.mean()):.2f} "
        f"latents_finite={lat_finite}")
    return secs, frames, lat_finite, by_stage, peak


def check_no_forms(by_stage: dict, what: str) -> None:
    """The pipeline's attention is K1 and K4 on the wgmma + TMA pipeline
    only: no K1' or K5 launch on either kernel, no template staticmax ("K1
    static") or template K4 ("K4 template") in a timed call, so the K1 and
    K4 counts prove which kernel ran."""
    ran = {n: d[n] for d in by_stage.values() for n in form_counters() if d[n]}
    if ran:
        raise SystemExit(f"{what}: forms-kernel launches in the pipeline: "
                         f"{ran}")


def check_frames(frames, shape, lat_finite, what: str) -> None:
    import numpy as np

    if frames.shape != shape or frames.dtype != np.uint8:
        raise SystemExit(f"{what}: bad frames {frames.shape} {frames.dtype}")
    if not lat_finite or frames.min() == frames.max():
        raise SystemExit(f"{what}: frames are constant or latents are not finite")


def record_temporal_sites(unet, hw: int, sites: dict, calls: dict):
    """Forward hooks on every motion-module attention (attn1 and attn2 of
    each TemporalBlock): count the calls per (hw, P) and keep, on the
    host, q, k and v [P, F, H, D] of the first call at each P, which is
    the first motion module's attn1 at that level. -> the hook handles."""
    from vdx_torch.nn.temporal import TemporalBlock

    def hook(mod, args, out):
        x = args[0]  # [P, F, C]: norm(x) + frame PE, as attn's forward got it
        P, F_ = x.shape[:2]
        calls[(hw, P)] = calls.get((hw, P), 0) + 1
        if (hw, P) not in sites:
            sites[(hw, P)] = tuple(
                proj(x).view(P, F_, mod.heads, mod.head_dim).cpu()
                for proj in (mod.to_q, mod.to_k, mod.to_v))

    return [attn.register_forward_hook(hook)
            for m in unet.modules() if isinstance(m, TemporalBlock)
            for attn in (m.attn1, m.attn2)]


def reference_eval(pipe, scheduler: str, hw: int, swap, per_call: dict,
                   sites: dict, calls: dict):
    """One denoiser evaluation at the first step's input of ``scheduler``
    at hw x hw, kernel path against the same call with the ``swap``
    kernels replaced by their plain versions; checks the launches of the
    kernel call and the agreement. The kernel call also fills ``sites``
    and ``calls`` (:func:`record_temporal_sites`)."""
    import torch

    from vdx_torch.schedulers import get_sampler

    t0 = time.time()
    with torch.inference_mode():
        ctx = pipe.encode_prompt(PROMPT, WORKLOAD["negative_prompt"])
        tables = pipe._get_tables(scheduler, TIMED_STEPS)
        lat = pipe.initial_noise((1, 16, hw // 8, hw // 8, 4), WORKLOAD["seed"])
        lat = lat * tables.init_noise_sigma
        model_in = get_sampler(scheduler).scale_model_input(
            torch.cat([lat, lat]), 0, tables)
        t_b = tables.timesteps[0].expand(2)
        hooks = record_temporal_sites(pipe.unet, hw, sites, calls)
        reset_counters()
        eps_k = pipe.unet(model_in, t_b, ctx)
        launches = read_counters()
        for h in hooks:
            h.remove()
        with plain_versions(*swap):
            eps_p = pipe.unet(model_in, t_b, ctx)
        rel = ((eps_k.float() - eps_p.float()).norm() / eps_p.float().norm()).item()
    finite = bool(torch.isfinite(eps_k).all())
    log(f"[reference{hw}] UNet eval at the first {scheduler} step's input, "
        f"{hw}x{hw}: rel_l2(kernels vs plain {'+'.join(swap)})={rel:.3e} "
        f"(bound 5e-2: bf16 rounding flips compounding over the network) "
        f"finite={finite} launches_per_unet_call={launches} "
        f"({time.time() - t0:.1f}s)")
    if not (finite and rel < 5e-2):
        raise SystemExit(f"{hw}: denoiser output disagrees with the plain versions")
    bad = {k: n for k, n in per_call.items() if launches[k] != n}
    if bad:
        raise SystemExit(f"{hw}: expected launches per UNet call {per_call}, "
                         f"got {launches}")


def drive_gn2560(dev) -> dict:
    """The GN dispatch that a resnet block calls (ops.groupnorm
    .group_norm_silu) once at each 2560-channel shape, the counters reset
    just before. -> {"dispatch": launches}"""
    import torch

    from vdx_torch.ops.groupnorm import group_norm_silu

    xs = [torch.randn(shape, device=dev).to(dtype)
          for shape, dtype in zip(GN2560_SHAPES, (torch.bfloat16, torch.float32))]
    scale, bias = torch.ones(2560, device=dev), torch.zeros(2560, device=dev)
    torch.cuda.synchronize()
    reset_counters()
    for x in xs:
        group_norm_silu(x, 32, scale, bias, 1e-5)
    launches = read_counters()
    torch.cuda.synchronize()
    log(f"[gn2560] ops.groupnorm.group_norm_silu at {GN2560_SHAPES} "
        f"(bf16, fp32): launches={launches}")
    if launches["K2"] != 2 or launches["K3"]:
        raise SystemExit(f"gn2560: expected K2 twice, K3 never: {launches}")
    return {"dispatch": launches}


def check_gn_sites(dev) -> dict:
    """Every GroupNorm of one UNet call (CFG batch 2 x 16 frames), one
    8-frame decode chunk and one 8-frame encode chunk at 512x512 and
    768x768, and of one UNet call of a two-prompt batch and of the
    server's three-request batch at 512x512 (CFG batch 4 and 6), traced on
    the meta device (scripts/bench_gn_torch.py), each
    driven through ops.groupnorm as often as the path runs it with the GN
    counters reset: one [gn] line a path with the launches (checked
    against the launch plan, kernels.groupnorm.gn_plan), the summed kernel
    ms, the summed bound and the summed F.group_norm (+ F.silu) ms.
    -> {(size, "batch" or "serve", "unet", "decode" or "encode"):
    launches by counter}"""
    import torch

    from vdx_torch.kernels import groupnorm as KG

    bench = load_script("bench_gn_torch")
    expected = {}
    for size, videos in ((512, 1), (768, 1), (512, 2), (512, 3)):
        for path, sites in bench.gn_sites(size, size, videos=videos).items():
            if videos > 1 and path != "unet":  # chunks do not see the batch
                continue
            t0 = time.time()
            want = {"K2": 0, "K3": 0}
            for (B, S, C, G, _, _), n in sites.items():
                want[KG.gn_plan(B, S, C, G, 2).route] += n
            launches = bench.drive(sites, dev)
            sums = bench.path_sums(bench.time_sites(sites, dev))
            what = f"{path} {size}x{size}" + (f", {videos} videos" if videos > 1
                                               else "")
            log(f"[gn] {what}: {sums['sites']} GroupNorms "
                f"through ops.groupnorm, launches {launches} (plan {want}) "
                f"kernel_ms={sums['ms']:.4f} bound_ms={sums['bound_ms']:.4f} "
                f"library_ms={sums['library_ms']:.4f} (F.group_norm + F.silu "
                f"where the site has it; each site's ms times its count) "
                f"({time.time() - t0:.1f}s)")
            if launches != want:
                raise SystemExit(f"[gn] {what}: launches {launches}, "
                                 f"the plan says {want}")
            key = {1: str(size), 2: "batch", 3: "serve"}[videos]
            expected[(key, path)] = want
            torch.cuda.empty_cache()
    expected[("batch", "decode")] = expected[("512", "decode")]
    return expected


def check_gn_launches(by_stage: dict, per_call: dict, size: str, steps: int,
                      chunks: int, encoded: bool = False) -> None:
    """A timed call's GroupNorm launches: the plan's K2 and K3 counts per
    UNet call times the steps, per decode (and encode) chunk times the
    chunks."""
    stages = [("denoise", steps, "unet"), ("decode", chunks, "decode")]
    if encoded:
        stages.append(("encode", chunks, "encode"))
    for stage, times, path in stages:
        want = {k: n * times for k, n in per_call[(size, path)].items()}
        got = {k: by_stage[stage][k] for k in want}
        if got != want:
            raise SystemExit(f"{size}: GroupNorm launches in the {stage} "
                             f"{got}, the plan says {want}")


def check_noise_on_card(pipe, dev) -> None:
    """The seeded initial noise (vdx's jax.random.normal, computed by
    vdx_torch.core.rng) on the card against the CPU, at both paths'
    latent shapes: the bits equal, the normals within RNG_TOL."""
    import torch

    from vdx_torch.core import rng

    seed = WORKLOAD["seed"]
    for hw in (512, 768):
        shape = (1, 16, hw // 8, hw // 8, 4)
        bits_equal = torch.equal(rng.random_bits(seed, shape, dev).cpu(),
                                 rng.random_bits(seed, shape))
        noise = pipe.initial_noise(shape, seed)
        err = (noise.cpu() - rng.normal(seed, shape)).abs().max().item()
        log(f"[rng] seed {seed} latents {list(shape)}: card bits == cpu "
            f"bits {bits_equal}, max |card - cpu| normal {err:.3e} "
            f"(tol {RNG_TOL}), std {noise.std().item():.4f}")
        if not (bits_equal and err <= RNG_TOL and noise.device.type == "cuda"):
            raise SystemExit("the seeded noise differs between the card and the CPU")


TEMPORAL = (  # kernel, entry point, the TPU kernel it replaces
    ("K6", "ops.attention.dot_product_attention(impl='blockdiag') -> "
     "flash_attention_blockdiag", "vdx/kernels/flash_attention.py:490"),
    ("K7", "flash_attention_blockdiag_tc", "vdx/kernels/flash_attention.py:556"),
    ("K8", "flash_attention_blockdiag_tc2", "vdx/kernels/flash_attention.py:684"),
    ("K9", "temporal_attention_cp", "vdx/kernels/temporal_attention_cp.py:62"),
)


# each temporal kernel's mode of csrc/temporal_attention.cu
TEMPORAL_MODE = {"K6": "blockdiag", "K7": "tc", "K8": "tc", "K9": "cp"}


def temporal_entries(P: int, H: int, D: int) -> dict:
    """kernel -> (its entry point, its plain version), each f(q, k, v), at
    a [P, F, H, D] site; K9 with block_p = gcd(P, 128), vdx's 128 except
    at the 768 level-3 site (P = 288: 32)."""
    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import temporal_attention_cp as KT
    from vdx_torch.ops.attention import dot_product_attention

    scale = D ** -0.5
    block_p = math.gcd(P, 128)
    tc_plain = lambda q, k, v: KA.flash_attention_blockdiag_tc_plain(  # noqa: E731
        q, k, v, scale=scale)
    return {
        "K6": (lambda q, k, v: dot_product_attention(q, k, v, impl="blockdiag"),
               lambda q, k, v: KA.flash_attention_blockdiag_plain(
                   q, k, v, scale=scale)),
        "K7": (lambda q, k, v: KA.flash_attention_blockdiag_tc(
            q, k, v, scale=scale, heads=H), tc_plain),
        "K8": (lambda q, k, v: KA.flash_attention_blockdiag_tc2(
            q, k, v, scale=scale, heads=H), tc_plain),
        "K9": (lambda q, k, v: KT.temporal_attention_cp(
            q, k, v, scale=scale, block_p=block_p),
            lambda q, k, v: KT.temporal_attention_cp_plain(q, k, v, scale=scale)),
    }


def check_temporal(dev, sites: dict, calls: dict):
    """Phase 12. The motion-module sites kept in phases 6 and 9, on the
    card: every entry point once per site with the counters reset (the
    run whose counts the kernels line reports), then per site and entry
    point the kernel against its plain version, the kernel, plain, SDPA
    and eager xla_bf16p times, and the kernel's agreement with xla_bf16p
    (what impl="auto" runs there). -> (rows, launches, per-UNet-call ms)"""
    import torch
    import torch.nn.functional as F

    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.ops.attention import dot_product_attention

    keys = sorted(sites, key=lambda key: (key[0], -key[1]))  # 512 first, L0 first
    level = {key: sum(1 for o in keys if o[0] == key[0] and o[1] > key[1])
             for key in keys}
    rows, per_call = [], {}
    with torch.inference_mode():
        on_dev = {key: tuple(t.to(dev) for t in sites[key]) for key in keys}
        torch.cuda.synchronize()
        reset_counters()
        for key in keys:
            q, k, v = on_dev[key]
            for call, _ in temporal_entries(q.shape[0], q.shape[2],
                                            q.shape[3]).values():
                call(q, k, v)
        launches = read_counters()
        torch.cuda.synchronize()
        log(f"[temporal] every entry point once at each of {len(keys)} sites "
            f"{[list(on_dev[key][0].shape) for key in keys]}: "
            f"launches={launches}")
        for kname, _, _ in TEMPORAL:
            if launches[kname] != len(keys):
                raise SystemExit(f"temporal: {kname} launched {launches[kname]} "
                                 f"times over {len(keys)} sites")
        for key in keys:
            t0 = time.time()
            hw, P = key
            q, k, v = on_dev[key]
            _, F_, H, D = q.shape
            where = f"L{level[key]} motion attn1, {hw}x{hw}"
            eager = lambda: dot_product_attention(  # noqa: E731
                q, k, v, impl="xla_bf16p")
            eager_out = eager()
            eager_ms = cuda_ms(eager)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [P, H, F, D]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=D ** -0.5))
            site_calls = calls[key]
            per_call.setdefault(str(hw), {"eager_xla_bf16p_ms": 0.0,
                                          "sites": 0})
            per_call[str(hw)]["eager_xla_bf16p_ms"] += eager_ms * site_calls
            per_call[str(hw)]["sites"] += site_calls
            for kname, entry, replaces in TEMPORAL:
                call, plain = temporal_entries(P, H, D)[kname]
                out, ref = call(q, k, v), plain(q, k, v)
                err = (out.float() - ref.float()).abs()
                tol = bf16_tol(ref)
                agree = (out.float() - eager_out.float()).abs().max().item()
                agree_tol = 4 * bf16_tol(eager_out)
                ms = cuda_ms(lambda: call(q, k, v))
                plain_ms = cuda_ms(lambda: plain(q, k, v), reps=3, warmup=1)
                per_call[str(hw)][f"{kname}_ms"] = \
                    per_call[str(hw)].get(f"{kname}_ms", 0.0) + ms * site_calls
                # two F x F x D products; K9's arithmetic is fp32 (FMA
                # pipes), K6-K8's operands bf16
                peak = H100_FP32_FLOPS if kname == "K9" else H100_BF16_FLOPS
                b_ms, b_by = bound(
                    4.0 * P * H * F_ * F_ * D, 4 * q.numel() * q.element_size(),
                    peak, float(P * H * F_ * F_))  # one exponential a score
                route = KA.temporal_kernel_for(TEMPORAL_MODE[kname], q.dtype)
                rows.append(dict(
                    name=f"{kname} {entry.rsplit(' ', 1)[-1]} "
                         f"[{P},{F_},{H},{D}] ({where}; {route})",
                    kernel=kname, path="temporal", stage="sites", route="cuda",
                    source="vdx_torch/csrc/temporal_attention.cu",
                    replaces=replaces, max_abs_err=err.max().item(),
                    mean_abs_err=err.mean().item(), tol=tol, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms,
                    library="F.scaled_dot_product_attention on [P, H, F, D] "
                            "views", bound_ms=b_ms, bound_by=b_by,
                    xla_bf16p_ms=eager_ms, xla_bf16p_max_abs_diff=agree,
                    xla_bf16p_tol=agree_tol, calls_per_unet_call=site_calls,
                    seconds=time.time() - t0,
                    note=(f"block_p={math.gcd(P, 128)} (128 does not divide "
                          f"P)" if kname == "K9" and P % 128 else "")))
                del out, ref, err
            log(f"[temporal] {where} [{P},{F_},{H},{D}] x{site_calls} per UNet "
                f"call: eager xla_bf16p {eager_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                + ", ".join(f"{r['kernel']} {r['ms']:.4f} ms (plain "
                            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
                            f"{r['bound_by']}, err {r['max_abs_err']:.2e} tol "
                            f"{r['tol']:.2e}, vs xla_bf16p "
                            f"{r['xla_bf16p_max_abs_diff']:.2e} tol "
                            f"{r['xla_bf16p_tol']:.2e})"
                            for r in rows[-len(TEMPORAL):])
                + f" ({time.time() - t0:.1f}s)")
            del on_dev[key], eager_out, qt, kt, vt
            torch.cuda.empty_cache()
    log(f"[temporal] per UNet call (sum over its temporal sites, ms): {per_call}")
    bad = [r["name"] for r in rows if not (r["max_abs_err"] <= r["tol"] and
           r["xla_bf16p_max_abs_diff"] <= r["xla_bf16p_tol"])]
    if bad:
        raise SystemExit(f"temporal kernels disagree with their plain versions "
                         f"or with xla_bf16p: {bad}")
    return rows, {"sites": launches}, per_call


# phase 13: the attention micro-benchmark's shapes, [32, 4096, 8, 40] (the
# 512 level-0 self-attention, scripts/bench_attention.py's), the 768
# level-2 [32, 576, 8, 160] and the same length at D = 256 (the pipeline's
# one-consumer-warpgroup instance; no SD-1.5 site), every form at each,
# all on the wgmma + TMA pipeline (staticmax: K1; the others K1' and K5),
# and K4 (form None, the bench's k4 spec) at D = 256
FORM_SHAPES = ((32, 4096, 8, 40), (32, 576, 8, 160), (32, 576, 8, 256))
FORM_ROWS = [(form, shape) for shape in FORM_SHAPES
             for form in ("exp", "exp2", "fastexp2", "staticaug", "noexp",
                          "mxu_only", "staticmax")]
FORM_ROWS.append((None, (32, 576, 8, 256)))
# exp2 calls per score in each form (fastexp2 and noexp: none on the
# special-function unit; mxu_only: no softmax); fastexp2's cubic takes
# the FMA and integer pipes instead (bound term "alu", its SM clocks a
# score counted from the SASS: scripts/sass_forms.py)
FORM_EXPS = {"exp": 1, "exp2": 1, "fastexp2": 0, "staticmax": 1,
             "staticaug": 1, "noexp": 0, "mxu_only": 0, None: 1}
BENCH_ITERS = 16  # vdx's K in scripts/bench_attention.py


def load_script(name: str):
    """scripts/<name>.py as a module (bench_attn_torch: make_fn, fresh and
    chain; sass_forms: cubic_per_score)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_forms(dev):
    """Phase 13. Each row of FORM_ROWS: the micro-benchmark's chained loop
    (spec dt:1024:1024:<form>, k4 for K4; K = 16) on fresh seeded bf16
    inputs with the counters reset, the run whose counts the kernels line
    reports; then flash_attention_dt in that form (K4: flash_attention)
    against its plain version (same block_k) on the first two batch
    entries, and the kernel, plain and library times beside the bound.
    -> (rows, {stage: launches})"""
    import torch

    from vdx_torch.kernels import flash_attention as KA

    from vdx_torch.kernels import _lib

    bench = load_script("bench_attn_torch")
    sass = load_script("sass_forms")
    cubic, cubic_clocks, evals, diff = sass.cubic_per_score(
        _lib.build_info["path"])
    log(f"[forms] fastexp2's cubic from the SASS (scripts/sass_forms.py, "
        f"DP = {sass.DP}; fastexp2 - noexp {diff} over {evals} "
        f"evaluations): per score {cubic}, {cubic_clocks:.5f} SM clocks a score (fp32 128, "
        f"integer/compare 64, conversion 16 a clock per SM; issue 128)")
    rows, runs = [], {}
    for i, (form, (B, S, H, D)) in enumerate(FORM_ROWS):
        t0 = time.time()
        kname = KA.counter_for(form, torch.bfloat16, D, True)
        scale = D ** -0.5
        q, k, v = bench.fresh((B, S, H, D), S, 100 + i, dev, torch.bfloat16)
        spec = "k4" if form is None else f"dt:1024:1024:{form}"
        fn = bench.make_fn(spec, scale)
        torch.cuda.synchronize()
        reset_counters()
        looped = bench.chain(fn, q, k, v, BENCH_ITERS)
        launches = read_counters()
        torch.cuda.synchronize()
        stage = f"{form or 'K4'} [{B},{S},{H},{D}]"
        runs[stage] = launches
        others = {n: c for n, c in launches.items() if n != kname and c}
        if launches[kname] != BENCH_ITERS or others:
            raise SystemExit(f"forms: the loop of {stage} launched {launches}, "
                             f"expected {kname} {BENCH_ITERS} times, no other")
        if form is None:  # K4: one bf16 ulp at max|plain|
            kw = dict(scale=scale)
            call, plain = KA.flash_attention, KA.flash_attention_plain
            out = call(q, k, v, **kw)
            ref = plain(q[:2], k[:2], v[:2], **kw)
            e = (out[:2].float() - ref.float()).abs()
            err, mean_err = e.max().item(), e.mean().item()
            tol, mag = bf16_tol(ref), ref.float().abs().max().item()
            del ref, e
        else:
            kw = dict(scale=scale, block_k=1024, exp_impl=form)
            call = KA.flash_attention_dt
            plain = KA.flash_attention_dt_plain
            out = call(q, k, v, **kw)
            err, mean_err, tol, mag = KA.plain_err_tol(out[:2], q[:2], k[:2],
                                                       v[:2], **kw)
        finite = bool(torch.isfinite(looped).all() and torch.isfinite(out).all())
        del looped
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if form == "mxu_only":  # the scores rounded to bf16 by the matmul
            qf = (q.float() * (scale * KA.LOG2E)).to(q.dtype).transpose(1, 2)
            library = "two torch.matmul, bf16 scores"
            lib_fn = lambda: torch.matmul(torch.matmul(qf, kt.transpose(-1, -2)),  # noqa: E731
                                          vt)
        elif form == "noexp":
            library, lib_fn = "none (no library call computes noexp)", None
        else:
            library = "F.scaled_dot_product_attention"
            lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, scale=scale)

        def plain_slice():  # one two-entry slice, timed and scaled
            plain(q[:2], k[:2], v[:2], **kw)

        ms = cuda_ms(lambda: call(q, k, v, **kw))
        plain_ms = cuda_ms(plain_slice, reps=3, warmup=1) * (B // 2)
        lib_ms = cuda_ms(lib_fn, reps=5) if lib_fn else None
        scores = float(B * H * S * S)
        b_ms, b_by = bound(4.0 * scores * D, 4 * q.numel() * 2,
                           H100_BF16_FLOPS, FORM_EXPS[form] * scores,
                           cubic_clocks * scores if form == "fastexp2" else 0.0)
        note = "plain_ms: one two-entry slice timed, times 16"
        if form in ("fastexp2", "noexp"):
            note += ("; the kernel also sweeps q.k once more for each "
                     "1024-key period's max (2*B*H*S*S*D operations more, "
                     "the form's own cost, not in the bound)")
        if form == "fastexp2":
            note += (f"; bound term alu: the cubic's {cubic} instructions a "
                     f"score from the SASS, {cubic_clocks:.5f} SM clocks")
        entry = ("flash_attention" if form is None else
                 f"flash_attention_dt exp_impl={form}")
        rows.append(dict(
            name=f"{kname} {entry} [{B},{S},{H},{D}] (attention "
                 f"micro-benchmark, {spec})",
            kernel=kname, path="forms", stage=stage, route="cuda",
            source=f"vdx_torch/csrc/{KA.kernel_for(form, torch.bfloat16, D, True)}.cu",
            replaces=("vdx/kernels/flash_attention.py:393" if form == "staticaug"
                      else "vdx/kernels/flash_attention.py:135" if form is None
                      else "vdx/kernels/flash_attention.py:204"),
            max_abs_err=err, mean_abs_err=mean_err, tol=tol, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, library=library,
            bound_ms=b_ms, bound_by=b_by,
            seconds=time.time() - t0, note=note))
        r = rows[-1]
        log(f"[forms] {r['name']}: launches {launches[kname]} in the loop "
            f"(K={BENCH_ITERS}) max_abs_err={err:.3e} "
            f"mean_abs_err={mean_err:.3e} tol={tol:.3e} max|plain|={mag:.3e} "
            f"(one bf16 ulp at max|plain|, KA.plain_err_tol) "
            f"finite={finite} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} ({library}) "
            f"bound_ms={b_ms:.4f} ({r['bound_by']}) ({r['seconds']:.1f}s)")
        if not (finite and err <= tol):
            raise SystemExit(f"forms: {r['name']} disagrees with its plain "
                             f"version or is not finite")
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    return rows, runs


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def run_batch(pipe2, gn_per_call) -> dict:
    """Phase 14: a two-prompt batch on ``pipe2`` (guidance_rescale 0.7,
    FreeU) with per-video seeds, a per-step guidance schedule and frames
    left on the card."""
    import numpy as np
    import torch

    from vdx_torch.core import rng

    t0 = time.time()
    schedule = np.linspace(8.5, 6.5, TIMED_STEPS, dtype=np.float32)
    w = dict(WORKLOAD, seed=list(BATCH_SEEDS), output_type="device",
             scheduler="ddim")
    F_, H, W = (WORKLOAD[k] for k in ("num_frames", "height", "width"))
    shape = (2, F_, H // 8, W // 8, 4)
    noise = pipe2.initial_noise(shape, list(BATCH_SEEDS))
    per_seed = [torch.equal(noise[b], rng.normal(s, shape[1:], noise.device))
                for b, s in enumerate(BATCH_SEEDS)]
    pipe2(list(BATCH_PROMPTS), num_inference_steps=2, **w)  # warm-up
    with torch.inference_mode():
        ctx = pipe2.encode_prompt(list(BATCH_PROMPTS), WORKLOAD["negative_prompt"])
        tables = pipe2._get_tables("ddim", TIMED_STEPS)
        lat = noise * tables.init_noise_sigma
        t_b = tables.timesteps[0]
        reset_counters()
        eps = pipe2.unet(torch.cat([lat, lat]), t_b.expand(4), ctx)
        launches = read_counters()
        # video b's (uncond, cond) rows against its own CFG pair alone
        rels = [rel_l2(eps[[b, 2 + b]],
                       pipe2.unet(torch.cat([lat[b:b + 1]] * 2), t_b.expand(2),
                                  ctx[[b, 2 + b]]))
                for b in range(2)]
    per_call = {"K1": 10, "K4": 0} | gn_per_call[("batch", "unet")]
    log(f"[batch] noise of video b == rng.normal(seed b) bit for bit: "
        f"{per_seed}; one UNet evaluation of the batch (CFG batch 4, UNet "
        f"batch 64) split per video against its two-row evaluation: rel_l2 "
        f"{rels[0]:.3e} / {rels[1]:.3e} (bar {REL_L2_TOL}) launches per UNet "
        f"call {launches} (plan {per_call}) ({time.time() - t0:.1f}s)")
    if not all(per_seed):
        raise SystemExit("batch: a video's noise is not its seed's draw")
    if not max(rels) < REL_L2_TOL:
        raise SystemExit(f"batch: a video of the batch differs from its "
                         f"single evaluation: {rels}")
    bad = {k: n for k, n in per_call.items() if launches[k] != n}
    if bad:
        raise SystemExit(f"batch: launches per UNet call {launches}, "
                         f"expected {per_call}")
    torch.cuda.empty_cache()
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe2, "batch", prompt=list(BATCH_PROMPTS),
        num_inference_steps=TIMED_STEPS, **dict(w, guidance_scale=schedule))
    chunks = 2 * WORKLOAD["num_frames"] // WORKLOAD["decode_chunk"]
    if by_stage["denoise"]["K1"] != 10 * TIMED_STEPS or by_stage["decode"]["K1"]:
        raise SystemExit(f"batch: launches {by_stage}, expected K1 "
                         f"{10 * TIMED_STEPS} times in the denoise loop")
    check_no_forms(by_stage, "batch")
    check_gn_launches(by_stage, gn_per_call, "batch", TIMED_STEPS, chunks)
    ok = (frames.device.type == pipe2.device.type == "cuda"
          and frames.dtype == torch.uint8
          and tuple(frames.shape) == (2, F_, H, W, 3) and lat_finite
          and all(int(frames[b].min()) < int(frames[b].max()) for b in range(2)))
    log(f"[batch] 2 videos, {TIMED_STEPS} DDIM steps, guidance schedule "
        f"{float(schedule[0])}..{float(schedule[-1])}, guidance_rescale "
        f"{pipe2.guidance_rescale}, FreeU {pipe2.unet.freeu}: {secs:.3f}s, "
        f"{secs / 2:.3f} s/video, max_memory_allocated={peak} "
        f"({peak / 2**30:.2f} GiB), frames {frames.device} {frames.dtype} "
        f"{tuple(frames.shape)}")
    if not ok:
        raise SystemExit(f"batch: frames are not a non-constant CUDA uint8 "
                         f"{[2, F_, H, W, 3]} tensor, or latents not finite")
    return dict(secs=secs, by_stage=by_stage, peak=peak, frames=2 * F_,
                steps=TIMED_STEPS, chunks=chunks, videos=2)


def run_video2video(pipe, clip, dev, gn_per_call) -> dict:
    """Phase 15: phase 7's 16 frames back in at strength 0.6 (15 of 25
    DDIM steps run), with one encode chunk held against the plain K2/K3."""
    import torch

    t0 = time.time()
    w = dict(WORKLOAD, scheduler="ddim", video=clip, strength=V2V_STRENGTH)
    pipe(PROMPT, **dict(w, num_inference_steps=2))  # warm-up: 1 step
    gn_want = gn_per_call[("512", "encode")]
    with torch.inference_mode():
        x = torch.as_tensor(clip[:WORKLOAD["decode_chunk"]], device=dev)
        x = x.float() / 127.5 - 1.0
        reset_counters()
        z = pipe.vae.encode(x)
        launches = read_counters()
        with plain_versions("K2/K3"):
            rel = rel_l2(z, pipe.vae.encode(x))
    log(f"[v2v] one encode chunk {list(x.shape)} -> {list(z.shape)}: rel_l2"
        f"(K2/K3 vs plain)={rel:.3e} (bar {REL_L2_TOL}) GN launches "
        f"K2={launches['K2']} K3={launches['K3']} (plan {gn_want}) "
        f"({time.time() - t0:.1f}s)")
    if not rel < REL_L2_TOL or {k: launches[k] for k in gn_want} != gn_want:
        raise SystemExit("v2v: the encode chunk disagrees with the plain "
                         "versions or with the launch plan")
    torch.cuda.empty_cache()
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "video2video", num_inference_steps=TIMED_STEPS, **w)
    steps = min(max(int(TIMED_STEPS * V2V_STRENGTH), 1), TIMED_STEPS)
    chunks = WORKLOAD["num_frames"] // WORKLOAD["decode_chunk"]
    if by_stage["denoise"]["K1"] != 10 * steps or by_stage["decode"]["K1"] \
            or by_stage["encode"]["K1"]:
        raise SystemExit(f"v2v: launches {by_stage}, expected K1 {10 * steps} "
                         "times in the denoise loop only")
    check_no_forms(by_stage, "video2video")
    check_gn_launches(by_stage, gn_per_call, "512", steps, chunks, encoded=True)
    check_frames(frames, clip.shape, lat_finite, "video2video")
    return dict(secs=secs, by_stage=by_stage, peak=peak, frames=clip.shape[0],
                steps=steps, chunks=chunks, video=frames)


def run_knobs(pipe) -> dict:
    """Phase 16: skip mode, dispatch segments, variable_steps, progress and
    attn_impl at 512x512, KNOB_STEPS DDIM steps, latents out."""
    import torch

    from vdx_torch.pipelines import SkipConfig

    t0 = time.time()
    w = dict(WORKLOAD, scheduler="ddim", num_inference_steps=KNOB_STEPS,
             output_type="latent")
    sibling = partial(sibling_of, pipe)

    calls = []
    plain = pipe(PROMPT, **w).latents
    exact = sibling(skip=SkipConfig(threshold=0.0),
                    progress=lambda i, n: calls.append(i))(PROMPT, **w)
    res = {"skip0_equal": torch.equal(exact.latents, plain),
           "skip0_n_evals": int(exact.n_evals), "skip0_progress": len(calls)}
    calls.clear()
    # a threshold no drift between the forced steps 0 and 5 reaches
    skipping = sibling(skip=SkipConfig(threshold=10.0, warmup_steps=1,
                                       cooldown_steps=1),
                       progress=lambda i, n: calls.append(i))(PROMPT, **w)
    res |= {"skip_n_evals": int(skipping.n_evals), "skip_progress": len(calls),
            "skip_finite": bool(torch.isfinite(skipping.latents).all())}
    res["dispatch2_equal"] = torch.equal(
        pipe(PROMPT, dispatch_steps=2, **w).latents, plain)
    res["variable8_equal"] = torch.equal(
        sibling(variable_steps=8)(PROMPT, **w).latents, plain)
    xla = sibling(attn_impl="xla")
    torch.cuda.synchronize()
    reset_counters()
    lat = xla(PROMPT, **w).latents
    launches = read_counters()
    res |= {"xla_K1": launches["K1"], "xla_K4": launches["K4"],
            "xla_forms": sum(form_counters().values()),
            "xla_rel_l2_vs_flash": rel_l2(lat, plain),
            "xla_finite": bool(torch.isfinite(lat).all())}
    del xla, lat
    torch.cuda.empty_cache()
    log(f"[knobs] {KNOB_STEPS} DDIM steps at 512x512: {res} "
        f"({time.time() - t0:.1f}s)")
    ok = (res["skip0_equal"] and res["skip0_n_evals"] == KNOB_STEPS
          == res["skip0_progress"] and res["skip_n_evals"] < KNOB_STEPS
          and res["skip_n_evals"] == res["skip_progress"] and res["skip_finite"]
          and res["dispatch2_equal"] and res["variable8_equal"]
          and res["xla_K1"] == res["xla_K4"] == res["xla_forms"] == 0
          and res["xla_finite"])
    if not ok:
        raise SystemExit(f"knobs: {res}")
    return res


def sibling_of(pipe, **kw):
    """A pipeline with other knobs over ``pipe``'s modules (its own UNet,
    with ``pipe``'s weights, when ``attn_impl`` changes the attention
    modules)."""
    from vdx_torch.pipelines import AnimateDiffPipeline

    p = AnimateDiffPipeline(unet_config=pipe.unet.config,
                            vae_config=pipe.vae.config,
                            text_config=pipe.text_encoder.config,
                            tokenizer=pipe.tokenizer, policy=pipe.policy,
                            device=pipe.device, **kw)
    if "attn_impl" in kw:
        p.unet.load_state_dict(pipe.unet.state_dict())
    else:
        p.unet = pipe.unet
    p.vae, p.text_encoder = pipe.vae, pipe.text_encoder
    return p


def first_step_inputs(pipe, frames: int = 16):
    """The CFG-batched UNet input, timesteps and context of the first
    DDIM step at 512x512 (phase 6's), from the pipeline's own noise."""
    import torch

    hw = WORKLOAD["height"] // 8
    with torch.inference_mode():
        ctx = pipe.encode_prompt(PROMPT, WORKLOAD["negative_prompt"])
        tables = pipe._get_tables("ddim", TIMED_STEPS)
        lat = pipe.initial_noise((1, frames, hw, hw, 4), WORKLOAD["seed"])
        lat = lat * tables.init_noise_sigma
        return torch.cat([lat, lat]), tables.timesteps[0].expand(2), ctx


def attention_type(key: str) -> str:
    """A PAB cache key's attention type (vdx's routing)."""
    if ".motion_modules." in key:
        return "temporal"
    return "spatial" if key.endswith("attn1") else "cross"


def run_pab(pipe, plain: dict, gn_per_call) -> tuple:
    """Phase 17: phase 7's call under PABConfig() (spatial 2, temporal 4,
    cross 6, warm-up 2, cool-down 2), then every interval 1 against phase
    7's launches and latents, and dispatch_steps=5 against the monolithic
    PAB call. ``plain``: phase 7's latents and denoise launches."""
    import torch

    from vdx_torch.pipelines import PABConfig
    from vdx_torch.pipelines.base import pab_refresh_flags

    t0 = time.time()
    pab = sibling_of(pipe, pab=PABConfig())
    w = dict(WORKLOAD, scheduler="ddim")
    model_in, t_b, ctx = first_step_inputs(pipe)
    with torch.inference_mode():  # the cache's bytes, from step 0's flags
        _, cache = pipe.unet(model_in, t_b, ctx, pab_refresh=pab_refresh_flags(
            pab.pab, 0, TIMED_STEPS))
        cache_bytes = {}
        for k, v in cache.items():
            typ = attention_type(k)
            cache_bytes[typ] = cache_bytes.get(typ, 0) + v.numel() * v.element_size()
        n_sites = {t: sum(attention_type(k) == t for k in cache) for t in cache_bytes}
        del cache, _
    torch.cuda.empty_cache()
    refreshes = {t: sum(bool(pab_refresh_flags(pab.pab, i, TIMED_STEPS)[t])
                        for i in range(TIMED_STEPS))
                 for t in ("spatial", "cross", "temporal")}
    log(f"[pab] cache of one request at {WORKLOAD['height']}x"
        f"{WORKLOAD['width']} ({pipe.policy.compute_dtype}): {cache_bytes} bytes, "
        f"{sum(cache_bytes.values()) / 2**30:.3f} GiB, sites {n_sites}; "
        f"refresh steps of {TIMED_STEPS}: {refreshes} ({time.time() - t0:.1f}s)")
    keep = {}
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pab, "pab", keep=keep, num_inference_steps=TIMED_STEPS, **w)
    want_k1 = 10 * refreshes["spatial"]
    if by_stage["denoise"]["K1"] != want_k1 or by_stage["decode"]["K1"]:
        raise SystemExit(f"pab: launches {by_stage}, expected K1 {want_k1} "
                         "times in the denoise loop (10 a refresh step)")
    check_no_forms(by_stage, "pab")
    chunks = WORKLOAD["num_frames"] // WORKLOAD["decode_chunk"]
    check_gn_launches(by_stage, gn_per_call, "512", TIMED_STEPS, chunks)
    F_, H, W = (WORKLOAD[k] for k in ("num_frames", "height", "width"))
    check_frames(frames, (F_, H, W, 3), lat_finite, "pab")
    lw = dict(w, output_type="latent", num_inference_steps=TIMED_STEPS)
    exact = sibling_of(pipe, pab=PABConfig(1, 1, 1, 1))
    torch.cuda.synchronize()
    reset_counters()
    lat1 = exact(PROMPT, **lw).latents
    launches1 = read_counters()
    seg = pab(PROMPT, dispatch_steps=5, **lw).latents
    res = {"K1": by_stage["denoise"]["K1"], "K1_plain": plain["denoise"]["K1"],
           "K2": by_stage["denoise"]["K2"], "K3": by_stage["denoise"]["K3"],
           "refresh_steps": refreshes, "cache_bytes": cache_bytes,
           "interval1_launches_equal": launches1 == plain["denoise"],
           "interval1_latents_equal": torch.equal(lat1, plain["latents"]),
           "dispatch5_equal": torch.equal(seg, keep["latents"]),
           "rel_l2_vs_plain": rel_l2(keep["latents"], plain["latents"])}
    log(f"[pab] {res} ({time.time() - t0:.1f}s)")
    if not (res["interval1_launches_equal"] and res["interval1_latents_equal"]
            and res["dispatch5_equal"]):
        raise SystemExit(f"pab: {res}")
    return dict(secs=secs, by_stage=by_stage, peak=peak, frames=F_,
                steps=TIMED_STEPS, chunks=chunks), res


def run_context(pipe, gn_per_call) -> tuple:
    """Phase 18: CONTEXT_FRAMES frames at 512x512 under ContextConfig()
    (windows of 16 at stride 8, pyramid weights, FreeNoise): the FreeNoise
    draw on the card against the CPU, one windowed UNet evaluation against
    the plain versions, then the timed call."""
    import torch

    from vdx_torch.core import rng
    from vdx_torch.pipelines import ContextConfig
    from vdx_torch.pipelines.context import (make_freenoise_maker,
                                             make_windowed_apply, window_starts)

    t0 = time.time()
    cfg = ContextConfig()
    cp = sibling_of(pipe, context=cfg)
    F_, seed, H = CONTEXT_FRAMES, WORKLOAD["seed"], WORKLOAD["height"]
    shape = (1, F_, H // 8, H // 8, 4)
    noise = cp.initial_noise(shape, seed)
    cpu = make_freenoise_maker(shape, cfg.frames, "cpu")([rng.prng_key(seed)])
    k_base, k_perm = rng.split(rng.prng_key(seed))
    base_shape = (cfg.frames,) + shape[2:]
    blocks, perm_ok = [], True
    for r in range(1, F_ // cfg.frames):
        k_perm, k = rng.split(k_perm)
        perm = rng.permutation(k, cfg.frames).to(noise.device)
        perm_ok &= torch.equal(noise[0, r * cfg.frames:(r + 1) * cfg.frames],
                               noise[0, :cfg.frames][perm])
    rng_res = {"bits_equal": torch.equal(
                   rng.key_bits(k_base, base_shape, noise.device).cpu(),
                   rng.key_bits(k_base, base_shape)),
               "blocks_permuted_base": bool(perm_ok),
               "bit_equal": torch.equal(noise.cpu(), cpu),
               "max_abs_diff": (noise.cpu() - cpu).abs().max().item()}
    starts = window_starts(F_, cfg.frames, cfg.stride)
    model_in, t_b, ctx = first_step_inputs(cp, F_)
    windowed = make_windowed_apply(cp.unet, total_frames=F_, out_channels=4,
                                   cfg=cfg)
    with torch.inference_mode():
        reset_counters()
        eps_k = windowed(model_in, t_b, ctx)
        launches = read_counters()
        with plain_versions("K1", "K2/K3"):
            eps_p = windowed(model_in, t_b, ctx)
        rel = rel_l2(eps_k, eps_p)
    per_eval = {"K1": 10 * len(starts), "K4": 0} | {
        k: n * len(starts) for k, n in gn_per_call[("512", "unet")].items()}
    log(f"[context] FreeNoise {list(shape)} on the card against the CPU: "
        f"{rng_res} (tol {RNG_TOL}); one windowed UNet evaluation (starts "
        f"{starts}, {eps_k.dtype}): rel_l2(kernels vs plain K1+K2/K3)="
        f"{rel:.3e} (bar {REL_L2_TOL}) launches {launches} (expected "
        f"{per_eval}) ({time.time() - t0:.1f}s)")
    if not (rng_res["bits_equal"] and rng_res["blocks_permuted_base"]
            and rng_res["max_abs_diff"] <= RNG_TOL):
        raise SystemExit("context: the FreeNoise draw differs between the "
                         "card and the CPU")
    if not (rel < REL_L2_TOL and bool(torch.isfinite(eps_k).all())):
        raise SystemExit("context: the windowed evaluation disagrees with "
                         "the plain versions")
    if any(launches[k] != n for k, n in per_eval.items()):
        raise SystemExit(f"context: launches {launches}, expected {per_eval}")
    del eps_k, eps_p
    torch.cuda.empty_cache()
    secs, frames, lat_finite, by_stage, peak = timed_call(
        cp, "context", num_inference_steps=TIMED_STEPS,
        **dict(WORKLOAD, scheduler="ddim", num_frames=F_))
    want_k1 = 10 * len(starts) * TIMED_STEPS
    if by_stage["denoise"]["K1"] != want_k1 or by_stage["decode"]["K1"]:
        raise SystemExit(f"context: launches {by_stage}, expected K1 "
                         f"{want_k1} times in the denoise loop")
    check_no_forms(by_stage, "context")
    chunks = F_ // WORKLOAD["decode_chunk"]
    check_gn_launches(by_stage, gn_per_call, "512", TIMED_STEPS * len(starts),
                      chunks)
    check_frames(frames, (F_, H, H, 3), lat_finite, "context")
    res = {"windows": len(starts), "starts": starts, "rng": rng_res,
           "rel_l2_window_eval": rel, "K1": by_stage["denoise"]["K1"],
           "K2": by_stage["denoise"]["K2"], "K3": by_stage["denoise"]["K3"]}
    return dict(secs=secs, by_stage=by_stage, peak=peak, frames=F_,
                steps=TIMED_STEPS, chunks=chunks), res


def ulp(x, bits: int):
    """One ulp of each element of ``x`` at ``bits`` significant bits (8 for
    bf16, 24 for fp32)."""
    import torch

    e = torch.frexp(x.float()).exponent
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - bits)


def run_lora(pipe, gn_per_call) -> dict:
    """Phase 19: a rank-8 peft adapter over every default target of the
    UNet, from seeded factors, written with the port's .safetensors writer
    and loaded at scale 0.8; every merged weight against the plain fp32
    merge on the CPU; one UNet evaluation; scale 0 and unload against the
    pristine weights."""
    import torch

    from vdx_torch.core import lora as L
    from vdx_torch.core.safetensors_io import save_file

    t0 = time.time()
    sd = pipe.unet.state_dict()
    targets = L.target_paths(sd, rules=pipe._conversion_rules()["unet"][0])
    gen = torch.Generator().manual_seed(0)
    factors, file_sd = {}, {}
    for k in targets:
        d_out, d_in = sd[k].shape
        A = torch.randn((LORA_RANK, d_in), generator=gen) / d_in ** 0.5
        B = torch.randn((d_out, LORA_RANK), generator=gen) * 0.1 / LORA_RANK ** 0.5
        factors[k] = (A, B)
        stem = "unet." + k[: -len(".weight")]
        file_sd[f"{stem}.lora_A.weight"] = A
        file_sd[f"{stem}.lora_B.weight"] = B
    SCRATCH.mkdir(parents=True, exist_ok=True)
    path = SCRATCH / "lora_peft.safetensors"
    save_file(file_sd, path, metadata={"format": "pt"})
    pristine = {k: sd[k].clone() for k in targets}
    storage = {k: sd[k].data_ptr() for k in targets}
    torch.cuda.synchronize()
    t1 = time.time()
    report = pipe.load_lora(path, scale=LORA_SCALE)
    torch.cuda.synchronize()
    load_s = time.time() - t1
    path.unlink()
    # the bar: one bf16 ulp of the merged weight (of the larger of the
    # two, where they straddle a power of two), plus the fp32 rounding of
    # the sum's terms (4 ulps of |W| + s |B| |A|; cuBLAS and the CPU sum
    # the rank-8 product in other orders), which shows only where W and
    # s * delta cancel and the result is far below its terms
    merged = pipe.unet.state_dict()
    worst, n_elems, n_past_ulp = 0.0, 0, 0
    for k in targets:
        A, B = factors[k]
        W = pristine[k].float().cpu()
        want = (W + torch.tensor(LORA_SCALE) * (A.T @ B.T).T).to(torch.bfloat16)
        terms = W.abs() + LORA_SCALE * (B.abs() @ A.abs())
        got = merged[k].cpu().float()
        diff = (got - want.float()).abs()
        one = ulp(torch.maximum(got.abs(), want.float().abs()), 8)
        worst = max(worst, (diff / (one + 4 * ulp(terms, 24))).max().item())
        n_past_ulp += int((diff > one).sum())
        n_elems += diff.numel()
    model_in, t_b, ctx = first_step_inputs(pipe)
    with torch.inference_mode():
        reset_counters()
        eps = pipe.unet(model_in, t_b, ctx)
        launches = read_counters()
        finite = bool(torch.isfinite(eps).all())
        del eps
    pipe.set_lora_scale(0.0)
    now = pipe.unet.state_dict()
    scale0 = all(torch.equal(now[k], pristine[k]) for k in targets)
    pipe.unload_lora()
    now = pipe.unet.state_dict()
    unloaded = all(torch.equal(now[k], pristine[k]) and now[k].data_ptr() == storage[k]
                   for k in targets)
    per_call = {"K1": 10, "K4": 0} | gn_per_call[("512", "unet")]
    res = {"sites": len(targets), "converted": len(report["converted"]),
           "skipped": len(report["skipped"]),
           "unused_lora_keys": len(report["unused_lora_keys"]),
           "adapter_params": sum(A.numel() + B.numel() for A, B in factors.values()),
           "merged_elems": n_elems, "load_lora_s": load_s,
           "max_err_over_bar": worst, "elems_past_one_bf16_ulp": n_past_ulp,
           "eval_finite": finite,
           "eval_launches": {k: launches[k] for k in per_call},
           "scale0_equal_pristine": scale0, "unload_equal_pristine": unloaded}
    log(f"[lora] rank {LORA_RANK} peft adapter at scale {LORA_SCALE}: {res} "
        f"({time.time() - t0:.1f}s)")
    ok = (res["converted"] == res["sites"] > 0 and not res["skipped"]
          and not res["unused_lora_keys"] and worst <= 1.0 and finite
          and res["eval_launches"] == per_call and scale0 and unloaded)
    if not ok:
        raise SystemExit(f"lora: {res}")
    return res


def run_checkpoints(pipe) -> dict:
    """Phase 20: the pipeline's weights as diffusers-named .safetensors
    files (the SD-1.5 UNet without its motion keys, the motion adapter,
    the VAE, the text tower) through from_pretrained into a second
    pipeline, then save_checkpoint / load_checkpoint; every tensor and one
    UNet evaluation against the first pipeline's."""
    import shutil

    import torch

    from vdx_torch.core.safetensors_io import save_file
    from vdx_torch.pipelines import AnimateDiffPipeline

    def all_equal(a, b):
        pairs = ((a.unet, b.unet), (a.vae, b.vae), (a.text_encoder, b.text_encoder))
        for m, n in pairs:
            sa, sb = m.state_dict(), n.state_dict()
            if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
                return False
        return True

    t0 = time.time()
    d = SCRATCH / "pretrained"
    d.mkdir(parents=True, exist_ok=True)
    unet = pipe.unet.state_dict()
    files = {n: d / f"{n}.safetensors" for n in ("unet", "motion", "vae", "text")}
    save_file({k: v for k, v in unet.items() if ".motion_modules." not in k},
              files["unet"])
    save_file({k: v for k, v in unet.items() if ".motion_modules." in k},
              files["motion"])
    save_file(pipe.vae.state_dict(), files["vae"])
    save_file(pipe.text_encoder.state_dict(), files["text"])
    sizes = {n: f.stat().st_size for n, f in files.items()}
    write_s = time.time() - t0
    t1 = time.time()
    pipe_b = AnimateDiffPipeline.from_pretrained(
        {"unet": [str(files["unet"]), str(files["motion"])],
         "vae": str(files["vae"]), "text": str(files["text"])},
        unet_config=pipe.unet.config, vae_config=pipe.vae.config,
        text_config=pipe.text_encoder.config, tokenizer=pipe.tokenizer,
        policy=pipe.policy, device=pipe.device)
    torch.cuda.synchronize()
    load_s = time.time() - t1
    shutil.rmtree(d)
    loaded_equal = all_equal(pipe, pipe_b)
    model_in, t_b, ctx = first_step_inputs(pipe)
    with torch.inference_mode():
        eval_equal = torch.equal(pipe.unet(model_in, t_b, ctx),
                                 pipe_b.unet(model_in, t_b, ctx))
    d2 = SCRATCH / "checkpoint"
    t1 = time.time()
    pipe.save_checkpoint(d2)
    save_s = time.time() - t1
    pipe_b.init_params(1)
    scrambled = not all_equal(pipe, pipe_b)
    t1 = time.time()
    pipe_b.load_checkpoint(d2)
    torch.cuda.synchronize()
    reload_s = time.time() - t1
    shutil.rmtree(d2)
    round_trip = all_equal(pipe, pipe_b)
    del pipe_b
    torch.cuda.empty_cache()
    res = {"file_bytes": sizes, "write_s": write_s, "from_pretrained_s": load_s,
           "loaded_equal": loaded_equal, "unet_eval_equal": eval_equal,
           "save_checkpoint_s": save_s, "load_checkpoint_s": reload_s,
           "round_trip_equal": scrambled and round_trip}
    log(f"[checkpoints] {res} ({time.time() - t0:.1f}s)")
    if not (loaded_equal and eval_equal and res["round_trip_equal"]):
        raise SystemExit(f"checkpoints: {res}")
    return res


def study_rel(got: float, want: float, scale: float = 0.0) -> float:
    return abs(got - want) / max(abs(want), scale, 1e-30)


def compare_metrics(card, cpu) -> dict:
    """The largest relative difference of each kind of value between two
    VideoMetrics of the same frames (spreads against their mean's scale)."""
    worst = {"basic": 0.0, "warp": 0.0, "lpips": 0.0, "flow": 0.0}
    for a, b in zip(card.frame_metrics, cpu.frame_metrics):
        worst["basic"] = max(worst["basic"], study_rel(a.mse, b.mse),
                             study_rel(a.psnr, b.psnr))
        worst["warp"] = max(worst["warp"], study_rel(a.warp_error, b.warp_error))
        worst["lpips"] = max(worst["lpips"], study_rel(a.lpips, b.lpips))
        worst["flow"] = max(worst["flow"],
                            study_rel(a.flow_magnitude_mean, b.flow_magnitude_mean),
                            study_rel(a.flow_magnitude_std, b.flow_magnitude_std))
    kinds = {"mean_mse": "basic", "mean_psnr": "basic", "flicker_index": "basic",
             "std_mse": ("basic", cpu.mean_mse),
             "mean_warp_error": "warp",
             "warp_error_variance": ("warp", cpu.mean_warp_error ** 2),
             "mean_lpips": "lpips", "std_lpips": ("lpips", cpu.mean_lpips),
             "temporal_consistency_score": "lpips",
             "mean_flow_magnitude": "flow",
             "flow_magnitude_variance": ("flow", cpu.mean_flow_magnitude ** 2)}
    for field, kind in kinds.items():
        kind, scale = kind if isinstance(kind, tuple) else (kind, 0.0)
        worst[kind] = max(worst[kind], study_rel(getattr(card, field),
                                                 getattr(cpu, field), scale))
    return worst


SUMMARY_KEYS = ["experiment_id", "video_name", "guidance_scale",
                "num_inference_steps", "phase", "mean_mse", "std_mse",
                "mean_lpips", "std_lpips", "mean_flow_magnitude",
                "flow_magnitude_variance", "mean_warp_error",
                "warp_error_variance", "temporal_consistency_score",
                "flicker_index"]


def run_study(pipe, gn_per_call) -> dict:
    """Phase 21: two configs of the grid plan generated alone and as one
    batch, then measured on the card against the CPU."""
    import dataclasses

    import torch

    from vdx_torch.harness import (generate_batch, generate_video,
                                   plan_grid_search)
    from vdx_torch.metrics import (LPIPSMetric, OpticalFlowEstimator,
                                   measure_video, save_metrics, save_summary)
    from vdx_torch.metrics import flow as flow_mod
    from vdx_torch.metrics.temporal import unit_frames

    t_phase = time.time()
    plan = plan_grid_search(phase="cfg", video_filter="corgi_beach")
    configs = [c for c in plan if c.guidance_scale in STUDY_CFGS]
    sizes = {(c.num_frames, c.height, c.width, c.num_inference_steps) for c in configs}
    if len(configs) != 2 or sizes != {(16, 512, 512, 25)}:
        raise SystemExit(f"study: the plan gave {configs}")
    configs = [dataclasses.replace(c, **STUDY_OVERRIDE) for c in configs]
    c0 = configs[0]
    F_, H, W, steps = c0.num_frames, c0.height, c0.width, c0.num_inference_steps
    sched, dchunk = pipe.scheduler, WORKLOAD["decode_chunk"]
    warm = [dataclasses.replace(c, num_inference_steps=2) for c in configs]
    generate_video(pipe, warm[0], output_type="device")
    generate_batch(pipe, warm, sched, decode_chunk=dchunk)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # every UNet call's input shape, and the first call's (x, t, context)
    unet_in, first = [], {}

    def record(module, args):
        if not unet_in:
            first.update(x=args[0].clone(), t=args[1].clone(), ctx=args[2].clone())
        unet_in.append(tuple(args[0].shape))

    hook = pipe.unet.register_forward_pre_hook(record)
    try:
        singles = []
        for c in configs:
            unet_in.clear()
            frames, secs, _, by_stage, peak = counted_run(
                pipe, lambda c=c: generate_video(pipe, c, output_type="device"))
            singles.append(dict(frames=frames[0], secs=secs, by_stage=by_stage,
                                peak=peak, unet_in=list(unet_in), first=dict(first)))
        unet_in.clear()
        batch, b_secs, _, b_stage, b_peak = counted_run(
            pipe, lambda: generate_batch(pipe, configs, sched, decode_chunk=dchunk))
        b_unet_in, b_first = list(unet_in), dict(first)
    finally:
        hook.remove()
    # video b's rows of the batch's first UNet call (uncond b, cond b) are
    # its single call's, bit for bit: its seed's noise, scaled alike, and
    # its own prompt pair
    routed = [torch.equal(b_first[k][[b, 2 + b]], s["first"][k])
              for b, s in enumerate(singles) for k in ("x", "ctx")] \
        + [torch.equal(b_first["t"][:2], s["first"]["t"]) for s in singles]
    hw = (H // 8, W // 8, 4)
    for s in singles:
        if s["unet_in"] != [(2, F_) + hw] * steps:
            raise SystemExit(f"study: a single call's UNet inputs {s['unet_in']}")
        if s["by_stage"]["denoise"]["K1"] != 10 * steps or s["by_stage"]["decode"]["K1"]:
            raise SystemExit(f"study: single call launches {s['by_stage']}")
        check_no_forms(s["by_stage"], "study single")
        check_gn_launches(s["by_stage"], gn_per_call, "512", steps, F_ // dchunk)
    # the batch: ONE UNet call a step at CFG batch 4 x 16 frames = 64
    if not all(routed):
        raise SystemExit(f"study: the batch's first UNet inputs are not the "
                         f"single calls' (x, context per video; t): {routed}")
    if b_unet_in != [(4, F_) + hw] * steps:
        raise SystemExit(f"study: the batch's UNet inputs {b_unet_in}, "
                         f"expected {steps} calls at {(4, F_) + hw}")
    if b_stage["denoise"]["K1"] != 10 * steps or b_stage["decode"]["K1"]:
        raise SystemExit(f"study: batch launches {b_stage}, expected K1 "
                         f"{10 * steps} in the denoise loop (10 a step)")
    check_no_forms(b_stage, "study batch")
    check_gn_launches(b_stage, gn_per_call, "batch", steps, 2 * F_ // dchunk)
    # the pipeline is on the card (phase 4), and so are the batch's frames
    ok = (batch.device.type == pipe.device.type and batch.dtype == torch.uint8
          and tuple(batch.shape) == (2, F_, H, W, 3))
    if not ok:
        raise SystemExit(f"study: batch frames {batch.device} {batch.dtype} "
                         f"{tuple(batch.shape)}")
    # F8: cuBLAS and cuDNN pick other algorithms at UNet batch 64, and 25
    # steps carry the difference into the frames; a batching fault (a
    # video with another seed, scale or prompt) moves it to the scale of
    # the two configs' distance from each other
    rels = [rel_l2(batch[b], s["frames"]) for b, s in enumerate(singles)]
    levels = [int((batch[b].int() - s["frames"].int()).abs().max())
              for b, s in enumerate(singles)]
    apart = rel_l2(singles[0]["frames"], singles[1]["frames"])
    crossed = [rel_l2(batch[b], singles[1 - b]["frames"]) for b in range(2)]
    log(f"[study] {len(configs)} configs of plan_grid_search(phase='cfg', "
        f"video_filter='corgi_beach') at CFG {STUDY_CFGS}, {F_}f {H}x{W}, "
        f"{steps} {sched.upper()} steps: single calls "
        f"{[round(s['secs'], 3) for s in singles]} s (s/video), peak "
        f"{[s['peak'] for s in singles]} B "
        f"({max(s['peak'] for s in singles) / 2**30:.2f} GiB); the batch "
        f"{b_secs:.3f} s ({b_secs / 2:.3f} s/video), peak {b_peak} B "
        f"({b_peak / 2**30:.2f} GiB), UNet input {b_unet_in[0]} x "
        f"{len(b_unet_in)}, launches denoise {b_stage['denoise']} decode "
        f"{b_stage['decode']}; batch frames against the single calls: rel-L2 "
        f"{rels[0]:.3e} / {rels[1]:.3e} (bar {REL_L2_TOL}), max "
        f"{levels} levels; against the other config's single call "
        f"{crossed[0]:.3e} / {crossed[1]:.3e}; the two single calls "
        f"{apart:.3e} apart; the first UNet call's inputs per video equal "
        f"the single calls': {all(routed)}")
    # with random weights CFG 5.0 and 9.0 leave the frames only ~3e-2
    # apart, so each video must also sit nearer its own config's single
    # call than the other's: the per-video guidance reached the card
    if not (max(rels) < REL_L2_TOL and all(r < x for r, x in zip(rels, crossed))):
        raise SystemExit(f"study: a batch's video differs from its single "
                         f"call: rel-L2 {rels}, against the other config's "
                         f"{crossed}, the configs {apart} apart")
    for s in singles:
        f = s["frames"]
        if int(f.min()) == int(f.max()):
            raise SystemExit("study: constant frames")

    # measure_video on the card, then the same frames on the CPU
    t0 = time.time()
    flow = OpticalFlowEstimator("native")
    native = dict(flow_mod.build_info)
    lp = LPIPSMetric(seed=0)
    lp_cpu = LPIPSMetric(seed=0, device="cpu")
    out_dir = SCRATCH / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    measured, timings, worst = [], [], {}
    for c, s in zip(configs, singles):
        frames = s["frames"]
        unit_equal = torch.equal(unit_frames(frames).cpu(),
                                 unit_frames(frames.cpu()))
        cfg = dataclasses.asdict(c)
        parts = {}
        torch.cuda.synchronize()
        t1 = time.time()
        m = measure_video(frames, c.video_name, c.experiment_id, cfg, lp, flow,
                          timings=parts)
        parts["total"] = time.time() - t1
        t1 = time.time()
        m_cpu = measure_video(frames.cpu(), c.video_name, c.experiment_id, cfg,
                              lp_cpu, flow)
        parts["cpu_total"] = time.time() - t1
        diff = compare_metrics(m, m_cpu)
        for k, v in diff.items():
            worst[k] = max(worst.get(k, 0.0), v)
        bad = {k: v for k, v in diff.items()
               if v > (STUDY_LPIPS_REL if k == "lpips" else STUDY_REL)}
        log(f"[study] measure_video {c.experiment_id}: {m.num_frames} frames "
            f"on {frames.device}, seconds {parts}; mean_mse {m.mean_mse:.6e} "
            f"mean_psnr {m.mean_psnr:.4f} mean_lpips {m.mean_lpips:.6f} "
            f"mean_flow_magnitude {m.mean_flow_magnitude:.6f} mean_warp_error "
            f"{m.mean_warp_error:.6e} flicker {m.flicker_index:.6e} score "
            f"{m.temporal_consistency_score:.6f}; against the CPU, largest "
            f"relative difference {diff} (bars {STUDY_REL}, LPIPS and score "
            f"{STUDY_LPIPS_REL}); [0, 1] frames on the card == CPU: {unit_equal}")
        if bad or not unit_equal or m.frame_metrics[0].frame_idx != 0 \
                or len(m.frame_metrics) != F_ - 1:
            raise SystemExit(f"study: measure_video on the card against the "
                             f"CPU: {diff}, unit frames equal {unit_equal}")
        save_metrics(m, out_dir / f"{m.experiment_id}_metrics.json")
        measured.append(m)
        timings.append(parts)
    save_summary(measured, out_dir / "grid_search_results.json")
    with open(out_dir / "grid_search_results.json") as f:
        summary = json.load(f)
    if [list(r) for r in summary] != [SUMMARY_KEYS] * len(configs):
        raise SystemExit(f"study: summary keys {[list(r) for r in summary]}")
    names = sorted(p.name for p in out_dir.iterdir())
    log(f"[study] native flow build {native}; files {names} in "
        f"{out_dir} ({time.time() - t0:.1f}s measuring, "
        f"{time.time() - t_phase:.1f}s phase)")
    return dict(single_s=[s["secs"] for s in singles],
                single_peak=[s["peak"] for s in singles],
                batch_s=b_secs, batch_s_per_video=b_secs / 2, batch_peak=b_peak,
                batch_launches=b_stage, batch_rel_l2=rels, batch_max_levels=levels,
                configs_rel_l2=apart, crossed_rel_l2=crossed,
                first_inputs_equal=all(routed),
                measure_s=timings, worst_rel=worst, native_flow=native,
                files=names)

def http_call(port: int, method: str, path: str, body=None):
    """One request on its own connection -> (status, JSON payload)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HANG_BUDGET_S)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def in_threads(*calls) -> list:
    """Each call in a worker thread of its own, all started together ->
    their results in order; a call's exception is raised here."""
    import threading

    out = [None] * len(calls)

    def run(i, fn):
        try:
            out[i] = (True, fn())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out[i] = (False, e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for ok, v in out:
        if not ok:
            raise v
    return [v for _, v in out]


def paeth_png(frame) -> bytes:
    """A PNG of ``frame`` (uint8 [H, W, 3]) with the Paeth filter on every
    row, as a client's adaptive encoder writes most rows: the decoder's
    slow path (the card's machine has no Pillow to write one)."""
    import struct
    import zlib

    import numpy as np

    x = frame.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    H, W, _ = frame.shape
    rows = np.full((H, 1 + 3 * W), 4, np.uint8)
    rows[:, 1:] = ((x - pred) & 0xFF).astype(np.uint8).reshape(H, 3 * W)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def run_serving(pipe, clip, v2v_frames, gn_per_call) -> tuple:
    """Phase 22: the 512 main path served over HTTP on phase 7's modules
    (GenerationServer on 127.0.0.1, an ephemeral port; every request on
    its own http.client connection from a worker thread). -> (the batch's
    path record, the phase's summary)"""
    import base64
    import shutil

    import numpy as np
    import torch

    from vdx_torch.harness import batched
    from vdx_torch.io.png import decode_pngs, encode_png
    from vdx_torch.serving import (BatchingGenerationService, GenerationServer,
                                   GenerationService, JobManager, ProgressRelay)
    from vdx_torch.tracing import ForwardTracer

    t_phase = time.time()
    relay = ProgressRelay()
    sp = sibling_of(pipe, scheduler="ddim", progress=relay)
    journal = SCRATCH / "journal"
    shutil.rmtree(journal, ignore_errors=True)
    F_, H, W = (WORKLOAD[k] for k in ("num_frames", "height", "width"))
    # the services' defaults are phase 7's call (GenerationService's own,
    # but for the CPU rehearsal's smaller WORKLOAD and TIMED_STEPS)
    defaults = dict(num_frames=F_, height=H, width=W,
                    num_inference_steps=TIMED_STEPS,
                    guidance_scale=WORKLOAD["guidance_scale"],
                    negative_prompt=WORKLOAD["negative_prompt"])

    def frames_of(payload):
        return decode_pngs([base64.b64decode(f) for f in payload["frames"]])

    def levels(a, b):
        return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())

    def rel(a, b):
        return rel_l2(torch.from_numpy(a), torch.from_numpy(b))

    # the codec on 16 frames: the server's own files (filter 0), and a
    # client's (Paeth on every row) for the decoder's diagonal path
    t0 = time.time()
    pngs = [encode_png(f) for f in clip]
    enc_s = time.time() - t0
    t0 = time.time()
    back = decode_pngs(pngs)
    dec_s = time.time() - t0
    paeth = [paeth_png(f) for f in clip]
    t0 = time.time()
    back_paeth = decode_pngs(paeth)
    dec_paeth_s = time.time() - t0
    codec = dict(encode_s=enc_s, decode_s=dec_s, decode_paeth_s=dec_paeth_s,
                 bytes=sum(map(len, pngs)), paeth_bytes=sum(map(len, paeth)))
    log(f"[serve] PNG codec, {len(clip)} frames {list(clip.shape[1:])}: "
        f"encode {enc_s:.4f}s ({codec['bytes']} B), decode {dec_s:.4f}s, "
        f"decode of Paeth-filtered files {dec_paeth_s:.4f}s "
        f"({codec['paeth_bytes']} B); round trips exact: "
        f"{np.array_equal(back, clip)} / {np.array_equal(back_paeth, clip)}")
    if not (np.array_equal(back, clip) and np.array_equal(back_paeth, clip)):
        raise SystemExit("serve: the PNG codec does not round-trip the frames")

    server = GenerationServer(GenerationService(sp, defaults), port=0,
                              journal_dir=journal)
    bsvc = BatchingGenerationService(sp, defaults, scheduler="ddim",
                                     autostart=False)
    bserver = GenerationServer(bsvc, port=0)
    server.start()
    bserver.start()
    real_denoise = batched.denoise_batch
    try:
        # 1. health
        code, health = in_threads(lambda: http_call(server.port, "GET",
                                                    "/healthz"))[0]
        log(f"[serve] GET /healthz: {code} {health}")
        if code != 200 or health["device"] != "cuda":
            raise SystemExit(f"serve: /healthz {code} {health}")

        # 2. the sync route, one request at a time: phase 7's call first
        sync = []
        for r in SERVE_REQUESTS:
            t0 = time.time()
            code, out = in_threads(lambda r=r: http_call(
                server.port, "POST", "/generate", r))[0]
            secs = time.time() - t0
            if code != 200 or out["num_frames"] != F_:
                raise SystemExit(f"serve: POST /generate {code} "
                                 f"{str(out)[:300]}")
            sync.append(dict(secs=secs, server_s=out["timings"]["seconds"],
                             frames=frames_of(out), payload=out))
        direct = levels(sync[0]["frames"], clip)
        log(f"[serve] POST /generate x {len(sync)} ({F_}f {H}x{W}, "
            f"{TIMED_STEPS} DDIM steps): seconds per request {[round(x['secs'], 3) for x in sync]}"
            f" (server's timings {[x['server_s'] for x in sync]}); phase 7's "
            f"request against phase 7's direct pipe(...) call: max "
            f"{direct} uint8 levels apart")
        if direct > 1:
            raise SystemExit(f"serve: the served frames are {direct} levels "
                             "from the direct call's")

        # 3. micro-batching: three requests of one key and one other
        runs = []

        def counted_denoise(p, configs, scheduler="ddim", context=None):
            before = read_counters()
            lat = real_denoise(p, configs, scheduler, context=context)
            after = read_counters()
            runs.append((len(configs), configs[0].num_inference_steps,
                         {k: after[k] - before[k] for k in after}))
            return lat

        batched.denoise_batch = counted_denoise
        reqs = list(SERVE_REQUESTS) + [SERVE_OTHER]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_batch = {}

        def start_when_queued():
            deadline = time.time() + 60
            while len(bsvc._queue) < len(reqs) and time.time() < deadline:
                time.sleep(0.005)
            t_batch["t0"] = time.time()
            bsvc.start_worker()
            return len(bsvc._queue)

        results = in_threads(*[lambda r=r: http_call(bserver.port, "POST",
                                                     "/generate", r)
                               for r in reqs], start_when_queued)
        b_secs = time.time() - t_batch["t0"]
        b_peak = torch.cuda.max_memory_allocated()
        queued = results.pop()
        batched.denoise_batch = real_denoise
        if any(code != 200 for code, _ in results):
            raise SystemExit(f"serve: batched requests {[c for c, _ in results]}"
                             f" {str(results)[:300]}")
        sizes = [out["timings"]["batch_size"] for _, out in results]
        vids = [frames_of(out) for _, out in results]
        per_req = [(n, steps) for n, steps, _ in runs]
        three = [d for n, steps, d in runs if n == 3]
        plan = {"K1": 10 * TIMED_STEPS, "K4": 0} | {
            k: n * TIMED_STEPS for k, n in gn_per_call[("serve", "unet")].items()}
        rels = [[rel(v, s["frames"]) for s in sync] for v in vids[:3]]
        log(f"[serve] BatchingGenerationService, {len(reqs)} requests queued "
            f"({queued} in the queue at start): batches_run "
            f"{bsvc.batches_run}, batch sizes {sizes}, denoise_batch runs "
            f"(videos, steps) {per_req}; {b_secs:.3f}s for all, the batch "
            f"of 3 {results[0][1]['timings']['seconds']}s on the server "
            f"({results[0][1]['timings']['seconds'] / 3:.3f} s/video), the "
            f"10-step request {results[3][1]['timings']['seconds']}s; peak "
            f"{b_peak} B ({b_peak / 2**30:.2f} GiB); the batch's denoise "
            f"launches {three[0] if three else None} (plan at UNet batch "
            f"96: {plan}); rel-L2 of each batch video against the three "
            f"sync requests' frames {[[f'{x:.3e}' for x in r] for r in rels]}"
            f" (bar {REL_L2_TOL}, own call on the diagonal), max levels from "
            f"its own {[levels(v, s['frames']) for v, s in zip(vids, sync)]}")
        if bsvc.batches_run != 2 or sizes != [3, 3, 3, 1] or len(three) != 1:
            raise SystemExit(f"serve: batches_run {bsvc.batches_run}, sizes "
                             f"{sizes}, runs {per_req}")
        bad = {k: (three[0][k], n) for k, n in plan.items() if three[0][k] != n}
        if bad:
            raise SystemExit(f"serve: the batch's denoise launches against "
                             f"the plan at UNet batch 96: {bad}")
        check_no_forms({"denoise": three[0]}, "served batch")
        for b, r in enumerate(rels):
            others = [x for i, x in enumerate(r) if i != b]
            if not (r[b] < REL_L2_TOL and r[b] < min(others)):
                raise SystemExit(f"serve: batch video {b} against the sync "
                                 f"calls {r}: not its own within the bar")
        check_frames(vids[3], (F_, H, W, 3), True, "served 10-step request")

        # 4. the job route with progress, and the journal recovered
        t0 = time.time()
        code, sub = http_call(server.port, "POST", "/jobs", dict(SERVE_REQUESTS[0]))
        steps_seen = []

        def poll():
            deadline = time.time() + HANG_BUDGET_S
            while time.time() < deadline:
                c, st = http_call(server.port, "GET", f"/jobs/{sub['job_id']}")
                if "progress" in st:
                    steps_seen.append(st["progress"]["step"])
                if st["status"] in ("done", "error"):
                    return c, st
                time.sleep(0.02)
            raise SystemExit(f"serve: job {sub} never finished")

        code_st, st = in_threads(poll)[0]
        job_s = time.time() - t0
        code_r, res = in_threads(lambda: http_call(
            server.port, "GET", f"/jobs/{sub['job_id']}/result"))[0]
        job_frames = frames_of(res)

        class Counting:
            calls = 0
            pipe = None

            def generate(self, request):
                Counting.calls += 1
                raise RuntimeError("a recovered finished job ran again")

        jm2 = JobManager({"t2v": Counting()}, journal_dir=journal)
        rec = jm2.status(sub["job_id"])
        rec_res = jm2.result(sub["job_id"])
        rising = sorted(set(steps_seen))
        log(f"[serve] POST /jobs: {code} {sub}; {len(steps_seen)} polls saw "
            f"steps {rising[:6]}...{rising[-3:]}, final {st}; result {code_r}, "
            f"max {levels(job_frames, sync[0]['frames'])} levels from the sync "
            f"route's frames; {job_s:.3f}s submit to done; a second "
            f"JobManager on the journal: {rec}, result equal "
            f"{rec_res == res}, generate calls {Counting.calls}")
        if code != 202 or code_st != 200 or st["status"] != "done" \
                or st.get("progress") != {"step": TIMED_STEPS, "total": TIMED_STEPS} \
                or steps_seen != sorted(steps_seen) or len(rising) < 2:
            raise SystemExit(f"serve: job {st}, progress seen {steps_seen}")
        if code_r != 200 or levels(job_frames, sync[0]["frames"]) > 1:
            raise SystemExit("serve: the job's frames are not the sync route's")
        if rec != {"job_id": sub["job_id"], "status": "done"} \
                or rec_res != res or Counting.calls:
            raise SystemExit(f"serve: journal recovery {rec}, calls "
                             f"{Counting.calls}")

        # 5. video2video over HTTP: phase 7's frames at strength 0.6
        body = dict(SERVE_REQUESTS[0], strength=V2V_STRENGTH, video=[
            base64.b64encode(p).decode("ascii") for p in pngs])
        t0 = time.time()
        code, out = in_threads(lambda: http_call(server.port, "POST", "/v2v",
                                                 body))[0]
        v2v_s = time.time() - t0
        if code != 200:
            raise SystemExit(f"serve: POST /v2v {code} {str(out)[:300]}")
        v2v = frames_of(out)
        v2v_rel = rel(v2v, v2v_frames)
        log(f"[serve] POST /v2v ({len(clip)} frames, strength {V2V_STRENGTH}): "
            f"{code} in {v2v_s:.3f}s (server's {out['timings']['seconds']}s); "
            f"against phase 15's direct call rel-L2 {v2v_rel:.3e} (bar "
            f"{REL_L2_TOL}), max {levels(v2v, v2v_frames)} levels")
        if not v2v_rel < REL_L2_TOL:
            raise SystemExit(f"serve: v2v {v2v_rel} from the direct call")
    finally:
        batched.denoise_batch = real_denoise
        server.stop()
        bserver.stop()
        bsvc.stop_worker()  # its worker thread holds the sibling pipeline
        shutil.rmtree(journal, ignore_errors=True)

    # 6. the tracer on the UNet: one 512 forward, the launches unchanged
    x, t, ctx = first_step_inputs(pipe)
    with torch.inference_mode():
        reset_counters()
        plain = pipe.unet(x, t, ctx)
        plain_launches = read_counters()
        # every module of the UNet whose forward runs, by a global hook
        names = {id(m): n for n, m in pipe.unet.named_modules()}
        ran = set()

        def seen(module, args, out):
            if id(module) in names:
                ran.add(names[id(module)])

        hook = torch.nn.modules.module.register_module_forward_hook(seen)
        try:
            pipe.unet(x, t, ctx)
        finally:
            hook.remove()
        tracer = ForwardTracer(pipe.unet)
        reset_counters()
        traced = tracer.trace(x, t, ctx)
        traced_launches = read_counters()
    hooks_left = sum(len(m._forward_hooks) for m in pipe.unet.modules())
    same = torch.equal(plain, traced)
    log(f"[serve] ForwardTracer on the UNet, one {H}x{W} forward: "
        f"{len(tracer.traces)} modules recorded, {len(ran)} submodules ran a "
        f"forward, {len(tracer.find_shape_changes())} change shape; launches "
        f"traced {traced_launches} against untraced {plain_launches}; output "
        f"torch.equal to the untraced call: {same}; hooks left {hooks_left}")
    if len(tracer.traces) != len(ran) or traced_launches != plain_launches \
            or hooks_left:
        raise SystemExit("serve: the tracer missed modules or changed the "
                         "kernels' launches")

    summary = dict(
        sync_s=[x["secs"] for x in sync],
        sync_server_s=[x["server_s"] for x in sync],
        batch_s=b_secs, batch_server_s=results[0][1]["timings"]["seconds"],
        batch_s_per_video=results[0][1]["timings"]["seconds"] / 3,
        other_s=results[3][1]["timings"]["seconds"], batch_peak=b_peak,
        batch_launches=three[0], batch_rel_l2=rels, job_s=job_s,
        job_polls=len(steps_seen), v2v_s=v2v_s, v2v_rel_l2=v2v_rel,
        served_vs_direct_levels=direct, png=codec,
        traced_modules=len(tracer.traces), tracer_output_equal=same,
        phase_s=time.time() - t_phase)
    log(f"[serve] phase done ({summary['phase_s']:.1f}s)")
    path = dict(secs=results[0][1]["timings"]["seconds"],
                by_stage={"denoise": three[0]}, peak=b_peak, frames=3 * F_,
                steps=TIMED_STEPS, videos=3)
    return path, summary


# ----------------------------------------------------------------------
# phases 23-24: the ModelScope and SVD families
# ----------------------------------------------------------------------
def family_gn_expectations(dev) -> dict:
    """Every GroupNorm of one UNet3D call (CFG batch 2 x 16 frames at
    256x256) and one SD VAE decode chunk (8 frames), of one SVD UNet
    call (2 x 25 frames at 576x1024), one temporal-decoder chunk (5
    frames) and the conditioning image's VAE encode, of Latte's SD VAE
    decode chunk (8 frames at 512x512; its DiT has no GroupNorm) and of
    CogVideoX's causal decode (13 latent frames at 480x720 in six tiles of
    40x40), traced on the meta
    device (scripts/bench_gn_torch.py), each driven through ops.groupnorm
    as often as the path runs it with the GN counters reset: one [gn] line
    a path, its launches checked against the launch plan
    (kernels.groupnorm.gn_plan). -> {(path, "unet" | "decode" |
    "encode"): {"K2": n, "K3": n}}"""
    import torch

    from vdx_torch.kernels import groupnorm as KG

    bench = load_script("bench_gn_torch")
    expected = {}
    for path, family, args, tile in (
            ("ms", "modelscope", (MS_CALL["height"], MS_CALL["width"],
                                  MS_CALL["num_frames"], MS_CALL["decode_chunk"]),
             0),
            ("svd", "svd", (SVD_CALL["height"], SVD_CALL["width"],
                            SVD_CALL["num_frames"], SVD_CALL["decode_chunk"]), 0),
            ("latte", "latte", (LATTE_CALL["height"], LATTE_CALL["width"],
                                LATTE_CALL["num_frames"],
                                LATTE_CALL["decode_chunk"]), 0),
            ("cog", "cogvideox", (COG_CALL["height"], COG_CALL["width"],
                                  COG_CALL["num_frames"], 0),
             COG_CALL["decode_spatial_tile"])):
        for stage, sites in bench.family_gn_sites(family, *args,
                                                  tile=tile).items():
            t0 = time.time()
            want = {"K2": 0, "K3": 0}
            for (B, S, C, G, _, _), n in sites.items():
                want[KG.gn_plan(B, S, C, G, 2).route] += n
            launches = bench.drive(sites, dev)
            log(f"[gn] {family} {stage}: {sum(sites.values())} GroupNorms "
                f"({len(sites)} shapes) through ops.groupnorm, launches "
                f"{launches} (plan {want}) ({time.time() - t0:.1f}s)")
            if launches != want:
                raise SystemExit(f"[gn] {family} {stage}: launches {launches}, "
                                 f"the plan says {want}")
            expected[(path, stage)] = want
            torch.cuda.empty_cache()
    return expected


def check_random_weights(pipe, what: str) -> None:
    """No zero-initialised kernel: every weight of two or more dims (the
    convs, the frame convs whose vdx init is zeros, the linears) holds
    seeded random values, so every branch reaches the output."""
    zero = [f"{c}.{n}" for c, m in pipe._components().items()
            for n, p in m.named_parameters() if p.dim() >= 2 and not p.any()]
    if zero:
        raise SystemExit(f"{what}: all-zero weights {zero[:5]}")


def family_reference_eval(pipe, label: str, model_in, t_b, args,
                          per_call: dict) -> float:
    """One denoiser evaluation, kernel path against the same call with K1
    and K2/K3 swapped for their plain versions; the kernel call's launches
    against ``per_call``. -> rel-L2."""
    import torch

    t0 = time.time()
    with torch.inference_mode():
        reset_counters()
        eps_k = pipe.unet(model_in, t_b, *args)
        launches = read_counters()
        with plain_versions("K1", "K2/K3"):
            eps_p = pipe.unet(model_in, t_b, *args)
        rel = rel_l2(eps_k, eps_p)
    finite = bool(torch.isfinite(eps_k).all())
    log(f"[{label}] UNet eval at the first step's input "
        f"{list(model_in.shape)}: rel_l2(kernels vs plain K1+K2/K3)={rel:.3e} "
        f"(bound {REL_L2_TOL}) finite={finite} launches_per_unet_call="
        f"{launches} ({time.time() - t0:.1f}s)")
    if not (finite and rel < REL_L2_TOL):
        raise SystemExit(f"{label}: denoiser output disagrees with the plain "
                         "versions")
    bad = {k: n for k, n in per_call.items() if launches[k] != n}
    if bad:
        raise SystemExit(f"{label}: expected launches per UNet call "
                         f"{per_call}, got {launches}")
    return rel


def check_family_launches(label: str, by_stage: dict, k1_per_step: int,
                          gn: dict, path: str, steps: int, chunks: int,
                          encodes: int = 0) -> None:
    """A family's timed call: K1 ``k1_per_step`` a step in the denoise
    loop and nowhere else, no K4 and no forms-kernel launch, and K2/K3 as
    the plan says per UNet call, decode chunk and encode."""
    if by_stage["denoise"]["K1"] != k1_per_step * steps \
            or by_stage["decode"]["K1"] or by_stage["encode"]["K1"] \
            or any(d["K4"] for d in by_stage.values()):
        raise SystemExit(f"{label}: launches {by_stage}: expected K1 "
                         f"{k1_per_step * steps} in the denoise loop only")
    check_no_forms(by_stage, label)
    for stage, times, site in (("denoise", steps, "unet"),
                               ("decode", chunks, "decode"),
                               ("encode", encodes, "encode")):
        want = {k: n * times for k, n in gn.get((path, site), {}).items()}
        got = {k: by_stage[stage][k] for k in ("K2", "K3")}
        if got != (want or {"K2": 0, "K3": 0}):
            raise SystemExit(f"{label}: GroupNorm launches in the {stage} "
                             f"{got}, the plan says {want}")


def run_modelscope(gn: dict) -> dict:
    """Phase 23: TextToVideoMSPipeline at full width (UNet3D.modelscope(),
    the ViT-H text tower, the SD VAE; bf16, seeded random weights): a
    warm-up, one denoiser evaluation against the plain versions (K1 5 a
    UNet call at [32, 1024, 5, 64]), then the timed call (16 frames
    256x256, 25 DDIM steps, CFG 7.5) with its launches checked."""
    import torch

    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.pipelines import TextToVideoMSPipeline
    from vdx_torch.schedulers import get_sampler

    t_phase = time.time()
    pipe = TextToVideoMSPipeline.with_random_params(
        seed=0, **({"policy": BF16_POLICY} | FAMILY_BUILD.get("ms", {})))
    n_params = {c: sum(p.numel() for p in m.parameters())
                for c, m in pipe._components().items()}
    check_random_weights(pipe, "modelscope")
    log(f"[modelscope] params {n_params} {pipe.policy.compute_dtype} on "
        f"{pipe.device}, scheduler {pipe.scheduler}, text "
        f"{pipe.text_encoder.config}")
    kw = dict(MS_CALL)
    t0 = time.time()
    pipe(PROMPT, num_inference_steps=2, **kw)
    log(f"[modelscope] warm-up, 2 steps ({time.time() - t0:.1f}s)")

    F_, H, W = kw["num_frames"], kw["height"], kw["width"]
    ds = pipe.vae.config.downscale
    with torch.inference_mode():
        ctx = pipe.encode_prompt(PROMPT, kw["negative_prompt"])
        tables = pipe._get_tables(pipe.scheduler, TIMED_STEPS)
        lat = pipe.initial_noise((1, F_, H // ds, W // ds, 4), kw["seed"]) \
            * tables.init_noise_sigma
        model_in = get_sampler(pipe.scheduler).scale_model_input(
            torch.cat([lat, lat]), 0, tables)
    rel = family_reference_eval(pipe, "modelscope", model_in,
                                tables.timesteps[0].expand(2), (ctx,),
                                {"K1": MS_K1_PER_CALL, "K4": 0}
                                | gn.get(("ms", "unet"), {}))
    del ctx, lat, model_in
    torch.cuda.empty_cache()

    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "modelscope", num_inference_steps=TIMED_STEPS, **kw)
    chunks = F_ // kw["decode_chunk"]
    check_family_launches("modelscope", by_stage, MS_K1_PER_CALL, gn, "ms",
                          TIMED_STEPS, chunks)
    check_frames(frames, (F_, H, W, 3), lat_finite, "modelscope")
    log(f"[modelscope] {secs:.3f}s a video, {F_ / secs:.4f} frames/s, peak "
        f"{peak} ({peak / 2**30:.2f} GiB); phase {time.time() - t_phase:.1f}s")
    del pipe
    return dict(secs=secs, by_stage=by_stage, peak=peak, frames=F_,
                steps=TIMED_STEPS, chunks=chunks, rel_l2_unet_eval=rel,
                params=n_params)


def run_svd(gn: dict, frame) -> tuple:
    """Phase 24: SVDImg2VidPipeline at full width (SVDUNetConfig.svd(),
    CLIP ViT-H vision, the VAE encoder and the temporal decoder; bf16) on
    ``frame`` (phase 7's first frame) resized to 576x1024 as the server
    resizes a client's image: a 2-step warm-up, one denoiser evaluation
    against the plain versions (K1 15 a UNet call at [50, 9216, 5, 64],
    [50, 2304, 10, 64] and [50, 576, 20, 64]), the timed call (25 frames,
    25 EDM steps, decode_chunk 5) with its launches checked by stage and
    its time split by CUDA events, then one POST /img2vid through a
    GenerationServer with the port's Img2VidService against the direct
    call's frames (one uint8 level)."""
    import base64

    import numpy as np
    import torch

    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.io.png import decode_pngs, encode_png
    from vdx_torch.ops.resize import resize_bilinear_u8
    from vdx_torch.pipelines import SVDImg2VidPipeline
    from vdx_torch.schedulers import get_sampler
    from vdx_torch.serving import (GenerationServer, GenerationService,
                                   Img2VidService)

    t_phase = time.time()
    pipe = SVDImg2VidPipeline.with_random_params(
        seed=0, **({"policy": BF16_POLICY} | FAMILY_BUILD.get("svd", {})))
    n_params = {c: sum(p.numel() for p in m.parameters())
                for c, m in pipe._components().items()}
    check_random_weights(pipe, "svd")
    kw = dict(SVD_CALL)
    F_, H, W = kw["num_frames"], kw["height"], kw["width"]
    image = resize_bilinear_u8(frame, W, H).astype(np.float32) / 255.0
    log(f"[svd] params {n_params} {pipe.policy.compute_dtype} on "
        f"{pipe.device}, scheduler {pipe.scheduler}; image {list(frame.shape)} "
        f"-> {list(image.shape)}")
    t0 = time.time()
    pipe(image, num_inference_steps=2, **kw)
    log(f"[svd] warm-up, 2 steps ({time.time() - t0:.1f}s)")

    ds = pipe.vae.config.downscale
    shape = (1, F_, H // ds, W // ds, pipe.latent_channels)
    img = torch.as_tensor(image, device=pipe.device)[None] * 2.0 - 1.0
    cond = (img, float(SVD_FPS - 1), 127.0, 0.02)
    with torch.inference_mode():
        prep = pipe._prepare_cond(kw["seed"], cond, shape)
        tables = pipe._get_tables(pipe.scheduler, TIMED_STEPS)
        lat = pipe.initial_noise(shape, prep["key"]) * tables.init_noise_sigma
        model_in = get_sampler(pipe.scheduler).scale_model_input(
            torch.cat([lat, lat]), 0, tables)
        model_in = torch.cat([model_in, prep["concat"].to(model_in.dtype)], -1)
    rel = family_reference_eval(pipe, "svd", model_in,
                                tables.timesteps[0].expand(2), prep["den_args"],
                                {"K1": SVD_K1_PER_CALL, "K4": 0}
                                | gn.get(("svd", "unet"), {}))
    del prep, lat, model_in
    torch.cuda.empty_cache()

    stage_ms = {}
    out, secs, returned, by_stage, peak = counted_run(
        pipe, lambda: pipe(image, num_inference_steps=TIMED_STEPS, fps=SVD_FPS,
                           **kw), stage_ms)
    frames = out.frames[0]
    chunks = F_ // kw["decode_chunk"]
    log(f"[svd] {TIMED_STEPS} EDM steps + temporal decode: {secs:.3f}s "
        f"(returned after {returned:.3f}s) frames/s={F_ / secs:.4f} "
        f"split: encode+vision {stage_ms['encode']:.1f} ms, denoise "
        f"{stage_ms['denoise']:.1f} ms, decode {stage_ms['decode']:.1f} ms "
        f"(CUDA events) max_memory_allocated={peak} ({peak / 2**30:.2f} GiB) "
        f"encode={by_stage['encode']} denoise={by_stage['denoise']} "
        f"decode={by_stage['decode']} frames {frames.shape} {frames.dtype} "
        f"min={int(frames.min())} max={int(frames.max())} "
        f"mean={float(frames.mean()):.2f}")
    check_family_launches("svd", by_stage, SVD_K1_PER_CALL, gn, "svd",
                          TIMED_STEPS, chunks, encodes=1)
    check_frames(frames, (F_, H, W, 3),
                 bool(torch.isfinite(out.latents).all()), "svd")

    # POST /img2vid: phase 7's frame as a client's PNG, resized by the
    # service; the same request as the direct call above
    svc = GenerationService(pipe, {})
    server = GenerationServer(svc, port=0, img2vid_service=Img2VidService(
        pipe, dict(num_inference_steps=TIMED_STEPS, fps=SVD_FPS, **{
            k: kw[k] for k in ("num_frames", "height", "width",
                               "decode_chunk")}), lock=svc.device_lock))
    server.start()
    try:
        body = {"image": base64.b64encode(encode_png(frame)).decode("ascii"),
                "seed": kw["seed"]}
        t0 = time.time()
        code, payload = in_threads(
            lambda: http_call(server.port, "POST", "/img2vid", body))[0]
        client_s = time.time() - t0
        _, health = in_threads(lambda: http_call(server.port, "GET",
                                                 "/healthz"))[0]
    finally:
        server.stop()
    if code != 200:
        raise SystemExit(f"svd: POST /img2vid {code} {payload}")
    served = decode_pngs([base64.b64decode(f) for f in payload["frames"]])
    levels = int(np.abs(served.astype(np.int16) - frames.astype(np.int16)).max())
    log(f"[svd] POST /img2vid: {code}, {client_s:.3f}s on the client's clock "
        f"({payload['timings']['seconds']}s on the server's), frames "
        f"{served.shape}, max |served - direct| {levels} uint8 levels; "
        f"/healthz img2vid {health.get('img2vid')}")
    if served.shape != frames.shape or levels > 1 \
            or health.get("img2vid", {}).get("requests_served") != 1:
        raise SystemExit("svd: /img2vid differs from the direct call")
    log(f"[svd] {secs:.3f}s a video; phase {time.time() - t_phase:.1f}s")
    del pipe, svc, server
    path = dict(secs=secs, by_stage=by_stage, peak=peak, frames=F_,
                steps=TIMED_STEPS, chunks=chunks, encode_chunks=1)
    summary = dict(stage_ms=stage_ms, rel_l2_unet_eval=rel, params=n_params,
                   img2vid_client_s=client_s,
                   img2vid_server_s=payload["timings"]["seconds"],
                   img2vid_max_levels=levels)
    return path, summary


# ----------------------------------------------------------------------
# phases 25-26: the DiT families, Latte and CogVideoX
# ----------------------------------------------------------------------
def check_dit_weights(pipe, what: str, gates) -> None:
    """:func:`check_random_weights`, and every adaLN gate and output
    projection named by ``gates`` (weight suffixes of the denoiser) holds
    non-zero values, so each block's attention reaches the frames (vdx
    initialises them to zeros: every block the identity)."""
    check_random_weights(pipe, what)
    named = [(n, p) for n, p in pipe.unet.named_parameters()
             if any(n.endswith(g) for g in gates)]
    zero = [n for n, p in named if not p.any()]
    if not named or zero:
        raise SystemExit(f"{what}: gates and output projections {len(named)}, "
                         f"all-zero {zero[:5]}")


def free_card(label: str) -> int:
    """Collect what earlier phases left in reference cycles, so this
    phase's peaks are its own; -> the bytes still allocated, logged (the
    stopped servers of phases 22 and 24 hold nothing: ROADMAP F15)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"[{label}] allocated on the card before the phase: {held} "
        f"({held / 2**30:.2f} GiB)")
    return held


def first_family_input(pipe, prompt, negative_prompt, shape, seed):
    """The first step's CFG-batched model input, its timesteps and the
    text states of a family pipeline (its own sampler and tables)."""
    import torch

    from vdx_torch.schedulers import get_sampler

    with torch.inference_mode():
        ctx = pipe.encode_prompt(prompt, negative_prompt)
        tables = pipe._get_tables(pipe.scheduler, FAMILY_STEPS)
        lat = pipe.initial_noise(shape, seed) * tables.init_noise_sigma
        model_in = get_sampler(pipe.scheduler).scale_model_input(
            torch.cat([lat, lat]), 0, tables)
    return model_in, tables.timesteps[0].expand(2), ctx


def run_latte(gn: dict) -> dict:
    """Phase 25: LattePipeline at full width (LatteConfig.xl(), the SD VAE,
    CLIP ViT-L text; bf16, seeded random weights): a 2-step warm-up, one
    DiT evaluation against the plain K1 (14 a call at [32, 1024, 16, 72],
    no GroupNorm), the timed call (16 frames 512x512, 50 DDIM steps, CFG
    7.5) with its launches checked."""
    import torch

    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.models.dit import LatteConfig
    from vdx_torch.pipelines import LattePipeline

    t_phase = time.time()
    held = free_card("latte")
    pipe = LattePipeline.with_random_params(
        seed=0, **({"unet_config": LatteConfig.xl(), "policy": BF16_POLICY}
                   | FAMILY_BUILD.get("latte", {})))
    n_params = {c: sum(p.numel() for p in m.parameters())
                for c, m in pipe._components().items()}
    check_dit_weights(pipe, "latte", ("adaln.proj.weight", "attn1.to_out.0.weight",
                                      "proj_out.weight", "scale_shift_table"))
    log(f"[latte] params {n_params} {pipe.policy.compute_dtype} on "
        f"{pipe.device}, scheduler {pipe.scheduler}, {pipe.unet.config}")
    kw = dict(LATTE_CALL)
    t0 = time.time()
    pipe(LATTE_PROMPT, num_inference_steps=2, **kw)
    log(f"[latte] warm-up, 2 steps ({time.time() - t0:.1f}s)")

    F_, H, W = kw["num_frames"], kw["height"], kw["width"]
    ds = pipe.vae.config.downscale
    model_in, t_b, ctx = first_family_input(
        pipe, LATTE_PROMPT, kw["negative_prompt"], (1, F_, H // ds, W // ds, 4),
        kw["seed"])
    rel = family_reference_eval(pipe, "latte", model_in, t_b, (ctx,),
                                {"K1": LATTE_K1_PER_CALL, "K4": 0, "K2": 0,
                                 "K3": 0})
    del ctx, model_in
    torch.cuda.empty_cache()

    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "latte", prompt=LATTE_PROMPT, num_inference_steps=FAMILY_STEPS,
        **kw)
    chunks = F_ // kw["decode_chunk"]
    check_family_launches("latte", by_stage, LATTE_K1_PER_CALL, gn, "latte",
                          FAMILY_STEPS, chunks)
    check_frames(frames, (F_, H, W, 3), lat_finite, "latte")
    log(f"[latte] {secs:.3f}s a video, {F_ / secs:.4f} frames/s, peak "
        f"{peak} ({peak / 2**30:.2f} GiB); phase {time.time() - t_phase:.1f}s")
    del pipe
    return dict(secs=secs, by_stage=by_stage, peak=peak, frames=F_,
                steps=FAMILY_STEPS, chunks=chunks, rel_l2_unet_eval=rel,
                params=n_params, held_before=held)


def run_cogvideox(gn: dict) -> tuple:
    """Phase 26: CogVideoXPipeline at full width (CogVideoXConfig.b2(),
    T5Config.xxl(), CausalVAEConfig.cogvideox(); bf16, T5 offloaded): a
    2-step warm-up, one DiT evaluation against the plain K1 (30 a call at
    [2, 17776, 30, 64]), the timed call with the prompt cache cleared (49
    frames 480x720, 50 DDIM steps, CFG 6.0, decode_spatial_tile=40): its
    launches by stage, its ms split by CUDA events into the T5 encode
    (weights to the card and back), the denoise loop and the decode, and
    the peak of each."""
    import torch

    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.models.cogvideox import CausalVAEConfig, CogVideoXConfig
    from vdx_torch.models.t5 import T5Config
    from vdx_torch.pipelines import CogVideoXPipeline

    t_phase = time.time()
    held = free_card("cogvideox")
    pipe = CogVideoXPipeline.with_random_params(
        seed=0, **({"dit_config": CogVideoXConfig.b2(),
                    "vae_config": CausalVAEConfig.cogvideox(),
                    "t5_config": T5Config.xxl(), "policy": BF16_POLICY,
                    "offload_text_encoder": True}
                   | FAMILY_BUILD.get("cog", {})))
    torch.cuda.synchronize()
    n_params = {c: sum(p.numel() for p in m.parameters())
                for c, m in pipe._components().items()}
    check_dit_weights(pipe, "cogvideox", ("norm1.linear.weight",
                                          "norm2.linear.weight",
                                          "attn1.to_out.0.weight",
                                          "proj_out.weight"))
    log(f"[cogvideox] params {n_params} {pipe.policy.compute_dtype} on "
        f"{pipe.device}, scheduler {pipe.scheduler} "
        f"{pipe._sampler_cfg(pipe.scheduler)}, {pipe.unet.config}; init "
        f"{time.time() - t_phase:.1f}s")
    kw = dict(COG_CALL)
    t0 = time.time()
    pipe(COG_PROMPT, num_inference_steps=2, **kw)
    log(f"[cogvideox] warm-up, 2 steps, T5 offloaded to pinned host memory "
        f"({time.time() - t0:.1f}s)")

    F_, H, W = kw["num_frames"], kw["height"], kw["width"]
    vcfg = pipe.vae_config
    shape = (1, 1 + (F_ - 1) // vcfg.temporal_downscale,
             H // vcfg.spatial_downscale, W // vcfg.spatial_downscale,
             pipe.latent_channels)
    model_in, t_b, ctx = first_family_input(pipe, COG_PROMPT, "", shape,
                                            kw["seed"])
    rel = family_reference_eval(pipe, "cogvideox", model_in, t_b, (ctx,),
                                {"K1": COG_K1_PER_CALL, "K4": 0, "K2": 0,
                                 "K3": 0})
    del ctx, model_in
    torch.cuda.empty_cache()

    # the peak of each stage: read and reset where the conditioning ends
    # and where the decode starts
    peaks = {}
    prep, decode = pipe._prepare_cond, pipe._decode

    def stage_peak(name):
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def prep_peak(*a, **k):
        out = prep(*a, **k)
        stage_peak("encode")
        return out

    def decode_peak(*a, **k):
        stage_peak("denoise")
        return decode(*a, **k)

    pipe._prepare_cond, pipe._decode = prep_peak, decode_peak
    pipe._text_cache.clear()  # the timed call encodes: T5 to the card
    stage_ms = {}
    try:
        out, secs, returned, by_stage, peaks["decode"] = counted_run(
            pipe, lambda: pipe(COG_PROMPT, num_inference_steps=FAMILY_STEPS,
                               **kw), stage_ms)
    finally:
        for name in ("_prepare_cond", "_decode"):
            pipe.__dict__.pop(name, None)
    frames = out.frames[0]
    log(f"[cogvideox] T5 encode + {FAMILY_STEPS} DDIM steps + tiled causal "
        f"decode: {secs:.3f}s (returned after {returned:.3f}s) "
        f"frames/s={F_ / secs:.4f} split: T5 encode with its host round trip "
        f"{stage_ms['encode']:.1f} ms, denoise {stage_ms['denoise']:.1f} ms, "
        f"decode {stage_ms['decode']:.1f} ms (CUDA events); peaks: encode "
        f"{peaks['encode'] / 2**30:.2f} GiB, denoise "
        f"{peaks['denoise'] / 2**30:.2f} GiB, decode "
        f"{peaks['decode'] / 2**30:.2f} GiB; encode={by_stage['encode']} "
        f"denoise={by_stage['denoise']} decode={by_stage['decode']} frames "
        f"{frames.shape} {frames.dtype} min={int(frames.min())} "
        f"max={int(frames.max())} mean={float(frames.mean()):.2f}")
    check_family_launches("cogvideox", by_stage, COG_K1_PER_CALL, gn, "cog",
                          FAMILY_STEPS, 1)
    check_frames(frames, (F_, H, W, 3),
                 bool(torch.isfinite(out.latents).all()), "cogvideox")
    log(f"[cogvideox] {secs:.3f}s a video; phase {time.time() - t_phase:.1f}s")
    del pipe, out
    path = dict(secs=secs, by_stage=by_stage, peak=max(peaks.values()),
                frames=F_, steps=FAMILY_STEPS, chunks=1)
    summary = dict(stage_ms=stage_ms, peaks=peaks, rel_l2_unet_eval=rel,
                   params=n_params, held_before=held)
    return path, summary


# ----------------------------------------------------------------------
# phase 27: training at full width
# ----------------------------------------------------------------------
def write_train_clips(root: pathlib.Path) -> None:
    """TRAIN_VIDEOS videos of TRAIN_VIDEO_FRAMES frames, TRAIN_SIZE
    square, as PNGs under ``root/<video>/frames/`` (the grid-search
    artifact layout): seeded colour gradients that drift from frame to
    frame, so consecutive frames differ as a video's do."""
    import numpy as np

    from vdx_torch.io.png import encode_png

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:TRAIN_SIZE, 0:TRAIN_SIZE].astype(np.float32) / TRAIN_SIZE
    for v in range(TRAIN_VIDEOS):
        d = root / f"video_{v}" / "frames"
        d.mkdir(parents=True, exist_ok=True)
        freq = rng.uniform(1.0, 4.0, (3, 2))
        phase = rng.uniform(0, 2 * np.pi, 3)
        for f in range(TRAIN_VIDEO_FRAMES):
            img = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (freq[c, 0] * xx
                                                            + freq[c, 1] * yy)
                                               + phase[c] + 0.2 * f)
                            for c in range(3)], axis=-1)
            (d / f"frame_{f:03d}.png").write_bytes(
                encode_png((img * 255).astype(np.uint8)))


def fn_backward_calls() -> dict:
    """How often each kernel's autograd Function ran its backward."""
    import vdx_torch.kernels.flash_attention as KA
    import vdx_torch.ops.groupnorm as G

    return {"K1 Fn": KA.FlashAttentionDtFn.backward_calls,
            "K4 Fn": KA.FlashAttentionFn.backward_calls,
            "GN Fn": G.GroupNormFn.backward_calls}


def forward_calls(unet):
    """Forward hooks on ``unet`` recording the launch counters around each
    call made on the main thread -> (list of per-call launch dicts, remove
    function). On the card autograd runs the backward, and so remat's
    recompute, on its own device thread, whose calls are left out (a
    recompute may also end early, once it has rebuilt what the backward
    needs, without its post-hook): a step's launches less its forwards'
    are its recomputes'."""
    import threading

    calls, start = [], {}
    main = threading.main_thread()

    def pre(module, args):
        if threading.current_thread() is main:
            start["c"] = read_counters()

    def post(module, args, out):
        if threading.current_thread() is main:
            now = read_counters()
            calls.append({k: now[k] - start["c"][k] for k in now})

    h1 = unet.register_forward_pre_hook(pre)
    h2 = unet.register_forward_hook(post)
    return calls, lambda: (h1.remove(), h2.remove())


def add_counts(dicts, keys=("K1", "K2", "K3", "K4")) -> dict:
    return {k: sum(d[k] for d in dicts) for k in keys}


def global_rel(a: dict, b: dict) -> float:
    """sqrt(sum ||a - b||^2) / sqrt(sum ||b||^2) over tensors by name, in
    fp32."""
    num = den = 0.0
    for n, y in b.items():
        num += float(((a[n].detach().float() - y.float()) ** 2).sum())
        den += float((y.float() ** 2).sum())
    return math.sqrt(num / den)


def run_training(dev) -> tuple:
    """Phase 27: vdx_torch.parallel.train on AnimateDiff's UNetMotion at
    SD-1.5 width (bf16, seeded random weights), on clips read back through
    vdx_torch.data and encoded on the card: (a) one batch's loss and whole
    gradient with the kernels against the plain versions, (b) full steps
    (remat, grad_accum=2, EMA) and (c) rank-8 LoRA steps, timed after a
    warm-up step, with the K1/K2/K3 launches in the forwards, the
    recomputes and the Functions' backward. -> (path record, summary)"""
    import torch
    import torch.nn.functional as F

    import vdx_torch.kernels.flash_attention as KA
    import vdx_torch.ops.groupnorm as G
    from vdx_torch.core import rng
    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.core.lora import init_lora
    from vdx_torch.data import (FrameFolderDataset, VideoClipLoader,
                                encode_clips_to_latents, prefetch_to_device)
    from vdx_torch.parallel import train as TT
    from vdx_torch.pipelines import AnimateDiffPipeline
    from vdx_torch.schedulers.common import ScheduleConfig, make_alphas_cumprod

    t_phase = time.time()
    held = free_card("train")
    root = SCRATCH / "train_clips"
    write_train_clips(root)
    pipe = AnimateDiffPipeline.with_random_params(
        seed=0, **({"policy": BF16_POLICY} | FAMILY_BUILD.get("train", {})))
    unet = pipe.unet
    n_params = sum(p.numel() for p in unet.parameters())
    ds = FrameFolderDataset(root, clip_frames=TRAIN_CLIP,
                            size=(TRAIN_SIZE, TRAIN_SIZE))
    loader = VideoClipLoader(ds, batch_size=TRAIN_BATCH, seed=0)
    ctx1 = pipe.encode_prompt(PROMPT)[1:].clone()  # an ordinary tensor
    ctx = ctx1.expand((TRAIN_BATCH,) + tuple(ctx1.shape[1:])).contiguous()

    # the clips through the loader, copied to the card and encoded there
    torch.cuda.synchronize()
    t0 = time.time()
    reset_counters()
    batches = [encode_clips_to_latents(pipe.vae, b["pixels"])
               for b in prefetch_to_device(iter(loader), dev)]
    torch.cuda.synchronize()
    enc = read_counters()
    encode_s = time.time() - t0
    lat_shape, n_batches = tuple(batches[0].shape), len(batches)
    log(f"[train] UNet {n_params} params {unet.policy.param_dtype}; data: "
        f"{len(ds)} videos, {ds.num_clips()} clips of {TRAIN_CLIP} at "
        f"{TRAIN_SIZE}x{TRAIN_SIZE} as PNGs, {len(batches)} batches of "
        f"{TRAIN_BATCH} read, copied and VAE-encoded in {encode_s:.2f}s "
        f"(latents {lat_shape} {batches[0].dtype}; encode launches "
        f"K2 {enc['K2']} K3 {enc['K3']} K1 {enc['K1']})")
    if not (enc["K2"] and enc["K3"]) or enc["K1"] != 0 or not all(
            torch.isfinite(b).all() for b in batches):
        raise SystemExit(f"[train] the encode: launches {enc}, or latents "
                         "not finite")

    # (a) one batch (B = 1: UNet batch 16) and one key: loss and gradient
    # with the kernels, then with the plain versions
    sched = ScheduleConfig()
    acp = torch.as_tensor(make_alphas_cumprod(sched), device=dev)
    params = dict(unet.named_parameters())

    def loss_and_grads():
        noisy, t, noise = TT.draw(acp, sched.num_train_timesteps,
                                  rng.prng_key(0), batches[0][:1])
        torch.cuda.synchronize()
        reset_counters()
        fn0 = fn_backward_calls()
        t0 = time.time()
        loss = torch.mean((unet(noisy, t, ctx[:1]).float() - noise.float()) ** 2)
        torch.cuda.synchronize()
        t_fwd, fwd = time.time() - t0, read_counters()
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params.values(), torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True))]
        torch.cuda.synchronize()
        t_bwd = time.time() - t0 - t_fwd
        bwd = {k: n - fwd[k] for k, n in read_counters().items()}
        fns = {k: n - fn0[k] for k, n in fn_backward_calls().items()}
        return (loss.detach(), dict(zip(params, grads)), fwd, bwd, fns,
                t_fwd, t_bwd)

    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, fwd, bwd, fns, t_fwd, t_bwd = loss_and_grads()
    peak_grad = torch.cuda.max_memory_allocated()
    with plain_versions("K1", "K2/K3"):
        loss_p, grads_p, fwd_p, _, fns_p, t_fwd_p, t_bwd_p = loss_and_grads()
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel = global_rel(grads_k, grads_p)
    log(f"[train] gradient check, one batch (UNet batch {TRAIN_CLIP}) and "
        f"key: loss {float(loss_k):.6f} (kernels) / {float(loss_p):.6f} "
        f"(plain) rel {loss_rel:.3e} (bar {TRAIN_LOSS_REL}), gradient rel-L2 "
        f"{grad_rel:.3e} (bar {TRAIN_GRAD_REL}); kernel path: forward "
        f"{t_fwd * 1e3:.1f} ms launches {add_counts([fwd])}, backward "
        f"{t_bwd * 1e3:.1f} ms launches {add_counts([bwd])}, Functions' "
        f"backward {fns}; peak {peak_grad / 2**30:.2f} GiB; plain path: "
        f"forward {t_fwd_p * 1e3:.1f} ms backward {t_bwd_p * 1e3:.1f} ms "
        f"launches {add_counts([fwd_p])} Functions {fns_p}")
    gn_fwd = fwd["K2"] + fwd["K3"]
    zeros = dict.fromkeys(("K1", "K2", "K3", "K4"), 0)
    if (fwd["K1"] != TRAIN_K1_PER_CALL or not (fwd["K2"] and fwd["K3"])
            or add_counts([bwd]) != zeros
            or fns != {"K1 Fn": TRAIN_K1_PER_CALL, "K4 Fn": 0, "GN Fn": gn_fwd}
            or add_counts([fwd_p]) != zeros
            or fns_p != dict.fromkeys(fns_p, 0)):
        raise SystemExit(f"[train] gradient check launches: forward {fwd} "
                         f"backward {bwd} Functions {fns}; plain path "
                         f"{fwd_p} {fns_p}")
    if not (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL):
        raise SystemExit(f"[train] the kernel path's loss (rel {loss_rel:.3e}) "
                         f"or gradient (rel-L2 {grad_rel:.3e}) is off the "
                         "plain path's")
    check = dict(loss_kernels=float(loss_k), loss_plain=float(loss_p),
                 loss_rel=loss_rel, grad_rel_l2=grad_rel,
                 forward_ms=t_fwd * 1e3, backward_ms=t_bwd * 1e3,
                 plain_forward_ms=t_fwd_p * 1e3, plain_backward_ms=t_bwd_p * 1e3,
                 forward_launches=add_counts([fwd]), functions_backward=fns,
                 max_memory_allocated=peak_grad)
    del grads_k, grads_p, loss_k, loss_p
    torch.cuda.empty_cache()

    # the Functions alone at the step's shapes: forward + backward against
    # the library's (SDPA; F.group_norm + F.silu)
    def fwd_bwd(fn, *shapes, dtype=torch.bfloat16):
        ins = [torch.randn(s, device=dev, dtype=dtype, requires_grad=True)
               for s in shapes]
        g = torch.randn_like(fn(*ins))
        return cuda_ms(lambda: torch.autograd.grad(fn(*ins), ins, g), reps=5)

    qs = TRAIN_ATTN_SHAPE
    (rs, rC), (ms_, mC) = ((s[:2], s[2]) for s in TRAIN_GN_SHAPES)
    a, r_, m_ = (str(list(x)).replace(" ", "") for x in (qs,) + TRAIN_GN_SHAPES)
    fb = {f"K1 {a}": fwd_bwd(
              lambda q, k, v: KA.flash_attention_dt(
                  q, k, v, scale=qs[-1] ** -0.5, block_q=4096, block_k=1024,
                  exp_impl="staticmax"), qs, qs, qs),
          f"SDPA {a}": fwd_bwd(
              lambda q, k, v: F.scaled_dot_product_attention(
                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  scale=qs[-1] ** -0.5), qs, qs, qs),
          f"K2 GN-SiLU {r_}": fwd_bwd(
              lambda x, w, b: G.group_norm_silu(x, 32, w, b, 1e-5),
              (*rs, rC), (rC,), (rC,)),
          f"group_norm+silu {r_}": fwd_bwd(
              lambda x, w, b: F.silu(F.group_norm(x.transpose(1, 2), 32, w, b,
                                                  1e-5)),
              (*rs, rC), (rC,), (rC,)),
          f"K3 GN {m_}": fwd_bwd(
              lambda x, w, b: G.group_norm(x, 32, w, b, 1e-6),
              (*ms_, mC), (mC,), (mC,)),
          f"group_norm {m_}": fwd_bwd(
              lambda x, w, b: F.group_norm(x.transpose(1, 2), 32, w, b, 1e-6),
              (*ms_, mC), (mC,), (mC,))}
    log("[train] forward + backward ms (CUDA events, median of 5; the "
        "kernels' backward is the plain version's VJP): "
        + ", ".join(f"{k} {v:.3f}" for k, v in fb.items()))
    torch.cuda.empty_cache()

    def run_steps(step, state, label, every_gn_graphed):
        """TRAIN_STEPS steps of ``step``; the first is a warm-up. -> (state,
        losses, s a timed step, peak, launches by stage over the timed
        steps). ``every_gn_graphed``: every GroupNorm's input or weights
        require grad (a full step), so each runs through GroupNormFn; a
        LoRA step's first GroupNorms, before any adapted projection, see
        none and launch their kernel directly."""
        key = rng.prng_key(1)
        losses, secs = [], []
        calls, remove = forward_calls(unet)
        try:
            for i in range(TRAIN_STEPS):
                if i == 1:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    reset_counters()
                    calls.clear()
                    fn0 = fn_backward_calls()
                key, sub = rng.split(key)
                t0 = time.time()
                state, metrics = step(state, {"latents": batches[i % len(batches)],
                                              "context": ctx}, sub)
                losses.append(float(metrics["loss"]))  # synchronises
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
        finally:
            remove()
        total = add_counts([read_counters()])
        fns = {k: n - fn0[k] for k, n in fn_backward_calls().items()}
        fwd = add_counts(calls)
        by_stage = {"forward": fwd,
                    "recompute": {k: total[k] - fwd[k] for k in total},
                    "functions_backward": fns, "step": total}
        timed = secs[1:]
        peak = torch.cuda.max_memory_allocated()
        log(f"[train] {label}: losses {losses}, s a step {timed} (warm-up "
            f"{secs[0]:.3f}s), mean {sum(timed) / len(timed):.3f}s, peak "
            f"{peak} ({peak / 2**30:.2f} GiB); launches over "
            f"{len(timed)} steps ({len(calls)} forwards): forward "
            f"{by_stage['forward']} recompute {by_stage['recompute']} "
            f"Functions' backward {fns}")
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"[train] {label}: losses not finite {losses}")
        n = TRAIN_K1_PER_CALL * len(calls)
        gn = fwd["K2"] + fwd["K3"]
        re = by_stage["recompute"]
        if (fwd["K1"] != n or re["K1"] != n or fns["K1 Fn"] != n
                or not (fwd["K2"] and fwd["K3"])
                or not 0 < fns["GN Fn"] <= gn
                or (every_gn_graphed and fns["GN Fn"] != gn)
                or not 0 < re["K2"] + re["K3"] <= gn or fns["K4 Fn"] != 0):
            raise SystemExit(f"[train] {label}: launches {by_stage}, expected "
                             f"K1 {n} in the forwards, the recomputes and the "
                             "Function's backward, GN in each")
        return state, losses, timed, peak, by_stage

    # (b) full steps: remat, grad_accum 2 (two micro-batches of UNet batch
    # 16), EMA, constant lr
    before = {n: p.detach().clone() for n, p in params.items()}
    opt = TT.make_optimizer(TRAIN_LR)
    state, opt = TT.init_train_state(unet, optimizer=opt, ema=True)
    step = TT.make_train_step(unet, opt, remat=True, grad_accum=2,
                              ema_decay=TRAIN_EMA)
    state, losses, timed, peak, by_stage = run_steps(
        step, state, "full steps (remat, grad_accum=2, EMA 0.999)", True)
    w_rel = global_rel(params, before)
    ema_rel = global_rel(state.ema_params, before)
    log(f"[train] weights moved rel-L2 {w_rel:.3e}, the EMA {ema_rel:.3e} "
        f"from the initial weights")
    if not (w_rel > 0 and ema_rel > 0):
        raise SystemExit("[train] the full steps did not move the weights")
    full = dict(losses=losses, s_per_step=timed, max_memory_allocated=peak,
                launches=by_stage, weights_rel_change=w_rel,
                ema_rel_change=ema_rel)
    del state, step, opt, before
    torch.cuda.empty_cache()

    # (c) rank-8 LoRA steps: the base frozen, through functional_call
    before = {n: p.detach().clone() for n, p in params.items()}
    adapter = init_lora(unet.state_dict(), rank=TRAIN_LORA_RANK, seed=0,
                        rules=pipe._conversion_rules()["unet"][0])
    flat = {n: t.to(dev).requires_grad_()
            for n, t in TT.flatten_adapter(adapter).items()}
    a0 = {n: t.detach().clone() for n, t in flat.items()}
    lopt = TT.make_optimizer(TRAIN_LR)
    lstate, lopt = TT.init_train_state(unet, flat, optimizer=lopt)
    lstate, llosses, ltimed, lpeak, lby_stage = run_steps(
        TT.make_lora_train_step(unet, lopt, remat=True), lstate,
        f"rank-{TRAIN_LORA_RANK} LoRA steps over {len(adapter)} sites (remat)",
        False)
    b_norm = math.sqrt(sum(float((t.float() ** 2).sum())
                           for n, t in lstate.params.items() if n.endswith("#b")))
    a_rel = global_rel({n: t for n, t in lstate.params.items() if n.endswith("#a")},
                       {n: t for n, t in a0.items() if n.endswith("#a")})
    base_same = all(torch.equal(p, before[n]) for n, p in params.items())
    log(f"[train] adapter moved: ||b|| {b_norm:.3e} (0 at init), a rel-L2 "
        f"{a_rel:.3e}; base weights unchanged {base_same}")
    if not (b_norm > 0 and a_rel > 0 and base_same):
        raise SystemExit("[train] LoRA steps: the adapter did not move or the "
                         "base did")
    lora = dict(losses=llosses, s_per_step=ltimed, max_memory_allocated=lpeak,
                launches=lby_stage, b_norm=b_norm, a_rel_change=a_rel,
                sites=len(adapter))
    del lstate, flat, a0, before, batches, pipe, unet, params
    log(f"[train] phase {time.time() - t_phase:.1f}s")
    path = dict(secs=sum(timed), by_stage={"step": by_stage["step"],
                                           "encode": enc},
                peak=peak, frames=len(timed) * TRAIN_BATCH * TRAIN_CLIP,
                steps=len(timed), chunks=n_batches)
    summary = dict(gradient_check=check, fwd_bwd_ms=fb, full=full, lora=lora,
                   encode_s=encode_s, encode_launches=enc, params=n_params,
                   held_before=held)
    return path, summary


# phase 28: frame sharding on a one-rank NCCL mesh. The sharded code at one
# rank against the local path: the all_to_alls, the ring, the halo and the
# sharded GroupNorm run through torch.distributed as at n ranks
FS_RAGGED = 14  # real frames of 16 in the ragged ring evaluation
FS_SVD_T = 1.64  # SVD's first EDM step: c_noise = log(700) / 4
FS_REPS = 3  # CUDA-event timings of each UNet evaluation (median)
FS_GN_REPS = 10  # CUDA-event timings of a UNet call's motion GroupNorms
# the SVD UNet's latent input (frames, h, w) and Latte's (b), (c)
FS_SVD_LATENT = (25, 72, 128)
FS_LATTE_LATENT = (16, 64, 64)


def build_random(factory, dev, seed: int):
    """A module built on the meta device, materialised on ``dev`` with the
    pipelines' conv layout and seeded random weights (random_init_)."""
    import torch

    from vdx_torch.pipelines.base import _channels_last_, random_init_

    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=dev).eval()
    _channels_last_(module)
    random_init_(module, torch.Generator(device=dev).manual_seed(seed))
    return module


def counted_eval(fn):
    """``fn()`` under inference mode with the counters reset just before;
    -> (output, launches)."""
    import torch

    with torch.inference_mode():
        reset_counters()
        out = fn()
        launches = read_counters()
    return out, launches


def nonzero(launches: dict) -> dict:
    return {k: n for k, n in launches.items() if n}


def motion_gn_ms(unet, mesh, call) -> dict:
    """The GroupNorms of a UNet call's motion modules alone, at the inputs
    one ``call()`` gives them: ms for all of them (CUDA events, median of
    FS_GN_REPS) on the kernels (K2/K3, the local route) and on the eager
    statistics over the mesh's frames axis (the sharded route)."""
    import torch

    from vdx_torch.nn.temporal import TemporalTransformer3D

    sites = []
    hooks = [m.norm.register_forward_pre_hook(
        lambda mod, args: sites.append((mod, args[0])))
        for m in unet.modules() if isinstance(m, TemporalTransformer3D)]
    try:
        with torch.inference_mode():
            call()
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        ms = {"kernels": cuda_ms(lambda: [m(x) for m, x in sites],
                                 FS_GN_REPS, 2)}
        with mesh.bind():
            ms["sharded"] = cuda_ms(lambda: [m(x, "frames") for m, x in sites],
                                    FS_GN_REPS, 2)
    ms["sites"] = len(sites)
    return ms


def check_sharded_launches(what: str, local: dict, sharded: dict,
                           gn_off: int) -> None:
    """The routing under frame sharding: every counter as the local call's,
    but K2 + K3 fewer by ``gn_off`` (the frame-spanning GroupNorms take the
    eager sharded statistics, as vdx's route to XLA)."""
    want = dict(local)
    k23 = local["K2"] + local["K3"] - gn_off
    got23 = sharded["K2"] + sharded["K3"]
    bad = {k: (sharded[k], n) for k, n in want.items()
           if k not in ("K2", "K3") and sharded[k] != n}
    if bad or got23 != k23:
        raise SystemExit(f"[frame_shards] {what}: launches {sharded} against "
                         f"the local call's {local}: expected the same but "
                         f"K2 + K3 = {k23} ({gn_off} GroupNorms off the "
                         f"kernels); differing: {bad}")


def run_frame_shards(dev) -> tuple:
    """Phase 28: frame sharding on a one-rank NCCL mesh (a process group of
    one over a file under SCRATCH), at full width in bf16 with seeded random
    weights. (a) UNetMotion at 16 frames 512x512, the CFG batch, phase 6's
    first DDIM input: make_frame_sharded_unet with seq_impl "ulysses" and
    "ring", and ring with 14 real frames of 16 (frames_valid) against the
    local 14-frame call, each at 5e-2 rel-L2, K1 as the local call and K2 +
    K3 one fewer per motion module, ms per evaluation and ms of the motion
    GroupNorms alone on K2/K3 and on the sharded statistics; (b) the SVD UNet
    at 25 frames 576x1024 through make_frame_sharded_svd_unet (the halo
    path at one rank), K2 + K3 two fewer per temporal resblock; (c)
    Latte-XL at 16 frames 512x512 with temporal_impl "ulysses:frames";
    (d) the timed 512 DDIM call with the pipeline's denoiser swapped for the
    one-rank Ulysses sharded apply (the pipeline's frame-sharded path:
    shard-local decode, gathered frames), after a local timed call: the
    first step's eps against the local evaluation's, frames, seconds, peak,
    launches by stage. -> (the path's dict, the phase's summary)"""
    import datetime

    import torch
    import torch.distributed as dist

    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.models.dit import LatteConfig, LatteDiT
    from vdx_torch.models.svd_unet import SVDUNetConfig, UNetSpatioTemporal
    from vdx_torch.nn.resnet import TemporalResBlock
    from vdx_torch.nn.temporal import TemporalTransformer3D
    from vdx_torch.parallel.distributed import health_check, initialize
    from vdx_torch.parallel.frame_parallel import (make_frame_sharded_denoiser,
                                                   make_frame_sharded_svd_unet,
                                                   make_frame_sharded_unet)
    from vdx_torch.parallel.mesh import make_mesh
    from vdx_torch.pipelines import AnimateDiffPipeline

    t_phase = time.time()
    held = free_card("frame_shards")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    store = SCRATCH / "frame_shards_pg"
    store.unlink(missing_ok=True)
    # NCCL on the card (gloo in a CPU rehearsal)
    initialize(f"file://{store}", 1, 0, device=dev.type,
               timeout=datetime.timedelta(seconds=300))
    fs = FAMILY_BUILD.get("frame_shards", {})
    policy = fs.get("policy", BF16_POLICY)
    summary = {"held_before": held}
    try:
        mesh = make_mesh(1, 1, 1)
        log(f"[frame_shards] process group: {dist.get_backend()}, world "
            f"{health_check()}, mesh {mesh.shape} on {mesh.device_type}")

        # (a) UNetMotion at 512: ulysses, ring, ragged ring
        pipe = AnimateDiffPipeline.with_random_params(
            seed=0, **({"policy": policy} | fs.get("pipe", {})))
        unet = pipe.unet
        n_motion = sum(isinstance(m, TemporalTransformer3D) for m in unet.modules())
        model_in, t_b, ctx = first_step_inputs(pipe)
        eps_l, local = counted_eval(lambda: unet(model_in, t_b, ctx))
        applies = {seq: make_frame_sharded_unet(mesh, seq_impl=seq)
                   for seq in ("ulysses", "ring")}
        rel, launches, ms = {}, {"local": local}, {}
        for seq, apply in applies.items():
            eps, launches[seq] = counted_eval(
                lambda: apply(unet, model_in, t_b, ctx))
            rel[seq] = rel_l2(eps, eps_l)
            check_sharded_launches(f"UNetMotion {seq}", local, launches[seq],
                                   n_motion)
            del eps
        mi = model_in[:, :FS_RAGGED]
        eps_l14, local14 = counted_eval(lambda: unet(mi, t_b, ctx))
        padded = torch.cat([mi, torch.zeros_like(model_in[:, FS_RAGGED:])], 1)
        eps, launches["ring_ragged"] = counted_eval(
            lambda: applies["ring"](unet, padded, t_b, ctx, frames_valid=FS_RAGGED))
        rel["ring_ragged"] = rel_l2(eps[:, :FS_RAGGED], eps_l14)
        finite = bool(torch.isfinite(eps).all())
        check_sharded_launches("UNetMotion ring, 14 of 16 frames", local14,
                               launches["ring_ragged"], n_motion)
        del eps, eps_l14, padded
        with torch.inference_mode():
            ms["local"] = cuda_ms(lambda: unet(model_in, t_b, ctx), FS_REPS, 1)
            for seq, apply in applies.items():
                ms[seq] = cuda_ms(lambda: apply(unet, model_in, t_b, ctx),
                                  FS_REPS, 1)
        gn_ms = motion_gn_ms(unet, mesh, lambda: unet(model_in, t_b, ctx))
        log(f"[frame_shards] (a) UNetMotion 16x512x512, CFG batch: rel_l2 "
            f"against the local call ulysses {rel['ulysses']:.3e} ring "
            f"{rel['ring']:.3e}; ring with {FS_RAGGED} of 16 frames against "
            f"the local {FS_RAGGED}-frame call {rel['ring_ragged']:.3e} "
            f"(bar 5e-2), finite={finite}; launches a UNet call "
            f"{ {k: nonzero(d) for k, d in launches.items()} } "
            f"({n_motion} motion GroupNorms off K2/K3); ms a UNet call "
            f"(CUDA events, median of {FS_REPS}) {ms}; the {n_motion} motion "
            f"GroupNorms alone, ms a UNet call (CUDA events, median of "
            f"{FS_GN_REPS}): {gn_ms}")
        if not finite or max(rel.values()) >= 5e-2:
            raise SystemExit(f"[frame_shards] UNetMotion disagrees: {rel}")
        summary["unet_motion"] = dict(rel_l2=rel, launches={
            k: nonzero(d) for k, d in launches.items()},
                                      ms_per_unet_call=ms, motion_modules=n_motion,
                                      motion_gn_ms_per_unet_call=gn_ms)

        # (d) the timed 512 DDIM call, local then on the one-rank mesh
        secs_local, _, _, by_local, peak_local = timed_call(
            pipe, "frame_shards_local", num_inference_steps=TIMED_STEPS,
            scheduler="ddim", **WORKLOAD)
        chunk, hw = WORKLOAD["decode_chunk"], WORKLOAD["height"]
        with torch.inference_mode():
            z = torch.zeros((1, chunk, hw // 8, hw // 8, 4), device=dev)
            _, per_chunk = counted_eval(lambda: pipe._decode_raw(chunk)(z))
        first = {}

        def recording(*args, **kw):
            out = applies["ulysses"](*args, **kw)
            first.setdefault("eps", out)
            return out

        # the pipeline's frame-sharded path at one rank (frame_shards > 1
        # needs as many ranks), swapped in as reference_eval swaps kernels:
        # the one-rank mesh's frames axis sets the shards
        pipe.mesh, pipe._sharded_unet_apply = mesh, recording
        pipe(PROMPT, num_inference_steps=2, scheduler="ddim", **WORKLOAD)
        first.clear()
        secs, frames, lat_finite, by_stage, peak = timed_call(
            pipe, "frame_shards", num_inference_steps=TIMED_STEPS,
            scheduler="ddim", **WORKLOAD)
        rel_first = rel_l2(first["eps"], eps_l)
        check_frames(frames, (16, hw, hw, 3), lat_finite, "frame_shards")
        steps, chunks = TIMED_STEPS, WORKLOAD["num_frames"] // chunk
        den, dec = by_stage["denoise"], by_stage["decode"]
        check_sharded_launches(
            "the timed call's denoise loop", {k: n * steps for k, n in local.items()},
            den, n_motion * steps)
        bad = {k: (dec[k], n * chunks) for k, n in per_chunk.items()
               if dec[k] != n * chunks}
        if bad:
            raise SystemExit(f"[frame_shards] decode launches (got, want): {bad}")
        log(f"[frame_shards] (d) 512 DDIM on the one-rank mesh (Ulysses): "
            f"{secs:.3f}s against the local call's {secs_local:.3f}s "
            f"(+{100 * (secs / secs_local - 1):.1f}%), peak {peak} "
            f"({peak / 2**30:.2f} GiB; local {peak_local / 2**30:.2f}); "
            f"first step's eps against the local evaluation rel_l2 "
            f"{rel_first:.3e} (bar 5e-2)")
        if rel_first >= 5e-2:
            raise SystemExit("[frame_shards] the sharded call's first step disagrees")
        path = dict(secs=secs, by_stage=by_stage, peak=peak, frames=16,
                    steps=steps, chunks=chunks)
        summary["timed_512"] = dict(secs=secs, secs_local=secs_local, peak=peak,
                                    peak_local=peak_local,
                                    rel_l2_first_step=rel_first,
                                    launches_local_by_stage={
                                        k: nonzero(d) for k, d in by_local.items()})
        del pipe, unet, applies, first, model_in, ctx, eps_l, frames
        free_card("frame_shards")

        # (b) the SVD UNet at 25 frames 576x1024
        cfg = fs.get("svd", SVDUNetConfig.svd())
        svd = build_random(lambda: UNetSpatioTemporal(cfg, policy), dev, 1)
        n_tres = sum(isinstance(m, TemporalResBlock) for m in svd.modules())
        gen = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn((2, *FS_SVD_LATENT, cfg.in_channels), generator=gen,
                        device=dev)
        emb = torch.randn((2, 1, cfg.cross_attention_dim), generator=gen,
                          device=dev)
        aids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev)
        t = torch.full((2,), FS_SVD_T, device=dev)
        eps_l, svd_local = counted_eval(lambda: svd(x, t, emb, aids))
        apply = make_frame_sharded_svd_unet(mesh)
        eps, svd_sharded = counted_eval(lambda: apply(svd, x, t, emb, aids))
        rel_svd = rel_l2(eps, eps_l)
        check_sharded_launches("the SVD UNet", svd_local, svd_sharded, 2 * n_tres)
        log(f"[frame_shards] (b) SVD UNet 25x576x1024, CFG batch, halo path: "
            f"rel_l2 {rel_svd:.3e} (bar 5e-2), finite "
            f"{bool(torch.isfinite(eps).all())}; launches local "
            f"{nonzero(svd_local)} sharded {nonzero(svd_sharded)} "
            f"({2 * n_tres} temporal-resblock "
            f"GroupNorms off K2/K3)")
        if rel_svd >= 5e-2 or not bool(torch.isfinite(eps).all()):
            raise SystemExit("[frame_shards] the SVD UNet disagrees")
        summary["svd"] = dict(rel_l2=rel_svd, launches_local=nonzero(svd_local),
                              launches_sharded=nonzero(svd_sharded))
        del svd, x, eps, eps_l
        free_card("frame_shards")

        # (c) Latte-XL at 16 frames 512x512, temporal_impl "ulysses:frames"
        lcfg = fs.get("latte", LatteConfig.xl())
        latte = build_random(lambda: LatteDiT(lcfg, policy), dev, 3)
        x = torch.randn((2, *FS_LATTE_LATENT, 4), generator=gen, device=dev)
        ctx = torch.randn((2, 77, lcfg.cross_attention_dim), generator=gen,
                          device=dev)
        t = torch.full((2,), 961.0, device=dev)
        eps_l, l_local = counted_eval(lambda: latte(x, t, ctx))
        apply = make_frame_sharded_denoiser(mesh, seq_impl="ulysses")
        eps, l_sharded = counted_eval(lambda: apply(latte, x, t, ctx))
        rel_latte = rel_l2(eps, eps_l)
        check_sharded_launches("Latte-XL", l_local, l_sharded, 0)
        log(f"[frame_shards] (c) Latte-XL 16x512x512, ulysses:frames: rel_l2 "
            f"{rel_latte:.3e} (bar 5e-2); launches {nonzero(l_sharded)} (local "
            f"{nonzero(l_local)})")
        if rel_latte >= 5e-2 or not bool(torch.isfinite(eps).all()):
            raise SystemExit("[frame_shards] Latte-XL disagrees")
        summary["latte"] = dict(rel_l2=rel_latte, launches=nonzero(l_sharded))
        del latte, x, eps, eps_l
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    summary["phase_s"] = time.time() - t_phase
    log(f"[frame_shards] phase done ({summary['phase_s']:.1f}s)")
    return path, summary


# phase 29: the rest of the mesh on a one-rank NCCL mesh (window
# parallelism, the data axis, the train step over the mesh) and two ranks
# of 2-way tensor parallelism on the one card over gloo (NCCL refuses two
# ranks on one card; gloo carries the CUDA tensors through the host)
MESH_TRAIN_STEPS = 4  # the first is compared with the single-card step
MESH_TP_SEED = 5  # the tensor-parallel UNet's random weights
MESH_TP_LIMIT = 420  # s for the two ranks to start, build and run
# K1 at the local heads of 2-way TP at 512 (8 heads -> 4 a rank)
MESH_TP_SHAPES = ((32, 4096, 4, 40), (32, 1024, 4, 80))


def tp_rank(rank: int, store: str, out: str, config, policy, device: str) -> None:
    """One rank of phase 29 (e): a gloo group of two on the one card, the
    UNetMotion of ``config`` cut by ``tensor_parallel`` over a 1x1x2 mesh,
    one counted forward of the saved inputs (its seconds include the first
    call's set-up); rank 0 writes its eps, launches, seconds and peak under
    ``out``."""
    sys.path.insert(0, str(ROOT))
    import datetime

    import torch
    import torch.distributed as dist

    from vdx_torch.kernels import _lib
    from vdx_torch.models.unet_motion import UNetMotion
    from vdx_torch.parallel.mesh import make_mesh
    from vdx_torch.parallel.tensor_parallel import tensor_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        _lib.lib()  # the parent's build, cached by source hash
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1, 1, 2)
        unet = build_random(lambda: UNetMotion(config, policy), dev, MESH_TP_SEED)
        tensor_parallel(unet, mesh)
        heads = sorted({m.heads for m in unet.modules()
                        if type(m).__name__ == "Attention"})
        args = [t.to(dev) for t in torch.load(pathlib.Path(out) / "tp_inputs.pt")]
        cuda = dev.type == "cuda"
        with torch.inference_mode():
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.time()
            with mesh.bind():
                eps = unet(*args)
            if cuda:
                torch.cuda.synchronize()
            secs = time.time() - t0
            launches = {k: int(n) for k, n in read_counters().items()}
        if rank == 0:
            torch.save({"eps": eps.cpu(), "launches": launches, "secs": secs,
                        "peak": torch.cuda.max_memory_allocated() if cuda else 0,
                        "split": len(unet.tp_layout), "heads": heads},
                       pathlib.Path(out) / "tp_rank0.pt")
    finally:
        dist.destroy_process_group()


def run_tp_ranks(unet_local, model_in, t_b, ctx, policy) -> dict:
    """Phase 29 (e): two processes on the one card (tp_rank) run the
    tensor-parallel UNet forward; -> rank 0's record with its rel-L2
    against ``unet_local``'s call on the same weights and inputs."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    d = SCRATCH / "mesh_tp"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    torch.save([model_in.cpu(), t_b.cpu(), ctx.cpu()], d / "tp_inputs.pt")
    with torch.inference_mode():
        eps_l = unet_local(model_in, t_b, ctx).float().cpu()
    free_card("mesh_axes")
    t0 = time.time()
    procs = mp.start_processes(
        tp_rank, args=(str(d / "pg"), str(d), unet_local.config, policy,
                       model_in.device.type),
        nprocs=2, join=False, start_method="spawn")
    try:
        while not procs.join(timeout=5):
            if time.time() - t0 > MESH_TP_LIMIT:
                raise SystemExit(f"[mesh_axes] (e) the two ranks still run "
                                 f"after {MESH_TP_LIMIT} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    rec = torch.load(d / "tp_rank0.pt")
    rec["rel_l2"] = rel_l2(rec["eps"].float(), eps_l)
    rec["wall_s"] = time.time() - t0
    del rec["eps"]
    shutil.rmtree(d, ignore_errors=True)
    return rec


def run_mesh_axes(dev) -> tuple:
    """Phase 29: the rest of the mesh at full width in bf16 with seeded
    random weights, on a one-rank NCCL mesh (a process group of one over
    a file under SCRATCH). (a) Window parallelism: phase 18's call (32
    frames at 512x512, ContextConfig(), 25 DDIM steps) through the
    sequential windows and through make_windowed_apply(mesh=) over the
    one-rank frames axis (swapped in as phase 28 swaps its apply:
    frame_shards > 1 needs as many ranks): latents and frames equal bit
    for bit, the launches equal. (b) The data axis: run_batched_experiments
    on two grid configs at 512 (25 DDIM steps) with and without
    mesh=make_mesh(1, 1, 1): the PNG and GIF files byte for byte, s a
    video, launches. (d) K1 at the local heads of 2-way TP against its
    plain version, SDPA and its bound. (e) Two ranks of 2-way TP on the
    one card over gloo: the UNet forward at 512 against the local call.
    (c) Phase 27's training setting (256x256, bf16, batch 2 in two
    micro-batches, remat, EMA): param_sharding_rules all replicated at one
    rank, the batch through prefetch_to_device(sharding=...), the mesh
    step against the single-card step from the same state and key (loss,
    gradient rel-L2, updated parameters), then timed mesh steps. -> (the
    (d) rows, paths, the phase's summary)"""
    import dataclasses
    import datetime
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from vdx_torch import harness as TH
    from vdx_torch.core import rng
    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.data import (FrameFolderDataset, VideoClipLoader,
                                encode_clips_to_latents, prefetch_to_device)
    from vdx_torch.models.unet_motion import UNetMotion, UNetMotionConfig
    from vdx_torch.parallel import train as TT
    from vdx_torch.parallel.distributed import health_check, initialize
    from vdx_torch.parallel.mesh import (batch_sharding, make_mesh,
                                         param_sharding_rules, video_sharding)
    from vdx_torch.parallel.tensor_parallel import tensor_parallel
    from vdx_torch.pipelines import AnimateDiffPipeline, ContextConfig
    from vdx_torch.pipelines import context as C

    t_phase = time.time()
    held = free_card("mesh_axes")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    store = SCRATCH / "mesh_axes_pg"
    store.unlink(missing_ok=True)
    initialize(f"file://{store}", 1, 0, device=dev.type,
               timeout=datetime.timedelta(seconds=300))
    fs = FAMILY_BUILD.get("mesh_axes", {})
    summary, paths = {"held_before": held}, {}
    try:
        mesh = make_mesh(1, 1, 1)
        log(f"[mesh_axes] process group: {dist.get_backend()}, world "
            f"{health_check()}, mesh {mesh.shape} on {mesh.device_type}")

        # (a) window parallelism: phase 18's call, sequential then sharded
        cfg = ContextConfig()
        pipe = AnimateDiffPipeline.with_random_params(
            seed=0, context=cfg, **({"policy": BF16_POLICY} | fs.get("pipe", {})))
        F_, H = CONTEXT_FRAMES, WORKLOAD["height"]
        kw = dict(WORKLOAD, scheduler="ddim", num_frames=F_)
        pipe(PROMPT, **dict(kw, num_inference_steps=2))  # warm-up
        n_windows = len(C.window_starts(F_, cfg.frames, cfg.stride))
        runs = {}
        for label in ("sequential", "sharded"):
            if label == "sharded":
                pipe.mesh, pipe._window_parallel = mesh, True
            C.window_evals.update(sequential=0, sharded=0)
            keep = {}
            secs, frames, lat_finite, by_stage, peak = timed_call(
                pipe, f"mesh_axes {label} windows", keep=keep,
                num_inference_steps=TIMED_STEPS, **kw)
            check_frames(frames, (F_, H, H, 3), lat_finite, f"windows {label}")
            evals = dict(C.window_evals)
            if evals != {**dict.fromkeys(C.window_evals, 0),
                         label: n_windows * TIMED_STEPS}:
                raise SystemExit(f"[mesh_axes] (a) {label}: window evaluations "
                                 f"{evals}, expected {n_windows * TIMED_STEPS} "
                                 f"{label}")
            runs[label] = dict(secs=secs, frames=frames, latents=keep["latents"],
                               by_stage=by_stage, peak=peak, evals=evals)
        seq, par = runs["sequential"], runs["sharded"]
        lat_equal = torch.equal(seq["latents"], par["latents"])
        frames_equal = bool(np.array_equal(seq["frames"], par["frames"]))
        den_s, den_p = seq["by_stage"]["denoise"], par["by_stage"]["denoise"]
        want_k1 = 10 * n_windows * TIMED_STEPS
        log(f"[mesh_axes] (a) {F_} frames in {n_windows} windows, "
            f"{TIMED_STEPS} DDIM steps: "
            f"window-parallel over the one-rank frames axis {par['secs']:.3f}s "
            f"peak {par['peak'] / 2**30:.2f} GiB against the sequential "
            f"windows' {seq['secs']:.3f}s peak {seq['peak'] / 2**30:.2f} GiB; "
            f"latents bit-equal {lat_equal}, frames equal {frames_equal}; "
            f"window evaluations {par['evals']}; denoise launches "
            f"{nonzero(den_p)} (sequential {nonzero(den_s)})")
        if not (lat_equal and frames_equal):
            raise SystemExit("[mesh_axes] (a) the window-parallel call differs "
                             "from the sequential one")
        if den_p != den_s or den_p["K1"] != want_k1:
            raise SystemExit(f"[mesh_axes] (a) denoise launches {den_p}, "
                             f"sequential {den_s}, expected K1 {want_k1}")
        summary["window_parallel"] = dict(
            secs=par["secs"], secs_sequential=seq["secs"], peak=par["peak"],
            peak_sequential=seq["peak"], windows=n_windows,
            launches=nonzero(den_p), latents_bit_equal=lat_equal,
            frames_equal=frames_equal)
        paths["window_parallel"] = dict(
            secs=par["secs"], by_stage=par["by_stage"], peak=par["peak"],
            frames=F_, steps=TIMED_STEPS, chunks=F_ // WORKLOAD["decode_chunk"])
        del runs, seq, par
        pipe.mesh, pipe._window_parallel = None, False
        free_card("mesh_axes")

        # (b) the data axis: the grid runner with and without the mesh
        bp = sibling_of(pipe)
        plan = TH.plan_grid_search(phase="cfg", video_filter="corgi_beach")
        configs = [dataclasses.replace(c, **fs.get("study", {}))
                   for c in plan if c.guidance_scale in STUDY_CFGS]
        warm = [dataclasses.replace(c, num_inference_steps=2) for c in configs]
        TH.generate_batch(bp, warm, "ddim", mesh=mesh)
        data = {}
        for label, m in (("plain", None), ("mesh", mesh)):
            out = SCRATCH / f"mesh_data_{label}"
            shutil.rmtree(out, ignore_errors=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.time()
            TH.run_batched_experiments(bp, configs, out, scheduler="ddim",
                                       mesh=m, max_batch=len(configs),
                                       decode_chunk=WORKLOAD["decode_chunk"],
                                       log=lambda *a: None)
            torch.cuda.synchronize()
            data[label] = dict(secs=time.time() - t0, launches=read_counters(),
                               peak=torch.cuda.max_memory_allocated(),
                               files={p.relative_to(out): p.read_bytes()
                                      for p in sorted(out.rglob("*")) if p.is_file()})
            shutil.rmtree(out, ignore_errors=True)
        same = data["plain"]["files"] == data["mesh"]["files"]
        n_files = len(data["mesh"]["files"])
        per_video = {k: d["secs"] / len(configs) for k, d in data.items()}
        k1 = {k: d["launches"]["K1"] for k, d in data.items()}
        log(f"[mesh_axes] (b) run_batched_experiments, {len(configs)} configs "
            f"at {configs[0].height}x{configs[0].width}x{configs[0].num_frames}, "
            f"{configs[0].num_inference_steps} DDIM steps: s a video with the "
            f"one-rank data axis {per_video['mesh']:.3f} against "
            f"{per_video['plain']:.3f} without; {n_files} files byte for byte "
            f"equal {same}; launches {nonzero(data['mesh']['launches'])} "
            f"(without the mesh {nonzero(data['plain']['launches'])})")
        want = 10 * configs[0].num_inference_steps
        if not same or n_files != len(configs) * (configs[0].num_frames + 2):
            raise SystemExit("[mesh_axes] (b) the data axis's artifacts differ")
        if k1 != {"plain": want, "mesh": want}:
            raise SystemExit(f"[mesh_axes] (b) K1 launches {k1}, expected {want}")
        summary["data_axis"] = dict(
            s_per_video=per_video, files=n_files, files_equal=same,
            launches={k: nonzero(d["launches"]) for k, d in data.items()},
            peak={k: d["peak"] for k, d in data.items()})
        del bp, data
        free_card("mesh_axes")

        # (d) K1 at the local heads of 2-way TP
        gen = torch.Generator(device=dev).manual_seed(29)
        rows = [attention_row(dev, gen, "K1", shape, "tp", site, False)
                for shape, site in zip(MESH_TP_SHAPES, (
                    "level-0 self-attn, local heads",
                    "level-1 self-attn, local heads"))]
        for r in rows:
            log(f"[mesh_axes] (d) {r['name']}: max_abs_err="
                f"{r['max_abs_err']:.3e} tol={r['tol']:.3e} kernel_ms="
                f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
                f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']})")
        bad = [r["name"] for r in rows if not r["max_abs_err"] <= r["tol"]]
        if bad:
            raise SystemExit(f"[mesh_axes] (d) kernels disagree: {bad}")
        torch.cuda.empty_cache()

        # (e) two ranks of 2-way TP on the one card, over gloo
        local = build_random(lambda: UNetMotion(
            fs.get("unet", UNetMotionConfig()), pipe.policy), dev, MESH_TP_SEED)
        model_in, t_b, ctx = first_step_inputs(pipe)
        tp = run_tp_ranks(local, model_in, t_b, ctx, local.policy)
        del local, model_in, t_b, ctx
        free_card("mesh_axes")
        log(f"[mesh_axes] (e) UNetMotion 16x512x512 CFG batch, 2-way TP on "
            f"one card (gloo): rel_l2 against the local call "
            f"{tp['rel_l2']:.3e} (bar {REL_L2_TOL}); {tp['split']} parameters "
            f"split, attention heads a rank {tp['heads']}; rank 0: "
            f"{tp['secs']:.3f}s a first UNet call (the collectives through "
            f"the host), peak {tp['peak'] / 2**30:.2f} GiB, launches "
            f"{nonzero(tp['launches'])}; {tp['wall_s']:.1f}s with start-up")
        if not tp["rel_l2"] < REL_L2_TOL or tp["launches"]["K1"] != 10:
            raise SystemExit(f"[mesh_axes] (e) the TP forward: rel_l2 "
                             f"{tp['rel_l2']}, launches {tp['launches']}")
        summary["tensor_parallel"] = {k: v for k, v in tp.items()
                                      if k != "launches"} | {
            "launches": nonzero(tp["launches"])}
        paths["tp"] = dict(secs=tp["secs"], by_stage={"denoise": tp["launches"]},
                           peak=tp["peak"], frames=16, steps=1, chunks=0)

        # (c) the train step over the mesh against the single-card step
        root = SCRATCH / "train_clips"
        write_train_clips(root)
        unet = pipe.unet
        ds = FrameFolderDataset(root, clip_frames=TRAIN_CLIP,
                                size=(TRAIN_SIZE, TRAIN_SIZE))
        loader = VideoClipLoader(ds, batch_size=TRAIN_BATCH, seed=0)
        ctx1 = pipe.encode_prompt(PROMPT)[1:].clone()
        tctx = ctx1.expand((TRAIN_BATCH,) + tuple(ctx1.shape[1:])).contiguous()
        host = [{"latents": encode_clips_to_latents(pipe.vae, b["pixels"]).cpu(),
                 "context": tctx.cpu()}
                for b in prefetch_to_device(iter(loader), dev)]
        params = dict(unet.named_parameters())
        p0 = {n: p.detach().clone() for n, p in params.items()}
        key = rng.prng_key(1)
        state, opt = TT.init_train_state(unet, optimizer=TT.make_optimizer(TRAIN_LR),
                                         ema=True)
        step = TT.make_train_step(unet, opt, remat=True, grad_accum=2,
                                  ema_decay=TRAIN_EMA, return_grads=True)
        first = {k: v.to(dev) for k, v in host[0].items()}
        state, m1 = step(state, first, key)
        loss1, g1 = float(m1["loss"]), m1["grads"]
        p1 = {n: p.detach().clone() for n, p in params.items()}
        del state, step, m1, first
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(p0[n])
        rules = param_sharding_rules(unet, mesh)
        replicated = all(d is None for d in rules.values())
        tensor_parallel(unet, mesh)
        if not replicated or unet.tp_layout:
            raise SystemExit("[mesh_axes] (c) a one-rank mesh split parameters")
        sharding = {"latents": video_sharding(mesh), "context": batch_sharding(mesh)}
        batches = prefetch_to_device(
            iter([host[i % len(host)] for i in range(MESH_TRAIN_STEPS)]),
            sharding=sharding)
        state, opt = TT.init_train_state(unet, optimizer=TT.make_optimizer(TRAIN_LR),
                                         ema=True)
        mstep = TT.make_mesh_train_step(unet, opt, mesh, remat=True, grad_accum=2,
                                        ema_decay=TRAIN_EMA, return_grads=True)
        b0 = next(batches)
        if type(b0["latents"]).__name__ != "DTensor":
            raise SystemExit("[mesh_axes] (c) the batch is not laid out on the mesh")
        state, mm = mstep(state, b0, key)
        loss_m = float(mm["loss"])
        loss_rel = abs(loss_m - loss1) / abs(loss1)
        grad_rel = global_rel(mm["grads"], g1)
        upd = math.sqrt(sum(float(((params[n].detach().float() - p1[n].float())
                                   ** 2).sum()) for n in params))
        own = math.sqrt(sum(float(((p1[n].float() - p0[n].float()) ** 2).sum())
                            for n in params))
        upd_rel = upd / own
        del mm, g1, p0, p1
        torch.cuda.empty_cache()
        log(f"[mesh_axes] (c) the mesh step against the single-card step "
            f"(same state and key): loss {loss_m:.6f} / {loss1:.6f} rel "
            f"{loss_rel:.3e} (bar {TRAIN_LOSS_REL}), gradient rel-L2 "
            f"{grad_rel:.3e} (bar {TRAIN_GRAD_REL}), the updated parameters "
            f"{upd:.4e} from the single-card step's, {upd_rel:.3f} of its own "
            f"update {own:.4e} (bar 1: AdamW's first step is +-lr an element)")
        if not (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL
                and upd_rel < 1.0):
            raise SystemExit("[mesh_axes] (c) the mesh step is off the "
                             "single-card step")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        fn0 = fn_backward_calls()
        secs, losses = [], [loss_m]
        for i, b in enumerate(batches):
            key, sub = rng.split(key)
            t0 = time.time()
            state, m = mstep(state, b, sub)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
        peak = torch.cuda.max_memory_allocated()
        launches = add_counts([read_counters()])
        fns = {k: n - fn0[k] for k, n in fn_backward_calls().items()}
        med = sorted(secs)[len(secs) // 2]
        n_k1 = 2 * 2 * TRAIN_K1_PER_CALL * len(secs)  # forward + recompute
        log(f"[mesh_axes] (c) {len(secs)} timed mesh steps: s a step {secs} "
            f"(median {med:.3f}, spread {min(secs):.3f}-{max(secs):.3f}), "
            f"losses {losses}, peak {peak} ({peak / 2**30:.2f} GiB); launches "
            f"{launches} (forward + recompute), Functions' backward {fns}")
        if (not all(math.isfinite(x) for x in losses) or launches["K1"] != n_k1
                or fns["K1 Fn"] != n_k1 // 2 or not launches["K2"]):
            raise SystemExit(f"[mesh_axes] (c) mesh steps: losses {losses}, "
                             f"launches {launches}, Functions {fns}; expected "
                             f"K1 {n_k1}")
        summary["train"] = dict(
            loss=loss_m, loss_single_card=loss1, loss_rel=loss_rel,
            grad_rel_l2=grad_rel, update_rel=upd_rel, s_per_step=secs,
            median_s=med, max_memory_allocated=peak, launches=launches,
            functions_backward=fns, all_replicated=replicated)
        del state, mstep, batches, host, unet, params, pipe
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    summary["phase_s"] = time.time() - t_phase
    log(f"[mesh_axes] phase done ({summary['phase_s']:.1f}s)")
    return rows, paths, summary


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("frame_shards", "mesh_axes"),
                    help="build the kernels and run this phase alone "
                         "(frame_shards: 28, mesh_axes: 29), then the same "
                         "last line")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(HANG_BUDGET_S, exit=True)
    t_start = time.time()
    if not (ROOT / "vdx_torch" / "csrc").is_dir():
        raise SystemExit(f"vdx_torch/csrc not found beside {__file__}: run "
                         "chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: chip_smoke.py "
                         "needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SM_CLOCKS_PER_S["rate"] = sms * clock_mhz * 1e6
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | SMs {sms} "
        f"clocks.max.sm {clock_mhz:.0f} MHz: exp2 bound rate "
        f"{EXP2_PER_CLOCK * SM_CLOCKS_PER_S['rate']:.4e}/s (16 a clock per "
        f"SM) | tf32 off "
        f"| hang budget {HANG_BUDGET_S}s")

    # 2. build
    from vdx_torch.kernels import _lib

    t0 = time.time()
    _lib.lib()
    info = _lib.build_info
    log(f"[build] build_s={info['build_s']:.1f} cached={info['cached']} "
        f"lib={pathlib.Path(info['path']).relative_to(ROOT)} "
        f"({time.time() - t0:.1f}s)")
    if info.get("nvcc_output"):
        log("[build] " + " | ".join(
            line for line in info["nvcc_output"].splitlines()
            if line.startswith("$ ")))
        log("[build] ptxas per kernel (registers, spill stores/loads): "
            + ptxas_summary(info["nvcc_output"]))

    if args.only == "frame_shards":
        path, frame_shards = run_frame_shards(dev)
        log(json.dumps({"frame_shards": frame_shards, "paths": {
            "frame_shards": {"timed_call_s": path["secs"],
                             "max_memory_allocated": path["peak"],
                             "launches_by_stage": path["by_stage"]}},
            "build_s": info["build_s"], "total_s": time.time() - t_start}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        faulthandler.cancel_dump_traceback_later()
        return 0
    if args.only == "mesh_axes":
        mesh_rows, mesh_paths, mesh_axes = run_mesh_axes(dev)
        runs = {p: d["by_stage"] for p, d in mesh_paths.items()}
        log(json.dumps({"kernels": [
            {k: r[k] for k in ("name", "route", "source", "replaces")}
            | {"launches": runs[r["path"]][r["stage"]][r["kernel"]],
               "path": r["path"], "stage": r["stage"]}
            | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "library_ms")}
            | {"bound_by": "bytes" if r["bound_by"] == "bytes" else "operations"}
            for r in mesh_rows], "mesh_axes": mesh_axes, "paths": {
            p: {"timed_call_s": d["secs"], "max_memory_allocated": d["peak"],
                "launches_by_stage": d["by_stage"]}
            for p, d in mesh_paths.items()},
            "build_s": info["build_s"], "total_s": time.time() - t_start}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        faulthandler.cancel_dump_traceback_later()
        return 0

    # 3. kernels against their plain versions
    t0 = time.time()
    rows, edge_launches = check_kernels(dev)
    torch.cuda.empty_cache()
    log(f"[kernels] all within tolerance ({time.time() - t0:.1f}s)")
    # each row's launches come from the run of its own path: a timed call
    # ("512", "768"), the GN dispatch at 2560 channels, the temporal sites
    runs = {"gn2560": drive_gn2560(dev)}
    torch.cuda.empty_cache()
    gn_per_call = check_gn_sites(dev)

    # 4. init: the pipeline with its defaults (Euler; the 512 path asks
    # for DDIM per call)
    from vdx_torch.core.dtypes import BF16_POLICY
    from vdx_torch.pipelines import AnimateDiffPipeline

    t0 = time.time()
    pipe = AnimateDiffPipeline.with_random_params(seed=0, policy=BF16_POLICY)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", pipe.unet), ("vae", pipe.vae),
                                ("text", pipe.text_encoder))}
    log(f"[init] params={sum(n_params.values())} {n_params} bf16 on the card "
        f"default scheduler={pipe.scheduler} device={pipe.device} "
        f"({time.time() - t0:.1f}s)")
    if pipe.scheduler != "euler" or pipe.device.type != "cuda":
        raise SystemExit("the pipeline's defaults should be euler on cuda")
    check_noise_on_card(pipe, dev)

    # 5. warm-up
    t0 = time.time()
    out = pipe(PROMPT, num_inference_steps=2, scheduler="ddim", **WORKLOAD)
    log(f"[warmup] 2 steps, frames {out.frames[0].shape} "
        f"({time.time() - t0:.1f}s)")

    # 6. reference: one denoiser evaluation, kernels against plain versions
    sites, site_calls = {}, {}  # the motion-module sites, for phase 12
    reference_eval(pipe, "ddim", 512, ("K1", "K2/K3"),
                   {"K1": 10, "K4": 0} | gn_per_call[("512", "unet")],
                   sites, site_calls)
    torch.cuda.empty_cache()

    # 7. the timed call (512x512, DDIM)
    plain512 = {}  # its latents, for phase 17
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "timed", keep=plain512, num_inference_steps=TIMED_STEPS,
        scheduler="ddim", **WORKLOAD)
    if by_stage["denoise"]["K1"] != 10 * TIMED_STEPS or by_stage["decode"]["K1"]:
        raise SystemExit(f"launches {by_stage}: expected K1 {10 * TIMED_STEPS} "
                         "times in the denoise loop (10 per UNet call), none after")
    check_no_forms(by_stage, "512x512 DDIM")
    chunks = WORKLOAD["num_frames"] // WORKLOAD["decode_chunk"]
    check_gn_launches(by_stage, gn_per_call, "512", TIMED_STEPS, chunks)
    check_frames(frames, (16, 512, 512, 3), lat_finite, "512x512 DDIM")
    paths = {"512": dict(secs=secs, by_stage=by_stage, peak=peak,
                         frames=frames.shape[0], steps=TIMED_STEPS,
                         chunks=chunks)}
    clip512 = frames  # phase 15's input

    # 8. warm-up of the 768x768 path (the pipeline's default sampler)
    t0 = time.time()
    out = pipe(PROMPT, num_inference_steps=2, **WORKLOAD_768)
    log(f"[warmup768] 2 {pipe.scheduler} steps, frames {out.frames[0].shape} "
        f"({time.time() - t0:.1f}s)")
    del out
    torch.cuda.empty_cache()

    # 9. reference at 768x768: only K4 swapped for its plain version
    reference_eval(pipe, pipe.scheduler, 768, ("K4",),
                   {"K1": 10, "K4": 5} | gn_per_call[("768", "unet")],
                   sites, site_calls)
    torch.cuda.empty_cache()

    # 10. the timed call (768x768, the default sampler: Euler)
    secs, frames, lat_finite, by_stage, peak = timed_call(
        pipe, "timed768", num_inference_steps=TIMED_STEPS, **WORKLOAD_768)
    want = {"K1": 10 * TIMED_STEPS, "K4": 5 * TIMED_STEPS}
    if any(by_stage["denoise"][k] != n or by_stage["decode"][k]
           for k, n in want.items()):
        raise SystemExit(f"launches {by_stage}: expected {want} in the denoise "
                         "loop (K1 10, K4 5 per UNet call), none in the decode")
    check_no_forms(by_stage, "768x768 Euler")
    check_gn_launches(by_stage, gn_per_call, "768", TIMED_STEPS, chunks)
    check_frames(frames, (16, 768, 768, 3), lat_finite, "768x768 Euler")
    paths["768"] = dict(secs=secs, by_stage=by_stage, peak=peak,
                        frames=frames.shape[0], steps=TIMED_STEPS,
                        chunks=chunks)
    del frames
    torch.cuda.empty_cache()

    # 11. every sampler on the card: tables on the device, the loop's carry
    from vdx_torch.schedulers import _SAMPLERS

    t0 = time.time()
    sampler_runs = {}
    for name in sorted(set(m.__name__.rsplit(".", 1)[1] for m in _SAMPLERS.values())):
        t1 = time.time()
        out = pipe(PROMPT, num_inference_steps=SAMPLER_STEPS, scheduler=name,
                   **WORKLOAD)
        f = out.frames[0]
        check_frames(f, (16, 512, 512, 3), bool(torch.isfinite(out.latents).all()),
                     f"sampler {name}")
        sampler_runs[name] = dict(s=time.time() - t1, mean=float(f.mean()),
                                  std=float(f.std()))
    log(f"[samplers] {SAMPLER_STEPS} steps at 512x512 through __call__, "
        f"finite latents, non-constant frames: {sampler_runs} "
        f"({time.time() - t0:.1f}s)")

    # 12. the temporal family at the motion-module sites of 6 and 9
    t0 = time.time()
    t_rows, runs["temporal"], temporal_per_call = check_temporal(
        dev, sites, site_calls)
    rows += t_rows
    del sites
    torch.cuda.empty_cache()
    log(f"[temporal] all within tolerance ({time.time() - t0:.1f}s)")

    # 13. the attention forms: every K1'/K5 form through the
    # micro-benchmark's loop (scripts/bench_attn_torch.py)
    t0 = time.time()
    f_rows, runs["forms"] = check_forms(dev)
    rows += f_rows
    torch.cuda.empty_cache()
    log(f"[forms] all within tolerance ({time.time() - t0:.1f}s)")

    # 14. a two-prompt batch on a second full-width pipeline from the same
    # seed, with guidance_rescale and FreeU, frames left on the card
    from vdx_torch.nn.freeu import FreeUConfig

    t0 = time.time()
    pipe2 = AnimateDiffPipeline.with_random_params(
        seed=0, policy=BF16_POLICY, guidance_rescale=0.7, freeu=FreeUConfig())
    paths["batch"] = run_batch(pipe2, gn_per_call)
    del pipe2
    torch.cuda.empty_cache()
    log(f"[batch] phase done ({time.time() - t0:.1f}s)")

    # 15. video2video: phase 7's frames at strength 0.6
    t0 = time.time()
    paths["v2v"] = run_video2video(pipe, clip512, dev, gn_per_call)
    torch.cuda.empty_cache()
    log(f"[v2v] phase done ({time.time() - t0:.1f}s)")

    # 16. skip mode, dispatch segments, variable_steps, progress, attn_impl
    knobs = run_knobs(pipe)

    # 17. PAB: phase 7's call with the attention broadcast
    t0 = time.time()
    plain512["denoise"] = paths["512"]["by_stage"]["denoise"]
    paths["pab"], pab = run_pab(pipe, plain512, gn_per_call)
    torch.cuda.empty_cache()
    log(f"[pab] phase done ({time.time() - t0:.1f}s)")

    # 18. context windows with FreeNoise: 32 frames
    t0 = time.time()
    paths["context"], context = run_context(pipe, gn_per_call)
    torch.cuda.empty_cache()
    log(f"[context] phase done ({time.time() - t0:.1f}s)")

    # 19. LoRA, 20. checkpoints
    lora = run_lora(pipe, gn_per_call)
    checkpoints = run_checkpoints(pipe)

    # 21. the study: two grid configs alone and batched, measured on the card
    study = run_study(pipe, gn_per_call)
    torch.cuda.empty_cache()

    # 22. the main path served over HTTP: sync, batched, job and v2v routes
    paths["serve"], serving = run_serving(pipe, clip512,
                                          paths["v2v"].pop("video"), gn_per_call)
    torch.cuda.empty_cache()
    svd_frame = clip512[0]  # phase 24's conditioning image

    # free AnimateDiff's pipeline: each family's peak is its own
    del pipe, clip512
    torch.cuda.empty_cache()

    # 23. ModelScope: UNet3D, 16 frames 256x256, 25 DDIM steps
    family_gn = family_gn_expectations(dev)
    paths["ms"] = run_modelscope(family_gn)
    torch.cuda.empty_cache()

    # 24. SVD: 25 frames 576x1024, 25 EDM steps, the temporal decoder,
    # one POST /img2vid
    paths["svd"], svd = run_svd(family_gn, svd_frame)
    torch.cuda.empty_cache()

    # 25. Latte-XL: 16 frames 512x512, 50 DDIM steps
    paths["latte"] = run_latte(family_gn)
    torch.cuda.empty_cache()

    # 26. CogVideoX-2B: 49 frames 480x720, 50 DDIM steps, T5-XXL offloaded,
    # the causal decode in spatial tiles
    paths["cog"], cogvideox = run_cogvideox(family_gn)
    torch.cuda.empty_cache()

    # 27. training at full width: the gradient check against the plain
    # versions, full steps (remat, grad_accum, EMA) and LoRA steps
    paths["train"], train = run_training(dev)
    torch.cuda.empty_cache()

    # 28. frame sharding on a one-rank NCCL mesh: UNetMotion (ulysses,
    # ring, ragged ring), the SVD UNet, Latte-XL, the timed 512 call
    paths["frame_shards"], frame_shards = run_frame_shards(dev)
    torch.cuda.empty_cache()

    # 29. the rest of the mesh: window parallelism, the data axis and the
    # train step on a one-rank NCCL mesh, K1 at the local heads of 2-way
    # TP, two TP ranks on the card over gloo
    mesh_rows, mesh_paths, mesh_axes = run_mesh_axes(dev)
    rows += mesh_rows
    paths.update(mesh_paths)
    torch.cuda.empty_cache()

    # Counts are per kernel at every shape, within the row's stage of its
    # path's run: the denoise loop of a timed call (per step), its VAE
    # encode and decode (per chunk), the GN dispatch at 2560 channels, the
    # temporal sites (per site), or the micro-benchmark's loop of its form
    # and shape.
    runs.update({p: d["by_stage"] for p, d in paths.items()})
    n_sites = len(t_rows) // len(TEMPORAL)
    for r in rows:
        if runs[r["path"]][r["stage"]][r["kernel"]] == 0:
            raise SystemExit(f"{r['name']} never launched in its stage of its "
                             f"path's run: {runs[r['path']]}")

    def row_launches(r):
        n = runs[r["path"]][r["stage"]][r["kernel"]]
        out = {"launches": n, "path": r["path"], "stage": r["stage"]}
        if r["stage"] in ("denoise", "step"):
            out["launches_per_step"] = n / paths[r["path"]]["steps"]
        elif r["stage"] in ("decode", "encode"):
            d = paths[r["path"]]
            out["launches_per_chunk"] = n / d.get(f"{r['stage']}_chunks",
                                                  d["chunks"])
        elif r["stage"] == "sites":
            out["launches_per_site"] = n / n_sites
        return out

    summary = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | row_launches(r)
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "library_ms")}
        | {"bound_by": "bytes" if r["bound_by"] == "bytes" else "operations",
           "bound_term": r["bound_by"]}
        | {k: r[k] for k in ("xla_bf16p_ms", "xla_bf16p_max_abs_diff",
                             "calls_per_unet_call") if k in r}
        | ({"note": r["note"]} if r["note"] else {})
        for r in rows
    ], "temporal_per_unet_call_ms": temporal_per_call, "paths": {
        p: {"timed_call_s": d["secs"], "frames_per_s": d["frames"] / d["secs"],
            "steps": d["steps"], "max_memory_allocated": d["peak"],
            "launches_by_stage": d["by_stage"]}
        | ({"s_per_video": d["secs"] / d["videos"]} if "videos" in d else {})
        for p, d in paths.items()},
        "samplers": sampler_runs, "knobs": knobs, "pab": pab,
        "context": context, "lora": lora, "checkpoints": checkpoints,
        "study": study, "serving": serving,
        "modelscope": {k: paths["ms"][k] for k in ("rel_l2_unet_eval", "params")},
        "svd": svd,
        "latte": {k: paths["latte"][k]
                  for k in ("rel_l2_unet_eval", "params", "held_before")},
        "cogvideox": cogvideox,
        "train": train,
        "frame_shards": frame_shards,
        "mesh_axes": mesh_axes,
        # every flash attention counter (kernels.flash_attention
        # .launch_counts) with its launches at phase 3's edges
        "edge_launches": edge_launches,
        "build_s": info["build_s"], "total_s": time.time() - t_start}
    log(json.dumps(summary))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
